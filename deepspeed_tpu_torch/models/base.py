"""Model protocol and the engine tests' fixtures.

Counterpart of ``deepspeed_tpu/models/base.py`` (:21-91).  The training
engine takes any object with

  init_params(seed, device) -> params tree (nested dicts of tensors)
  loss(params, batch)       -> scalar tensor

``SimpleModel`` and ``random_dataset`` mirror the reference fixtures
(``tests/unit/simple_model.py``) as the JAX package has them, so the
JAX engine's tests serve as cheap parity cases for the port's engine.
"""

from __future__ import annotations

import math
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device


@runtime_checkable
class Model(Protocol):
    def init_params(self, seed: int = 0, device: DeviceLike = None) -> Any: ...
    def loss(self, params, batch) -> torch.Tensor: ...


class SimpleModel:
    """MLP regression fixture: a stack of Linear layers with ReLU between
    them and an MSE loss over a dict batch {'x': [B, H], 'y': [B, H]}."""

    def __init__(self, hidden_dim: int = 64, nlayers: int = 2):
        self.hidden_dim = hidden_dim
        self.nlayers = nlayers

    def init_params(self, seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        h = self.hidden_dim
        return {f"layer_{i}": {
            "w": torch.randn((h, h), generator=gen, device=dev) / math.sqrt(h),
            "b": torch.zeros((h,), device=dev)} for i in range(self.nlayers)}

    def forward(self, params, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.nlayers):
            p = params[f"layer_{i}"]
            # jnp's promotion: an fp32 input against bf16 weights computes
            # in fp32
            dt = torch.promote_types(x.dtype, p["w"].dtype)
            x = x.to(dt) @ p["w"].to(dt) + p["b"].to(dt)
            if i < self.nlayers - 1:
                x = torch.relu(x)
        return x

    def loss(self, params, batch) -> torch.Tensor:
        pred = self.forward(params, batch["x"])
        return torch.mean((pred - batch["y"].to(pred.dtype)) ** 2)


def random_dataset(total_samples: int, hidden_dim: int, seed: int = 42):
    """Reference ``random_dataset`` (simple_model.py:266): numpy samples,
    the same draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(total_samples, hidden_dim)).astype(np.float32)
    ys = rng.normal(size=(total_samples, hidden_dim)).astype(np.float32)
    return [{"x": xs[i], "y": ys[i]} for i in range(total_samples)]
