"""Random-LTD (random layerwise token dropping) and progressive layer
drop.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_routing.py``
(``RandomLTDScheduler`` :26, ``token_sort_indices`` :46,
``gather_tokens`` :56, ``scatter_tokens`` :61, ``apply_random_ltd``
:69, ``ProgressiveLayerDrop`` :83).  A middle layer runs on a random
subset of ``keep`` tokens of each row; the dropped tokens ride the
residual stream unchanged.  As in JAX, nothing in the model calls
:func:`apply_random_ltd`: these are functions a model's layer loop
calls, and the engine exposes the config through
``random_ltd_enabled`` / ``random_ltd_config``.

The draw is JAX's, bit for bit: ``jax.random.uniform(key, (batch,
seq))`` through ``inference/v2/threefry.py`` (a ``[2]`` key of uint32
words in an int64 tensor, :func:`~..inference.v2.threefry.key_from_seed`),
the 2-D shape's counters being its flat index as in JAX's partitionable
``random_bits``, then a stable argsort as ``jnp.argsort``'s.  So a key
gives JAX's kept indices exactly.  Gather and scatter are
``torch.gather`` and an index copy on the caller's device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ...inference.v2 import threefry


class RandomLTDScheduler:
    """The kept-token schedule (JAX ``RandomLTDScheduler``): a linear
    ramp from ``min_value`` to ``max_value`` tokens over
    ``schedule_config.total_steps`` (or ``total_steps``) steps, rounded
    down to a multiple of ``seq_per_step`` and clamped to the range."""

    def __init__(self, config: Dict[str, Any]):
        self.min_value = int(config.get("min_value", 128))
        self.max_value = int(config.get("max_value", 1024))
        sc = config.get("schedule_config", {})
        self.total_steps = int(sc.get("total_steps",
                                      config.get("total_steps", 10000)))
        self.step_size = int(sc.get("seq_per_step", 16))

    def get_value(self, global_step: int) -> int:
        frac = min(1.0, global_step / max(1, self.total_steps))
        raw = self.min_value + (self.max_value - self.min_value) * frac
        v = int(raw // self.step_size) * self.step_size
        return max(self.min_value, min(self.max_value, v))


def token_sort_indices(key: torch.Tensor, batch: int, seq: int, keep: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random kept-token indices ``[batch, keep]`` (sorted, so the kept
    tokens keep their order) and the complement ``[batch, seq - keep]``,
    int64 on the key's device.  ``key`` is a JAX key's data ``[2]``."""
    noise = threefry.uniform(key.reshape(1, 2), batch * seq).reshape(
        batch, seq)
    order = torch.argsort(noise, dim=-1, stable=True)
    kept = torch.sort(order[:, :keep], dim=-1).values
    dropped = torch.sort(order[:, keep:], dim=-1).values
    return kept, dropped


def gather_tokens(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``[B, S, H]`` -> ``[B, keep, H]``: the kept tokens."""
    idx = indices.to(x.device)[:, :, None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, idx)


def scatter_tokens(full: torch.Tensor, sub: torch.Tensor,
                   indices: torch.Tensor) -> torch.Tensor:
    """The processed kept tokens written back into a copy of the full
    stream; the dropped tokens keep their values."""
    out = full.clone()
    idx = indices.to(full.device)[:, :, None].expand(-1, -1, full.shape[-1])
    return out.scatter(1, idx, sub.to(full.dtype))


def apply_random_ltd(layer_fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor, keep: int, key: torch.Tensor
                     ) -> torch.Tensor:
    """``layer_fn`` over a random ``keep``-token subset of each row of
    ``x`` ``[B, S, H]``; the rest bypass the layer (the Random-LTD
    forward).  ``keep >= S`` runs the layer on every token."""
    b, s = x.shape[0], x.shape[1]
    if keep >= s:
        return layer_fn(x)
    kept, _ = token_sort_indices(key, b, s, keep)
    return scatter_tokens(x, layer_fn(gather_tokens(x, kept)), kept)


class ProgressiveLayerDrop:
    """PLD (JAX ``ProgressiveLayerDrop``): the keep probability
    ``theta(t) = (1 - theta) exp(-gamma t) + theta``; layer i keeps with
    probability ``1 - (i + 1) / L * (1 - theta(t))``."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)
        self.current_theta = 1.0

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> float:
        self.current_theta = float((1.0 - self.theta) * np.exp(
            -self.gamma * global_step) + self.theta)
        return self.current_theta

    def layer_keep_prob(self, layer_idx: int, num_layers: int) -> float:
        frac = (layer_idx + 1) / max(1, num_layers)
        return 1.0 - frac * (1.0 - self.current_theta)

    def state_dict(self) -> Dict[str, float]:
        return {"current_theta": self.current_theta}

    def load_state_dict(self, sd: Dict[str, float]) -> None:
        self.current_theta = float(sd["current_theta"])
