"""Optimizer factory for the training slice.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:38-83``.  The JAX
engine computes AdamW, Lion and LAMB through ``optax.adamw``,
``optax.lion`` and ``optax.lamb``; the reference DeepSpeed runs
``FusedAdam``, ``FusedLion`` and ``FusedLamb`` on a CUDA card, so the
port maps ``adam`` / ``adamw`` / ``fusedadam`` to :class:`FusedAdamW`,
``lion`` / ``fusedlion`` to :class:`FusedLion` and ``lamb`` /
``fusedlamb`` to :class:`FusedLamb` (the same functions, through the
fused kernels); the host optimizers' names ``cpuadam`` /
``deepspeedcpuadam`` and ``cpulion`` give the same two on the device
(JAX ``runtime/optimizers.py:49-69``).  Hyper-parameters come out as JAX's ``get_optimizer``
gives them: Lion's ``b2`` is ``betas[1]`` (0.999 under the default
betas) and it takes no eps; LAMB takes the config's eps (default 1e-8)
and decays every leaf.  Every other optimizer raises, Adagrad too: it
runs only in the host kernel, with every leaf offloaded.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..ops.fused_optimizer import FusedAdamW, FusedLamb, FusedLion
from .config import OTHER_OPTIMIZERS, OptimizerParams, optimizer_kind, \
    outside_slice


def get_optimizer(name: str, params_cfg: OptimizerParams,
                  params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
    """The optimizer for a DeepSpeed optimizer name over ``params``."""
    kind = optimizer_kind(name)
    if kind == "adagrad":
        raise outside_slice(f"optimizer {name!r} on the device",
                            OTHER_OPTIMIZERS)
    betas = tuple(params_cfg.betas)
    if kind == "lion":
        # JAX optimizers.py:65-66: a missing beta takes Lion's own default
        b1 = betas[0] if betas else 0.9
        b2 = betas[1] if len(betas) > 1 else 0.99
        return FusedLion(params, lr=params_cfg.lr, betas=(b1, b2),
                         weight_decay=params_cfg.weight_decay)
    cls = FusedLamb if kind == "lamb" else FusedAdamW
    return cls(params, lr=params_cfg.lr, betas=betas, eps=params_cfg.eps,
               weight_decay=params_cfg.weight_decay)
