"""Optimizer factory for the training slice.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py:38-83``.  The JAX
engine computes AdamW through ``optax.adamw``; the reference DeepSpeed
runs ``FusedAdam`` for ``adam`` / ``adamw`` / ``fusedadam`` on a CUDA
card, so the port maps all three to :class:`FusedAdamW` (the same
function, through the fused kernel).  Every other optimizer raises.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..ops.fused_optimizer import FusedAdamW
from .config import ADAM_TYPES, OptimizerParams, outside_slice


def get_optimizer(name: str, params_cfg: OptimizerParams,
                  params: Iterable[torch.Tensor]) -> FusedAdamW:
    """The optimizer for a DeepSpeed optimizer name over ``params``."""
    if name.lower().replace("_", "") not in ADAM_TYPES:
        raise outside_slice(f"optimizer {name!r}",
                            "11d (Lion, LAMB and the other optimizers)")
    return FusedAdamW(params, lr=params_cfg.lr, betas=params_cfg.betas,
                      eps=params_cfg.eps,
                      weight_decay=params_cfg.weight_decay)
