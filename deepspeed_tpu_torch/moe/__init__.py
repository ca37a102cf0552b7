"""MoE public API (counterpart of ``deepspeed_tpu/moe/__init__.py``: the
MoE layer, its gating and capacity bins)."""

from . import capacity_bins, gating, layer  # noqa: F401
from .layer import MoE, MoEConfig, init_moe_params, moe_forward  # noqa: F401
