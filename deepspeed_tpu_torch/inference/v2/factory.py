"""Engine factory: HF checkpoint -> a ready ``InferenceEngineV2``
(counterpart of ``deepspeed_tpu/inference/v2/factory.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from ...accelerator import DeviceLike
from ...checkpoint.hf import from_pretrained, load_hf_model
from .config import RaggedInferenceEngineConfig
from .engine import InferenceEngineV2
from .model_implementations import implementation_for


def build_hf_engine(model_or_path: Any,
                    engine_config: Optional[RaggedInferenceEngineConfig] = None,
                    dtype: Optional[torch.dtype] = None,
                    device: DeviceLike = None) -> InferenceEngineV2:
    """A ragged inference engine from a ``transformers`` model instance
    or a local HF checkpoint directory, on ``device`` (the card unless
    the caller asks for the CPU).

    Arch dispatch is two-stage, as in the JAX package: the policy table
    (``module_inject/policies.py``) maps the config and the weights (cast
    to ``dtype``, bf16 by default), then ``implementation_for`` picks the
    family's model class, which checks the family's invariants (Mixtral
    included: its MoE mlp self-wires from ``cfg.moe_num_experts``).
    ``engine_config.quantization`` quantises the weights at engine build,
    before the KV pool is sized."""
    hf_model = load_hf_model(model_or_path)
    cfg, params = from_pretrained(hf_model, dtype=dtype or torch.bfloat16,
                                  device=device)
    model = implementation_for(hf_model.config.model_type)(
        cfg, params, device=device)
    return InferenceEngineV2(model, engine_config)
