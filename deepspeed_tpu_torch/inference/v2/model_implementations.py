"""Per-architecture inference-v2 model implementations.

Counterpart of ``deepspeed_tpu/inference/v2/model_implementations.py``.
All families share one core
(:class:`~deepspeed_tpu_torch.inference.v2.model.RaggedInferenceModel`
over the functional transformer), so an implementation is a thin subclass
that checks the family's architectural invariants at construction, where
a mis-mapped checkpoint config should fail.  ``implementation_for`` maps
a checkpoint's ``model_type`` to its class.
"""

from __future__ import annotations

from typing import Dict, Tuple, Type

from .model import RaggedInferenceModel


def _expect(cond: bool, message: str) -> None:
    # the JAX package asserts; raising keeps the check under ``python -O``
    if not cond:
        raise AssertionError(message)


class LlamaV2InferenceModel(RaggedInferenceModel):
    MODEL_TYPES: Tuple[str, ...] = ("llama",)

    def __init__(self, cfg, params, **kw):
        _expect(cfg.norm == "rmsnorm" and cfg.pos_emb == "rope",
                f"llama family expects rmsnorm+rope, got "
                f"{cfg.norm}/{cfg.pos_emb}")
        _expect("gated" in cfg.activation, "llama family is gated-MLP")
        super().__init__(cfg, params, **kw)


class MistralInferenceModel(LlamaV2InferenceModel):
    """Llama shape + sliding window (when set, the paged kernel skips
    pages wholly outside the window)."""
    MODEL_TYPES = ("mistral",)


class MixtralInferenceModel(RaggedInferenceModel):
    """Mistral attention + block-sparse MoE: the routed mlp self-wires
    from ``cfg.moe_num_experts`` (``moe/layer.py``, dropless top-k); a
    checkpoint mapped without experts raises, as in the JAX class."""
    MODEL_TYPES = ("mixtral",)

    def __init__(self, cfg, params, **kw):
        _expect(cfg.moe_num_experts > 1,
                "mixtral checkpoint mapped without experts — wrong policy?")
        super().__init__(cfg, params, **kw)


class FalconInferenceModel(RaggedInferenceModel):
    """Parallel attention + MLP residual for the new decoder architecture;
    sequential-residual falcon variants exist too, so no residual layout
    is asserted."""
    MODEL_TYPES = ("falcon",)


class OPTInferenceModel(RaggedInferenceModel):
    """Learned positions (the HF +2 offset folded into the table at load),
    pre-LN, relu."""
    MODEL_TYPES = ("opt",)

    def __init__(self, cfg, params, **kw):
        _expect(cfg.pos_emb == "learned", "OPT expects learned positions")
        super().__init__(cfg, params, **kw)


class PhiInferenceModel(RaggedInferenceModel):
    """Partial rotary + parallel residual (phi-2) / llama-like (phi-3)."""
    MODEL_TYPES = ("phi", "phi3")


class Qwen2InferenceModel(RaggedInferenceModel):
    """Llama geometry + attention-only qkv biases."""
    MODEL_TYPES = ("qwen2",)

    def __init__(self, cfg, params, **kw):
        _expect(cfg.qkv_bias, "qwen2 expects attention qkv biases")
        super().__init__(cfg, params, **kw)


class BloomInferenceModel(RaggedInferenceModel):
    """ALiBi + embedding layernorm."""
    MODEL_TYPES = ("bloom",)

    def __init__(self, cfg, params, **kw):
        _expect(cfg.pos_emb == "alibi", "bloom expects ALiBi")
        super().__init__(cfg, params, **kw)


class GPTNeoXInferenceModel(RaggedInferenceModel):
    MODEL_TYPES = ("gpt_neox",)


class GPT2InferenceModel(RaggedInferenceModel):
    MODEL_TYPES = ("gpt2",)


class GPTJInferenceModel(RaggedInferenceModel):
    MODEL_TYPES = ("gptj",)


_IMPLEMENTATIONS: Tuple[Type[RaggedInferenceModel], ...] = (
    LlamaV2InferenceModel, MistralInferenceModel, MixtralInferenceModel,
    FalconInferenceModel, OPTInferenceModel, PhiInferenceModel,
    Qwen2InferenceModel, BloomInferenceModel,
    GPTNeoXInferenceModel, GPT2InferenceModel, GPTJInferenceModel,
)


def implementation_for(model_type: str) -> Type[RaggedInferenceModel]:
    """model_type -> implementation class; unknown architectures get the
    generic shared core."""
    mt = model_type.lower()
    for impl in _IMPLEMENTATIONS:
        if mt in impl.MODEL_TYPES:
            return impl
    return RaggedInferenceModel


def supported_model_types() -> Dict[str, str]:
    return {t: impl.__name__ for impl in _IMPLEMENTATIONS
            for t in impl.MODEL_TYPES}
