"""LoRA / OptimizedLinear (counterpart of ``deepspeed_tpu/linear``)."""

from .optimized_linear import (  # noqa: F401
    LoRAConfig,
    OptimizedLinear,
    QuantizationConfig,
    lora_trainable_mask,
)
