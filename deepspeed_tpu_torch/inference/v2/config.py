"""Inference-v2 engine configuration.

The subset of ``deepspeed_tpu/inference/v2/config.py`` the port reads.
The serving path runs the JAX package's ``fused_step=True,
on_device_sampling=True, async_scheduling=False, prefix_caching=False,
speculative=False, tp_degree=1, keyed_sampling=False`` combination:
:class:`ServingOptimizationConfig` carries those flags at exactly these
values (another value raises, naming the ROADMAP item that brings it)
and the one knob that varies, ``kv_quantization``.  The KV cache
geometry is the model's ``kv_config``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StateManagerConfig:
    max_tracked_sequences: int = 2048
    max_ragged_sequence_count: int = 512
    max_ragged_batch_size: int = 768       # token budget per forward


# flag -> (the one value the port runs, ROADMAP Queue 1 item)
_FIXED_SERVING_FLAGS = {
    "fused_step": (True, "4 (the split, non-fused escape hatch)"),
    "on_device_sampling": (True, "4 (host-side sampling)"),
    "async_scheduling": (False, "7 (the async chained step)"),
    "prefix_caching": (False, "6 (prefix caching)"),
    "speculative": (False, "8 (speculative decoding)"),
    "tp_degree": (1, "13 (tensor-parallel serving)"),
    "keyed_sampling": (False, "3 (keyed sampling)"),
}


@dataclasses.dataclass
class ServingOptimizationConfig:
    """Serving-step knobs.  Only ``kv_quantization`` varies; the other
    fields exist so a configuration written for the JAX package says
    what it expects, and :meth:`validate` (run at construction and again
    at engine build) raises ``NotImplementedError`` for a value the port
    does not run."""
    fused_step: bool = True
    on_device_sampling: bool = True
    async_scheduling: bool = False
    prefix_caching: bool = False
    speculative: bool = False
    tp_degree: int = 1
    keyed_sampling: bool = False
    #: KV page storage format: "none" (fp pages at the cache dtype) or
    #: "int8" (block-scaled codes + one fp32 scale per head_dim block).
    #: Fixed at engine build: it shapes the cache tensors.  An unknown
    #: format raises ``ValueError`` there (``KVCacheConfig``)
    kv_quantization: str = "none"

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for flag, (value, item) in _FIXED_SERVING_FLAGS.items():
            if getattr(self, flag) != value:
                raise NotImplementedError(
                    f"serving_optimization.{flag}={getattr(self, flag)!r} "
                    f"is not ported yet: the port runs {flag}={value!r} "
                    f"(ROADMAP Queue 1 item {item})")


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    state_manager: StateManagerConfig = dataclasses.field(
        default_factory=StateManagerConfig)
    serving: ServingOptimizationConfig = dataclasses.field(
        default_factory=ServingOptimizationConfig)
