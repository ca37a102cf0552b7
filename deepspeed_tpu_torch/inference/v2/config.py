"""Inference-v2 engine configuration.

The subset of ``deepspeed_tpu/inference/v2/config.py`` the port reads.
:class:`ServingOptimizationConfig` has the JAX package's defaults:
``fused_step=True, on_device_sampling=True, async_scheduling=True,
prefix_caching=True, speculative=False, tp_degree=1,
keyed_sampling=False``.  ``async_scheduling``, ``prefix_caching`` and
``kv_quantization`` vary; the other flags stay at these values (another
value raises, naming the ROADMAP item that brings it).  The KV cache
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
    "fused_step": (True, "4b (the split, non-fused escape hatch)"),
    "on_device_sampling": (True, "4b (host-side sampling)"),
    "speculative": (False, "8 (speculative decoding)"),
    "tp_degree": (1, "13 (tensor-parallel serving)"),
    "keyed_sampling": (False, "3 (keyed sampling)"),
}


@dataclasses.dataclass
class ServingOptimizationConfig:
    """Serving-step knobs.  The fixed fields exist so a configuration
    written for the JAX package says what it expects, and
    :meth:`validate` (run at construction and again at engine build)
    raises ``NotImplementedError`` for a value the port does not run."""
    fused_step: bool = True
    on_device_sampling: bool = True
    #: double-buffered scheduler: step k+1 (a chained decode step whose
    #: tokens are gathered on the device) is dispatched before step k's
    #: tokens are read, so tokens reach the host one step late
    async_scheduling: bool = True
    #: automatic prefix cache over the paged KV pool: full prompt pages
    #: are shared across sequences and kept after they finish (LRU
    #: eviction under pool pressure), so a warm prefix is not prefilled
    #: again.  Fixed at engine build
    prefix_caching: bool = True
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
