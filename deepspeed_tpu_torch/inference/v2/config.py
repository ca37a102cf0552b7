"""Inference-v2 engine configuration.

The subset of ``deepspeed_tpu/inference/v2/config.py`` this slice reads.
The serving path itself is fixed at the JAX package's
``fused_step=True, on_device_sampling=True, async_scheduling=False,
prefix_caching=False, speculative=False, kv_quantization="none",
tp_degree=1`` combination; the other combinations are later slices.
The KV cache geometry is the model's ``kv_config``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StateManagerConfig:
    max_tracked_sequences: int = 2048
    max_ragged_sequence_count: int = 512
    max_ragged_batch_size: int = 768       # token budget per forward


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    state_manager: StateManagerConfig = dataclasses.field(
        default_factory=StateManagerConfig)
