"""Ragged (FastGen-style) serving: counterpart of
``deepspeed_tpu/inference/v2``."""

from .config import (RaggedInferenceEngineConfig, ServingOptimizationConfig,
                     StateManagerConfig)
from .engine import InferenceEngineV2, SchedulingError, SchedulingResult
from .model import RaggedInferenceModel
from .model_implementations import (implementation_for,
                                    supported_model_types)
from .ragged import BlockedAllocator, KVCacheConfig
from .sampling import SamplingParams, sample_dynamic
from .scheduler import FastGenScheduler

__all__ = [
    "RaggedInferenceEngineConfig", "ServingOptimizationConfig",
    "StateManagerConfig",
    "InferenceEngineV2", "SchedulingError", "SchedulingResult",
    "RaggedInferenceModel", "BlockedAllocator", "KVCacheConfig",
    "SamplingParams", "sample_dynamic", "FastGenScheduler",
    "implementation_for", "supported_model_types",
]
