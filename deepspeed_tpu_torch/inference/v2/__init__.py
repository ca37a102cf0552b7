"""Ragged (FastGen-style) serving: counterpart of
``deepspeed_tpu/inference/v2``."""

from .config import RaggedInferenceEngineConfig, StateManagerConfig
from .engine import InferenceEngineV2, SchedulingError, SchedulingResult
from .model import RaggedInferenceModel
from .ragged import BlockedAllocator, KVCacheConfig
from .sampling import SamplingParams, sample_dynamic
from .scheduler import FastGenScheduler

__all__ = [
    "RaggedInferenceEngineConfig", "StateManagerConfig",
    "InferenceEngineV2", "SchedulingError", "SchedulingResult",
    "RaggedInferenceModel", "BlockedAllocator", "KVCacheConfig",
    "SamplingParams", "sample_dynamic", "FastGenScheduler",
]
