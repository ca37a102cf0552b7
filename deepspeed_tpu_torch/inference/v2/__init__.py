"""Ragged (FastGen-style) serving: counterpart of
``deepspeed_tpu/inference/v2``."""

from .config import (FaultInjectionConfig, KVCacheUserConfig,
                     QuantizationConfig,
                     RaggedInferenceEngineConfig, ServingOptimizationConfig,
                     StateManagerConfig, TelemetryConfig)
from .engine import InferenceEngineV2, SchedulingError, SchedulingResult
from .factory import build_hf_engine
from .lattice import BucketLattice, LatticeError, resolve_lattice
from .model import RaggedInferenceModel
from .model_implementations import (implementation_for,
                                    supported_model_types)
from .ragged import BlockedAllocator, KVAllocationError, KVCacheConfig
from .sampling import (SamplingParams, derive_row_keys, sample,
                       sample_dynamic, sample_keyed)
from .scheduler import FastGenScheduler, Request, RequestError, generate
from .snapshot import SnapshotError
from .spec import ModelDrafter, NgramDrafter

__all__ = [
    "FaultInjectionConfig", "KVCacheUserConfig", "QuantizationConfig", "RaggedInferenceEngineConfig",
    "ServingOptimizationConfig", "StateManagerConfig", "TelemetryConfig",
    "BucketLattice", "LatticeError", "resolve_lattice", "InferenceEngineV2", "SchedulingError", "SchedulingResult",
    "RaggedInferenceModel", "BlockedAllocator", "KVAllocationError",
    "KVCacheConfig", "SamplingParams", "sample", "sample_dynamic",
    "derive_row_keys", "sample_keyed", "SnapshotError",
    "FastGenScheduler", "Request", "RequestError", "generate",
    "ModelDrafter", "NgramDrafter",
    "implementation_for", "supported_model_types", "build_hf_engine",
]
