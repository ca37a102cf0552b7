"""Data-efficiency pipeline (counterpart of
``deepspeed_tpu/runtime/data_pipeline``): curriculum learning,
difficulty-indexed sampling, Megatron mmap datasets, Random-LTD token
routing and progressive layer drop."""

from .curriculum_scheduler import CurriculumScheduler  # noqa: F401
from .data_routing import (  # noqa: F401
    ProgressiveLayerDrop,
    RandomLTDScheduler,
    apply_random_ltd,
    gather_tokens,
    scatter_tokens,
    token_sort_indices,
)
from .data_sampler import DataAnalyzer, DeepSpeedDataSampler  # noqa: F401
from .indexed_dataset import (  # noqa: F401
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
)
