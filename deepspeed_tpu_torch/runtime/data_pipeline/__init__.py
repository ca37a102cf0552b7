"""Data-efficiency pipeline (counterpart of
``deepspeed_tpu/runtime/data_pipeline``): curriculum learning,
difficulty-indexed sampling and Megatron mmap datasets.  Random-LTD
(``data_routing.py``, which reaches into the model's layer loop) is not
ported yet (ROADMAP Queue 1 item 3)."""

from .curriculum_scheduler import CurriculumScheduler  # noqa: F401
from .data_sampler import DataAnalyzer, DeepSpeedDataSampler  # noqa: F401
from .indexed_dataset import (  # noqa: F401
    MMapIndexedDataset,
    MMapIndexedDatasetBuilder,
)
