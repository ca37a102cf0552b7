"""Profiling (counterpart of ``deepspeed_tpu/profiling``)."""

from .flops_profiler import (  # noqa: F401
    FlopsProfiler,
    count_params,
    get_model_profile,
)
