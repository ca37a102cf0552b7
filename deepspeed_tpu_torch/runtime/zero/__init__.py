"""ZeRO (JAX ``runtime/zero``): the partitioner across ranks and
ZeRO-Offload."""

from .offload import HostOffloadOptimizer, NVMeStateSwapper  # noqa: F401
from .partitioner import ZeroPartitioner  # noqa: F401
