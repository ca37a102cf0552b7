"""ZeRO-Offload (JAX ``runtime/zero``)."""

from .offload import HostOffloadOptimizer, NVMeStateSwapper  # noqa: F401
