"""Host optimizers for the offload path (JAX ``ops/adam``)."""

from .cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam, DeepSpeedCPULion  # noqa: F401
