"""Per-architecture injection policies and AutoTP (counterpart of
``deepspeed_tpu/module_inject``)."""

from .auto_tp import AutoTP, classify  # noqa: F401
