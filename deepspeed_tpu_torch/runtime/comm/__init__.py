"""Gradient communication (counterpart of ``deepspeed_tpu/runtime/comm/``):
the collective scheduler (bucketed, int8-quantised gradient reduction)
and the compressed-communication optimizers (1-bit Adam / LAMB, 0/1
Adam)."""

from .collective_scheduler import Bucket, CollectiveScheduler  # noqa: F401
