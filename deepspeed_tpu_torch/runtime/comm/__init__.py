"""Compressed-communication optimizers (1-bit Adam / LAMB, 0/1 Adam):
counterpart of ``deepspeed_tpu/runtime/comm/``.  The collective
scheduler is not ported (one rank has no collective; ROADMAP item 11e)."""
