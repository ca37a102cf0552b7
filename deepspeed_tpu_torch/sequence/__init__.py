"""Sequence parallelism (counterpart of ``deepspeed_tpu/sequence``):
DeepSpeed-Ulysses' all-to-all sandwich (:mod:`.layer`) and ring
attention (:mod:`.ring`) over the ``seq`` ranks."""
