"""Per-architecture injection policies (counterpart of
``deepspeed_tpu/module_inject``): the dispatch table only."""
