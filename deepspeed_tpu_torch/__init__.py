"""PyTorch + CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
tree (``models/``, ``ops/``, ``runtime/``, ``inference/v2/``) so each
module's counterpart is found under the same name.  Nothing here imports
JAX or ``deepspeed_tpu``.  Entry points run on ``cuda`` unless
``device="cpu"`` is asked for; on the CPU every hand-written kernel is
replaced by its plain PyTorch version.
"""


def initialize(model=None, config=None, model_parameters=None,
               lr_scheduler=None, device=None, training_data=None,
               collate_fn=None):
    """Build a training engine (JAX ``deepspeed_tpu.initialize``,
    ``__init__.py:51``).  Returns ``(engine, optimizer, dataloader,
    lr_scheduler)``; the dataloader is ``engine.training_dataloader``,
    built over ``training_data`` (None without it)."""
    from .runtime.engine import DeepSpeedEngine
    engine = DeepSpeedEngine(model=model, config=config,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device,
                             training_data=training_data,
                             collate_fn=collate_fn)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
