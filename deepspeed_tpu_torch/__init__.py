"""PyTorch + CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
tree (``models/``, ``ops/``, ``runtime/``, ``inference/v2/``) so each
module's counterpart is found under the same name.  Nothing here imports
JAX or ``deepspeed_tpu``.  Entry points run on ``cuda`` unless
``device="cpu"`` is asked for; on the CPU every hand-written kernel is
replaced by its plain PyTorch version.
"""


def initialize(model=None, config=None, model_parameters=None,
               lr_scheduler=None, device=None, training_data=None):
    """Build a training engine (JAX ``deepspeed_tpu.initialize``,
    ``__init__.py:51``).  Returns ``(engine, optimizer, None,
    lr_scheduler)``: the port's slice has no dataloader, so
    ``training_data`` raises ``NotImplementedError``."""
    from .runtime.config import outside_slice
    from .runtime.engine import DeepSpeedEngine
    if training_data is not None:
        raise outside_slice("training_data and dataloaders",
                            "11i (dataloaders)")
    engine = DeepSpeedEngine(model=model, config=config,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler
