"""PyTorch + CUDA port of ``deepspeed_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
tree (``models/``, ``ops/``, ``inference/v2/``) so each module's
counterpart is found under the same name.  Nothing here imports JAX or
``deepspeed_tpu``.  Entry points run on ``cuda`` unless ``device="cpu"``
is asked for; on the CPU every hand-written kernel is replaced by its
plain PyTorch version.
"""
