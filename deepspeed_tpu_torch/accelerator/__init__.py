"""The accelerator interface and device resolution for the port's entry
points.

Counterpart of ``deepspeed_tpu/accelerator``: ``get_accelerator()`` is
the CUDA accelerator (``cuda_accelerator.py``; the CPU one only when
asked for, ``real_accelerator.py``).  Every entry point also takes an
explicit ``device``.  ``None`` means the GPU, and a missing GPU is an
error — the port never falls back to the CPU on its own.  ``"cpu"`` is
how the tests run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Union

import torch

from .abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from .real_accelerator import get_accelerator, set_accelerator  # noqa: F401

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> cpu; ``"cuda[:n]"`` -> that
    card.  Raises ``RuntimeError`` when CUDA is asked for (explicitly or
    by default) and torch sees no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
