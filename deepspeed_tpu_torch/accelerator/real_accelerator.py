"""Accelerator selection (counterpart of
``deepspeed_tpu/accelerator/real_accelerator.py``).

``get_accelerator()`` is the CUDA accelerator.  The port never falls
back to the host on its own: without a card it raises unless the CPU is
asked for, by ``DS_ACCELERATOR=cpu`` (the reference's variable) or
``set_accelerator(CPU_Accelerator())``, as the tests do.
"""

from __future__ import annotations

import os
from typing import Optional

from .abstract_accelerator import DeepSpeedAccelerator
from ..utils.logging import logger

SUPPORTED_ACCELERATOR_LIST = ["cuda", "cpu"]

_accelerator: Optional[DeepSpeedAccelerator] = None


def get_accelerator() -> DeepSpeedAccelerator:
    global _accelerator
    if _accelerator is not None:
        return _accelerator
    name = os.environ.get("DS_ACCELERATOR", "cuda")
    if name not in SUPPORTED_ACCELERATOR_LIST:
        raise ValueError(
            f"DS_ACCELERATOR={name!r} not in {SUPPORTED_ACCELERATOR_LIST}")
    if name == "cpu":
        from .cpu_accelerator import CPU_Accelerator
        _accelerator = CPU_Accelerator()
    else:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torch.cuda.is_available() is False.  Set "
                "DS_ACCELERATOR=cpu (or set_accelerator(CPU_Accelerator())) "
                "to run on the host")
        from .cuda_accelerator import CUDA_Accelerator
        _accelerator = CUDA_Accelerator()
    logger.info("Setting accelerator to %s", _accelerator.device_name())
    return _accelerator


def set_accelerator(accel: Optional[DeepSpeedAccelerator]) -> None:
    """Pin the accelerator ``get_accelerator`` returns (None: choose
    again at the next call)."""
    global _accelerator
    _accelerator = accel
