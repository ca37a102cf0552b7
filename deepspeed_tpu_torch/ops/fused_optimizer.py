"""Fused AdamW: the CUDA kernel wrapper, its plain version, and the
``torch.optim.Optimizer`` the training engine runs.

Counterpart of ``deepspeed_tpu/ops/fused_optimizer.py`` (:29
``_adamw_kernel``, :52 ``fused_adamw_flat``, :299 ``fused_adamw``); the
kernel (``csrc/fused_adamw.cu``) replaces ``_adamw_kernel``.  The TPU
kernel returns new p, m and v; the port updates them in place, which
saves a copy of the 16 bytes per parameter of masters and moments.  The
math is ``optax.adamw``: eps_root 0, bias corrections from the 1-based
update count taken in fp32, decoupled decay ``wd * p`` on every
parameter.  Lion and LAMB are not ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, F, I, P, stream_of

KERNEL = CudaKernel("fused_adamw.cu", {
    "fused_adamw_f32": [P, P, P, P, LL, F, F, F, F, F, I, P]})


def _fp32(x) -> float:
    """A Python float that fp32 holds exactly: the scalar the kernel gets."""
    return float(np.float32(x))


def adamw_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, wd: float, step: int) -> None:
    """Plain version of the kernel, in place on fp32 ``p``, ``m`` and
    ``v``: the TPU kernel's expressions in its order, with its scalars
    rounded to fp32 and ``1 - b``, ``b ** step`` taken in fp32."""
    one = np.float32(1.0)
    b1_, b2_ = np.float32(b1), np.float32(b2)
    bc1 = float(one - b1_ ** np.float32(step))
    bc2 = float(one - b2_ ** np.float32(step))
    m.copy_(float(b1_) * m + float(one - b1_) * g)
    v.copy_(float(b2_) * v + float(one - b2_) * g * g)
    update = (m / bc1) / (torch.sqrt(v / bc2) + _fp32(eps)) + _fp32(wd) * p
    p.copy_(p - _fp32(lr) * update)


def fused_adamw_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, lr: float, b1: float, b2: float,
                     eps: float, wd: float, step: int) -> None:
    """One AdamW update of fp32 ``p`` with gradient ``g`` and moments
    ``m``, ``v``, all in place; ``step`` is the 1-based update count.
    CPU tensors take :func:`adamw_reference`; CUDA tensors launch
    ``fused_adamw_f32`` (contiguous, 16-byte aligned, same size) or
    raise."""
    if step < 1:
        raise ValueError(f"step is the 1-based update count, got {step}")
    if p.device.type == "cpu":
        adamw_reference(p, g, m, v, lr, b1, b2, eps, wd, step)
        return
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.dtype != torch.float32 or t.device != p.device:
            raise TypeError(f"adamw kernel takes fp32 {name} on {p.device}, "
                            f"got {t.dtype} on {t.device}")
        if t.numel() != p.numel() or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"adamw kernel takes contiguous 16-byte aligned "
                             f"buffers of {p.numel()} elements, got {name} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if p.numel():
        KERNEL.launch("fused_adamw_f32", p.data_ptr(), g.data_ptr(),
                      m.data_ptr(), v.data_ptr(), p.numel(), _fp32(lr),
                      _fp32(b1), _fp32(b2), _fp32(eps), _fp32(wd), int(step),
                      stream_of(p))


class FusedAdamW(torch.optim.Optimizer):
    """AdamW over fp32 parameters through :func:`fused_adamw_flat`, one
    call (one kernel launch on the card) per parameter per step.  Moments
    are fp32 (``exp_avg``, ``exp_avg_sq``); ``step`` counts updates per
    parameter."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                fused_adamw_flat(p, p.grad, state["exp_avg"],
                                 state["exp_avg_sq"], group["lr"], b1, b2,
                                 group["eps"], group["weight_decay"],
                                 state["step"])
        return loss
