"""Fused AdamW, Lion and LAMB: the CUDA kernel wrappers, their plain
versions, and the ``torch.optim.Optimizer`` classes the training engine
runs.

Counterpart of ``deepspeed_tpu/ops/fused_optimizer.py`` (:29
``_adamw_kernel``, :52 ``fused_adamw_flat``, :91 ``_lion_kernel``, :107
``fused_lion_flat``, :183 ``_lamb_stage1_kernel``, :208
``fused_lamb_flat``); the kernels ``csrc/fused_adamw.cu``,
``csrc/fused_lion.cu`` and ``csrc/fused_lamb.cu`` replace the three TPU
kernels.  The TPU kernels return new buffers; the port updates p and the
moments in place, which saves a copy of masters and moments.  The math
is optax's (``adamw``, ``lion``, ``lamb``): decoupled decay ``wd * p``
on every parameter, scalars rounded to fp32, bias corrections from the
1-based update count taken in fp32.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, F, I, P, stream_of

KERNEL = CudaKernel("fused_adamw.cu", {
    "fused_adamw_f32": [P, P, P, P, LL, F, F, F, F, F, I, P]})
LION_KERNEL = CudaKernel("fused_lion.cu", {
    "fused_lion_f32": [P, P, P, LL, F, F, F, F, P]})
LAMB_KERNEL = CudaKernel("fused_lamb.cu", {
    "fused_lamb_stage1_f32": [P, P, P, P, P, P, LL, I, F, F, F, F, I, P]})

# the LAMB kernel's grid: 256 threads a CTA, at most 8 CTAs per SM of 132
_LAMB_THREADS = 256
_LAMB_MAX_BLOCKS = 132 * 8


def _fp32(x) -> float:
    """A Python float that fp32 holds exactly: the scalar the kernel gets."""
    return float(np.float32(x))


def _check_step(step: int) -> None:
    if step < 1:
        raise ValueError(f"step is the 1-based update count, got {step}")


def _check_buffers(kernel: str, p: torch.Tensor, **others: torch.Tensor
                   ) -> None:
    """What the elementwise optimizer kernels take: fp32 buffers on p's
    device, contiguous, 16-byte aligned, of p's size."""
    for name, t in (("p", p), *others.items()):
        if t.dtype != torch.float32 or t.device != p.device:
            raise TypeError(f"{kernel} kernel takes fp32 {name} on "
                            f"{p.device}, got {t.dtype} on {t.device}")
        if t.numel() != p.numel() or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel takes contiguous 16-byte "
                             f"aligned buffers of {p.numel()} elements, got "
                             f"{name} {tuple(t.shape)} strides {t.stride()}")


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
    _check_step(step)
    if p.device.type == "cpu":
        adamw_reference(p, g, m, v, lr, b1, b2, eps, wd, step)
        return
    _check_buffers("adamw", p, g=g, m=m, v=v)
    if p.numel():
        KERNEL.launch("fused_adamw_f32", p.data_ptr(), g.data_ptr(),
                      m.data_ptr(), v.data_ptr(), p.numel(), _fp32(lr),
                      _fp32(b1), _fp32(b2), _fp32(eps), _fp32(wd), int(step),
                      stream_of(p))


def lion_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   lr: float, b1: float, b2: float, wd: float) -> None:
    """Plain version of the Lion kernel, in place on fp32 ``p`` and
    ``m``: the TPU kernel's expressions in its order, with its scalars
    rounded to fp32 and ``1 - b`` taken in fp32."""
    one = np.float32(1.0)
    b1_, b2_ = np.float32(b1), np.float32(b2)
    u = torch.sign(float(b1_) * m + float(one - b1_) * g)
    p.copy_(p - _fp32(lr) * (u + _fp32(wd) * p))
    m.copy_(float(b2_) * m + float(one - b2_) * g)


def fused_lion_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    lr: float, b1: float, b2: float, wd: float) -> None:
    """One Lion update of fp32 ``p`` with gradient ``g`` and momentum
    ``m``, both in place.  CPU tensors take :func:`lion_reference`; CUDA
    tensors launch ``fused_lion_f32`` (contiguous, 16-byte aligned, same
    size) or raise."""
    if p.device.type == "cpu":
        lion_reference(p, g, m, lr, b1, b2, wd)
        return
    _check_buffers("lion", p, g=g, m=m)
    if p.numel():
        LION_KERNEL.launch("fused_lion_f32", p.data_ptr(), g.data_ptr(),
                           m.data_ptr(), p.numel(), _fp32(lr), _fp32(b1),
                           _fp32(b2), _fp32(wd), stream_of(p))


def lamb_stage1_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, b1: float, b2: float, eps: float,
                          wd: float, step: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the LAMB stage-1 kernel: updates ``m`` and ``v``
    in place and returns the update ``u`` and ``[[sum p^2, sum u^2]]``
    (one row where the kernel gives one per CTA)."""
    one = np.float32(1.0)
    b1_, b2_ = np.float32(b1), np.float32(b2)
    bc1 = float(one - b1_ ** np.float32(step))
    bc2 = float(one - b2_ ** np.float32(step))
    m.copy_(float(b1_) * m + float(one - b1_) * g)
    v.copy_(float(b2_) * v + float(one - b2_) * g * g)
    u = (m / bc1) / (torch.sqrt(v / bc2) + _fp32(eps)) + _fp32(wd) * p
    return u, torch.stack([(p * p).sum(), (u * u).sum()])[None]


def lamb_stage1(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, b1: float, b2: float, eps: float, wd: float,
                step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """LAMB stage 1 on fp32 buffers: ``m`` and ``v`` in place; returns
    the update ``u`` (a new buffer) and the partial squared norms
    ``[rows, 2]`` of p and u.  CPU tensors take
    :func:`lamb_stage1_reference`; CUDA tensors launch
    ``fused_lamb_stage1_f32`` over a grid fixed by the size alone (the
    partial sums are deterministic) or raise."""
    _check_step(step)
    if p.device.type == "cpu":
        return lamb_stage1_reference(p, g, m, v, b1, b2, eps, wd, step)
    _check_buffers("lamb", p, g=g, m=m, v=v)
    n = p.numel()
    threads = -(-n // 4)
    nblocks = max(1, min(-(-threads // _LAMB_THREADS), _LAMB_MAX_BLOCKS))
    u = torch.empty_like(p)
    norms = torch.empty((nblocks, 2), dtype=torch.float32, device=p.device)
    LAMB_KERNEL.launch("fused_lamb_stage1_f32", p.data_ptr(), g.data_ptr(),
                       m.data_ptr(), v.data_ptr(), u.data_ptr(),
                       norms.data_ptr(), n, nblocks, _fp32(b1), _fp32(b2),
                       _fp32(eps), _fp32(wd), int(step), stream_of(p))
    return u, norms


def lamb_trust_step(p: torch.Tensor, u: torch.Tensor, norms: torch.Tensor,
                    lr: float) -> None:
    """``p -= lr * ratio * u`` in place with the per-tensor trust ratio
    ``||p|| / ||u||`` (1 where either is 0) from stage 1's partial sums
    (JAX ``fused_lamb_flat``, :244-247).  Torch ops on p's device, no
    host sync; ``u`` is scaled in place."""
    pn, un = norms.sum(dim=0).sqrt().unbind()
    ratio = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
    p.sub_(u.mul_(_fp32(lr) * ratio))


def lamb_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, lr: float, b1: float, b2: float,
                   eps: float, wd: float, step: int) -> None:
    """Plain LAMB update, in place on fp32 ``p``, ``m`` and ``v``."""
    u, norms = lamb_stage1_reference(p, g, m, v, b1, b2, eps, wd, step)
    lamb_trust_step(p, u, norms, lr)


def fused_lamb_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, wd: float, step: int) -> None:
    """One LAMB update of fp32 ``p`` with moments ``m``, ``v``, all in
    place: :func:`lamb_stage1` (the kernel on the card), then
    :func:`lamb_trust_step`."""
    u, norms = lamb_stage1(p, g, m, v, b1, b2, eps, wd, step)
    lamb_trust_step(p, u, norms, lr)


class _FusedOptimizer(torch.optim.Optimizer):
    """A flat update per parameter per step (one kernel launch on the
    card).  State: ``step``, the parameter's 1-based update count, and
    the fp32 moments named in ``_moments``."""

    _moments: Tuple[str, ...] = ()

    def _update(self, p: torch.Tensor, state: dict, group: dict) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for name in self._moments:
                        state[name] = torch.zeros_like(p)
                state["step"] += 1
                self._update(p, state, group)
        return loss


class FusedAdamW(_FusedOptimizer):
    """AdamW (``optax.adamw``) over fp32 parameters through
    :func:`fused_adamw_flat`; moments ``exp_avg``, ``exp_avg_sq``."""

    _moments = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _update(self, p, state, group):
        b1, b2 = group["betas"]
        fused_adamw_flat(p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                         group["lr"], b1, b2, group["eps"],
                         group["weight_decay"], state["step"])


class FusedLion(_FusedOptimizer):
    """Lion (``optax.lion``) over fp32 parameters through
    :func:`fused_lion_flat`; momentum ``exp_avg``, no eps."""

    _moments = ("exp_avg",)

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    def _update(self, p, state, group):
        b1, b2 = group["betas"]
        fused_lion_flat(p, p.grad, state["exp_avg"], group["lr"], b1, b2,
                        group["weight_decay"])


class FusedLamb(_FusedOptimizer):
    """LAMB (``optax.lamb``: per-tensor trust ratio, decay on every
    parameter) over fp32 parameters through :func:`fused_lamb_flat`;
    moments ``exp_avg``, ``exp_avg_sq``."""

    _moments = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _update(self, p, state, group):
        b1, b2 = group["betas"]
        fused_lamb_flat(p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                        group["lr"], b1, b2, group["eps"],
                        group["weight_decay"], state["step"])
