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

Each kernel has an instance for every mix of fp32 and bf16 p and g over
fp32 moments (pure bf16 training: the JAX engine's optax state holds
fp32 moments whatever the parameters' dtype, and the TPU kernel's own
reach is bf16 p over fp32 moments); the wrapper picks it from p's and
g's dtypes (:func:`entry_point`).  Every instance reads fp32, computes
in fp32 and rounds each output once, and so does its plain version.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, F, I, P, stream_of

#: the dtypes p and g may take, by their entry-point names
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _instance(base: str, names: Tuple[str, str]) -> str:
    """``<base>_f32`` for fp32 p and g, else ``<base>_<p>_<g>``."""
    if names == ("f32", "f32"):
        return f"{base}_f32"
    return "_".join((base,) + names)


def entry_point(base: str, p: torch.Tensor, g: torch.Tensor) -> str:
    """The instance for p's and g's dtypes."""
    return _instance(base, (DTYPE_NAMES[p.dtype], DTYPE_NAMES[g.dtype]))


def _instances(base: str, argtypes) -> dict:
    return {_instance(base, (p, g)): argtypes
            for p in DTYPE_NAMES.values() for g in DTYPE_NAMES.values()}


KERNEL = CudaKernel("fused_adamw.cu", _instances(
    "fused_adamw", [P, P, P, P, LL, F, F, F, F, F, I, P]))
LION_KERNEL = CudaKernel("fused_lion.cu", _instances(
    "fused_lion", [P, P, P, LL, F, F, F, F, P]))
LAMB_KERNEL = CudaKernel("fused_lamb.cu", _instances(
    "fused_lamb_stage1", [P, P, P, P, P, P, LL, I, F, F, F, F, I, P]))

# the LAMB kernel's grid: 256 threads a CTA, at most 8 CTAs per SM of 132
_LAMB_THREADS = 256
_LAMB_MAX_BLOCKS = 132 * 8


def _fp32(x) -> float:
    """A Python float that fp32 holds exactly: the scalar the kernel gets."""
    return float(np.float32(x))


def bias_correction(b: float, count: int) -> float:
    """``1 - b ** count`` in fp32, as the TPU kernels and optax take it
    (the count is the 1-based update count)."""
    return float(np.float32(1) - np.float32(b) ** np.float32(count))


def _check_step(step: int) -> None:
    if step < 1:
        raise ValueError(f"step is the 1-based update count, got {step}")


def _check_buffers(kernel: str, p: torch.Tensor, g: torch.Tensor,
                   **moments: torch.Tensor) -> None:
    """What the elementwise optimizer kernels take: fp32 or bf16 p and g
    and fp32 moments on p's device, contiguous, 16-byte aligned, of p's
    size."""
    for name, t in (("p", p), ("g", g), *moments.items()):
        dtypes = DTYPE_NAMES if name in ("p", "g") else (torch.float32,)
        if t.dtype not in dtypes or t.device != p.device:
            kind = "fp32 or bf16" if name in ("p", "g") else "fp32"
            raise TypeError(f"{kernel} kernel takes {kind} {name} on "
                            f"{p.device}, got {t.dtype} on {t.device}")
        if t.numel() != p.numel() or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel takes contiguous 16-byte "
                             f"aligned buffers of {p.numel()} elements, got "
                             f"{name} {tuple(t.shape)} strides {t.stride()}")


def adamw_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, wd: float, step: int) -> None:
    """Plain version of the kernel, in place on ``p`` (fp32 or bf16),
    ``m`` and ``v``: the TPU kernel's expressions in its order over the
    fp32 values, with its scalars rounded to fp32 and ``1 - b``,
    ``b ** step`` taken in fp32; each output rounded once."""
    one = np.float32(1.0)
    b1_, b2_ = np.float32(b1), np.float32(b2)
    bc1, bc2 = bias_correction(b1, step), bias_correction(b2, step)
    P, G = p.float(), g.float()
    M = float(b1_) * m.float() + float(one - b1_) * G
    V = float(b2_) * v.float() + float(one - b2_) * G * G
    update = (M / bc1) / (torch.sqrt(V / bc2) + _fp32(eps)) + _fp32(wd) * P
    p.copy_(P - _fp32(lr) * update)
    m.copy_(M)
    v.copy_(V)


def fused_adamw_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, lr: float, b1: float, b2: float,
                     eps: float, wd: float, step: int) -> None:
    """One AdamW update of ``p`` with gradient ``g`` and moments ``m``,
    ``v``, all in place; ``step`` is the 1-based update count.  CPU
    tensors take :func:`adamw_reference`; CUDA tensors launch the
    instance for their dtypes (:func:`entry_point`; contiguous, 16-byte
    aligned, same size) or raise."""
    _check_step(step)
    if p.device.type == "cpu":
        adamw_reference(p, g, m, v, lr, b1, b2, eps, wd, step)
        return
    _check_buffers("adamw", p, g, m=m, v=v)
    if p.numel():
        KERNEL.launch(entry_point("fused_adamw", p, g), p.data_ptr(),
                      g.data_ptr(),
                      m.data_ptr(), v.data_ptr(), p.numel(), _fp32(lr),
                      _fp32(b1), _fp32(b2), _fp32(eps), _fp32(wd), int(step),
                      stream_of(p))


def lion_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   lr: float, b1: float, b2: float, wd: float) -> None:
    """Plain version of the Lion kernel, in place on ``p`` (fp32 or
    bf16) and ``m``: the TPU kernel's expressions in its order over the
    fp32 values, with its scalars rounded to fp32 and ``1 - b`` taken in
    fp32; each output rounded once."""
    one = np.float32(1.0)
    b1_, b2_ = np.float32(b1), np.float32(b2)
    P, G, M = p.float(), g.float(), m.float()
    u = torch.sign(float(b1_) * M + float(one - b1_) * G)
    p.copy_(P - _fp32(lr) * (u + _fp32(wd) * P))
    m.copy_(float(b2_) * M + float(one - b2_) * G)


def fused_lion_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    lr: float, b1: float, b2: float, wd: float) -> None:
    """One Lion update of ``p`` with gradient ``g`` and momentum ``m``,
    both in place.  CPU tensors take :func:`lion_reference`; CUDA
    tensors launch the instance for their dtypes (contiguous, 16-byte
    aligned, same size) or raise."""
    if p.device.type == "cpu":
        lion_reference(p, g, m, lr, b1, b2, wd)
        return
    _check_buffers("lion", p, g, m=m)
    if p.numel():
        LION_KERNEL.launch(entry_point("fused_lion", p, g), p.data_ptr(),
                           g.data_ptr(),
                           m.data_ptr(), p.numel(), _fp32(lr), _fp32(b1),
                           _fp32(b2), _fp32(wd), stream_of(p))


def lamb_stage1_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, b1: float, b2: float, eps: float,
                          wd: float, step: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the LAMB stage-1 kernel: updates ``m`` and ``v``
    in place (each rounded once into its dtype) and returns the fp32
    update ``u`` and ``[[sum p^2, sum u^2]]`` (one row where the kernel
    gives one per CTA)."""
    one = np.float32(1.0)
    b1_, b2_ = np.float32(b1), np.float32(b2)
    bc1, bc2 = bias_correction(b1, step), bias_correction(b2, step)
    P, G = p.float(), g.float()
    M = float(b1_) * m.float() + float(one - b1_) * G
    V = float(b2_) * v.float() + float(one - b2_) * G * G
    u = (M / bc1) / (torch.sqrt(V / bc2) + _fp32(eps)) + _fp32(wd) * P
    m.copy_(M)
    v.copy_(V)
    return u, torch.stack([(P * P).sum(), (u * u).sum()])[None]


def lamb_stage1(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, b1: float, b2: float, eps: float, wd: float,
                step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """LAMB stage 1: ``m`` and ``v`` in place; returns the fp32 update
    ``u`` (a new buffer) and the partial squared norms ``[rows, 2]`` of
    p and u.  CPU tensors take :func:`lamb_stage1_reference`; CUDA
    tensors launch the instance for their dtypes over a grid fixed by
    the size alone (the partial sums are deterministic) or raise."""
    _check_step(step)
    if p.device.type == "cpu":
        return lamb_stage1_reference(p, g, m, v, b1, b2, eps, wd, step)
    _check_buffers("lamb", p, g, m=m, v=v)
    n = p.numel()
    threads = -(-n // 4)
    nblocks = max(1, min(-(-threads // _LAMB_THREADS), _LAMB_MAX_BLOCKS))
    u = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    norms = torch.empty((nblocks, 2), dtype=torch.float32, device=p.device)
    LAMB_KERNEL.launch(entry_point("fused_lamb_stage1", p, g),
                       p.data_ptr(), g.data_ptr(),
                       m.data_ptr(), v.data_ptr(), u.data_ptr(),
                       norms.data_ptr(), n, nblocks, _fp32(b1), _fp32(b2),
                       _fp32(eps), _fp32(wd), int(step), stream_of(p))
    return u, norms


def lamb_trust_step(p: torch.Tensor, u: torch.Tensor, norms: torch.Tensor,
                    lr: float) -> None:
    """``p -= lr * ratio * u`` in place with the per-tensor trust ratio
    ``||p|| / ||u||`` (1 where either is 0) from stage 1's partial sums
    (JAX ``fused_lamb_flat``, :244-247).  Torch ops on p's device, no
    host sync; ``u`` is scaled in place, and a bf16 p is rounded once."""
    pn, un = norms.sum(dim=0).sqrt().unbind()
    ratio = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
    p.sub_(u.mul_(_fp32(lr) * ratio))


def lamb_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, lr: float, b1: float, b2: float,
                   eps: float, wd: float, step: int) -> None:
    """Plain LAMB update, in place on ``p``, ``m`` and ``v``."""
    u, norms = lamb_stage1_reference(p, g, m, v, b1, b2, eps, wd, step)
    lamb_trust_step(p, u, norms, lr)


def fused_lamb_flat(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, lr: float, b1: float, b2: float,
                    eps: float, wd: float, step: int) -> None:
    """One LAMB update of ``p`` with moments ``m``, ``v``, all in
    place: :func:`lamb_stage1` (the kernel on the card), then
    :func:`lamb_trust_step`."""
    u, norms = lamb_stage1(p, g, m, v, b1, b2, eps, wd, step)
    lamb_trust_step(p, u, norms, lr)


class PortOptimizer(torch.optim.Optimizer):
    """An update per parameter per step.  State: ``step``, the
    parameter's 1-based update count (optax's ``count``), and the
    moments named in ``_moments``, fp32 whatever the parameter's dtype:
    the JAX engine's optax state under pure bf16 is created in the
    parameters' dtype and holds fp32 from the first update on (the fp32
    gradients promote it), zeros before, so fp32 from the start gives
    its numbers.  :meth:`step` takes the gradients as a list in
    parameter order (a pure-bf16 master's accumulator may be fp32, which
    ``.grad`` cannot hold), else reads ``.grad``.  ``lr_count_offset`` 1
    marks an optimizer whose schedule is read at the 1-based count."""

    _moments: Tuple[str, ...] = ()
    lr_count_offset = 0

    def _update(self, p: torch.Tensor, g: torch.Tensor, state: dict,
                group: dict) -> None:
        raise NotImplementedError

    def _init_state(self, p: torch.Tensor, state: dict) -> None:
        state["step"] = 0
        for name in self._moments:
            state[name] = torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)

    @torch.no_grad()
    def step(self, closure=None, grads=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = iter(grads) if grads is not None else None
        for group in self.param_groups:
            for p in group["params"]:
                g = next(grads) if grads is not None else p.grad
                if g is None:
                    continue
                state = self.state[p]
                if not state:
                    self._init_state(p, state)
                state["step"] += 1
                self._update(p, g, state, group)
        return loss


class FusedAdamW(PortOptimizer):
    """AdamW (``optax.adamw``) through :func:`fused_adamw_flat`; moments
    ``exp_avg``, ``exp_avg_sq``."""

    _moments = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        fused_adamw_flat(p, g, state["exp_avg"], state["exp_avg_sq"],
                         group["lr"], b1, b2, group["eps"],
                         group["weight_decay"], state["step"])


class FusedLion(PortOptimizer):
    """Lion (``optax.lion``) through :func:`fused_lion_flat`; momentum
    ``exp_avg``, no eps."""

    _moments = ("exp_avg",)

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      weight_decay=weight_decay))

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        fused_lion_flat(p, g, state["exp_avg"], group["lr"], b1, b2,
                        group["weight_decay"])


class FusedLamb(PortOptimizer):
    """LAMB (``optax.lamb``: per-tensor trust ratio, decay on every
    parameter) through :func:`fused_lamb_flat`; moments ``exp_avg``,
    ``exp_avg_sq``."""

    _moments = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        #: ``id(p)`` -> the process group over which p is one shard of a
        #: leaf: its partial norms are summed over the group before the
        #: trust ratio (the ratio is the whole leaf's)
        self.norm_groups = {}

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        u, norms = lamb_stage1(p, g, state["exp_avg"], state["exp_avg_sq"],
                               b1, b2, group["eps"], group["weight_decay"],
                               state["step"])
        shards = self.norm_groups.get(id(p))
        if shards is not None:
            from ..comm import comm
            norms = comm.all_reduce(norms.sum(dim=0, keepdim=True), shards)
        lamb_trust_step(p, u, norms, group["lr"])
