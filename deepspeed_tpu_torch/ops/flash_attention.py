"""Flash attention: the CUDA kernel wrappers, their plain references and
the autograd node that ties the forward and backward kernels together.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``.
``csrc/flash_fwd.cu`` replaces ``_fwd_kernel``; ``csrc/flash_bwd.cu``
replaces ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``.  Layout [B, H, S, D];
k and v may carry fewer (GQA) heads, query head h reading kv head
``h // (H // K)`` — the same result as repeating them, so the backward
sums each kv head's dK/dV over its G query heads.

:class:`FlashAttention` is the JAX ``custom_vjp`` (:315-336) as a
``torch.autograd.Function``: the forward saves ``q, k, v, out, lse`` and
the backward computes ``delta = rowsum(dO * O)`` in fp32 and runs the two
backward kernels.  :func:`flash_attention` goes through it, so it is
differentiable.  On CPU tensors every piece takes its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, F, I, P, stream_of
from .paged_attention import HEAD_DIMS

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL = CudaKernel("flash_fwd.cu", {
    "flash_fwd_bf16": [P] * 5 + [I] * 6 + [LL] * 12 + [F, I, I, P]})

BWD_KERNEL = CudaKernel("flash_bwd.cu", {
    "flash_bwd_dkv_bf16": [P] * 8 + [I] * 6 + [LL] * 12 + [F, I, I, P],
    "flash_bwd_dq_bf16": [P] * 7 + [I] * 6 + [LL] * 12 + [F, I, I, P]})

# HEAD_DIMS: the widths the forward kernel is instantiated for, one set
# with the paged kernel's, since both run the tile of ``attn_tile.cuh``
#: head dims the backward kernels take (``flash_bwd.cu``, a template
#: instance at each, on the forward's padded tile): training takes the
#: flash path on the card at these alone
BWD_HEAD_DIMS = (64, 80, 96, 128)


def _repeat_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    groups = heads // k.shape[1]
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=1)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """fp32, or fp64 for fp64 inputs (so gradcheck sees fp64 arithmetic)."""
    return x if x.dtype == torch.float64 else x.float()


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return sm_scale if sm_scale is not None else 1.0 / np.sqrt(d)


def _scores(q, k, causal, sm_scale, window):
    scale = _scale(q.shape[-1], sm_scale)
    k = _repeat_kv(k, q.shape[1])
    scores = _wide(torch.einsum("bhqd,bhkd->bhqk", q, k)) * scale
    s_q, s_k = scores.shape[-2:]
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        mask &= torch.ones_like(mask).tril(diagonal=s_k - s_q)
    if window is not None:
        q_pos = torch.arange(s_q, device=q.device)[:, None] + (s_k - s_q)
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        mask &= (q_pos - k_pos) < window
    if causal or window is not None:
        scores = torch.where(mask, scores, DEFAULT_MASK_VALUE)
    return scores


def mha_reference(q, k, v, causal: bool = True,
                  sm_scale: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """[B,H,S,D] attention with an fp32 softmax — semantics ground truth
    (``window``: position t attends to (t - window, t])."""
    probs = torch.softmax(_scores(q, k, causal, sm_scale, window),
                          dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, _repeat_kv(v, q.shape[1]))


def flash_reference(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (out, lse) with lse [B, H, S]
    fp32."""
    scores = _scores(q, k, causal, sm_scale, window)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, _repeat_kv(v, q.shape[1]))
    return out, lse


def flash_bwd_reference(q, k, v, out, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: the TPU kernels' formulas,
    not autograd, over the whole S x S block.

    ``delta = rowsum(dO * O)`` and ``p = exp(s - lse)`` in fp32, ``dS =
    p * (dP - delta) * scale``; p and dS are rounded to the input dtype
    before their products, which accumulate in fp32 (the TPU kernels'
    ``preferred_element_type``).  dK and dV of a kv head sum over its G
    query heads.  Returns (dq, dk, dv) in the input dtypes."""
    b, h, s_q, d = q.shape
    kh = k.shape[1]
    scale = _scale(d, sm_scale)
    delta = (_wide(do) * _wide(out)).sum(-1)
    p = torch.exp(_scores(q, k, causal, sm_scale, window) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", _wide(p.to(do.dtype)), _wide(do))
    dp = torch.einsum("bhqd,bhkd->bhqk", _wide(do),
                      _wide(_repeat_kv(v, h)))
    ds = _wide((p * (dp - delta[..., None]) * scale).to(q.dtype))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _wide(q))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _wide(_repeat_kv(k, h)))
    dk = dk.reshape(b, kh, h // kh, *dk.shape[2:]).sum(2)
    dv = dv.reshape(b, kh, h // kh, *dv.shape[2:]).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rows_readable(t) -> bool:
    """The kernels read rows with 16-byte loads through the strides."""
    return (t.stride(-1) == 1 and not t.data_ptr() % 16
            and not any(s % 8 for s in t.stride()[:-1]))


def _check_operand(name, t, device, head_dims=HEAD_DIMS):
    if t.dtype != torch.bfloat16 or t.device != device:
        raise TypeError(f"flash kernel takes bf16 {name} on {device}, got "
                        f"{t.dtype} on {t.device}")
    if t.shape[-1] not in head_dims or not _rows_readable(t):
        raise ValueError(f"flash kernel takes head_dim in {head_dims} in "
                         f"16-byte aligned rows with a contiguous last dim, "
                         f"got {name} {tuple(t.shape)} strides {t.stride()}")


def _check_shapes(q, k, v, causal):
    b, h = q.shape[:2]
    if k.shape != v.shape or k.shape[0] != b or h % k.shape[1] \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash kernel shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal flash kernel needs Sq == Sk")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Sq,D], k/v [B,K,Sk,D] -> (out [B,H,Sq,D], lse [B,H,Sq]),
    D in ``HEAD_DIMS``.  CPU tensors take :func:`flash_reference`; CUDA
    tensors launch ``flash_fwd_bf16`` or raise.  Strided views (e.g. a
    transposed [B,S,H,D] activation) are read in place."""
    if q.device.type == "cpu":
        return flash_reference(q, k, v, causal, sm_scale, window)
    b, h, s_q, d = q.shape
    kh, s_k = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    _check_shapes(q, k, v, causal)
    out = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if out.numel():
        KERNEL.launch("flash_fwd_bf16", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      b, h, kh, s_q, s_k, d, *q.stride()[:3], *k.stride()[:3],
                      *v.stride()[:3], *out.stride()[:3],
                      float(_scale(d, sm_scale)), int(bool(causal)),
                      int(window or 0), stream_of(q))
    return out, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_fwd` given its ``out``, ``lse`` and
    the output gradient ``do``, D in ``BWD_HEAD_DIMS``.  CPU tensors take
    :func:`flash_bwd_reference`; CUDA tensors launch ``flash_bwd_dkv_bf16``
    and ``flash_bwd_dq_bf16`` or raise.  q, k, v and do are read through
    their strides; a ``do`` whose last dim is not contiguous (an expanded
    gradient) is copied first, and ``BWD_KERNEL.copies`` counts it."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, out, lse, do, causal, sm_scale,
                                   window)
    b, h, s_q, d = q.shape
    kh, s_k = k.shape[1], k.shape[2]
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash backward shapes q {tuple(q.shape)}, "
                         f"out {tuple(out.shape)}, do {tuple(do.shape)}")
    if not _rows_readable(do):
        do = do.contiguous()
        BWD_KERNEL.copies += 1
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand(name, t, q.device, BWD_HEAD_DIMS)
    _check_shapes(q, k, v, causal)
    if lse.dtype != torch.float32 or lse.shape != (b, h, s_q) \
            or not lse.is_contiguous():
        raise ValueError(f"flash backward takes a contiguous fp32 lse "
                         f"{(b, h, s_q)}, got {lse.dtype} {tuple(lse.shape)}")
    delta = bwd_delta(do, out)
    dq = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kh, s_k, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kh, s_k, d), dtype=v.dtype, device=q.device)
    if dq.numel():
        for fn, args in bwd_launch_args(q, k, v, do, lse, delta, dq, dk, dv,
                                        causal, sm_scale, window).items():
            BWD_KERNEL.launch(fn, *args)
    return dq, dk, dv


def bwd_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, [B, H, S], over the D columns of
    the head (the kernels' tiles are padded, the operands are not): what
    the backward kernels read beside lse.  ``out`` is widened inside the
    product (the same values as ``out.float()``, one pass fewer)."""
    return (do.float() * out).sum(-1)


def bwd_launch_args(q, k, v, do, lse, delta, dq, dk, dv, causal, sm_scale,
                    window) -> dict:
    """The arguments of the two backward kernels, by C entry point (dK/dV
    first), for operands :func:`flash_bwd` has checked."""
    b, h, s_q, d = q.shape
    common = (b, h, k.shape[1], s_q, k.shape[2], d, *q.stride()[:3],
              *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
              float(_scale(d, sm_scale)), int(bool(causal)),
              int(window or 0), stream_of(q))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    return {"flash_bwd_dkv_bf16": (*inputs, dk.data_ptr(), dv.data_ptr(),
                                   *common),
            "flash_bwd_dq_bf16": (*inputs, dq.data_ptr(), *common)}


@torch.library.custom_op("deepspeed_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, sm_scale: Optional[float],
                 window: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_fwd` as one operator the dispatcher sees, so that a
    selective activation checkpoint can keep its ``(out, lse)`` and the
    recomputation skip the kernel (``models/transformer.py``'s
    ``save_attn_out`` and ``offload_attn_out``)."""
    return flash_fwd(q, k, v, causal, sm_scale, window)


@torch.library.custom_op("deepspeed_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool, sm_scale: Optional[float],
                 window: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_bwd` as one operator the dispatcher sees, so that a
    dispatch mode (the flops profiler's counter) sees the backward as one
    call rather than its launches' host code."""
    return flash_bwd(q, k, v, out, lse, do, causal, sm_scale, window)


def attended_pairs(s_q: int, s_k: int, causal: bool,
                   window: Optional[int]) -> int:
    """The (query, key) pairs the kernels attend to in one head: all of
    them, or the causal triangle, cut to the last ``window`` keys."""
    if not causal:
        return s_q * s_k
    w = min(window or s_k, s_k)
    # row i attends min(i + 1, w) keys
    return w * (w + 1) // 2 + (s_q - w) * w if s_q >= w else \
        s_q * (s_q + 1) // 2


def flash_fwd_flops(q_shape, k_shape, v_shape, causal, sm_scale, window,
                    *args, out_shape=None, **kwargs) -> int:
    """The forward's matrix products, ``Q K^T`` and ``P V`` over the
    attended pairs: 4 B H D pairs (a flop formula for the counter)."""
    b, h, s_q, d = q_shape
    return 4 * b * h * d * attended_pairs(s_q, k_shape[2], causal, window)


def flash_bwd_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape,
                    do_shape, causal, sm_scale, window, *args,
                    out_shape=None, **kwargs) -> int:
    """The backward's products as an algorithm counts them (dV, dP, dQ
    and dK, the recomputed ``Q K^T`` left out): twice the forward's."""
    b, h, s_q, d = q_shape
    return 8 * b * h * d * attended_pairs(s_q, k_shape[2], causal, window)


#: the flops formulas of the flash operators, by operator
FLOP_FORMULAS = {torch.ops.deepspeed_tpu_torch.flash_fwd: flash_fwd_flops,
                 torch.ops.deepspeed_tpu_torch.flash_bwd: flash_bwd_flops}


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: :func:`flash_fwd` forward (through
    :func:`flash_fwd_op` when a gradient is wanted), :func:`flash_bwd`
    backward from the saved ``q, k, v, out, lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, sm_scale=None, window=None):
        # training (an input needs a gradient) goes through the operator
        # a checkpoint policy can see; serving calls the wrapper
        fwd = flash_fwd_op if any(ctx.needs_input_grad[:3]) else flash_fwd
        out, lse = fwd(q, k, v, bool(causal), sm_scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = (causal, sm_scale, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, window = ctx.options
        dq, dk, dv = flash_bwd_op(q, k, v, out, lse, do, bool(causal),
                                  sm_scale, window)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention, [B,H,S,D]; returns only the output and is
    differentiable through :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v, causal, sm_scale, window)
