"""Flash attention forward: the CUDA kernel wrapper and the plain
reference.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``; the kernel
(``csrc/flash_fwd.cu``) replaces ``_fwd_kernel``.  Layout [B, H, S, D];
k and v may carry fewer (GQA) heads, query head h reading kv head
``h // (H // K)`` — the same result as repeating them.  The backward
kernels are not ported yet (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, F, I, P, stream_of

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL = CudaKernel("flash_fwd.cu", {
    "flash_fwd_bf16": [P, P, P, P, P, I, I, I, I, I] + [LL] * 12
                      + [F, I, I, P]})

HEAD_DIM = 128


def _repeat_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    groups = heads // k.shape[1]
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=1)


def _scores(q, k, causal, sm_scale, window):
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(d)
    k = _repeat_kv(k, q.shape[1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
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
    """Plain version of the kernel: (out, lse) with lse [B, H, S] fp32."""
    scores = _scores(q, k, causal, sm_scale, window)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, _repeat_kv(v, q.shape[1]))
    return out, lse


def _check_operand(name, t, device):
    if t.dtype != torch.bfloat16 or t.device != device:
        raise TypeError(f"flash kernel takes bf16 {name} on {device}, got "
                        f"{t.dtype} on {t.device}")
    if t.shape[-1] != HEAD_DIM or t.stride(-1) != 1:
        raise ValueError(f"flash kernel takes head_dim {HEAD_DIM} with a "
                         f"contiguous last dim, got {name} {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"flash kernel needs 16-byte aligned rows of {name}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Sq,D], k/v [B,K,Sk,D] -> (out [B,H,Sq,D], lse [B,H,Sq]).
    CPU tensors take :func:`flash_reference`; CUDA tensors launch
    ``flash_fwd_bf16`` or raise.  Strided views (e.g. a transposed
    [B,S,H,D] activation) are read in place."""
    if q.device.type == "cpu":
        return flash_reference(q, k, v, causal, sm_scale, window)
    b, h, s_q, d = q.shape
    kh, s_k = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device)
    if k.shape != v.shape or k.shape[0] != b or h % kh:
        raise ValueError(f"flash kernel shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and s_q != s_k:
        raise ValueError("causal flash kernel needs Sq == Sk")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if out.numel():
        KERNEL.launch("flash_fwd_bf16", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                      b, h, kh, s_q, s_k, *q.stride()[:3], *k.stride()[:3],
                      *v.stride()[:3], *out.stride()[:3], float(scale),
                      int(bool(causal)), int(window or 0), stream_of(q))
    return out, lse


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Blockwise attention, [B,H,S,D]; returns only the output."""
    return flash_fwd(q, k, v, causal, sm_scale, window)[0]
