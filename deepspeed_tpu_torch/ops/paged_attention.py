"""Paged (blocked-KV) attention for ragged inference batches.

Counterpart of ``deepspeed_tpu/ops/paged_attention.py``.  A ragged batch
is padded to a static ``[S, Q]`` grid (``ragged/batch.py``):

* ``write_kv``        — scatter new K/V into cache pages IN PLACE (the
                        JAX package returned a new array and donated the
                        old one); padding rows write to null page 0.
* ``paged_attention`` — the plain version: gather each slot's pages and
                        run masked GQA attention over ``[S, C]`` context.
* ``paged_decode_attention`` — the CUDA kernel wrapper
                        (``csrc/paged_attention.cu``, replacing the
                        Pallas ``_decode_kernel``); CPU tensors take the
                        plain version.
* ``gather_last``     — last-token hidden-state gather for logits.

Only fp pages are ported; the int8 ``KVPages`` store is a later slice.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .kernel_loader import CudaKernel, F, I, P, stream_of

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL = CudaKernel("paged_attention.cu", {
    "paged_attention_bf16": [P, P, P, P, P, P] + [I] * 6 + [F, I, P]})

HEAD_DIM = 128
#: keys per shared-memory stage of the kernel (pages may be smaller)
MAX_PAGE = 64


def token_positions(start_pos: torch.Tensor, q_len_max: int) -> torch.Tensor:
    """pos[s, i] = start_pos[s] + i  (int64, [S, Q])."""
    return start_pos[:, None].long() + torch.arange(
        q_len_max, device=start_pos.device)[None, :]


def write_kv(kv_layer: torch.Tensor, k_new: torch.Tensor,
             v_new: torch.Tensor, page_table: torch.Tensor,
             start_pos: torch.Tensor, q_lens: torch.Tensor) -> torch.Tensor:
    """Scatter new KV into the cache pages of one layer, in place.

    kv_layer : [num_pages+1, page_size, 2, K, D]
    k_new/v_new : [S, Q, K, D]
    Rows past a slot's ``q_lens`` go to the null page 0, whose contents
    are garbage by contract.  Returns ``kv_layer``."""
    S, Q = k_new.shape[:2]
    page_size = kv_layer.shape[1]
    pos = token_positions(start_pos, Q)                     # [S, Q]
    valid = torch.arange(Q, device=pos.device)[None, :] < q_lens[:, None]
    page_idx = torch.clamp(pos // page_size, max=page_table.shape[1] - 1)
    pages = torch.gather(page_table.long(), 1, page_idx)
    pages = torch.where(valid, pages, torch.zeros_like(pages))
    kv_new = torch.stack([k_new, v_new], dim=2)             # [S,Q,2,K,D]
    kv_layer[pages.reshape(-1), (pos % page_size).reshape(-1)] = \
        kv_new.reshape((S * Q,) + kv_new.shape[2:]).to(kv_layer.dtype)
    return kv_layer


def rope_write_kv(kv_layer, k_new, v_new, sin, cos, page_table, start_pos,
                  q_lens) -> torch.Tensor:
    """Rotate K, then write it with V (reference
    ``linear_blocked_kv_rotary``)."""
    from ..models.transformer import apply_rope
    return write_kv(kv_layer, apply_rope(k_new, sin, cos), v_new,
                    page_table, start_pos, q_lens)


def paged_attention(q: torch.Tensor, kv_layer: torch.Tensor,
                    page_table: torch.Tensor, start_pos: torch.Tensor,
                    q_lens: Optional[torch.Tensor] = None, *,
                    sm_scale: Optional[float] = None,
                    alibi_slopes=None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Plain version: masked GQA attention of [S, Q] new tokens over
    their paged context (the JAX dense-gather path).

    q        : [S, Q, H, D]    (H = K * groups)
    kv_layer : [num_pages+1, page_size, 2, K, D] (new KV already written)
    Returns  : [S, Q, H, D].  ``q_lens`` is unused: rows past it compute
    garbage that logits gather and the null page ignore."""
    S, Q, H, D = q.shape
    page_size, K = kv_layer.shape[1], kv_layer.shape[3]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(D)
    pages = kv_layer[page_table.long()]          # [S, P, page, 2, K, D]
    C = pages.shape[1] * page_size
    k = pages[..., 0, :, :].reshape(S, C, K, D)
    v = pages[..., 1, :, :].reshape(S, C, K, D)
    qg = q.reshape(S, Q, K, G, D)
    scores = torch.einsum("sqkgd,sckd->skgqc", qg, k).float() * scale
    pos = token_positions(start_pos, Q)                     # [S, Q]
    ctx = torch.arange(C, device=q.device)
    if alibi_slopes is not None:
        # head h = k*G + g matches the grouped reshape above
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                             device=q.device).reshape(K, G)
        scores = scores + sl[None, :, :, None, None] * ctx.float()
    # context row c IS position c (pages fill in order)
    mask = ctx[None, None, :] <= pos[:, :, None]            # [S, Q, C]
    if window is not None:  # Mistral sliding window: (pos-window, pos]
        mask &= ctx[None, None, :] > pos[:, :, None] - window
    scores = torch.where(mask[:, None, None, :, :], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("skgqc,sckd->sqkgd", probs, v)
    return out.reshape(S, Q, H, D)


def paged_decode_attention(q: torch.Tensor, kv_layer: torch.Tensor,
                           page_table: torch.Tensor, start_pos: torch.Tensor,
                           *, sm_scale: Optional[float] = None,
                           alibi_slopes=None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Ragged paged attention (any Q: decode rows and prefill chunks with
    per-row causal limits).  CPU tensors take :func:`paged_attention`;
    CUDA tensors launch ``paged_attention_bf16`` or raise.

    q: [S, Q, H, D] bf16; kv_layer: [num_pages+1, page, 2, K, D] bf16;
    page_table: [S, P] int32; start_pos: [S] int32.  Returns [S, Q, H, D].
    """
    if q.device.type == "cpu":
        return paged_attention(q, kv_layer, page_table, start_pos,
                               sm_scale=sm_scale, alibi_slopes=alibi_slopes,
                               window=window)
    S, Q, H, D = q.shape
    pages_total, page_size, two, K, Dk = kv_layer.shape
    dev = q.device
    if q.dtype != torch.bfloat16 or kv_layer.dtype != torch.bfloat16:
        raise TypeError(f"paged kernel takes bf16 q and pages, got {q.dtype}"
                        f" / {kv_layer.dtype}")
    if D != HEAD_DIM or Dk != D or two != 2 or H % K:
        raise ValueError(f"paged kernel needs head_dim {HEAD_DIM} and H % K "
                         f"== 0: q {tuple(q.shape)}, kv "
                         f"{tuple(kv_layer.shape)}")
    if not 1 <= page_size <= MAX_PAGE:
        raise ValueError(f"paged kernel takes pages of <= {MAX_PAGE} tokens,"
                         f" got {page_size}")
    if page_table.dtype != torch.int32 or start_pos.dtype != torch.int32:
        raise TypeError("paged kernel takes int32 page_table / start_pos")
    if page_table.shape[0] != S or start_pos.shape != (S,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / start_pos "
                         f"{tuple(start_pos.shape)} do not match S={S}")
    for name, t in (("q", q), ("kv", kv_layer), ("page_table", page_table),
                    ("start_pos", start_pos)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"paged kernel takes a contiguous {name} on "
                             f"{dev}")
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).contiguous()
        if slopes.shape != (H,):
            raise ValueError(f"alibi slopes {tuple(slopes.shape)} != ({H},)")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if q.numel():
        KERNEL.launch("paged_attention_bf16", q.data_ptr(),
                      kv_layer.data_ptr(), page_table.data_ptr(),
                      start_pos.data_ptr(),
                      slopes.data_ptr() if slopes is not None else None,
                      out.data_ptr(), S, Q, H, K, page_table.shape[1],
                      page_size, float(scale), int(window or 0),
                      stream_of(q))
    return out


def gather_last(x: torch.Tensor, q_lens: torch.Tensor) -> torch.Tensor:
    """Last valid token's hidden state per slot: [S, Q, E] -> [S, E]
    (reference ``logits_gather`` kernel)."""
    idx = torch.clamp(q_lens.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def attention_reference(q, k_ctx, v_ctx, start_pos, q_lens=None,
                        window=None) -> torch.Tensor:
    """Dense ground truth for tests: the same masking over an unpaged
    [S, C, K, D] context."""
    S, Q, H, D = q.shape
    K = k_ctx.shape[2]
    qg = q.reshape(S, Q, K, H // K, D)
    scores = torch.einsum("sqkgd,sckd->skgqc", qg, k_ctx).float()
    scores = scores / np.sqrt(D)
    C = k_ctx.shape[1]
    pos = token_positions(start_pos, Q)
    ctx = torch.arange(C, device=q.device)
    mask = ctx[None, None, :] <= pos[:, :, None]
    if window is not None:
        mask &= ctx[None, None, :] > pos[:, :, None] - window
    scores = torch.where(mask[:, None, None, :, :], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(v_ctx.dtype)
    out = torch.einsum("skgqc,sckd->sqkgd", probs, v_ctx)
    return out.reshape(S, Q, H, D)
