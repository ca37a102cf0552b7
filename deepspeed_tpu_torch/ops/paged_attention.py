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

A cache layer is either one fp tensor or a :class:`KVPages` pair (int8
codes plus one fp32 scale per token and kv head): ``write_kv`` quantises
at append, the plain version dequantises the gathered context, and the
kernel wrapper routes a ``KVPages`` layer to ``paged_attention_int8``,
which dequantises each page on the chip (shared memory or registers).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .kernel_loader import CudaKernel, F, I, P, stream_of

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

KERNEL = CudaKernel("paged_attention.cu", {
    "paged_attention_bf16": [P] * 7 + [I] * 6 + [F, I, I, P],
    "paged_attention_int8": [P] * 8 + [I] * 6 + [F, I, I, P],
    "paged_attention_combine": [P, P] + [I] * 5 + [P]})

HEAD_DIM = 128
#: keys per shared-memory stage of the kernel (pages may be smaller)
MAX_PAGE = 64
#: folded rows (Q * H / K) below which the kernel takes its split-KV
#: decode path (``kDecodeRows`` in ``csrc/paged_attention.cu``)
DECODE_ROWS = 16
#: decode path: blocks per SM the split count aims for, and the fewest
#: pages a split walks
SPLIT_BLOCKS_PER_SM = 4
MIN_PAGES_PER_SPLIT = 2

#: supported ``kv_quantization`` values
KV_QUANT_FORMATS = ("none", "int8")


class KVPages:
    """Block-scaled int8 KV page store: the quantised twin of the fp
    ``[..., page, 2, K, D]`` cache tensor.

    ``payload`` holds the int8 codes at the fp layout's exact shape;
    ``scale`` is the per-(token, kv-head) fp32 sidecar, one scale per
    ``head_dim`` block (``payload.shape[:-1]``).  A decode append never
    rescales rows written before: each row carries its own amax.
    ``__getitem__`` indexes both tensors alike (``kv[layer]``); the views
    it returns share storage, so ``write_kv`` on a layer updates the
    cache in place."""

    __slots__ = ("payload", "scale")

    def __init__(self, payload: torch.Tensor, scale: torch.Tensor):
        self.payload = payload
        self.scale = scale

    def __getitem__(self, idx) -> "KVPages":
        return KVPages(self.payload[idx], self.scale[idx])

    @property
    def shape(self):
        return self.payload.shape

    @property
    def dtype(self):
        return self.payload.dtype

    def __repr__(self):
        return (f"KVPages(payload={tuple(self.payload.shape)}, "
                f"scale={tuple(self.scale.shape)})")


KVLayer = Union[torch.Tensor, KVPages]


def quantize_kv_blocks(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 block quantisation over the trailing ``head_dim``
    axis: ``(codes int8 [..., D], scales fp32 [...])`` with ``codes *
    scales ~= kv``.  Computed in fp32, rounding half to even; an all-zero
    block gets scale 0 and codes 0."""
    kvf = kv.float()
    scale = kvf.abs().amax(dim=-1) / 127.0
    codes = torch.round(kvf / scale.clamp(min=1e-30)[..., None])
    return codes.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv_blocks(codes: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_blocks`."""
    return (codes.float() * scale[..., None]).to(dtype)


def token_positions(start_pos: torch.Tensor, q_len_max: int) -> torch.Tensor:
    """pos[s, i] = start_pos[s] + i  (int64, [S, Q])."""
    return start_pos[:, None].long() + torch.arange(
        q_len_max, device=start_pos.device)[None, :]


def write_kv(kv_layer: KVLayer, k_new: torch.Tensor,
             v_new: torch.Tensor, page_table: torch.Tensor,
             start_pos: torch.Tensor, q_lens: torch.Tensor) -> KVLayer:
    """Scatter new KV into the cache pages of one layer, in place.

    kv_layer : [num_pages+1, page_size, 2, K, D] (or :class:`KVPages`)
    k_new/v_new : [S, Q, K, D]
    Rows past a slot's ``q_lens`` go to the null page 0, whose contents
    are garbage by contract.  A quantised layer quantises at append:
    codes and scales land at the same (page, slot), so a row is always
    self-consistent.  Returns ``kv_layer``."""
    S, Q = k_new.shape[:2]
    page_size = kv_layer.shape[1]
    pos = token_positions(start_pos, Q)                     # [S, Q]
    valid = torch.arange(Q, device=pos.device)[None, :] < q_lens[:, None]
    page_idx = torch.clamp(pos // page_size, max=page_table.shape[1] - 1)
    pages = torch.gather(page_table.long(), 1, page_idx)
    pages = torch.where(valid, pages, torch.zeros_like(pages))
    kv_new = torch.stack([k_new, v_new], dim=2)             # [S,Q,2,K,D]
    pages_f, slot_f = pages.reshape(-1), (pos % page_size).reshape(-1)
    if isinstance(kv_layer, KVPages):
        codes, scales = quantize_kv_blocks(kv_new)
        kv_layer.payload[pages_f, slot_f] = codes.reshape(
            (S * Q,) + codes.shape[2:])
        kv_layer.scale[pages_f, slot_f] = scales.reshape(
            (S * Q,) + scales.shape[2:])
        return kv_layer
    kv_layer[pages_f, slot_f] = \
        kv_new.reshape((S * Q,) + kv_new.shape[2:]).to(kv_layer.dtype)
    return kv_layer


def rope_write_kv(kv_layer, k_new, v_new, sin, cos, page_table, start_pos,
                  q_lens) -> torch.Tensor:
    """Rotate K, then write it with V (reference
    ``linear_blocked_kv_rotary``)."""
    from ..models.transformer import apply_rope
    return write_kv(kv_layer, apply_rope(k_new, sin, cos), v_new,
                    page_table, start_pos, q_lens)


def paged_attention(q: torch.Tensor, kv_layer: KVLayer,
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
    garbage that logits gather and the null page ignore.  A
    :class:`KVPages` layer dequantises only the gathered context, to
    ``q.dtype``; the resident cache stays int8."""
    S, Q, H, D = q.shape
    page_size, K = kv_layer.shape[1], kv_layer.shape[3]
    G = H // K
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(D)
    table = page_table.long()
    if isinstance(kv_layer, KVPages):
        pages = dequantize_kv_blocks(kv_layer.payload[table],
                                     kv_layer.scale[table], dtype=q.dtype)
    else:
        pages = kv_layer[table]                  # [S, P, page, 2, K, D]
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_splits(S: int, K: int, P: int, sms: int) -> int:
    """Splits per (slot, kv head) of the decode path: enough that the
    ``n_split * K * S`` blocks give each of ``sms`` SMs
    ``SPLIT_BLOCKS_PER_SM``, with at least ``MIN_PAGES_PER_SPLIT`` of the
    ``P`` page-table columns per split (the table's width stands in for
    the longest context, which the host does not know without a sync)."""
    want = -(-SPLIT_BLOCKS_PER_SM * sms // max(S * K, 1))
    return max(1, min(want, -(-P // MIN_PAGES_PER_SPLIT)))


def paged_decode_attention(q: torch.Tensor, kv_layer: KVLayer,
                           page_table: torch.Tensor, start_pos: torch.Tensor,
                           *, sm_scale: Optional[float] = None,
                           alibi_slopes=None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Ragged paged attention (any Q: decode rows and prefill chunks with
    per-row causal limits).  CPU tensors take :func:`paged_attention`;
    CUDA tensors launch ``paged_attention_bf16`` (fp pages) or
    ``paged_attention_int8`` (:class:`KVPages`) or raise.  With fewer than
    ``DECODE_ROWS`` folded rows (``Q * H / K``) and more than one split
    (:func:`decode_splits`) that launch writes fp32 split partials to a
    workspace and ``paged_attention_combine`` (its own count in
    ``KERNEL.launches_by_fn``) reduces them into the output; with one
    split the first launch writes the output.

    q: [S, Q, H, D] bf16; kv_layer: [num_pages+1, page, 2, K, D] bf16, or
    KVPages of int8 codes at that shape and fp32 scales
    [num_pages+1, page, 2, K]; page_table: [S, P] int32; start_pos: [S]
    int32.  Returns [S, Q, H, D].
    """
    if q.device.type == "cpu":
        return paged_attention(q, kv_layer, page_table, start_pos,
                               sm_scale=sm_scale, alibi_slopes=alibi_slopes,
                               window=window)
    quantized = isinstance(kv_layer, KVPages)
    S, Q, H, D = q.shape
    pages_total, page_size, two, K, Dk = kv_layer.shape
    dev = q.device
    want = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or kv_layer.dtype != want:
        raise TypeError(f"paged kernel takes bf16 q and {want} pages, got "
                        f"{q.dtype} / {kv_layer.dtype}")
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
    operands = [("q", q), ("page_table", page_table),
                ("start_pos", start_pos)]
    if quantized:
        if kv_layer.scale.dtype != torch.float32 \
                or kv_layer.scale.shape != kv_layer.shape[:-1]:
            raise ValueError(
                f"paged kernel takes fp32 scales of shape "
                f"{tuple(kv_layer.shape[:-1])}, got {kv_layer.scale.dtype} "
                f"{tuple(kv_layer.scale.shape)}")
        operands += [("kv codes", kv_layer.payload),
                     ("kv scales", kv_layer.scale)]
    else:
        operands.append(("kv", kv_layer))
    for name, t in operands:
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
    if not q.numel():
        return out
    width = page_table.shape[1]
    rows = Q * (H // K)
    work, n_split = None, 0
    if rows < DECODE_ROWS:
        n_split = decode_splits(S, K, width, _sm_count(dev.index or 0))
    if n_split > 1:
        # acc [S, K, n_split, rows, D], then (m, l) [S, K, n_split, rows, 2]
        work = torch.empty(S * K * n_split * rows * (D + 2),
                           dtype=torch.float32, device=dev)
    pages = ((kv_layer.payload.data_ptr(), kv_layer.scale.data_ptr())
             if quantized else (kv_layer.data_ptr(),))
    stream = stream_of(q)
    KERNEL.launch("paged_attention_int8" if quantized
                  else "paged_attention_bf16", q.data_ptr(), *pages,
                  page_table.data_ptr(), start_pos.data_ptr(),
                  slopes.data_ptr() if slopes is not None else None,
                  out.data_ptr(),
                  work.data_ptr() if work is not None else None,
                  S, Q, H, K, width, page_size, float(scale),
                  int(window or 0), n_split, stream)
    if work is not None:
        KERNEL.launch("paged_attention_combine", work.data_ptr(),
                      out.data_ptr(), S, Q, H, K, n_split, stream)
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


def paged_context(kv_layer: KVLayer, page_table: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialise each slot's context as ([S, C, K, D] keys, values), a
    testing helper; a quantised layer dequantises to fp32."""
    table = page_table.long()
    if isinstance(kv_layer, KVPages):
        pages = dequantize_kv_blocks(kv_layer.payload[table],
                                     kv_layer.scale[table])
    else:
        pages = kv_layer[table]
    S, P, page_size = pages.shape[:3]
    k = pages[..., 0, :, :].reshape(S, P * page_size, *pages.shape[4:])
    v = pages[..., 1, :, :].reshape(S, P * page_size, *pages.shape[4:])
    return k, v
