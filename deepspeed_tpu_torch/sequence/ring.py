"""Ring attention: context parallelism over the ``seq`` ranks
(counterpart of ``deepspeed_tpu/sequence/ring.py``).

Each rank holds ``[B, H, S/P, D]`` blocks of q, k and v.  Queries stay
put; the K/V block travels the ring, rank r handing its block to rank
r+1 each step, so at step i rank r holds the block of rank r-i.  Each
block's attention (its output and log-sum-exp) merges into the row's
by the log-sum-exps, in fp32, and the output is cast back to q's dtype,
as in JAX.  A block runs the flash kernels (``csrc/flash_fwd.cu``,
``flash_bwd.cu``; their plain versions on the CPU) wherever they can
mask it: the diagonal block, causal and windowed, and an earlier block
whole when there is no window.  A block under a window shifted off the
diagonal runs torch products that round as the kernels do (operands in
the inputs' dtype, fp32 accumulators, the probabilities and the scaled
dS rounded to the inputs' dtype before they meet V, K or Q).  A block
with no visible element (fully above the causal diagonal, or fully
below a sliding window: JAX ``:62-63``, ``:74-81``) is skipped but
still travels.  The first block is the rank's own (the diagonal),
which every query row sees, so the merged log-sum-exp is finite from
the first step on.

JAX differentiates through its ``ppermute``; here the backward is
written out (:class:`RingAttention`): each block's probabilities are
recomputed from the merged log-sum-exp (the backward kernels read it
with the merged output), ``dQ`` stays home, and ``dK`` /
``dV`` ride the ring beside their K/V block, so after P rotations each
block's gradient arrives at the rank that owns it.  Block j's gradient
sums the contributions of ranks j, j+1, ... in ring order, a fixed
order, so two calls are bit-equal.

The rotation is the comm facade's ring shift, ``comm.send_recv_next``:
one ``torch.distributed.all_to_all_single`` with uneven splits, in which
each rank sends its whole block to rank r+1 alone and receives rank
r-1's (the other splits are empty).  It moves one block a rank a step,
and gloo (the rank processes sharing one card, and the CPU tests) and
NCCL both run it.
The JAX ring computes its blocks with einsums, not a Pallas kernel; the
port's blocks run the flash pair where it fits, as the rest of its
training attention does.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..comm import comm

#: JAX's masked score (ring.py ``_block_attn``)
_MASKED = -1e30


def _visible(r: int, src: int, sl: int, causal: bool,
             window: Optional[int]) -> bool:
    """Whether any query of rank r's block sees a key of block src."""
    if not causal:
        return True
    q_lo, q_hi = r * sl, (r + 1) * sl - 1
    k_lo, k_hi = src * sl, (src + 1) * sl - 1
    if q_hi < k_lo:
        return False
    return window is None or max(q_lo - k_hi, 0) < window


def _mask(r: int, src: int, sl: int, causal: bool, window: Optional[int],
          device) -> Optional[torch.Tensor]:
    """[Sq, Sk] visibility of block src to rank r's queries (None: all
    visible)."""
    if not causal:
        return None
    q = r * sl + torch.arange(sl, device=device)[:, None]
    k = src * sl + torch.arange(sl, device=device)[None, :]
    mask = q >= k
    if window is not None:
        mask = mask & ((q - k) < window)
    return mask


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over [..., M, K] x [..., K, N] operands of one dtype
    with an fp32 result (the accumulator, not rounded to the operands'
    dtype): ``torch.bmm``'s ``out_dtype`` on the card."""
    if a.is_cuda and a.dtype != torch.float32:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.reshape(*lead, *out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def _scores(q, k, scale, mask):
    s = _mm(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, _MASKED)
    return s


def _kernels(q: torch.Tensor) -> bool:
    """Whether the flash kernels take q's blocks (their plain versions do
    on the CPU; on the card bf16 at a head dim of the backward's)."""
    from ..ops.flash_attention import BWD_HEAD_DIMS
    return q.device.type == "cpu" or (q.dtype == torch.bfloat16 and
                                      q.shape[-1] in BWD_HEAD_DIMS)


class RingAttention(torch.autograd.Function):
    """Ring attention over ``n`` members of ``group`` (this rank is
    ``me``).  A block the flash kernels can express (the diagonal one,
    causal and windowed as the kernels mask it; an earlier one whole,
    without a window) runs ``flash_fwd`` and ``flash_bwd``: the forward's
    blocks merge by their log-sum-exps, and each block's backward reads
    the merged output and log-sum-exp, so its probabilities are the whole
    row's.  A block under a window shifted off the diagonal runs torch
    products that round as the kernels do."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, me, causal, scale, window):
        from ..ops.flash_attention import flash_fwd
        b, h, sl, d = q.shape
        kernels = _kernels(q)
        out32 = lse = None
        kv = torch.stack([k, v])
        for i in range(n):
            src = (me - i) % n
            if _visible(me, src, sl, causal, window):
                diag = causal and src == me
                if kernels and (diag or window is None):
                    o, l_b = flash_fwd(q, kv[0], kv[1], diag, scale,
                                       window if diag else None)
                    o = o.float()
                else:
                    s = _scores(q, kv[0], scale,
                                _mask(me, src, sl, causal, window, q.device))
                    l_b = torch.logsumexp(s, dim=-1)
                    o = _mm(torch.exp(s - l_b[..., None]).to(v.dtype), kv[1])
                if out32 is None:
                    out32, lse = o, l_b
                else:
                    new = torch.logaddexp(lse, l_b)
                    out32 = (out32 * torch.exp(lse - new)[..., None]
                             + o * torch.exp(l_b - new)[..., None])
                    lse = new
            if i < n - 1:
                kv = comm.send_recv_next(kv, group, n, axis="seq")
        out = out32.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, n, me, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..ops.flash_attention import flash_bwd
        q, k, v, out, lse = ctx.saved_tensors
        group, n, me, causal, scale, window = ctx.args
        sl = q.shape[2]
        kernels = _kernels(q)
        do = dout.to(q.dtype)
        # the flash kernels' delta: rowsum(dO * O) over the output as the
        # forward returned it
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros((2,) + tuple(k.shape), device=k.device)
        for i in range(n):
            src = (me - i) % n
            if _visible(me, src, sl, causal, window):
                diag = causal and src == me
                if kernels and (diag or window is None):
                    dq_b, dk_b, dv_b = flash_bwd(q, kv[0], kv[1], out, lse,
                                                 do, diag, scale,
                                                 window if diag else None)
                    dq += dq_b.float()
                    dkv[0] += dk_b.float()
                    dkv[1] += dv_b.float()
                else:
                    s = _scores(q, kv[0], scale,
                                _mask(me, src, sl, causal, window, q.device))
                    p = torch.exp(s - lse[..., None])
                    dkv[1] += _mm(p.to(q.dtype).transpose(-1, -2), do)
                    ds = (p * (_mm(do, kv[1].transpose(-1, -2)) - delta)
                          * scale).to(q.dtype)
                    dq += _mm(ds, kv[0])
                    dkv[0] += _mm(ds.transpose(-1, -2), q)
            if i < n - 1:
                kv = comm.send_recv_next(kv, group, n, axis="seq")
            if n > 1:
                # the block's gradient follows it: home after n rotations
                dkv = comm.send_recv_next(dkv, group, n, axis="seq")
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = True,
                   sm_scale: Optional[float] = None,
                   window: Optional[int] = None,
                   n: Optional[int] = None) -> torch.Tensor:
    """q, k, v: this rank's ``[B, H, S_local, D]`` blocks of a sequence
    split over ``group``'s members in rank order (None: the active
    model-parallel layout's seq group, or the default group; ``n=1``
    runs one block alone).  ``window``: Mistral's sliding window
    ((t - window, t]); requires ``causal``."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal ring attention")
    from .layer import _seq_group
    if n != 1:
        group = _seq_group(group)
        n = comm.group_size(group)
    me = comm.axis_index(group) if n > 1 else 0
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    return RingAttention.apply(q, k, v, group, n, me, causal, scale, window)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, topology, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """The convenience entry: q, k, v ``[B, H, S, D]`` whole on every
    rank; each rank runs the ring on its ``seq`` block (``topology``'s
    seq group) and the blocks are gathered back into ``[B, H, S, D]``."""
    sl = topology.seq_slice(q.shape[2])
    n = topology.sp_world_size
    if n == 1:
        return ring_attention(q, k, v, None, causal=causal, window=window,
                              n=1)
    group = topology.group(("seq",))
    out = ring_attention(q[:, :, sl], k[:, :, sl], v[:, :, sl], group,
                         causal=causal, window=window)
    return comm.all_gather(out.contiguous(), group, axis=2)


__all__: List[str] = ["ring_attention", "ring_attention_sharded",
                      "RingAttention"]
