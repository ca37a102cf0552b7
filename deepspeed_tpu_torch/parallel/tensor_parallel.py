"""Tensor parallelism's collectives, and the model-parallel context of a
training step.

The JAX package has no file for these: its transformer annotates
activations with sharding constraints (``models/transformer.py``
``_constrain``) and GSPMD inserts the collectives.  Here each is an
``torch.autograd.Function`` over the ``tensor`` (or ``seq``) process
group of ``parallel/topology.py``, Megatron's pairs:

* :func:`column_parallel` — a tensor-parallel region's entry and its
  first products (q/k/v, ``mlp.wi`` / ``wg``, the vocab-parallel lm
  head): each rank multiplies the replicated input by its heads or
  columns; the backward sums the input gradient over the ranks;
* :func:`row_parallel` — a row-parallel exit (``attn.wo``, ``mlp.wo``):
  the ranks' partial products summed, identity backward;
* :func:`copy_to_tensor` — identity forward, all-reduce backward: a
  replicated leaf whose use is split over the ranks (wk / wv under split
  heads, ``lm_head_bias`` under a split vocabulary);
* :func:`gather_from_tensor` — the vocab-sharded table made whole before
  the embedding lookup (JAX constrains it replicated,
  ``transformer.py:684-691``): all-gather forward; the backward keeps
  the rank's own slice, since every tensor rank computes the same
  lookup and so the same gradient;
* :func:`split_to_tensor` — the inverse pair (``partition_activations``
  keeps a rank's slice of the tokens): slice forward, all-gather
  backward;
* :func:`gather_from_seq` — keys and values gathered over the seq ranks
  (the dense attention path): all-gather forward, reduce-scatter
  backward (every seq rank's queries read every key);
* :func:`vocab_parallel_cross_entropy` — ``cross_entropy_loss`` (JAX
  ``transformer.py:787``) over vocab-sharded logits: the max and the sum
  of exponentials all-reduced over ``tensor``, the gold logit taken on
  the rank that holds it.

Every activation a tensor rank holds outside a region is the same on
every rank of its group (replicated over ``tensor``), and so is its
gradient: that is what lets a region's entry sum and its exit pass
through.  Each region moves one all-reduce a way: the row-parallel exit
sums the ranks' products in the forward, and the entry sums one input
gradient for all of its projections (q, k and v; ``wi`` and ``wg``) in
the backward.  Both sums are carried in fp32: each rank's partial
product keeps its fp32 accumulator (``torch.mm``'s ``out_dtype`` on the
card), the ranks' are summed in fp32 and rounded once, as one rank's
GEMM rounds its accumulator once.  That doubles the bytes of a bf16 sum.
The JAX package sums the bf16 partial products (GSPMD's psum of the
einsum's output); in bf16 each rank's partial rounds before the sum,
and Adam's first steps turn those extra roundings into sign flips of
near-zero gradients, away from one rank's run of the same batch.  :class:`ModelParallel` is
the step's context (the groups, this rank's place); the engine makes
it active around the model's loss and :func:`active_model_parallel`
returns it.  Each collective's bytes are counted in the comms logger
under its axis (``CommsLogger.axis_bytes``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Optional

import torch

from ..comm import comm


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """One step's model-parallel layout: the sizes of ``tensor`` and
    ``seq``, this rank's index in each, and their process groups (None at
    size 1).  The default is one rank, which splits nothing (the
    sequence-parallel mode is the model config's ``sp_mode``)."""
    tp: int = 1
    sp: int = 1
    tp_index: int = 0
    sp_index: int = 0
    tp_group: Any = None
    sp_group: Any = None

    @classmethod
    def of(cls, topology) -> "ModelParallel":
        """The layout of ``topology``'s rank."""
        return cls(topology.tp_world_size, topology.sp_world_size,
                   topology.coords["tensor"], topology.coords["seq"],
                   topology.group(("tensor",)), topology.group(("seq",)))


#: the layout of a forward that no tensor or seq axis splits
ONE_RANK = ModelParallel()


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "model_parallel", default=None)


def active_model_parallel() -> Optional[ModelParallel]:
    """The model-parallel layout of the step being run (None outside
    one, or without a tensor or seq axis)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def model_parallel(mp: Optional[ModelParallel]):
    token = _ACTIVE.set(mp)
    try:
        yield mp
    finally:
        _ACTIVE.reset(token)


def _all_reduce(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    comm.record_axis(axis, x)
    return comm.all_reduce.__wrapped__(x, group)


def _all_gather(x: torch.Tensor, group, dim: int, axis: str
                ) -> torch.Tensor:
    comm.record_axis(axis, x)
    return comm.all_gather.__wrapped__(x, group, axis=dim)


def _own_slice(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    c = x.shape[dim] // n
    return x.narrow(dim, i * c, c).contiguous()


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "tensor"), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "tensor")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i, dim):
        ctx.n, ctx.i, ctx.dim = n, i, dim
        return _all_gather(x, group, dim, "tensor")

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.n, ctx.i, ctx.dim), None, None, None, None


class _SplitToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, n, i, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.contiguous(), ctx.group, ctx.dim, "tensor"),
                None, None, None, None)


class _GatherFromSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x.contiguous(), group, dim, "seq")

    @staticmethod
    def backward(ctx, g):
        comm.record_axis("seq", g)
        return (comm.reduce_scatter.__wrapped__(g.contiguous(), ctx.group,
                                                axis=ctx.dim), None, None)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D, one dtype) with its fp32 accumulator kept as the
    result: ``torch.mm``'s ``out_dtype`` on the card, the fp32 product of
    the same values on the CPU."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _RowParallel(torch.autograd.Function):
    """``a @ w`` summed over the tensor ranks: each rank's partial product
    in fp32, summed in fp32 and rounded once, as one rank's GEMM rounds
    its accumulator once."""

    @staticmethod
    def forward(ctx, a, w, group):
        ctx.save_for_backward(a, w)
        return _all_reduce(_mm32(a, w), group, "tensor").to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        return g @ w.T, a.T @ g, None


class _ColumnParallel(torch.autograd.Function):
    """``[x @ w for w in ws]`` for a replicated ``x``; the backward's input
    gradient is Megatron's: the rank sums its projections' partial
    products in fp32, one all-reduce sums the ranks' over ``tensor``,
    and the sum is rounded once."""

    @staticmethod
    def forward(ctx, x, group, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.group = group
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        dx = None
        dws = []
        for g, w in zip(gs, ws):
            if g is None:
                dws.append(None)
                continue
            part = _mm32(g, w.T)
            dx = part if dx is None else dx + part
            dws.append(x.T @ g)
        if dx is None:
            dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx = _all_reduce(dx, ctx.group, "tensor").to(x.dtype)
        return (dx, None, *dws)


def row_parallel(a: torch.Tensor, w: torch.Tensor, mp: ModelParallel,
                 n_in: int = 1) -> torch.Tensor:
    """A row-parallel projection (``attn.wo``, ``mlp.wo``): the trailing
    ``n_in`` dims of ``a`` (this rank's heads or columns) contracted with
    ``w``'s leading ones, summed over ``tensor``."""
    k = math.prod(w.shape[:n_in])
    out = _RowParallel.apply(a.reshape(-1, k), w.reshape(k, -1),
                             mp.tp_group)
    return out.reshape(a.shape[:a.dim() - n_in] + w.shape[n_in:])


def column_parallel(x: torch.Tensor, ws, mp: ModelParallel):
    """Column-parallel projections of a replicated ``x`` ([..., E]) by each
    of ``ws`` ([E, ...], this rank's heads or columns): a tensor-parallel
    region's entry and its first products."""
    e = x.shape[-1]
    outs = _ColumnParallel.apply(x.reshape(-1, e), mp.tp_group,
                                 *(w.reshape(e, -1) for w in ws))
    return [o.reshape(x.shape[:-1] + w.shape[1:]) for o, w in zip(outs, ws)]


def copy_to_tensor(x: torch.Tensor, mp: ModelParallel) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``tensor``."""
    if mp.tp == 1:
        return x
    return _CopyToTensor.apply(x, mp.tp_group)


def gather_from_tensor(x: torch.Tensor, mp: ModelParallel,
                       dim: int = 0) -> torch.Tensor:
    """The whole of a tensor-sharded ``x`` along ``dim``, for a use every
    tensor rank makes alike (all-gather; the backward keeps the rank's
    slice)."""
    if mp.tp == 1:
        return x
    return _GatherFromTensor.apply(x.contiguous(), mp.tp_group, mp.tp,
                                   mp.tp_index, dim)


def split_to_tensor(x: torch.Tensor, mp: ModelParallel,
                    dim: int = 1) -> torch.Tensor:
    """The rank's slice of a replicated ``x`` along ``dim`` (all-gather
    backward)."""
    if mp.tp == 1:
        return x
    return _SplitToTensor.apply(x, mp.tp_group, mp.tp, mp.tp_index, dim)


def gather_from_seq(x: torch.Tensor, mp: ModelParallel,
                    dim: int = 1) -> torch.Tensor:
    """Every seq rank's ``x`` joined along ``dim`` (all-gather;
    reduce-scatter backward)."""
    if mp.sp == 1:
        return x
    return _GatherFromSeq.apply(x, mp.sp_group, dim)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 valid: torch.Tensor, group=None,
                                 vocab_start: int = 0) -> torch.Tensor:
    """Per-token negative log-likelihood over the whole vocabulary from
    this rank's vocab shard of ``logits`` ([..., V/tp], fp32, columns
    ``vocab_start`` on) over the tensor ``group`` (None: the vocabulary
    is whole here): ``logsumexp - gold``, zero where ``valid`` is False
    (labels < 0 must be False there).  The same on every rank of the
    group."""
    n_local = logits.shape[-1]
    with torch.no_grad():
        m = logits.max(dim=-1).values
        if group is not None:
            comm.record_axis("tensor", m)
            m = comm.all_reduce.__wrapped__(m, group, "max")
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    safe = labels.clamp(min=0).long() - vocab_start
    mine = (safe >= 0) & (safe < n_local)
    gold = torch.gather(logits, -1, safe.clamp(0, n_local - 1)[..., None]
                        )[..., 0] * mine
    if group is not None:
        # one all-reduce for both: [..., 2]
        both = _ReduceFromTensor.apply(torch.stack([sumexp, gold], -1),
                                       group)
        sumexp, gold = both[..., 0], both[..., 1]
    nll = torch.log(sumexp) + m - gold
    return nll * valid
