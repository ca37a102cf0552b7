"""DeepSpeed-Ulysses sequence parallelism (counterpart of
``deepspeed_tpu/sequence/layer.py``; reference
``deepspeed/sequence/layer.py:65`` ``DistributedAttention``,
``single_all_to_all`` :19, ``_SeqAllToAll`` :49).

:func:`seq_all_to_all` redistributes a ``[B, S/P, H, D]`` activation to
``[B, S, H/P, D]`` over the ``seq`` ranks (the port's tiled
``comm.all_to_all``); its backward is the inverse all-to-all.
:class:`DistributedAttention` sandwiches any local attention between
the two, as JAX's does inside ``shard_map``: the callable sees the full
sequence and a 1/P slice of the heads.  The transformer's flash path
(``models/transformer.py``) runs the same sandwich around the flash
kernels.

``group`` None means the ``seq`` group of the active model-parallel
layout (``parallel/tensor_parallel.active_model_parallel``), or the
default group when none is active: JAX's default ``axis_name="seq"``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..comm import comm
from ..parallel.tensor_parallel import active_model_parallel


def _seq_group(group):
    if group is not None:
        return group
    mp = active_model_parallel()
    return mp.sp_group if mp is not None else None


def _all_to_all(x: torch.Tensor, group, split: int, concat: int
                ) -> torch.Tensor:
    comm.record_axis("seq", x)
    return comm.all_to_all.__wrapped__(x, group, split, concat)


class _SeqAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_axis, gather_axis):
        ctx.group, ctx.axes = group, (scatter_axis, gather_axis)
        return _all_to_all(x, group, scatter_axis, gather_axis)

    @staticmethod
    def backward(ctx, g):
        scatter_axis, gather_axis = ctx.axes
        return (_all_to_all(g.contiguous(), ctx.group, gather_axis,
                            scatter_axis), None, None, None)


def seq_all_to_all(x: torch.Tensor, group=None, scatter_axis: int = 2,
                   gather_axis: int = 1) -> torch.Tensor:
    """Split ``scatter_axis`` over the seq ranks and join what they send
    along ``gather_axis`` (reference ``single_all_to_all``): a
    ``[.., seq_local, heads, ..]`` tensor becomes ``[.., seq,
    heads_local, ..]``.  Differentiable: the backward runs the inverse
    all-to-all."""
    group = _seq_group(group)
    if comm.group_size(group) == 1:
        return x
    return _SeqAllToAll.apply(x, group, scatter_axis, gather_axis)


class DistributedAttention:
    """The Ulysses sandwich (reference ``DistributedAttention``).
    ``local_attention(q, k, v, *args)`` sees the FULL sequence and a 1/P
    head slice.  Layout: ``[B, S_local, H, D]`` in, ``[B, S_local, H,
    D]`` out."""

    def __init__(self, local_attention: Callable, group=None,
                 scatter_idx: int = 2, gather_idx: int = 1):
        self.local_attn = local_attention
        self.group = group
        self.scatter_idx = scatter_idx   # heads dim
        self.gather_idx = gather_idx     # sequence dim

    def __call__(self, query, key, value, *args, **kwargs):
        a, b = self.scatter_idx, self.gather_idx
        q = seq_all_to_all(query, self.group, a, b)
        k = seq_all_to_all(key, self.group, a, b)
        v = seq_all_to_all(value, self.group, a, b)
        ctx = self.local_attn(q, k, v, *args, **kwargs)
        # inverse: scatter the sequence back, gather the heads
        return seq_all_to_all(ctx, self.group, b, a)
