"""Sparse (indexed-slices) gradients for embedding tables.

Counterpart of ``deepspeed_tpu/runtime/sparse_tensor.py`` (``SparseTensor``
:39, ``sparse_allreduce`` :87, ``embedding_lookup`` :98 with its backward
``_embed_bwd`` :115).  The batch's token ids are the rows an embedding
gradient touches, so the gradient is the ``[B*S, E]`` output cotangent
with those ids: :class:`SparseTensor` holds the pair, and
:func:`embedding_lookup` is ``table[ids]`` whose backward sums the
cotangent rows into the dense ``[V, E]`` table gradient in fp32
(``index_add_``, duplicate ids accumulating) and casts it to the table's
dtype, as JAX's ``segment_sum`` does.

On the card ``index_add_`` sums duplicate ids with atomics in no fixed
order, so the sum is not bit-reproducible there; it is held to the dense
backward within a stated limit (``chip_smoke.py`` phase 23 (d)).  On the
CPU the sum runs in order.

``sparse_allreduce`` all-gathers every rank's indices and values over a
data-parallel process group (the identity at one rank), as JAX's does
over a mesh axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class SparseTensor:
    """Indexed-slices gradient: ``indices`` [n] int row ids (they may
    repeat), ``values`` [n, E], ``dense_shape`` (V, E)."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 dense_shape: Tuple[int, ...]):
        self.indices = indices
        self.values = values
        self.dense_shape = tuple(int(d) for d in dense_shape)

    @classmethod
    def from_dense(cls, dense: torch.Tensor,
                   indices: torch.Tensor) -> "SparseTensor":
        """Compress ``dense`` knowing ``indices`` are the touched rows."""
        return cls(indices, dense[indices.long()], dense.shape)

    def to_dense(self) -> torch.Tensor:
        """Scatter-add the values back to the dense shape (duplicate
        indices accumulate)."""
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.indices.long(), self.values)

    def add(self, other: "SparseTensor") -> "SparseTensor":
        assert self.dense_shape == other.dense_shape
        return SparseTensor(torch.cat([self.indices, other.indices]),
                            torch.cat([self.values, other.values]),
                            self.dense_shape)

    def sparse_size(self) -> Tuple[int, int]:
        index_size = self.indices.shape[0]
        value_size = self.values.shape[0] * self.values.shape[1]
        dense_size = self.dense_shape[0] * self.dense_shape[1]
        return index_size + value_size, dense_size

    def __repr__(self):
        return (f"SparseTensor(n={self.indices.shape[0]}, "
                f"dense_shape={self.dense_shape})")


def sparse_allreduce(st: SparseTensor, group=None) -> SparseTensor:
    """All-gather (indices, values) over a data-parallel group (JAX
    ``sparse_allreduce`` over a mesh axis, :70): the members' rows
    concatenated in member order.  ``group`` is a ``torch.distributed``
    process group or None (the default group); over one rank the gather
    is the identity."""
    from ..comm import comm
    return SparseTensor(comm.all_gather(st.indices, group, axis=0),
                        comm.all_gather(st.values, group, axis=0),
                        st.dense_shape)


def sparse_embedding_grad(ids: torch.Tensor, ct: torch.Tensor, vocab: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """The dense table gradient of ``table[ids]`` from its output
    cotangent ``ct`` [..., E]: an fp32 sum of the rows per id, cast to
    ``dtype`` (JAX ``_embed_bwd``)."""
    emb = ct.shape[-1]
    dense = torch.zeros((vocab, emb), dtype=torch.float32, device=ct.device)
    dense.index_add_(0, ids.reshape(-1).long(),
                     ct.reshape(-1, emb).float())
    return dense.to(dtype)


class _EmbeddingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        return table[ids.long()]

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return sparse_embedding_grad(ids, ct, ctx.vocab, ctx.dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     replicate_cotangent: Optional[bool] = True
                     ) -> torch.Tensor:
    """``table[ids]`` whose backward is the sparse-gradient path.
    ``replicate_cotangent`` is JAX's mesh constraint on the cotangent;
    one device has no mesh, so it changes nothing here."""
    del replicate_cotangent
    return _EmbeddingLookup.apply(table, ids)
