"""Ragged batch — host-side builder producing static-shape arrays.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/batch.py``.  A batch
is padded into power-of-two buckets, the same ones the JAX package uses
(or a mined lattice's tops), because they set the padding the kernels
see:

    token_ids   : [S, Q] int32   (null-padded)
    q_lens      : [S]    int32   new tokens per slot (0 = empty slot)
    start_pos   : [S]    int32   committed history length per slot
    page_table  : [S, P] int32   KV page indices (0 = null page)

Padding slots write their KV into the null page and are masked out of
attention and logits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .sequence import SequenceDescriptor

#: bucket floors (slots, pages) — the JAX package's values
MIN_SLOTS = 1
MIN_PAGES = 8


def _bucket(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class RaggedBatch:
    token_ids: np.ndarray    # [S, Q] int32
    q_lens: np.ndarray       # [S] int32
    start_pos: np.ndarray    # [S] int32
    page_table: np.ndarray   # [S, P] int32
    uids: List[int]          # live uids, in slot order (len <= S)
    #: every slot starts at position 0 with Q > 1 (pure fresh prefill):
    #: attention may run the flash kernel over the new tokens instead of
    #: the paged gather
    fresh: bool = False

    @property
    def num_slots(self) -> int:
        return self.token_ids.shape[0]

    @property
    def max_q(self) -> int:
        return self.token_ids.shape[1]

    @property
    def shape_key(self) -> Tuple[int, int, int, bool]:
        """(S, Q, P, fresh): the bucket a step over this batch runs in."""
        return (self.token_ids.shape[0], self.token_ids.shape[1],
                self.page_table.shape[1], self.fresh)


def build_batch(seqs: Sequence[SequenceDescriptor],
                tokens: Sequence[np.ndarray],
                page_size: int,
                min_slots: int = MIN_SLOTS,
                min_pages: int = MIN_PAGES,
                fresh_supported: bool = True,
                min_q: int = 1, lattice=None) -> RaggedBatch:
    """Pack (descriptor, new-token) pairs into a bucketed RaggedBatch.
    Callers must already have reserved KV pages on each descriptor and
    called ``pre_forward``.  ``fresh_supported``: whether the model has
    a fresh-prefill attention path (ALiBi models do not).  ``min_q``
    floors the Q bucket: every speculative dispatch pads to the one
    ``1 + spec_max_draft`` bucket, so a short-draft step forms no
    smaller key.  ``lattice``, a mined ``lattice.BucketLattice``, buckets
    S, Q and P to its tops instead of to powers of two (past its largest
    top it grows by powers of two): it changes padding, never tokens."""
    n = len(seqs)
    if n != len(tokens) or n < 1:
        raise ValueError(f"{n} sequences for {len(tokens)} token arrays")
    if lattice is not None:
        S = lattice.bucket_s(n)
        Q = lattice.bucket_q(max(max(len(t) for t in tokens), min_q))
        P = lattice.bucket_p(max(s.allocated_capacity for s in seqs))
    else:
        S = _bucket(n, min_slots)
        Q = _bucket(max(max(len(t) for t in tokens), min_q))
        P = _bucket(max(max(s.allocated_capacity for s in seqs), 1),
                    min_pages)

    token_ids = np.zeros((S, Q), dtype=np.int32)
    q_lens = np.zeros(S, dtype=np.int32)
    start_pos = np.zeros(S, dtype=np.int32)
    page_table = np.zeros((S, P), dtype=np.int32)
    uids = []
    for i, (sd, toks) in enumerate(zip(seqs, tokens)):
        toks = np.asarray(toks, dtype=np.int32).reshape(-1)
        token_ids[i, :len(toks)] = toks
        q_lens[i] = len(toks)
        start_pos[i] = sd.seen_tokens
        page_table[i] = sd.page_table(P)
        uids.append(sd.uid)
    fresh = fresh_supported and Q > 1 and all(s.seen_tokens == 0
                                              for s in seqs)
    return RaggedBatch(token_ids, q_lens, start_pos, page_table, uids,
                       fresh=fresh)
