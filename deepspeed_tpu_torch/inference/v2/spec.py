"""Speculative drafters.

Counterpart of ``deepspeed_tpu/inference/v2/spec.py``, plain Python and
numpy.  A drafter proposes the next few tokens of a decode row; the
fused serving step verifies all of them in one dispatch of a Q > 1
step key and the scheduler commits the accepted prefix in the same step
(``scheduler.py`` ``_dispatch_spec`` / ``_dispatch_draft_spec``).

Drafter protocol (duck-typed, what the scheduler relies on):

- ``propose(uid, prompt, generated, max_draft) -> np.ndarray``: up to
  ``max_draft`` int32 draft tokens continuing ``prompt + generated``
  (possibly empty: nothing to propose this step);
- ``drop(uid)``: release any per-request state on termination;
- ``__len__``: the live per-request state count.

:class:`NgramDrafter` is host-side prompt-lookup decoding: it looks the
row's trailing n-gram up in the row's own history and copies what
followed its previous occurrence, so the scheduler ships ``[last,
draft...]`` and the device only verifies.  :class:`ModelDrafter` stands
for the draft trunk that drafts on the device inside the fused
``draft_spec`` step: ``propose`` returns placeholder zeros whose length
shapes the row, and the real drafts come back with the verdict in the
``[S, 2+k]`` int32 transfer.  A wrong draft costs one verify slot,
never a wrong token: only the verify's own emissions commit.

The per-sequence index is incremental: each committed token extends the
n-gram -> last-position map in O(n-gram sizes), so a long-lived request
never rescans its history.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

#: longest n-gram the index keys on (lookups try longest-first down to
#: the configured minimum — a longer match is a stronger predictor)
NGRAM_MAX = 4


class _SeqIndex:
    """Suffix index of one sequence's history: for every n-gram size in
    [ngram_min, ngram_max], the last position each n-gram ENDED at."""

    def __init__(self, ngram_min: int, ngram_max: int):
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max
        #: prompt length this index was built for (uid-reuse probe)
        self.prompt_len = 0
        #: tokens already folded into the maps
        self.tokens: List[int] = []
        #: per n-gram size: {ngram tuple: (last end position, previous
        #: end position or None)} — the trailing n-gram's last
        #: occurrence IS the tail, so a lookup needs the one before it
        self.maps: Dict[int, Dict[Tuple[int, ...],
                                  Tuple[int, Optional[int]]]] = {
            n: {} for n in range(ngram_min, ngram_max + 1)}

    def extend(self, new_tokens) -> None:
        """Fold ``new_tokens`` (the history suffix past what is already
        indexed) into the index — O(len(new_tokens) * n-gram sizes)."""
        toks = self.tokens
        for t in new_tokens:
            toks.append(int(t))
            i = len(toks) - 1
            for n, m in self.maps.items():
                if i + 1 >= n:
                    key = tuple(toks[i + 1 - n:i + 1])
                    cur = m.get(key)
                    m[key] = (i, cur[0] if cur else None)

    def lookup(self, max_draft: int) -> np.ndarray:
        """Draft continuation of the trailing n-gram, longest n first:
        copy what followed its most recent STRICTLY-EARLIER occurrence
        (the trailing occurrence itself has nothing after it).  When
        the match sits near the end — a PERIODIC tail, the single most
        draftable structure there is — the copied span is extended
        cyclically, extrapolating the period instead of truncating the
        draft to the couple of recorded tokens (a wrong extrapolation
        costs nothing: acceptance is verify-gated)."""
        toks = self.tokens
        for n in range(min(self.ngram_max, len(toks)),
                       self.ngram_min - 1, -1):
            ent = self.maps[n].get(tuple(toks[-n:]))
            if ent is None:
                continue
            end = ent[0] if ent[0] != len(toks) - 1 else ent[1]
            if end is None:
                continue
            lo = end + 1
            avail = len(toks) - lo
            return np.asarray([toks[lo + (i % avail)]
                               for i in range(max_draft)], dtype=np.int32)
        return np.zeros(0, dtype=np.int32)


class NgramDrafter:
    """Per-request prompt-lookup drafters keyed by uid."""

    def __init__(self, ngram_min: int = 2):
        self.ngram_min = max(int(ngram_min), 1)
        #: an ngram_min above NGRAM_MAX widens the indexed range rather
        #: than silently emptying it (maps over an empty range would
        #: never draft while the scheduler kept paying the probe cost)
        self.ngram_max = max(NGRAM_MAX, self.ngram_min)
        self._seqs: Dict[int, _SeqIndex] = {}

    def propose(self, uid: int, prompt: np.ndarray,
                generated: List[int], max_draft: int) -> np.ndarray:
        """Up to ``max_draft`` drafted tokens continuing ``prompt +
        generated`` (possibly empty).  Incremental: only tokens
        committed since the last call are folded into the index — the
        full history is never re-materialized, so a long-lived request
        pays O(new tokens) per step, not O(context).  Callers reusing
        a uid for a new request should :meth:`drop` it first; as a
        backstop, a shrunken history, a changed prompt length, or a
        mismatched last-indexed token triggers a rebuild (O(1) probes —
        a pathological same-length same-tail prompt swap can slip past
        them, costing only verify-rejected drafts)."""
        if max_draft <= 0:
            return np.zeros(0, dtype=np.int32)
        idx = self._seqs.get(uid)
        total = len(prompt) + len(generated)
        if idx is not None and (total < len(idx.tokens)
                                or len(prompt) != idx.prompt_len
                                or self._stale(idx, prompt, generated)):
            idx = None                  # uid reuse without drop: rebuild
        if idx is None:
            idx = self._seqs[uid] = _SeqIndex(self.ngram_min,
                                              self.ngram_max)
            idx.prompt_len = len(prompt)
        start = len(idx.tokens)
        if start < len(prompt):
            idx.extend(np.asarray(prompt[start:], dtype=np.int32))
            idx.extend(generated)
        else:
            idx.extend(generated[start - len(prompt):])
        if len(idx.tokens) < self.ngram_min + 1:
            return np.zeros(0, dtype=np.int32)
        return idx.lookup(max_draft)

    @staticmethod
    def _stale(idx: _SeqIndex, prompt, generated) -> bool:
        """O(1) probe: does the index's first/last folded token still
        match the history it claims to cover?"""
        n = len(idx.tokens)
        if n == 0:
            return False

        def hist(i):
            return int(prompt[i]) if i < len(prompt) \
                else int(generated[i - len(prompt)])

        return idx.tokens[0] != hist(0) or idx.tokens[n - 1] != hist(n - 1)

    def drop(self, uid: int) -> None:
        """Release a terminated request's index."""
        self._seqs.pop(uid, None)

    def __len__(self) -> int:
        return len(self._seqs)


class ModelDrafter:
    """Device-resident draft-model drafter.

    The actual drafting runs on the device inside the fused
    ``draft_spec`` step: a truncated-trunk (or shared-trunk) draft
    model autoregresses ``k`` greedy tokens against its own KV pool and
    the target verifies them in the same dispatch — no host round-trip
    between drafting and verification, which is the whole point (the
    n-gram drafter's propose/verify split costs the async overlap every
    attempted step).

    ``propose`` therefore returns PLACEHOLDER zeros sized to the
    requested draft length: the scheduler uses the length to shape the
    ragged row (``[last, 0*k]``) and reads the real draft tokens from
    the step's ``[S, 2+k]`` return.  Host state is nothing but the
    uid set (symmetry with :class:`NgramDrafter` for leak accounting).
    """

    def __init__(self) -> None:
        self._live: Dict[int, bool] = {}

    def propose(self, uid: int, prompt: np.ndarray,
                generated: List[int], max_draft: int) -> np.ndarray:
        if max_draft <= 0:
            return np.zeros(0, dtype=np.int32)
        self._live[uid] = True
        return np.zeros(max_draft, dtype=np.int32)

    def drop(self, uid: int) -> None:
        self._live.pop(uid, None)

    def __len__(self) -> int:
        return len(self._live)
