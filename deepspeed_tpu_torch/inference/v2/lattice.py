"""The step-key lattice: every bucket key a serving engine can dispatch.

Counterpart of ``enumerate_lattice_keys`` in
``deepspeed_tpu/inference/v2/lattice.py``.  A key is ``(S, Q, P, fresh)``
for a logits step, with ``("sample", greedy)`` for a fused sampling step
and ``(S, 1, P, False, "chain", prev_s, greedy)`` for a chained decode
step.  ``spec_q`` adds the speculative verify keys ``(S, Q, P, False,
"spec", greedy)`` and ``draft`` the model-drafted twins (``"draft_spec"``
and ``(S, Q, P, False, "draft_fill")``).  On the card each key is one
CUDA graph (``model.py``); the JAX package compiles one program per key.
Mined lattices (ROADMAP Queue 1 item 12) are not ported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def enumerate_lattice_keys(s_vals: Sequence[int], q_vals: Sequence[int],
                           p_vals: Sequence[int], *, page_size: int,
                           max_ragged_batch_size: int, has_fresh: bool,
                           sampling: bool, spec_q: int = 0,
                           draft: bool = False) -> List[Tuple]:
    """Every (S, Q, P[, fresh[, kind, ...]]) key over the given bucket
    tops.  ``spec_q`` > 0 (the bucketed Q = 1 + spec_max_draft of a
    verify step) adds the spec keys of the sampling lattice; ``draft``
    adds a "draft_spec" twin of every spec key (the draft loop and the
    verify in one step) and a "draft_fill" twin of every non-fresh
    logits key (the draft pool's catch-up forward, bucketed like a
    prefill)."""
    s_vals = sorted({int(s) for s in s_vals})
    q_vals = sorted({int(q) for q in q_vals} | {1})
    p_vals = sorted({int(p) for p in p_vals})
    keys: List[Tuple] = []
    for S in s_vals:
        for Q in q_vals:
            if S * Q > max_ragged_batch_size:
                continue
            for P in p_vals:
                if P * page_size < Q:  # the bucket cannot hold its tokens
                    continue
                # Q > 1 buckets come as fresh prefill (flash) and
                # continued prefill (paged), the first only when the
                # model has a fresh path (ALiBi models do not)
                for fresh in ((False, True) if Q > 1 and has_fresh
                              else (False,)):
                    key = (S, Q, P, fresh)
                    keys.append(key)
                    if draft and not fresh:
                        keys.append((S, Q, P, False, "draft_fill"))
                    if not sampling:
                        continue
                    for greedy in (True, False):
                        keys.append(key + ("sample", greedy))
                        if Q == 1 and not fresh:
                            # a chained step's rows are a subset of the
                            # previous step's, whose slot bucket is >= S
                            for prev_s in s_vals:
                                if prev_s >= S:
                                    keys.append((S, 1, P, False, "chain",
                                                 prev_s, greedy))
    if sampling and spec_q > 0:
        # one Q bucket serves every draft length (q_lens is per row);
        # the S * Q budget rule holds for it too
        for S in s_vals:
            if S * spec_q > max_ragged_batch_size:
                continue
            for P in p_vals:
                if P * page_size < spec_q:
                    continue
                for greedy in (True, False):
                    keys.append((S, spec_q, P, False, "spec", greedy))
                    if draft:
                        keys.append((S, spec_q, P, False, "draft_spec",
                                     greedy))
    return keys
