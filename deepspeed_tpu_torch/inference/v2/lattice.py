"""The step-key lattice: every bucket key a serving engine can dispatch.

Counterpart of ``enumerate_lattice_keys`` in
``deepspeed_tpu/inference/v2/lattice.py``.  A key is ``(S, Q, P, fresh)``
for a logits step, with ``("sample", greedy)`` for a fused sampling step
and ``(S, 1, P, False, "chain", prev_s, greedy)`` for a chained decode
step.  On the card each key is one CUDA graph (``model.py``); the JAX
package compiles one program per key.  The speculative families (Queue 1
item 8) and mined lattices (item 12) are not ported.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def enumerate_lattice_keys(s_vals: Sequence[int], q_vals: Sequence[int],
                           p_vals: Sequence[int], *, page_size: int,
                           max_ragged_batch_size: int, has_fresh: bool,
                           sampling: bool, spec_q: int = 0,
                           draft: bool = False) -> List[Tuple]:
    """Every (S, Q, P[, fresh[, kind, ...]]) key over the given bucket
    tops.  ``spec_q`` (the bucketed speculative Q width) and ``draft``
    (the model-drafted families) raise: speculation is not ported."""
    if spec_q > 0 or draft:
        raise NotImplementedError(
            "speculative step keys (spec, draft_spec, draft_fill) are not "
            "ported yet (ROADMAP Queue 1 item 8 (speculative decoding))")
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
    return keys
