"""Step-key lattices: the power-of-two default and mined lattices.

Counterpart of ``deepspeed_tpu/inference/v2/lattice.py``.  A key is
``(S, Q, P, fresh)`` for a logits step, with ``("sample", greedy)`` for a
fused sampling step and ``(S, 1, P, False, "chain", prev_s, greedy)``
for a chained decode step.  ``spec_q`` adds the speculative verify keys
``(S, Q, P, False, "spec", greedy)`` and ``draft`` the model-drafted
twins (``"draft_spec"`` and ``(S, Q, P, False, "draft_fill")``).  On the
card each key is one CUDA graph (``model.py``); the JAX package compiles
one program per key.

A :class:`BucketLattice` carries bucket tops for S (slots), Q (tokens a
row) and P (pages a row) that need not be powers of two, and the key set
enumerated over them.  ``mine_lattice`` fits the Q tops to the prompt
lengths of a workload trace (``telemetry/workload_trace.py``), so a
1088-token prompt pads to a mined top near 1088 instead of to 2048; the
engine buckets every batch through the lattice, and a padding change
changes no token.  The artifact is a versioned JSON document::

    {"kind": "ds_lattice", "version": 1,
     "config_digest": "<blake2b over (page_size, vocab_size)>",
     "page_size": ..., "vocab_size": ..., "max_ragged_batch_size": ...,
     "has_fresh": ..., "s_buckets": [...], "q_buckets": [...],
     "p_buckets": [...], "keys": [[S, Q, P, fresh, ...], ...],
     "source": "<trace path>", "requests": N, "dispatches": N}

byte for byte the JAX package's (both packages mine the same artifact
from the same trace, digests included).  ``resolve_lattice`` checks the
digest against the consuming engine's geometry and refuses a mismatch
with :class:`LatticeError`; ``"auto:<path>"`` takes an artifact or a raw
trace (mined when the engine is built).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .ragged.batch import MIN_PAGES, MIN_SLOTS, _bucket

LATTICE_ARTIFACT_VERSION = 1
LATTICE_ARTIFACT_KIND = "ds_lattice"


class LatticeError(ValueError):
    """A lattice artifact could not be read or does not fit the engine
    (wrong kind or version, an undecodable file, a malformed key, another
    geometry or a smaller batch budget).  The engine build fails: a wrong
    lattice would capture its graphs on the request path."""


def lattice_config_digest(page_size: int, vocab_size: int) -> str:
    """Digest of the geometry a lattice is valid under, the same at mine
    time (from the trace's meta) and at load time (from the engine): the
    page size gives every P top its meaning, the vocabulary shapes the
    steps."""
    facts = json.dumps({"page_size": int(page_size),
                        "vocab_size": int(vocab_size)}, sort_keys=True)
    return hashlib.blake2b(facts.encode("utf-8"),
                           digest_size=8).hexdigest()


def lattice_content_digest(doc: Dict[str, Any]) -> str:
    """Identity of one particular lattice: the geometry digest, the tops
    and the key set.  A snapshot records it and ``restore`` compares it
    (two lattices mined from different traces on one geometry bucket
    differently, so one's keys would be the wrong ones on the other)."""
    facts = json.dumps({
        "config": str(doc.get("config_digest", "")),
        "s": list(doc.get("s_buckets", [])),
        "q": list(doc.get("q_buckets", [])),
        "p": list(doc.get("p_buckets", [])),
        "keys": sorted(map(repr, doc.get("keys", []))),
    }, sort_keys=True)
    return hashlib.blake2b(facts.encode("utf-8"),
                           digest_size=8).hexdigest()


def fit_buckets(lengths: Sequence[int], ratio: float = 1.3,
                max_buckets: int = 12, floor: int = 1) -> List[int]:
    """Bucket tops fit to observed lengths: sorted distinct lengths are
    grouped greedily so every length maps to a top within ``ratio`` x of
    itself, each top the largest length of its group.  When that takes
    more than ``max_buckets`` tops the ratio widens until it fits.  A
    bimodal distribution gets tops at its modes."""
    # a ratio <= 1 never merges and never widens: floor it
    ratio = max(float(ratio), 1.001)
    vals = sorted({max(int(v), floor) for v in lengths})
    if not vals:
        return []
    while True:
        buckets: List[int] = []
        i = 0
        while i < len(vals):
            lo = vals[i]
            j = i
            while j + 1 < len(vals) and vals[j + 1] <= lo * ratio:
                j += 1
            buckets.append(vals[j])
            i = j + 1
        if len(buckets) <= max_buckets:
            return buckets
        ratio *= 1.25


def _pick(n: int, tops: Tuple[int, ...], floor: int) -> int:
    """The smallest top >= n; past the largest top, power-of-two growth
    (padding stays padding; the key is off the lattice)."""
    n = max(int(n), 1)
    for t in tops:
        if t >= n:
            return t
    return _bucket(n, floor)


def enumerate_lattice_keys(s_vals: Sequence[int], q_vals: Sequence[int],
                           p_vals: Sequence[int], *, page_size: int,
                           max_ragged_batch_size: int, has_fresh: bool,
                           sampling: bool, spec_q: int = 0,
                           draft: bool = False) -> List[Tuple]:
    """Every (S, Q, P[, fresh[, kind, ...]]) key over the given bucket
    tops, the power-of-two default's and a mined lattice's alike.
    ``spec_q`` > 0 (the bucketed Q = 1 + spec_max_draft of a verify
    step) adds the spec keys of the sampling lattice; ``draft`` adds a
    "draft_spec" twin of every spec key (the draft loop and the verify
    in one step) and a "draft_fill" twin of every non-fresh logits key
    (the draft pool's catch-up forward, bucketed like a prefill)."""
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


@dataclasses.dataclass(frozen=True)
class BucketLattice:
    """The bucket tops and key set an engine serves under.  The three
    ``bucket_*`` methods replace the power-of-two ``_bucket`` in
    ``build_batch``, ``predict_step_key``, the draft fill and the mixed
    step's token pad: bucketing and the precompiled keys come from the
    same tops, so a precompiled engine captures nothing on the request
    path."""
    s_tops: Tuple[int, ...]
    q_tops: Tuple[int, ...]
    p_tops: Tuple[int, ...]
    keys: Tuple[Tuple, ...] = ()
    digest: str = ""
    source: str = ""
    has_fresh: bool = True

    def __post_init__(self):
        object.__setattr__(self, "s_tops", tuple(sorted(
            {max(int(s), MIN_SLOTS) for s in self.s_tops})))
        object.__setattr__(self, "q_tops", tuple(sorted(
            {int(q) for q in self.q_tops} | {1})))
        object.__setattr__(self, "p_tops", tuple(sorted(
            {max(int(p), MIN_PAGES) for p in self.p_tops})))
        if not (self.s_tops and self.p_tops):
            raise LatticeError(
                "lattice needs at least one S and one P bucket top "
                f"(got s={self.s_tops}, p={self.p_tops})")

    def bucket_s(self, n: int) -> int:
        return _pick(n, self.s_tops, MIN_SLOTS)

    def bucket_q(self, n: int) -> int:
        return _pick(n, self.q_tops, 1)

    def bucket_p(self, n: int) -> int:
        return _pick(n, self.p_tops, MIN_PAGES)


def _prune_q_tops(tops: List[int], ratio: float, s_tops: List[int],
                  p_tops: List[int], page_size: int,
                  batch: int) -> List[int]:
    """Drop a Q top the next kept top covers within ``ratio``, provided
    every (S, P) the dropped top could form stays formable with its
    successor (S * Q <= batch and P * page >= Q decide which keys the
    enumeration keeps; a drop across either would leave a chunk length
    to a capture on the request path).  Q=1 (decode) always stays."""
    ratio = max(float(ratio), 1.0)
    kept: List[int] = []
    for t in sorted(tops, reverse=True):
        if t == 1 or not kept:
            kept.append(t)
            continue
        u = kept[-1]            # the smallest top kept so far above t
        safe = (u <= t * ratio
                and all(s * u <= batch for s in s_tops
                        if s * t <= batch)
                and all(p * page_size >= u for p in p_tops
                        if p * page_size >= t))
        if not safe:
            kept.append(t)
    return sorted(kept)


def mine_lattice(trace: Dict[str, Any], ratio: float = 1.3,
                 max_buckets: int = 12,
                 max_ragged_batch_size: int = 768,
                 source: str = "") -> Dict[str, Any]:
    """A lattice artifact from a loaded workload trace (``{"meta",
    "requests", "compiles", "key_counts"}``, :func:`load_trace_facts`).

    S and P keep the observed bucket values (picking the smallest
    observed top >= n reproduces the capture run's bucketing), while Q
    gets tops fitted to the recorded prompt lengths, joined with the
    observed Q values (a budget-limited prompt chunks to lengths the
    full-prompt tops do not cover) and pruned within ``ratio``.  The key
    set is the enumeration over those tops plus each observed mixed-step
    combination expanded across the fitted Q tops."""
    meta = trace.get("meta", {})
    requests = trace.get("requests", [])
    page = int(meta.get("page_size", 16) or 16)
    vocab = int(meta.get("vocab_size", 0) or 0)

    occ: Dict[tuple, int] = {tuple(k): int(n) for k, n in
                             trace.get("key_counts", {}).items()}
    for k in trace.get("compiles", []):
        occ.setdefault(tuple(k), 1)
    if not occ and not requests:
        raise LatticeError(
            "trace has no step-key occupancy and no requests — nothing "
            "to mine a lattice from")

    s_set, p_set, q_obs, spec_draft = set(), set(), set(), 0
    mixed_combos = set()
    fresh_seen = False
    draft_seen = False
    for k in occ:
        s_set.add(int(k[0]))
        p_set.add(int(k[2]))
        if len(k) > 3 and bool(k[3]):
            fresh_seen = True
        kind = k[4] if len(k) > 4 else "logits"
        if kind == "chain":
            s_set.add(int(k[5]))
        elif kind in ("spec", "draft_spec"):
            spec_draft = max(spec_draft, int(k[1]) - 1)
            draft_seen = draft_seen or kind == "draft_spec"
        elif kind == "draft_fill":
            q_obs.add(int(k[1]))
            draft_seen = True
        elif kind == "mixed":
            # (S_d, 1, P_d, False, "mixed", S_p, Q_p, P_p, fresh_p, g)
            s_set.add(int(k[5]))
            p_set.add(int(k[7]))
            q_obs.add(int(k[6]))
            if bool(k[8]):
                fresh_seen = True
            mixed_combos.add((int(k[0]), int(k[2]), int(k[5]),
                              int(k[7]), bool(k[8]), bool(k[9])))
        else:
            q_obs.add(int(k[1]))

    prompt_lens = [int(r["prompt_len"]) for r in requests]
    if not s_set:
        # a trace of requests alone: power tops up to the request count
        s = _bucket(1, MIN_SLOTS)
        top = min(_bucket(max(len(requests), 1), MIN_SLOTS), 512)
        while s <= top:
            s_set.add(s)
            s *= 2
    if not p_set:
        total = max((int(r["prompt_len"]) + int(r.get("gen_len", 0))
                     for r in requests), default=page)
        p_set = {_bucket(-(-total // page), MIN_PAGES)}
    q_union = sorted(set(fit_buckets(prompt_lens, ratio=ratio,
                                     max_buckets=max_buckets))
                     | q_obs | {1})
    q_tops = _prune_q_tops(q_union, ratio, sorted(s_set), sorted(p_set),
                           page, max_ragged_batch_size)

    lat = BucketLattice(s_tops=tuple(s_set), q_tops=tuple(q_tops),
                        p_tops=tuple(p_set), has_fresh=fresh_seen)
    spec_q = lat.bucket_q(1 + spec_draft) if spec_draft else 0
    keys = enumerate_lattice_keys(
        lat.s_tops, lat.q_tops, lat.p_tops, page_size=page,
        max_ragged_batch_size=max_ragged_batch_size,
        has_fresh=fresh_seen, sampling=True, spec_q=spec_q,
        draft=draft_seen)
    # a fitted Q top re-buckets prompt chunks: each observed mixed
    # combination fans out across every Q_p the chunking can now form
    for (sd, pd, sp, pp, fresh_p, greedy) in sorted(mixed_combos):
        for q in lat.q_tops:
            if q <= 1 or sd + sp * q > max_ragged_batch_size * 2:
                continue
            keys.append((sd, 1, pd, False, "mixed",
                         sp, q, pp, fresh_p, greedy))

    return {
        "kind": LATTICE_ARTIFACT_KIND,
        "version": LATTICE_ARTIFACT_VERSION,
        "config_digest": lattice_config_digest(page, vocab),
        "page_size": page,
        "vocab_size": vocab,
        # the budget the S * Q rule ran under: an engine with a larger
        # one forms keys this artifact left out (resolve_lattice refuses)
        "max_ragged_batch_size": int(max_ragged_batch_size),
        "has_fresh": fresh_seen,
        "s_buckets": list(lat.s_tops),
        "q_buckets": list(lat.q_tops),
        "p_buckets": list(lat.p_tops),
        "keys": [list(k) for k in keys],
        "source": source,
        "requests": len(requests),
        "dispatches": sum(occ.values()),
    }


def load_trace_facts(path: str) -> Dict[str, Any]:
    """Parse a workload-trace JSONL ledger (the first meta record, the
    requests, the on-path compiles and the summed key counts)."""
    meta: Dict[str, Any] = {}
    requests: List[Dict[str, Any]] = []
    compiles: List[list] = []
    key_counts: Dict[tuple, int] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.get("kind")
                if kind == "meta" and not meta:
                    meta = rec
                elif kind == "request":
                    requests.append(rec)
                elif kind == "compile":
                    compiles.append(rec["key"])
                elif kind == "keys":
                    for key, n in rec["counts"]:
                        key_counts[tuple(key)] = (
                            key_counts.get(tuple(key), 0) + int(n))
    except OSError as e:
        raise LatticeError(f"cannot read workload trace {path}: {e}")
    except ValueError as e:
        raise LatticeError(f"{path} is not a workload-trace JSONL "
                           f"ledger: {e}")
    return {"meta": meta, "requests": requests, "compiles": compiles,
            "key_counts": key_counts}


def write_artifact(artifact: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    return path


#: step kind -> the length of its keys
KEY_LENGTHS = {"logits": 4, "sample": 6, "chain": 7, "spec": 6,
               "draft_spec": 6, "draft_fill": 5, "mixed": 10}


def _validate_artifact(doc: Any, path: str) -> Dict[str, Any]:
    if not isinstance(doc, dict) or doc.get("kind") != LATTICE_ARTIFACT_KIND:
        raise LatticeError(
            f"{path} is not a lattice artifact (kind="
            f"{doc.get('kind') if isinstance(doc, dict) else type(doc)!r})")
    if doc.get("version") != LATTICE_ARTIFACT_VERSION:
        raise LatticeError(
            f"unsupported lattice artifact version {doc.get('version')!r} "
            f"in {path} (this build reads {LATTICE_ARTIFACT_VERSION})")
    for field in ("config_digest", "page_size", "vocab_size",
                  "max_ragged_batch_size", "s_buckets", "q_buckets",
                  "p_buckets", "keys"):
        if field not in doc:
            raise LatticeError(
                f"lattice artifact {path} is missing {field!r}")
    for i, key in enumerate(doc["keys"]):
        n = len(key) if isinstance(key, (list, tuple)) else 0
        kind = key[4] if n > 4 else ("logits" if n == 4 else None)
        if kind not in KEY_LENGTHS or n != KEY_LENGTHS[kind]:
            raise LatticeError(
                f"lattice artifact {path}: keys[{i}] = {key!r} is not "
                "a valid (S, Q, P, fresh[, kind, ...]) step key")
    return doc


def load_artifact(path: str) -> Dict[str, Any]:
    """Read and check a lattice artifact (:class:`LatticeError` on
    anything short of a complete document of this version)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise LatticeError(f"cannot read lattice artifact {path}: {e}")
    except ValueError as e:
        raise LatticeError(f"{path} is not a JSON lattice artifact: {e}")
    return _validate_artifact(doc, path)


def _lattice_from_artifact(doc: Dict[str, Any],
                           source: str) -> BucketLattice:
    return BucketLattice(
        s_tops=tuple(doc["s_buckets"]),
        q_tops=tuple(doc["q_buckets"]),
        p_tops=tuple(doc["p_buckets"]),
        keys=tuple(tuple(k) for k in doc["keys"]),
        digest=lattice_content_digest(doc),
        source=source,
        has_fresh=bool(doc.get("has_fresh", True)))


def resolve_lattice(spec: str, *, page_size: int, vocab_size: int,
                    max_ragged_batch_size: int = 768
                    ) -> Optional[BucketLattice]:
    """The lattice of a ``serving.lattice`` spec, at engine build.

    ``""`` gives None (the power-of-two default).  ``"auto:<path>"``
    loads an artifact (one JSON document) or mines one from a raw
    workload trace (JSONL), then checks its geometry digest against this
    engine's (page_size, vocab_size) and its batch budget against this
    engine's: a mismatch raises :class:`LatticeError` naming both
    sides."""
    spec = (spec or "").strip()
    if not spec:
        return None
    if not spec.startswith("auto:"):
        raise LatticeError(
            f"unknown lattice spec {spec!r} (expected \"\" for the "
            "power-of-two default or \"auto:<artifact-or-trace-path>\")")
    path = spec[len("auto:"):]
    if not path or not os.path.exists(path):
        raise LatticeError(
            f"lattice spec {spec!r}: no such file {path!r}")
    # an artifact is ONE JSON object of our kind; a JSONL ledger does not
    # parse as one document and is mined instead
    is_artifact = False
    try:
        with open(path) as f:
            doc = json.load(f)
        is_artifact = (isinstance(doc, dict)
                       and doc.get("kind") == LATTICE_ARTIFACT_KIND)
    except OSError as e:
        raise LatticeError(f"cannot read {path}: {e}")
    except ValueError:
        pass
    if is_artifact:
        doc = _validate_artifact(doc, path)
    else:
        doc = mine_lattice(load_trace_facts(path),
                           max_ragged_batch_size=max_ragged_batch_size,
                           source=path)
    want = lattice_config_digest(page_size, vocab_size)
    have = str(doc["config_digest"])
    if have != want:
        raise LatticeError(
            f"lattice artifact {path} was mined under config digest "
            f"{have} (page_size={doc.get('page_size')}, "
            f"vocab_size={doc.get('vocab_size')}) but this engine's "
            f"digest is {want} (page_size={page_size}, "
            f"vocab_size={vocab_size}): mine it again from a trace "
            "captured on this geometry")
    mined_batch = int(doc.get("max_ragged_batch_size", 0) or 0)
    if mined_batch and mined_batch < max_ragged_batch_size:
        raise LatticeError(
            f"lattice artifact {path} was mined under "
            f"max_ragged_batch_size={mined_batch} but this engine runs "
            f"{max_ragged_batch_size}: keys the larger budget can form "
            "were left out and would be captured on the request path; "
            "mine it again with this budget or a larger one")
    return _lattice_from_artifact(doc, source=path)
