"""Mine a workload trace for the request-shape facts that choose a
serving configuration.

Counterpart of the JAX package's ``tools/analyze_trace.py``.  From a
JSONL ledger written by ``telemetry/workload_trace.py``:

- the request-length distribution (prompt and total tokens), the
  outcome mix and an arrival-overlap concurrency estimate;
- the occupancy of each step key ``(S, Q, P, fresh[, kind, ...])``: how
  often each graph ran (the ``keys`` records), and every graph captured
  on the request path (the ``compile`` records: the keys the
  precompiled lattice missed);
- the coverage of the default power-of-two lattice
  (``inference.v2.engine.lattice_keys``, the enumeration ``precompile()``
  captures) against the observed keys;
- speculation, tier-hit, journey and memory reports (the memory facts
  through ``plan_capacity.mine_memory``);
- a recommended lattice: bucket tops fitted to the observed lengths and
  a precompile key set that covers every observed key.

Run as::

    python -m deepspeed_tpu_torch.tools.analyze_trace --trace trace.jsonl \
        [--max-concurrency 512] [--batch-size 768] [--ratio 1.3] \
        [--json out.json] [--emit-lattice lattice.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from . import plan_capacity as _plan_capacity
from . import replay_trace


def __getattr__(name):
    """``fit_buckets`` lives in ``inference.v2.lattice``, where engine
    build reads it; re-exported lazily, so importing this CLI loads no
    serving stack."""
    if name == "fit_buckets":
        from ..inference.v2.lattice import fit_buckets
        return fit_buckets
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


#: one percentile implementation across the trace tools
_pct = replay_trace.percentile


def recommend_spec_drafter(ngram_rate, model_rate,
                           margin: float = 0.15):
    """Recommend ``spec_drafter`` from per-drafter mined accept rates
    (None = that drafter never drafted in the trace).  The host n-gram
    drafter is free, the model drafter pays a draft-trunk forward per
    step — so prefer "ngram" unless the model drafter's accept rate
    beats it by ``margin``.  A low-accept n-gram workload with an
    UNTRIED model drafter recommends "auto": let the per-request state
    machine probe the draft trunk in production.  Both drafters mined
    below the pay-off floor recommends "off" (run with
    speculative=false).  Returns None when the trace has no
    speculation at all."""
    floor = 0.25
    if ngram_rate is None and model_rate is None:
        return None
    if model_rate is None:
        return "ngram" if ngram_rate >= floor else "auto"
    if ngram_rate is None:
        return "model" if model_rate >= floor else "off"
    if max(ngram_rate, model_rate) < floor:
        return "off"
    return ("model" if model_rate >= ngram_rate + margin else "ngram")


def recommend_spec_max_draft(accept_rate: float, cap: int = 8) -> int:
    """Recommend ``spec_max_draft`` from an observed per-draft accept
    rate ``p``: expected committed tokens per program with k drafts is
    the truncated geometric sum ``E(k) = (1 - p^(k+1)) / (1 - p)``,
    which saturates fast — pick the smallest k within 95% of the
    ``cap``-draft asymptote, so low accept rates recommend short (or
    zero) drafts and high rates recommend long ones without ever
    paying verify width that can't pay for itself."""
    p = min(max(float(accept_rate), 0.0), 0.999)
    if p <= 0.0:
        return 0

    def expected(k: int) -> float:
        return (1.0 - p ** (k + 1)) / (1.0 - p)

    target = 0.95 * expected(cap)
    for k in range(1, cap + 1):
        if expected(k) >= target:
            return k
    return cap


def _concurrency_estimate(requests: List[Dict[str, Any]]) -> int:
    """Max overlap of [arrival, completion] intervals, completion
    approximated from the recorded latency facts (TTFT + (n-1) * mean
    ITL); requests without stamps count as instantaneous."""
    events = []
    for r in requests:
        t0 = float(r.get("arrival_s", 0.0))
        dur = 0.0
        if r.get("ttft_ms") is not None:
            dur += float(r["ttft_ms"]) / 1e3
        if r.get("itl_ms") is not None and int(r.get("gen_len", 0)) > 1:
            dur += float(r["itl_ms"]) * (int(r["gen_len"]) - 1) / 1e3
        events.append((t0, 1))
        events.append((t0 + dur, -1))
    peak = cur = 0
    for _, d in sorted(events):
        cur += d
        peak = max(peak, cur)
    return peak


def observed_keys(trace: Dict[str, Any]) -> Dict[tuple, int]:
    """Occupancy union: step-key summaries plus on-path compiles (a
    compiled key was dispatched at least once even if the process died
    before its ``keys`` summary flushed)."""
    occ = {tuple(k): int(n) for k, n in trace["key_counts"].items()}
    for k in trace["compiles"]:
        occ.setdefault(tuple(k), 1)
    return occ


def analyze(trace: Dict[str, Any], max_concurrency: int = 0,
            batch_size: int = 768, ratio: float = 1.3,
            max_buckets: int = 12) -> Dict[str, Any]:
    requests = trace["requests"]
    meta = trace["meta"]
    page = int(meta.get("page_size", 16) or 16)

    prompt_lens = [int(r["prompt_len"]) for r in requests]
    total_lens = [int(r["prompt_len"]) + int(r["gen_len"])
                  for r in requests]
    outcomes: Dict[str, int] = {}
    for r in requests:
        outcomes[r.get("outcome", "?")] = \
            outcomes.get(r.get("outcome", "?"), 0) + 1
    concurrency = _concurrency_estimate(requests)

    occ = observed_keys(trace)
    compile_keys = [tuple(k) for k in trace["compiles"]]

    # -- current-lattice coverage (the one shared enumeration) --------
    from ..inference.v2.engine import lattice_keys
    mc = max_concurrency or max(concurrency, 1)
    # spec keys in the traffic imply speculation was on: widen the
    # current lattice with the observed spec Q bucket so enabled
    # speculation isn't misreported as uncovered
    spec_q = max((int(k[1]) for k in occ
                  if len(k) > 4 and k[4] in ("spec", "draft_spec")),
                 default=0)
    # draft_spec/draft_fill keys imply a draft trunk was live: widen
    # the current lattice with the draft twins
    draft_seen = any(len(k) > 4 and k[4] in ("draft_spec", "draft_fill")
                     for k in occ)
    current = set(lattice_keys(
        max_prompt=max(prompt_lens), max_new_tokens=max(
            max(int(r["gen_len"]) for r in requests), 1),
        max_concurrency=mc, page_size=page,
        max_ragged_batch_size=batch_size, has_fresh=True,
        sampling=True, spec_max_draft=max(spec_q - 1, 0),
        draft=draft_seen))
    uncovered = sorted(k for k in occ if k not in current)

    # -- recommended lattice ------------------------------------------
    from ..inference.v2.lattice import fit_buckets
    q_buckets = fit_buckets(prompt_lens, ratio=ratio,
                            max_buckets=max_buckets)
    p_buckets = fit_buckets([-(-t // page) for t in total_lens],
                            ratio=ratio, max_buckets=max_buckets)
    s_buckets = sorted({int(k[0]) for k in occ}) or [mc]
    # the recommended precompile set: every key traffic actually formed
    # — which the fitted boundaries above would re-generate once
    # build_batch learns non-power lattices (ROADMAP item 5).  The
    # coverage field below checks it against the ON-PATH COMPILE keys
    # specifically (the acceptance bar); today's recommendation covers
    # them because compiles ⊆ occupancy, but the check is against the
    # emitted key set, so a future recommendation that trims keys
    # (e.g. dropping a rare-key tail) surfaces any regression here
    recommended_keys = sorted(occ)
    rec_uncovered = sorted(set(compile_keys) - set(recommended_keys))

    # -- speculation mining: accept rates recorded per
    # request recommend the verify width for this workload ------------
    drafted = sum(int(r.get("spec_drafted", 0)) for r in requests)
    accepted = sum(int(r.get("spec_accepted", 0)) for r in requests)
    accept_rate = (accepted / drafted) if drafted else None
    # per-drafter split: graceful on legacy traces, whose
    # request records predate the spec_<drafter>_drafted/_accepted
    # fields — the splits then read all-zero and the drafter
    # recommendation falls back to the aggregate note below
    per_drafter: Dict[str, Any] = {}
    for name in ("ngram", "model"):
        dn = sum(int(r.get(f"spec_{name}_drafted", 0))
                 for r in requests)
        an = sum(int(r.get(f"spec_{name}_accepted", 0))
                 for r in requests)
        per_drafter[name] = {
            "drafted": dn, "accepted": an,
            "accept_rate": (round(an / dn, 4) if dn else None)}
    legacy = bool(requests) and not any(
        "spec_drafter" in r for r in requests)
    speculation = {
        "drafted": drafted,
        "accepted": accepted,
        "accept_rate": (round(accept_rate, 4)
                        if accept_rate is not None else None),
        "per_drafter": per_drafter,
        "recommended_spec_max_draft": (
            recommend_spec_max_draft(accept_rate)
            if accept_rate is not None else None),
        "recommended_spec_drafter": recommend_spec_drafter(
            per_drafter["ngram"]["accept_rate"],
            per_drafter["model"]["accept_rate"]),
        "note": (("trace predates per-drafter ledger fields — "
                  "aggregate accept rate only; recapture to mine a "
                  "spec_drafter recommendation") if legacy and drafted
                 else None if drafted else
                 "no speculation in this trace — capture with "
                 "serving_optimization.speculative=true (or replay "
                 "with tools.replay_trace --spec) to mine accept "
                 "rates"),
    }

    # -- tier mining: the per-request hit_device/host/disk/
    # remote token attribution the scheduler writes at finish makes
    # tier sizing minable from a replayed trace the same way lattice
    # keys are: a big host-tier token share says grow the host ring, a
    # big disk share says promotions are eating disk reads, a big
    # remote share says affinity routing is losing placements ---------
    hit_fields = ("device", "host", "disk", "remote")
    hits = {t: sum(int(r.get(f"hit_{t}", 0)) for r in requests)
            for t in hit_fields}
    prompt_total = sum(prompt_lens) or 1
    tiers = {
        "hit_tokens": hits,
        "hit_rate": {t: round(hits[t] / prompt_total, 4)
                     for t in hit_fields},
        "prefix_hit_rate": round(sum(hits.values()) / prompt_total, 4),
        "requests_with_tier_hits": sum(
            1 for r in requests
            if any(int(r.get(f"hit_{t}", 0)) for t in hit_fields[1:])),
        "note": (None if any(hits.values()) else
                 "no tier-hit attribution in this trace — captured "
                 "before the tiered-KV ledger fields existed, or "
                 "prefix caching / kv_tier_* were off"),
    }

    # -- journey mining: the flattened journey_<bucket>_ms
    # TTFT-decomposition scalars the scheduler flushes at drain make
    # per-segment latency minable from the same ledger — where did the
    # slowest requests actually spend their time? -----------------------------
    jfields = ("queue", "placement", "prefill", "handoff", "promote",
               "decode", "migrate")
    jreqs = [r for r in requests if r.get("journey_queue_ms") is not None]
    per_bucket = {}
    for b in jfields:
        vals = [float(r.get(f"journey_{b}_ms", 0.0)) for r in jreqs]
        per_bucket[b] = {"p50": _pct(vals, 50), "p99": _pct(vals, 99)}
    dominant = None
    if jreqs:
        # dominant-segment attribution for the slowest decile (by
        # summed journey time — the e2e latency by construction)
        totals = sorted(
            (sum(float(r.get(f"journey_{b}_ms", 0.0)) for b in jfields),
             i) for i, r in enumerate(jreqs))
        n = max(1, len(totals) // 10)
        slow = [jreqs[i] for _, i in totals[-n:]]
        by_b = {b: sum(float(r.get(f"journey_{b}_ms", 0.0))
                       for r in slow) for b in jfields}
        total = sum(by_b.values())
        if total > 0:
            seg = max(by_b, key=by_b.get)
            dominant = {"bucket": seg,
                        "share": round(by_b[seg] / total, 4),
                        "slow_requests": len(slow)}
    # -- memory mining: the same per-sequence page facts
    # plan_capacity plans capacity from, surfaced in the one
    # mining report — how many whole KV pages a sequence of this
    # workload charges, and how its prefix pages split hot (reused —
    # host-ring material) vs cold (once-seen — disk is fine).  Offline
    # by construction: pool-specific capacity and the live-ledger
    # cross-check are plan_capacity's --kv-pages / --validate legs.
    mined = _plan_capacity.mine_memory(requests, page,
                                       concurrency=concurrency)
    mem_plan = _plan_capacity.plan(mined, kv_pages=0)
    memory = {
        "pages_per_seq": mined["pages_per_seq"],
        "total_pages": mined["total_pages"],
        "predicted_seqs_per_1k_pages": mem_plan["seqs_per_1k_pages"],
        "tier_split": mem_plan["tier_split"],
        "note": (mined["note"] or
                 "pool-specific capacity + live-ledger validation: "
                 "tools.plan_capacity --kv-pages N --validate"),
    }

    journeys = {
        "requests_with_journeys": len(jreqs),
        "per_bucket_ms": per_bucket if jreqs else None,
        "slowest_decile_dominant": dominant,
        "note": (None if jreqs else
                 "no journey decomposition in this trace — captured "
                 "before the journey_<bucket>_ms ledger fields "
                 "existed, or telemetry was off at capture"),
    }

    return {
        "meta": {k: v for k, v in meta.items() if k != "kind"},
        "requests": {
            "count": len(requests),
            "outcomes": outcomes,
            "prompt_len": {"p50": _pct(prompt_lens, 50),
                           "p90": _pct(prompt_lens, 90),
                           "max": max(prompt_lens)},
            "total_len": {"p50": _pct(total_lens, 50),
                          "p90": _pct(total_lens, 90),
                          "max": max(total_lens)},
            "concurrency_estimate": concurrency,
            "ttft_p50_ms": _pct([r["ttft_ms"] for r in requests
                                 if r.get("ttft_ms") is not None], 50),
            "queue_wait_p50_ms": _pct(
                [r["queue_wait_ms"] for r in requests
                 if r.get("queue_wait_ms") is not None], 50),
        },
        "occupancy": {
            "keys": [[list(k), n]
                     for k, n in sorted(occ.items(),
                                        key=lambda kv: -kv[1])],
            "distinct_keys": len(occ),
            "dispatches": sum(occ.values()),
            "compile_on_path_keys": [list(k) for k in compile_keys],
        },
        "coverage": {
            "current_lattice_size": len(current),
            "observed_keys": len(occ),
            "uncovered_by_current": [list(k) for k in uncovered],
        },
        "speculation": speculation,
        "tiers": tiers,
        "journeys": journeys,
        "memory": memory,
        "recommended_lattice": {
            "page_size": page,
            "s_buckets": s_buckets,
            "q_buckets": q_buckets,
            "p_buckets": p_buckets,
            "keys": [list(k) for k in recommended_keys],
            "uncovered_on_path_compile_keys": [list(k)
                                               for k in rec_uncovered],
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True, help="workload JSONL path")
    ap.add_argument("--max-concurrency", type=int, default=0,
                    help="current-lattice S range (default: the "
                    "trace's concurrency estimate)")
    ap.add_argument("--batch-size", type=int, default=768,
                    help="max_ragged_batch_size of the serving config")
    ap.add_argument("--ratio", type=float, default=1.3,
                    help="max per-bucket overshoot of the fitted "
                    "boundaries")
    ap.add_argument("--max-buckets", type=int, default=12)
    ap.add_argument("--json", default="",
                    help="also write the report to this path")
    ap.add_argument("--emit-lattice", default="", metavar="PATH",
                    help="write a versioned lattice artifact (fitted "
                    "bucket tops + precompile key set + config digest) "
                    "that engine build consumes via "
                    "serving_optimization.lattice=\"auto:PATH\"; a "
                    "digest mismatch at load refuses "
                    "with a structured error, never a silent cold "
                    "lattice")
    args = ap.parse_args(argv)

    trace = replay_trace.load_trace(args.trace)
    report = analyze(trace, max_concurrency=args.max_concurrency,
                     batch_size=args.batch_size, ratio=args.ratio,
                     max_buckets=args.max_buckets)
    if args.emit_lattice:
        from ..inference.v2 import lattice as dslattice
        artifact = dslattice.mine_lattice(
            trace, ratio=args.ratio, max_buckets=args.max_buckets,
            max_ragged_batch_size=args.batch_size, source=args.trace)
        dslattice.write_artifact(artifact, args.emit_lattice)
        report["emitted_lattice"] = {
            "path": args.emit_lattice,
            "config_digest": artifact["config_digest"],
            "keys": len(artifact["keys"]),
            "s_buckets": artifact["s_buckets"],
            "q_buckets": artifact["q_buckets"],
            "p_buckets": artifact["p_buckets"],
        }
    print(json.dumps(report, indent=1, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
