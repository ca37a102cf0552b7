"""Predict serving memory capacity from a configuration and a mined
workload trace, and hold the plan to the live memory ledger.

Counterpart of the JAX package's ``tools/plan_capacity.py``.  Offline:
the recorded request lengths give the pages a sequence takes; the model
preset and the page geometry give the bytes of a page (at the replay's
dtype: fp32 on the CPU, bf16 on the card); together they predict how
many sequences a pool of ``--kv-pages`` holds, the headroom at the
trace's concurrency, and a host/disk tier split (shared prefix pages
want the host ring, once-seen ones the disk).

``--validate`` builds the engine ``replay_trace`` would and replays the
trace twice with telemetry on, then checks the ledger: every ``ds_mem_*``
accountant registered and readable; the accounted-vs-measured residual
within ``--tolerance`` of the measured total; no drift between the two
passes; the predicted capacity within one sequence or 10% of the live
headroom.  ``--oom-smoke`` arms the ``kv.alloc_oom`` fault site, replays,
and asserts the evidence: a ``mem.breakdown`` flight-recorder event with
each rung's pages freed, and a postmortem ``memory.json`` naming the
dominant subsystem.  ``--check`` exits non-zero on any failed check.

Run as::

    python -m deepspeed_tpu_torch.tools.plan_capacity \
        --trace tools/traces/sample_200.jsonl [--kv-pages 4096] \
        [--max-seqs 32] [--validate] [--oom-smoke] [--tolerance 0.10] \
        [--device cuda|cpu] [--layers N] [--check] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from typing import Any, Dict, List

from . import replay_trace

_pct = replay_trace.percentile


# -- trace mining (shared with analyze_trace) -----------------------
def mine_memory(requests: List[Dict[str, Any]], page: int,
                concurrency: int = 0) -> Dict[str, Any]:
    """The per-sequence page facts a capacity plan needs, mined from
    recorded request records: the pages-per-sequence distribution
    (prompt + generation, ceil pages — exactly what the allocator
    charges), and the prefix-page reuse structure from the recorded
    digest chains (a page referenced by >1 request is HOT: it earns a
    host-ring slot; a once-seen page is COLD: disk is fine).  The one
    implementation behind plan_capacity and the analyze_trace ``memory``
    section: both charge whole pages."""
    pages = [-(-(int(r["prompt_len"]) + int(r.get("gen_len", 0)))
               // page) for r in requests]
    digest_refs: Dict[str, int] = {}
    for r in requests:
        for d in r.get("digests", ()):
            digest_refs[d] = digest_refs.get(d, 0) + 1
    distinct = len(digest_refs)
    hot = sum(1 for n in digest_refs.values() if n > 1)
    return {
        "page_size": page,
        "pages_per_seq": {
            "p50": _pct(pages, 50), "p90": _pct(pages, 90),
            "p99": _pct(pages, 99), "max": max(pages) if pages else 0,
        },
        "total_pages": sum(pages),
        "distinct_prefix_pages": distinct,
        "hot_prefix_pages": hot,
        "cold_prefix_pages": distinct - hot,
        "concurrency_estimate": int(concurrency),
        "note": (None if digest_refs else
                 "no prefix digest chains in this trace — tier-split "
                 "recommendation degrades to the length distribution "
                 "only (recapture with the workload ledger to mine "
                 "page reuse)"),
    }


def plan(mined: Dict[str, Any], kv_pages: int,
         bytes_per_page: int = 0, max_seqs: int = 0) -> Dict[str, Any]:
    """Config + mined facts -> the prediction: resident-sequence
    capacity of the pool (pages / p90 pages-per-seq, slot-clamped —
    the same admissibility model ``engine.headroom()`` serves live),
    headroom at the observed concurrency, and the tier split."""
    p90 = max(int(mined["pages_per_seq"]["p90"] or 0), 1)
    conc = int(mined["concurrency_estimate"])
    cap = kv_pages // p90 if kv_pages else 0
    if max_seqs:
        cap = min(cap, max_seqs)
    hot = int(mined["hot_prefix_pages"])
    cold = int(mined["cold_prefix_pages"])
    return {
        "kv_pages": int(kv_pages),
        "bytes_per_page": int(bytes_per_page),
        "kv_pool_bytes": (int(bytes_per_page) * (kv_pages + 1)
                          if bytes_per_page else None),
        "capacity_seqs": cap,
        "seqs_per_1k_pages": 1000 // p90,
        "bound": ("slots" if max_seqs and kv_pages // p90 >= max_seqs
                  else "kv_pages"),
        "headroom_at_observed_concurrency": cap - conc,
        "tier_split": {
            # the device pool must hold the ACTIVE working set (one
            # p90 sequence per concurrent request plus its landing
            # page); the host ring earns the hot reuse set; disk takes
            # the cold tail
            "device_pages_needed": conc * (p90 + 1),
            "host_pages_recommended": hot,
            "disk_pages_recommended": cold,
            "note": mined["note"],
        },
    }


def _bytes_per_page(page: int, model_size: str = "debug",
                    device: str = "cuda") -> int:
    """The page footprint of the preset's KV geometry at the replay's
    dtype on ``device`` (fp32 on the CPU, bf16 on the card), without
    building an engine (``KVCacheConfig`` is arithmetic)."""
    from ..inference.v2 import KVCacheConfig
    from ..models.llama import llama_config
    cfg = llama_config(model_size, max_seq_len=64,
                       dtype=replay_trace._dtype_for(device))
    return KVCacheConfig(
        num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
        head_dim=cfg.dims_per_head, page_size=page, num_pages=1,
        dtype=cfg.dtype).bytes_per_page


def run_plan(trace_path: str, limit: int = 0, kv_pages: int = 0,
             max_seqs: int = 32, model_size: str = "debug",
             device: str = "cuda") -> Dict[str, Any]:
    """The offline leg: load -> mine -> predict.  ``kv_pages=0``
    plans for the pool replay_trace's auto-sizing would build, so the
    --validate comparison is against the engine actually constructed."""
    trace = replay_trace.load_trace(trace_path)
    requests = replay_trace._replayable(trace, trace_path, limit,
                                        include_errors=False)
    meta = trace["meta"]
    page = int(meta.get("page_size", 16))
    # analyze_trace owns the interval-overlap concurrency estimator
    # (imported here: analyze_trace imports this module for mine_memory)
    from . import analyze_trace
    conc = max(analyze_trace._concurrency_estimate(requests), 1)
    mined = mine_memory(requests, page, concurrency=conc)
    if not kv_pages:
        # replay_trace._build_engine's pool: max_seqs worst-case
        # sequences, at least 256 pages
        need = max(int(r["prompt_len"]) + max(1, int(r["gen_len"]))
                   for r in requests) + page
        kv_pages = max(256, max_seqs * -(-need // page))
    bpp = _bytes_per_page(page, model_size, device)
    return {
        "trace": trace_path,
        "requests": len(requests),
        "memory": mined,
        "plan": plan(mined, kv_pages, bytes_per_page=bpp,
                     max_seqs=max_seqs),
        "_requests": requests,      # stripped before printing
        "_meta": meta,
    }


# -- validation against the live ledger --------------------------------------
def validate(report: Dict[str, Any], seed: int = 0,
             tolerance: float = 0.10, model_size: str = "debug",
             max_seqs: int = 32, device: str = "cuda",
             layers: int = 0) -> Dict[str, Any]:
    """Replay the planned trace twice on a real engine with telemetry
    on and hold the plan to the ledger's account of what happened.
    ``layers`` > 0 cuts the preset's depth (the plan's page bytes stay
    the preset's)."""
    from .. import telemetry as dstel
    from ..telemetry.memory import SUBSYSTEMS, get_memory_ledger

    requests, meta = report["_requests"], report["_meta"]
    page = int(meta.get("page_size", 16))
    planned = report["plan"]
    ledger = get_memory_ledger()
    ledger.reset()
    engine = replay_trace.build_replay_engine(
        meta, requests, model_size=model_size,
        num_pages=planned["kv_pages"], max_seqs=max_seqs, device=device,
        layers=layers)
    prompts = replay_trace.synthesize_prompts(
        requests, page, replay_trace._vocab(meta, engine.model.cfg),
        seed=seed)
    prev = dstel.enabled()
    dstel.enable()
    try:
        replay_trace.replay(engine, requests, prompts)
        bd1 = ledger.breakdown()
        replay_trace._reset_engine(engine)
        replay_trace.replay(engine, requests, prompts)
        bd2 = ledger.breakdown()
        replay_trace._reset_engine(engine)
        head = engine.headroom()
    finally:
        dstel.set_enabled(bool(prev))

    problems: List[str] = []
    missing = sorted(set(SUBSYSTEMS) - set(bd2["subsystems"]))
    if missing:
        problems.append(
            f"[ledger] subsystem accountant(s) never registered: "
            f"{missing}")
    dead = sorted(s for s in ("weights", "kv_pages")
                  if not bd2["subsystems"].get(s, 0))
    if dead:
        problems.append(
            f"[ledger] {dead} read zero bytes after a replay — the "
            "accountant callbacks are dead")
    measured = int(bd2["measured_bytes"])
    resid = abs(int(bd2["unaccounted_bytes"]))
    # the residual compares the device-resident accountants with a count
    # of device bytes: on the CPU the ledger measures the whole process's
    # RSS (PyTorch has no sum of live tensors), which it cannot match
    residual_checked = bd2["measured_source"] == "device"
    if residual_checked and measured > 0 and resid > tolerance * measured:
        problems.append(
            f"[residual] unaccounted {resid} bytes exceeds "
            f"{tolerance:.0%} of measured {measured} "
            f"(source={bd2['measured_source']}) : a device-resident "
            "subsystem is missing an accountant")
    drift = abs(int(bd2["measured_bytes"]) - int(bd1["measured_bytes"]))
    if bd1["measured_bytes"] and drift > tolerance * bd1["measured_bytes"]:
        problems.append(
            f"[leak] measured bytes drifted {drift} between two "
            "identical replays — steady state is not leak-free")
    p90 = max(int(report["memory"]["pages_per_seq"]["p90"] or 0), 1)
    live_cap = max(min(int(head["headroom_pages"]) // p90,
                       int(head["slot_headroom"])), 0)
    want = int(planned["capacity_seqs"])
    if abs(live_cap - want) > max(1, int(0.10 * max(want, 1))):
        problems.append(
            f"[capacity] plan predicted {want} resident seqs but the "
            f"drained engine's headroom admits {live_cap} at the "
            "mined p90 — the plan and the live pool disagree")
    return {
        "pass1": bd1, "pass2": bd2,
        "headroom": head,
        "live_capacity_seqs": live_cap,
        "predicted_capacity_seqs": want,
        "residual_checked": residual_checked,
        "problems": problems, "ok": not problems,
    }


# -- OOM forensics chaos leg -------------------------------------------------
def oom_smoke(report: Dict[str, Any], seed: int = 0,
              model_size: str = "debug", max_seqs: int = 8,
              device: str = "cuda", layers: int = 0) -> Dict[str, Any]:
    """Arm ``kv.alloc_oom``, replay, and assert the forensics chain:
    the degrade ladder must leave a ``mem.breakdown`` event (with its
    per-rung pages-freed accounting) in the flight recorder, and
    ``dump_postmortem`` must ship a ``memory.json`` naming the
    dominant subsystem."""
    from .. import telemetry as dstel
    from ..runtime.fault_injection import get_fault_injector
    from ..telemetry.flight_recorder import (dump_postmortem,
                                             get_flight_recorder)
    from ..telemetry.memory import get_memory_ledger

    requests, meta = report["_requests"], report["_meta"]
    page = int(meta.get("page_size", 16))
    get_memory_ledger().reset()
    engine = replay_trace.build_replay_engine(
        meta, requests, model_size=model_size, max_seqs=max_seqs,
        device=device, layers=layers)
    prompts = replay_trace.synthesize_prompts(
        requests, page, replay_trace._vocab(meta, engine.model.cfg),
        seed=seed)
    rec = get_flight_recorder()
    rec.clear()
    inj = get_fault_injector()
    prev = dstel.enabled()
    dstel.enable()
    # fire once, early: the scheduler's degrade ladder catches the
    # injected KVAllocationError and must leave the breakdown behind
    inj.configure({"kv.alloc_oom": {"at": "2", "max": 1}}, seed=seed)
    dump_dir = tempfile.mkdtemp(prefix="ds_mem_smoke_")
    try:
        replay_trace.replay(engine, requests, prompts)
        fired = inj.stats().get("kv.alloc_oom", {}).get("fires", 0)
        events = [e for e in rec.events()
                  if e.get("kind") == "mem.breakdown"]
        paths = dump_postmortem(dump_dir)
        mem_doc = None
        if "memory.json" in paths:
            with open(paths["memory.json"]) as f:
                mem_doc = json.load(f)
    finally:
        inj.disarm()
        dstel.set_enabled(bool(prev))
        shutil.rmtree(dump_dir, ignore_errors=True)

    problems: List[str] = []
    if not fired:
        problems.append("[chaos] kv.alloc_oom never fired — the "
                        "replay made no KV allocations?")
    if not events:
        problems.append("[forensics] no mem.breakdown event in the "
                        "flight recorder after an injected OOM")
    else:
        ev = events[-1]
        if not ev.get("dominant"):
            problems.append("[forensics] mem.breakdown names no "
                            "dominant subsystem")
        if not isinstance(ev.get("rungs"), list):
            problems.append("[forensics] mem.breakdown carries no "
                            "per-rung pages-freed accounting")
    if mem_doc is None:
        problems.append("[postmortem] dump_postmortem shipped no "
                        "memory.json although the ledger was armed")
    elif not mem_doc.get("dominant"):
        problems.append("[postmortem] memory.json names no dominant "
                        "subsystem")
    return {
        "injected_fires": fired,
        "breakdown_events": len(events),
        "dominant": (events[-1].get("dominant") if events else None),
        "memory_json": (sorted(mem_doc) if mem_doc else None),
        "problems": problems, "ok": not problems,
    }


# -- CLI ---------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True, help="workload JSONL path")
    ap.add_argument("--limit", type=int, default=0,
                    help="plan over only the first N ok requests")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="device KV pool to plan for (0 = the pool "
                    "the replay engine would auto-size)")
    ap.add_argument("--max-seqs", type=int, default=32,
                    help="tracked-sequence slots of the target config")
    ap.add_argument("--model-size", default="debug",
                    help="llama preset for page-byte geometry and the "
                    "--validate engine")
    ap.add_argument("--seed", type=int, default=0,
                    help="prompt-synthesis seed")
    ap.add_argument("--tolerance", type=float, default=0.10,
                    help="accounted-vs-measured residual and leak "
                    "bound for --validate (fraction of measured)")
    ap.add_argument("--validate", action="store_true",
                    help="replay the trace twice and hold the plan to "
                    "the live memory ledger")
    ap.add_argument("--oom-smoke", action="store_true",
                    help="chaos leg: injected kv.alloc_oom must leave "
                    "mem.breakdown forensics and a memory.json "
                    "postmortem")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on any failed assertion")
    ap.add_argument("--json", default="",
                    help="also write the report to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the --validate and --oom-smoke engines "
                    "serve (the page bytes follow its dtype)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the --validate and --oom-smoke engines to N "
                    "layers (0 = the preset's depth)")
    args = ap.parse_args(argv)

    try:
        report = run_plan(args.trace, limit=args.limit,
                          kv_pages=args.kv_pages,
                          max_seqs=args.max_seqs,
                          model_size=args.model_size, device=args.device)
    except ValueError as e:
        print(f"plan_capacity: {e}", file=sys.stderr)
        return 1
    problems: List[str] = []
    if args.validate:
        v = validate(report, seed=args.seed, tolerance=args.tolerance,
                     model_size=args.model_size,
                     max_seqs=args.max_seqs, device=args.device,
                     layers=args.layers)
        report["validate"] = v
        problems += v["problems"]
    if args.oom_smoke:
        s = oom_smoke(report, seed=args.seed,
                      model_size=args.model_size, device=args.device,
                      layers=args.layers)
        report["oom_smoke"] = s
        problems += s["problems"]
    report.pop("_requests", None)
    report.pop("_meta", None)
    print(json.dumps(report, indent=1, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
    if args.check and problems:
        print("plan_capacity: CAPACITY PLAN FAILED", file=sys.stderr)
        for p in problems:
            print(f"plan_capacity:   {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
