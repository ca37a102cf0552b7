"""fleetctl: see and drive N serving replicas as one fleet.

Counterpart of the JAX package's ``tools/fleetctl.py``.  A CLI over the
federation (``telemetry/federation.py``): scrape each replica's
``/snapshot?raw=1``, merge (counters sum, gauges roll up min/max/sum,
log-bucketed histograms merge exactly), and print status, JSON or
Prometheus text.  It also holds the two-replica subprocess smoke, the
replica-kill demo, and the pool legs over the in-process
:class:`~deepspeed_tpu_torch.serving.ReplicaPool` (a smoke with one
replica drain-migrated mid-run, and a kill/add demo).

Usage::

    python -m deepspeed_tpu_torch.tools.fleetctl \
        --targets 127.0.0.1:9001,127.0.0.1:9002 \
        [status|json|metrics|digests|mem] [--watch SECONDS]
    python -m deepspeed_tpu_torch.tools.fleetctl --targets ... journey <uid>
    python -m deepspeed_tpu_torch.tools.fleetctl --smoke [--device cpu]
    python -m deepspeed_tpu_torch.tools.fleetctl --kill-demo [--device cpu]
    python -m deepspeed_tpu_torch.tools.fleetctl --pool-smoke [--device cpu]
    python -m deepspeed_tpu_torch.tools.fleetctl --pool-demo [--device cpu]

``digests`` prints each target's ``/snapshot?digests=1`` prefix-cache
affinity hint (the subprocess mode's routing input); ``mem`` the
per-replica ``ds_mem_*`` table with fleet totals and headroom;
``journey`` stitches one request's segments across every replica's
``/journey?uid=``.  Targets are ``[label=]host:port`` (labels default to
r0, r1, ...).  The kill demo and the pool legs serve the debug Llama
(``--device``, default ``cuda``; ``cpu`` serves on the CPU) on the
in-repo recorded trace ``tools/traces/sample_200.jsonl``, replayed as
``tools.replay_trace`` replays it (anonymised prompts, the recorded
sampling parameters and lengths); the two-replica smoke keeps the
replicas' synthetic workload (``fleet_replica.synthetic_workload``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

from .replay_trace import SAMPLE_TRACE

#: the directory that holds the ``deepspeed_tpu_torch`` package: a child
#: interpreter imports the package from there
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# -- replica process management ------------------------------------------------
class ReplicaProc:
    """A ``fleet_replica`` child: a fresh interpreter (never a fork of a
    process that touched CUDA), with a reader thread keeping its stdout
    lines.  ``log_path`` keeps its stderr (default: discarded)."""

    def __init__(self, label: str, args: Optional[List[str]] = None,
                 env_extra: Optional[Dict[str, str]] = None,
                 log_path: Optional[str] = None):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p)
        env.update(env_extra or {})
        self.label = label
        self._log = open(log_path, "w") if log_path else None
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.fleet_replica",
             "--label", label] + (args or []),
            stdout=subprocess.PIPE,
            stderr=self._log if self._log else subprocess.DEVNULL,
            text=True, env=env, cwd=PACKAGE_ROOT, start_new_session=True)
        self.spawn_unix = time.time()
        self.lines: List[str] = []
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_line(self, needle: str, timeout: float) -> Optional[str]:
        deadline = time.monotonic() + timeout
        seen = 0
        while time.monotonic() < deadline:
            while seen < len(self.lines):
                if needle in self.lines[seen]:
                    return self.lines[seen]
                seen += 1
            if self.proc.poll() is not None and seen >= len(self.lines):
                self._t.join(timeout=1.0)
                if seen >= len(self.lines):
                    return None
            time.sleep(0.05)
        return None

    def port(self, timeout: float = 120.0) -> int:
        line = self.wait_line("FLEET_REPLICA ready", timeout)
        if line is None:
            raise RuntimeError(
                f"replica {self.label} never reported ready "
                f"(exit={self.proc.poll()})")
        return int(line.split("port=")[1].split()[0])

    def report(self, kind: str, timeout: float = 5.0) -> Any:
        """The JSON of a ``FLEET_REPLICA <kind> <json>`` line (``stats``,
        ``digests``)."""
        line = self.wait_line(f"FLEET_REPLICA {kind} ", timeout)
        if line is None:
            raise RuntimeError(f"replica {self.label} printed no {kind}")
        return json.loads(line.split(f"FLEET_REPLICA {kind} ", 1)[1])

    def terminate(self) -> None:
        """Stop the child and reap it (its server goes with it)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)
        self._t.join(timeout=2.0)
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        if self._log is not None:
            self._log.close()
            self._log = None


def _federation(targets: List[Tuple[str, int]], stale_after_s=None):
    from ..telemetry.federation import Federation
    fed = Federation() if stale_after_s is None else Federation(
        stale_after_s=stale_after_s)
    for label, port in targets:
        fed.add_http(label, f"127.0.0.1:{port}")
    return fed


def fetch_raw(port: int, timeout: float = 5.0) -> Dict[str, Any]:
    """One replica's ``/snapshot?raw=1`` body."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/snapshot?raw=1", timeout=timeout) as r:
        return json.loads(r.read().decode())


# -- subprocess smoke ------------------------------------------------------------
def run_smoke(device: str = "cuda") -> int:
    """Spin two debug replicas, scrape, assert the merged fleet view IS
    the sum of its parts (counters and histogram counts, exactly)."""
    common = ["--rounds", "1", "--device", device]
    reps = [ReplicaProc("r0", common + ["--seed", "0"]),
            ReplicaProc("r1", common + ["--seed", "1"])]
    try:
        targets = [(r.label, r.port()) for r in reps]
        for r in reps:
            if r.wait_line("FLEET_REPLICA done", 180.0) is None:
                raise RuntimeError(
                    f"replica {r.label} did not finish its round")
        fed = _federation(targets)
        view = fed.scrape()
        if view["stale"]:
            raise RuntimeError(f"stale replicas in smoke: "
                               f"{view['replicas']}")
        parts = [fetch_raw(port) for _, port in targets]
        for name, merged in sorted(view["counters"].items()):
            want = sum(p["counters"].get(name, 0) for p in parts)
            if merged != want:
                raise RuntimeError(
                    f"merged counter {name}: {merged} != sum of parts "
                    f"{want}")
        for name, h in sorted(view["hists"].items()):
            want = sum(p["hists"][name]["count"] for p in parts
                       if name in p.get("hists", {}))
            if h["count"] != want:
                raise RuntimeError(
                    f"merged histogram {name}: count {h['count']} != "
                    f"sum of parts {want}")
        toks = view["counters"].get("ds_fastgen_tokens_total", 0)
        if toks <= 0:
            raise RuntimeError("no tokens counted across the fleet")
        print(f"fleetctl smoke: OK: 2 replicas, "
              f"{len(view['counters'])} merged counters == sum of "
              f"parts, {len(view['hists'])} histograms merged exactly, "
              f"{toks} fleet tokens")
        return 0
    finally:
        for r in reps:
            r.terminate()


# -- replica-kill fleet event ------------------------------------------------------
def run_kill_demo(step_sleep_s: float = 0.05, rounds: int = 150,
                  kill_at_step: int = 90,
                  sample_every_s: float = 0.2,
                  run_s: float = 20.0, device: str = "cuda") -> Dict[str, Any]:
    """Two live replicas replaying the recorded trace (the first 4 ok
    requests a round, prompts from each replica's seed); one is killed
    mid-run through the ``serving.preempt`` fault site.  The parent
    federates both, samples a fleet time-series ring, and runs the SLO
    evaluator over it with a fleet-goodput objective set from the
    both-alive rate; returns the aggregate tokens/s, the merged p99 TTFT
    across the kill, the page verdict and its advice.  On one host the
    survivor speeds up when its neighbour dies, so the objective need
    not page (the JAX demo's premise, kept)."""
    from ..telemetry.registry import percentile_from_counts
    from ..telemetry.slo import SLOEvaluator
    from ..telemetry.timeseries import TimeSeries

    # 4 requests a round keep a step's compute small beside the pacing
    # sleep, so the token rate follows the live replicas, not contention
    common = ["--trace", SAMPLE_TRACE, "--trace-limit", "4",
              "--rounds", str(rounds), "--step-sleep-s", str(step_sleep_s),
              "--device", device]
    reps = [
        ReplicaProc("r0", common + ["--seed", "0"]),
        ReplicaProc("r1", common + ["--seed", "1"],
                    env_extra={
                        "DS_CHAOS": f"serving.preempt:at={kill_at_step}"}),
    ]
    try:
        targets = [(r.label, r.port()) for r in reps]
        fed = _federation(targets, stale_after_s=2.0)
        ts = TimeSeries(source=fed.merged_raw)
        ts.configure(interval_s=sample_every_s, retention_s=600.0)
        ev = SLOEvaluator()
        ev.attach(timeseries=ts, federation=fed)
        # both replicas past their first round (the graph captures)
        # before the both-alive rate the objective is set from
        for r in reps:
            if r.wait_line("round=0 done", 300.0) is None:
                raise RuntimeError(
                    f"replica {r.label} never finished round 0 "
                    f"(exit={r.proc.poll()})")
        ts.sample_now()
        time.sleep(max(4 * sample_every_s, 2.4))
        ts.sample_now()
        warm_rate = ts.counter_rate("ds_fastgen_tokens_total", 5.0) or 0.0
        if warm_rate <= 0:
            raise RuntimeError(
                "no fleet tokens observed in the warm window: replicas "
                "too slow for the demo pacing?")
        if reps[1].proc.poll() is not None:
            raise RuntimeError(
                "replica r1 died before the both-alive rate was "
                "measured: raise kill_at_step")
        ev.configure([{
            "name": "fleet_goodput", "kind": "throughput_min",
            "counter": "ds_fastgen_tokens_total",
            "min_per_s": 0.8 * warm_rate, "budget": 0.1,
            "fast_window_s": 2.0, "slow_window_s": 4.0,
            "page_burn": 2.0, "warn_burn": 0.5,
        }])
        t0 = time.monotonic()
        tok0 = fed.scrape()["counters"].get("ds_fastgen_tokens_total", 0)
        paged = advice = surv_rate = None
        kill_seen_at = None
        while time.monotonic() - t0 < run_s:
            time.sleep(sample_every_s)
            ts.sample_now()     # the evaluator rides the on-sample hook
            if kill_seen_at is None and reps[1].proc.poll() is not None:
                kill_seen_at = round(time.monotonic() - t0, 2)
            cur = ev.current()
            if paged is None and cur["status"] == "page":
                v = cur["objectives"]["fleet_goodput"]
                paged = round(time.monotonic() - t0, 2)
                advice = v["advice"]
                surv_rate = ts.counter_rate("ds_fastgen_tokens_total", 2.0)
                break
            if (reps[0].proc.poll() is not None
                    or any("FLEET_REPLICA done" in ln
                           for ln in reps[0].lines)):
                break   # the end of traffic is not the kill
        wall = time.monotonic() - t0
        view = fed.scrape()
        toks = view["counters"].get("ds_fastgen_tokens_total", 0) - tok0
        th = view["hists"].get("ds_fastgen_ttft_ms")
        ttft_p99 = (round(percentile_from_counts(
            th["bounds"], th["counts"], th["count"], 99), 2)
            if th and th["count"] else None)
        return {
            "fastgen_fleet_tok_s": round(toks / wall, 1),
            "fastgen_fleet_ttft_p99_ms": ttft_p99,
            "fastgen_fleet_warm_tok_s": round(warm_rate, 1),
            "fastgen_fleet_survivor_tok_s": (
                round(surv_rate, 1) if surv_rate is not None else None),
            "fastgen_fleet_replicas": len(reps),
            "fastgen_fleet_stale": view["stale"],
            "fastgen_fleet_kill_observed_s": kill_seen_at,
            "fastgen_fleet_paged_at_s": paged,
            "fastgen_fleet_advice": advice,
        }
    finally:
        for r in reps:
            r.terminate()


# -- replica pool (in process) -----------------------------------------------------
def _pool_workload(limit: int):
    """(meta, requests, prompts, sampling params) of the first ``limit``
    ok requests of the recorded trace: the workload every pool leg
    drives."""
    from .replay_trace import (_replayable, _sampling_params, load_trace,
                               synthesize_prompts)
    trace = load_trace(SAMPLE_TRACE)
    requests = _replayable(trace, SAMPLE_TRACE, limit, include_errors=False)
    meta = trace["meta"]
    prompts = synthesize_prompts(requests, int(meta.get("page_size", 16)),
                                 int(meta.get("vocab_size", 128)), seed=0)
    return meta, requests, prompts, _sampling_params(requests)


def _pool_factory(meta, requests, engines: Dict[str, Any], device: str,
                  max_seqs: int = 8, model_size: str = "debug",
                  layers: int = 0):
    """A ReplicaPool factory that caches one replay engine per label (so
    a warm-up pass captures the graphs a later measured pass, its
    post-kill spawn included, will replay)."""
    from ..inference.v2 import FastGenScheduler
    from .replay_trace import build_replay_engine

    def factory(label: str):
        eng = engines.get(label)
        if eng is None:
            eng = build_replay_engine(meta, requests, model_size=model_size,
                                      max_seqs=max_seqs, device=device,
                                      layers=layers)
            engines[label] = eng
        return FastGenScheduler(eng)

    return factory


def _reset_engines(engines: Dict[str, Any]) -> None:
    """Flush every tracked sequence and drop each prefix cache, so the
    next pass starts cold."""
    from .replay_trace import _reset_engine
    for eng in engines.values():
        _reset_engine(eng)


def run_pool_smoke(limit: int = 32, device: str = "cuda",
                   engines: Optional[Dict[str, Any]] = None,
                   model_size: str = "debug", layers: int = 0) -> int:
    """Two in-process replicas behind the prefix-affinity router replay
    the first ``limit`` requests of the recorded trace; one replica is
    drain-migrated away mid-run.  Asserts every request ends with its
    recorded generated length and none is lost, with the pool counters
    monotone through the change.  ``engines``: a label -> engine cache
    to build into (a caller reads their counts afterwards); the replicas
    serve the ``model_size`` Llama preset (``layers`` > 0 cuts its
    depth; on the card a preset whose head dim the kernels take)."""
    from ..serving import ReplicaPool
    from ..telemetry import metrics as tm

    meta, requests, prompts, params = _pool_workload(limit)
    engines = {} if engines is None else engines
    pool = ReplicaPool(_pool_factory(meta, requests, engines, device,
                                     model_size=model_size, layers=layers),
                       replicas=2)
    routed0 = tm.POOL_ROUTED.value
    migrated0 = tm.POOL_MIGRATED.value
    for i in range(len(requests)):
        verdict = pool.submit(i, prompts[i], params[i])
        if verdict is not None:
            raise RuntimeError(
                f"pool smoke: request {i} rejected at submit: "
                f"{verdict.code}")
    for _ in range(6):      # both replicas get work in flight
        pool.step()
    gone = pool.scale_down()
    if gone is None:
        raise RuntimeError("pool smoke: scale_down refused with two "
                           "live replicas")
    pool.run_to_completion()
    results = pool.results()
    problems = []
    if pool.errors:
        problems.append(f"structured errors: "
                        f"{ {u: e.code for u, e in pool.errors.items()} }")
    if len(results) != len(requests):
        problems.append(f"request count: {len(results)} completed vs "
                        f"{len(requests)} submitted")
    for i, rec in enumerate(requests):
        want = max(1, int(rec["gen_len"]))
        got = len(results.get(i, []))
        if got != want:
            problems.append(f"req {i}: gen_len {got} vs recorded {want}")
    routed = tm.POOL_ROUTED.value - routed0
    migrated = tm.POOL_MIGRATED.value - migrated0
    lost = sum(1 for i in range(len(requests))
               if pool.request(i) is None or not pool.request(i).finalized)
    if lost:
        problems.append(f"{lost} request(s) lost")
    if routed < len(requests):
        problems.append(f"routed counter not monotone/complete: "
                        f"{routed} < {len(requests)}")
    if migrated < 1:
        problems.append("no request migrated across the scale_down")
    if len(pool.labels) != 1:
        problems.append(f"expected 1 surviving replica, have "
                        f"{pool.labels}")
    if problems:
        for p in problems:
            print(f"fleetctl pool smoke: {p}", file=sys.stderr)
        raise RuntimeError("pool smoke failed")
    print(f"fleetctl pool smoke: OK: {len(requests)} requests through "
          f"2 replicas, {gone} drain-migrated mid-replay "
          f"({migrated} requests re-homed, partial tokens kept), "
          f"0 lost, exact generated-length parity")
    return 0


def _pool_run_pass(meta, requests, prompts, params, engines, device: str,
                   n_replicas: int, policy: str, pace_s: float, wave: int,
                   wave_gap_s: float, kill_add: bool = False,
                   timeout_s: float = 180.0) -> Dict[str, Any]:
    """One measured pool pass: threaded replicas, wave-paced submission.
    With ``kill_add`` the busiest replica is killed once ~40% of the
    requests completed and a fresh replica is added shortly after."""
    from ..serving import ReplicaPool
    from ..telemetry import metrics as tm
    from .replay_trace import percentile

    pool = ReplicaPool(_pool_factory(meta, requests, engines, device),
                       replicas=n_replicas, policy=policy, hint_every=1)
    look0 = tm.SERVING_PREFIX_LOOKUP_TOKENS.value
    hit0 = tm.SERVING_PREFIX_HIT_TOKENS.value
    migr0 = tm.POOL_MIGRATED.value
    pool.start(pace_s=pace_s)
    t0 = time.monotonic()
    kill_done = add_done = False
    kill_mono = None
    i = 0
    try:
        while True:
            now = time.monotonic()
            due = min(len(prompts), (int((now - t0) / wave_gap_s) + 1)
                      * wave)
            while i < due:
                pool.submit(i, prompts[i], params[i])
                i += 1
            stats = pool.stats()
            if (kill_add and not kill_done
                    and stats["completed"] >= 0.4 * len(prompts)):
                victim = max(stats["backlogs"] or {"": 0},
                             key=lambda lb: stats["backlogs"].get(lb, 0))
                if victim:
                    pool.kill(victim)
                    kill_mono = time.monotonic()
                    kill_done = True
            if (kill_done and not add_done
                    and time.monotonic() - kill_mono > 0.3):
                pool.scale_up()
                add_done = True
            if i >= len(prompts) and pool.serve_until_idle(0.05):
                break
            if time.monotonic() - t0 > timeout_s:
                raise RuntimeError(f"pool pass timed out "
                                   f"({policy}, kill_add={kill_add})")
            time.sleep(0.005)
    finally:
        pool.stop()
    wall = time.monotonic() - t0
    reqs = [pool.request(u) for u in range(len(prompts))]
    toks = sum(len(r.tokens) for r in reqs if r is not None)
    ttft = [(r.first_token_mono - r.submit_mono) * 1e3 for r in reqs
            if r is not None and r.first_token_mono]
    out = {
        "tok_s": round(toks / wall, 1) if wall else None,
        "wall_s": round(wall, 3),
        "completed": sum(1 for r in reqs if r is not None and r.done),
        "lost": sum(1 for r in reqs if r is None or not r.finalized),
        "errors": {u: e.code for u, e in pool.errors.items()},
        "ttft_p99_ms": percentile(ttft, 99),
        "hit_rate": round(
            (tm.SERVING_PREFIX_HIT_TOKENS.value - hit0)
            / max(tm.SERVING_PREFIX_LOOKUP_TOKENS.value - look0, 1), 4),
        "migrated": tm.POOL_MIGRATED.value - migr0,
    }
    if kill_add and kill_mono is not None:
        before = [(r.first_token_mono - r.submit_mono) * 1e3
                  for r in reqs if r is not None and r.first_token_mono
                  and r.first_token_mono <= kill_mono]
        after = [(r.first_token_mono - r.submit_mono) * 1e3
                 for r in reqs if r is not None and r.first_token_mono
                 and r.first_token_mono > kill_mono]
        out["ttft_p99_ms_before_kill"] = percentile(before, 99)
        out["ttft_p99_ms_after_kill"] = percentile(after, 99)
        out["kill_at_s"] = round(kill_mono - t0, 3)
    return out


def run_pool_demo(limit: int = 24, pace_s: float = 0.01, wave: int = 4,
                  wave_gap_s: float = 0.15, device: str = "cuda",
                  model_size: str = "debug",
                  layers: int = 0) -> Dict[str, Any]:
    """The pool kill/add demo: the recorded trace's first ``limit`` ok
    requests through (a) one replica, (b) two under round-robin routing,
    (c) two under the prefix-affinity router, and (d) the affinity pool
    with a replica killed mid-run and one added after: aggregate tokens/s
    against one replica, affinity against round-robin prefix hit rate,
    p99 TTFT before and after the kill, migrated and lost requests.
    Every pass runs on engines warmed by one untimed replay of the whole
    workload each (three labels, so the post-kill spawn is warm too)."""
    from .replay_trace import replay
    meta, requests, prompts, params = _pool_workload(limit)
    engines: Dict[str, Any] = {}
    factory = _pool_factory(meta, requests, engines, device,
                            model_size=model_size, layers=layers)
    for label in ("r0", "r1", "r2"):
        factory(label)
        replay(engines[label], requests, prompts)
    _reset_engines(engines)
    passes = {}
    for name, n, policy, kill in (("single", 1, "affinity", False),
                                  ("rr", 2, "round_robin", False),
                                  ("aff", 2, "affinity", False),
                                  ("kill", 2, "affinity", True)):
        passes[name] = _pool_run_pass(meta, requests, prompts, params,
                                      engines, device, n, policy, pace_s,
                                      wave, wave_gap_s, kill_add=kill)
        _reset_engines(engines)
    single, rr, aff, kill = (passes[k] for k in ("single", "rr", "aff",
                                                 "kill"))
    return {
        "pool_requests": len(prompts),
        "pool_single_tok_s": single["tok_s"],
        "pool_rr_tok_s": rr["tok_s"],
        "pool_affinity_tok_s": aff["tok_s"],
        "pool_agg_tok_s": kill["tok_s"],
        "pool_speedup_vs_single": (
            round(kill["tok_s"] / single["tok_s"], 3)
            if single["tok_s"] else None),
        "pool_prefix_hit_rate_affinity": aff["hit_rate"],
        "pool_prefix_hit_rate_round_robin": rr["hit_rate"],
        "pool_ttft_p99_ms_before_kill": kill.get("ttft_p99_ms_before_kill"),
        "pool_ttft_p99_ms_after_kill": kill.get("ttft_p99_ms_after_kill"),
        "pool_kill_at_s": kill.get("kill_at_s"),
        "pool_migrated_requests": kill["migrated"],
        "pool_lost_requests": kill["lost"],
    }


# -- text views ------------------------------------------------------------------
def _journey_text(targets: List[Tuple[str, str]], uid: int) -> str:
    """Scrape every target's ``/journey?uid=`` records and stitch them
    into one chronological segment chain by journey id; an unreachable
    replica degrades to a line, never an abort."""
    from ..telemetry import journey as jn
    records: List[Dict[str, Any]] = []
    lines = []
    for label, target in targets:
        try:
            with urllib.request.urlopen(
                    f"http://{target}/journey?uid={int(uid)}",
                    timeout=5) as resp:
                doc = json.loads(resp.read().decode())
        except Exception as e:  # noqa: BLE001 (any replica may be down)
            lines.append(f"{label:<8} UNREACHABLE ({e})")
            continue
        comp, frag = doc.get("completed", []), doc.get("fragments", [])
        lines.append(f"{label:<8} {len(comp)} completed, "
                     f"{len(frag)} fragment(s)")
        records.extend(comp + frag)
    if not records:
        lines.append(f"uid {uid}: no journey records on any target "
                     "(telemetry off, or the rings rolled over)")
        return "\n".join(lines)
    stitched = jn.stitch(records)
    total = sum(s["ms"] for s in stitched["segments"])
    lines.append(f"journey {stitched['jid']} uid={uid} "
                 f"outcome={stitched.get('outcome')} "
                 f"sources={stitched['sources']} "
                 f"total={round(total, 2)}ms")
    for s in stitched["segments"]:
        at = f" @{s['at']}" if s.get("at") else ""
        lines.append(f"  {s['seg']:<16} {s['ms']:>10.3f} ms{at}")
    for finding in jn.chain_gaps(stitched, eps_ms=5.0):
        lines.append(f"  GAP: {finding}")
    return "\n".join(lines)


def _digests_text(targets: List[Tuple[str, str]], top_k: int = 8) -> str:
    """Per-target ``/snapshot?digests=1`` affinity hints."""
    from ..serving import fetch_remote_hints
    lines = []
    for label, target in targets:
        try:
            doc = fetch_remote_hints(target, top_k=top_k)
            digests = doc.get("digests", [])
            lines.append(f"{label:<8} page_size={doc.get('page_size')} "
                         f"digests={len(digests)}")
            for d in digests:
                lines.append(f"  {d}")
        except Exception as e:  # noqa: BLE001 (any replica may be down)
            lines.append(f"{label:<8} UNREACHABLE ({e})")
    return "\n".join(lines)


#: fleet memory table columns: subsystem -> gauge name
_MEM_COLUMNS = (
    ("weights", "ds_mem_weights_bytes"),
    ("kv_pages", "ds_mem_kv_pages_bytes"),
    ("draft_kv", "ds_mem_draft_kv_bytes"),
    ("tier_host", "ds_mem_tier_host_bytes"),
    ("tier_disk", "ds_mem_tier_disk_bytes"),
    ("offload", "ds_mem_offload_bytes"),
    ("staging", "ds_mem_staging_bytes"),
    ("telemetry", "ds_mem_telemetry_bytes"),
)


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024.0
    return f"{n:.1f}GiB"


def _mem_text(view: Dict[str, Any]) -> str:
    """One row per replica over the ``ds_mem_*`` subsystem gauges, fleet
    totals from the federation's sum rollup, and the capacity signal:
    fleet headroom is the sum of ``ds_mem_headroom_seqs`` (what the
    fleet can still admit), the minimum names the replica to stop
    routing to."""
    gauges = view.get("gauges", {})
    labels = sorted(view.get("replicas", {}))
    cols = [(s, gauges.get(g, {}).get("per_replica", {}))
            for s, g in _MEM_COLUMNS]
    out = ["replica   " + "".join(f"{s:>11}" for s, _ in cols)
           + f"{'unacct':>11}{'headroom':>10}"]
    unacct = gauges.get("ds_mem_unaccounted_bytes",
                        {}).get("per_replica", {})
    head = gauges.get("ds_mem_headroom_seqs", {})
    head_pr = head.get("per_replica", {})
    for label in labels:
        row = f"{label:<10}"
        for _, pr in cols:
            row += f"{_fmt_bytes(pr.get(label)):>11}"
        row += f"{_fmt_bytes(unacct.get(label)):>11}"
        h = head_pr.get(label)
        row += f"{(int(h) if h is not None else '-'):>10}"
        out.append(row)
    total = f"{'fleet':<10}"
    for s, g in _MEM_COLUMNS:
        total += f"{_fmt_bytes(gauges.get(g, {}).get('sum')):>11}"
    total += (f"{_fmt_bytes(gauges.get('ds_mem_unaccounted_bytes', {}).get('sum')):>11}")
    hs = head.get("sum")
    total += f"{(int(hs) if hs is not None else '-'):>10}"
    out.append(total)
    if head_pr:
        hmin = min((v, k) for k, v in head_pr.items())
        out.append(f"headroom: fleet={int(hs or 0)} seqs admissible, "
                   f"min={int(hmin[0])} on {hmin[1]}")
    else:
        out.append("headroom: no ds_mem_headroom_seqs published: no "
                   "engine built in the replicas, or telemetry is off")
    return "\n".join(out)


def _status_text(view: Dict[str, Any]) -> str:
    lines = [f"fleet: {view['live']} live, {view['stale']} stale"]
    for label, st in sorted(view["replicas"].items()):
        mark = "STALE" if st["stale"] else "up"
        err = f" ({st['error']})" if st["error"] else ""
        lines.append(f"  {label:<8} {mark:<6} {st['target']}"
                     f" age={st['age_s']}s{err}")
    c = view["counters"]
    for key in ("ds_fastgen_tokens_total", "ds_serving_steps_total",
                "ds_fastgen_shed_total"):
        if key in c:
            lines.append(f"  {key} = {c[key]}")
    return "\n".join(lines)


def _target_pairs(targets: str) -> List[Tuple[str, str]]:
    pairs = []
    for i, entry in enumerate(t.strip() for t in targets.split(",")
                              if t.strip()):
        label, _, tgt = (entry.partition("=") if "=" in entry
                         else (f"r{i}", "", entry))
        pairs.append((label.strip(), tgt.strip()))
    return pairs


# -- CLI ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", nargs="?", default="status",
                    choices=["status", "json", "metrics", "digests",
                             "journey", "mem"])
    ap.add_argument("uid", nargs="?", type=int,
                    help="journey command: the request uid to stitch "
                    "across the fleet")
    ap.add_argument("--targets", default="",
                    help="comma-separated [label=]host:port replica "
                    "list (or DS_FLEET_TARGETS)")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="repeat every N seconds")
    ap.add_argument("--smoke", action="store_true",
                    help="spin two debug replicas and assert the "
                    "merged view == sum of parts")
    ap.add_argument("--kill-demo", action="store_true",
                    help="two replicas, one killed mid-run; print the "
                    "fleet keys")
    ap.add_argument("--pool-smoke", action="store_true",
                    help="replica pool smoke: 2 in-process replicas "
                    "behind the affinity router, one drain-migrated "
                    "mid-run; assert every token count and no loss")
    ap.add_argument("--pool-demo", action="store_true",
                    help="replica pool kill/add demo; print its keys")
    ap.add_argument("--limit", type=int, default=0,
                    help="pool legs: replay only the first N trace "
                    "requests (0 = the leg's default)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replica and pool legs serve")
    ap.add_argument("--model-size", default="debug",
                    help="pool legs: the replicas' Llama preset (on the "
                    "card one whose head dim the kernels take, e.g. 7b)")
    ap.add_argument("--layers", type=int, default=0,
                    help="pool legs: cut the preset to N layers (0 = its "
                    "depth)")
    args = ap.parse_args(argv)

    if args.smoke:
        try:
            return run_smoke(device=args.device)
        except RuntimeError as e:
            print(f"fleetctl smoke: FAILED: {e}", file=sys.stderr)
            return 1
    if args.pool_smoke:
        try:
            return run_pool_smoke(
                device=args.device, model_size=args.model_size,
                layers=args.layers,
                **({"limit": args.limit} if args.limit else {}))
        except RuntimeError as e:
            print(f"fleetctl pool smoke: FAILED: {e}", file=sys.stderr)
            return 1
    if args.kill_demo:
        print(json.dumps(run_kill_demo(device=args.device), indent=1))
        return 0
    if args.pool_demo:
        print(json.dumps(run_pool_demo(
            device=args.device, model_size=args.model_size,
            layers=args.layers,
            **({"limit": args.limit} if args.limit else {})), indent=1))
        return 0

    targets = args.targets or os.environ.get("DS_FLEET_TARGETS", "")
    if not targets:
        print("fleetctl: no --targets (or DS_FLEET_TARGETS)",
              file=sys.stderr)
        return 2
    from ..telemetry.federation import Federation
    fed = Federation()
    fed.configure_targets(targets)
    if args.command == "journey":
        if args.uid is None:
            print("fleetctl: journey needs a uid "
                  "(fleetctl --targets ... journey <uid>)", file=sys.stderr)
            return 2
        print(_journey_text(_target_pairs(targets), args.uid))
        return 0
    while True:
        if args.command == "digests":
            print(_digests_text(_target_pairs(targets)))
        elif args.command == "json":
            print(json.dumps(fed.snapshot_json(), indent=1))
        elif args.command == "metrics":
            print(fed.prometheus_text(), end="")
        elif args.command == "mem":
            print(_mem_text(fed.scrape()))
        else:
            print(_status_text(fed.scrape()))
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
