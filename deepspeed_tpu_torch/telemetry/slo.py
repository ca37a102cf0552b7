"""SLO burn-rate evaluator: the telemetry core's signals turned into the
control records an autoscaler acts on.

Counterpart of ``deepspeed_tpu/telemetry/slo.py`` (plain Python, the same
kinds, defaults, refusals, burns and transitions).

An *objective* is an error budget ("p99 TTFT under 500ms" allows 1% of
requests over 500ms; "shed rate under 1%" allows 1 shed per 100
requests; "fleet goodput over 2000 tok/s" allows a 10% shortfall).  The
*burn rate* is how fast the budget is being spent: bad-fraction /
budget, so burn 1.0 exhausts the budget exactly at the objective's
horizon and burn 10 exhausts it 10x early.  Following the SRE
multi-window pattern, every objective is evaluated over a FAST window
(reacts in seconds–minutes) and a SLOW window (suppresses blips): a
verdict escalates only when both burn — fast-only spikes are noise,
slow-only burn is old news already healing.

Objective kinds, all computed from the time-series ring
(:mod:`.timeseries`) — never from lifetime cumulatives, which dilute:

- ``latency``  — fraction of a histogram's *window* observations above
  ``threshold_ms`` vs the quantile's budget (p99 → 1%).
- ``ratio``    — a bad-counter's window delta over a traffic
  denominator (counters and/or histogram counts) vs ``budget``.
- ``throughput_min`` — shortfall of a counter's windowed rate below
  ``min_per_s`` vs ``budget`` (the fleet-goodput / scale-up signal;
  optional ``scale_down_below_per_s`` emits scale-DOWN advice while
  comfortably idle).
- ``balance``  — max/min per-replica rate of a counter across a
  federation (:meth:`~.federation.Federation.replica_rates`) vs
  ``max_ratio`` (the hot-spot / rebalance signal).
- ``capacity`` — fraction of window samples where a headroom gauge
  (default ``ds_mem_headroom_seqs``, the memory ledger's admissible-
  sequences signal) sits below ``min_headroom_seqs`` vs ``budget`` —
  the page fires while admissions still succeed, BEFORE the OOM
  degrade ladder starts shedding.

Verdicts are ``ok``/``warn``/``page`` with structured advice records
(``scale_up`` / ``scale_down`` / ``rebalance``); every status
TRANSITION lands in the flight recorder (``slo.verdict`` /
``slo.advice`` events) and the current verdicts ride ``/healthz`` — the
surface a pool controller subscribes to (``ReplicaPool.attach_slo``).

Configured via ``telemetry.slo_objectives`` (a list of objective dicts,
shared ``apply_settings`` path); the evaluator attaches to the
time-series sampler's per-sample hook so verdicts track the series.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from . import metrics as tm

KINDS = ("latency", "ratio", "throughput_min", "balance", "capacity")
SEVERITY = {"ok": 0, "warn": 1, "page": 2}

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 300.0
DEFAULT_PAGE_BURN = 6.0
DEFAULT_WARN_BURN = 2.0
#: the slow window escalates at this fraction of the fast threshold
SLOW_FACTOR = 0.5

_DEFAULT_ADVICE = {"latency": "scale_up", "ratio": "scale_up",
                   "throughput_min": "scale_up", "balance": "rebalance",
                   "capacity": "scale_up"}


def _normalize(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Fill defaults and validate one objective spec (unknown kinds and
    missing required fields raise at configure time, not mid-serve)."""
    o = dict(spec)
    kind = o.get("kind")
    if kind not in KINDS:
        raise ValueError(f"slo objective kind {kind!r} not in {KINDS}")
    if "name" not in o:
        raise ValueError(f"slo objective needs a name: {spec}")
    required = {"latency": ("hist", "threshold_ms"),
                "ratio": ("bad", "total"),
                "throughput_min": ("counter", "min_per_s"),
                "balance": ("counter",),
                "capacity": ("min_headroom_seqs",)}[kind]
    for field in required:
        if field not in o:
            raise ValueError(
                f"slo objective {o['name']!r} ({kind}) missing "
                f"{field!r}")
    o.setdefault("quantile", 99.0)
    if kind == "latency":
        o.setdefault("budget", 1.0 - float(o["quantile"]) / 100.0)
    elif kind == "throughput_min":
        o.setdefault("budget", 0.1)
    else:
        o.setdefault("budget", 0.01)
    if o["budget"] <= 0:
        raise ValueError(f"slo objective {o['name']!r}: budget must "
                         "be > 0")
    o.setdefault("max_ratio", 4.0)
    o.setdefault("metric", "ds_mem_headroom_seqs")
    if kind == "capacity" and float(o["min_headroom_seqs"]) <= 0:
        # a zero floor can never be undershot (headroom gauges clamp
        # at 0) — the objective would be forever-ok, silently
        raise ValueError(f"slo objective {o['name']!r}: "
                         "min_headroom_seqs must be > 0")
    if kind == "throughput_min" and float(o["min_per_s"]) <= 0:
        # a zero floor would divide by zero inside evaluate(), where
        # the sampler hook's guard would silently swallow it — refuse
        # at configure time instead
        raise ValueError(f"slo objective {o['name']!r}: min_per_s "
                         "must be > 0")
    if kind == "balance" and float(o["max_ratio"]) <= 0:
        raise ValueError(f"slo objective {o['name']!r}: max_ratio "
                         "must be > 0")
    o.setdefault("fast_window_s", DEFAULT_FAST_WINDOW_S)
    o.setdefault("slow_window_s", DEFAULT_SLOW_WINDOW_S)
    o.setdefault("page_burn", 2.0 if kind == "balance"
                 else DEFAULT_PAGE_BURN)
    o.setdefault("warn_burn", 1.0 if kind == "balance"
                 else DEFAULT_WARN_BURN)
    o.setdefault("advice", _DEFAULT_ADVICE[kind])
    if isinstance(o.get("total"), str):
        o["total"] = [o["total"]]
    return o


class SLOEvaluator:
    """Multi-window burn-rate evaluation over a time-series ring."""

    def __init__(self):
        self._lock = threading.RLock()
        self._objectives: List[Dict[str, Any]] = []
        self._status: Dict[str, str] = {}
        self._verdicts: Dict[str, Dict[str, Any]] = {}
        self._scale_down_advised: Dict[str, bool] = {}
        self._ts = None
        self._federation = None

    # -- configuration -------------------------------------------------------
    def configure(self, objectives: Optional[List[Dict[str, Any]]] = None
                  ) -> None:
        """Config-block entry point (None/empty = keep current)."""
        if not objectives:
            return
        normalized = [_normalize(o) for o in objectives]
        with self._lock:
            self._objectives = normalized
            self._status = {o["name"]: "ok" for o in normalized}
            self._verdicts = {}
            self._scale_down_advised = {}

    def attach(self, timeseries=None, federation=None) -> None:
        """Bind the series (and optionally a federation for ``balance``
        objectives) and register the per-sample hook."""
        if timeseries is not None:
            self._ts = timeseries
        if federation is not None:
            self._federation = federation
        ts = self._ts
        if ts is not None:
            # add_on_sample dedupes, so re-attach is always safe — an
            # "already attached" latch here would desync from a
            # TimeSeries.disable() that cleared the hook list
            ts.add_on_sample(self._on_sample)

    def reset(self) -> None:
        with self._lock:
            self._objectives = []
            self._status = {}
            self._verdicts = {}
            self._scale_down_advised = {}
            self._ts = None
            self._federation = None

    @property
    def configured(self) -> bool:
        return bool(self._objectives)

    def _on_sample(self, ts) -> None:
        self.evaluate(ts)

    # -- burn computation ----------------------------------------------------
    def _burn(self, o: Dict[str, Any], ts, window_s: float
              ) -> Optional[float]:
        """One objective's burn rate over one window; None = no data
        (never treated as either healthy or burning)."""
        kind = o["kind"]
        if kind == "latency":
            w = ts.hist_window(o["hist"], window_s)
            if w is None or w.count == 0:
                return None
            return w.frac_above(float(o["threshold_ms"])) / o["budget"]
        if kind == "ratio":
            bad = ts.counter_delta(o["bad"], window_s) or 0.0
            total = 0.0
            for src in o["total"]:
                d = ts.counter_delta(src, window_s)
                if d is None:
                    w = ts.hist_window(src, window_s)
                    d = w.count if w is not None else None
                total += d or 0.0
            total += bad if o.get("bad_in_total", True) else 0.0
            if total <= 0:
                return None
            return (bad / total) / o["budget"]
        if kind == "throughput_min":
            rate = ts.counter_rate(o["counter"], window_s)
            if rate is None:
                return None
            shortfall = max(0.0, 1.0 - rate / float(o["min_per_s"]))
            return shortfall / o["budget"]
        if kind == "capacity":
            series = ts.gauge_series(o["metric"], window_s)
            if not series:
                return None
            floor = float(o["min_headroom_seqs"])
            bad = sum(1 for _, v in series if v < floor)
            return (bad / len(series)) / o["budget"]
        # balance: federation-fed, windowless (scrape-to-scrape)
        fed = self._federation
        if fed is None:
            return None
        rates = [r for r in fed.replica_rates(o["counter"]).values()
                 if r is not None]
        if len(rates) < 2 or min(rates) <= 0:
            return None
        return (max(rates) / min(rates)) / float(o["max_ratio"])

    def _value(self, o: Dict[str, Any], ts,
               fast_burn: Optional[float]) -> Optional[float]:
        """The objective's headline observable (for the verdict
        record).  ``fast_burn`` is the fast-window burn the caller
        already computed — a ratio's value derives from it directly
        instead of re-running the O(ring) scans on the step path."""
        kind, w_s = o["kind"], o["fast_window_s"]
        if kind == "latency":
            w = ts.hist_window(o["hist"], w_s)
            return (round(w.percentile(float(o["quantile"])), 3)
                    if w is not None and w.count else None)
        if kind == "throughput_min":
            r = ts.counter_rate(o["counter"], w_s)
            return round(r, 3) if r is not None else None
        if kind == "ratio":
            return (round(fast_burn * o["budget"], 6)
                    if fast_burn is not None else None)
        if kind == "capacity":
            series = ts.gauge_series(o["metric"], w_s)
            return series[-1][1] if series else None
        return None

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, ts=None) -> List[Dict[str, Any]]:
        """Evaluate every objective now; returns the verdict list and
        records transitions (flight recorder + counters/gauges).
        Serialized under the evaluator lock: the background sampler
        thread and the scheduler-step tick can fire concurrently, and
        two interleaved evaluations of one real transition must not
        double-count pages or lose a status update."""
        ts = ts or self._ts
        if ts is None or not self._objectives:
            return []
        with self._lock:
            return self._evaluate_locked(ts)

    def _evaluate_locked(self, ts) -> List[Dict[str, Any]]:
        objectives = list(self._objectives)
        if not objectives:
            return []
        verdicts: List[Dict[str, Any]] = []
        worst = 0
        worst_burn = 0.0
        for o in objectives:
            fast = self._burn(o, ts, o["fast_window_s"])
            slow = (fast if o["kind"] == "balance"
                    else self._burn(o, ts, o["slow_window_s"]))
            prev = self._status.get(o["name"], "ok")
            if fast is None or slow is None:
                status = prev      # insufficient data: no flapping
            elif (fast >= o["page_burn"]
                    and slow >= o["page_burn"] * SLOW_FACTOR):
                status = "page"
            elif (fast >= o["warn_burn"]
                    and slow >= o["warn_burn"] * SLOW_FACTOR):
                status = "warn"
            else:
                status = "ok"
            advice = o["advice"] if status == "page" else None
            v = {"objective": o["name"], "kind": o["kind"],
                 "status": status,
                 "fast_burn": round(fast, 4) if fast is not None
                 else None,
                 "slow_burn": round(slow, 4) if slow is not None
                 else None,
                 "value": self._value(o, ts, fast),
                 "advice": advice,
                 "windows_s": [o["fast_window_s"], o["slow_window_s"]]}
            if status == "page" and o["kind"] == "latency":
                # journey attribution: name the segment
                # dominating the slowest completed journeys, so the
                # page reads "latency, dominated by handoff_transfer"
                # instead of just "latency"
                dom = self._dominant_segment()
                if dom is not None:
                    v["dominant_segment"] = dom
            verdicts.append(v)
            worst = max(worst, SEVERITY[status])
            if fast is not None:
                worst_burn = max(worst_burn, fast)
            self._transition(o, prev, status, v)
            self._maybe_scale_down(o, status, ts)
        with self._lock:
            self._verdicts = {v["objective"]: v for v in verdicts}
        tm.SLO_STATUS.set(worst)
        tm.SLO_WORST_BURN.set(round(worst_burn, 4))
        return verdicts

    def _transition(self, o: Dict[str, Any], prev: str, status: str,
                    verdict: Dict[str, Any]) -> None:
        if status == prev:
            return
        self._status[o["name"]] = status
        if status == "page":
            tm.SLO_PAGES.inc()
        elif status == "warn" and SEVERITY[prev] < SEVERITY["warn"]:
            tm.SLO_WARNS.inc()
        # "objective_kind", not "kind": the flight recorder reserves
        # "kind" for the event type itself
        dom = verdict.get("dominant_segment")
        self._record("slo.verdict", objective=o["name"],
                     objective_kind=o["kind"], prev=prev, status=status,
                     fast_burn=verdict["fast_burn"],
                     slow_burn=verdict["slow_burn"],
                     value=verdict["value"],
                     advice=verdict["advice"],
                     **({"dominant_segment": dom["seg"],
                         "dominant_share": dom["share"]}
                        if dom else {}))
        if status == "page":
            attribution = (f"; dominated by {dom['seg']} "
                           f"({dom['share']:.0%} of slow-decile "
                           "journey time)" if dom else "")
            self._record("slo.advice", action=o["advice"],
                         objective=o["name"],
                         reason=f"burn {verdict['fast_burn']} over "
                                f"{o['fast_window_s']}s window "
                                f"(page at {o['page_burn']})"
                                + attribution)
        if SEVERITY[status] >= SEVERITY["warn"]:
            self._logger().warning(
                "slo: objective %r %s -> %s (fast burn %s, slow burn "
                "%s%s)", o["name"], prev, status,
                verdict["fast_burn"], verdict["slow_burn"],
                f"; advice: {verdict['advice']}"
                if verdict["advice"] else "")

    def _maybe_scale_down(self, o: Dict[str, Any], status: str,
                          ts) -> None:
        """Scale-DOWN advice: a throughput objective comfortably ok AND
        below its configured low-water rate over the SLOW window (a
        fleet running far under capacity).  Advice is edge-triggered —
        one record per entry into the idle regime."""
        low = o.get("scale_down_below_per_s")
        if o["kind"] != "throughput_min" or not low:
            return
        rate = ts.counter_rate(o["counter"], o["slow_window_s"])
        idle = (status == "ok" and rate is not None
                and float(o["min_per_s"]) <= rate < float(low))
        was = self._scale_down_advised.get(o["name"], False)
        self._scale_down_advised[o["name"]] = idle
        if idle and not was:
            self._record("slo.advice", action="scale_down",
                         objective=o["name"],
                         reason=f"rate {round(rate, 3)}/s under "
                                f"low-water {low}/s with burn 0")

    # -- read side -----------------------------------------------------------
    def current(self) -> Dict[str, Any]:
        """Last verdicts (the ``/healthz`` ``slo`` block)."""
        with self._lock:
            verdicts = dict(self._verdicts)
            statuses = dict(self._status)
        worst = max([SEVERITY[s] for s in statuses.values()],
                    default=0)
        return {
            "configured": bool(self._objectives),
            "status": {0: "ok", 1: "warn", 2: "page"}[worst],
            "objectives": verdicts,
        }

    @staticmethod
    def _dominant_segment() -> Optional[Dict[str, Any]]:
        """Which journey segment dominates the slowest completed
        decile; None when no journeys have flushed."""
        from .journey import get_journey_log
        return get_journey_log().dominant_segment()

    @staticmethod
    def _record(event: str, **fields) -> None:
        from .flight_recorder import get_flight_recorder
        get_flight_recorder().record(event, **fields)

    @staticmethod
    def _logger():
        from ..utils.logging import logger
        return logger


#: process-wide singleton
_EVALUATOR = SLOEvaluator()


def get_slo_evaluator() -> SLOEvaluator:
    return _EVALUATOR
