"""Time-series sampler: history for a registry that only knows "now".

Counterpart of ``deepspeed_tpu/telemetry/timeseries.py`` (plain Python,
the same ring, windows and arithmetic).

Every metric in the registry is a current-value reading — a counter is
a lifetime total, a gauge is this instant, a histogram is cumulative
since process start.  None of that answers the questions a fleet
controller asks: *what is the token rate over the last 60 seconds*,
*what was p99 TTFT in the last window* (not diluted by six hours of
history), *is the shed rate rising*.  This module answers them with a
bounded ring of periodic :meth:`MetricsRegistry.raw_snapshot` samples:

- **windowed counter rates** — ``counter_rate("ds_fastgen_tokens_total",
  60)`` is (newest − window-base) / elapsed, the tok/s / shed/s series
  the SLO burn-rate evaluator (:mod:`.slo`) consumes;
- **gauge histories** — ``gauge_series(name, window)`` returns the
  sampled trajectory, fixing the wall-relative-gauge wart
  (``ds_fastgen_mfu`` dilutes over process lifetime; its recent
  samples do not);
- **delta-windowed histogram percentiles** — bucket counts subtract
  exactly (fixed boundaries, integer counts), so
  ``hist_window(name, window).percentile(99)`` is the p99 *of the
  window's observations alone*, via the same
  :func:`~.registry.percentile_from_counts` arithmetic as the live
  histogram.

Sampling is driven two ways, both cheap: a background daemon thread
(:meth:`start_thread`, started by ``apply_settings`` when an interval
is configured) and an opportunistic :meth:`maybe_sample` tick on the
serving scheduler's step path whose disabled path is one attribute
read (``self.active``, the tracer and watchdog cost contract).

Configured via ``telemetry.timeseries_interval_s`` /
``timeseries_retention_s`` on the engine config (``apply_settings``) or ``DS_TIMESERIES="<interval>[:<retention>]"``
at import.  Ring memory is bounded by retention/interval (hard-capped
at :data:`MAX_SAMPLES`); disabled (the default) it holds nothing.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .registry import get_registry, percentile_from_counts

#: hard cap on ring capacity regardless of retention/interval — a
#: misconfigured pair (retention 1h, interval 10ms) must not grow an
#: unbounded ring; the oldest retention silently shortens instead
MAX_SAMPLES = 8192
DEFAULT_RETENTION_S = 600.0


class WindowHist:
    """A histogram DELTA between two ring samples: the observations of
    one window, percentile-queryable with the live histogram's exact
    arithmetic."""
    __slots__ = ("bounds", "counts", "count", "sum")

    def __init__(self, bounds: List[float], counts: List[int],
                 count: int, total: float):
        self.bounds = bounds
        self.counts = counts
        self.count = count
        self.sum = total

    def percentile(self, q: float) -> float:
        return percentile_from_counts(self.bounds, self.counts,
                                      self.count, q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def frac_above(self, threshold: float) -> float:
        """Fraction of the window's observations strictly above the
        first bucket boundary >= ``threshold`` (the threshold snaps UP
        to a boundary — log-bucketed histograms cannot split a bucket).
        0.0 on an empty window."""
        if self.count == 0:
            return 0.0
        import bisect
        k = bisect.bisect_left(self.bounds, threshold)
        good = sum(self.counts[:k + 1])
        return max(0, self.count - good) / self.count


class TimeSeries:
    """Bounded ring of periodic registry snapshots with windowed
    queries."""

    def __init__(self, source: Optional[Callable[[], Dict]] = None):
        #: hot-path gate — one attribute read is the whole disabled cost
        self.active = False
        self._source = source or (lambda: get_registry().raw_snapshot())
        self._interval_s = 0.0
        self._retention_s = DEFAULT_RETENTION_S
        # RLock: the postmortem SIGTERM handler serializes the ring on
        # the main thread and may interrupt a frame holding this
        self._lock = threading.RLock()
        self._ring: List[Dict[str, Any]] = []
        self._cap = 2
        self._bounds: Dict[str, List[float]] = {}
        self._last_t = 0.0
        self._thread: Optional[threading.Thread] = None
        self._thread_stop = threading.Event()
        self._on_sample: List[Callable[["TimeSeries"], None]] = []

    # -- lifecycle -----------------------------------------------------------
    def configure(self, interval_s: float = 0.0,
                  retention_s: float = 0.0) -> None:
        """Config-block entry point (0 = keep current).  A positive
        interval activates sampling; ring capacity =
        retention/interval + 1, capped at :data:`MAX_SAMPLES`."""
        with self._lock:
            if interval_s:
                self._interval_s = float(interval_s)
            if retention_s:
                self._retention_s = float(retention_s)
            if self._interval_s > 0:
                self._cap = min(
                    MAX_SAMPLES,
                    int(self._retention_s / self._interval_s) + 1)
                self._cap = max(self._cap, 2)
                self.active = True
                del self._ring[:max(0, len(self._ring) - self._cap)]

    def disable(self) -> None:
        """Stop sampling and drop the ring (tests / reconfiguration)."""
        self.stop_thread()
        with self._lock:
            self.active = False
            self._interval_s = 0.0
            self._retention_s = DEFAULT_RETENTION_S
            self._ring = []
            self._bounds = {}
            self._last_t = 0.0
            self._on_sample = []

    def add_on_sample(self, fn: Callable[["TimeSeries"], None]) -> None:
        """Register a per-sample hook (the SLO evaluator attaches here
        so verdicts track the series, not their own clock)."""
        with self._lock:
            if fn not in self._on_sample:
                self._on_sample.append(fn)

    # -- sampling ------------------------------------------------------------
    def maybe_sample(self) -> bool:
        """Opportunistic tick (the scheduler-step hook): samples when
        at least ``interval_s`` has passed since the last sample.
        Disabled path: one attribute read."""
        if not self.active:
            return False
        now = time.monotonic()
        if now - self._last_t < self._interval_s:
            return False
        self.sample_now(t=now)
        return True

    def sample_now(self, t: Optional[float] = None) -> Dict[str, Any]:
        """Take one sample immediately.  ``t`` overrides the monotonic
        stamp (test seam: windowed-rate assertions against hand-built
        series need exact timestamps)."""
        raw = self._source()
        sample = {
            "t": time.monotonic() if t is None else float(t),
            "unix": time.time(),
            "counters": dict(raw.get("counters", {})),
            "gauges": dict(raw.get("gauges", {})),
            "hists": {},
        }
        hists = sample["hists"]
        with self._lock:
            for name, h in raw.get("hists", {}).items():
                # bounds are FIXED per metric — stored once in a side
                # table, not per sample (ring memory is counts only)
                if name not in self._bounds and h.get("bounds"):
                    self._bounds[name] = list(h["bounds"])
                hists[name] = (list(h["counts"]), int(h["count"]),
                               float(h["sum"]))
            self._ring.append(sample)
            if len(self._ring) > self._cap:
                del self._ring[:len(self._ring) - self._cap]
            self._last_t = sample["t"]
            hooks = list(self._on_sample)
        for fn in hooks:
            try:
                fn(self)
            except Exception:
                # an evaluator bug must not take down the sampler
                pass
        return sample

    def start_thread(self) -> None:
        """Background sampler (daemon): for processes that are not
        stepping a scheduler (routers, idle replicas).  Idempotent."""
        with self._lock:
            if not self.active or (
                    self._thread is not None and self._thread.is_alive()):
                return
            self._thread_stop.clear()
            t = threading.Thread(target=self._run, name="ds-timeseries",
                                 daemon=True)
            self._thread = t
        t.start()

    def stop_thread(self) -> None:
        self._thread_stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        while not self._thread_stop.wait(self._interval_s or 1.0):
            if not self.active:
                return
            try:
                # skip if a scheduler tick sampled more recently than
                # half an interval ago (two samplers, one cadence)
                if time.monotonic() - self._last_t >= self._interval_s / 2:
                    self.sample_now()
            except Exception:
                pass

    # -- window selection ----------------------------------------------------
    def samples(self, window_s: Optional[float] = None
                ) -> List[Dict[str, Any]]:
        with self._lock:
            ring = list(self._ring)
        if window_s is None or not ring:
            return ring
        cut = ring[-1]["t"] - float(window_s)
        return [s for s in ring if s["t"] >= cut]

    def _window_pair(self, window_s: float
                     ) -> Optional[Tuple[Dict, Dict]]:
        """(base, newest) samples spanning ~``window_s``.  The base is
        the earliest sample inside the window; when only the newest
        sample is inside (interval > window), the nearest OLDER sample
        is used instead so small windows degrade to the last delta
        rather than to nothing — the covered span is reported, not
        assumed."""
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return None
        newest = ring[-1]
        cut = newest["t"] - float(window_s)
        inside = [s for s in ring if s["t"] >= cut]
        base = inside[0] if len(inside) >= 2 else ring[-2]
        return base, newest

    # -- queries -------------------------------------------------------------
    @staticmethod
    def _delta_from_pair(pair, name: str) -> Optional[float]:
        """Counter increase between two samples.  A counter reset
        inside the window (measured-window ``reset()``) makes
        new < old; the post-reset cumulative IS the window's increase
        then."""
        base, newest = pair
        new = newest["counters"].get(name)
        if new is None:
            return None
        d = new - base["counters"].get(name, 0)
        return new if d < 0 else d

    def counter_delta(self, name: str, window_s: float
                      ) -> Optional[float]:
        """Counter increase over the window."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        return self._delta_from_pair(pair, name)

    def counter_rate(self, name: str, window_s: float
                     ) -> Optional[float]:
        """Counter increase per second over the window.  Delta and
        elapsed come from ONE window pair — a concurrent sample landing
        between two ring reads (two samplers: thread + scheduler tick)
        must not mismatch numerator and denominator."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        delta = self._delta_from_pair(pair, name)
        elapsed = pair[1]["t"] - pair[0]["t"]
        if delta is None or elapsed <= 0:
            return None
        return delta / elapsed

    def gauge_series(self, name: str, window_s: Optional[float] = None
                     ) -> List[Tuple[float, float]]:
        """Sampled (t, value) trajectory of a gauge over the window."""
        return [(s["t"], s["gauges"][name])
                for s in self.samples(window_s)
                if name in s["gauges"]]

    def _hist_delta_from_pair(self, pair, name: str
                              ) -> Optional[WindowHist]:
        """The ONE histogram-delta implementation behind
        :meth:`hist_window` and :meth:`window_snapshot` (the reset
        heuristic must not diverge between them).  A histogram that
        appeared or was reset inside the window contributes its newest
        cumulative as the window's content."""
        base, newest = pair
        hn = newest["hists"].get(name)
        if hn is None:
            return None
        counts_n, count_n, sum_n = hn
        bounds = self._bounds.get(name, [])
        hb = base["hists"].get(name)
        if hb is None or count_n < hb[1] or len(hb[0]) != len(counts_n):
            return WindowHist(bounds, list(counts_n), count_n, sum_n)
        counts_b, count_b, sum_b = hb
        return WindowHist(bounds,
                          [a - b for a, b in zip(counts_n, counts_b)],
                          count_n - count_b, sum_n - sum_b)

    def hist_window(self, name: str, window_s: float
                    ) -> Optional[WindowHist]:
        """The histogram's observations WITHIN the window, as an exact
        bucket-count delta (fixed boundaries — integer subtraction)."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        return self._hist_delta_from_pair(pair, name)

    def window_snapshot(self, window_s: float) -> Dict[str, Any]:
        """Flat dict mirroring the registry's lifetime ``snapshot()``
        but delta-windowed (the ``/snapshot?window=<s>`` body): counters
        -> window increase plus ``<name>_per_s`` rate, gauges -> newest
        sampled value, histograms -> ``_p50/_p90/_p99/_count/_mean`` of
        the window's observations alone.  ``_window_covered_s`` reports
        the span actually subtended (never trust the request)."""
        pair = self._window_pair(window_s)
        out: Dict[str, Any] = {
            "_window_requested_s": float(window_s),
            "_window_covered_s": 0.0,
            "_samples": len(self.samples(window_s)),
        }
        if pair is None:
            return out
        base, newest = pair
        elapsed = newest["t"] - base["t"]
        out["_window_covered_s"] = round(elapsed, 6)
        for name in sorted(newest["counters"]):
            delta = self._delta_from_pair(pair, name)
            out[name] = delta
            out[f"{name}_per_s"] = (round(delta / elapsed, 6)
                                    if elapsed > 0 else 0.0)
        for name, v in sorted(newest["gauges"].items()):
            out[name] = v
        for name in sorted(newest["hists"]):
            w = self._hist_delta_from_pair(pair, name)
            out[f"{name}_p50"] = w.percentile(50)
            out[f"{name}_p90"] = w.percentile(90)
            out[f"{name}_p99"] = w.percentile(99)
            out[f"{name}_count"] = w.count
            out[f"{name}_mean"] = w.mean
        return out

    # -- export (postmortem artifact) ----------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """The ring as a JSON document (the ``timeseries.json``
        postmortem artifact): configuration, per-histogram bounds
        (stored once), and every retained sample — the minutes BEFORE
        a crash, not just the instant of it."""
        with self._lock:
            return {
                "interval_s": self._interval_s,
                "retention_s": self._retention_s,
                "capacity": self._cap,
                "bounds": {k: list(v) for k, v in self._bounds.items()},
                "samples": [
                    {"t": s["t"], "unix": s["unix"],
                     "counters": dict(s["counters"]),
                     "gauges": dict(s["gauges"]),
                     "hists": {n: {"counts": list(c), "count": k,
                                   "sum": v}
                               for n, (c, k, v) in s["hists"].items()}}
                    for s in self._ring],
            }


#: process-wide singleton (samples the process registry)
_TIMESERIES = TimeSeries()


def get_timeseries() -> TimeSeries:
    return _TIMESERIES


def maybe_configure_from_env() -> bool:
    """Honor ``DS_TIMESERIES="<interval_s>[:<retention_s>]"`` as soon
    as telemetry is imported (the DS_METRICS_PORT convention: malformed
    values degrade to a warning, never an import error)."""
    raw = os.environ.get("DS_TIMESERIES", "")
    if not raw:
        return False
    try:
        parts = raw.split(":", 1)
        interval = float(parts[0])
        retention = float(parts[1]) if len(parts) > 1 else 0.0
    except ValueError:
        from ..utils.logging import logger
        logger.warning(
            "DS_TIMESERIES=%r is not <interval>[:<retention>] — "
            "time-series sampling not started", raw)
        return False
    if interval <= 0:
        return False
    _TIMESERIES.configure(interval_s=interval, retention_s=retention)
    _TIMESERIES.start_thread()
    return True
