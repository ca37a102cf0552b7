"""Unified metrics registry: counters, gauges, log-bucketed histograms.

Counterpart of ``deepspeed_tpu/telemetry/registry.py`` (plain Python, the
same arithmetic).  One process-wide named namespace (``ds_<area>_<name>``)
that the serving counters, the KV-pool page states and the serving SLO
histograms write into, read through a flat ``snapshot()``, a structured
``raw_snapshot()`` and the Prometheus text exposition.

Histograms are log-bucketed with FIXED boundaries and retain no samples:
``observe`` is a bisect + two adds, and percentiles are interpolated
from the cumulative bucket counts (bounded relative error = one bucket
ratio, ~19% worst case at the default 2**0.25 spacing, typically far
less with in-bucket interpolation).
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

Number = Union[int, float]


def log_buckets(lo: float, hi: float, ratio: float = 2 ** 0.25
                ) -> List[float]:
    """Geometric bucket boundaries covering [lo, hi]."""
    bounds = []
    b = lo
    while b < hi * ratio:
        bounds.append(b)
        b *= ratio
    return bounds


#: default boundaries for millisecond-valued latencies: 10µs .. 10min
DEFAULT_MS_BUCKETS = log_buckets(1e-2, 6e5)


def percentile_from_counts(bounds: Sequence[float],
                           counts: Sequence[int], count: int,
                           q: float) -> float:
    """Approximate q-th percentile (q in [0, 100]) by linear
    interpolation inside the bucket where the cumulative count crosses
    rank q/100 * count.  The ONE percentile implementation shared by
    live histograms, the time-series ring's delta-windowed views, and
    the fleet federation's merged histograms — merged-then-percentile
    is bit-equal to observe-all-then-percentile exactly because all
    three run this same arithmetic over summed integer counts."""
    if count == 0:
        return 0.0
    target = (q / 100.0) * count
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = (bounds[i] if i < len(bounds) else bounds[-1])
            frac = (target - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return bounds[-1]


class Counter:
    """Monotonic counter (resettable for measured windows)."""
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value; either set imperatively or bound to a
    callback evaluated at read time (KV-pool page states bind the live
    allocator so the hot path never writes a gauge)."""
    __slots__ = ("name", "help", "_value", "_set", "fn")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._set = False
        self.fn: Optional[Callable[[], Number]] = None

    def set(self, value: Number) -> None:
        self._value = value
        self._set = True

    def bind(self, fn: Callable[[], Number]) -> None:
        self.fn = fn

    @property
    def value(self) -> Number:
        if self.fn is not None:
            try:
                return self.fn()
            except Exception:
                return 0
        return self._value

    @property
    def touched(self) -> bool:
        """True once the gauge has a meaning: bound to a callback or
        ever ``set()`` — distinguishes "never recorded" from a value
        that legitimately dropped to 0 (readers that skip untouched
        gauges must keep emitting a series after it hits zero)."""
        return self.fn is not None or self._set

    def reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Log-bucketed histogram: fixed boundaries, cumulative-count
    percentiles, no sample retention."""
    __slots__ = ("name", "help", "bounds", "counts", "count", "sum")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help
        self.bounds = list(buckets if buckets is not None
                           else DEFAULT_MS_BUCKETS)
        # counts[i] = observations with v <= bounds[i]; counts[-1] = overflow
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: Number) -> None:
        # total before bucket: a concurrent /metrics scrape reads the
        # buckets first and ``count`` (the le="+Inf" line) last, so this
        # order keeps the exposition monotone (cum <= count) without a
        # hot-path lock
        self.count += 1
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]); see
        :func:`percentile_from_counts`."""
        return percentile_from_counts(self.bounds, self.counts,
                                      self.count, q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0


class MetricsRegistry:
    """Named metric namespace with a flat ``snapshot()`` dict and a
    Prometheus text exposition."""

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}
        # RLock: the postmortem SIGTERM handler snapshots the registry
        # on the main thread and may interrupt a _get() holding this
        self._lock = threading.RLock()

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def gauge_fn(self, name: str, fn: Callable[[], Number],
                 help: str = "") -> Gauge:
        """Register/rebind a callback gauge.  Re-binding replaces the
        previous callback (multiple engines in one process: the newest
        owns the gauge)."""
        g = self.gauge(name, help=help)
        g.bind(fn)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, help=help, buckets=buckets)

    def all_metrics(self) -> Dict[str, Union[Counter, Gauge, Histogram]]:
        # copied under the lock: the HTTP scrape thread iterates this
        # while another thread may be registering a late metric
        with self._lock:
            return dict(self._metrics)

    def reset(self) -> None:
        """Zero counters and histograms (measured-window control);
        callback gauges keep their binding."""
        for m in self.all_metrics().values():
            m.reset()

    # -- exports -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Number]:
        """Flat name -> value dict.  Histograms flatten to
        ``<name>_p50/_p90/_p99/_count/_mean``."""
        out: Dict[str, Number] = {}
        for name, m in sorted(self.all_metrics().items()):
            if isinstance(m, Histogram):
                out[f"{name}_p50"] = m.percentile(50)
                out[f"{name}_p90"] = m.percentile(90)
                out[f"{name}_p99"] = m.percentile(99)
                out[f"{name}_count"] = m.count
                out[f"{name}_mean"] = m.mean
            else:
                out[name] = m.value
        return out

    def raw_snapshot(self) -> Dict[str, Dict]:
        """Structured snapshot preserving histogram BUCKET COUNTS (the
        flat :meth:`snapshot` collapses them to percentiles, which
        cannot be merged across replicas).  This is the substrate the
        time-series sampler rings and the fleet federation merges:
        counters/gauges by value, histograms as
        ``{"bounds", "counts", "count", "sum"}``.  Gauges appear only
        once touched (bound or ever set) — an untouched gauge would
        pollute a fleet min/max rollup with a meaningless 0."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {},
                                "hists": {}}
        for name, m in self.all_metrics().items():
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                if m.touched:
                    out["gauges"][name] = m.value
            else:
                out["hists"][name] = {
                    "bounds": list(m.bounds),
                    "counts": list(m.counts),
                    "count": m.count,
                    "sum": m.sum,
                }
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (served at /metrics)."""
        lines: List[str] = []
        for name, m in sorted(self.all_metrics().items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value}")
            else:
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(m.bounds, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.sum}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"


#: process-wide singleton
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
