"""Span tracer: bounded ring buffer of (name, start, dur, step, attrs)
records, exportable as Chrome-trace JSON (Perfetto/chrome://tracing).

Counterpart of ``deepspeed_tpu/telemetry/tracer.py``.
``trace_span("fastgen.dispatch")`` is the only public entry point on hot
paths.  Disabled (the default): one attribute read and a shared no-op
context manager, no allocation, no clock read.  Enabled: a
``torch.profiler.record_function`` is entered under the same name (the
JAX package enters ``jax.profiler.TraceAnnotation``), so host spans line
up with the card's kernels in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .state import state

#: record = (name, start_s, dur_s, step, thread_id, attrs-or-None)
Record = Tuple[str, float, float, int, int, Optional[Dict[str, Any]]]

#: thread-local replica/component label: pool stepper threads interleave
#: in the one process-wide span ring, and a component label on each
#: record (and on flight events, and on journey segments' ``at``) tells
#: the replicas apart
_COMPONENT = threading.local()


def set_component(label: str) -> None:
    """Label every span/flight-event/journey-segment this thread
    records from now on (e.g. ``r0``, ``prefill``, ``decode``)."""
    _COMPONENT.value = str(label)


def current_component() -> str:
    return getattr(_COMPONENT, "value", "")

def _default_capacity() -> int:
    """``DS_TRACE_BUFFER`` is a tuning knob, not a correctness switch: a
    malformed value (``64k``) warns and keeps the default instead of
    failing every import of the package."""
    raw = os.environ.get("DS_TRACE_BUFFER", "")
    if raw:
        try:
            return int(raw)
        except ValueError:
            import warnings
            warnings.warn(
                f"DS_TRACE_BUFFER={raw!r} is not an integer — using the "
                "default trace-buffer capacity 65536")
    return 65536


DEFAULT_CAPACITY = _default_capacity()


class SpanTracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._cap = max(int(capacity), 1)
        self._buf: List[Optional[Record]] = [None] * self._cap
        self._n = 0          # total records ever written
        self.step = 0        # current step label (set_step)
        # RLock: a postmortem dump on the main thread may interrupt a
        # record() holding this lock
        self._lock = threading.RLock()

    def set_step(self, step: int) -> None:
        self.step = step

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._cap = max(int(capacity), 1)
            self._buf = [None] * self._cap
            self._n = 0

    def record(self, name: str, start: float, dur: float,
               attrs: Optional[Dict[str, Any]] = None) -> None:
        comp = getattr(_COMPONENT, "value", "")
        if comp:
            # merged, not mutated: the caller's attrs dict may be shared
            attrs = {"component": comp, **(attrs or {})}
        rec = (name, start, dur, self.step,
               threading.get_ident(), attrs)
        with self._lock:
            self._buf[self._n % self._cap] = rec
            self._n += 1

    def records(self) -> List[Record]:
        """Retained records, oldest first.  The critical section is
        O(1) — only the buffer reference and write count are read under
        the lock, so a slow /trace scrape or dump never stalls a
        ``record()`` on the serving hot path.  Slots written while the
        copy runs may surface a newer record in an "old" position
        (records are immutable tuples, slot stores are atomic); callers
        sort by start time, so the benign race costs nothing."""
        with self._lock:
            buf, n, cap = self._buf, self._n, self._cap
        if n <= cap:
            return [r for r in buf[:n] if r is not None]
        i = n % cap
        return [r for r in buf[i:] + buf[:i] if r is not None]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self._cap
            self._n = 0

    def chrome_events(self) -> List[Dict[str, Any]]:
        """Retained spans as Chrome-trace complete events, sorted by
        start time (the single source for :meth:`dump` and the HTTP
        ``/trace`` view — the record shape is defined once)."""
        events = [{
            "name": name,
            "ph": "X",
            "ts": start * 1e6,      # µs, perf_counter epoch
            "dur": dur * 1e6,
            "pid": os.getpid(),
            "tid": tid,
            "args": ({"step": step, **attrs} if attrs
                     else {"step": step}),
        } for name, start, dur, step, tid, attrs in self.records()]
        events.sort(key=lambda e: e["ts"])
        return events

    def dump(self, path: str) -> str:
        """Write retained spans as Chrome-trace JSON (the object form:
        ``{"traceEvents": [...]}``) loadable in Perfetto."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


#: process-wide singleton
_TRACER = SpanTracer()


def get_tracer() -> SpanTracer:
    return _TRACER


class _NullSpan:
    """Shared disabled-path context manager: no state, no allocation."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0", "_rf")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        self._rf = rf
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        self._rf.__exit__(exc_type, exc, tb)
        _TRACER.record(self.name, self.t0, dur, self.attrs)
        return False


def trace_span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Context manager recording a named host span when telemetry is
    enabled.  ``attrs`` (an optional plain dict — not kwargs, so the
    disabled call allocates nothing) lands in the Chrome-trace ``args``.
    """
    if not state.enabled:
        return _NULL_SPAN
    return _Span(name, attrs)


def dump_trace(path: str) -> str:
    """Export the process ring buffer as Chrome-trace JSON."""
    return _TRACER.dump(path)
