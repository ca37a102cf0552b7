"""Flight recorder: crash forensics for a process that may be gone by
the time anyone looks.

Counterpart of ``deepspeed_tpu/telemetry/flight_recorder.py``, with the
same event kinds and bundle layout.  A bounded structured event ring
(engine lifecycle, admissions, preemptions, handoffs, pool membership)
plus :func:`dump_postmortem`, which writes the bundle:

- ``registry.json``  the metrics registry's flat snapshot
- ``trace.json``     the span ring as Chrome-trace JSON
- ``config.json``    the engine config(s) captured at build
- ``events.json``    the last-K structured events
- ``env.json``       process/env capture and the health verdict

plus ``workload.jsonl`` (the tail of the workload trace) while the trace
is on, ``journeys.json`` once any request journey was recorded,
``timeseries.json`` (the sampled ring: the minutes before the crash)
while the time series runs and holds samples, and ``memory.json`` (the
memory ledger's breakdown naming the dominant subsystem) once an engine
build armed the ledger.

Invoked when an unhandled exception escapes the FastGen step loop (once
per process, into the configured postmortem dir), on demand, and with
``DS_POSTMORTEM_ON_EXIT=1`` from an idempotent atexit and SIGTERM
handler.  ``record()``'s disabled path is one attribute read; the dump
paths are best-effort and never raise into the crashing frame.
"""

from __future__ import annotations

import atexit
import collections
import dataclasses
import json
import os
import signal
import sys
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

from .state import state

DEFAULT_EVENT_CAPACITY = 1024

#: every flight-event kind the JAX package records (the namespace is
#: closed; the port records the serving subset).  Postmortem consumers
#: grep events by kind, so the two packages share the one list.
EVENT_KINDS = frozenset({
    "chaos.fire",
    "checkpoint.load", "checkpoint.save",
    "crash", "sigterm",
    "disagg.build", "disagg.handoff", "disagg.handoff_ready",
    "engine.build", "engine.destroy",
    "fastgen.reopen", "fastgen.restore", "fastgen.snapshot",
    "journey.flush", "journey.fragment",
    "kv.alloc_fail", "kv.demote", "kv.evict", "kv.promote",
    "mem.breakdown", "mem.pressure",
    "pool.advice_applied", "pool.build", "pool.page_fetch",
    "pool.rebalance",
    "pool.replica_add", "pool.replica_death", "pool.scale_down",
    "pool.warm_spawn",
    "request.admit", "request.done", "request.error",
    "request.preempt", "request.restore",
    "selfheal.retry", "selfheal.rollback",
    "slo.advice", "slo.verdict",
    "spec.draft_fill", "spec.drafter_switch",
    "watchdog.anomaly", "watchdog.compile_on_path",
    "watchdog.nonfinite", "watchdog.overflow_skip",
})


def _jsonable(obj: Any, depth: int = 0) -> Any:
    """Best-effort JSON projection of an arbitrary config object
    (pydantic models, dataclasses, dtypes) — forensics must serialize
    whatever it is handed, so unknown leaves degrade to ``str``."""
    if depth > 6:
        return str(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v, depth + 1) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name), depth + 1)
                for f in dataclasses.fields(obj)}
    dump = getattr(obj, "model_dump", None)
    if callable(dump):            # pydantic v2 config models
        try:
            return _jsonable(dump(), depth + 1)
        except Exception:
            pass
    return str(obj)


class FlightRecorder:
    """Bounded structured event ring + postmortem bundle writer."""

    def __init__(self, capacity: int = DEFAULT_EVENT_CAPACITY):
        # RLock: the SIGTERM handler dumps on the main thread and may
        # interrupt a frame that holds this lock (record/set_config);
        # a plain Lock would deadlock the dying process
        self._lock = threading.RLock()
        self._events: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))
        self._configs: Dict[str, Any] = {}
        self._crash_dumped = False
        self._exit_dumped = False
        self.postmortem_dir = os.environ.get("DS_POSTMORTEM_DIR", "")

    # -- event ring ----------------------------------------------------------
    def record(self, event: str, **fields) -> None:
        """Append one structured event (``fields`` must not shadow the
        reserved ``ts``/``kind``/``step`` keys).  Disabled path: one
        attribute read, no allocation."""
        if not state.enabled:
            return
        from .tracer import current_component, get_tracer
        evt = {"ts": time.time(), "kind": event,
               "step": get_tracer().step}
        comp = current_component()
        if comp:
            # pool stepper threads interleave in one process ring:
            # label which replica/component spoke
            evt["component"] = comp
        evt.update(fields)
        with self._lock:
            self._events.append(evt)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._events = collections.deque(
                self._events, maxlen=max(int(capacity), 1))

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- config capture ------------------------------------------------------
    def set_config(self, label: str, config: Any) -> None:
        """Capture an engine config at build time (always on — a config
        is captured once per engine, and a crash with telemetry off
        should still identify what was running)."""
        with self._lock:
            self._configs[label] = _jsonable(config)

    # -- the bundle ----------------------------------------------------------
    def dump_postmortem(self, dir_path: str) -> Dict[str, str]:
        """Write the bundle into ``dir_path`` (created if needed).
        Returns {artifact name: path}.  Raises only on an unwritable
        directory; the automatic crash/exit paths guard it."""
        os.makedirs(dir_path, exist_ok=True)
        from .registry import get_registry
        from .tracer import get_tracer
        from .watchdog import get_watchdog

        paths: Dict[str, str] = {}

        def write(name: str, doc: Any) -> None:
            path = os.path.join(dir_path, name)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            paths[name] = path

        write("registry.json", get_registry().snapshot())
        paths["trace.json"] = get_tracer().dump(
            os.path.join(dir_path, "trace.json"))
        with self._lock:
            configs = dict(self._configs)
            events = list(self._events)
        write("config.json", configs)
        write("events.json", {"events": events})
        write("env.json", {
            "pid": os.getpid(),
            "argv": sys.argv,
            "cwd": os.getcwd(),
            "python": sys.version,
            "torch": _torch_version(),
            "platform": sys.platform,
            "time_unix": time.time(),
            "uptime_s": _uptime_s(),
            # the device is deliberately not touched here: a postmortem
            # of a wedged card must not hang on device discovery
            "env": {k: v for k, v in sorted(os.environ.items())
                    if k.startswith(("DS_", "CUDA_", "TORCH_"))},
            "health": get_watchdog().health(),
        })
        # the workload-trace tail, only while the trace is on
        from .workload_trace import get_workload_trace
        tail = get_workload_trace().tail_text()
        if tail is not None:
            path = os.path.join(dir_path, "workload.jsonl")
            with open(path, "w") as f:
                f.write(tail)
            paths["workload.jsonl"] = path
        # the journey log's tail, skipped when nothing was recorded
        from .journey import get_journey_log
        jdoc = get_journey_log().tail_json()
        if jdoc is not None:
            write("journeys.json", jdoc)
        # the time-series ring, while the sampler runs and holds samples
        from .timeseries import get_timeseries
        tsr = get_timeseries()
        if tsr.active:
            doc = tsr.to_json()
            if doc["samples"]:
                write("timeseries.json", doc)
        # the memory ledger's breakdown, once an engine build armed it
        from .memory import get_memory_ledger
        mdoc = get_memory_ledger().to_json()
        if mdoc is not None:
            write("memory.json", mdoc)
        return paths

    # -- automatic invocation paths ------------------------------------------
    def on_crash(self, where: str, exc: BaseException) -> None:
        """Called when an unhandled exception escapes the FastGen step
        loop.  Records the crash
        event; writes the bundle once per process when telemetry is on
        and a postmortem dir is configured.  NEVER raises — the
        original exception must propagate unchanged."""
        try:
            self.record("crash", where=where,
                        exc_type=type(exc).__name__,
                        exc=str(exc)[:500])
            out_dir = self.postmortem_dir
            if not (state.enabled and out_dir) or self._crash_dumped:
                return
            self._crash_dumped = True
            paths = self.dump_postmortem(out_dir)
            self._log_warning(
                "flight recorder: unhandled %s escaping %s — postmortem "
                "bundle written to %s", type(exc).__name__, where,
                os.path.abspath(out_dir), paths)
        except Exception:
            pass

    def dump_on_exit(self, signum: Optional[int] = None) -> None:
        """atexit / SIGTERM body (``DS_POSTMORTEM_ON_EXIT=1``):
        idempotent, never raises."""
        if self._exit_dumped:
            return
        self._exit_dumped = True
        try:
            out_dir = self.postmortem_dir or "postmortem"
            if signum is not None:
                self.record("sigterm", signum=signum)
            self.dump_postmortem(out_dir)
            self._log_warning(
                "flight recorder: exit postmortem bundle written to %s "
                "(signal=%s)", os.path.abspath(out_dir), signum)
        except Exception:
            pass

    @staticmethod
    def _log_warning(fmt, *args) -> None:
        try:
            warnings.warn(fmt % args)
        except Exception:
            pass


#: process start as this module saw it (the uptime's origin)
_T0 = time.monotonic()


def _torch_version() -> str:
    try:
        import torch
        return torch.__version__
    except Exception:
        return "unavailable"


def _uptime_s() -> float:
    return round(time.monotonic() - _T0, 3)


#: process-wide singleton
_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def dump_postmortem(dir_path: str) -> Dict[str, str]:
    """Write the postmortem bundle on demand."""
    return _RECORDER.dump_postmortem(dir_path)


_handlers_installed = False


def maybe_install_exit_handlers() -> bool:
    """Honor ``DS_POSTMORTEM_ON_EXIT=1``: register an atexit hook and a
    chaining SIGTERM handler that write the bundle before the process
    goes away (a preempted job gets SIGTERM).  Idempotent; signal
    installation degrades silently off the main thread."""
    global _handlers_installed
    if _handlers_installed:
        return True
    if os.environ.get("DS_POSTMORTEM_ON_EXIT", "") in ("", "0"):
        return False
    _handlers_installed = True
    atexit.register(_RECORDER.dump_on_exit)
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            _RECORDER.dump_on_exit(signum)
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:
                # restore default disposition and re-deliver so the
                # process still dies with the conventional exit status
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass    # not the main thread / restricted env: atexit remains
    return True
