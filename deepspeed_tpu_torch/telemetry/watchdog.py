"""Health watchdog: the layer that acts on the telemetry core's signals
instead of only recording them.

Counterpart of ``deepspeed_tpu/telemetry/watchdog.py`` (plain Python, the
same detectors, thresholds and verdicts).  Four detectors, all fed from
values the engines already hold on the host (no device syncs):

- **non-finite sentinel**: a host-fetched loss / grad-norm / fp16
  overflow flag mints ``ds_train_nonfinite_total`` /
  ``ds_train_overflow_skip_total`` and a warn-once (the training engine
  feeds it after every step while telemetry is on: the loss and the
  gradient norm of an applied step, the skip of an fp16 overflow);
- **step-time anomaly detector**: an EWMA mean and EWMA absolute
  deviation over ``train`` / ``fastgen`` step wall times; a step slower
  than ``threshold x`` the running mean (after warm-up) increments
  ``ds_train_anomaly_total``, warns once per storm, and dumps the span
  ring (Chrome trace) around the offending step.  The scheduler feeds the
  host time around ``step()``: under the async chained decode that is
  the host's enqueue cost of a step, not the card's time for it, as in
  the JAX package (no sync is added to read it);
- **goodput accounting**: wall clock split into compile / input-wait /
  step / checkpoint / idle fractions through callback gauges
  (``ds_train_goodput_ratio`` = the step fraction);
- **serving step-cache accounting**: step-cache hits vs misses and the
  step programs built on the request path (a CUDA graph captured at a
  key's first use; ``ds_fastgen_step_cache_miss_total`` /
  ``ds_fastgen_compile_on_path_total``), with a storm warning naming the
  uncovered ``(S, Q, P, fresh, kind)`` keys.

Disabled-path contract: every per-step entry point reads
``state.enabled`` first and returns.  The step-cache counters are the
one exception: they count unconditionally, because a graph capture is
many orders of magnitude dearer than they are and a storm must show
with telemetry off.  Threshold, warm-up and enablement come from
:meth:`Watchdog.configure` (the ``telemetry`` config block);
``DS_POSTMORTEM_DIR`` names where anomaly traces go.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Dict, Optional

from .state import state
from . import metrics as tm

#: process start reference for /healthz uptime
_T0 = time.monotonic()


class _KindState:
    """Per-stream (``train`` / ``fastgen``) EWMA step-time state."""
    __slots__ = ("mean_ms", "dev_ms", "n", "in_storm", "calm",
                 "anomalies", "last_ms", "last_anomaly_ms")

    def __init__(self):
        self.mean_ms = 0.0
        self.dev_ms = 0.0
        self.n = 0
        self.in_storm = False
        self.calm = 0
        self.anomalies = 0
        self.last_ms = 0.0
        self.last_anomaly_ms = 0.0


class _DriftState:
    """Resident-bytes EWMA state for the memory-drift detector: the
    step-time machinery with bytes in place of ms."""
    __slots__ = ("mean_b", "n", "in_storm", "calm", "anomalies",
                 "last_b", "last_anomaly_b")

    def __init__(self):
        self.mean_b = 0.0
        self.n = 0
        self.in_storm = False
        self.calm = 0
        self.anomalies = 0
        self.last_b = 0.0
        self.last_anomaly_b = 0.0


#: goodput phases; ``idle`` is derived (wall − accounted), never noted
GOODPUT_PHASES = ("compile", "input_wait", "step", "checkpoint")


class _PhaseTimer:
    """Tiny context manager accumulating one goodput phase (the enabled
    path of :meth:`Watchdog.track`)."""
    __slots__ = ("wd", "phase", "t0")

    def __init__(self, wd: "Watchdog", phase: str):
        self.wd = wd
        self.phase = phase

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.wd.note_phase(self.phase, time.perf_counter() - self.t0)
        return False


class _NullTrack:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_TRACK = _NullTrack()


class Watchdog:
    """Process-wide health watchdog over the telemetry spine."""

    def __init__(self):
        self.enabled = True          # config gate ON TOP of state.enabled
        self.threshold = 3.0         # anomaly: ms > threshold * EWMA mean
        self.warmup = 8              # EWMA samples before verdicts fire
        self.alpha = 0.2             # EWMA smoothing factor
        self.min_delta_ms = 1.0      # absolute floor under the ratio rule
        self.calm_steps = 8          # normal steps that end a storm
        self.storm_compiles = 3      # on-path compiles within...
        self.storm_window_s = 60.0   # ...this window = a recompile storm
        # memory-drift detector: resident bytes fed from the
        # ledger's time-series hook; growth past threshold × EWMA (and
        # past the absolute floor) is a drift anomaly — a leaking codec
        # path shows here in production mode, not just under DS_KV_DEBUG
        self.mem_threshold = 1.5
        self.mem_min_delta_bytes = 32 << 20
        self._mem = _DriftState()
        self.postmortem_dir = os.environ.get("DS_POSTMORTEM_DIR", "")
        # RLock, not Lock: the DS_POSTMORTEM_ON_EXIT SIGTERM handler
        # runs dump_postmortem -> health() on the main thread, possibly
        # interrupting a frame that already holds this lock — a plain
        # Lock would deadlock the dying process instead of dumping
        self._lock = threading.RLock()
        self._kinds: Dict[str, _KindState] = {}
        self._nonfinite_warned: set = set()
        #: train steps the non-finite verdict stays raised after the
        #: last non-finite observation (recency: /healthz must recover
        #: once finite steps resume, not latch 503 for process life)
        self._nonfinite_recent = 0
        self._phase_s: Dict[str, float] = {}
        self._phase_t0: Optional[float] = None
        self._gauges_bound = False
        self._compile_times: collections.deque = collections.deque(
            maxlen=32)
        self._compile_keys: collections.deque = collections.deque(
            maxlen=8)
        self._in_compile_storm = False

    # -- non-finite sentinel (training engine, host-fetched values) ----------
    def note_nonfinite(self, what: str, step: int, value: float) -> None:
        """A host-fetched training scalar (loss / grad_norm) came back
        non-finite.  Counts always-on via the caller's enabled gate;
        warns once per scalar name."""
        if not (state.enabled and self.enabled):
            return
        tm.TRAIN_NONFINITE.inc()
        with self._lock:
            self._nonfinite_recent = self.calm_steps + 1
        self._record_event("watchdog.nonfinite", what=what,
                           at_step=step, value=repr(value))
        if what not in self._nonfinite_warned:
            self._nonfinite_warned.add(what)
            self._logger().warning(
                "watchdog: non-finite %s (%r) at global step %d — "
                "further occurrences count in ds_train_nonfinite_total "
                "without logging", what, value, step)

    def note_overflow_skip(self, step: int) -> None:
        """One fp16 dynamic-loss-scale overflow skip (the engine's
        device-side skip counter already exists; this mirrors the
        per-step host-visible flag into the registry)."""
        if not (state.enabled and self.enabled):
            return
        tm.TRAIN_OVERFLOW_SKIP.inc()
        self._record_event("watchdog.overflow_skip", at_step=step)

    # -- step-time anomaly detector ------------------------------------------
    def observe_step_time(self, kind: str, ms: float,
                          step: int = 0) -> None:
        """Feed one step wall time (``kind`` ∈ {train, fastgen}).  After
        ``warmup`` samples, a step slower than ``threshold ×`` the EWMA
        mean (and at least ``min_delta_ms`` over it) is an anomaly:
        counter + warn-once-per-storm + span-ring dump.  Anomalous
        samples do NOT update the EWMA (a storm must not drag the
        baseline up and mask itself)."""
        if not (state.enabled and self.enabled):
            return
        with self._lock:
            if kind == "train" and self._nonfinite_recent > 0:
                # one train step elapsed since the last non-finite
                # observation: the /healthz verdict heals after
                # calm_steps finite steps (a still-NaN'ing run keeps
                # re-raising it every step)
                self._nonfinite_recent -= 1
            w = self._kinds.get(kind)
            if w is None:
                w = self._kinds[kind] = _KindState()
            w.last_ms = ms
            anomalous = (
                w.n >= self.warmup and w.mean_ms > 0.0
                and ms > w.mean_ms * self.threshold
                and ms - w.mean_ms > self.min_delta_ms)
            if not anomalous:
                d = ms - w.mean_ms
                w.mean_ms += self.alpha * d
                w.dev_ms += self.alpha * (abs(d) - w.dev_ms)
                w.n += 1
                if w.in_storm:
                    w.calm += 1
                    if w.calm >= self.calm_steps:
                        w.in_storm = False
                return
            w.anomalies += 1
            w.last_anomaly_ms = ms
            first_of_storm = not w.in_storm
            w.in_storm = True
            w.calm = 0
            mean = w.mean_ms
        tm.TRAIN_ANOMALY.inc()
        self._record_event("watchdog.anomaly", stream=kind,
                           at_step=step, ms=round(ms, 3),
                           ewma_ms=round(mean, 3))
        if first_of_storm:
            self._logger().warning(
                "watchdog: %s step %d took %.1fms vs EWMA %.1fms "
                "(>%.1fx) — step-time anomaly storm begins; further "
                "anomalies count in ds_train_anomaly_total without "
                "logging until %d normal steps pass",
                kind, step, ms, mean, self.threshold, self.calm_steps)
            self._dump_anomaly_trace(kind, step)

    # -- memory-drift detector ----------------------------------------------
    def observe_resident_bytes(self, nbytes: float,
                               step: int = 0) -> None:
        """Feed one post-step resident-bytes observation (the memory
        ledger's time-series hook).  After ``warmup`` samples, resident
        bytes above ``mem_threshold ×`` the EWMA mean (and at least
        ``mem_min_delta_bytes`` over it) is a drift anomaly: counter +
        flight event + warn-once-per-storm.  Anomalous samples do NOT
        update the EWMA (a leak must not drag the baseline up and mask
        itself); the storm ends after ``calm_steps`` normal samples."""
        if not (state.enabled and self.enabled):
            return
        with self._lock:
            w = self._mem
            w.last_b = nbytes
            anomalous = (
                w.n >= self.warmup and w.mean_b > 0.0
                and nbytes > w.mean_b * self.mem_threshold
                and nbytes - w.mean_b > self.mem_min_delta_bytes)
            if not anomalous:
                w.mean_b += self.alpha * (nbytes - w.mean_b)
                w.n += 1
                if w.in_storm:
                    w.calm += 1
                    if w.calm >= self.calm_steps:
                        w.in_storm = False
                return
            w.anomalies += 1
            w.last_anomaly_b = nbytes
            first_of_storm = not w.in_storm
            w.in_storm = True
            w.calm = 0
            mean = w.mean_b
        tm.MEM_DRIFT_ANOMALY.inc()
        self._record_event("watchdog.anomaly", stream="memory",
                           at_step=step, bytes=int(nbytes),
                           ewma_bytes=int(mean))
        if first_of_storm:
            self._logger().warning(
                "watchdog: resident memory %.1fMB vs EWMA %.1fMB "
                "(>%.1fx) — memory-drift storm begins; further "
                "anomalies count in ds_mem_drift_anomaly_total "
                "without logging until %d normal samples pass "
                "(breakdown: /memory endpoint or memory.json "
                "postmortem)",
                nbytes / 2**20, mean / 2**20, self.mem_threshold,
                self.calm_steps)

    def _dump_anomaly_trace(self, kind: str, step: int) -> None:
        """Write the span ring around the offending step as a Chrome
        trace (best-effort: forensics must never take the run down).
        Requires a configured ``postmortem_dir`` — without one the
        verdict stays counter+warning only, so a test or smoke process
        never litters its cwd with trace artifacts."""
        if not self.postmortem_dir:
            return
        path = os.path.join(self.postmortem_dir,
                            f"anomaly_{kind}_step{step}.json")
        try:
            os.makedirs(self.postmortem_dir, exist_ok=True)
            from .tracer import get_tracer
            get_tracer().dump(path)
            self._logger().warning(
                "watchdog: span ring dumped to %s", path)
        except OSError as e:
            self._logger().warning(
                "watchdog: could not dump anomaly trace to %s (%s)",
                path, e)

    # -- goodput accounting --------------------------------------------------
    def track(self, phase: str):
        """Context manager accumulating wall time into ``phase``
        (one of :data:`GOODPUT_PHASES`).  Disabled: a shared no-op, no
        allocation."""
        if not (state.enabled and self.enabled):
            return _NULL_TRACK
        return _PhaseTimer(self, phase)

    def note_phase(self, phase: str, seconds: float) -> None:
        if not (state.enabled and self.enabled):
            return
        with self._lock:
            if self._phase_t0 is None:
                # wallclock origin opens at the first tracked phase, so
                # pre-training setup is not billed as idle
                self._phase_t0 = time.perf_counter() - seconds
            self._phase_s[phase] = self._phase_s.get(phase, 0.0) + seconds
        if not self._gauges_bound:
            self._bind_goodput_gauges()

    def _bind_goodput_gauges(self) -> None:
        self._gauges_bound = True

        def frac(phase):
            def _read(p=phase):
                return self._phase_fraction(p)
            return _read

        tm.TRAIN_GOODPUT_RATIO.bind(frac("step"))
        tm.TRAIN_COMPILE_FRACTION.bind(frac("compile"))
        tm.TRAIN_INPUT_WAIT_FRACTION.bind(frac("input_wait"))
        tm.TRAIN_STEP_FRACTION.bind(frac("step"))
        tm.TRAIN_CHECKPOINT_FRACTION.bind(frac("checkpoint"))
        tm.TRAIN_IDLE_FRACTION.bind(frac("idle"))

    def _phase_fraction(self, phase: str) -> float:
        with self._lock:
            if self._phase_t0 is None:
                return 0.0
            wall = max(time.perf_counter() - self._phase_t0, 1e-9)
            if phase == "idle":
                accounted = sum(self._phase_s.values())
                return max(0.0, 1.0 - accounted / wall)
            return min(self._phase_s.get(phase, 0.0) / wall, 1.0)

    def goodput(self) -> Dict[str, float]:
        out = {p: round(self._phase_fraction(p), 4)
               for p in GOODPUT_PHASES + ("idle",)}
        out["goodput_ratio"] = out["step"]
        return out

    # -- serving step-cache / recompile accounting ---------------------------
    def note_step_cache(self, hit: bool, key: Any = None,
                        compiled_on_path: bool = False) -> None:
        """One step-cache lookup on the serving request path.  Counters
        are unconditional (a compile is ~10^7× their cost, and a
        recompile storm must be visible even telemetry-off); the storm
        warning names the uncovered keys."""
        if hit:
            tm.FASTGEN_STEP_CACHE_HIT.inc()
            return
        tm.FASTGEN_STEP_CACHE_MISS.inc()
        if not compiled_on_path:
            return
        tm.FASTGEN_COMPILE_ON_PATH.inc()
        self._record_event("watchdog.compile_on_path", key=repr(key))
        # an on-path capture is a key the precompiled lattice missed:
        # ship it to the workload trace, so a lattice mined from the
        # trace covers it
        from .workload_trace import get_workload_trace
        get_workload_trace().record_compile(key)
        now = time.monotonic()
        with self._lock:
            self._compile_times.append(now)
            self._compile_keys.append(key)
            recent = [t for t in self._compile_times
                      if now - t <= self.storm_window_s]
            storm = len(recent) >= self.storm_compiles
            if not storm:
                self._in_compile_storm = False
                return
            if self._in_compile_storm:
                return      # warn once per storm
            self._in_compile_storm = True
            keys = list(self._compile_keys)
        wt = get_workload_trace()
        trace_hint = ((getattr(wt, "_path", "")
                       or "<workload-trace.jsonl>")
                      if wt.active else "<workload-trace.jsonl>")
        self._logger().warning(
            "watchdog: capture storm on the serving request path: "
            "%d step graphs captured in %.0fs; uncovered (S, Q, P, fresh, "
            "kind) step-cache keys: %s.  Widen precompile()'s lattice to "
            "cover them (sampling=True for the fused sample/chain "
            "variants), or mine a covering lattice from the workload "
            "trace and rebuild the engine with "
            "serving_optimization.lattice=\"auto:%s\" (plus "
            "compile_cache_dir/DS_COMPILE_CACHE so later processes load "
            "the kernel libraries instead of building them)",
            len(recent), self.storm_window_s, keys, trace_hint)

    # -- health verdicts (/healthz) ------------------------------------------
    def health(self) -> Dict[str, Any]:
        with self._lock:
            kinds = {
                k: {"ewma_ms": round(w.mean_ms, 3),
                    "dev_ms": round(w.dev_ms, 3),
                    "samples": w.n,
                    "anomalies": w.anomalies,
                    "in_storm": w.in_storm,
                    "last_ms": round(w.last_ms, 3)}
                for k, w in self._kinds.items()}
            nonfinite_recent = self._nonfinite_recent
            m = self._mem
            mem_drift = {"ewma_bytes": int(m.mean_b),
                         "samples": m.n,
                         "anomalies": m.anomalies,
                         "in_storm": m.in_storm,
                         "last_bytes": int(m.last_b)}
        nonfinite = tm.TRAIN_NONFINITE.value
        status = "ok"
        if (any(w["in_storm"] for w in kinds.values())
                or mem_drift["in_storm"]):
            status = "anomaly"
        if nonfinite_recent > 0:
            # recency, not history: the verdict heals after calm_steps
            # finite train steps (the cumulative counter still reports)
            status = "nonfinite"
        return {
            "status": status,
            "uptime_s": round(time.monotonic() - _T0, 3),
            "telemetry_enabled": state.enabled,
            "watchdog_enabled": self.enabled,
            "step_time": kinds,
            "memory_drift": mem_drift,
            "nonfinite_total": nonfinite,
            "overflow_skip_total": tm.TRAIN_OVERFLOW_SKIP.value,
            "anomaly_total": tm.TRAIN_ANOMALY.value,
            "step_cache": {
                "hit_total": tm.FASTGEN_STEP_CACHE_HIT.value,
                "miss_total": tm.FASTGEN_STEP_CACHE_MISS.value,
                "compile_on_path_total": tm.FASTGEN_COMPILE_ON_PATH.value,
            },
            "goodput": self.goodput(),
        }

    # -- plumbing ------------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  threshold: float = 0.0, warmup: int = -1,
                  postmortem_dir: str = "") -> None:
        """Config-block entry point (0 / -1 / "" = keep current)."""
        if enabled is not None:
            self.enabled = bool(enabled)
        if threshold:
            self.threshold = float(threshold)
        if warmup >= 0:
            self.warmup = int(warmup)
        if postmortem_dir:
            self.postmortem_dir = postmortem_dir

    def reset(self) -> None:
        """Drop all learned state (tests / measured-window control);
        configuration and gauge bindings survive."""
        with self._lock:
            self._kinds.clear()
            self._nonfinite_warned.clear()
            self._nonfinite_recent = 0
            self._phase_s.clear()
            self._phase_t0 = None
            self._compile_times.clear()
            self._compile_keys.clear()
            self._in_compile_storm = False
            self._mem = _DriftState()

    @staticmethod
    def _record_event(event: str, **fields) -> None:
        from .flight_recorder import get_flight_recorder
        get_flight_recorder().record(event, **fields)

    @staticmethod
    def _logger():
        from ..utils.logging import logger
        return logger


#: process-wide singleton
_WATCHDOG = Watchdog()


def get_watchdog() -> Watchdog:
    return _WATCHDOG
