"""Memory observatory: every byte gets an owner, every OOM a postmortem.

Counterpart of ``deepspeed_tpu/telemetry/memory.py``.  The
**MemoryLedger** is a process-wide registry of *accountants*: zero-arg
callbacks each reporting one subsystem's resident bytes (model weights,
quantised ``{'q', 'scale'}`` leaves included; KV pages at the true
``bytes_per_page``; the draft-KV pool; the tier's host ring and disk
directory; offloaded host blobs; handoff staging; the telemetry rings
themselves).  Accountants follow the ``ds_kv_*`` callback-gauge
discipline: bound through weakrefs, read lazily at scrape or sample time,
never written on the hot path; a dead owner reads as 0.

Three derived signals ride on top of the raw breakdown:

- ``ds_mem_accounted_bytes``: the sum of every accountant, with
  per-subsystem and total watermark peaks tracked by the per-step
  :meth:`MemoryLedger.sample` tick (disabled path: one branch).
- ``ds_mem_measured_bytes``: the truth, down a ladder.  On the card,
  ``torch.cuda.memory_allocated()``, the caching allocator's count of
  bytes in live tensors (the counterpart of JAX's ``bytes_in_use``;
  source ``"device"``); it is a host-side counter, so a scrape may read
  it while a CUDA graph captures.  Else the process RSS (source
  ``"rss"``).  PyTorch has no counterpart of ``jax.live_arrays()``, so
  the JAX ladder's middle rung (``"live_arrays"``, the CPU-debug sum of
  live buffers) has none here.  The probe is cached for half a second
  and taken only by scrapes, time-series samples and breakdowns; the
  per-step :meth:`MemoryLedger.sample` reads the accountants alone.
- ``ds_mem_unaccounted_bytes``: measured minus the device-resident
  accountants (weights, KV pages, draft KV, staging).  On the card the
  residual is the CUDA graphs' private memory pool (activations and
  workspaces of every captured step), the allocator's blocks of other
  live tensors (the token buffers of the step in flight, sampling
  scratch) and anything a caller allocated beside the engine.

The ledger also feeds the watchdog's memory-drift detector (measured
bytes per time-series sample) and writes ``memory.json``, the full
breakdown naming the dominant subsystem, into the postmortem bundle
(:func:`~.flight_recorder.dump_postmortem`).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

from .state import state
from . import metrics as tm

#: canonical subsystem names (the ``ds_mem_<subsystem>_bytes`` gauge
#: set); the ledger accepts ad-hoc names too, but only these publish
SUBSYSTEMS = ("weights", "kv_pages", "draft_kv", "tier_host",
              "tier_disk", "offload", "staging", "telemetry")

#: subsystems resident in device memory — the residual cross-check
#: compares their sum against device truth (tier ring / disk dir /
#: offloaded blobs / telemetry rings are host- or disk-side)
DEVICE_SUBSYSTEMS = frozenset({"weights", "kv_pages", "draft_kv",
                               "staging"})

#: measured-bytes cache TTL: the gauge reads of one scrape share a probe
_MEASURE_TTL_S = 0.5

#: flat per-entry estimate for the telemetry rings' own footprint
#: (span records, flight events, time-series samples are small dicts —
#: this is an ESTIMATE, labeled as such in the breakdown)
_RING_ENTRY_BYTES = 256


def _rss_bytes() -> Optional[int]:
    """Process-resident bytes: /proc VmRSS, else getrusage peak (a
    peak, not current — last-resort only)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        return int(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss) * 1024
    except Exception:
        return None


def _telemetry_ring_bytes() -> int:
    """Approximate footprint of the telemetry rings themselves (span
    buffer, flight events, time-series ring) — the observatory accounts
    for its own overhead instead of hiding in the residual."""
    n = 0
    from .tracer import get_tracer
    from .flight_recorder import get_flight_recorder
    from .timeseries import get_timeseries
    buf = getattr(get_tracer(), "_buf", None)
    if buf is not None:
        n += sum(1 for r in buf if r is not None)
    events = getattr(get_flight_recorder(), "_events", None)
    if events is not None:
        n += len(events)
    ring = getattr(get_timeseries(), "_ring", None)
    if ring is not None:
        n += len(ring)
    return n * _RING_ENTRY_BYTES


class MemoryLedger:
    """Per-subsystem capacity accounting with device-truth cross-check.

    Thread-safe (RLock, the telemetry lock discipline: the SIGTERM
    postmortem path may re-enter mid-sample).  Accountants may be
    registered from any thread; reads tolerate a raising accountant
    (warn once, report 0) — forensics must never take the serve loop
    down."""

    def __init__(self):
        self._lock = threading.RLock()
        self._accountants: Dict[str, Callable[[], int]] = {}
        self._device: Dict[str, bool] = {}
        self._peaks: Dict[str, int] = {}
        self._peak_total = 0
        self._warned: set = set()
        self._gauges_bound = False
        self._hooked = False
        self._measure_cache: Tuple[float, Optional[int], str] = (
            -1e9, None, "none")

    # -- registration --------------------------------------------------------
    def register(self, subsystem: str,
                 fn: Callable[[], int],
                 device: bool = False) -> None:
        """Register (or replace — newest owner wins, the ``ds_kv_*``
        gauge convention) one subsystem's accountant.  ``device``
        marks bytes resident in accelerator memory; it defaults from
        :data:`DEVICE_SUBSYSTEMS` for canonical names."""
        if subsystem in DEVICE_SUBSYSTEMS:
            device = True
        with self._lock:
            self._accountants[subsystem] = fn
            self._device[subsystem] = bool(device)
            self._peaks.setdefault(subsystem, 0)
            if "telemetry" not in self._accountants \
                    and subsystem != "telemetry":
                # the observatory accounts for itself from the first
                # real registration on
                self._accountants["telemetry"] = _telemetry_ring_bytes
                self._device["telemetry"] = False
                self._peaks.setdefault("telemetry", 0)
        self._bind_gauges()
        self._attach_hooks()

    def register_object(self, subsystem: str, obj: Any,
                        compute: Callable[[Any], int],
                        device: bool = False) -> None:
        """Weakref-backed registration: ``compute(obj)`` while ``obj``
        is alive, 0 after — the registry never keeps a discarded
        engine's pools alive."""
        ref = weakref.ref(obj)

        def _read(r=ref, c=compute):
            o = r()
            return int(c(o)) if o is not None else 0

        self.register(subsystem, _read, device=device)

    def unregister(self, subsystem: str) -> None:
        with self._lock:
            self._accountants.pop(subsystem, None)
            self._device.pop(subsystem, None)

    @property
    def armed(self) -> bool:
        """At least one accountant registered (the postmortem artifact
        and the ``/memory`` endpoint are on/off with this)."""
        return bool(self._accountants)

    # -- reads ---------------------------------------------------------------
    def read(self, subsystem: str) -> int:
        """One subsystem's current bytes (0: unregistered, dead owner,
        or a raising accountant — warned once per subsystem)."""
        fn = self._accountants.get(subsystem)
        if fn is None:
            return 0
        try:
            return max(int(fn()), 0)
        except Exception as e:
            if subsystem not in self._warned:
                self._warned.add(subsystem)
                self._logger().warning(
                    "memory ledger: accountant %r raised (%s) — "
                    "reporting 0; further failures are silent",
                    subsystem, e)
            return 0

    def accounted_bytes(self) -> int:
        """Sum of every accountant (the ``ds_mem_accounted_bytes``
        gauge callback)."""
        with self._lock:
            names = list(self._accountants)
        return sum(self.read(n) for n in names)

    def device_accounted_bytes(self) -> int:
        with self._lock:
            names = [n for n, d in self._device.items() if d]
        return sum(self.read(n) for n in names)

    # -- device truth --------------------------------------------------------
    def measured_bytes(self) -> Tuple[Optional[int], str]:
        """Resident bytes from the truth ladder: the caching allocator's
        ``memory_allocated`` on the card, else RSS.  Cached briefly so
        one scrape's gauge reads share a probe."""
        now = time.monotonic()
        with self._lock:
            t, val, src = self._measure_cache
            if now - t < _MEASURE_TTL_S:
                return val, src
        val, src = self._measure_now()
        with self._lock:
            self._measure_cache = (now, val, src)
        return val, src

    @staticmethod
    def _measure_now() -> Tuple[Optional[int], str]:
        try:
            import torch
            # is_initialized: a scrape never creates a CUDA context in a
            # process that serves on the CPU
            if torch.cuda.is_initialized():
                allocated = int(torch.cuda.memory_allocated())
                if allocated:
                    return allocated, "device"
        except Exception:
            pass
        rss = _rss_bytes()
        return (rss, "rss") if rss is not None else (None, "none")

    def unaccounted_bytes(self) -> Optional[int]:
        """Measured minus device-resident accounted: the residual that
        makes accounting drift visible instead of silent.  None when
        no truth source exists."""
        measured, _ = self.measured_bytes()
        if measured is None:
            return None
        return measured - self.device_accounted_bytes()

    # -- hot-path tick -------------------------------------------------------
    def sample(self) -> None:
        """Per-step watermark tick (scheduler step end): refresh every
        accountant and raise the per-subsystem + total peaks.  The
        disabled/unarmed path is a single branch with no allocation."""
        if not state.enabled or not self._accountants:
            return
        with self._lock:
            names = list(self._accountants)
        total = 0
        for name in names:
            b = self.read(name)
            total += b
            with self._lock:
                if b > self._peaks.get(name, 0):
                    self._peaks[name] = b
        with self._lock:
            if total > self._peak_total:
                self._peak_total = total

    def _on_ts_sample(self, ts) -> None:
        """Time-series sampler hook: feed the watchdog's memory-drift
        detector with post-step resident bytes and keep watermarks
        fresh even when no scheduler is stepping."""
        measured, _src = self.measured_bytes()
        if measured is not None:
            from .watchdog import get_watchdog
            get_watchdog().observe_resident_bytes(measured)
        self.sample()

    # -- forensics -----------------------------------------------------------
    def breakdown(self) -> Dict[str, Any]:
        """The full accounting snapshot: per-subsystem bytes + peaks,
        totals, device truth, residual, and the dominant subsystem —
        the ``mem.breakdown`` flight-event payload and the
        ``memory.json`` postmortem body."""
        with self._lock:
            names = list(self._accountants)
            device_flags = dict(self._device)
        subsystems: Dict[str, int] = {}
        total = 0
        device_total = 0
        for name in names:
            b = self.read(name)
            subsystems[name] = b
            total += b
            if device_flags.get(name):
                device_total += b
        with self._lock:
            for name, b in subsystems.items():
                if b > self._peaks.get(name, 0):
                    self._peaks[name] = b
            if total > self._peak_total:
                self._peak_total = total
            peaks = {n: self._peaks.get(n, 0) for n in subsystems}
            peak_total = self._peak_total
        measured, source = self.measured_bytes()
        dominant = max(subsystems, key=subsystems.get) \
            if subsystems else None
        return {
            "subsystems": subsystems,
            "peaks": peaks,
            "accounted_bytes": total,
            "device_accounted_bytes": device_total,
            "peak_accounted_bytes": peak_total,
            "measured_bytes": measured,
            "measured_source": source,
            "unaccounted_bytes": (measured - device_total
                                  if measured is not None else None),
            "dominant": dominant,
        }

    def to_json(self) -> Optional[Dict[str, Any]]:
        """The ``memory.json`` artifact body — None when no accountant
        ever registered, so telemetry-only processes keep their bundle
        unchanged (the workload.jsonl on/off convention)."""
        if not self.armed:
            return None
        doc = self.breakdown()
        hd = tm.MEM_HEADROOM_SEQS
        doc["headroom_seqs"] = (int(hd.value) if hd.touched else None)
        return doc

    # -- plumbing ------------------------------------------------------------
    def _bind_gauges(self) -> None:
        """Bind the ``ds_mem_*`` gauge set to this ledger (idempotent;
        the ledger is a process singleton, so strong callback refs are
        fine — accountants themselves hold the weakrefs)."""
        if self._gauges_bound:
            return
        self._gauges_bound = True

        def reader(name):
            def _read(n=name):
                return self.read(n)
            return _read

        tm.MEM_WEIGHTS_BYTES.bind(reader("weights"))
        tm.MEM_KV_PAGES_BYTES.bind(reader("kv_pages"))
        tm.MEM_DRAFT_KV_BYTES.bind(reader("draft_kv"))
        tm.MEM_TIER_HOST_BYTES.bind(reader("tier_host"))
        tm.MEM_TIER_DISK_BYTES.bind(reader("tier_disk"))
        tm.MEM_OFFLOAD_BYTES.bind(reader("offload"))
        tm.MEM_STAGING_BYTES.bind(reader("staging"))
        tm.MEM_TELEMETRY_BYTES.bind(reader("telemetry"))
        tm.MEM_ACCOUNTED_BYTES.bind(self.accounted_bytes)
        tm.MEM_PEAK_ACCOUNTED_BYTES.bind(lambda: self._peak_total)
        tm.MEM_MEASURED_BYTES.bind(self._measured_gauge)
        tm.MEM_UNACCOUNTED_BYTES.bind(self._unaccounted_gauge)

    def _measured_gauge(self) -> int:
        measured, _ = self.measured_bytes()
        return measured or 0

    def _unaccounted_gauge(self) -> int:
        return self.unaccounted_bytes() or 0

    def _attach_hooks(self) -> None:
        """Join the time-series sampler (memory-drift feed) — dedup'd
        by add_on_sample, safe to call per registration."""
        if self._hooked:
            return
        self._hooked = True
        from .timeseries import get_timeseries
        get_timeseries().add_on_sample(self._on_ts_sample)

    def reset(self) -> None:
        """Drop accountants and learned peaks (tests / rebuild);
        gauge bindings survive and read 0."""
        with self._lock:
            self._accountants.clear()
            self._device.clear()
            self._peaks.clear()
            self._peak_total = 0
            self._warned.clear()
            self._measure_cache = (-1e9, None, "none")

    @staticmethod
    def _logger():
        from ..utils.logging import logger
        return logger


#: process-wide singleton
_LEDGER = MemoryLedger()


def get_memory_ledger() -> MemoryLedger:
    return _LEDGER
