"""Deterministic fault-injection registry.

Counterpart of ``deepspeed_tpu/runtime/fault_injection.py`` (plain
Python, the same sites, grammar and seeding).  The port wires
``serving.preempt`` (``FastGenScheduler.step``),
``fastgen.poison_request`` (the scheduler's admission), ``kv.alloc_oom``
(``StateManager.allocate_for``), ``ckpt.io_error``
(``checkpoint/engine.py`` and the serving snapshot writer) and the
training sites ``comm.collective_failure``, ``train.nan_grad`` and
``train.slow_step`` (``DeepSpeedEngine.train_batch``).

Chaos engineering for the training and serving hot paths: a process-wide
registry of **named injection sites** woven into the code the telemetry
spine already instruments.  Every site is seeded and call-counted, so a
chaos run is exactly reproducible: the same seed + site spec fires the
same faults at the same call ordinals, which is what lets the chaos
tests assert tokenwise parity between an injected and an uninjected run
for the requests a fault did NOT touch.

Sites (the registry refuses unknown names so a typo'd spec is loud):

=========================  ==================================================
``train.nan_grad``         poison the next train batch with NaNs — the real
                           NaN propagates through the real fused step, so
                           recovery must genuinely roll back corrupted state
``train.slow_step``        stall a train step by ``value`` ms (EWMA anomaly
                           detector food)
``comm.collective_failure``  raise :class:`InjectedCollectiveFault` (a
                           :class:`TransientFault`) at train-step dispatch,
                           before any state mutation — retry-safe
``ckpt.io_error``          raise :class:`InjectedCheckpointFault` (an
                           ``OSError``) inside checkpoint save / the atomic
                           ``latest`` write
``kv.alloc_oom``           raise ``KVAllocationError`` from the KV-page
                           allocation path
``fastgen.poison_request``  raise :class:`PoisonedRequestFault` inside ONE
                           request's admission path (isolation food)
``serving.preempt``        raise :class:`InjectedPreemptionFault` — a
                           deterministic SIGTERM-equivalent — between
                           scheduler steps, so the drain→snapshot→restore
                           preemption path is chaos-testable without signals
=========================  ==================================================

Arming: the ``fault_injection`` config block on either engine config, or
the ``DS_CHAOS`` env var (read at import)::

    DS_CHAOS="fastgen.poison_request:p=0.1,max=3;ckpt.io_error:at=1|3"
    DS_CHAOS_SEED=7

Per-site spec keys: ``p``/``probability`` (per-call fire chance),
``at`` / ``at_calls`` (explicit 1-based call ordinals, deterministic),
``max`` / ``max_fires`` (fire budget, 0 = unlimited), ``value`` (site
payload, e.g. slow-step milliseconds).

Disabled-path contract: :meth:`FaultInjector.fire` reads ONE attribute
(``armed``) and returns — the same <5µs bound the tracer and watchdog
keep, verified by the same style of test.  Every fire increments
``ds_chaos_injected_total`` and leaves a ``chaos.fire`` flight-recorder
event, so a postmortem bundle of a chaos run names exactly which faults
were injected where.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any, Dict, Mapping, Optional


# -- fault taxonomy ----------------------------------------------------------

class InjectedFault(RuntimeError):
    """Base of every exception the registry raises on purpose."""


class TransientFault(RuntimeError):
    """Marker for retry-safe failures: raised before any state mutation,
    so the self-healing engine may retry the same work after backoff.
    Real transient errors (a flaky collective transport) may subclass
    this too — the recovery path keys on the marker, not on injection."""


class InjectedCollectiveFault(TransientFault, InjectedFault):
    """A collective failed at dispatch; no device state was touched."""


class InjectedCheckpointFault(InjectedFault, OSError):
    """Checkpoint I/O failed (an ``OSError``, so the checkpoint retry
    loop treats it exactly like a real full-disk / dead-mount error)."""


class PoisonedRequestFault(InjectedFault):
    """One serving request's processing blew up (attributable: raised
    inside that request's admission block)."""


class InjectedPreemptionFault(InjectedFault):
    """A SIGTERM-equivalent preemption raised BETWEEN scheduler steps
    (no step state is mid-mutation).  The driving loop catches it and
    runs ``drain_and_snapshot`` exactly as the real signal handler
    would — deterministic, so a chaos test can interrupt at any chosen
    step ordinal and assert tokenwise parity after restore."""


#: every known injection site -> short description (docs + validation)
SITES: Dict[str, str] = {
    "train.nan_grad": "poison the next train batch with NaNs",
    "train.slow_step": "stall a train step by `value` ms",
    "comm.collective_failure":
        "raise a transient collective failure at train-step dispatch",
    "ckpt.io_error": "raise OSError inside checkpoint save/latest write",
    "kv.alloc_oom": "raise KVAllocationError from KV-page allocation",
    "kv.tier_io_error":
        "raise OSError inside KV tier demotion/spill/promotion I/O "
        "(degrades to a clean tier miss, never a corrupt hit)",
    "fastgen.poison_request":
        "raise inside one serving request's admission path",
    "serving.preempt":
        "raise a SIGTERM-equivalent preemption between scheduler steps",
}


class FaultSpec:
    """One site's firing rule (immutable after configure)."""
    __slots__ = ("probability", "at_calls", "max_fires", "value")

    def __init__(self, probability: float = 0.0,
                 at_calls: Optional[frozenset] = None,
                 max_fires: int = 0, value: float = 0.0):
        self.probability = float(probability)
        self.at_calls = at_calls or frozenset()
        self.max_fires = int(max_fires)
        self.value = float(value)


_SPEC_KEYS = {
    "p": "probability", "prob": "probability", "probability": "probability",
    "at": "at_calls", "at_calls": "at_calls",
    "max": "max_fires", "max_fires": "max_fires",
    "value": "value",
}


def _normalize_spec(site: str, raw: Mapping[str, Any]) -> FaultSpec:
    if site not in SITES:
        raise ValueError(
            f"unknown fault-injection site {site!r}; known sites: "
            f"{sorted(SITES)}")
    kw: Dict[str, Any] = {}
    for k, v in raw.items():
        dest = _SPEC_KEYS.get(k)
        if dest is None:
            raise ValueError(
                f"fault-injection site {site!r}: unknown spec key {k!r} "
                f"(use p/at/max/value)")
        if dest == "at_calls":
            if isinstance(v, str):
                v = [int(x) for x in v.split("|") if x]
            kw[dest] = frozenset(int(x) for x in v)
        else:
            kw[dest] = float(v)
    return FaultSpec(**kw)


class FaultInjector:
    """Process-wide injector.  ``armed`` is the one-attribute fast gate:
    with no sites configured every ``fire()`` is a read + return."""

    def __init__(self):
        self.armed = False
        # RLock: fire() can run inside frames
        # the postmortem SIGTERM handler interrupts and re-enters
        self._lock = threading.RLock()
        self._seed = 0
        self._specs: Dict[str, FaultSpec] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._calls: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}

    # -- arming --------------------------------------------------------------
    def configure(self, sites: Mapping[str, Mapping[str, Any]],
                  seed: int = 0) -> None:
        """Arm the registry with per-site specs.  Deterministic: each
        site gets its own ``random.Random`` seeded from ``(seed, site)``,
        and call ordinals restart at 0, so two identically-configured
        processes inject identical fault sequences."""
        specs = {s: _normalize_spec(s, raw or {})
                 for s, raw in sites.items()}
        with self._lock:
            self._seed = int(seed)
            self._specs = specs
            self._rngs = {s: random.Random(f"{seed}:{s}") for s in specs}
            self._calls = {s: 0 for s in specs}
            self._fires = {s: 0 for s in specs}
            self.armed = bool(specs)

    def disarm(self) -> None:
        """Drop every spec; ``fire()`` returns to the one-read path."""
        with self._lock:
            self._specs = {}
            self._rngs = {}
            self._calls = {}
            self._fires = {}
            self.armed = False

    def has_site(self, site: str) -> bool:
        """Whether ``site`` is armed (lets a call site skip expensive
        applicability checks — and avoid mis-counting an inapplicable
        fire — without probing the RNG)."""
        return self.armed and site in self._specs

    # -- the hot-path gate ---------------------------------------------------
    def fire(self, site: str) -> bool:
        """Should the fault at ``site`` fire on this call?  Disabled
        path: one attribute read."""
        if not self.armed:
            return False
        return self._fire_slow(site)

    def _fire_slow(self, site: str) -> bool:
        with self._lock:
            spec = self._specs.get(site)
            if spec is None:
                return False
            self._calls[site] += 1
            call = self._calls[site]
            if spec.max_fires and self._fires[site] >= spec.max_fires:
                return False
            hit = call in spec.at_calls or (
                spec.probability > 0.0
                and self._rngs[site].random() < spec.probability)
            if not hit:
                return False
            self._fires[site] += 1
            fired = self._fires[site]
        from ..telemetry import metrics as tm
        tm.CHAOS_INJECTED.inc()
        from ..telemetry.flight_recorder import get_flight_recorder
        get_flight_recorder().record("chaos.fire", site=site, call=call,
                                     fired=fired)
        return True

    def maybe_raise(self, site: str, exc_type=InjectedFault,
                    message: str = "") -> None:
        """Raise ``exc_type`` when ``site`` fires (no-op otherwise)."""
        if self.armed and self.fire(site):
            raise exc_type(message or f"injected fault at {site}")

    def site_value(self, site: str, default: float = 0.0) -> float:
        """The site's ``value`` payload (e.g. slow-step ms)."""
        with self._lock:
            spec = self._specs.get(site)
            return spec.value if spec is not None and spec.value \
                else default

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-site call/fire counts (the chaos tests assert every
        configured site actually fired)."""
        with self._lock:
            return {s: {"calls": self._calls[s], "fires": self._fires[s]}
                    for s in self._specs}


def parse_chaos_env(spec: str) -> Dict[str, Dict[str, str]]:
    """``DS_CHAOS`` grammar: ``site:k=v,k=v;site2:k=v`` (``at`` ordinals
    are ``|``-separated).  A bare ``site`` with no keys means
    ``p=1.0`` — fire on every call."""
    sites: Dict[str, Dict[str, str]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, args = part.partition(":")
        site = site.strip()
        kv: Dict[str, str] = {}
        for item in args.split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            kv[k.strip()] = v.strip()
        if not kv:
            kv = {"p": "1.0"}
        sites[site] = kv
    return sites


#: process-wide singleton
_INJECTOR = FaultInjector()


def get_fault_injector() -> FaultInjector:
    return _INJECTOR


def apply_fault_injection(enabled: bool, seed: int,
                          sites: Mapping[str, Mapping[str, Any]]) -> None:
    """Single implementation behind both engine configs'
    ``FaultInjectionConfig.apply()`` (the telemetry ``apply_settings``
    pattern).  ``enabled=False`` leaves the process registry alone so a
    default-config engine build cannot disarm a ``DS_CHAOS`` arming."""
    if not enabled:
        return
    _INJECTOR.configure(sites, seed=seed)


def _arm_from_env() -> None:
    spec = os.environ.get("DS_CHAOS", "")
    if not spec:
        return
    seed = int(os.environ.get("DS_CHAOS_SEED", "0") or 0)
    _INJECTOR.configure(parse_chaos_env(spec), seed=seed)


_arm_from_env()
