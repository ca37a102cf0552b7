"""Replica-pool serving controller.

Counterpart of ``deepspeed_tpu/serving/pool.py``.  One
``FastGenScheduler`` is an engine; a :class:`ReplicaPool` is a service:
N in-process scheduler replicas behind a :class:`PrefixAffinityRouter`,
scaled and rebalanced on an SLO evaluator's advice, with live migration
so a membership change never loses a request.

Placement: replicas publish a bounded top-K slice of their chained page
digests (``engine.export_digests``) and each prompt goes to the replica
holding the longest matching digest prefix, else to the least backlog
(``FastGenScheduler.backlog``).  With ``page_fetch_margin`` >= 0 an
affinity match that loses to least-backlog streams the matched pages
from the peer (``export_prefix`` / ``import_prefix``, host tensors in
the handoff codec's layout) instead of prefilling them again.

Migration keeps every committed token.  ``scale_down`` drains one
replica (``snapshot()`` commits its step in flight, delivering the
tokens through the pool's ledger) and resubmits each of its requests to
a peer as ``prompt + committed tokens`` with the remaining token budget
and TTL; the pool stitches the stream, so the committed prefix is kept
verbatim and a greedy continuation equals the uninterrupted run.
``kill`` and an ``InjectedPreemptionFault`` escaping a step (the
``serving.preempt`` fault site) drop a replica without a drain; the pool
resubmits its requests from its own ledger.

Threads: ``start()`` runs one stepper thread per replica.  Precompile
every replica's step keys before it starts: captures are thread-local
(``ops/kernel_loader.CountedGraph``), and a warm spawn captures while
holding every live replica's lock, so no capture overlaps a step.
``attach_slo`` takes any object with ``current()``, such as
``telemetry.slo.SLOEvaluator``.  In the subprocess mode each replica is
a process of its own (``python -m deepspeed_tpu_torch.tools.
fleet_replica``) with its metrics endpoint on an ephemeral port: a
controller federates their registries (``telemetry.federation``), judges
the merged ring (``telemetry.slo``) and places a request by the digest
hints it scrapes from each (``router.fetch_remote_hints`` into a
:class:`PrefixAffinityRouter`); ``python -m
deepspeed_tpu_torch.tools.fleetctl`` drives it.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..inference.v2.compile_cache import active_cache_dir
from ..inference.v2.sampling import SamplingParams
from ..inference.v2.scheduler import FastGenScheduler, RequestError
from ..runtime.fault_injection import InjectedPreemptionFault
from ..telemetry import journey as _journey
from ..telemetry import metrics as tm
from ..telemetry.flight_recorder import get_flight_recorder
from ..telemetry.tracer import set_component
from .router import PrefixAffinityRouter, RouteDecision


def _nbytes(arrays) -> int:
    """Bytes of a bundle's arrays (numpy arrays or host tensors)."""
    return sum(int(a.nbytes) if hasattr(a, "nbytes")
               else a.numel() * a.element_size() for a in arrays.values())


@dataclasses.dataclass
class PoolRequest:
    """Pool-side view of one request: the authoritative token ledger
    across migrations (each scheduler only ever sees the tokens IT
    generated; the pool stitches the full stream)."""
    uid: int
    prompt: np.ndarray
    params: SamplingParams
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[RequestError] = None
    replica: str = ""
    migrations: int = 0
    matched_pages: int = 0
    #: monotonic stamps for the pool's own TTFT accounting
    submit_mono: float = 0.0
    first_token_mono: float = 0.0
    finished_mono: float = 0.0
    #: absolute monotonic deadline (None = no TTL); survives migration
    #: as a remaining budget
    deadline: Optional[float] = None
    #: journey: ONE trace context for the request's whole
    #: life — every scheduler Request it is (re)submitted as shares
    #: this same object, so segments from before and after a migration
    #: land in one chain
    journey: Optional[object] = None

    @property
    def finalized(self) -> bool:
        return self.done or self.error is not None


class _Replica:
    """One in-process replica: scheduler + engine + its step lock (a
    scheduler is single-threaded; the lock serializes its own stepper
    thread against pool submits/migrations)."""

    def __init__(self, label: str, scheduler: FastGenScheduler,
                 pool: "ReplicaPool"):
        self.label = label
        self.scheduler = scheduler
        self.engine = scheduler._engine
        self.lock = threading.RLock()
        self.alive = True
        self.steps = 0
        self._pool = pool

    def deliver(self, uid: int, tok: int) -> None:
        """The pool's per-token delivery (passed as ``on_token`` to
        every step/snapshot drain): appends to the POOL ledger and
        applies the original request's termination rule (the scheduler
        applies it to its own residual view after a migration)."""
        req = self._pool._requests.get(uid)
        if req is None or req.finalized:
            return
        req.tokens.append(int(tok))
        now = time.monotonic()
        if req.first_token_mono == 0.0:
            req.first_token_mono = now
        stop = req.params.stop_token
        if (len(req.tokens) >= req.params.max_new_tokens
                or (stop is not None and int(tok) == stop)):
            req.done = True
            req.finished_mono = now


class ReplicaPool:
    """N FastGenScheduler replicas behind a prefix-affinity router."""

    def __init__(self, factory: Callable[[str], FastGenScheduler],
                 replicas: int = 2,
                 policy: str = "affinity",
                 hint_top_k: int = 64,
                 hint_every: int = 4,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 warm_spawn: bool = True,
                 page_fetch_margin: int = -1):
        """``factory(label)`` builds one fresh replica (engine and
        scheduler), also the ``scale_up`` spawn path, so it must return
        an INDEPENDENT engine per call (engines may share weight
        tensors).  With ``warm_spawn`` every later spawn captures the
        union of the live replicas' dispatched step keys (the graphs
        fleet traffic actually forms) before joining the pool, when a
        compile cache is active (``serving.compile_cache_dir`` or
        ``DS_COMPILE_CACHE``, as in the JAX package); without one the
        spawn joins at once and captures on first use."""
        self._factory = factory
        self._warm_spawn = bool(warm_spawn)
        self._hint_top_k = int(hint_top_k)
        self._hint_every = max(int(hint_every), 1)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}
        self._requests: Dict[int, PoolRequest] = {}
        #: uids whose home died while the pool had no live replica —
        #: re-routed on the next scale_up / step with live members
        self._orphans: List[int] = []
        self._next_label = 0
        self._router: Optional[PrefixAffinityRouter] = None
        self._policy = policy
        #: cross-replica page fetch: when >= 0, an affinity match losing
        #: to least-backlog by more than this margin streams its matched
        #: pages to the chosen replica instead of recomputing the
        #: prefill (-1 = off, pure affinity)
        self._page_fetch_margin = int(page_fetch_margin)
        # -- SLO subscription ------------------------------------------------
        self._slo = None
        self._slo_cooldown_s = 5.0
        self._last_action_mono = 0.0
        # -- threaded serve loop ---------------------------------------------
        self._stop_evt = threading.Event()
        self._threads: Dict[str, threading.Thread] = {}
        self._pace_s = 0.0
        for _ in range(max(int(replicas), 1)):
            self._add_replica(count_scale_up=False)
        get_flight_recorder().record(
            "pool.build", replicas=len(self._replicas), policy=policy)

    # -- membership ----------------------------------------------------------
    @property
    def router(self) -> PrefixAffinityRouter:
        return self._router

    def _live(self) -> List[_Replica]:
        with self._lock:
            return [r for r in self._replicas.values() if r.alive]

    @property
    def labels(self) -> List[str]:
        return sorted(r.label for r in self._live())

    def _add_replica(self, label: Optional[str] = None,
                     count_scale_up: bool = True) -> _Replica:
        with self._lock:
            if label is None:
                label = f"r{self._next_label}"
            self._next_label += 1
        sched = self._factory(label)
        if self._warm_spawn:
            self._warm_new_replica(sched)
        rep = _Replica(label, sched, self)
        with self._lock:
            self._replicas[label] = rep
            if self._router is None:
                # page size is an engine fact; the first replica fixes it
                self._router = PrefixAffinityRouter(
                    rep.engine.model.kv_config.page_size,
                    top_k=self._hint_top_k, policy=self._policy,
                    fetch_backlog_margin=self._page_fetch_margin)
            tm.POOL_REPLICAS.set(len(self._live()))
        if count_scale_up:
            tm.POOL_SCALE_UP.inc()
        get_flight_recorder().record("pool.replica_add", label=label,
                                     scale_up=count_scale_up)
        self._flush_orphans()
        return rep

    def compiled_manifest(self) -> List[tuple]:
        """Union of the live replicas' compiled-key manifests — the
        programs fleet traffic actually formed, in a stable order."""
        keys = set()
        for rep in self._live():
            try:
                keys.update(rep.engine.compiled_keys())
            except Exception:   # noqa: BLE001 -- a dying replica is fine
                continue
        return sorted(keys, key=repr)

    def _warm_new_replica(self, sched: FastGenScheduler) -> None:
        """Capture the fleet's dispatched step keys on a just-spawned
        replica, so it joins warm.  Gated on an active compile cache, as
        in the JAX package (without one a spawn joins at once and
        captures the keys traffic forms).  Every live replica's lock is
        held while it captures, so no capture overlaps another replica's
        step.  Best-effort: a failure warns and the replica joins
        cold."""
        if active_cache_dir() is None:
            return
        manifest = self.compiled_manifest()
        if not manifest:
            return
        live = sorted(self._live(), key=lambda r: r.label)
        for rep in live:
            rep.lock.acquire()
        try:
            n = sched._engine.precompile_keys(manifest)
        except (RuntimeError, ValueError) as e:
            warnings.warn(f"pool: warm spawn precompile failed "
                          f"({type(e).__name__}: {e}); replica joins cold")
            return
        finally:
            for rep in reversed(live):
                rep.lock.release()
        get_flight_recorder().record("pool.warm_spawn",
                                     manifest_keys=len(manifest),
                                     compiled=n)

    def scale_up(self, label: Optional[str] = None) -> Optional[str]:
        """Spawn one fresh replica (the SLO ``scale_up`` action).
        Refuses past ``max_replicas``; returns the new label."""
        if len(self._live()) >= self.max_replicas:
            return None
        return self._add_replica(label).label

    # -- placement -----------------------------------------------------------
    def _backlogs(self, exclude: Optional[str] = None) -> Dict[str, int]:
        return {r.label: r.scheduler.backlog for r in self._live()
                if r.label != exclude}

    def _place(self, req: PoolRequest, prompt: np.ndarray,
               params: SamplingParams, ttl_s: Optional[float],
               exclude: Optional[str] = None
               ) -> Optional[RequestError]:
        """Route + submit one (possibly migrated) request.  Returns the
        scheduler's immediate-rejection verdict or None; a rejection
        finalizes the pool request with its partial tokens."""
        backlogs = self._backlogs(exclude)
        if not backlogs:
            with self._lock:
                if req.uid not in self._orphans:
                    self._orphans.append(req.uid)
            return None     # parked until a replica exists
        decision: RouteDecision = self._router.decide(prompt, backlogs)
        rep = self._replicas.get(decision.label)
        if rep is None or not rep.alive:
            return self._place(req, prompt, params, ttl_s, exclude)
        tm.POOL_ROUTED.inc()
        if decision.reason in ("affinity", "pin"):
            tm.POOL_AFFINITY_ROUTED.inc()
        req.replica = decision.label
        req.matched_pages = decision.matched_pages
        if req.journey is not None:
            req.journey.mark("placement", at="router")
        if decision.fetch_from:
            self._fetch_pages(rep, decision)
            if req.journey is not None:
                req.journey.mark("page_fetch", at=decision.label)
        with rep.lock:
            verdict = rep.scheduler.submit(req.uid, prompt, params,
                                           ttl_s=ttl_s,
                                           journey=req.journey)
        if verdict is not None:
            req.error = RequestError(uid=req.uid, code=verdict.code,
                                     message=verdict.message,
                                     tokens=list(req.tokens))
            req.finished_mono = time.monotonic()
        return verdict

    def _fetch_pages(self, rep: _Replica,
                     decision: RouteDecision) -> None:
        """Stream the matched committed prefix pages replica to replica
        through the handoff codec's (meta, named arrays) layout: export
        under the peer's lock, import under the target's, two separate
        critical sections, never nested, so opposite fetches cannot
        deadlock.  Best-effort: a dead peer, a stale hint or a full
        target pool means the request prefills its prefix like a cold
        placement."""
        src = self._replicas.get(decision.fetch_from)
        if src is None or not src.alive:
            return
        t0 = time.monotonic()
        try:
            with src.lock:
                exported = src.engine.export_prefix(
                    decision.fetch_digests)
            if exported is None:
                return      # stale hint: the peer evicted the pages
            meta, arrays = exported
            with rep.lock:
                stats = rep.engine.import_prefix(meta, arrays)
        except Exception as e:  # noqa: BLE001 -- the fetch is an
            # optimisation; the recompute path is always correct
            warnings.warn(f"pool: page fetch {decision.fetch_from} -> "
                          f"{rep.label} failed ({type(e).__name__}: {e}); "
                          "the request prefills cold")
            return
        elapsed_ms = (time.monotonic() - t0) * 1000.0
        pages = int(stats.get("pages_imported", 0))
        nbytes = _nbytes(arrays)
        tm.POOL_PAGE_FETCHES.inc()
        tm.POOL_PAGE_FETCH_PAGES.inc(pages)
        tm.POOL_PAGE_FETCH_BYTES.inc(nbytes)
        tm.POOL_PAGE_FETCH_MS.observe(elapsed_ms)
        get_flight_recorder().record(
            "pool.page_fetch", src=decision.fetch_from, dst=rep.label,
            pages=pages, skipped=int(stats.get("pages_skipped", 0)),
            bytes=nbytes)

    def submit(self, uid: int, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               ttl_s: Optional[float] = None) -> Optional[RequestError]:
        """Route one request into the pool; same contract as
        ``FastGenScheduler.submit`` (None = accepted, else the
        structured rejection, also kept in :attr:`errors`)."""
        params = params or SamplingParams()
        req = PoolRequest(uid=uid,
                          prompt=np.asarray(prompt, dtype=np.int32),
                          params=params)
        req.submit_mono = time.monotonic()
        req.journey = _journey.mint(uid)
        if ttl_s:
            req.deadline = req.submit_mono + float(ttl_s)
        with self._lock:
            old = self._requests.get(uid)
            if old is not None and not old.finalized:
                raise ValueError(f"uid {uid} is already live in the pool")
            self._requests[uid] = req
        return self._place(req, req.prompt, params, ttl_s)

    # -- hint publication ----------------------------------------------------
    def _publish_hints(self, rep: _Replica) -> None:
        # under the replica's step lock: export_digests iterates the
        # prefix-cache index, which that replica's stepper thread
        # mutates mid-step (scale_down refreshes PEER hints from the
        # caller's thread while peers keep serving)
        with rep.lock:
            digests = rep.engine.export_digests(self._hint_top_k)
        self._router.publish(rep.label, digests)

    def publish_hints(self) -> None:
        """Force an immediate hint publish from every live replica
        (the step loop otherwise publishes every ``hint_every`` steps
        per replica)."""
        for rep in self._live():
            self._publish_hints(rep)

    # -- stepping ------------------------------------------------------------
    def _step_replica(self, rep: _Replica) -> bool:
        """One scheduler step on one replica (under its lock).  A
        preemption fault escaping the step kills the replica like a
        preempted spot VM; the pool absorbs it."""
        died = publish = False
        set_component(rep.label)
        with rep.lock:
            if not rep.alive or not rep.scheduler.has_work:
                return False
            try:
                rep.scheduler.step(on_token=rep.deliver)
                rep.steps += 1
                publish = rep.steps % self._hint_every == 0
            except InjectedPreemptionFault:
                rep.alive = False
                died = True
        if died:
            self._absorb_death(rep, reason="preempted")
            return True
        if publish:
            self._publish_hints(rep)
        self._harvest_errors(rep)
        return True

    def step(self) -> None:
        """Single-threaded drive: one step on every live replica, then
        orphan re-routing and SLO advice polling."""
        for rep in self._live():
            self._step_replica(rep)
        self._flush_orphans()
        self._poll_advice()

    @property
    def idle(self) -> bool:
        return (not self._orphans
                and all(not r.scheduler.has_work for r in self._live())
                and all(r.finalized for r in self._requests.values()))

    def run_to_completion(self, max_stalls: int = 256
                          ) -> Dict[int, List[int]]:
        """Step until every submitted request is finalized; returns
        {uid: tokens} for completed requests (errors in
        :attr:`errors`)."""
        stalls = 0
        while not self.idle:
            before = sum(len(r.tokens) for r in self._requests.values())
            self.step()
            after = sum(len(r.tokens) for r in self._requests.values())
            stalls = 0 if after > before else stalls + 1
            if stalls > max_stalls:
                raise RuntimeError(
                    f"pool stalled: {sum(not r.finalized for r in self._requests.values())} "
                    f"request(s) unfinalized with no progress "
                    f"({len(self._live())} live replicas, "
                    f"{len(self._orphans)} orphans)")
        return self.results()

    # -- threaded serve loop -------------------------------------------------
    def start(self, pace_s: float = 0.0) -> None:
        """Launch one stepper thread per live replica: one replica's host
        work overlaps another's steps on the card (the GIL is released
        while a graph replays and while the host waits for tokens).
        ``pace_s`` sleeps between steps.  Replicas added later get
        threads from :meth:`serve_until_idle`'s control loop.  Precompile
        the replicas' step keys before this."""
        self._stop_evt.clear()
        self._pace_s = float(pace_s)
        self._ensure_threads()

    def _ensure_threads(self) -> None:
        for rep in self._live():
            t = self._threads.get(rep.label)
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._thread_loop,
                                     args=(rep,), daemon=True,
                                     name=f"ds-pool-{rep.label}")
                self._threads[rep.label] = t
                t.start()

    def _thread_loop(self, rep: _Replica) -> None:
        set_component(rep.label)
        while not self._stop_evt.is_set() and rep.alive:
            if not self._step_replica(rep):
                time.sleep(0.002)
            elif self._pace_s:
                time.sleep(self._pace_s)

    def serve_until_idle(self, timeout_s: float = 120.0) -> bool:
        """Control loop for the threaded mode: keeps threads covering
        the (possibly changing) membership, re-routes orphans, polls
        SLO advice; returns True once idle (False on timeout)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self._ensure_threads()
            self._flush_orphans()
            self._poll_advice()
            if self.idle:
                return True
            time.sleep(0.01)
        return False

    def stop(self) -> None:
        self._stop_evt.set()
        for t in self._threads.values():
            t.join(timeout=5.0)
        self._threads.clear()

    # -- migration -----------------------------------------------------------
    def _resubmit(self, req: PoolRequest,
                  exclude: Optional[str] = None) -> None:
        """Re-home one in-flight request with its committed prefix
        kept: the peer continues from ``prompt + tokens`` with the
        remaining token and TTL budgets.  Greedy continuations are
        tokenwise identical to the uninterrupted run; the committed
        prefix is preserved verbatim for every sampling mode."""
        stop = req.params.stop_token
        if (len(req.tokens) >= req.params.max_new_tokens
                or (stop is not None and req.tokens
                    and req.tokens[-1] == stop)):
            req.done = True       # finished exactly at the boundary
            req.finished_mono = req.finished_mono or time.monotonic()
            # the dead home never got to flush this journey (it
            # finished AT the migration boundary, with no survivor
            # scheduler to close it) — the pool is the only owner left
            if req.journey is not None:
                req.journey.mark("decode")
                _journey.get_journey_log().publish(req.journey, "ok")
            return
        prompt2 = (np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
            if req.tokens else req.prompt)
        params2 = dataclasses.replace(
            req.params,
            max_new_tokens=req.params.max_new_tokens - len(req.tokens))
        ttl = (max(req.deadline - time.monotonic(), 0.001)
               if req.deadline is not None else None)
        req.migrations += 1
        tm.POOL_MIGRATED.inc()
        # close the outage window (death/drain -> re-home) as one
        # "migrate" segment before the new home starts queue_wait
        if req.journey is not None:
            req.journey.mark("migrate")
        self._place(req, prompt2, params2, ttl, exclude=exclude)

    def scale_down(self, label: Optional[str] = None) -> Optional[str]:
        """Drain-and-migrate the emptiest replica (the SLO
        ``scale_down`` action): close admission, drain to committed
        state (tokens delivered through the pool ledger), serialize its
        requests via ``snapshot()``, redistribute each to a peer with
        partial tokens kept, and drop the replica.  Refuses below
        ``min_replicas`` or with fewer than two live replicas (the
        last replica has no peer to migrate into)."""
        live = self._live()
        if len(live) <= max(self.min_replicas, 1):
            return None
        if label is None:
            rep = min(live, key=lambda r: (r.scheduler.backlog, r.label))
        else:
            rep = self._replicas.get(label)
            if rep is None or not rep.alive:
                return None
        # survivors' hints must be fresh BEFORE re-homing: the whole
        # point of affinity migration is landing each request on the
        # peer already holding its prefix
        for peer in live:
            if peer.label != rep.label:
                self._publish_hints(peer)
        with rep.lock:
            rep.scheduler.close()
            bundle = rep.scheduler.snapshot(on_token=rep.deliver)
            rep.alive = False
        serialized = bundle["meta"]["requests"]
        moved = 0
        for rec in (serialized["pending"] + serialized["running"]
                    + serialized["preempted"]):
            req = self._requests.get(int(rec["uid"]))
            if req is None or req.finalized:
                continue
            self._resubmit(req, exclude=rep.label)
            moved += 1
        self._drop_replica(rep)
        tm.POOL_SCALE_DOWN.inc()
        get_flight_recorder().record("pool.scale_down", label=rep.label,
                                     migrated=moved)
        return rep.label

    def kill(self, label: str) -> None:
        """Abrupt replica death (test/demo control — the same path an
        ``InjectedPreemptionFault`` escaping a step takes): no drain,
        no snapshot; the pool resubmits every tracked request from its
        own token ledger."""
        rep = self._replicas.get(label)
        if rep is None or not rep.alive:
            return
        with rep.lock:
            rep.alive = False
        self._absorb_death(rep, reason="killed")

    def _absorb_death(self, rep: _Replica, reason: str) -> None:
        tm.POOL_REPLICA_DEATHS.inc()
        victims = [r for r in self._requests.values()
                   if r.replica == rep.label and not r.finalized]
        self._drop_replica(rep)
        get_flight_recorder().record("pool.replica_death",
                                     label=rep.label, reason=reason,
                                     inflight=len(victims))
        for req in victims:
            self._resubmit(req, exclude=rep.label)

    def _drop_replica(self, rep: _Replica) -> None:
        with self._lock:
            self._replicas.pop(rep.label, None)
            self._threads.pop(rep.label, None)
            if self._router is not None:
                self._router.forget(rep.label)
            tm.POOL_REPLICAS.set(len(self._live()))

    def _flush_orphans(self) -> None:
        with self._lock:
            if not self._orphans or not self._live():
                return
            orphans, self._orphans = self._orphans, []
        for uid in orphans:
            req = self._requests.get(uid)
            if req is not None and not req.finalized:
                self._resubmit(req)

    def _harvest_errors(self, rep: _Replica) -> None:
        """Mirror a replica's structured terminal errors into the pool
        ledger (shed/expired/poisoned/oom...), tokens = the FULL pool
        stream (the scheduler record only has post-migration tokens)."""
        if not rep.scheduler.errors:
            return
        for uid, err in list(rep.scheduler.errors.items()):
            req = self._requests.get(uid)
            if req is None or req.finalized or req.replica != rep.label:
                continue
            req.error = RequestError(uid=uid, code=err.code,
                                     message=err.message,
                                     tokens=list(req.tokens))
            req.finished_mono = time.monotonic()

    # -- SLO subscription ------------------------------------------------------
    def attach_slo(self, evaluator, cooldown_s: float = 5.0) -> None:
        """Subscribe to an SLO evaluator, any object whose ``current()``
        returns the JAX ``SLOEvaluator``'s verdict layout (``{"configured",
        "objectives": {name: {"status", "advice"}}}``): the step and serve
        loops poll it and apply page-verdict advice through
        :meth:`handle_advice` under a cooldown.  (Scale-down advice rides
        the flight recorder only: a controller tailing ``slo.advice``
        events calls ``handle_advice("scale_down")`` itself.)"""
        self._slo = evaluator
        self._slo_cooldown_s = float(cooldown_s)

    def _poll_advice(self) -> None:
        ev = self._slo
        if ev is None:
            return
        cur = ev.current()
        if not cur.get("configured"):
            return
        for v in cur.get("objectives", {}).values():
            if v.get("status") == "page" and v.get("advice"):
                self.handle_advice(v["advice"])

    def handle_advice(self, action: str) -> Optional[str]:
        """Apply one SLO advice action (``scale_up`` / ``scale_down`` /
        ``rebalance``) under the cooldown; returns what changed (new /
        removed label, pinned root) or None when the action was a
        no-op (cooldown, bounds, nothing to do)."""
        now = time.monotonic()
        if now - self._last_action_mono < self._slo_cooldown_s:
            return None
        result: Optional[str] = None
        if action == "scale_up":
            result = self.scale_up()
        elif action == "scale_down":
            result = self.scale_down()
        elif action == "rebalance":
            result = self.rebalance()
        if result is not None:
            self._last_action_mono = now
            get_flight_recorder().record("pool.advice_applied",
                                         action=action, result=result)
        return result

    def rebalance(self) -> Optional[str]:
        """Re-home the hottest digest group: pin the root digest most
        often routed to the most-loaded replica onto the least-loaded
        one (which warms its own cache on first arrival).  Returns the
        pinned root or None when the pool is already balanced."""
        # one backlog snapshot is the membership view — a replica dying
        # between two _live() reads must not KeyError the advice path
        backlogs = self._backlogs()
        if len(backlogs) < 2:
            return None
        hot = max(backlogs, key=lambda lb: (backlogs[lb], lb))
        cold = min(backlogs, key=lambda lb: (backlogs[lb], lb))
        if hot == cold:
            return None
        root = self._router.hottest_group(hot)
        if root is None:
            return None
        self._router.pin(root, cold)
        tm.POOL_REBALANCE.inc()
        get_flight_recorder().record("pool.rebalance", root=root,
                                     src=hot, dst=cold)
        return root

    # -- read side -----------------------------------------------------------
    @property
    def errors(self) -> Dict[int, RequestError]:
        return {uid: r.error for uid, r in self._requests.items()
                if r.error is not None}

    def results(self) -> Dict[int, List[int]]:
        return {uid: list(r.tokens)
                for uid, r in self._requests.items() if r.done}

    def request(self, uid: int) -> Optional[PoolRequest]:
        return self._requests.get(uid)

    def stats(self) -> Dict:
        reqs = list(self._requests.values())
        return {
            "replicas": self.labels,
            "requests": len(reqs),
            "completed": sum(r.done for r in reqs),
            "errors": sum(r.error is not None for r in reqs),
            "inflight": sum(not r.finalized for r in reqs),
            "migrated": sum(r.migrations > 0 for r in reqs),
            "orphans": len(self._orphans),
            "backlogs": self._backlogs(),
        }
