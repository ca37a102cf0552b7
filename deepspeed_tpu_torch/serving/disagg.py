"""Disaggregated prefill/decode serving.

Counterpart of ``deepspeed_tpu/serving/disagg.py``.  A
:class:`DisaggPool` runs two engines in one process: a prefill engine
(``serving.role = "prefill"``) runs prompt chunks and each request's
FIRST token, so TTFT never waits on a transfer, and a decode engine
(``role = "decode"``) runs the steady token loop with the async chained
decode and speculation.

The handoff: once a request's first token lands, the prefill scheduler
parks it handoff-ready and the pool streams it across:
``export_handoff(uids)`` (the sequences' committed pages through the
manager's selective ``export_state``, each page once, full prefix pages
with their chain digests, and each request's residual state), then
``import_handoff(bundle)`` on the decode side, which merges into the live
engine, attaching by reference every full page whose digest the decode
cache already indexes (``ds_disagg_pages_shared_total``), then
``complete_handoff``, which flushes the prefill side (its prefix pages
park in ITS cache).  The bundle is the snapshot codec's (meta, named
arrays), with host tensors as the arrays.

Backpressure is structured: an import the decode engine cannot hold yet
raises ``KVAllocationError`` without changing anything; the pool defers
and retries while the decode engine drains
(``ds_disagg_handoff_retry_total``), and a request that could never fit
an idle decode engine ends with an ``"oom"`` verdict.  With
``keyed_sampling`` on both engines (one base key) the two-engine output
is tokenwise the fused engine's; greedy needs no flag.  Each engine
captures its role's keys (``precompile(kinds=...)``): the decode engine
no Q>1 prefill key, the prefill engine no chain or spec key.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..inference.v2.ragged.blocked_allocator import KVAllocationError
from ..inference.v2.sampling import SamplingParams
from ..inference.v2.scheduler import FastGenScheduler, RequestError
from ..telemetry import journey as _journey
from ..telemetry import metrics as tm
from ..telemetry.flight_recorder import get_flight_recorder
from ..telemetry.tracer import set_component
from .pool import PoolRequest, _nbytes

#: deferred-import attempts against a BUSY decode pool before the pool
#: stops waiting for natural drain and fails the request structurally
#: (a busy pool frees pages as requests finish, so the common case
#: resolves in a few steps; the cap bounds pathological workloads)
_MAX_HANDOFF_RETRIES = 256


class DisaggPool:
    """One prefill engine + one decode engine behind a committed-page
    KV streaming handoff."""

    def __init__(self,
                 prefill_factory: Callable[[], FastGenScheduler],
                 decode_factory: Callable[[], FastGenScheduler],
                 on_token: Optional[Callable[[int, int], None]] = None,
                 handoff_every: int = 4,
                 manifest: Optional[Dict[str, list]] = None):
        """The factories build the two schedulers (engines must share
        model WEIGHTS for tokenwise-identical continuations and carry
        ``serving.role`` "prefill" / "decode" respectively — the role
        admission is what guarantees a misrouted request can never sit
        forever).  ``on_token`` taps the pool's stitched per-token
        delivery (a stream consumer).  ``handoff_every`` is the
        pump cadence in prefill steps: batching a few handoffs per
        import means fewer decode-membership changes, so the decode
        pool's async chain breaks once per BATCH instead of once per
        request (TTFT is unaffected — the first token already left the
        prefill pool; only that request's second token waits).
        ``manifest``: a per-role step-key manifest (``{"prefill": [...],
        "decode": [...]}``, the :meth:`compiled_manifest` of an earlier
        pool); with a compile cache active each engine captures its
        role's keys at birth, so a fresh pool serves its first handoff
        warm."""
        self.prefill = prefill_factory()
        self.decode = decode_factory()
        for sched, want in ((self.prefill, "prefill"),
                            (self.decode, "decode")):
            if sched.role != want:
                raise ValueError(
                    f"DisaggPool needs a role={want!r} scheduler, got "
                    f"role={sched.role!r} (set serving.role)")
        if manifest:
            # the gate of ReplicaPool._warm_new_replica
            from ..inference.v2.compile_cache import active_cache_dir
            if active_cache_dir() is None:
                warnings.warn("DisaggPool: no active compile cache; not "
                              "capturing the manifest at birth (engines "
                              "capture on first use)")
            else:
                for sched, role in ((self.prefill, "prefill"),
                                    (self.decode, "decode")):
                    keys = manifest.get(role) or []
                    if keys:
                        sched._engine.precompile_keys(keys)
        self.prefill.enable_handoff_sink()
        self._on_token = on_token
        self._requests: Dict[int, PoolRequest] = {}
        self._retries: Dict[int, int] = {}
        self._lock = threading.RLock()          # pool ledger
        self._plock = threading.RLock()         # prefill scheduler
        self._dlock = threading.RLock()         # decode scheduler
        #: serializes a whole pump (export -> import -> complete): the
        #: per-scheduler locks drop between those phases, and two
        #: pumping threads (stepper + serve_until_idle caller) would
        #: otherwise export the same parked uids and collide at import
        self._pump_lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pace_s = 0.0
        #: optional per-handoff wall-time tap (each handoff's ms, beside
        #: the ds_disagg_handoff_ms histogram; chip_smoke.py reads it)
        self._on_handoff_ms: Optional[Callable[[float], None]] = None
        #: wall seconds each pool spent INSIDE its own scheduler steps
        #: — the busy windows behind the per-pool MFU / HBM-rate
        #: numbers (pump time and the other pool's phases excluded:
        #: the claim is about what a specialized program mix does with
        #: its hardware while it runs, not about thread overlap)
        self.prefill_busy_s = 0.0
        self.decode_busy_s = 0.0
        # each engine's dispatched work at the pool's build: the rates
        # count only what this pool's busy windows dispatched
        self._work_base = {
            "prefill": self._dispatched_work(self.prefill),
            "decode": self._dispatched_work(self.decode)}
        self._handoff_every = max(int(handoff_every), 1)
        self._steps_since_pump = 0
        self._bind_backlog_gauge()
        get_flight_recorder().record(
            "disagg.build",
            prefill_pages=self.prefill._engine.model.kv_config.num_pages,
            decode_pages=self.decode._engine.model.kv_config.num_pages,
            keyed=bool(getattr(self.prefill._engine.model,
                               "keyed_sampling", False)))

    def compiled_manifest(self) -> Dict[str, list]:
        """Per-role compiled-key manifest of this pool — the
        ``manifest=`` input for spawning the next (warm-born) pool."""
        return {"prefill": [list(k) for k in
                            self.prefill._engine.compiled_keys()],
                "decode": [list(k) for k in
                           self.decode._engine.compiled_keys()]}

    def _bind_backlog_gauge(self) -> None:
        import weakref
        ref = weakref.ref(self.prefill)

        def _read(r=ref):
            sched = r()
            return sched.handoff_backlog if sched is not None else 0

        tm.DISAGG_HANDOFF_BACKLOG.bind(_read)

    # -- request lifecycle ---------------------------------------------------
    def submit(self, uid: int, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               ttl_s: Optional[float] = None) -> Optional[RequestError]:
        """Same contract as ``FastGenScheduler.submit``: None on
        acceptance, else the structured rejection verdict (also kept
        in :attr:`errors`).  Every request enters through the prefill
        pool; the handoff is the pool's concern, not the caller's."""
        params = params or SamplingParams()
        req = PoolRequest(uid=uid,
                          prompt=np.asarray(prompt, dtype=np.int32),
                          params=params, replica="prefill")
        req.submit_mono = time.monotonic()
        req.journey = _journey.mint(uid)
        if req.journey is not None:
            # disagg placement is static (everything enters prefill),
            # but the segment still closes submit -> admission handed
            # to the prefill scheduler, mirroring the pool's router leg
            req.journey.mark("placement", at="router")
        if ttl_s:
            req.deadline = req.submit_mono + float(ttl_s)
        with self._lock:
            old = self._requests.get(uid)
            if old is not None and not old.finalized:
                raise ValueError(f"uid {uid} is already live in the pool")
            self._requests[uid] = req
        with self._plock:
            verdict = self.prefill.submit(uid, req.prompt, params,
                                          ttl_s=ttl_s,
                                          journey=req.journey)
        if verdict is not None:
            req.error = RequestError(uid=uid, code=verdict.code,
                                     message=verdict.message,
                                     tokens=[])
            req.finished_mono = time.monotonic()
        return verdict

    def _deliver(self, uid: int, tok: int) -> None:
        """The stitched per-token delivery both schedulers feed: the
        pool ledger is the authoritative full stream (prefill pool
        contributes the first token, decode pool the rest)."""
        req = self._requests.get(uid)
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
        if self._on_token is not None:
            self._on_token(uid, int(tok))

    # -- the handoff pump ----------------------------------------------------
    def pump_handoffs(self) -> int:
        """Stream every handoff-ready request from the prefill pool to
        the decode pool; returns how many moved.  Import failures are
        backpressure, not errors: the batch splits to singles, singles
        defer while the decode pool still has work to drain, and only
        a request that cannot fit an IDLE decode pool (or exhausted
        the retry budget) fails with a structured verdict.  One pump
        runs at a time (export -> import -> complete is not atomic
        under the per-scheduler locks alone)."""
        with self._pump_lock:
            return self._pump_impl()

    def _pump_impl(self) -> int:
        with self._plock:
            # parked requests outlive the step loop (has_work excludes
            # them), so their TTL sweep runs here — a deadline passing
            # while awaiting collection still yields code="expired"
            self.prefill._expire_requests()
            uids = [u for u in self.prefill.handoff_ready_uids()
                    if not self._finalized(u)]
        if not uids:
            return 0
        moved = self._try_handoff(uids)
        if moved or len(uids) == 1:
            return moved
        # batch refused: try one by one so a single oversized request
        # can't wedge every other handoff behind it
        for u in uids:
            moved += self._try_handoff([u])
        return moved

    def _finalized(self, uid: int) -> bool:
        req = self._requests.get(uid)
        return req is not None and req.finalized

    def _try_handoff(self, uids: List[int]) -> int:
        t0 = time.perf_counter()
        with self._plock:
            uids = [u for u in uids
                    if u in self.prefill.handoff_ready_uids()]
            if not uids:
                return 0
            sm = self.prefill._engine.state_manager
            need = set()
            for u in uids:
                sd = sm.get_sequence(u)
                if sd is not None:
                    need.update(p for p in sd.pages if p)
        # cheap pre-check before the expensive export: a BUSY decode
        # pool whose schedulable page count can't possibly hold these
        # sequences defers WITHOUT re-copying their KV to host every
        # pump (optimistic — digest dedup only shrinks the need; an
        # idle pool, or an exhausted retry budget, always runs the
        # authoritative export+import, which fails structurally)
        with self._dlock:
            free = self.decode._engine.free_blocks
            decode_busy = self.decode.has_work
        if (decode_busy and len(need) > free
                and all(self._retries.get(u, 0) < _MAX_HANDOFF_RETRIES
                        for u in uids)):
            tm.DISAGG_HANDOFF_RETRY.inc()
            for u in uids:
                self._retries[u] = self._retries.get(u, 0) + 1
            return 0
        with self._plock:
            uids = [u for u in uids
                    if u in self.prefill.handoff_ready_uids()]
            if not uids:
                return 0
            bundle = self.prefill.export_handoff(uids)
        nbytes = _nbytes(bundle["arrays"])
        try:
            with self._dlock:
                stats = self.decode.import_handoff(bundle)
        except KVAllocationError as e:
            tm.DISAGG_HANDOFF_RETRY.inc()
            self._defer_or_fail(uids, e)
            return 0
        with self._plock:
            self.prefill.complete_handoff(uids)
        for u in uids:
            self._retries.pop(u, None)
            req = self._requests.get(u)
            if req is not None:
                req.replica = "decode"
                req.migrations += 1
        ms = (time.perf_counter() - t0) * 1e3
        tm.DISAGG_HANDOFFS.inc(len(uids))
        tm.DISAGG_HANDOFF_BYTES.inc(nbytes)
        tm.DISAGG_HANDOFF_MS.observe(ms)
        if self._on_handoff_ms is not None:
            self._on_handoff_ms(ms)
        tm.DISAGG_PAGES_STREAMED.inc(int(stats.get("pages_streamed", 0)))
        tm.DISAGG_PAGES_SHARED.inc(int(stats.get("pages_shared", 0)))
        get_flight_recorder().record(
            "disagg.handoff", uids=len(uids), bytes=nbytes,
            ms=round(ms, 2),
            pages_streamed=int(stats.get("pages_streamed", 0)),
            pages_shared=int(stats.get("pages_shared", 0)))
        return len(uids)

    def _defer_or_fail(self, uids: List[int], exc: Exception) -> None:
        """A refused import: defer while the decode pool can still
        free pages by draining; fail structurally once it cannot (or
        the retry budget is spent) — the satellite guarantee that no
        request ever sits forever."""
        with self._dlock:
            decode_busy = self.decode.has_work
        for u in uids:
            self._retries[u] = self._retries.get(u, 0) + 1
        if decode_busy and all(self._retries[u] < _MAX_HANDOFF_RETRIES
                               for u in uids):
            return
        if len(uids) > 1:
            return      # pump retries one-by-one before any verdict
        u = uids[0]
        with self._plock:
            req = self.prefill._handoff_ready.get(u)
            if req is not None:
                self.prefill._fail_request(
                    req, "oom",
                    "handoff refused: decode pool cannot hold this "
                    f"sequence's KV ({exc}); "
                    f"{self._retries.get(u, 0)} attempts")
        self._retries.pop(u, None)

    # -- stepping ------------------------------------------------------------
    def _step_prefill(self) -> bool:
        set_component("prefill")
        with self._plock:
            if not self.prefill.has_work:
                return False
            t0 = time.perf_counter()
            self.prefill.step(on_token=self._deliver)
            self.prefill_busy_s += time.perf_counter() - t0
            return True

    def _step_decode(self) -> bool:
        set_component("decode")
        with self._dlock:
            if not self.decode.has_work:
                return False
            t0 = time.perf_counter()
            self.decode.step(on_token=self._deliver)
            self.decode_busy_s += time.perf_counter() - t0
            return True

    def _pump_due(self, stepped: bool) -> bool:
        """Cadence gate: pump every ``handoff_every`` prefill steps,
        or immediately once the prefill pool has nothing left to run
        (nothing to batch against — don't sit on the backlog)."""
        if stepped:
            self._steps_since_pump += 1
        if not self.prefill.handoff_backlog:
            return False
        if not stepped or self._steps_since_pump >= self._handoff_every:
            self._steps_since_pump = 0
            return True
        return False

    def step(self) -> None:
        """Single-threaded drive: one prefill step, the handoff pump
        (on its cadence), one decode step, error harvest."""
        stepped = self._step_prefill()
        if self._pump_due(stepped):
            self.pump_handoffs()
        self._step_decode()
        self._harvest_errors()

    @property
    def idle(self) -> bool:
        return (not self.prefill.has_work
                and self.prefill.handoff_backlog == 0
                and not self.decode.has_work
                and all(r.finalized for r in self._requests.values()))

    def run_to_completion(self, max_stalls: int = 512
                          ) -> Dict[int, List[int]]:
        """Step until every submitted request is finalized; returns
        ``{uid: tokens}`` for completed requests (structured errors in
        :attr:`errors`)."""
        stalls = 0
        while not self.idle:
            before = sum(len(r.tokens) for r in self._requests.values())
            self.step()
            after = sum(len(r.tokens) for r in self._requests.values())
            stalls = 0 if after > before else stalls + 1
            if stalls > max_stalls:
                raise RuntimeError(
                    "disagg pool stalled: "
                    f"{sum(not r.finalized for r in self._requests.values())} "
                    f"request(s) unfinalized with no progress "
                    f"(prefill backlog {self.prefill.backlog}, "
                    f"handoff-ready {self.prefill.handoff_backlog}, "
                    f"decode backlog {self.decode.backlog})")
        self.refresh_cost_gauges()
        return self.results()

    # -- threaded serve loop (the ReplicaPool.start pattern) -----------------
    def start(self, pace_s: float = 0.0) -> None:
        """One stepper thread per engine (the GIL is released while a
        graph replays and while the host waits for tokens, so one
        engine's host work overlaps the other's steps); the prefill
        thread also pumps handoffs after its steps.  Precompile both
        engines' keys before this."""
        self._stop_evt.clear()
        self._pace_s = float(pace_s)
        for name, loop in (("prefill", self._prefill_loop),
                           ("decode", self._decode_loop)):
            t = threading.Thread(target=loop, daemon=True,
                                 name=f"ds-disagg-{name}")
            self._threads.append(t)
            t.start()

    def _prefill_loop(self) -> None:
        set_component("prefill")
        while not self._stop_evt.is_set():
            stepped = self._step_prefill()
            if self._pump_due(stepped):
                self.pump_handoffs()
            self._harvest_errors()
            if not stepped:
                time.sleep(0.002)
            elif self._pace_s:
                time.sleep(self._pace_s)

    def _decode_loop(self) -> None:
        set_component("decode")
        while not self._stop_evt.is_set():
            stepped = self._step_decode()
            if not stepped:
                time.sleep(0.002)
            elif self._pace_s:
                time.sleep(self._pace_s)

    def serve_until_idle(self, timeout_s: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.prefill.handoff_backlog:
                self.pump_handoffs()
            self._harvest_errors()
            if self.idle:
                self.refresh_cost_gauges()
                return True
            time.sleep(0.005)
        return False

    def stop(self) -> None:
        self._stop_evt.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    # -- read side -----------------------------------------------------------
    def _harvest_errors(self) -> None:
        """Mirror both schedulers' structured terminal errors into the
        pool ledger, with the FULL stitched token stream (a scheduler
        record only holds the tokens generated on ITS side)."""
        for sched in (self.prefill, self.decode):
            if not sched.errors:
                continue
            for uid, err in list(sched.errors.items()):
                req = self._requests.get(uid)
                if req is None or req.finalized:
                    continue
                req.error = RequestError(uid=uid, code=err.code,
                                         message=err.message,
                                         tokens=list(req.tokens))
                req.finished_mono = time.monotonic()

    def refresh_cost_gauges(self) -> Dict[str, float]:
        """Publish (and return) the per-engine cost facts over each
        engine's busy window: the prefill engine's MFU and the decode
        engine's memory GB/s (from the analytic step costs of
        ``model.cost_summary``), the ``ds_disagg_*`` gauges."""
        from ..inference.v2.model import serving_peak_flops
        pre_flops, _ = self._work_since_build("prefill")
        _, dec_bytes = self._work_since_build("decode")
        peak = serving_peak_flops()
        out = {
            "prefill_mfu": (pre_flops / max(self.prefill_busy_s, 1e-9)
                            / peak),
            "decode_hbm_gb_s": (dec_bytes / max(self.decode_busy_s, 1e-9)
                                / 1e9),
        }
        tm.DISAGG_PREFILL_MFU.set(out["prefill_mfu"])
        tm.DISAGG_DECODE_HBM_GB_S.set(out["decode_hbm_gb_s"])
        return out

    @staticmethod
    def _dispatched_work(sched: FastGenScheduler) -> tuple:
        cost = sched._engine.cost_summary()
        return (float(cost.get("flops_dispatched", 0.0)),
                float(cost.get("bytes_dispatched", 0.0)))

    def _work_since_build(self, role: str) -> tuple:
        """(FLOPs, bytes) ``role``'s engine dispatched since this pool
        was built (all of its window, if that was opened again since)."""
        now = self._dispatched_work(getattr(self, role))
        base = self._work_base[role]
        return tuple(n - b if n >= b else n for n, b in zip(now, base))

    @property
    def errors(self) -> Dict[int, RequestError]:
        self._harvest_errors()
        return {uid: r.error for uid, r in self._requests.items()
                if r.error is not None}

    def results(self) -> Dict[int, List[int]]:
        return {uid: list(r.tokens)
                for uid, r in self._requests.items() if r.done}

    def request(self, uid: int) -> Optional[PoolRequest]:
        return self._requests.get(uid)

    def stats(self) -> Dict:
        reqs = list(self._requests.values())
        self.refresh_cost_gauges()
        return {
            "requests": len(reqs),
            "completed": sum(r.done for r in reqs),
            "errors": sum(r.error is not None for r in reqs),
            "inflight": sum(not r.finalized for r in reqs),
            "handed_off": sum(r.replica == "decode" for r in reqs),
            "handoff_backlog": self.prefill.handoff_backlog,
            "prefill_backlog": self.prefill.backlog,
            "decode_backlog": self.decode.backlog,
            "prefill_cost": self.prefill._engine.cost_summary(),
            "decode_cost": self.decode._engine.cost_summary(),
        }
