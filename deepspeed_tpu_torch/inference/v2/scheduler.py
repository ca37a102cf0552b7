"""Continuous-batching scheduler (Dynamic SplitFuse).

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py``.  Every step
fills a fixed token budget: running decodes first (one token each), then
prompt *chunks* of admitted requests, so long prompts are split across
steps and fused with decodes.  Admission runs on incremental
page/token/sequence counters (``_Admission``), as in the JAX package.

With ``fused_step`` and ``on_device_sampling`` (the defaults) each step
is one ``InferenceEngineV2.step_sample`` (forward + on-device sampling),
and only int32 tokens reach the host.  With either flag off the step
takes the split escape hatch: ``put`` returns the [n, V] fp32 logits
and each group of requests that share (temperature, top_k, top_p) is
sampled from them in a call of its own outside the step, on the logits'
device, with one generator draw per stochastic group; only the int32
tokens reach the host, as on the fused path.  Under strict shapes a
step whose fused key was not precompiled (a mixed step, or a superbucket
outside the lattice) also serves split.

With ``async_scheduling`` (the default) the scheduler double-buffers: a
step of pure decodes whose rows all sat in the step still in flight is
dispatched as a chained step (its tokens gathered on the device) BEFORE
that step's tokens are read, so the host's work on step k+1 overlaps the
device's work on step k and tokens reach the host one step late.  A
request that stops at step k may have been chained past its stop token;
that extra token is discarded at the drain.  With ``prefix_caching``
(the default) each new request is matched once against the prefix cache
before its first admission and only its uncached suffix is prefilled.

With ``speculative`` (fused and on-device sampling only) a step of pure
decodes may speculate instead: the step in flight is drained, a drafter
proposes up to ``spec_max_draft`` tokens per row (``spec.py``: host
prompt lookup, or a draft trunk that drafts on the device inside the
step), one dispatch verifies them all, and the [S, 2] (or [S, 2+k]) int32
verdict, the step's only copy to the host, commits each row's accepted
block in the same step.  ``spec_drafter="auto"`` moves each request
between the drafters on its accept rate, and each request backs off its
own fruitless attempts.

When the KV pool runs short the scheduler degrades instead of failing:
when nothing is schedulable it preempts the running sequence with the
most private KV (its pages go to host memory) and resumes it once the
pool has room; a failed page allocation runs a ladder (reclaim parked
prefix pages, then preempt, then shed the most demanding request with a
structured ``"oom"`` error).  Requests may carry a TTL, admission may
be bounded (``max_queue_depth``, ``shed_queue_wait_ms``) and closed
(``close`` / ``reopen``); a request that ends without completing leaves
a :class:`RequestError` in ``errors``.

On an engine built with ``keyed_sampling`` every sampled row draws from
``fold_in(fold_in(key(seed), uid), position)`` (``sampling.sample_keyed``
on the fused steps, one call per parameter group on the split path): a
request's sampled tokens are the same whatever batch, step kind or
engine draws them, and equal to the JAX scheduler's for the same seed.

``snapshot`` drains the step in flight and writes the scheduler's whole
state (requests, KV pages, the prefix index, counters, errors) as a
bundle the JAX package reads too (``snapshot.py``); ``restore`` rebuilds
it in a fresh scheduler over a fresh engine and resumes tokenwise, and
``drain_and_snapshot`` is the SIGTERM body with its grace budget.

With the workload trace on (``telemetry/workload_trace.py``) every
request that ends, completed or with an error, leaves one content-free
record (lengths, page digests, parameters, TTFT / ITL / queue wait, the
speculation counts and the warm-prefix tokens by tier), the ledger a
mined lattice is mined from.

A scheduler has a role (``serving.role``): "both" serves whole
requests; a "prefill" scheduler runs prompts and each request's FIRST
token, then parks the request handoff-ready until a ``serving.
DisaggPool`` streams it (``export_handoff``: the committed pages through
the manager's selective export, and the request's residual state) to a
"decode" scheduler (``import_handoff``, which merges into the live
engine and admits nothing else).  A request a role can never finish is
refused at once with a ``"misrouted"`` verdict.

Telemetry (``telemetry/``, gated on one flag): each request carries a
journey from submit to its end, across handoffs, snapshots and pool
migrations; steps, dispatches and admissions are spans; lifecycle
events go to the flight recorder (which writes a postmortem bundle when
a step raises); the SLO histograms, the ``ds_fastgen_*`` counters and
the ``ds_disagg_*`` / speculation counters are fed as in the JAX
package.  Every step advances the ``ds_serving_*`` counters (a step,
the prompt tokens prefilled, the bytes copied to the host: the [S] int32
tokens at a drain, a verify step's verdict, the split path's sampled
groups), feeds its host time to the watchdog's anomaly detector, ticks
the time-series ring (interval-gated inside) and the memory ledger's
watermarks; a failed page allocation leaves a ``mem.breakdown`` flight
event naming the dominant subsystem and the ladder's rungs.  The
``serving.preempt`` fault-injection site raises
``InjectedPreemptionFault`` between steps, and ``fastgen.poison_request``
fails one request at admission with a ``"poisoned"`` verdict while the
step serves the rest.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...runtime.fault_injection import (InjectedPreemptionFault,
                                        PoisonedRequestFault,
                                        get_fault_injector)
from ...telemetry import journey as _journey
from ...telemetry import metrics as tm
from ...telemetry.flight_recorder import get_flight_recorder
from ...telemetry.memory import get_memory_ledger
from ...telemetry.state import state as _telemetry
from ...telemetry.timeseries import get_timeseries
from ...telemetry.tracer import get_tracer, trace_span
from ...telemetry.watchdog import get_watchdog
from ...telemetry.workload_trace import get_workload_trace
from ...utils.comms_logging import serving_counters
from .config import ServingOptimizationConfig
from .engine import InferenceEngineV2
from .ragged.blocked_allocator import NULL_PAGE, KVAllocationError
from .ragged.prefix_cache import PrefixCache
from .sampling import SamplingParams, derive_row_keys, sample, sample_keyed
from .snapshot import (SNAPSHOT_VERSION, SnapshotError,
                       maybe_install_drain_handler, read_bundle,
                       write_bundle)
from .spec import NgramDrafter
from .threefry import key_from_seed


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # int32 [prompt_len]
    params: SamplingParams
    #: tokens of the prompt already sent to the engine (or served from
    #: the prefix cache)
    prompt_sent: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: the one prefix-cache lookup has run
    prefix_checked: bool = False
    #: absolute ``time.monotonic()`` deadline; None = no TTL
    deadline: Optional[float] = None
    #: ``time.monotonic()`` at submit (the queue-wait shed reads it)
    submit_mono: float = 0.0
    #: ``time.monotonic()`` at the first admission, the first and the
    #: last token reaching the host (stamped while the workload trace is
    #: on: its queue wait, TTFT and ITL)
    first_sched_mono: float = 0.0
    first_token_mono: float = 0.0
    last_token_mono: float = 0.0
    #: the tokens the one prefix match attached, by tier of origin
    #: ({"device", "host", "disk", "remote"}); None: no hit
    tier_hits: Optional[dict] = None
    #: speculation: tokens drafted for this request and accepted
    spec_drafted: int = 0
    spec_accepted: int = 0
    #: its drafter state: the dry-spell streak and backoff window, the
    #: active drafter ("" = not chosen yet; "ngram", "model" or "off"),
    #: the accept-rate EWMA per drafter (-1.0 = untried), and the
    #: drafted / accepted counts split by drafter
    spec_dry: int = 0
    spec_cool: int = 0
    spec_drafter: str = ""
    spec_ewma: Optional[Dict[str, float]] = None
    spec_drafted_ngram: int = 0
    spec_accepted_ngram: int = 0
    spec_drafted_model: int = 0
    spec_accepted_model: int = 0
    #: SLO stamps (``time.perf_counter()``, stamped while telemetry is
    #: on; 0.0 = unset): submit, first admission, the last token, and
    #: the telemetry generation that last stamp was taken in
    submit_s: float = 0.0
    first_sched_s: float = 0.0
    last_token_s: float = 0.0
    slo_gen: int = 0
    #: the request's journey (``telemetry.journey.Journey``; None with
    #: telemetry off at submit), carried across handoffs, snapshots and
    #: pool migrations; ``journey_admitted`` latches this scheduler's
    #: queue_wait mark (a migrated request queues again on its new home)
    journey: Optional[object] = None
    journey_admitted: bool = False

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prompt_sent


@dataclasses.dataclass
class RequestError:
    """Why a request ended without completing.  ``code`` is one of
    ``"shed"`` (admission control: a full queue, a violated queue-wait
    SLO, or unservable demand), ``"expired"`` (its deadline passed),
    ``"oom"`` (the KV pool stayed exhausted after the degradation
    ladder, or a handoff the decode engine could never hold),
    ``"closing"`` (submitted after ``close``), ``"poisoned"`` (an
    exception attributable to this request at its admission, such as the
    ``fastgen.poison_request`` fault site; the step serves the rest),
    ``"migrated"`` (the
    drain's grace budget ran out before a snapshot) or ``"misrouted"``
    (the scheduler's role can never finish it: a fresh submit to a
    decode scheduler, or a multi-token submit to a prefill scheduler no
    handoff sink collects from).  ``tokens``
    holds what the request generated before it ended."""
    uid: int
    code: str
    message: str
    tokens: List[int] = dataclasses.field(default_factory=list)


#: the most verdicts ``FastGenScheduler.errors`` keeps (oldest go first)
_MAX_ERROR_RECORDS = 4096


@dataclasses.dataclass
class _Inflight:
    """A dispatched step whose tokens are not read yet: the device token
    array, its copy to host memory (pinned on the card, with the event
    that marks the copy done; the array itself on the CPU) and the (uid,
    output row, request) triples of its SAMPLED rows."""
    tokens_dev: torch.Tensor
    rows: List[Tuple[int, int, Request]]
    host: torch.Tensor
    copied: Optional[torch.cuda.Event]

    @classmethod
    def start(cls, tokens: torch.Tensor, rows) -> "_Inflight":
        """Start the token copy to the host right after the step is
        enqueued; reading it later waits for this step alone, not for a
        step enqueued after it."""
        if tokens.device.type == "cpu":
            return cls(tokens, rows, tokens, None)
        host = torch.empty(tokens.shape, dtype=tokens.dtype,
                           pin_memory=True)
        host.copy_(tokens, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return cls(tokens, rows, host, copied)


class _Admission:
    """Incremental per-step budget accounting mirroring the checks of
    ``InferenceEngineV2.can_schedule``."""

    def __init__(self, engine: InferenceEngineV2, token_budget: int):
        sm = engine._config.state_manager
        self.engine = engine
        self.free_pages = engine.free_blocks
        self.tokens_left = min(token_budget, sm.max_ragged_batch_size)
        self.seqs_left = sm.max_ragged_sequence_count
        self.tracked_left = (sm.max_tracked_sequences
                             - engine.state_manager.n_tracked_sequences)

    def try_admit(self, uid: int, n_tokens: int, is_new: bool) -> bool:
        if (self.seqs_left < 1 or self.tokens_left < n_tokens
                or (is_new and self.tracked_left < 1)):
            return False
        tokens, pages = self.engine.query(uid, n_tokens, self.free_pages)
        if tokens != n_tokens:
            return False
        self.free_pages -= pages
        self.tokens_left -= n_tokens
        self.seqs_left -= 1
        if is_new:
            self.tracked_left -= 1
        return True


def _group_key(p: SamplingParams) -> tuple:
    """Host-sampling group of a row: every greedy row shares one group
    whatever its top_k / top_p (they do nothing at temperature 0)."""
    if p.temperature <= 0.0:
        return (0.0, 0, 1.0)
    return (p.temperature, p.top_k, p.top_p)


class FastGenScheduler:
    """Drives an InferenceEngineV2 with the SplitFuse policy.  ``seed``
    seeds the ``torch.Generator`` (on the model's device) that the fused
    steps' sampled rows draw from, and the host generator of the split
    path; greedy-only steps touch neither.  On a keyed engine it is
    instead the base key, ``jax.random.key(seed)``, that every row key
    derives from (never split), so an equal seed draws the JAX
    scheduler's stream.  ``serving`` (default: the
    engine's) sets the step flags and the degradation knobs for this
    scheduler; its ``kv_quantization`` must be the engine's.  With
    ``DS_KV_DEBUG=1`` in the environment the KV page accounting is
    audited after every step.  ``role`` (default: the serving view's
    ``role``) is "both", "prefill" or "decode"."""

    def __init__(self, engine: InferenceEngineV2,
                 token_budget: Optional[int] = None, seed: int = 0,
                 serving: Optional[ServingOptimizationConfig] = None,
                 role: Optional[str] = None):
        self._engine = engine
        if serving is not None:
            serving.validate()
            built = engine.model.kv_config.quantization
            if (serving.kv_quantization or "none") != built:
                raise ValueError(
                    f"serving.kv_quantization={serving.kv_quantization!r} "
                    f"but the engine's cache was built as {built!r}; the "
                    f"page encoding is fixed at engine build")
        sv = serving if serving is not None else engine._config.serving
        self._serving = sv
        self._fused_cfg = bool(sv.fused_step and sv.on_device_sampling)
        self._async_cfg = bool(self._fused_cfg and sv.async_scheduling)
        self._prefix_cfg = bool(sv.prefix_caching)
        # -- disaggregated roles
        self._role = str(role if role is not None else (sv.role or "both"))
        if self._role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"unknown scheduler role {self._role!r} "
                "(expected both|prefill|decode)")
        if self._role == "prefill":
            # a prefill engine never decodes steadily: no chain (and no
            # speculation below); every request leaves after its first
            # token
            self._async_cfg = False
        #: prefill role: requests whose first token is delivered, parked
        #: until the DisaggPool collects them
        self._handoff_ready: Dict[int, Request] = {}
        #: a DisaggPool collects this prefill scheduler's handoffs (else
        #: a multi-token request could never finish here)
        self._handoff_sink = False
        #: latches of the strict-shapes check in ``_fused``
        self._fused_ready = False
        self._warned_strict_fallback = False
        self._kv_debug = os.environ.get("DS_KV_DEBUG", "") not in ("", "0")
        self._budget = (token_budget or
                        engine._config.state_manager.max_ragged_batch_size)
        self._generator = torch.Generator(device=engine.model.device)
        self._generator.manual_seed(seed)
        #: keyed sampling is fixed when the engine is built (it shapes
        #: the step inputs): follow the model, not the serving view
        self._keyed = bool(engine.model.keyed_sampling)
        #: the base key every row key derives from (int64 [2])
        self._base_key = key_from_seed(seed).numpy()
        self._inflight: Optional[_Inflight] = None
        self._pending: List[Request] = []     # waiting for first prefill
        self._running: Dict[int, Request] = {}
        self._preempted: Dict[int, Request] = {}  # KV offloaded to host
        self._preempted_this_step = False
        self.last_step_scheduled = 0
        #: steps taken (a bundle carries it across a restore)
        self._step_ordinal = 0
        self._max_queue_depth = int(sv.max_queue_depth or 0)
        self._shed_queue_wait_ms = float(sv.shed_queue_wait_ms or 0.0)
        self._default_ttl_s = float(sv.default_ttl_s or 0.0)
        self._shed_unservable = bool(sv.shed_unservable)
        #: structured verdicts of requests that ended without completing
        self.errors: Dict[int, RequestError] = {}
        #: a live request carries a deadline (else no step scans for one)
        self._has_deadlines = False
        #: consecutive steps lost to a failed page allocation (the
        #: degradation ladder climbs with it)
        self._oom_streak = 0
        self._closed = False
        # speculation
        self._spec_max_draft = max(int(sv.spec_max_draft or 0), 0)
        self._drafter = (NgramDrafter(max(int(sv.spec_ngram_min or 1), 1))
                         if sv.speculative and self._spec_max_draft
                         and self._role != "prefill" else None)
        #: "ngram", "model" or "auto": the policy (the scheduler's view)
        self._spec_drafter_cfg = str(sv.spec_drafter or "ngram")
        #: the engine built a draft trunk: the capability ("model" or
        #: "auto" on an engine without one serve the n-gram drafter)
        self._draft_ok = bool(self._drafter is not None
                              and engine.draft_enabled)
        #: latches of the strict-shapes check in ``_spec_on``
        self._spec_strict_ready = False
        self._warned_strict_spec = False
        #: drafted / accepted tokens over every drafter, and the draft
        #: trunk's share of them
        self._spec_drafted_cum = 0
        self._spec_accepted_cum = 0
        self._spec_draft_drafted_cum = 0
        self._spec_draft_accepted_cum = 0
        #: verify dispatches, and the tokens they committed
        self._spec_steps = 0
        self._spec_committed_cum = 0
        #: drafter switches of "auto", by (from, to) (each also a
        #: ``spec.drafter_switch`` flight event)
        self.spec_switches: Counter = Counter()
        # snapshots: the SIGTERM drain path with its grace budget
        self._snapshot_grace_s = float(sv.snapshot_grace_s or 0.0)
        self._snapshot_path = str(sv.snapshot_path or "")
        self._wtrace = get_workload_trace()
        self._tseries = get_timeseries()
        self._mledger = get_memory_ledger()
        self._bind_gauges()
        if self._snapshot_path:
            maybe_install_drain_handler(self, self._snapshot_path,
                                        self._snapshot_grace_s)

    def _bind_gauges(self) -> None:
        """The backlog gauges read the live queues at scrape time, and the
        memory ledger's ``staging`` accountant this scheduler's handoff
        staging (the newest scheduler of the process owns them; through a
        weakref, so the registry keeps no discarded scheduler alive)."""
        import weakref
        ref = weakref.ref(self)

        def read(attr):
            def _read(r=ref, a=attr):
                sched = r()
                return len(getattr(sched, a)) if sched is not None else 0
            return _read

        tm.FASTGEN_QUEUE_DEPTH.bind(read("_pending"))
        tm.FASTGEN_RUNNING.bind(read("_running"))
        tm.FASTGEN_PREEMPTED.bind(read("_preempted"))
        self._mledger.register_object("staging", self,
                                      lambda sched: sched.staging_bytes)

    @property
    def staging_bytes(self) -> int:
        """KV bytes the handoff-ready sequences hold while they wait for
        the decode engine: committed capacity the allocator cannot take
        back (a stuck handoff shows as growing staging, not as mystery
        KV pressure)."""
        kv = self._engine.model.kv_config
        state = self._engine.state_manager
        total = 0
        for uid, req in list(self._handoff_ready.items()):
            sd = state.get_sequence(uid)
            toks = sd.seen_tokens if sd is not None else len(req.prompt)
            total += -(-int(toks) // kv.page_size) * kv.bytes_per_page
        return total

    # -- request lifecycle ---------------------------------------------------
    def submit(self, uid: int, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               ttl_s: Optional[float] = None,
               journey: Optional[object] = None) -> Optional[RequestError]:
        """Queue a request.  Returns None when it is accepted, else the
        :class:`RequestError` that rejects it at once (also kept in
        ``errors``): the scheduler is closed (``"closing"``), its role
        can never finish the request (``"misrouted"``), the queue holds
        ``max_queue_depth`` requests, or the oldest pending request has
        waited past ``shed_queue_wait_ms`` while the queue-wait histogram
        does not veto it (``"shed"``).  ``ttl_s`` (default: the config's
        ``default_ttl_s``) sets a deadline past which the request ends
        with an ``"expired"`` error.  ``journey`` is the caller's journey
        of the request (a pool's); without one a journey is minted here
        (None with telemetry off)."""
        now = time.monotonic()
        req = Request(uid=uid, prompt=np.asarray(prompt, dtype=np.int32),
                      params=params or SamplingParams(), submit_mono=now)
        req.journey = (journey if journey is not None
                       else _journey.mint(uid))
        if self._closed:
            return self._reject_submit(
                req, "closing", "scheduler is closed to new requests "
                "(drain or shutdown); resubmit elsewhere")
        # a request the role can never finish is refused at once, never
        # left in a queue nothing drains
        if self._role == "decode":
            return self._reject_submit(
                req, "misrouted", "decode-only scheduler: fresh requests "
                "need prefill; submit to the prefill engine (this one "
                "admits handoff imports only)")
        if self._role == "prefill" and not self._handoff_sink \
                and req.params.max_new_tokens > 1:
            return self._reject_submit(
                req, "misrouted", "prefill-only scheduler with no handoff "
                f"sink: max_new_tokens={req.params.max_new_tokens} could "
                "never complete here (only the first token is produced by "
                "the prefill engine)")
        ttl = ttl_s if ttl_s is not None else (self._default_ttl_s or None)
        if ttl:
            req.deadline = now + float(ttl)
            self._has_deadlines = True
        if _telemetry.enabled:
            req.submit_s = time.perf_counter()
        if self._max_queue_depth and \
                len(self._pending) >= self._max_queue_depth:
            return self._reject_submit(
                req, "shed", f"admission queue full ({len(self._pending)} "
                f"pending >= max_queue_depth={self._max_queue_depth})")
        if self._shed_queue_wait_ms > 0.0 and self._pending:
            # the current backlog decides; the queue-wait histogram,
            # cumulative over the process, may only veto (a fresh
            # backlog in a healthy period is not shed for a burst long
            # ago) once it has data
            h = tm.FASTGEN_QUEUE_WAIT_MS
            oldest_ms = (now - self._pending[0].submit_mono) * 1e3
            if oldest_ms > self._shed_queue_wait_ms and (
                    h.count < 8
                    or h.percentile(90.0) > self._shed_queue_wait_ms):
                return self._reject_submit(
                    req, "shed", f"queue-wait SLO "
                    f"{self._shed_queue_wait_ms:.1f}ms violated (oldest "
                    f"pending {oldest_ms:.1f}ms, observed p90 "
                    f"{h.percentile(90.0):.1f}ms over {h.count} samples)")
        if self._is_live(uid):
            raise ValueError(f"request {uid} is already live")
        self._pending.append(req)
        return None

    def _is_live(self, uid: int) -> bool:
        return (uid in self._running or uid in self._preempted
                or uid in self._handoff_ready
                or any(r.uid == uid for r in self._pending))

    def _reject_submit(self, req: Request, code: str,
                       message: str) -> RequestError:
        """Reject a submit at once.  A live request with the same uid (a
        client retrying its uid) keeps its place, pages and eventual
        verdict: the verdict of the new submit is returned but not
        stored."""
        if self._is_live(req.uid):
            tm.FASTGEN_SHED.inc()
            get_flight_recorder().record(
                "request.error", uid=req.uid, code=code,
                message=message[:200], tokens=0, duplicate=True)
            return RequestError(uid=req.uid, code=code, message=message)
        self._fail_request(req, code, message)
        return self.errors[req.uid]

    def _fail_request(self, req: Request, code: str, message: str) -> None:
        """End ``req`` with a structured error: it leaves every queue,
        its engine state is flushed, and its tokens so far stay on the
        record.  A row of it still in flight is dropped at the drain
        (``req.done``, as past a stop token)."""
        req.done = True
        self._pending = [r for r in self._pending if r.uid != req.uid]
        self._running.pop(req.uid, None)
        self._preempted.pop(req.uid, None)
        self._handoff_ready.pop(req.uid, None)
        if self._engine.state_manager.get_sequence(req.uid) is not None:
            self._engine.flush(req.uid)
        if self._drafter is not None:
            self._drafter.drop(req.uid)
        self.errors[req.uid] = RequestError(
            uid=req.uid, code=code, message=message,
            tokens=list(req.generated))
        while len(self.errors) > _MAX_ERROR_RECORDS:
            self.errors.pop(next(iter(self.errors)))   # the oldest
        if code in ("shed", "closing"):
            tm.FASTGEN_SHED.inc()       # "closing" is admission control too
        elif code == "misrouted":
            tm.DISAGG_MISROUTED.inc()
        elif code == "expired":
            tm.FASTGEN_EXPIRED.inc()
        elif code == "migrated":
            tm.FASTGEN_MIGRATED.inc()
        else:
            tm.FASTGEN_REQUEST_ERROR.inc()
        get_flight_recorder().record(
            "request.error", uid=req.uid, code=code,
            message=message[:200], tokens=len(req.generated))
        # the journey closes first, so the ledger record sees its buckets
        self._journey_finish(req, code)
        if self._wtrace.active:
            self._trace_finish(req, code)   # the outcome is the error code

    def _journey_finish(self, req: Request, outcome: str) -> None:
        """Close and publish the request's journey, once (a prefill-side
        copy whose request finished on the decode engine is already
        closed)."""
        j = req.journey
        if j is None or j.closed:
            return
        if req.generated:
            # first token -> last committed token; a request that ended
            # before any token folds straight into drain
            j.mark("decode")
        j.mark("drain")
        _journey.get_journey_log().publish(j, outcome)

    # -- the workload trace ----------------------------------------------------
    def _trace_finish(self, req: Request, outcome: str) -> None:
        """One ended request into the workload trace: lengths, the
        parameters, latencies and the prompt's chained page digests (the
        prefix cache's hash), never a token id.  Callers check
        ``self._wtrace.active``."""
        page = self._engine.model.kv_config.page_size
        prompt = np.asarray(req.prompt)
        digests: List[str] = []
        if outcome not in ("shed", "closing"):
            # a request refused at submit never reached the engine; its
            # O(prompt) chain is skipped on that fast path
            d = b""
            for i in range(len(prompt) // page):
                d = PrefixCache.chain(d, prompt[i * page:(i + 1) * page])
                digests.append(d.hex())
        n = len(req.generated)
        p = req.params
        hits = req.tier_hits or {}
        self._wtrace.record_request(
            uid=req.uid, arrival_mono=req.submit_mono,
            prompt_len=len(prompt), gen_len=n, digests=digests,
            page_size=page,
            vocab_size=int(self._engine.model.cfg.vocab_size),
            temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
            max_new_tokens=p.max_new_tokens, outcome=outcome,
            ttft_ms=((req.first_token_mono - req.submit_mono) * 1e3
                     if req.first_token_mono else None),
            itl_ms=((req.last_token_mono - req.first_token_mono) * 1e3
                    / (n - 1)
                    if n > 1 and req.first_token_mono else None),
            queue_wait_ms=((req.first_sched_mono - req.submit_mono) * 1e3
                           if req.first_sched_mono else None),
            spec_drafted=req.spec_drafted,
            spec_accepted=req.spec_accepted,
            spec_drafter=req.spec_drafter,
            spec_ngram=[req.spec_drafted_ngram, req.spec_accepted_ngram],
            spec_model=[req.spec_drafted_model, req.spec_accepted_model],
            hit_device=hits.get("device", 0), hit_host=hits.get("host", 0),
            hit_disk=hits.get("disk", 0), hit_remote=hits.get("remote", 0),
            journey_ms=(req.journey.bucket_ms()
                        if req.journey is not None and req.journey.segments
                        else None))

    def _expire_requests(self) -> None:
        """End every request whose deadline has passed: pending, running
        and preempted alike."""
        if not self._has_deadlines:
            return
        now = time.monotonic()
        expired = [r for r in (self._pending + list(self._running.values())
                               + list(self._preempted.values())
                               + list(self._handoff_ready.values()))
                   if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self._fail_request(
                req, "expired", f"deadline passed ({len(req.generated)} "
                f"tokens generated, {req.prefill_remaining} prompt tokens "
                "unprefilled)")

    @property
    def has_work(self) -> bool:
        return bool(self._pending or self._running or self._preempted
                    or self._inflight is not None)

    @property
    def backlog(self) -> int:
        """Live requests: pending + running + preempted."""
        return (len(self._pending) + len(self._running)
                + len(self._preempted))

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop admission: every later ``submit`` ends at once with a
        ``"closing"`` error.  Live requests keep being served."""
        self._closed = True

    def reopen(self) -> None:
        """Resume admission after ``close`` (an aborted scale-down; the
        engine state is untouched by closing)."""
        self._closed = False
        get_flight_recorder().record("fastgen.reopen", backlog=self.backlog)

    @property
    def _fused(self) -> bool:
        """Fused serving, unless the engine is strict and precompiled no
        sample key: strict means "serve only captured steps", so such a
        scheduler serves split (warned once)."""
        if not self._fused_cfg:
            return False
        model = self._engine.model
        if not model.strict_shapes or self._fused_ready:
            return True
        if self._warned_strict_fallback:
            return False
        if any(len(k) > 4 and k[4] == "sample" for k in model._step_cache):
            self._fused_ready = True
            return True
        warnings.warn(
            "strict_shapes engine has no precompiled sample keys: this "
            "scheduler serves through the split path; precompile with "
            "sampling=True for the fused step")
        self._warned_strict_fallback = True
        return False

    @property
    def _async(self) -> bool:
        return self._async_cfg and self._fused

    def _strict_key_ok(self, uids, tokens, suffix: tuple,
                       min_q: int = 1) -> bool:
        """Under strict shapes a step goes where its predicted key was
        captured: bucket rounding can form a key the lattice skips (S * Q
        past the token budget) even when the tokens fit.  ``min_q`` is
        the spec Q bucket for the spec suffixes."""
        model = self._engine.model
        if not model.strict_shapes:
            return True
        return (self._engine.predict_step_key(uids, tokens, suffix,
                                              min_q=min_q)
                in model._step_cache)

    @property
    def _rng(self):
        """What a sampling step draws from: the base key on a keyed
        engine (never split, so the stream does not depend on the step
        count), else the generator, which greedy-only steps leave as it
        is."""
        return self._base_key if self._keyed else self._generator

    # -- delivery ------------------------------------------------------------
    def _deliver_token(self, req: Request, tok: int, out: Dict[int, int],
                       on_token) -> bool:
        """Append one token and deliver it; True when it ends the
        request (``max_new_tokens`` reached or the stop token)."""
        req.generated.append(tok)
        # unconditional, like the JAX package's: the windowed tok/s
        # numerator exists with telemetry off
        tm.FASTGEN_TOKENS.inc()
        if _telemetry.enabled:
            self._note_token_slo(req)
        if self._wtrace.active:
            mono = time.monotonic()
            if req.first_token_mono == 0.0:
                req.first_token_mono = mono
            req.last_token_mono = mono
        if req.journey is not None and len(req.generated) == 1:
            # the first committed token closes prefill (marked on the
            # prefill side only: an imported request arrives with tokens)
            req.journey.mark("prefill")
            req.journey.mark("first_token")
        out[req.uid] = tok
        if on_token is not None:
            on_token(req.uid, tok)
        stop = req.params.stop_token
        return (len(req.generated) >= req.params.max_new_tokens
                or (stop is not None and tok == stop))

    def _note_token_slo(self, req: Request) -> None:
        """One host-visible token: the first feeds TTFT (from submit),
        the later ones the inter-token latency, when the previous stamp
        was taken in this telemetry generation."""
        now = time.perf_counter()
        if len(req.generated) == 1:
            if req.submit_s:
                tm.FASTGEN_TTFT_MS.observe((now - req.submit_s) * 1e3)
        elif req.last_token_s and req.slo_gen == _telemetry.generation:
            tm.FASTGEN_ITL_MS.observe((now - req.last_token_s) * 1e3)
        req.last_token_s = now
        req.slo_gen = _telemetry.generation

    def _finish_request(self, req: Request) -> None:
        req.done = True
        get_flight_recorder().record("request.done", uid=req.uid,
                                     tokens=len(req.generated))
        self._engine.flush(req.uid)
        self._running.pop(req.uid, None)
        if self._drafter is not None:
            self._drafter.drop(req.uid)
        self._journey_finish(req, "ok")
        if self._wtrace.active:
            self._trace_finish(req, "ok")

    # -- drain: read a dispatched step's tokens -------------------------------
    def _drain(self, on_token) -> Dict[int, int]:
        if self._inflight is None:
            return {}
        with trace_span("fastgen.drain"):
            return self._drain_impl(on_token)

    def _drain_impl(self, on_token) -> Dict[int, int]:
        inf, self._inflight = self._inflight, None
        if inf.copied is not None:
            inf.copied.synchronize()
        toks = inf.host.numpy()                # the one [S] int32 d2h
        serving_counters.record_d2h(toks.nbytes)
        out: Dict[int, int] = {}
        for uid, row, req in inf.rows:
            if req.done:
                # chained past a stop token (or ended with an error): the
                # extra token is dropped (its KV write landed in pages
                # the flush released)
                continue
            if self._deliver_token(req, int(toks[row]), out, on_token):
                self._finish_request(req)
        return out

    # -- double buffer: the chained decode step -------------------------------
    def _plan_chain(self) -> Optional[List[Tuple[int, int, Request]]]:
        """Rows of a chained decode step, or None when this step cannot
        chain (admissions pending, preempted requests waiting, mid-prefill
        rows, a request the step in flight does not hold, KV pressure, or
        under strict shapes a key that was not precompiled) and takes the
        host path."""
        if not self._async or self._inflight is None:
            return None
        if self._pending or self._preempted:
            return None
        slot = {uid: row for uid, row, _ in self._inflight.rows}
        adm = _Admission(self._engine, self._budget)
        rows = []
        for uid, req in self._running.items():
            if req.prefill_remaining > 0 or uid not in slot:
                return None
            if len(req.generated) + 1 >= req.params.max_new_tokens:
                continue  # the token in flight is its last
            if not adm.try_admit(uid, 1, is_new=False):
                return None     # the host path preempts
            rows.append((uid, slot[uid], req))
        if not rows:
            return None
        one = np.zeros(1, np.int32)
        if not self._strict_key_ok(
                [u for u, _, _ in rows], [one] * len(rows),
                ("chain", int(self._inflight.tokens_dev.shape[0]),
                 all(r.params.temperature <= 0.0 for _, _, r in rows))):
            return None
        return rows

    def _dispatch_chain(self, rows) -> _Inflight:
        uids = [u for u, _, _ in rows]
        # keyed: the chained step samples the token AFTER the one in
        # flight (that one, not drained yet, is index len(generated))
        row_pos = ([len(req.generated) + 1 for _, _, req in rows]
                   if self._keyed else None)
        toks = self._engine.step_decode_chained(
            uids, self._inflight.tokens_dev, [r for _, r, _ in rows],
            [req.params for _, _, req in rows], self._rng, row_pos=row_pos)
        self.last_step_scheduled = len(uids)
        return _Inflight.start(
            toks, [(u, i, req) for i, (u, _, req) in enumerate(rows)])

    # -- speculative decoding -------------------------------------------------
    #: after N fruitless attempts in a row (nothing drafted, or nothing
    #: accepted) a request speculates again at most every N + 1 steps
    _SPEC_BACKOFF_MAX = 8
    #: smoothing of the per-drafter accept-rate EWMA
    _SPEC_EWMA_ALPHA = 0.3
    #: "auto" moves a request off its drafter when the drafter's EWMA is
    #: below this after >= _SPEC_MIN_TRIES drafted tokens (or after that
    #: many dry attempts in a row)
    _SPEC_SWITCH_BELOW = 0.25
    _SPEC_MIN_TRIES = 4

    @property
    def _spec_on(self) -> bool:
        """Speculation is served: a drafter, the fused step, and under
        strict shapes a captured spec key (a strict engine without one
        latches speculation off for this scheduler, warned once, so no
        step drains and drafts only to fail the key check)."""
        if self._drafter is None or not self._fused:
            return False
        model = self._engine.model
        if not model.strict_shapes or self._spec_strict_ready:
            return True
        if self._warned_strict_spec:
            return False
        if any(len(k) > 4 and k[4] in ("spec", "draft_spec")
               for k in model._step_cache):
            self._spec_strict_ready = True
            return True
        warnings.warn(
            "strict_shapes engine has no precompiled speculative keys: "
            "speculation is off for this scheduler; precompile with "
            "sampling=True on an engine with serving.speculative=True (or "
            "pass spec_max_draft) to serve it")
        self._warned_strict_spec = True
        return False

    def _spec_gate(self) -> bool:
        """A step may speculate: pure steady-state decode, and a request
        out of its backoff whose drafter is not "off".  An attempt costs
        the async overlap (the step in flight drains first), so each
        request's fruitless attempts back off; the cooldowns tick here,
        once a step."""
        if not self._spec_on or self._pending or self._preempted \
                or not self._running:
            return False
        if any(r.prefill_remaining > 0 for r in self._running.values()):
            return False
        eligible = False
        for req in self._running.values():
            if req.spec_cool > 0:
                req.spec_cool -= 1
                continue
            if self._drafter_of(req) != "off":
                eligible = True
        return eligible

    def _drafter_of(self, req: Request) -> str:
        """The request's drafter, chosen at its first attempt: the
        configured one ("model" or "auto" without a draft trunk serve
        "ngram"; "auto" starts on "ngram").  Under "auto" a request
        parked "off" whose backoff ran out tries its best drafter by
        EWMA again."""
        if not req.spec_drafter:
            mode = self._spec_drafter_cfg
            if mode in ("model", "auto") and not self._draft_ok:
                mode = "ngram"
            req.spec_drafter = "ngram" if mode == "auto" else mode
            req.spec_ewma = {"ngram": -1.0, "model": -1.0}
        if (req.spec_drafter == "off" and req.spec_cool == 0
                and self._spec_drafter_cfg == "auto"):
            ew = req.spec_ewma or {}
            cands = ("ngram", "model") if self._draft_ok else ("ngram",)
            self._switch_drafter(
                req, max(cands, key=lambda k: ew.get(k, -1.0)))
        return req.spec_drafter

    def _switch_drafter(self, req: Request, new: str) -> None:
        old = req.spec_drafter
        self.spec_switches[(old, new)] += 1
        req.spec_drafter = new
        if new == "off":
            # parked for one full backoff window, then re-probed
            req.spec_dry = req.spec_cool = self._SPEC_BACKOFF_MAX
        else:
            req.spec_dry = req.spec_cool = 0
        ew = req.spec_ewma or {}
        get_flight_recorder().record(
            "spec.drafter_switch", uid=req.uid, src=old, dst=new,
            ewma_ngram=round(ew.get("ngram", -1.0), 3),
            ewma_model=round(ew.get("model", -1.0), 3))

    def _maybe_switch_drafter(self, req: Request) -> None:
        """The "auto" state machine: ngram -> model when the n-gram
        drafter does not pay (a low EWMA over enough drafts, or a dry
        spell), model -> off when the draft trunk does not either."""
        if self._spec_drafter_cfg != "auto":
            return
        ew = req.spec_ewma or {}

        def bad(name: str, tried: int) -> bool:
            return ((tried >= self._SPEC_MIN_TRIES
                     and 0.0 <= ew.get(name, -1.0) < self._SPEC_SWITCH_BELOW)
                    or req.spec_dry >= self._SPEC_MIN_TRIES)

        if req.spec_drafter == "ngram" and self._draft_ok \
                and bad("ngram", req.spec_drafted_ngram):
            self._switch_drafter(req, "model")
        elif req.spec_drafter == "model" \
                and bad("model", req.spec_drafted_model):
            self._switch_drafter(req, "off")

    def _note_spec_dry(self, req: Request) -> None:
        """One attempt that drafted nothing: the backoff grows."""
        req.spec_dry += 1
        req.spec_cool = min(req.spec_dry, self._SPEC_BACKOFF_MAX)
        self._maybe_switch_drafter(req)

    def _note_spec_result(self, req: Request, drafter: str, drafted: int,
                          accepted: int) -> None:
        """Account one verified block: the totals, the drafter's split,
        its EWMA and the backoff (reset by any acceptance)."""
        req.spec_drafted += drafted
        req.spec_accepted += accepted
        if drafter == "model":
            req.spec_drafted_model += drafted
            req.spec_accepted_model += accepted
        else:
            req.spec_drafted_ngram += drafted
            req.spec_accepted_ngram += accepted
        if accepted:
            req.spec_dry = req.spec_cool = 0
        else:
            req.spec_dry += 1
            req.spec_cool = min(req.spec_dry, self._SPEC_BACKOFF_MAX)
        if drafted:
            if req.spec_ewma is None:
                req.spec_ewma = {"ngram": -1.0, "model": -1.0}
            rate = accepted / drafted
            prev = req.spec_ewma.get(drafter, -1.0)
            req.spec_ewma[drafter] = (
                rate if prev < 0.0
                else (1.0 - self._SPEC_EWMA_ALPHA) * prev
                + self._SPEC_EWMA_ALPHA * rate)
        self._maybe_switch_drafter(req)

    def _plan_spec(self):
        """The drafter mode and rows of one speculative step, after the
        step in flight drained.  One step runs one mode: any eligible row
        on the draft trunk pulls the step into "model" (the others ride
        as plain q_len=1 rows).  Returns ("ngram" | "model", rows) with
        rows ``[(uid, req, tokens, draft), ...]``, ("fill", [(uid,
        tokens), ...]) when the draft pool must catch up first, or None
        (nothing drafted, the budget refused, or under strict shapes no
        captured key) for the normal path."""
        mode = "ngram"
        for req in self._running.values():
            if req.spec_cool == 0 and self._drafter_of(req) == "model":
                mode = "model"
                break
        if mode == "model":
            # every row rides the one step, so any row the draft pool does
            # not cover holds the whole step back
            lagged = [(u, r) for u, r in self._running.items()
                      if self._engine.draft_lag(u) > 0]
            if lagged:
                fill = self._plan_draft_fill(lagged)
                if fill is not None:
                    return ("fill", fill)
                mode = "ngram"
            if mode == "model":
                plan = self._plan_spec_mode("model")
                if plan is not None:
                    return ("model", plan)
                mode = "ngram"
        plan = self._plan_spec_mode(mode)
        return (mode, plan) if plan is not None else None

    def _plan_spec_mode(self, mode: str):
        """Every running row as ``[last_committed, draft...]`` (the draft
        possibly empty); in "model" mode the draft is placeholder zeros
        whose length shapes the row."""
        adm = _Admission(self._engine, self._budget)
        max_seq = int(self._engine.model.cfg.max_seq_len)
        rows, any_draft = [], False
        for uid, req in self._running.items():
            drafts_here = (req.spec_cool == 0
                           and self._drafter_of(req) == mode)
            # room for the corrected token and the drafts, never past
            # max_new_tokens or the model's context
            room = min(self._spec_max_draft,
                       req.params.max_new_tokens - len(req.generated) - 1,
                       max_seq - self._engine.seen_tokens(uid) - 2) \
                if drafts_here else 0
            if room > 0 and mode == "model":
                draft = np.zeros(room, np.int32)
            elif room > 0:
                draft = self._drafter.propose(uid, req.prompt,
                                              req.generated, room)
                if not len(draft):
                    self._note_spec_dry(req)
            else:
                draft = np.zeros(0, np.int32)
            last = (req.generated[-1] if req.generated
                    else int(req.prompt[-1]))
            toks = np.concatenate([np.asarray([last], np.int32), draft])
            if not adm.try_admit(uid, len(toks), is_new=False):
                # a plain decode row before giving the step up
                if len(toks) > 1 and adm.try_admit(uid, 1, is_new=False):
                    toks, draft = toks[:1], draft[:0]
                else:
                    return None     # the normal path preempts
            any_draft = any_draft or bool(len(draft))
            rows.append((uid, req, toks, draft))
        if not rows or not any_draft:
            return None
        greedy_only = all(req.params.temperature <= 0.0
                          for _, req, _, _ in rows)
        suffix = ("draft_spec" if mode == "model" else "spec", greedy_only)
        if not self._strict_key_ok([u for u, _, _, _ in rows],
                                   [t for _, _, t, _ in rows], suffix,
                                   min_q=1 + self._spec_max_draft):
            return None
        return rows

    def _plan_draft_fill(self, lagged):
        """Each lagging row's committed history from its draft mark,
        chunked to the token budget (a long backlog fills over several
        steps); under strict shapes the chunk halves until a captured
        draft_fill key takes it, else None."""
        budget, rows = self._budget, []
        for uid, req in lagged:
            lag = self._engine.draft_lag(uid)
            seen = self._engine.seen_tokens(uid)
            hist = np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.generated, np.int32)])
            chunk = min(lag, max(budget, 1))
            rows.append((uid, hist[seen - lag: seen - lag + chunk]))
            budget -= chunk
            if budget <= 0:
                break
        while rows:
            if self._strict_key_ok([u for u, _ in rows],
                                   [t for _, t in rows], ("draft_fill",)):
                return rows
            cap = max(len(t) for _, t in rows) // 2
            if cap < 1:
                return None
            rows = [(u, t[:cap]) for u, t in rows]
        return None

    def _commit_verdict(self, rows, verdict, drafter, on_token
                        ) -> Dict[int, int]:
        """Deliver each row's committed block (its first ``accepted``
        drafts, then the corrected token) up to a stop token or
        ``max_new_tokens``, advance each row by what it committed, and
        account the drafts.  ``verdict`` is the host copy of the step's
        [S, 2] (n-gram: drafts are the host's) or [S, 2+k] (model:
        drafts come back in columns 2..)."""
        out: Dict[int, int] = {}
        committed: List[int] = []
        drafted = accepted = 0
        for i, (_, req, _t, draft) in enumerate(rows):
            room = len(draft)
            a = min(int(verdict[i, 0]), room)
            proposed = verdict[i, 2:2 + a] if drafter == "model" \
                else draft[:a]
            c = 0
            for tok in [int(t) for t in proposed] + [int(verdict[i, 1])]:
                c += 1
                if self._deliver_token(req, tok, out, on_token):
                    # finished after the commit: the flush needs the
                    # descriptor the commit below still advances
                    req.done = True
                    break
            committed.append(c)
            # accepted counts COMMITTED drafts: a stop token cuts
            # verifier-accepted drafts past it
            drafted += room
            accepted += min(a, c)
            if room:
                self._note_spec_result(req, drafter, room, min(a, c))
        uids = [u for u, _, _, _ in rows]
        self._engine.commit_spec(uids, committed)
        if drafter == "model":
            self._engine.mark_draft_seen(uids)
            self._spec_draft_drafted_cum += drafted
            self._spec_draft_accepted_cum += accepted
            tm.FASTGEN_SPEC_DRAFT_DRAFTED.inc(drafted)
            tm.FASTGEN_SPEC_DRAFT_ACCEPTED.inc(accepted)
            if self._spec_draft_drafted_cum:
                tm.FASTGEN_SPEC_DRAFT_ACCEPT_RATE.set(
                    self._spec_draft_accepted_cum
                    / self._spec_draft_drafted_cum)
        for _, req, _, _ in rows:
            if req.done:
                self._finish_request(req)
        self._spec_drafted_cum += drafted
        self._spec_accepted_cum += accepted
        tm.FASTGEN_SPEC_DRAFTED.inc(drafted)
        tm.FASTGEN_SPEC_ACCEPTED.inc(accepted)
        if self._spec_drafted_cum:
            tm.FASTGEN_SPEC_ACCEPT_RATE.set(
                self._spec_accepted_cum / self._spec_drafted_cum)
        self._spec_steps += 1
        self._spec_committed_cum += sum(committed)
        return out

    def _spec_row_pos(self, rows) -> Optional[List[int]]:
        """Keyed: position j of a verify row emits generation index
        ``len(generated) + j`` (the step folds in the j)."""
        return ([len(req.generated) for _, req, _, _ in rows]
                if self._keyed else None)

    def _dispatch_spec(self, rows, on_token) -> Dict[int, int]:
        """One verify step of host-drafted rows, read in the same step:
        the [S, 2] int32 verdict is its only copy to the host."""
        with trace_span("fastgen.dispatch.spec"):
            verdict = self._engine.step_spec(
                [u for u, _, _, _ in rows], [t for _, _, t, _ in rows],
                [req.params for _, req, _, _ in rows], self._rng,
                min_q=1 + self._spec_max_draft,
                row_pos=self._spec_row_pos(rows))
        self.last_step_scheduled = len(rows)
        verdict = verdict.cpu().numpy()        # the [S, 2] int32 d2h
        serving_counters.record_d2h(verdict.nbytes)
        return self._commit_verdict(rows, verdict, "ngram", on_token)

    def _dispatch_draft_spec(self, rows, on_token) -> Dict[int, int]:
        """One step of the draft loop and the verify: the [S, 2+k] int32
        verdict, drafts included, is its only copy to the host."""
        with trace_span("fastgen.dispatch.draft_spec"):
            verdict = self._engine.step_draft_spec(
                [u for u, _, _, _ in rows], [t for _, _, t, _ in rows],
                [req.params for _, req, _, _ in rows], self._rng,
                min_q=1 + self._spec_max_draft,
                row_pos=self._spec_row_pos(rows))
        self.last_step_scheduled = len(rows)
        verdict = verdict.cpu().numpy()        # the [S, 2+k] int32 d2h
        serving_counters.record_d2h(verdict.nbytes)
        return self._commit_verdict(rows, verdict, "model", on_token)

    def _dispatch_draft_fill(self, rows) -> None:
        """The draft pool's catch-up step: nothing is sampled, committed
        or copied to the host."""
        with trace_span("fastgen.dispatch.draft_fill"):
            self._engine.step_draft_fill([u for u, _ in rows],
                                         [t for _, t in rows])
        self.last_step_scheduled = len(rows)
        n = int(sum(len(t) for _, t in rows))
        tm.FASTGEN_SPEC_DRAFT_FILL.inc(n)
        get_flight_recorder().record("spec.draft_fill", rows=len(rows),
                                     tokens=n)

    # -- prefix cache ---------------------------------------------------------
    def _match_prefix_once(self, req: Request, adm: _Admission) -> None:
        """The one prefix-cache lookup before first admission: cached
        full pages attach to the (created) sequence, and only the
        uncached suffix is prefilled."""
        state = self._engine.state_manager
        if state.prefix_cache is None:
            req.prefix_checked = True
            return
        if adm.tracked_left < 1:
            return
        was_tracked = state.get_sequence(req.uid) is not None
        alloc = state.kv_cache.allocator
        before = alloc.free_pages + alloc.parked_pages
        hit = self._engine.match_prefix(req.uid, req.prompt)
        # consumed only once the lookup ran (it creates the sequence)
        req.prefix_checked = state.get_sequence(req.uid) is not None
        if req.prefix_checked and not was_tracked:
            adm.tracked_left -= 1
        if hit:
            req.prompt_sent = hit
            req.tier_hits = self._engine.tier_hits(req.uid)
            if req.journey is not None and any(
                    (req.tier_hits or {}).get(t)
                    for t in ("host", "disk", "remote")):
                # a promotion or fetched pages paid wall time here; a
                # device hit is a reference attach and stays unmarked
                req.journey.mark("tier_promote")
            # parked pages the match revived and free pages a tier
            # promotion took were schedulable in this admission's
            # snapshot and are live now (a demotion it caused moved pages
            # from parked to free: no change)
            adm.free_pages -= before - (alloc.free_pages
                                        + alloc.parked_pages)

    # -- the step -------------------------------------------------------------
    def step(self, on_token: Optional[Callable[[int, int], None]] = None
             ) -> Dict[int, int]:
        """Schedule one ragged batch; returns {uid: new_token} for every
        sequence whose token reached the host this step (under
        ``async_scheduling`` the PREVIOUS step's tokens).  An armed
        ``serving.preempt`` fault site raises ``InjectedPreemptionFault``
        here, before the step (a preemption at a step boundary, nothing
        half done); an exception escaping the step leaves a postmortem
        bundle first (``telemetry.flight_recorder``)."""
        faults = get_fault_injector()
        if faults.armed and faults.fire("serving.preempt"):
            raise InjectedPreemptionFault(
                "injected preemption between scheduler steps")
        self._step_ordinal += 1
        try:
            if _telemetry.enabled:
                get_tracer().set_step(self._step_ordinal)
                t0 = time.perf_counter()
                with trace_span("fastgen.step"):
                    out = self._step_impl(on_token)
                step_ms = (time.perf_counter() - t0) * 1e3
                tm.FASTGEN_STEP_MS.observe(step_ms)
                # the anomaly detector reads the host time around the
                # step: under the async chain that is the enqueue of step
                # k+1 and the wait for step k's tokens, not the card's
                # time for one step (as in the JAX package; no sync)
                get_watchdog().observe_step_time(
                    "fastgen", step_ms, step=self._step_ordinal)
            else:
                out = self._step_impl(on_token)
        except Exception as e:
            get_flight_recorder().on_crash("fastgen.step", e)
            raise
        if self._role == "prefill" and self._running:
            self._sweep_handoff_ready()
        if self._kv_debug:
            self._engine.state_manager.check_invariants()
        if self._tseries.active:
            # interval-gated inside: a fast step loop samples at the
            # configured cadence, not every step
            self._tseries.maybe_sample()
        # watermarks follow the step cadence (peaks between time-series
        # samples would be lost)
        self._mledger.sample()
        return out

    def _resume_preempted(self) -> None:
        """Restore preempted sequences, oldest first, while the pool has
        room for their pages and a page of decode headroom."""
        state = self._engine.state_manager
        for uid in list(self._preempted):
            sd = state.get_sequence(uid)
            if sd is None:
                self._preempted.pop(uid)
                continue
            need = sd.host_blob.shape[1] if sd.host_blob is not None else 0
            if self._engine.free_blocks >= need + 1:
                self._engine.restore_sequence(uid)
                get_flight_recorder().record("request.restore", uid=uid)
                self._running[uid] = self._preempted.pop(uid)

    def _step_impl(self, on_token) -> Dict[int, int]:
        serving_counters.record_step()
        self._preempted_this_step = False
        self._expire_requests()
        spec_drained: Optional[Dict[int, int]] = None
        if self._spec_gate():
            # the drafters read committed tokens, so the step in flight
            # drains first; when nothing drafts, the normal path below
            # runs with that drain done
            spec_drained = self._drain(on_token)
            plan = self._plan_spec()
            if plan is not None:
                mode, rows = plan
                if mode == "fill":
                    self._dispatch_draft_fill(rows)
                    return spec_drained
                try:
                    out = (self._dispatch_draft_spec(rows, on_token)
                           if mode == "model"
                           else self._dispatch_spec(rows, on_token))
                except KVAllocationError as e:
                    self._degrade_oom(e, [], [])
                    return spec_drained
                self._oom_streak = 0
                spec_drained.update(out)
                return spec_drained

        chain = self._plan_chain() if spec_drained is None else None
        if chain is not None:
            # dispatch k+1 FIRST, then drain k: the wait for k's tokens
            # overlaps the device running k+1
            try:
                with trace_span("fastgen.dispatch.chain"):
                    new_inflight = self._dispatch_chain(chain)
            except KVAllocationError as e:
                out = self._drain(on_token)
                self._degrade_oom(e, [], [])
                return out
            self._oom_streak = 0
            out = self._drain(on_token)
            self._inflight = new_inflight
            return out

        out_prev = (spec_drained if spec_drained is not None
                    else self._drain(on_token))
        with trace_span("fastgen.admission"):
            admitted = self._admit()
        return self._dispatch_admitted(on_token, out_prev, *admitted)

    def _admit(self):
        """The host path's admission: resume preempted sequences, then
        admit running decodes, partial prefills and pending requests to
        the budget.  Returns (uids, tokens, requests, the prompt advances
        and the pending -> running moves a failed dispatch undoes)."""
        self._resume_preempted()
        adm = _Admission(self._engine, self._budget)
        uids: List[int] = []
        tokens: List[np.ndarray] = []
        reqs: List[Request] = []
        #: prompt advances and pending -> running moves of this step,
        #: undone when its dispatch fails
        advances: List[Tuple[Request, int]] = []
        new_admits: List[Request] = []
        faults = get_fault_injector()

        # 1. all running decodes (one token each).  An exception that
        # belongs to one request fails that request ("poisoned"); the
        # step serves the rest
        for uid, req in list(self._running.items()):
            if req.prefill_remaining > 0:
                continue  # mid-prefill requests handled below
            try:
                if faults.armed and faults.fire("fastgen.poison_request"):
                    raise PoisonedRequestFault(
                        f"injected poisoned request {uid}")
                if not adm.try_admit(uid, 1, is_new=False):
                    continue
            except Exception as e:
                self._fail_request(req, "poisoned",
                                   f"{type(e).__name__}: {e}")
                continue
            last = (req.generated[-1] if req.generated
                    else int(req.prompt[-1]))
            uids.append(uid)
            tokens.append(np.array([last], dtype=np.int32))
            reqs.append(req)

        # 2. continue partial prefills, then admit pending, chunked to
        # the budget (halving the chunk to fit KV headroom)
        def try_prefill(req: Request, is_new: bool) -> bool:
            if adm.tokens_left <= 0 or req.prefill_remaining == 0:
                return False
            if faults.armed and faults.fire("fastgen.poison_request"):
                raise PoisonedRequestFault(
                    f"injected poisoned request {req.uid}")
            if req.journey is not None and not req.journey_admitted:
                # the first admission attempt on this scheduler closes
                # queue_wait, so a prefix match or promotion gets its
                # own segment
                req.journey_admitted = True
                req.journey.mark("queue_wait")
            if is_new and self._prefix_cfg and not req.prefix_checked:
                with trace_span("fastgen.prefix_match"):
                    self._match_prefix_once(req, adm)
            if is_new:
                # the lookup tracks the sequence even on a miss
                is_new = (self._engine.state_manager
                          .get_sequence(req.uid) is None)
            chunk = min(req.prefill_remaining, adm.tokens_left)
            while chunk > 0 and not adm.try_admit(req.uid, chunk, is_new):
                chunk //= 2
            if chunk == 0:
                return False
            uids.append(req.uid)
            tokens.append(req.prompt[req.prompt_sent:
                                     req.prompt_sent + chunk])
            reqs.append(req)
            req.prompt_sent += chunk
            advances.append((req, chunk))
            serving_counters.record_prefill(chunk)
            if self._wtrace.active and req.first_sched_mono == 0.0:
                req.first_sched_mono = time.monotonic()
            if _telemetry.enabled and req.first_sched_s == 0.0:
                # the first admission closes the queue wait
                req.first_sched_s = time.perf_counter()
                if req.submit_s:
                    tm.FASTGEN_QUEUE_WAIT_MS.observe(
                        (req.first_sched_s - req.submit_s) * 1e3)
                get_flight_recorder().record(
                    "request.admit", uid=req.uid,
                    prompt_tokens=len(req.prompt),
                    cached_tokens=req.prompt_sent - chunk)
            return True

        for req in list(self._running.values()):
            try:
                try_prefill(req, is_new=False)
            except Exception as e:
                self._fail_request(req, "poisoned",
                                   f"{type(e).__name__}: {e}")
        while self._pending and adm.tokens_left > 0:
            req = self._pending[0]
            try:
                admitted = try_prefill(req, is_new=True)
            except Exception as e:
                self._fail_request(req, "poisoned",
                                   f"{type(e).__name__}: {e}")
                continue
            if not admitted:
                break
            self._pending.pop(0)
            self._running[req.uid] = req
            new_admits.append(req)

        return uids, tokens, reqs, advances, new_admits

    def _dispatch_admitted(self, on_token, out_prev, uids, tokens, reqs,
                           advances, new_admits) -> Dict[int, int]:
        """Dispatch the admitted batch: fused, or the split escape hatch;
        with nothing admitted, preempt to make room."""
        self.last_step_scheduled = len(uids)
        if not uids:
            # nothing schedulable but work remains: preempt the running
            # sequence with the most private KV so the others can finish;
            # it resumes once the pool has room
            self._preempt_largest()
            return out_prev

        sampled = [i for i, r in enumerate(reqs) if r.prefill_remaining == 0]
        # strict shapes serve only captured steps: a mixed key is never
        # in the lattice, and a superbucket may fall outside it, so such
        # a step serves split
        strict = self._engine.model.strict_shapes
        strict_mixed = (strict and any(len(t) == 1 for t in tokens)
                        and any(len(t) > 1 for t in tokens))
        greedy_only = all(reqs[i].params.temperature <= 0.0 for i in sampled)
        use_fused = self._fused and not strict_mixed
        if use_fused and not self._strict_key_ok(
                uids, tokens, ("sample", greedy_only)):
            use_fused = False

        if use_fused:
            # mid-prefill rows produce no token: pin them greedy so they
            # can neither flip the step into the sampling path nor draw
            # from the generator
            row_params = [r.params if r.prefill_remaining == 0
                          else SamplingParams() for r in reqs]
            # keyed: a sampled row emits generation index len(generated)
            # (the draws of mid-prefill rows are ignored)
            row_pos = ([len(r.generated) for r in reqs] if self._keyed
                       else None)
            try:
                with trace_span("fastgen.dispatch.fused"):
                    toks, rowmap = self._engine.step_sample(
                        uids, tokens, row_params, self._rng,
                        do_checks=False, row_pos=row_pos)
            except KVAllocationError as e:
                self._degrade_oom(e, advances, new_admits)
                return out_prev
            self._oom_streak = 0
            self._inflight = _Inflight.start(
                toks, [(uids[i], rowmap[i], reqs[i]) for i in sampled])
            if not self._async:
                out_prev.update(self._drain(on_token))
            return out_prev

        # the split escape hatch: the logits are sampled outside the step,
        # one call per parameter group, and only the tokens reach the
        # host.  The forward's fusion follows this scheduler's serving
        # view; under strict shapes the superbucket must also have been
        # captured
        put_fused = bool(self._serving.fused_step) and not strict_mixed
        if put_fused:
            put_fused = self._strict_key_ok(uids, tokens, ())
        with trace_span("fastgen.dispatch.split"):
            try:
                logits = self._engine.put(uids, tokens, do_checks=False,
                                          fused=put_fused)
            except KVAllocationError as e:
                self._degrade_oom(e, advances, new_admits)
                return out_prev
            self._oom_streak = 0
            groups: Dict[tuple, List[int]] = {}
            for i in sampled:
                groups.setdefault(_group_key(reqs[i].params), []).append(i)
            new_tokens: Dict[int, int] = {}
            for (temp, top_k, top_p), idxs in groups.items():
                rows = torch.tensor(idxs, dtype=torch.long,
                                    device=logits.device)
                if self._keyed and temp > 0.0:
                    toks = self._sample_group_keyed(
                        logits[rows], [reqs[i] for i in idxs], temp, top_k,
                        top_p)
                else:
                    toks = sample(logits[rows], self._generator,
                                  temperature=temp, top_k=top_k,
                                  top_p=top_p)
                # the group's [g] int32 d2h
                serving_counters.record_d2h(toks.numel()
                                            * toks.element_size())
                for i, t in zip(idxs, toks.tolist()):
                    new_tokens[i] = t
        out = dict(out_prev)
        for i, tok in new_tokens.items():
            if self._deliver_token(reqs[i], tok, out, on_token):
                self._finish_request(reqs[i])
        return out

    def _sample_group_keyed(self, logits: torch.Tensor, reqs, temp: float,
                            top_k: int, top_p: float) -> torch.Tensor:
        """The split path's keyed draw of one parameter group: each row
        from its own (uid, position) key, bit-equal to the fused step's
        draw of the same row."""
        dev = logits.device
        n = len(reqs)

        def col(values, dtype):
            return torch.tensor(values, dtype=dtype, device=dev)

        keys = derive_row_keys(
            torch.from_numpy(self._base_key).to(dev),
            col(np.asarray([r.uid for r in reqs], np.int64).astype(np.int32),
                torch.int32),
            col([len(r.generated) for r in reqs], torch.int32))
        return sample_keyed(logits, keys, col([temp] * n, torch.float32),
                            col([top_k] * n, torch.int32),
                            col([top_p] * n, torch.float32))

    # -- the disaggregated handoff --------------------------------------------
    @property
    def role(self) -> str:
        return self._role

    @property
    def handoff_backlog(self) -> int:
        """Requests awaiting collection by the DisaggPool (prefill role;
        0 elsewhere)."""
        return len(self._handoff_ready)

    def enable_handoff_sink(self) -> None:
        """Register a handoff consumer (the DisaggPool): a prefill
        scheduler then admits multi-token requests."""
        self._handoff_sink = True

    def handoff_ready_uids(self) -> List[int]:
        return list(self._handoff_ready)

    def _sweep_handoff_ready(self) -> None:
        """Prefill role: a running request whose prompt is done and whose
        first token reached the host (its TTFT never waits on the
        transfer) leaves the scheduling sets and parks handoff-ready; its
        sequence stays in the engine until ``complete_handoff`` or an
        error ends it."""
        for uid, req in list(self._running.items()):
            if req.done or req.prefill_remaining > 0 or not req.generated:
                continue
            self._running.pop(uid)
            self._handoff_ready[uid] = req
            get_flight_recorder().record("disagg.handoff_ready", uid=uid,
                                         tokens=len(req.generated))

    def export_handoff(self, uids: Sequence[int]) -> dict:
        """One handoff bundle of handoff-ready ``uids``: their committed
        pages through the manager's selective ``export_state`` (each
        page once, full prefix pages with their chain digests, so the
        importer attaches what its cache holds) and each request's
        residual state (prompt with its partial-page tail, committed
        tokens, sampling parameters, remaining TTL, speculation state,
        journey).  The requests stay parked until ``complete_handoff``.
        Returns ``{"meta", "arrays"}``, the snapshot bundle's layout (the
        arrays are host tensors)."""
        missing = [u for u in uids if u not in self._handoff_ready]
        if missing:
            raise ValueError(
                f"export_handoff of non-handoff-ready uids {missing}")
        now = time.monotonic()
        for u in uids:
            req = self._handoff_ready[u]
            if req.journey is not None:
                # the journey travels whole in the bundle; the fragment
                # keeps this side's view if the importer dies
                req.journey.mark("handoff_export")
                _journey.get_journey_log().publish_fragment(
                    req.journey, where=self._role)
        eng_meta, arrays = self._engine.state_manager.export_state(
            seq_ids=list(uids))
        meta = {"version": SNAPSHOT_VERSION, "handoff": True,
                "requests": [self._serialize_request(self._handoff_ready[u],
                                                     now) for u in uids],
                "engine": eng_meta}
        return {"meta": meta, "arrays": arrays}

    def complete_handoff(self, uids: Sequence[int]) -> None:
        """The bundle landed: flush the local sequences (their full
        prefix pages park in this engine's prefix cache, so the next
        prompt with the prefix prefills only its suffix) and drop the
        parked requests; the importing scheduler delivers the rest."""
        for u in uids:
            req = self._handoff_ready.pop(u, None)
            if req is None:
                continue
            if self._drafter is not None:
                self._drafter.drop(u)
            if self._engine.state_manager.get_sequence(u) is not None:
                self._engine.flush(u)

    def import_handoff(self, bundle: dict) -> dict:
        """Decode side: merge one handoff bundle into the live engine
        (refcounts and prefix sharing rebuilt; pages whose digest this
        cache holds attach by reference) and enqueue its requests: into
        the running set, or the preempted set when a request's pages
        arrive as a host blob (handed off mid-preemption).  Called
        between steps, so no step is in flight over the tables it
        changes.  :class:`SnapshotError` for a bundle that is not a
        handoff, a closed scheduler, a uid already live here or another
        KV geometry; ``KVAllocationError`` when the pool cannot hold the
        streamed pages yet (retryable: nothing changed).  Returns
        ``{"uids", "pages_streamed", "pages_shared"}``."""
        meta, arrays = bundle["meta"], bundle["arrays"]
        if not meta.get("handoff"):
            raise SnapshotError(
                "import_handoff expects a bundle from export_handoff")
        if self._closed:
            raise SnapshotError("import_handoff on a closed scheduler")
        for d in meta["requests"]:
            if self._is_live(int(d["uid"])):
                raise SnapshotError(
                    f"import_handoff: uid {int(d['uid'])} already live on "
                    "the importing scheduler")
        t_import = time.time()      # the transfer ends where import begins
        with trace_span("fastgen.import_handoff"):
            stats = self._engine.state_manager.import_state(
                meta["engine"], arrays)
            now = time.monotonic()
            uids: List[int] = []
            for d in meta["requests"]:
                req = self._restore_request(d, now)
                if req.journey is not None:
                    # the wire and queue time, then the merge; at= is
                    # this (importing) scheduler's role, as the pump's
                    # thread carries the exporter's label
                    req.journey.mark("handoff_transfer", at=self._role,
                                     t=t_import)
                    req.journey.mark("handoff_import", at=self._role)
                sd = self._engine.state_manager.get_sequence(req.uid)
                if sd is not None and sd.host_blob is not None:
                    self._preempted[req.uid] = req
                else:
                    self._running[req.uid] = req
                uids.append(req.uid)
        if self._kv_debug:
            self._engine.state_manager.check_invariants()
        stats = dict(stats or {})
        stats["uids"] = uids
        return stats

    # -- graceful degradation -------------------------------------------------
    def _preempt_largest(self) -> bool:
        """Preempt the sequence with the most offloadable KV
        (window-evicted slots and shared pages free nothing, and a
        preemption that frees nothing would spin ``run_to_completion``).
        Handoff-ready sequences go first: they hold pages and do no
        work, and their host blob travels with the handoff."""
        state = self._engine.state_manager

        def live_pages(u):
            sd = state.get_sequence(u)
            return len(state.offloadable_slots(sd)) if sd else 0

        if self._handoff_ready:
            victim = max(self._handoff_ready, key=live_pages)
            if live_pages(victim) > 0:
                with trace_span("fastgen.preempt"):
                    self._engine.offload_sequence(victim)
                get_flight_recorder().record("request.preempt", uid=victim,
                                             handoff=True)
                self._preempted_this_step = True
                return True
        if not self._running:
            return False
        victim = max(self._running, key=live_pages)
        if live_pages(victim) <= 0:
            return False
        with trace_span("fastgen.preempt"):
            self._engine.offload_sequence(victim)
        get_flight_recorder().record("request.preempt", uid=victim)
        self._preempted[victim] = self._running.pop(victim)
        self._preempted_this_step = True
        return True

    def _most_demanding_request(self) -> Optional[Request]:
        """The request with the most demand left (prompt tokens still to
        prefill, then pages held): the shed victim that frees the most."""
        cands = (self._pending + list(self._running.values())
                 + list(self._preempted.values()))
        if not cands:
            return None

        def demand(r: Request):
            sd = self._engine.state_manager.get_sequence(r.uid)
            pages = (sum(p != NULL_PAGE for p in sd.pages)
                     if sd is not None else 0)
            return (r.prefill_remaining, pages)

        return max(cands, key=demand)

    def _degrade_oom(self, exc: Exception,
                     advances: List[Tuple[Request, int]],
                     new_admits: List[Request]) -> None:
        """A page allocation failed in a dispatch: undo the step's prompt
        advances (no prompt token is skipped), then climb the ladder
        with the run of failures: (1) reclaim every parked prefix page,
        (2) from the second failure on, preempt the largest sequence,
        (3) from the fourth, shed the most demanding request with an
        ``"oom"`` error."""
        for req, chunk in advances:
            req.prompt_sent -= chunk
        for req in reversed(new_admits):
            # an admission whose sequence never came to exist goes back
            # to the front of the queue, in order
            if self._engine.state_manager.get_sequence(req.uid) is None \
                    and not req.generated and req.uid in self._running:
                self._running.pop(req.uid)
                self._pending.insert(0, req)
        self._oom_streak += 1
        tm.KV_ALLOC_FAIL.inc()
        tm.MEM_PRESSURE.inc()
        get_flight_recorder().record("kv.alloc_fail", streak=self._oom_streak,
                                     error=str(exc)[:200])
        state = self._engine.state_manager
        alloc = state.kv_cache.allocator
        # each rung logs the pages it freed, so a postmortem shows which
        # lever mattered
        rungs: List[Dict[str, object]] = []
        before = alloc.free_pages
        if alloc.parked_pages:
            state.ensure_free(alloc.free_pages + alloc.parked_pages)
            self._preempted_this_step = True      # pages freed: progress
            rungs.append({"lever": "reclaim_parked",
                          "pages_freed": alloc.free_pages - before})
        if self._oom_streak >= 2:
            before = alloc.free_pages
            self._preempt_largest()
            rungs.append({"lever": "preempt_largest",
                          "pages_freed": alloc.free_pages - before})
        if self._oom_streak >= 4:
            victim = self._most_demanding_request()
            if victim is not None:
                before = alloc.free_pages
                self._fail_request(
                    victim, "oom", "KV pool exhausted after parked-page "
                    f"eviction and preemption ({self._oom_streak} "
                    f"consecutive allocation failures: {exc})")
                self._preempted_this_step = True
                rungs.append({"lever": "shed_request",
                              "pages_freed": alloc.free_pages - before})
        freed = sum(max(r["pages_freed"], 0) for r in rungs)
        if freed:
            tm.MEM_DEGRADE_FREED_PAGES.inc(freed)
        if _telemetry.enabled:
            # who owned the bytes when the allocator starved: the
            # dominant subsystem names the lever a capacity fix pulls
            bd = self._mledger.breakdown()
            get_flight_recorder().record(
                "mem.breakdown", trigger="kv.alloc_oom",
                streak=self._oom_streak, dominant=bd["dominant"],
                accounted_bytes=bd["accounted_bytes"],
                subsystems=bd["subsystems"], rungs=rungs)
        self.last_step_scheduled = 0

    # -- snapshots ------------------------------------------------------------
    @staticmethod
    def _serialize_request(req: Request, now: float) -> dict:
        p = req.params
        return {"uid": int(req.uid),
                "prompt": np.asarray(req.prompt).tolist(),
                "prompt_sent": int(req.prompt_sent),
                "generated": [int(t) for t in req.generated],
                "prefix_checked": bool(req.prefix_checked),
                "params": {"temperature": float(p.temperature),
                           "top_k": int(p.top_k), "top_p": float(p.top_p),
                           "max_new_tokens": int(p.max_new_tokens),
                           "stop_token": (None if p.stop_token is None
                                          else int(p.stop_token))},
                # a monotonic deadline means nothing in another process:
                # the remaining budget travels
                "ttl_remaining_s": (None if req.deadline is None
                                    else req.deadline - now),
                "spec_drafted": int(req.spec_drafted),
                "spec_accepted": int(req.spec_accepted),
                "spec_state": {
                    "drafter": req.spec_drafter,
                    "dry": int(req.spec_dry), "cool": int(req.spec_cool),
                    "ewma": {k: float(v)
                             for k, v in (req.spec_ewma or {}).items()},
                    "ngram": [int(req.spec_drafted_ngram),
                              int(req.spec_accepted_ngram)],
                    "model": [int(req.spec_drafted_model),
                              int(req.spec_accepted_model)]},
                # the journey rides every bundle a request crosses, so
                # the importer appends to the context it received
                "journey": (req.journey.to_dict()
                            if req.journey is not None else None)}

    def _restore_request(self, d: dict, now: float) -> Request:
        pr = d["params"]
        req = Request(
            uid=int(d["uid"]), prompt=np.asarray(d["prompt"], dtype=np.int32),
            params=SamplingParams(
                temperature=float(pr["temperature"]),
                top_k=int(pr["top_k"]), top_p=float(pr["top_p"]),
                max_new_tokens=int(pr["max_new_tokens"]),
                stop_token=(None if pr["stop_token"] is None
                            else int(pr["stop_token"]))),
            prompt_sent=int(d["prompt_sent"]),
            generated=[int(t) for t in d["generated"]],
            prefix_checked=bool(d["prefix_checked"]), submit_mono=now)
        req.spec_drafted = int(d.get("spec_drafted", 0))
        req.spec_accepted = int(d.get("spec_accepted", 0))
        ss = d.get("spec_state")
        if ss:
            req.spec_drafter = str(ss.get("drafter", "") or "")
            req.spec_dry = int(ss.get("dry", 0))
            req.spec_cool = int(ss.get("cool", 0))
            ew = ss.get("ewma") or {}
            req.spec_ewma = ({str(k): float(v) for k, v in ew.items()}
                             if ew else None)
            req.spec_drafted_ngram, req.spec_accepted_ngram = (
                int(x) for x in ss.get("ngram", (0, 0)))
            req.spec_drafted_model, req.spec_accepted_model = (
                int(x) for x in ss.get("model", (0, 0)))
        ttl = d.get("ttl_remaining_s")
        if ttl is not None:
            req.deadline = now + float(ttl)
            self._has_deadlines = True
        jd = d.get("journey")
        if jd:
            req.journey = _journey.Journey.from_dict(jd)
        return req

    @property
    def _generator_array(self) -> str:
        """The bundle array of this scheduler's generator state: the
        port's own name (the JAX package ignores it), one per device
        type, as a CPU and a CUDA generator keep different states."""
        return f"torch_generator_{self._generator.device.type}"

    def snapshot(self, path: Optional[str] = None,
                 on_token: Optional[Callable[[int, int], None]] = None
                 ) -> dict:
        """Close admission, drain the step in flight (its tokens go to
        ``on_token``: a request that completes there is not in the
        bundle) and serialize what resuming needs: the pending, running
        and preempted requests, the base key (``rng_key``) and the
        generator state, every referenced KV page, host blobs, the prefix
        index in LRU order, counters, the error log, the captured step
        keys and the draft trunk's digest.  Returns ``{"meta",
        "arrays"}``; with ``path`` also writes the bundle.  Keyed and
        greedy requests resume tokenwise in either package; the sampled
        rows of a non-keyed scheduler resume exactly only in the port,
        on the same device type."""
        t0 = time.perf_counter()
        self.close()
        with trace_span("fastgen.snapshot"):
            meta, arrays = self._snapshot_impl(on_token)
            if path is not None:
                write_bundle(path, meta, arrays)
        ms = (time.perf_counter() - t0) * 1e3
        # counted with telemetry off too: snapshots are rare and matter
        tm.FASTGEN_SNAPSHOT_MS.observe(ms)
        get_flight_recorder().record(
            "fastgen.snapshot", requests=self.backlog,
            pages=len(meta["engine"]["page_ids"]), ms=round(ms, 2),
            path=path or "")
        return {"meta": meta, "arrays": arrays}

    def _snapshot_impl(self, on_token) -> tuple:
        self._drain(on_token)
        now = time.monotonic()
        eng_meta, arrays = self._engine.state_manager.export_state()
        arrays["rng_key"] = np.asarray(self._base_key, np.uint32)
        arrays[self._generator_array] = self._generator.get_state().numpy()
        meta = {
            "version": SNAPSHOT_VERSION,
            "requests": {
                "pending": [self._serialize_request(r, now)
                            for r in self._pending],
                "running": [self._serialize_request(r, now)
                            for r in self._running.values()],
                "preempted": [self._serialize_request(r, now)
                              for r in self._preempted.values()],
                # prefill role: awaiting collection
                "handoff_ready": [self._serialize_request(r, now)
                                  for r in self._handoff_ready.values()]},
            "counters": {"step_ordinal": int(self._step_ordinal),
                         "last_step_scheduled": int(self.last_step_scheduled),
                         "oom_streak": int(self._oom_streak)},
            "errors": [dataclasses.asdict(e) for e in self.errors.values()],
            "engine": eng_meta,
            # the keys traffic dispatched, captured again up front at
            # restore, and the lattice they were bucketed under
            "compiled": {"keys": [list(k)
                                  for k in self._engine.compiled_keys()],
                         "lattice_digest": self._engine.lattice_digest},
            "draft_digest": self._engine.draft_digest,
        }
        return meta, arrays

    def restore(self, bundle) -> "FastGenScheduler":
        """Rebuild a snapshotted scheduler in this fresh one (over a fresh
        engine with the same weights and serving config) and resume where
        it stopped.  ``bundle`` is a path or what ``snapshot()`` returned.
        The bundle's step keys are captured first when its lattice digest
        (``""`` for the power-of-two lattice) is this engine's; else a
        warning, and they capture at first use.
        :class:`SnapshotError` for a corrupt, truncated or other-version
        bundle, a scheduler that is not fresh, another draft trunk or
        another KV geometry."""
        t0 = time.perf_counter()
        with trace_span("fastgen.restore"):
            meta = self._restore_impl(bundle)
        tm.FASTGEN_RESTORE.inc()
        get_flight_recorder().record(
            "fastgen.restore", requests=self.backlog,
            pages=len(meta["engine"]["page_ids"]),
            ms=round((time.perf_counter() - t0) * 1e3, 2))
        if self._kv_debug:
            self._engine.state_manager.check_invariants()
        return self

    def _restore_impl(self, bundle) -> dict:
        if isinstance(bundle, (str, os.PathLike)):
            meta, arrays = read_bundle(os.fspath(bundle))
        else:
            meta, arrays = bundle["meta"], bundle["arrays"]
            if meta.get("version") != SNAPSHOT_VERSION:
                raise SnapshotError(f"unsupported snapshot version "
                                    f"{meta.get('version')!r}")
        if (self._pending or self._running or self._preempted
                or self._handoff_ready or self._inflight is not None
                or self._closed):
            raise SnapshotError("restore needs a fresh scheduler (this one "
                                "has queued work or is closed)")
        want = meta.get("draft_digest")
        if want is not None and str(want) != self._engine.draft_digest:
            raise SnapshotError(
                f"the snapshot was taken with draft trunk {str(want)!r} but "
                f"this engine runs {self._engine.draft_digest!r}: restore "
                "onto an engine with the same spec_drafter and "
                "spec_draft_layers (a draft trunk's digest is its own "
                "package's)")
        self._engine.state_manager.import_state(meta["engine"], arrays)
        compiled = meta.get("compiled") or {}
        manifest = compiled.get("keys") or []
        if manifest:
            want = str(compiled.get("lattice_digest", "") or "")
            have = self._engine.lattice_digest
            if want != have:
                # keys bucketed under another lattice are the wrong ones
                # to capture here; the restore itself is still exact
                warnings.warn(
                    f"restore: the bundle's step keys were recorded under "
                    f"lattice digest {want!r} and this engine runs "
                    f"{have!r}: not capturing them up front (they capture "
                    "at first use)")
            else:
                self._engine.precompile_keys(manifest)
        self._base_key = np.asarray(arrays["rng_key"]).astype(np.int64)
        state = arrays.get(self._generator_array)
        if state is not None:
            self._generator.set_state(torch.as_tensor(np.asarray(state)))
        now = time.monotonic()
        reqs = meta["requests"]
        self._pending = [self._restore_request(d, now)
                         for d in reqs["pending"]]
        self._running = {int(d["uid"]): self._restore_request(d, now)
                         for d in reqs["running"]}
        self._preempted = {int(d["uid"]): self._restore_request(d, now)
                           for d in reqs["preempted"]}
        self._handoff_ready = {int(d["uid"]): self._restore_request(d, now)
                               for d in reqs.get("handoff_ready", [])}
        # the wall time between snapshot and restore is the migration
        # (marked here, not in _restore_request: a handoff import marks
        # its own transfer and import)
        for req in (self._pending + list(self._running.values())
                    + list(self._preempted.values())
                    + list(self._handoff_ready.values())):
            if req.journey is not None:
                req.journey.mark("migrate")
        c = meta["counters"]
        self._step_ordinal = int(c["step_ordinal"])
        self.last_step_scheduled = int(c["last_step_scheduled"])
        self._oom_streak = int(c["oom_streak"])
        self.errors = {int(e["uid"]): RequestError(
            uid=int(e["uid"]), code=e["code"], message=e["message"],
            tokens=[int(t) for t in e["tokens"]]) for e in meta["errors"]}
        return meta

    def drain_and_snapshot(self, path: str, grace_s: Optional[float] = None,
                           on_token: Optional[Callable[[int, int], None]]
                           = None) -> Optional[str]:
        """The SIGTERM body: close admission, drain the step in flight and
        snapshot to ``path`` within the grace budget (default
        ``snapshot_grace_s``).  Returns ``path`` when the bundle was
        written; when the budget ran out first, or the write failed, every
        live request ends with a ``"migrated"`` error that keeps its
        tokens so far, and None is returned: each client gets a verdict
        either way."""
        grace = (self._snapshot_grace_s if grace_s is None
                 else float(grace_s))
        deadline = time.monotonic() + grace
        self.close()
        try:
            self._drain(on_token)
        except Exception as e:            # the device may be gone already
            warnings.warn(f"drain_and_snapshot: drain failed: {e!r}")
        if time.monotonic() < deadline:
            try:
                self.snapshot(path, on_token)
                return path
            except Exception as e:
                warnings.warn(f"drain_and_snapshot: snapshot failed: {e!r}")
        else:
            warnings.warn(f"drain_and_snapshot: the grace budget "
                          f"({grace:.2f}s) ran out before a snapshot")
        for req in (list(self._pending) + list(self._running.values())
                    + list(self._preempted.values())
                    + list(self._handoff_ready.values())):
            self._fail_request(
                req, "migrated", f"preemption grace budget ({grace:.2f}s) "
                "expired before a snapshot could be written "
                f"({len(req.generated)} partial tokens kept)")
        return None

    def run_to_completion(self) -> Dict[int, List[int]]:
        all_reqs = {r.uid: r for r in self._pending}
        all_reqs.update(self._running)
        all_reqs.update(self._preempted)
        stalls = 0
        while self.has_work:
            out = self.step()
            if self.last_step_scheduled == 0 and not out:
                if self._preempted_this_step:
                    continue  # a preemption freed pages: progress
                stalls += 1
                if stalls >= 2:
                    if self._shed_unservable:
                        victim = self._most_demanding_request()
                        if victim is not None:
                            self._fail_request(
                                victim, "oom", "unservable: nothing is "
                                "schedulable with this request in the pool")
                            stalls = 0
                            continue
                    err = RuntimeError(
                        "scheduler deadlock: work remains but nothing is "
                        "schedulable (KV cache exhausted or a request "
                        "exceeds engine limits); "
                        f"{len(self._pending)} pending, "
                        f"{len(self._running)} running, "
                        f"{len(self._preempted)} preempted, "
                        f"{self._engine.free_blocks} free KV pages")
                    # a livelock leaves forensics like a crash
                    get_flight_recorder().on_crash(
                        "fastgen.run_to_completion", err)
                    raise err
            else:
                stalls = 0
        return {uid: req.generated for uid, req in all_reqs.items()}


def generate(engine: InferenceEngineV2, prompts: Sequence[Sequence[int]],
             params=None, token_budget: Optional[int] = None
             ) -> List[List[int]]:
    """Generate for every prompt through one scheduler.  ``params`` is
    one SamplingParams for all prompts or one per prompt."""
    sched = FastGenScheduler(engine, token_budget=token_budget)
    per_prompt = (list(params) if isinstance(params, (list, tuple))
                  else [params] * len(prompts))
    if len(per_prompt) != len(prompts):
        raise ValueError(f"{len(per_prompt)} params for {len(prompts)} "
                         "prompts")
    for i, (p, sp) in enumerate(zip(prompts, per_prompt)):
        sched.submit(i, p, sp)
    results = sched.run_to_completion()
    return [results[i] for i in range(len(prompts))]
