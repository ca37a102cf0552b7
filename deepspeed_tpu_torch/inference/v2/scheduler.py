"""Continuous-batching scheduler (Dynamic SplitFuse).

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py`` for the fused
path.  Every step fills a fixed token budget: running decodes first (one
token each), then prompt *chunks* of admitted requests, so long prompts
are split across steps and fused with decodes.  Each step is one
``InferenceEngineV2.step_sample`` (forward + on-device sampling), and
admission runs on incremental page/token/sequence counters
(``_Admission``), as in the JAX package.

With ``async_scheduling`` (the default) the scheduler double-buffers: a
step of pure decodes whose rows all sat in the step still in flight is
dispatched as a chained step (its tokens gathered on the device) BEFORE
that step's tokens are read, so the host's work on step k+1 overlaps the
device's work on step k and tokens reach the host one step late.  A
request that stops at step k may have been chained past its stop token;
that extra token is discarded at the drain.  With ``prefix_caching``
(the default) each new request is matched once against the prefix cache
before its first admission and only its uncached suffix is prefilled.

Not ported yet (ROADMAP Queue 1 items 4b, 8, 9): speculation,
preemption, shedding/TTL, snapshots and handoffs; a ``serving`` config
asking for one of them raises.  When nothing is schedulable,
``run_to_completion`` raises instead of preempting.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ServingOptimizationConfig
from .engine import InferenceEngineV2
from .sampling import SamplingParams


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

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prompt_sent


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


class FastGenScheduler:
    """Drives an InferenceEngineV2 with the SplitFuse policy.  ``seed``
    seeds the ``torch.Generator`` (on the model's device) that sampled
    rows draw from; greedy-only steps never touch it.  ``serving``
    (default: the engine's) sets ``async_scheduling`` and
    ``prefix_caching`` for this scheduler; its ``kv_quantization`` must
    be the engine's.  With ``DS_KV_DEBUG=1`` in the environment the KV
    page accounting is audited after every step."""

    def __init__(self, engine: InferenceEngineV2,
                 token_budget: Optional[int] = None, seed: int = 0,
                 serving: Optional[ServingOptimizationConfig] = None):
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
        self._async = bool(sv.async_scheduling)
        self._prefix_cfg = bool(sv.prefix_caching)
        self._kv_debug = os.environ.get("DS_KV_DEBUG", "") not in ("", "0")
        self._budget = (token_budget or
                        engine._config.state_manager.max_ragged_batch_size)
        self._generator = torch.Generator(device=engine.model.device)
        self._generator.manual_seed(seed)
        self._inflight: Optional[_Inflight] = None
        self._pending: List[Request] = []     # waiting for first prefill
        self._running: Dict[int, Request] = {}
        self.last_step_scheduled = 0

    def submit(self, uid: int, prompt: Sequence[int],
               params: Optional[SamplingParams] = None) -> None:
        if uid in self._running or any(r.uid == uid for r in self._pending):
            raise ValueError(f"request {uid} is already live")
        self._pending.append(Request(
            uid=uid, prompt=np.asarray(prompt, dtype=np.int32),
            params=params or SamplingParams()))

    @property
    def has_work(self) -> bool:
        return bool(self._pending or self._running
                    or self._inflight is not None)

    def _finish_request(self, req: Request) -> None:
        req.done = True
        self._engine.flush(req.uid)
        self._running.pop(req.uid, None)

    def _deliver(self, req: Request, tok: int, out: Dict[int, int],
                 on_token) -> None:
        req.generated.append(tok)
        out[req.uid] = tok
        if on_token is not None:
            on_token(req.uid, tok)
        stop = req.params.stop_token
        if (len(req.generated) >= req.params.max_new_tokens
                or (stop is not None and tok == stop)):
            self._finish_request(req)

    # -- drain: read a dispatched step's tokens -------------------------------
    def _drain(self, on_token) -> Dict[int, int]:
        if self._inflight is None:
            return {}
        inf, self._inflight = self._inflight, None
        if inf.copied is not None:
            inf.copied.synchronize()
        toks = inf.host.numpy()                # the one [S] int32 d2h
        out: Dict[int, int] = {}
        for uid, row, req in inf.rows:
            if req.done:
                # chained past a stop token: the extra token is dropped
                # (its KV write landed in pages the flush released)
                continue
            self._deliver(req, int(toks[row]), out, on_token)
        return out

    # -- double buffer: the chained decode step -------------------------------
    def _plan_chain(self) -> Optional[List[Tuple[int, int, Request]]]:
        """Rows of a chained decode step, or None when this step cannot
        chain (admissions pending, mid-prefill rows, a request the step
        in flight does not hold, KV pressure, or under strict shapes a
        key that was not precompiled) and takes the host path."""
        if not self._async or self._inflight is None or self._pending:
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
                return None
            rows.append((uid, slot[uid], req))
        if not rows:
            return None
        if self._engine.model.strict_shapes:
            key = self._engine.predict_step_key(
                [u for u, _, _ in rows], [[0]] * len(rows),
                ("chain", int(self._inflight.tokens_dev.shape[0]),
                 all(r.params.temperature <= 0.0 for _, _, r in rows)))
            if key not in self._engine.model._step_cache:
                return None
        return rows

    def _dispatch_chain(self, rows) -> _Inflight:
        uids = [u for u, _, _ in rows]
        toks = self._engine.step_decode_chained(
            uids, self._inflight.tokens_dev, [r for _, r, _ in rows],
            [req.params for _, _, req in rows], self._generator)
        self.last_step_scheduled = len(uids)
        return _Inflight.start(
            toks, [(u, i, req) for i, (u, _, req) in enumerate(rows)])

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
            # parked pages the match revived were schedulable in this
            # admission's snapshot and are live now
            adm.free_pages -= before - (alloc.free_pages
                                        + alloc.parked_pages)

    # -- the step -------------------------------------------------------------
    def step(self, on_token: Optional[Callable[[int, int], None]] = None
             ) -> Dict[int, int]:
        """Schedule one ragged batch; returns {uid: new_token} for every
        sequence whose token reached the host this step (under
        ``async_scheduling`` the PREVIOUS step's tokens)."""
        out = self._step_impl(on_token)
        if self._kv_debug:
            self._engine.state_manager.check_invariants()
        return out

    def _step_impl(self, on_token) -> Dict[int, int]:
        chain = self._plan_chain()
        if chain is not None:
            # dispatch k+1 FIRST, then drain k: the wait for k's tokens
            # overlaps the device running k+1
            new_inflight = self._dispatch_chain(chain)
            out = self._drain(on_token)
            self._inflight = new_inflight
            return out

        out_prev = self._drain(on_token)
        adm = _Admission(self._engine, self._budget)
        uids: List[int] = []
        tokens: List[np.ndarray] = []
        reqs: List[Request] = []

        # 1. all running decodes (one token each)
        for uid, req in self._running.items():
            if req.prefill_remaining > 0:
                continue  # mid-prefill requests handled below
            if not adm.try_admit(uid, 1, is_new=False):
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
            if is_new and self._prefix_cfg and not req.prefix_checked:
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
            return True

        for req in list(self._running.values()):
            try_prefill(req, is_new=False)
        while self._pending and adm.tokens_left > 0:
            req = self._pending[0]
            if not try_prefill(req, is_new=True):
                break
            self._pending.pop(0)
            self._running[req.uid] = req

        self.last_step_scheduled = len(uids)
        if not uids:
            return out_prev
        sampled = [i for i, r in enumerate(reqs) if r.prefill_remaining == 0]
        # mid-prefill rows produce no token: pin them greedy so they can
        # neither flip the step into the sampling path nor draw from the
        # generator
        row_params = [r.params if r.prefill_remaining == 0
                      else SamplingParams() for r in reqs]
        toks, rowmap = self._engine.step_sample(
            uids, tokens, row_params, self._generator, do_checks=False)
        self._inflight = _Inflight.start(
            toks, [(uids[i], rowmap[i], reqs[i]) for i in sampled])
        if not self._async:
            out_prev.update(self._drain(on_token))
        return out_prev

    def run_to_completion(self) -> Dict[int, List[int]]:
        all_reqs = {r.uid: r for r in self._pending}
        all_reqs.update(self._running)
        stalls = 0
        while self.has_work:
            out = self.step()
            if self.last_step_scheduled == 0 and not out:
                stalls += 1
                if stalls >= 2:
                    raise RuntimeError(
                        "scheduler deadlock: work remains but nothing is "
                        "schedulable (KV cache exhausted or a request "
                        "exceeds engine limits); "
                        f"{len(self._pending)} pending, "
                        f"{len(self._running)} running, "
                        f"{self._engine.free_blocks} free KV pages")
            else:
                stalls = 0
        return {uid: req.generated for uid, req in all_reqs.items()}
