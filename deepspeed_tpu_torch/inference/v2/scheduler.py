"""Continuous-batching scheduler (Dynamic SplitFuse).

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py`` for the
synchronous fused path.  Every step fills a fixed token budget: running
decodes first (one token each), then prompt *chunks* of admitted
requests, so long prompts are split across steps and fused with decodes.
Each step is one ``InferenceEngineV2.step_sample`` (forward + on-device
sampling); its [S] int32 tokens are read back at once.  Admission runs
on incremental page/token/sequence counters (``_Admission``), as in the
JAX package.

Not ported yet (ROADMAP): the async double-buffered chain, speculation,
prefix caching, preemption, shedding/TTL, snapshots and handoffs; a
``serving`` config asking for one of them raises.  When
nothing is schedulable, ``run_to_completion`` raises instead of
preempting.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

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
    #: tokens of the prompt already sent to the engine
    prompt_sent: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def prefill_remaining(self) -> int:
        return len(self.prompt) - self.prompt_sent


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
    rows draw from; greedy-only steps never touch it."""

    def __init__(self, engine: InferenceEngineV2,
                 token_budget: Optional[int] = None, seed: int = 0,
                 serving: Optional[ServingOptimizationConfig] = None):
        self._engine = engine
        # the serving knobs are the engine's; a ``serving`` given here (as
        # ``FastGenScheduler(eng, serving=eng._config.serving)``) must
        # agree with the cache the engine already built
        if serving is not None:
            serving.validate()
            built = engine.model.kv_config.quantization
            if (serving.kv_quantization or "none") != built:
                raise ValueError(
                    f"serving.kv_quantization={serving.kv_quantization!r} "
                    f"but the engine's cache was built as {built!r}; the "
                    f"page encoding is fixed at engine build")
        self._budget = (token_budget or
                        engine._config.state_manager.max_ragged_batch_size)
        self._generator = torch.Generator(device=engine.model.device)
        self._generator.manual_seed(seed)
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
        return bool(self._pending or self._running)

    def _finish_request(self, req: Request) -> None:
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

    def step(self, on_token: Optional[Callable[[int, int], None]] = None
             ) -> Dict[int, int]:
        """Schedule one ragged batch; returns {uid: new_token} for every
        sequence that sampled a token this step."""
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
            return {}
        sampled = [i for i, r in enumerate(reqs) if r.prefill_remaining == 0]
        # mid-prefill rows produce no token: pin them greedy so they can
        # neither flip the step into the sampling path nor draw from the
        # generator
        row_params = [r.params if r.prefill_remaining == 0
                      else SamplingParams() for r in reqs]
        toks_dev, rowmap = self._engine.step_sample(
            uids, tokens, row_params, self._generator, do_checks=False)
        toks = toks_dev.cpu().numpy()          # the one [S] int32 d2h
        out: Dict[int, int] = {}
        for i in sampled:
            self._deliver(reqs[i], int(toks[rowmap[i]]), out, on_token)
        return out

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
