"""Replay a recorded workload trace against a live FastGenScheduler.

Counterpart of the JAX package's ``tools/replay_trace.py``.  It loads a
JSONL ledger written by ``telemetry/workload_trace.py``, synthesises
anonymised token-id prompts that keep each request's recorded lengths
and prefix sharing (a full page's tokens are a function of its recorded
chained digest, so two requests share a synthesised page exactly when
they shared a page at capture; the content is new, the structure the
same), re-issues the requests at full speed or at the recorded arrival
offsets scaled by ``--speed``, and diffs the replay's percentiles and
on-path capture counters against the recording.

Run as::

    python -m deepspeed_tpu_torch.tools.replay_trace \
        --trace tools/traces/sample_200.jsonl [--limit N] [--speed S] \
        [--spec [--drafter ngram|model|auto]] [--disagg [--journeys]] \
        [--tier [--tier-device-pages 4]] [--device cuda|cpu] [--check]

``--check`` exits non-zero when structural parity (request count,
lengths, share structure, arrival order) fails.

The model is random-initialised Llama (``--model-size``, default the
debug preset) at a page size and context taken from the trace.  Its dtype
follows the device: fp32 on the CPU, where the tests hold this tool to
the JAX tool token for token, and bf16 on the card, whose kernels take
bf16 only (``inference/v2/modules.py``).  A "compile" of the JAX tool is
a CUDA-graph capture here: the measured pass after the shape warm-up
must capture nothing (``compile_on_path``).  ``--tp`` above 1 raises
``NotImplementedError`` naming ROADMAP Queue 1 item 13, as the serving
config does.

Beside JAX's report keys, each replay report carries the step keys its
pass dispatched (``dispatches``: ``[[key], n]`` pairs) and the graphs it
captured on the path (``path_captures``); ``run_replay`` keeps its
warm-up passes' reports under ``warmup``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

#: the in-repo sample trace (a data file of the repository root)
SAMPLE_TRACE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tools", "traces", "sample_200.jsonl")


def percentile(vals, q: float):
    """Nearest-rank percentile over values (None entries dropped); None
    when empty.  The one implementation the replay report, the recorded
    side of the diff and ``analyze_trace`` share."""
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return None
    k = min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1))))
    return round(float(vals[k]), 3)


def _dtype_for(device: str):
    """fp32 on the CPU, bf16 on the card (the kernels' dtype)."""
    import torch
    return torch.float32 if device == "cpu" else torch.bfloat16


# -- trace loading -------------------------------------------------------------
def load_trace(path: str) -> Dict[str, Any]:
    """Parse a workload-trace ledger into ``{"meta", "requests",
    "compiles", "key_counts"}`` through the package's one parser
    (``inference.v2.lattice.load_trace_facts``); a replay also needs
    request records.  The rotated generation (``<path>.1``) is not
    read."""
    from ..inference.v2.lattice import load_trace_facts
    trace = load_trace_facts(path)
    if not trace["requests"]:
        raise ValueError(f"{path}: no request records")
    return trace


def _replayable(trace: Dict[str, Any], trace_path: str, limit: int,
                include_errors: bool) -> List[Dict[str, Any]]:
    requests = trace["requests"]
    if not include_errors:
        requests = [r for r in requests if r.get("outcome") == "ok"]
    if limit:
        requests = requests[:limit]
    if not requests:
        raise ValueError(f"{trace_path}: no replayable requests")
    return requests


# -- anonymised prompt synthesis -----------------------------------------------
def synthesize_prompts(requests: List[Dict[str, Any]], page_size: int,
                       vocab_size: int, seed: int = 0) -> List[np.ndarray]:
    """One int32 prompt per request (in record order) with the recorded
    lengths and prefix sharing: a full page's tokens are a function of
    its recorded cumulative digest (equal digests give equal pages), and
    the trailing partial page is unique per request (the prefix cache
    never shares a partial page, so this changes no structure)."""
    blocks: Dict[str, np.ndarray] = {}
    prompts: List[np.ndarray] = []
    for idx, rec in enumerate(requests):
        parts: List[np.ndarray] = []
        for digest in rec["digests"]:
            blk = blocks.get(digest)
            if blk is None:
                rng = np.random.default_rng(
                    (int(digest[:15], 16) << 17) ^ (seed & 0x1FFFF))
                blk = rng.integers(0, vocab_size, page_size,
                                   dtype=np.int64).astype(np.int32)
                blocks[digest] = blk
            parts.append(blk)
        rem = int(rec["prompt_len"]) - len(parts) * page_size
        if rem > 0:
            rng = np.random.default_rng(
                (seed << 24) ^ (idx * 2654435761 & 0x7FFFFFFF) ^ 0x5A5A)
            parts.append(rng.integers(0, vocab_size, rem,
                                      dtype=np.int64).astype(np.int32))
        prompts.append(np.concatenate(parts) if parts
                       else np.zeros(0, np.int32))
    return prompts


def share_signature_recorded(requests: List[Dict[str, Any]]) -> List[tuple]:
    """The recorded prompts' sharing structure: digests renamed to
    first-occurrence ordinals, one tuple per request."""
    ids: Dict[str, int] = {}
    return [tuple(ids.setdefault(d, len(ids)) for d in r["digests"])
            for r in requests]


def share_signature_prompts(prompts: List[np.ndarray], page_size: int
                            ) -> List[tuple]:
    """The same structure recomputed from token-id prompts through the
    prefix cache's own chained hash."""
    from ..inference.v2.ragged.prefix_cache import PrefixCache
    ids: Dict[bytes, int] = {}
    sigs = []
    for p in prompts:
        d = b""
        sig = []
        for i in range(len(p) // page_size):
            d = PrefixCache.chain(d, p[i * page_size:(i + 1) * page_size])
            sig.append(ids.setdefault(d, len(ids)))
        sigs.append(tuple(sig))
    return sigs


# -- engine construction -------------------------------------------------------
def _init_weights(cfg, device: str):
    """The replay's weights: random, from seed 0."""
    from ..models.transformer import init_params
    return init_params(cfg, seed=0, device=device)


def _replay_model_parts(meta: Dict[str, Any], requests: List[Dict[str, Any]],
                        model_size: str = "debug", device: str = "cuda",
                        layers: int = 0):
    """(cfg, params, page, need): the geometry every replay engine of one
    trace shares, so two engines can serve over one weight tree.
    ``layers`` > 0 cuts the preset's depth."""
    from ..models.llama import llama_config
    page = int(meta.get("page_size", 16))
    need = max(int(r["prompt_len"]) + max(1, int(r["gen_len"]))
               for r in requests) + page
    max_seq = 1
    while max_seq < need:
        max_seq *= 2
    over = {"num_layers": int(layers)} if layers else {}
    cfg = llama_config(model_size, max_seq_len=max(max_seq, 64),
                       dtype=_dtype_for(device), **over)
    return cfg, _init_weights(cfg, device), page, need


def _build_engine(cfg, params, page: int, need: int, num_pages: int,
                  max_seqs: int, serving=None, device: str = "cuda"):
    from ..inference.v2 import (InferenceEngineV2, KVCacheConfig,
                                RaggedInferenceEngineConfig,
                                RaggedInferenceModel, StateManagerConfig)
    if not num_pages:
        # a pool for max_seqs concurrent worst-case sequences
        per_seq = -(-need // page)
        num_pages = max(256, max_seqs * per_seq)
    kv_cfg = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                           head_dim=cfg.dims_per_head, page_size=page,
                           num_pages=num_pages, dtype=cfg.dtype)
    model = RaggedInferenceModel(cfg, params, kv_config=kv_cfg,
                                 device=device)
    econf = RaggedInferenceEngineConfig(
        state_manager=StateManagerConfig(
            max_tracked_sequences=max_seqs,
            max_ragged_sequence_count=max_seqs,
            max_ragged_batch_size=max(256, 4 * page)))
    if serving is not None:
        econf.serving = serving
    return InferenceEngineV2(model, econf)


def build_replay_engine(meta: Dict[str, Any], requests: List[Dict[str, Any]],
                        model_size: str = "debug", num_pages: int = 0,
                        max_seqs: int = 32, serving=None,
                        device: str = "cuda", layers: int = 0, parts=None):
    """An engine whose page size, context and KV pool fit the trace.  The
    replay measures scheduling and shapes (lattice coverage, sharing,
    relative SLOs), so the weights are random.  ``parts``: a
    :func:`_replay_model_parts` tuple to build over (one weight tree for
    several engines)."""
    cfg, params, page, need = parts or _replay_model_parts(
        meta, requests, model_size, device, layers)
    return _build_engine(cfg, params, page, need, num_pages, max_seqs,
                         serving=serving, device=device)


def build_disagg_engines(meta: Dict[str, Any], requests: List[Dict[str, Any]],
                         model_size: str = "debug", max_seqs: int = 32,
                         keyed: bool = True, device: str = "cuda",
                         layers: int = 0, parts=None):
    """(prefill engine, decode engine) over one weight tree, each with its
    serving role; ``keyed`` turns on schedule-invariant sampling on both,
    so sampled requests replay token for token as on the fused engine.
    The decode engine has twice the slots: a decode row is cheap, and a
    pool that serves no prompt chunks can batch more of them."""
    from ..inference.v2 import ServingOptimizationConfig
    cfg, params, page, need = parts or _replay_model_parts(
        meta, requests, model_size, device, layers)
    pre = _build_engine(
        cfg, params, page, need, 0, max_seqs,
        serving=ServingOptimizationConfig(role="prefill",
                                          keyed_sampling=keyed),
        device=device)
    dec = _build_engine(
        cfg, params, page, need, 0, 2 * max_seqs,
        serving=ServingOptimizationConfig(role="decode",
                                          keyed_sampling=keyed),
        device=device)
    return pre, dec


def _vocab(meta: Dict[str, Any], cfg) -> int:
    """The trace's vocabulary, clamped to the model's."""
    return min(int(meta.get("vocab_size", 0)) or cfg.vocab_size,
               cfg.vocab_size)


def _sampling_params(requests: List[Dict[str, Any]]):
    from ..inference.v2 import SamplingParams
    return [SamplingParams(
        temperature=float(r.get("temperature", 0.0)),
        top_k=int(r.get("top_k", 0)), top_p=float(r.get("top_p", 1.0)),
        max_new_tokens=max(1, int(r["gen_len"]))) for r in requests]


def _arrival_order(requests: List[Dict[str, Any]]) -> List[int]:
    return sorted(range(len(requests)),
                  key=lambda i: float(requests[i].get("arrival_s", 0.0)))


class _PassWatch:
    """The step keys dispatched and graphs captured on the path by one
    pass over ``engines``."""

    def __init__(self, engines):
        self.models = [e.model for e in engines]
        self.d0 = [dict(m.dispatch_counts) for m in self.models]
        self.c0 = [m.path_captures for m in self.models]

    def report(self) -> Dict[str, Any]:
        disp: Dict[tuple, int] = {}
        for m, d0 in zip(self.models, self.d0):
            for k, n in m.dispatch_counts.items():
                if n != d0.get(k, 0):
                    disp[k] = disp.get(k, 0) + n - d0.get(k, 0)
        return {"dispatches": [[list(k), n] for k, n in sorted(
                    disp.items(), key=lambda kv: repr(kv[0]))],
                "path_captures": sum(m.path_captures - c for m, c in
                                     zip(self.models, self.c0))}


# -- the replay loop -----------------------------------------------------------
def replay(engine, requests: List[Dict[str, Any]],
           prompts: List[np.ndarray], speed: float = 0.0,
           token_budget: Optional[int] = None, serving=None, on_token=None,
           capture: bool = False) -> Dict[str, Any]:
    """Re-issue the trace against a new FastGenScheduler on ``engine``.
    ``speed=0`` submits everything at once; ``speed>0`` paces submissions
    at the recorded arrival offsets divided by ``speed``.  Request ``i``
    runs with ``max_new_tokens = gen_len_i`` and no stop token, so the
    generated lengths reproduce whatever the sampled values.  Returns the
    replay's facts: generated lengths, TTFT percentiles, tokens/s and the
    pass's step-cache counters.  A live workload ledger is suspended for
    the drive, unless ``capture=True`` (the caller configured a private
    ledger and wants the replay's own request records)."""
    from ..telemetry.workload_trace import get_workload_trace
    if capture:
        return _replay_impl(engine, requests, prompts, speed, token_budget,
                            serving, on_token)
    with get_workload_trace().suspended():
        return _replay_impl(engine, requests, prompts, speed, token_budget,
                            serving, on_token)


def _replay_impl(engine, requests, prompts, speed, token_budget, serving,
                 user_on_token=None) -> Dict[str, Any]:
    from ..inference.v2 import FastGenScheduler
    from ..telemetry import metrics as tm
    order = _arrival_order(requests)
    params = _sampling_params(requests)
    sched = FastGenScheduler(engine, token_budget=token_budget,
                             serving=serving)
    watch = _PassWatch([engine])
    miss0 = tm.FASTGEN_STEP_CACHE_MISS.value
    comp0 = tm.FASTGEN_COMPILE_ON_PATH.value
    submit_t: Dict[int, float] = {}
    first_t: Dict[int, float] = {}
    gen: Dict[int, int] = {}
    submitted: List[int] = []
    token_count = [0]
    busy_s = 0.0
    nxt = 0
    stalls = 0

    def on_token(uid: int, tok: int) -> None:
        # per-token accounting rides the callback: a speculative step
        # commits a block of tokens a row, one entry in step()'s result
        token_count[0] += 1
        gen[uid] = gen.get(uid, 0) + 1
        first_t.setdefault(uid, time.perf_counter())
        if user_on_token is not None:
            user_on_token(uid, tok)

    t0 = time.perf_counter()
    while nxt < len(order) or sched.has_work:
        elapsed = (time.perf_counter() - t0) * (speed if speed > 0 else 1.0)
        while nxt < len(order) and (
                speed <= 0
                or float(requests[order[nxt]].get("arrival_s", 0.0))
                <= elapsed):
            i = order[nxt]
            if sched.submit(i, prompts[i], params[i]) is None:
                submit_t[i] = time.perf_counter()
                submitted.append(i)
            nxt += 1
        if sched.has_work:
            t_step = time.perf_counter()
            out = sched.step(on_token=on_token)
            busy_s += time.perf_counter() - t_step
            stalls = (stalls + 1 if sched.last_step_scheduled == 0
                      and not out else 0)
            if stalls > 64:
                raise RuntimeError(
                    "replay stalled: requests unschedulable (the trace "
                    "needs a larger KV pool or context than the replay "
                    "engine has)")
        elif nxt < len(order) and speed > 0:
            gap = (float(requests[order[nxt]].get("arrival_s", 0.0))
                   - elapsed) / speed
            time.sleep(min(max(gap, 0.0), 0.01))
    total = time.perf_counter() - t0
    ttfts = [(first_t[i] - submit_t[i]) * 1e3
             for i in submitted if i in first_t]
    return {
        "requests_submitted": len(submitted),
        "submit_order": submitted,
        "gen_lens": {i: gen.get(i, 0) for i in submitted},
        "errors": {int(u): e.code for u, e in sched.errors.items()},
        "wall_s": round(total, 4),
        "busy_s": round(busy_s, 4),
        "decode_tok_s": (round(token_count[0] / total, 1) if total
                         else None),
        "ttft_p50_ms": percentile(ttfts, 50),
        "ttft_p99_ms": percentile(ttfts, 99),
        "step_cache_miss": tm.FASTGEN_STEP_CACHE_MISS.value - miss0,
        "compile_on_path": tm.FASTGEN_COMPILE_ON_PATH.value - comp0,
        "spec_drafted": sched._spec_drafted_cum,
        "spec_accepted": sched._spec_accepted_cum,
        "spec_draft_drafted": sched._spec_draft_drafted_cum,
        "spec_draft_accepted": sched._spec_draft_accepted_cum,
        **watch.report(),
    }


# -- the two-pool (disaggregated) replay loop ------------------------------------
def _journey_report(pool, submitted: List[int], jlog) -> Dict[str, Any]:
    """Every completed request's journey: a flushed record, gap-free, its
    segments summing to the measured end-to-end latency; no orphaned
    fragment."""
    from ..telemetry import journey as dsjourney
    completed = {r["uid"]: r for r in jlog.completed()}
    problems: List[str] = []
    for i in submitted:
        preq = pool.request(i)
        if preq is None or not preq.done:
            continue
        rec = completed.get(i)
        if rec is None:
            problems.append(f"uid {i}: completed request has no flushed "
                            "journey")
            continue
        for g in dsjourney.chain_gaps(rec, eps_ms=5.0):
            problems.append(f"uid {i}: {g}")
        e2e_ms = (preq.finished_mono - preq.submit_mono) * 1e3
        seg_ms = sum(s["ms"] for s in rec["segments"])
        # the drain mark fires on the scheduler's finish sweep, up to one
        # step after the pool saw the last token
        if abs(seg_ms - e2e_ms) > max(75.0, 0.10 * e2e_ms):
            problems.append(f"uid {i}: journey segments sum "
                            f"{round(seg_ms, 1)}ms vs measured e2e "
                            f"{round(e2e_ms, 1)}ms")
    orphans = jlog.orphans()
    if orphans:
        problems.append(f"{len(orphans)} orphaned journey fragment(s): "
                        f"{orphans[:4]}")
    return {"completed_journeys": len(completed),
            "fragments": len(jlog.fragments()),
            "orphans": len(orphans), "problems": problems}


def replay_disagg(prefill_engine, decode_engine,
                  requests: List[Dict[str, Any]], prompts: List[np.ndarray],
                  speed: float = 0.0, threaded: bool = False, on_token=None,
                  journeys: bool = False) -> Dict[str, Any]:
    """Re-issue the trace through a new :class:`~..serving.DisaggPool`
    over the two engines.  The submission contract and report are
    :func:`replay`'s, so :func:`diff_replay` diffs both; the report adds
    the handoffs (count, bytes, p50 ms, pages streamed and shared), the
    pools' cost over their busy seconds and ``lost`` (requests neither
    completed nor structurally refused).  ``threaded`` drives the pool's
    stepper threads; ``journeys`` turns telemetry on for the pass and
    verifies every completed request's journey (``journeys`` block)."""
    from .. import telemetry as dstel
    from ..inference.v2 import FastGenScheduler
    from ..serving import DisaggPool
    from ..telemetry import journey as dsjourney
    from ..telemetry import metrics as tm
    from ..telemetry.workload_trace import get_workload_trace

    order = _arrival_order(requests)
    params = _sampling_params(requests)
    submit_t: Dict[int, float] = {}
    first_t: Dict[int, float] = {}
    gen: Dict[int, int] = {}
    submitted: List[int] = []
    token_count = [0]

    def _tap(uid: int, tok: int) -> None:
        token_count[0] += 1
        gen[uid] = gen.get(uid, 0) + 1
        first_t.setdefault(uid, time.perf_counter())
        if on_token is not None:
            on_token(uid, tok)

    pool = DisaggPool(lambda: FastGenScheduler(prefill_engine),
                      lambda: FastGenScheduler(decode_engine), on_token=_tap)
    watch = _PassWatch([prefill_engine, decode_engine])
    miss0 = tm.FASTGEN_STEP_CACHE_MISS.value
    comp0 = tm.FASTGEN_COMPILE_ON_PATH.value
    hand0 = tm.DISAGG_HANDOFFS.value
    bytes0 = tm.DISAGG_HANDOFF_BYTES.value
    stream0 = tm.DISAGG_PAGES_STREAMED.value
    share0 = tm.DISAGG_PAGES_SHARED.value
    handoff_ms: List[float] = []
    pool._on_handoff_ms = handoff_ms.append
    jlog = prev_enabled = None
    if journeys:
        # journeys need telemetry on; start from an empty log so the
        # verdicts see this pass alone
        jlog = dsjourney.get_journey_log()
        jlog.clear()
        prev_enabled = dstel.enabled()
        dstel.enable()
    nxt = 0
    stalls = 0
    with get_workload_trace().suspended():
        t0 = time.perf_counter()
        if threaded:
            pool.start()
        try:
            while nxt < len(order) or not pool.idle:
                elapsed = ((time.perf_counter() - t0)
                           * (speed if speed > 0 else 1.0))
                while nxt < len(order) and (
                        speed <= 0
                        or float(requests[order[nxt]].get("arrival_s", 0.0))
                        <= elapsed):
                    i = order[nxt]
                    if pool.submit(i, prompts[i], params[i]) is None:
                        submit_t[i] = time.perf_counter()
                        submitted.append(i)
                    nxt += 1
                if threaded:
                    if pool.idle and nxt >= len(order):
                        break
                    time.sleep(0.002)
                    continue
                if not pool.idle:
                    before = token_count[0]
                    pool.step()
                    stalls = stalls + 1 if token_count[0] == before else 0
                    if stalls > 512:
                        raise RuntimeError(
                            "disagg replay stalled: requests unschedulable "
                            "(the trace needs a larger KV pool than the "
                            "replay engines have)")
                elif nxt < len(order) and speed > 0:
                    gap = (float(requests[order[nxt]].get("arrival_s", 0.0))
                           - elapsed) / speed
                    time.sleep(min(max(gap, 0.0), 0.01))
            total = time.perf_counter() - t0
        finally:
            if threaded:
                pool.stop()
            if journeys:
                dstel.set_enabled(bool(prev_enabled))
    # each pool's cost over its busy seconds (the pool's gauge refresh
    # feeds both the ds_disagg_* gauges and this report)
    cost = pool.refresh_cost_gauges()
    ttfts = [(first_t[i] - submit_t[i]) * 1e3
             for i in submitted if i in first_t]
    lost = [i for i in submitted if not pool.request(i).finalized]
    return {
        "requests_submitted": len(submitted),
        "submit_order": submitted,
        "gen_lens": {i: gen.get(i, 0) for i in submitted},
        "errors": {int(u): e.code for u, e in pool.errors.items()},
        "lost": len(lost),
        "wall_s": round(total, 4),
        "decode_tok_s": (round(token_count[0] / total, 1) if total
                         else None),
        "ttft_p50_ms": percentile(ttfts, 50),
        "ttft_p99_ms": percentile(ttfts, 99),
        "step_cache_miss": tm.FASTGEN_STEP_CACHE_MISS.value - miss0,
        "compile_on_path": tm.FASTGEN_COMPILE_ON_PATH.value - comp0,
        "spec_drafted": 0,
        "spec_accepted": 0,
        "spec_draft_drafted": 0,
        "spec_draft_accepted": 0,
        "handoffs": tm.DISAGG_HANDOFFS.value - hand0,
        "handoff_bytes": tm.DISAGG_HANDOFF_BYTES.value - bytes0,
        "handoff_p50_ms": percentile(handoff_ms, 50),
        "pages_streamed": tm.DISAGG_PAGES_STREAMED.value - stream0,
        "pages_shared": tm.DISAGG_PAGES_SHARED.value - share0,
        "prefill_mfu": float(cost["prefill_mfu"]),
        "prefill_busy_s": round(pool.prefill_busy_s, 4),
        "decode_hbm_gb_s": float(cost["decode_hbm_gb_s"]),
        "decode_busy_s": round(pool.decode_busy_s, 4),
        "programs_prefill": len(prefill_engine.model._step_cache),
        "programs_decode": len(decode_engine.model._step_cache),
        "journeys": (_journey_report(pool, submitted, jlog) if journeys
                     else None),
        **watch.report(),
    }


def run_replay_disagg(trace_path: str, limit: int = 0,
                      include_errors: bool = False, speed: float = 0.0,
                      model_size: str = "debug", seed: int = 0,
                      warmup: bool = True, tolerance: float = 4.0,
                      keyed: bool = True, journeys: bool = False,
                      device: str = "cuda", layers: int = 0
                      ) -> Dict[str, Any]:
    """load, synthesise, (shape warm-up), the measured two-pool replay and
    the structural diff: :func:`run_replay`'s counterpart for the
    disaggregated pools."""
    trace = load_trace(trace_path)
    requests = _replayable(trace, trace_path, limit, include_errors)
    meta = trace["meta"]
    page = int(meta.get("page_size", 16))
    pre_eng, dec_eng = build_disagg_engines(
        meta, requests, model_size=model_size, keyed=keyed, device=device,
        layers=layers)
    prompts = synthesize_prompts(requests, page,
                                 _vocab(meta, pre_eng.model.cfg), seed=seed)
    out: Dict[str, Any] = {"trace": trace_path, "meta": meta,
                           "requests": len(requests)}
    if warmup:
        out["warmup"] = replay_disagg(pre_eng, dec_eng, requests, prompts)
        _reset_engine(pre_eng)
        _reset_engine(dec_eng)
    report = replay_disagg(pre_eng, dec_eng, requests, prompts, speed=speed,
                           journeys=journeys)
    out.update(replay=report, diff=diff_replay(requests, prompts, page,
                                               report, tolerance=tolerance))
    return out


def run_disagg_bench(trace_path: Optional[str] = None,
                     limit: Optional[int] = None, device: str = "cuda",
                     model_size: str = "debug",
                     layers: int = 0) -> Dict[str, Any]:
    """The disaggregation bench leg: one replayed trace through (a) the
    fused scheduler and (b) the two-pool scheduler, both keyed so the
    sampled requests are held token for token too, both single-threaded
    (a deterministic step and handoff sequence: the warm-up captures
    exactly the measured keys).  Returns prefill MFU and decode GB/s
    against the fused engine's over the same busy-window accounting,
    graphs and lattice sizes per pool, handoff p50 ms, the tokens/s
    ratio, on-path captures, lost requests and token identity."""
    from ..inference.v2 import ServingOptimizationConfig
    from ..inference.v2.engine import lattice_keys
    from ..inference.v2.model import serving_peak_flops
    from ..telemetry import metrics as tm

    if trace_path is None:
        trace_path = os.environ.get("BENCH_DISAGG_TRACE", SAMPLE_TRACE)
    if limit is None:
        limit = int(os.environ.get("BENCH_DISAGG_LIMIT", "64"))
    trace = load_trace(trace_path)
    requests = _replayable(trace, trace_path, limit, False)
    # a decode-weighted variant: the sample's ~4-token generations end
    # before the decode pool's chain warms up (prompts, sharing and
    # arrivals untouched; both arms serve the same scaled workload)
    gen_scale = int(os.environ.get("BENCH_DISAGG_GEN_SCALE", "4"))
    if gen_scale > 1:
        requests = [dict(r, gen_len=int(r["gen_len"]) * gen_scale)
                    for r in requests]
    meta = trace["meta"]
    page = int(meta.get("page_size", 16))
    parts = _replay_model_parts(meta, requests, model_size, device, layers)

    fused_eng = build_replay_engine(
        meta, requests, serving=ServingOptimizationConfig(
            keyed_sampling=True), device=device, parts=parts)
    prompts = synthesize_prompts(requests, page,
                                 _vocab(meta, fused_eng.model.cfg))
    replay(fused_eng, requests, prompts)            # shape warm-up
    _reset_engine(fused_eng)
    fused_eng.model.reset_cost_window()
    comp0 = tm.FASTGEN_COMPILE_ON_PATH.value
    fused_tokens: Dict[int, List[int]] = {}
    fused_rep = replay(
        fused_eng, requests, prompts,
        on_token=lambda u, t: fused_tokens.setdefault(u, []).append(t))
    fused_cost = fused_eng.model.cost_summary()
    fused_busy = max(float(fused_rep.get("busy_s") or 0.0), 1e-9)
    fused_mfu = (float(fused_cost.get("flops_dispatched", 0.0))
                 / fused_busy / serving_peak_flops())
    fused_hbm = float(fused_cost.get("bytes_dispatched", 0.0)) / fused_busy / 1e9
    fused_compiles = tm.FASTGEN_COMPILE_ON_PATH.value - comp0

    pre_eng, dec_eng = build_disagg_engines(meta, requests, device=device,
                                            parts=parts)
    replay_disagg(pre_eng, dec_eng, requests, prompts)  # shape warm-up
    _reset_engine(pre_eng)
    _reset_engine(dec_eng)
    pre_eng.model.reset_cost_window()
    dec_eng.model.reset_cost_window()
    disagg_tokens: Dict[int, List[int]] = {}
    rep = replay_disagg(
        pre_eng, dec_eng, requests, prompts,
        on_token=lambda u, t: disagg_tokens.setdefault(u, []).append(t))
    identical = all(fused_tokens.get(i) == disagg_tokens.get(i)
                    for i in range(len(requests)))

    def lat(engine):
        sm = engine._config.state_manager
        return dict(
            max_prompt=max(int(r["prompt_len"]) for r in requests),
            max_new_tokens=max(int(r["gen_len"]) for r in requests),
            max_concurrency=sm.max_ragged_sequence_count, page_size=page,
            max_ragged_batch_size=sm.max_ragged_batch_size,
            has_fresh=getattr(engine.model, "_fresh_attention",
                              None) is not None,
            sampling=True, spec_max_draft=0)
    return {
        "disagg_requests": len(requests),
        "disagg_agg_tok_s": rep["decode_tok_s"],
        "disagg_fused_tok_s": fused_rep["decode_tok_s"],
        "disagg_speedup_vs_fused": (
            round(rep["decode_tok_s"] / fused_rep["decode_tok_s"], 3)
            if fused_rep["decode_tok_s"] else None),
        "disagg_prefill_mfu": round(rep["prefill_mfu"], 9),
        "disagg_fused_mfu": round(fused_mfu, 9),
        "disagg_decode_hbm_gb_s": round(rep["decode_hbm_gb_s"], 4),
        "disagg_fused_hbm_gb_s": round(fused_hbm, 4),
        "disagg_handoff_p50_ms": rep["handoff_p50_ms"],
        "disagg_handoffs": rep["handoffs"],
        "disagg_handoff_bytes": rep["handoff_bytes"],
        "disagg_pages_streamed": rep["pages_streamed"],
        "disagg_pages_shared": rep["pages_shared"],
        "disagg_programs_prefill": rep["programs_prefill"],
        "disagg_programs_decode": rep["programs_decode"],
        "disagg_programs_fused": len(fused_eng.model._step_cache),
        "disagg_lattice_prefill": len(lattice_keys(
            kinds=("prefill", "decode"), **lat(pre_eng))),
        "disagg_lattice_decode": len(lattice_keys(
            kinds=("decode", "chain", "spec"), **lat(dec_eng))),
        "disagg_lattice_fused": len(lattice_keys(**lat(fused_eng))),
        "disagg_compile_on_path_total": rep["compile_on_path"],
        "disagg_fused_compile_on_path_total": fused_compiles,
        "disagg_lost_requests": rep["lost"],
        "disagg_tokenwise_identical": int(identical),
        "disagg_ttft_p50_ms": rep["ttft_p50_ms"],
        "disagg_fused_ttft_p50_ms": fused_rep["ttft_p50_ms"],
    }


# -- the host/disk tier replay legs -------------------------------------------------
def build_tier_engine(meta: Dict[str, Any], requests: List[Dict[str, Any]],
                      device_pages: int = 4, host_pages: int = 8,
                      disk_pages: int = 256, tier_dir: str = "",
                      model_size: str = "debug", max_seqs: int = 2,
                      quant: str = "none", device: str = "cuda",
                      layers: int = 0, parts=None):
    """A device-starved replay engine over the host/disk prefix tier: the
    pool is clamped up to the smallest schedulable size >=
    ``device_pages`` (every admitted sequence pins its matched pages: the
    floor is the worst-case active set, each with a landing page), so
    parked prefix pages demote almost at once and a returning prefix
    comes back through promotion.  Keyed sampling makes the tokens
    schedule-invariant, so warm-from-tier can be held to cold."""
    from ..inference.v2 import ServingOptimizationConfig
    cfg, params, page, need = parts or _replay_model_parts(
        meta, requests, model_size, device, layers)
    per_seq = -(-need // page)
    num_pages = max(int(device_pages), max_seqs * (per_seq + 1))
    serving = ServingOptimizationConfig(
        keyed_sampling=True, kv_quantization=quant,
        kv_tier_host_pages=host_pages, kv_tier_disk_pages=disk_pages,
        kv_tier_dir=tier_dir)
    return _build_engine(cfg, params, page, need, num_pages, max_seqs,
                         serving=serving, device=device)


def run_tier_smoke(trace_path: str, limit: int = 0,
                   include_errors: bool = False, device_pages: int = 4,
                   host_pages: int = 8, disk_pages: int = 256,
                   model_size: str = "debug", seed: int = 0,
                   tolerance: float = 4.0, device: str = "cuda",
                   layers: int = 0, on_engine=None) -> Dict[str, Any]:
    """Two replays of one trace on one device-starved tiered engine.  Wave
    1 prefills cold and every parked prefix page demotes (device -> host
    ring -> disk through the async I/O handle); wave 2 resubmits the same
    requests, so every returning prefix comes back through promotion.
    ``diff`` carries the structural verdict plus the tier's: demotions
    and disk spills happened, wave 2 promoted pages, wave 2's tokens are
    wave 1's (keyed sampling), the store's accounting holds.
    ``on_engine(engine)`` runs on the built engine before wave 1 (a
    caller's instrumentation)."""
    import shutil
    import tempfile

    trace = load_trace(trace_path)
    requests = _replayable(trace, trace_path, limit, include_errors)
    meta = trace["meta"]
    page = int(meta.get("page_size", 16))
    tier_dir = tempfile.mkdtemp(prefix="ds_tier_smoke_")
    engine = None
    try:
        engine = build_tier_engine(
            meta, requests, device_pages=device_pages,
            host_pages=host_pages, disk_pages=disk_pages, tier_dir=tier_dir,
            model_size=model_size, device=device, layers=layers)
        if on_engine is not None:
            on_engine(engine)
        prompts = synthesize_prompts(requests, page,
                                     _vocab(meta, engine.model.cfg),
                                     seed=seed)
        tok1: Dict[int, List[int]] = {}
        tok2: Dict[int, List[int]] = {}
        rep1 = replay(engine, requests, prompts,
                      on_token=lambda u, t: tok1.setdefault(u, []).append(t))
        tiers = engine.state_manager.tiers
        stats1 = tiers.stats()
        rep2 = replay(engine, requests, prompts,
                      on_token=lambda u, t: tok2.setdefault(u, []).append(t))
        stats2 = tiers.stats()
        verdict = diff_replay(requests, prompts, page, rep2,
                              tolerance=tolerance)
        problems = list(verdict["problems"])
        if stats1["demoted_pages"] <= 0:
            problems.append(
                "[tier] wave 1 demoted no pages: the device-starved pool "
                "should have evicted every parked prefix page into the "
                "host tier")
        if disk_pages > 0 and stats2["spilled_pages"] <= 0:
            problems.append(
                "[tier] nothing spilled host -> disk although a disk tier "
                "was configured and the host ring is tiny")
        if stats2["promoted_pages"] <= stats1["promoted_pages"]:
            problems.append(
                "[tier] wave 2 promoted no pages: returning prefixes "
                "recomputed instead of warming from the tier")
        if tok2 != tok1:
            diff_uids = sorted(u for u in tok1 if tok1.get(u) != tok2.get(u))
            problems.append(
                f"[tier] warm-from-tier tokens differ from cold for "
                f"request(s) {diff_uids[:8]}: promotion corrupted page "
                "contents")
        try:
            tiers.check_invariants()
        except RuntimeError as e:
            problems.append(f"[tier] store accounting broken: {e}")
        verdict = dict(verdict, problems=problems, structural_ok=not problems)
        return {"trace": trace_path, "meta": meta,
                "requests": len(requests),
                "device_pages": engine.model.kv_config.num_pages,
                "wave1": rep1, "replay": rep2,
                "tokens": {"wave1": tok1, "wave2": tok2},
                "tier": stats2, "diff": verdict}
    finally:
        if engine is not None:
            engine.state_manager.close()
        shutil.rmtree(tier_dir, ignore_errors=True)


def run_tier_bench(trace_path: Optional[str] = None,
                   limit: Optional[int] = None, device: str = "cuda",
                   model_size: str = "debug",
                   layers: int = 0) -> Dict[str, Any]:
    """The tier bench leg, three parts over one replayed trace:

    1. int8 pages at the fp pool's device bytes: resident sequences from
       ``bytes_per_page`` (``pages_for_memory``), and an fp against int8
       replay's TTFT p99 and tokens/s;
    2. the host/disk tier: a device-starved tiered engine replays the
       trace three times; the third wave's per-request tier attribution
       is captured into a private ledger and mined (prefix hit rate by
       tier), with promote-batch p50 ms;
    3. cross-replica page fetch: a 2-replica pool serves one warm-prefix
       request with page fetch on and, under the same backlog, cold with
       it off: fetch TTFT against recompute TTFT."""
    import dataclasses as _dc
    import shutil
    import tempfile

    from ..inference.v2 import (FastGenScheduler, SamplingParams,
                                ServingOptimizationConfig)
    from ..inference.v2.lattice import load_trace_facts
    from ..inference.v2.ragged.kv_cache import KVCacheConfig, pages_for_memory
    from ..serving import ReplicaPool
    from ..telemetry import metrics as tm
    from ..telemetry.workload_trace import get_workload_trace

    if trace_path is None:
        trace_path = os.environ.get("BENCH_TIER_TRACE", SAMPLE_TRACE)
    if limit is None:
        limit = int(os.environ.get("BENCH_TIER_LIMIT", "48"))
    trace = load_trace(trace_path)
    requests = _replayable(trace, trace_path, limit, False)
    meta = trace["meta"]
    parts = _replay_model_parts(meta, requests, model_size, device, layers)
    cfg, params, page, need = parts
    per_seq = -(-need // page)
    max_seqs = 32

    # capacity at equal device bytes, the budget constrained (8
    # worst-case fp sequences for a 32-request wave) so KV capacity binds
    fp_pages = 8 * (per_seq + 1)
    fp_kv = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                          head_dim=cfg.dims_per_head, page_size=page,
                          num_pages=fp_pages, dtype=cfg.dtype)
    budget = fp_pages * fp_kv.bytes_per_page
    q_pages = pages_for_memory(_dc.replace(fp_kv, quantization="int8"),
                               budget)
    out: Dict[str, Any] = {
        "tier_requests": len(requests),
        "tier_device_budget_mb": round(budget / 1e6, 2),
        "tier_resident_seqs_fp": fp_pages // per_seq,
        "tier_resident_seqs_int8": q_pages // per_seq,
        "tier_resident_seq_ratio": round(
            (q_pages // per_seq) / max(fp_pages // per_seq, 1), 3),
    }
    vocab = _vocab(meta, cfg)
    prompts = synthesize_prompts(requests, page, vocab)

    # part 1: fp against int8 at the same byte budget
    fp_eng = _build_engine(cfg, params, page, need, fp_pages, max_seqs,
                           device=device)
    replay(fp_eng, requests, prompts)            # shape warm-up
    _reset_engine(fp_eng)
    before = replay(fp_eng, requests, prompts)
    q_eng = _build_engine(
        cfg, params, page, need, q_pages, max_seqs,
        serving=ServingOptimizationConfig(kv_quantization="int8"),
        device=device)
    replay(q_eng, requests, prompts)             # shape warm-up
    _reset_engine(q_eng)
    after = replay(q_eng, requests, prompts)
    out.update({
        "tier_ttft_p99_before_ms": before["ttft_p99_ms"],
        "tier_ttft_p99_after_ms": after["ttft_p99_ms"],
        "tier_fp_decode_tok_s": before["decode_tok_s"],
        "tier_int8_decode_tok_s": after["decode_tok_s"],
        "tier_fp_compile_on_path": before["compile_on_path"],
        "tier_int8_compile_on_path": after["compile_on_path"],
        "tier_compile_on_path_total": (before["compile_on_path"]
                                       + after["compile_on_path"]),
    })

    # part 2: the host/disk tier, the warm wave mined from its own ledger
    tier_dir = tempfile.mkdtemp(prefix="ds_tier_bench_")
    t_eng = None
    try:
        t_eng = build_tier_engine(meta, requests, device_pages=4,
                                  host_pages=max(8, per_seq),
                                  disk_pages=4096, tier_dir=tier_dir,
                                  device=device, parts=parts)
        cold = replay(t_eng, requests, prompts)  # wave 1: demotes
        # wave 2 warms the warm-shape keys (promoted requests form mixed
        # keys a cold wave never dispatches); the tier state cycles, so
        # wave 3 forms the same keys again
        replay(t_eng, requests, prompts)
        ledger = os.path.join(tier_dir, "tier_warm_wave.jsonl")
        wt = get_workload_trace()
        wt.configure(ledger)
        try:
            warm = replay(t_eng, requests, prompts, capture=True)
        finally:
            wt.close()
        stats = t_eng.state_manager.tiers.stats()
        recs = load_trace_facts(ledger)["requests"]
        prompt_tokens = sum(int(r["prompt_len"]) for r in recs) or 1
        hits = {t: sum(int(r.get(f"hit_{t}", 0)) for r in recs)
                for t in ("device", "host", "disk", "remote")}
        out.update({
            "tier_prefix_hit_rate": round(sum(hits.values())
                                          / prompt_tokens, 4),
            **{f"tier_{t}_hit_rate": round(hits[t] / prompt_tokens, 4)
               for t in ("device", "host", "disk", "remote")},
            "tier_demoted_pages": stats["demoted_pages"],
            "tier_promoted_pages": stats["promoted_pages"],
            "tier_spilled_pages": stats["spilled_pages"],
            "tier_io_errors": stats["io_errors"],
            "tier_plain_io": stats["plain_io"],
            "tier_cold_ttft_p99_ms": cold["ttft_p99_ms"],
            "tier_warm_ttft_p99_ms": warm["ttft_p99_ms"],
            "tier_promote_p50_ms": (
                round(tm.KV_TIER_PROMOTE_MS.percentile(50), 3)
                if tm.KV_TIER_PROMOTE_MS.count else None),
            "tier_warm_compile_on_path": warm["compile_on_path"],
        })
        out["tier_compile_on_path_total"] += warm["compile_on_path"]
    finally:
        if t_eng is not None:
            t_eng.state_manager.close()
        shutil.rmtree(tier_dir, ignore_errors=True)

    # part 3: cross-replica page fetch against recompute; a long (20-page)
    # prefix, on its own geometry (the trace-sized engines cannot seat it)
    fetch_prefix_pages = 20
    fetch_need = (fetch_prefix_pages + 2) * page + 16
    fcfg, fparams, _, _ = _replay_model_parts(
        meta, [{"prompt_len": fetch_need - page, "gen_len": 8}], model_size,
        device, layers)
    engines: Dict[str, Any] = {}

    def factory(label):
        eng = engines.get(label)
        if eng is None:
            eng = _build_engine(fcfg, fparams, page, fetch_need, 0, 8,
                                device=device)
            engines[label] = eng
        return FastGenScheduler(eng)

    def _p(seed_, n):
        rng = np.random.default_rng(seed_)
        return rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)

    warm_prefix = _p(1, fetch_prefix_pages * page)
    full = np.concatenate([warm_prefix, _p(2, page // 2)])
    sp = SamplingParams(max_new_tokens=8, temperature=0.0)

    def scenario(margin, warm_):
        """One placement; both arms see the same backlog (2 queued on r0,
        1 on r1), so the measured TTFT differs by fetch against
        recompute only."""
        for eng in engines.values():
            _reset_engine(eng)
        pool = ReplicaPool(factory, replicas=2, page_fetch_margin=margin)
        if warm_:
            pool.submit(1, warm_prefix, sp)
            pool.run_to_completion()
            pool.publish_hints()
        for uid, s in ((2, 7), (3, 8), (4, 9)):
            pool.submit(uid, _p(s, 3 * page), sp)
        pool.submit(100, full, sp)
        pool.run_to_completion()
        req = pool.request(100)
        return ((req.first_token_mono - req.submit_mono) * 1e3, req.replica)

    # the warm-up includes a fetch: the import side's restore has shapes
    # of its own
    scenario(0, True)
    scenario(-1, False)
    f0, fp0 = tm.POOL_PAGE_FETCHES.value, tm.POOL_PAGE_FETCH_PAGES.value
    fetch_ttft, fetch_rep = min(scenario(0, True) for _ in range(3))
    fetches = tm.POOL_PAGE_FETCHES.value - f0
    recompute_ttft = min(scenario(-1, False)[0] for _ in range(3))
    out.update({
        "tier_fetch_prefix_tokens": len(warm_prefix),
        "tier_fetch_ttft_ms": round(fetch_ttft, 3),
        "tier_recompute_ttft_ms": round(recompute_ttft, 3),
        "tier_fetch_speedup_vs_recompute": (
            round(recompute_ttft / fetch_ttft, 3) if fetch_ttft else None),
        "tier_fetch_count": fetches,
        "tier_fetch_pages": tm.POOL_PAGE_FETCH_PAGES.value - fp0,
        "tier_fetch_replica": fetch_rep,
    })
    return out


# -- recorded against replayed ---------------------------------------------------
def recorded_percentiles(requests: List[Dict[str, Any]]
                         ) -> Dict[str, Optional[float]]:
    ttfts = [r.get("ttft_ms") for r in requests]
    waits = [r.get("queue_wait_ms") for r in requests]
    return {"ttft_p50_ms": percentile(ttfts, 50),
            "ttft_p99_ms": percentile(ttfts, 99),
            "queue_wait_p50_ms": percentile(waits, 50)}


def diff_replay(requests: List[Dict[str, Any]], prompts: List[np.ndarray],
                page_size: int, report: Dict[str, Any],
                tolerance: float = 4.0) -> Dict[str, Any]:
    """Structural parity and SLO diff of one replay against its trace.
    The structure must match exactly (count, prompt and generated
    lengths, sharing, arrival order); latency percentiles within a
    multiplicative ``tolerance``."""
    problems: List[str] = []
    n = len(requests)
    if report["requests_submitted"] != n:
        problems.append(f"request count: {report['requests_submitted']} "
                        f"replayed vs {n} recorded")
    for i, rec in enumerate(requests):
        if len(prompts[i]) != int(rec["prompt_len"]):
            problems.append(f"req {i}: prompt_len {len(prompts[i])} vs "
                            f"recorded {rec['prompt_len']}")
        want = max(1, int(rec["gen_len"]))
        got = report["gen_lens"].get(i)
        if got != want:
            problems.append(f"req {i}: gen_len {got} vs recorded {want}")
    if (share_signature_prompts(prompts, page_size)
            != share_signature_recorded(requests)):
        problems.append("share structure: synthesized prompts do not "
                        "reproduce the recorded digest classes")
    if report["submit_order"] != _arrival_order(requests):
        problems.append("arrival order: replay submitted out of recorded "
                        "order")
    rec_pct = recorded_percentiles(requests)
    slo = {}
    for key in ("ttft_p50_ms", "ttft_p99_ms"):
        a, b = rec_pct.get(key), report.get(key)
        slo[key] = {"recorded": a, "replayed": b,
                    "ratio": round(b / a, 3) if a and b else None}
    within = all(v["ratio"] is None
                 or 1.0 / tolerance <= v["ratio"] <= tolerance
                 for v in slo.values())
    return {"structural_ok": not problems, "problems": problems,
            "slo": slo, "slo_within_tolerance": within,
            "tolerance": tolerance,
            "compile_on_path": report["compile_on_path"],
            "recorded_queue_wait_p50_ms": rec_pct["queue_wait_p50_ms"]}


def _reset_engine(engine) -> None:
    """Flush every tracked sequence and drop the prefix cache: the next
    pass starts from a cold engine (its graphs stay)."""
    for uid in list(engine.state_manager._seqs):
        engine.flush(uid)
    engine.reset_prefix_cache()


def run_replay(trace_path: str, limit: int = 0, include_errors: bool = False,
               speed: float = 0.0, model_size: str = "debug", seed: int = 0,
               warmup: bool = True, tolerance: float = 4.0,
               spec: bool = False, drafter: str = "ngram", tp: int = 1,
               device: str = "cuda", layers: int = 0,
               capture: bool = False) -> Dict[str, Any]:
    """load, filter, build, synthesise, (shape warm-up), the measured
    replay and its diff: one sequence for the CLI, the smoke and a bench,
    so they cannot drift on the warm-up or the vocabulary clamp.  With
    ``spec`` the workload replays again with speculative decoding and the
    report gains a ``spec`` block (accept rate, tokens/s on and off, the
    spec pass's own diff: speculation changes throughput, nothing
    else).  ``drafter`` picks the spec pass's drafter: ``ngram`` reuses
    the engine (host state only); ``model`` and ``auto`` build a spec
    engine with the draft trunk.  ``tp`` > 1 raises
    ``NotImplementedError`` (ROADMAP Queue 1 item 13).  ``capture``: the
    measured pass records into the live workload ledger (the caller
    configured one), as :func:`replay`'s ``capture``."""
    from ..inference.v2 import ServingOptimizationConfig
    trace = load_trace(trace_path)
    requests = _replayable(trace, trace_path, limit, include_errors)
    meta = trace["meta"]
    page = int(meta.get("page_size", 16))
    base_serving = (ServingOptimizationConfig(tp_degree=tp) if tp > 1
                    else None)
    parts = _replay_model_parts(meta, requests, model_size, device, layers)
    engine = build_replay_engine(meta, requests, serving=base_serving,
                                 device=device, parts=parts)
    prompts = synthesize_prompts(requests, page,
                                 _vocab(meta, engine.model.cfg), seed=seed)
    out: Dict[str, Any] = {"trace": trace_path, "meta": meta,
                           "requests": len(requests),
                           "recorded_compiles": len(trace["compiles"]),
                           "tp": int(max(tp, 1))}
    if warmup:
        # an untimed shape warm-up: the measured replay then shows the
        # real on-path captures, not the cold start
        out["warmup"] = replay(engine, requests, prompts, speed=0.0)
        _reset_engine(engine)
    report = replay(engine, requests, prompts, speed=speed, capture=capture)
    out.update(replay=report, diff=diff_replay(requests, prompts, page,
                                               report, tolerance=tolerance))
    if spec:
        spec_serving = ServingOptimizationConfig(
            speculative=True, spec_drafter=drafter, tp_degree=tp)
        # the n-gram drafter is host state: same engine; the draft trunk
        # and its KV are engine state: a spec engine of their own
        spec_engine = (engine if drafter == "ngram" else build_replay_engine(
            meta, requests, serving=spec_serving, device=device,
            parts=parts))
        spec_warm = None
        if warmup:
            _reset_engine(spec_engine)
            spec_warm = replay(spec_engine, requests, prompts, speed=0.0,
                               serving=spec_serving)
        _reset_engine(spec_engine)
        spec_report = replay(spec_engine, requests, prompts, speed=speed,
                             serving=spec_serving)
        spec_diff = diff_replay(requests, prompts, page, spec_report,
                                tolerance=tolerance)
        drafted = spec_report["spec_drafted"]
        off_tok_s = report["decode_tok_s"]

        def _rate(acc, dr):
            return round(acc / dr, 4) if dr else None

        d_model = spec_report["spec_draft_drafted"]
        a_model = spec_report["spec_draft_accepted"]
        d_ngram = drafted - d_model
        a_ngram = spec_report["spec_accepted"] - a_model
        out["spec"] = {
            "replay": spec_report, "diff": spec_diff, "drafter": drafter,
            "accept_rate": _rate(spec_report["spec_accepted"], drafted),
            "drafted": drafted, "accepted": spec_report["spec_accepted"],
            "per_drafter": {
                "ngram": {"drafted": d_ngram, "accepted": a_ngram,
                          "accept_rate": _rate(a_ngram, d_ngram)},
                "model": {"drafted": d_model, "accepted": a_model,
                          "accept_rate": _rate(a_model, d_model)},
            },
            "tok_s_off": off_tok_s,
            "tok_s_on": spec_report["decode_tok_s"],
            "tok_s_ratio": (round(spec_report["decode_tok_s"] / off_tok_s, 3)
                            if off_tok_s else None),
        }
        if spec_warm is not None:
            out["spec"]["warmup"] = spec_warm
    return out


# -- CLI -----------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", required=True, help="workload JSONL path")
    ap.add_argument("--speed", type=float, default=0.0,
                    help="arrival pacing: 0 = full speed (default), 1 = "
                    "recorded offsets, 2 = twice as fast, ...")
    ap.add_argument("--limit", type=int, default=0,
                    help="replay only the first N requests (0 = all)")
    ap.add_argument("--model-size", default="debug",
                    help="Llama preset of the replay engine")
    ap.add_argument("--seed", type=int, default=0,
                    help="prompt-synthesis seed")
    ap.add_argument("--tolerance", type=float, default=4.0,
                    help="SLO percentile agreement factor")
    ap.add_argument("--include-errors", action="store_true",
                    help="also replay requests whose recorded outcome was "
                    "a structured error (default: ok only)")
    ap.add_argument("--spec", action="store_true",
                    help="replay a second pass with speculative decoding "
                    "and report the accept rate and the tokens/s change")
    ap.add_argument("--drafter", default="ngram",
                    choices=("ngram", "model", "auto"),
                    help="drafter of the --spec pass: model and auto build "
                    "the spec engine with the draft trunk and the report "
                    "splits the accept rate by drafter")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree of the replay engine; "
                    "above 1 raises NotImplementedError (ROADMAP Queue 1 "
                    "item 13)")
    ap.add_argument("--disagg", action="store_true",
                    help="replay through the two-pool disaggregated "
                    "prefill/decode scheduler (KV handoffs, keyed sampling "
                    "on both pools); --check also requires 0 lost requests")
    ap.add_argument("--tier", action="store_true",
                    help="replay twice on one device-starved engine over "
                    "the host/disk prefix tier: wave 1 demotes every "
                    "parked page, wave 2 warms back through promotion; "
                    "--check also requires demotions, disk spills, "
                    "promotions, warm == cold tokens and clean accounting")
    ap.add_argument("--tier-device-pages", type=int, default=4,
                    help="device pool asked for with --tier (clamped up to "
                    "the smallest schedulable pool)")
    ap.add_argument("--tier-host-pages", type=int, default=8,
                    help="host ring capacity with --tier (tiny, so disk "
                    "spills too)")
    ap.add_argument("--tier-disk-pages", type=int, default=256,
                    help="disk tier capacity with --tier (0 turns the disk "
                    "tier and its spill check off)")
    ap.add_argument("--journeys", action="store_true",
                    help="with --disagg: telemetry on for the measured "
                    "pass, every completed request's journey gap-free and "
                    "summing to its end-to-end latency, no orphaned "
                    "fragment; --check fails on any finding")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the untimed shape warm-up (the measured pass "
                    "then captures the graphs)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless structural parity holds")
    ap.add_argument("--json", default="",
                    help="also write the full report to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the replay engine serves (cpu: fp32 and the "
                    "plain versions of the kernels)")
    args = ap.parse_args(argv)
    if args.tp > 1 and (args.tier or args.disagg):
        ap.error("--tp shards the base/--spec replay only; the tier and "
                 "disagg legs build their own engines")
    if args.journeys and not args.disagg:
        ap.error("--journeys rides the --disagg leg (the journey smoke "
                 "verifies the handoff segments)")
    try:
        if args.tier:
            out = run_tier_smoke(
                args.trace, limit=args.limit,
                include_errors=args.include_errors,
                device_pages=args.tier_device_pages,
                host_pages=args.tier_host_pages,
                disk_pages=args.tier_disk_pages, model_size=args.model_size,
                seed=args.seed, tolerance=args.tolerance,
                device=args.device)
        elif args.disagg:
            out = run_replay_disagg(
                args.trace, limit=args.limit,
                include_errors=args.include_errors, speed=args.speed,
                model_size=args.model_size, seed=args.seed,
                warmup=not args.no_warmup, tolerance=args.tolerance,
                journeys=args.journeys, device=args.device)
        else:
            out = run_replay(
                args.trace, limit=args.limit,
                include_errors=args.include_errors, speed=args.speed,
                model_size=args.model_size, seed=args.seed,
                warmup=not args.no_warmup, tolerance=args.tolerance,
                spec=args.spec, drafter=args.drafter, tp=args.tp,
                device=args.device)
    except ValueError as e:
        print(f"replay_trace: {e}", file=sys.stderr)
        return 1
    verdict = out["diff"]
    print(json.dumps(out, indent=1, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    problems = (list(verdict["problems"]) if not verdict["structural_ok"]
                else [])
    if args.disagg and out["replay"].get("lost"):
        problems.append(f"[disagg] {out['replay']['lost']} request(s) lost "
                        "(neither completed nor structurally errored)")
    if args.journeys:
        jrep = out["replay"].get("journeys") or {}
        problems += [f"[journey] {p}" for p in jrep.get("problems", ())]
        if not jrep.get("completed_journeys"):
            problems.append("[journey] no journeys flushed during the "
                            "measured replay")
    if args.spec and not out["spec"]["diff"]["structural_ok"]:
        # speculation may change throughput and metrics, not structure
        problems += [f"[spec] {p}" for p in out["spec"]["diff"]["problems"]]
    if args.check and problems:
        print("replay_trace: STRUCTURAL PARITY FAILED", file=sys.stderr)
        for p in problems:
            print(f"replay_trace:   {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
