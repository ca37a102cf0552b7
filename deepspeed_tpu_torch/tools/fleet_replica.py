"""One serving replica as a process: the unit the fleet federation
scrapes.

Counterpart of the JAX package's ``tools/fleet_replica.py``, with the
same flags, handshake and progress lines.  Run as::

    python -m deepspeed_tpu_torch.tools.fleet_replica --label r0 \
        [--device cuda|cpu] [--model debug|7b] [--rounds N] ...

It builds an engine (``--model debug``: the debug Llama in fp32;
``--model 7b``: Llama-2-7B at full width and depth in bf16, random
weights drawn from ``--seed`` on the device), starts the metrics
endpoint on an ephemeral port (``--port 0``, the default, so N replicas
on one host never collide), turns telemetry and the time-series sampler
on, and serves a synthetic workload in rounds (:func:`synthetic_workload`;
a parent reproduces its prompts from the same flags).  The parent reads
the handshake line::

    FLEET_REPLICA ready label=<label> port=<port> pid=<pid>

then scrapes ``http://127.0.0.1:<port>/snapshot?raw=1`` like any other
replica.  Progress lines follow: ``FLEET_REPLICA round=<n> done``, then
``FLEET_REPLICA stats <json>`` (wall-clock stamps of ready and of the
first token, decode step median ms and tokens/s of the rounds after the
first, the kernels' launches), ``FLEET_REPLICA digests <json>`` (the
engine's ``export_digests(4096)``: every digest its cache holds, which
``/snapshot?digests=1&top_k=4096`` must serve) and ``FLEET_REPLICA done``; the replica then lingers
(``--linger-s``) so a controller can scrape its final state.  Arm
``DS_CHAOS="serving.preempt:at=<N>"`` in its environment to kill it
mid-serving through the fault site: it prints ``FLEET_REPLICA
preempted`` and exits with status 17 at once, endpoint and all, as a
preempted machine vanishes.

``--device`` defaults to ``cuda`` and raises without a GPU (the tests
pass ``cpu``).  ``--trace`` (replaying a captured workload trace) needs
the replay tool, which is not ported (ROADMAP Queue 1 item 12c).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Tuple

EXIT_PREEMPTED = 17
#: the digests the replica prints: every one its cache holds (the
#: metrics endpoint caps a ``top_k`` at this too)
HINT_TOP_K = 4096


def synthetic_workload(vocab: int, requests: int, prompt_len: int,
                       shared_prefix: int, seed: int, max_new: int):
    """The replica's requests: ``[(prompt, SamplingParams)]``, greedy,
    ``max_new`` tokens each, drawn from ``seed``.  With
    ``shared_prefix`` 0 every prompt is ``prompt_len`` random tokens (the
    JAX replica's workload).  Otherwise the first half of the requests
    share one ``shared_prefix``-token prefix with tails of 64-256 tokens,
    and the second half are cold prompts of 128-1024 tokens."""
    import numpy as np
    from ..inference.v2 import SamplingParams
    rng = np.random.default_rng(seed)
    sp = SamplingParams(max_new_tokens=max_new, temperature=0.0)
    if not shared_prefix:
        return [(rng.integers(0, vocab, prompt_len).tolist(), sp)
                for _ in range(requests)]
    prefix = rng.integers(0, vocab, shared_prefix)
    warm = (requests + 1) // 2
    out = []
    for i in range(requests):
        if i < warm:
            tail = rng.integers(0, vocab, int(rng.integers(64, 257)))
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(0, vocab, int(rng.integers(128, 1025)))
        out.append((prompt.tolist(), sp))
    return out


def build_engine(model: str, device: str, seed: int, page_size: int,
                 num_pages: int, max_seqs: int, token_budget: int):
    """The replica's engine: the debug Llama (fp32, a 256-token context)
    or Llama-2-7B (bf16), weights from ``seed`` on ``device``."""
    import torch
    from ..inference.v2 import (InferenceEngineV2, KVCacheConfig,
                                RaggedInferenceEngineConfig,
                                RaggedInferenceModel, StateManagerConfig)
    from ..models.llama import llama_config
    from ..models.transformer import init_params
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("fleet_replica: --device cuda but no CUDA device "
                           "is visible (pass --device cpu to serve on the "
                           "CPU)")
    if model == "debug":
        # fp32: random-init bf16 argmax ties make greedy decode depend on
        # the step's shapes
        cfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    else:
        cfg = llama_config(model)
    params = init_params(cfg, seed=seed, device=device)
    kv = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                       head_dim=cfg.dims_per_head, page_size=page_size,
                       num_pages=num_pages, dtype=cfg.dtype)
    econf = RaggedInferenceEngineConfig(state_manager=StateManagerConfig(
        max_tracked_sequences=max_seqs, max_ragged_sequence_count=max_seqs,
        max_ragged_batch_size=token_budget))
    return InferenceEngineV2(
        RaggedInferenceModel(cfg, params, kv_config=kv, device=device),
        econf)


def kernel_launches() -> dict:
    """Launches this process counted (replays of captured graphs
    included): ``{kernel source: {entry point: launches}}`` for every
    kernel library the process loaded."""
    from ..ops import kernel_loader
    return {k.source.name: dict(k.launches_by_fn)
            for k in list(kernel_loader._KERNELS)}


def serve_round(engine, workload, rnd: int, step_sleep_s: float,
                step_ms: List[Tuple[float, bool]]) -> Tuple[int, float]:
    """One round: every request submitted at once to a new scheduler and
    stepped to completion.  Appends (host ms, decode-only step) per step
    to ``step_ms``; returns (tokens delivered, wall clock of the first
    token)."""
    from ..inference.v2 import FastGenScheduler
    from ..inference.v2.engine import lattice_kind_of
    model = engine.model
    sched = FastGenScheduler(engine)
    for i, (prompt, params) in enumerate(workload):
        sched.submit(rnd * len(workload) + i, prompt, params)
    tokens, first = 0, 0.0

    def on_token(uid, tok):
        nonlocal tokens, first
        tokens += 1
        if not first:
            first = time.time()

    while sched.has_work:
        before = dict(model.dispatch_counts)
        t = time.perf_counter()
        sched.step(on_token=on_token)
        ms = (time.perf_counter() - t) * 1e3
        keys = [k for k, n in model.dispatch_counts.items()
                if n != before.get(k, 0)]
        step_ms.append((ms, bool(keys) and all(
            lattice_kind_of(k) in ("decode", "chain") for k in keys)))
        if step_sleep_s:
            time.sleep(step_sleep_s)
    return tokens, first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="r0")
    ap.add_argument("--port", type=int, default=0,
                    help="metrics port (0 = ephemeral, the default)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--model", default="debug", choices=["debug", "7b"],
                    help="debug: the debug Llama in fp32; 7b: Llama-2-7B "
                    "at full width and depth in bf16")
    ap.add_argument("--trace", default="",
                    help="replay a captured workload trace (not ported)")
    ap.add_argument("--trace-limit", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4,
                    help="concurrent requests per round")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=17)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of one prefix the first half of the "
                    "requests share (0 = every prompt --prompt-len random "
                    "tokens)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--token-budget", type=int, default=256,
                    help="the engine's max_ragged_batch_size")
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights' seed (and the workload's, unless "
                    "--workload-seed is given)")
    ap.add_argument("--workload-seed", type=int, default=None,
                    help="the synthetic workload's seed")
    ap.add_argument("--step-sleep-s", type=float, default=0.0,
                    help="pace the step loop (steady token rate for "
                    "burn-rate windows)")
    ap.add_argument("--ts-interval-s", type=float, default=0.1,
                    help="time-series sampler cadence")
    ap.add_argument("--linger-s", type=float, default=30.0,
                    help="keep serving /snapshot after the workload")
    args = ap.parse_args(argv)
    if args.trace:
        raise NotImplementedError(
            "fleet_replica --trace replays a captured workload trace "
            "through tools/replay_trace.py, which is not ported yet "
            "(ROADMAP Queue 1 item 12c)")

    from .. import telemetry
    from ..runtime.fault_injection import InjectedPreemptionFault

    telemetry.enable()
    telemetry.get_timeseries().configure(interval_s=args.ts_interval_s,
                                         retention_s=300.0)
    engine = build_engine(args.model, args.device, args.seed,
                          args.page_size, args.num_pages,
                          max_seqs=args.requests,
                          token_budget=args.token_budget)
    workload = synthetic_workload(
        engine.model.cfg.vocab_size, args.requests, args.prompt_len,
        args.shared_prefix,
        args.seed if args.workload_seed is None else args.workload_seed,
        args.max_new)
    srv = telemetry.start_http_server(args.port)
    port = srv.server_address[1]
    ready = time.time()
    print(f"FLEET_REPLICA ready label={args.label} port={port} "
          f"pid={os.getpid()}", flush=True)

    step_ms: List[Tuple[float, bool]] = []
    first_token = 0.0
    warm_tokens, warm_s = 0, 0.0
    try:
        for rnd in range(args.rounds):
            t = time.perf_counter()
            tokens, first = serve_round(engine, workload, rnd,
                                        args.step_sleep_s, step_ms)
            if rnd == 0:
                first_token = first
                step_ms[:] = []     # the first round captures the graphs
            else:
                warm_tokens += tokens
                warm_s += time.perf_counter() - t
            print(f"FLEET_REPLICA round={rnd} done", flush=True)
    except InjectedPreemptionFault:
        # die like a preempted machine: at once, endpoint and all
        # (os._exit skips atexit; the federation must see it vanish)
        print("FLEET_REPLICA preempted", flush=True)
        sys.stdout.flush()
        os._exit(EXIT_PREEMPTED)
    decode = [ms for ms, is_decode in step_ms if is_decode]
    stats = dict(label=args.label, model=args.model, device=args.device,
                 ready_unix=ready, first_token_unix=first_token,
                 decode_ms_median=(statistics.median(decode)
                                   if decode else None),
                 decode_steps=len(decode),
                 tok_s=warm_tokens / warm_s if warm_s else None,
                 path_captures=engine.model.path_captures,
                 launches=kernel_launches())
    print(f"FLEET_REPLICA stats {json.dumps(stats)}", flush=True)
    print(f"FLEET_REPLICA digests "
          f"{json.dumps(engine.export_digests(HINT_TOP_K))}", flush=True)
    print("FLEET_REPLICA done", flush=True)
    deadline = time.monotonic() + args.linger_s
    while time.monotonic() < deadline:
        time.sleep(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
