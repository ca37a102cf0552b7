"""Generate a sample workload trace.

Counterpart of the JAX package's ``tools/gen_sample_trace.py``: a
deterministic mixed workload (four shared system prompts of 2-4 full
pages, a bimodal suffix length, mostly greedy sampling, submissions in
waves so the arrival offsets are not all zero) served by a debug Llama
with 16-token pages and the workload trace on, written as a content-free
JSONL ledger.  Run as::

    python -m deepspeed_tpu_torch.tools.gen_sample_trace --out trace.jsonl \
        [--requests 200] [--device cuda|cpu]

``--out`` has no default, so the in-repo fixture
``tools/traces/sample_200.jsonl`` is never overwritten by accident.
"""

from __future__ import annotations

import argparse
import os
import sys

N_REQUESTS = 200
PAGE = 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="the ledger to write")
    ap.add_argument("--requests", type=int, default=N_REQUESTS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine serves (fp32 on either)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from .. import telemetry
    from ..inference.v2 import (FastGenScheduler, InferenceEngineV2,
                                KVCacheConfig, RaggedInferenceEngineConfig,
                                RaggedInferenceModel, SamplingParams,
                                StateManagerConfig)
    from ..models.llama import llama_config
    from ..models.transformer import init_params
    from .replay_trace import load_trace

    # fp32 on either device: the kernels are not on this path (the
    # engine pins the plain versions), and the trace records shapes only
    cfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    params = init_params(cfg, seed=0, device=args.device)
    kv_cfg = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                           head_dim=cfg.dims_per_head, page_size=PAGE,
                           num_pages=512, dtype=torch.float32)
    model = RaggedInferenceModel(
        cfg, params, kv_config=kv_cfg, device=args.device,
        implementations={"norm": "plain", "ragged_attention": "dense_gather",
                         "fresh_prefill_attention": "mha_reference"})
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        state_manager=StateManagerConfig(
            max_tracked_sequences=32, max_ragged_sequence_count=32,
            max_ragged_batch_size=256)))

    rng = np.random.default_rng(9)
    systems = [rng.integers(0, cfg.vocab_size, pages * PAGE)
               for pages in (2, 2, 3, 4)]

    def prompt(i):
        sys_p = systems[int(rng.integers(0, len(systems)))]
        # bimodal suffix: short chat turns, long few-shot tails
        sfx = int(rng.integers(3, 9) if rng.random() < 0.6
                  else rng.integers(24, 40))
        return np.concatenate(
            [sys_p, rng.integers(0, cfg.vocab_size, sfx)]).tolist()

    tmp = args.out + ".gen"
    if os.path.exists(tmp):
        os.unlink(tmp)
    wt = telemetry.get_workload_trace()
    wt.configure(tmp)
    sched = FastGenScheduler(eng)
    uid = 0
    # waves of 20 with the scheduler stepping in between, so arrival
    # offsets and queue waits are not degenerate
    while uid < args.requests or sched.has_work:
        for _ in range(20):
            if uid >= args.requests:
                break
            greedy = rng.random() < 0.8
            sp = SamplingParams(
                max_new_tokens=int(rng.integers(4, 11)),
                temperature=0.0 if greedy else 0.8,
                top_k=0 if greedy else 40)
            sched.submit(uid, prompt(uid), sp)
            uid += 1
        for _ in range(6):
            if sched.has_work:
                sched.step()
    wt.close()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    os.replace(tmp, args.out)

    trace = load_trace(args.out)
    ok = sum(1 for r in trace["requests"] if r.get("outcome") == "ok")
    print(f"gen_sample_trace: {args.out}: "
          f"{len(trace['requests'])} requests ({ok} ok), "
          f"{len(trace['key_counts'])} distinct step keys, "
          f"{len(trace['compiles'])} on-path compiles, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
