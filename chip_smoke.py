#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``deepspeed_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is ignored):

1. card and software: ``nvidia-smi`` name and power limit, torch / CUDA;
2. build: every hand-written kernel of the serving path from
   ``deepspeed_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
3. each kernel against its plain PyTorch version in bf16 at the serving
   shapes: error relative to the case's own reference scale against
   stated tolerances, kernel / plain / library-yardstick times (CUDA
   events) and the bound (the larger of bytes / 3.35 TB/s and
   operations / 989 TFLOP/s, H100 SXM data sheet);
4. FastGen serving of Llama-2-7B at full width (32 layers, random seeded
   bf16 weights, 256 KV pages of 64 tokens): 8 greedy and 2 sampled
   requests through ``FastGenScheduler``, with every kernel's launch
   count read from a run that starts at zero;
5. the same weights with the registry pinned to the plain versions:
   ten teacher-forced serving steps of 3 requests (fresh prefill,
   decode, and two mixed steps, one with a Q=1024 prefill chunk over
   history), every segment's logits and greedy picks compared;
6. a ``{"kernels": [...]}`` JSON line, the card line, and last the
   ``{"ok": true, "device": {...}}`` line.

Without a GPU, or outside the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor core
SEED = 0

# Kernel vs plain version, bf16 outputs, each case held against the
# scale of its own reference (attention outputs over N(0,1) keys at
# contexts of 10^3 are ~0.05, so an absolute limit would be as large as
# the values).  The kernels keep scores and probabilities in fp32 where
# the plain versions round them to bf16; on the CPU that difference
# measures rms 5e-3 and max 9e-3 of max|ref| at these shapes, while one
# key too many at a 2048-token context moves the rms by 2.4e-2.
#   rms_rel = rms(kernel - plain) / rms(plain)
#   max_rel = max|kernel - plain| / max|plain|
RMS_REL_TOL = 1e-2
MAX_REL_TOL = 2.5e-2
# full-width kernel vs plain path: max |logit difference| over the
# largest |logit| of the segment (32 layers of bf16 rounding differences)
LOGIT_REL_TOL = 5e-2
# greedy picks that agree between the two paths: bf16 rounding flips
# only near-tied argmaxes (a wrong kernel also fails the logit check)
GREEDY_AGREE_MIN = 0.75


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def parity(out, ref) -> dict:
    """Absolute and reference-relative errors of ``out`` against
    ``ref``."""
    out, ref = out.float(), ref.float()
    d = out - ref
    return dict(max_abs_err=float(d.abs().max()),
                max_rel_err=float(d.abs().max() / ref.abs().max()),
                rms_rel_err=float(d.pow(2).mean().sqrt()
                                  / ref.pow(2).mean().sqrt()))


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions
# ---------------------------------------------------------------------------

def check_rmsnorm(dev):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import normalization as N
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for n in (8, 1024):
        e = 4096
        x = torch.randn(n, e, generator=g, device=dev, dtype=torch.bfloat16)
        w = torch.rand(e, generator=g, device=dev) + 0.5
        err = parity(N.rmsnorm(x, w, 1e-5), N.rmsnorm_reference(x, w, 1e-5))
        wb = w.bfloat16()
        b_ms, b_by = bound(2 * n * e * 2 + e * 4, 4 * n * e)
        rows.append(dict(
            shape=f"N={n} E={e}", **err,
            ms=cuda_ms(lambda: N.rmsnorm(x, w, 1e-5), 200),
            plain_ms=cuda_ms(lambda: N.rmsnorm_reference(x, w, 1e-5), 50),
            library_ms=cuda_ms(lambda: F.rms_norm(x, (e,), wb, 1e-5), 200),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def _paged_inputs(dev, S, Q, H, K, ctx_max, g, page=64):
    import torch
    D = 128
    P = ctx_max // page
    n_pages = S * P
    kv = torch.randn(n_pages + 1, page, 2, K, D, generator=g, device=dev,
                     dtype=torch.bfloat16)
    perm = torch.randperm(n_pages, generator=g, device=dev) + 1
    table = perm.reshape(S, P).to(torch.int32).contiguous()
    start = torch.randint(128, ctx_max - Q + 1, (S,), generator=g,
                          device=dev, dtype=torch.int32)
    q = torch.randn(S, Q, H, D, generator=g, device=dev,
                    dtype=torch.bfloat16)
    return q, kv, table, start


def _sdpa_paged(q, kv, table, start, slopes, window):
    """Library yardstick: scaled_dot_product_attention over the slot's
    context gathered into dense [S, H, C, D] (gather done outside)."""
    import torch
    import torch.nn.functional as F
    S, Q, H, D = q.shape
    page, K = kv.shape[1], kv.shape[3]
    pages = kv[table.long()]
    C = pages.shape[1] * page
    k = pages[..., 0, :, :].reshape(S, C, K, D).transpose(1, 2)
    v = pages[..., 1, :, :].reshape(S, C, K, D).transpose(1, 2)
    pos = start[:, None].long() + torch.arange(Q, device=q.device)
    ctx = torch.arange(C, device=q.device)
    keep = ctx[None, None, :] <= pos[:, :, None]
    if window:
        keep &= ctx[None, None, :] > pos[:, :, None] - window
    mask = torch.where(keep, 0.0, -math.inf)[:, None].to(q.dtype)
    if slopes is not None:
        mask = mask + (slopes[None, :, None, None]
                       * ctx.float()).to(q.dtype)
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, enable_gqa=K != H)


def check_paged(dev):
    import torch
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops import paged_attention as PA
    g = torch.Generator(device=dev).manual_seed(SEED)
    # the serving run's decode steps carry 16 slots and its mixed steps
    # Q=1024-bucket prefill chunks over up to 1024 tokens of history
    cases = [("serving decode", 16, 1, 32, 32, None, False),
             ("decode", 8, 1, 32, 32, None, False),
             ("prefill chunk", 8, 64, 32, 32, None, False),
             ("serving prefill chunk", 4, 1024, 32, 32, None, False),
             ("GQA decode", 8, 1, 32, 8, None, False),
             ("window decode", 8, 1, 32, 32, 512, False),
             ("ALiBi decode", 8, 1, 32, 32, None, True)]
    rows = []
    for name, S, Q, H, K, window, alibi in cases:
        q, kv, table, start = _paged_inputs(dev, S, Q, H, K, 2048, g)
        slopes = (torch.as_tensor(alibi_slopes(H), device=dev)
                  if alibi else None)
        kw = dict(window=window, alibi_slopes=slopes)
        out = PA.paged_decode_attention(q, kv, table, start, **kw)
        ref = PA.paged_attention(q, kv, table, start, **kw)
        err = parity(out, ref)
        del out, ref
        # what this data needs: row i of a slot sees keys (pos - window,
        # pos] with pos = start + i; the slot reads the union once
        pos = start.long()[:, None] + torch.arange(Q, device=dev)
        lo = (pos - window + 1).clamp(min=0) if window else 0 * pos
        n_keys = int((pos[:, -1] + 1 - lo[:, 0]).sum())
        kv_bytes = n_keys * 2 * K * 128 * 2
        io_bytes = 2 * q.numel() * 2 + table.numel() * 4 + S * 4
        flops = 4 * 128 * H * int((pos + 1 - lo).sum())
        b_ms, b_by = bound(kv_bytes + io_bytes, flops)
        rows.append(dict(
            shape=f"{name}: S={S} Q={Q} H={H} K={K} D=128 page=64 "
                  f"ctx<=2048" + (f" window={window}" if window else ""),
            **err,
            ms=cuda_ms(lambda: PA.paged_decode_attention(
                q, kv, table, start, **kw), 20),
            plain_ms=cuda_ms(lambda: PA.paged_attention(
                q, kv, table, start, **kw), 5, warmup=1),
            library_ms=cuda_ms(_sdpa_paged(q, kv, table, start, slopes,
                                           window), 20),
            bound_ms=b_ms, bound_by=b_by))
    return rows


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as FA
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, H, S, D = 4, 32, 1024, 128
    q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    out, lse = FA.flash_fwd(q, k, v, causal=True)
    ref, ref_lse = FA.flash_reference(q, k, v, causal=True)
    err = parity(out, ref)
    lse_err = parity(lse, ref_lse)
    flops = 4 * B * H * D * S * (S + 1) // 2
    b_ms, b_by = bound(4 * B * H * S * D * 2 + B * H * S * 4, flops)
    return [dict(
        shape=f"B={B} H={H} S={S} D={D} causal", **err,
        lse_max_rel_err=lse_err["max_rel_err"],
        lse_rms_rel_err=lse_err["rms_rel_err"],
        ms=cuda_ms(lambda: FA.flash_fwd(q, k, v, causal=True), 10),
        plain_ms=cuda_ms(lambda: FA.flash_reference(q, k, v, causal=True),
                         3),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10),
        bound_ms=b_ms, bound_by=b_by)]


# ---------------------------------------------------------------------------
# phases 4 and 5: serving at Llama-2-7B width
# ---------------------------------------------------------------------------

def build_engine(cfg, params, num_pages, implementations=None):
    import torch
    from deepspeed_tpu_torch.inference.v2 import (
        InferenceEngineV2, KVCacheConfig, RaggedInferenceEngineConfig,
        RaggedInferenceModel, StateManagerConfig)
    kv_cfg = KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                           head_dim=cfg.dims_per_head, page_size=64,
                           num_pages=num_pages, dtype=torch.bfloat16)
    model = RaggedInferenceModel(cfg, params, kv_config=kv_cfg, device="cuda",
                                 implementations=implementations)
    econf = RaggedInferenceEngineConfig(state_manager=StateManagerConfig(
        max_tracked_sequences=16, max_ragged_sequence_count=16,
        max_ragged_batch_size=2048))
    return InferenceEngineV2(model, econf)


def serve(cfg, params, kernels, card):
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import (FastGenScheduler,
                                                  SamplingParams)
    engine = build_engine(cfg, params, num_pages=256)
    model = engine.model
    log("implementations:", model.implementations)
    segments = {"fresh": 0, "paged": 0}
    step_impl = model._step_impl

    def counted(*a, fresh=False, **k):
        segments["fresh" if fresh else "paged"] += 1
        return step_impl(*a, fresh=fresh, **k)

    model._step_impl = counted
    rng = np.random.default_rng(SEED)
    V = cfg.vocab_size

    # warm-up (cuBLAS handles, allocator): one short request
    warm = FastGenScheduler(engine, seed=SEED)
    warm.submit(1000, rng.integers(0, V, 64), SamplingParams(max_new_tokens=2))
    warm.run_to_completion()

    sched = FastGenScheduler(engine, seed=SEED)
    lens = rng.integers(128, 1025, 10)
    reqs = {}
    for uid, n in enumerate(lens):
        sampled = uid >= 8
        params_ = SamplingParams(max_new_tokens=64,
                                 temperature=0.8 if sampled else 0.0,
                                 top_p=0.9 if sampled else 1.0)
        reqs[uid] = (rng.integers(0, V, int(n)), params_)
    for k in kernels.values():
        k.launches = 0
    for s in segments:
        segments[s] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first_token = {}
    generated = {uid: [] for uid in reqs}
    steps = []
    t0 = time.perf_counter()
    for uid, (prompt, sp) in reqs.items():
        sched.submit(uid, prompt, sp)

    def on_token(uid, tok):
        first_token.setdefault(uid, time.perf_counter() - t0)
        generated[uid].append(tok)

    while sched.has_work:
        ts = time.perf_counter()
        seg_before = dict(segments)
        out = sched.step(on_token=on_token)
        dt = time.perf_counter() - ts
        fresh_segs = segments["fresh"] - seg_before["fresh"]
        paged_segs = segments["paged"] - seg_before["paged"]
        steps.append(dict(ms=dt * 1e3, tokens=len(out),
                          scheduled=sched.last_step_scheduled,
                          fresh=fresh_segs, paged=paged_segs))
        if sched.last_step_scheduled == 0:
            raise RuntimeError("serving stalled: nothing schedulable")
    total_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    for uid, (prompt, sp) in reqs.items():
        toks = generated[uid]
        if len(toks) != sp.max_new_tokens:
            raise RuntimeError(f"request {uid}: {len(toks)} tokens, "
                               f"expected {sp.max_new_tokens}")
        if not all(0 <= t < V for t in toks):
            raise RuntimeError(f"request {uid}: token outside the vocab")
    L = cfg.num_layers
    n_seg = segments["fresh"] + segments["paged"]
    checks = {
        "rmsnorm": launches["rmsnorm"] == (2 * L + 1) * n_seg,
        "paged_attention": launches["paged_attention"] >= L * segments["paged"]
        and launches["paged_attention"] > 0,
        "flash_fwd": launches["flash_fwd"] >= L * segments["fresh"]
        and launches["flash_fwd"] > 0,
    }

    def kind(st):
        if st["fresh"] + st["paged"] == 2:
            return "mixed"          # decode segment + prefill segment
        if st["fresh"]:
            return "fresh"          # pure fresh prefill
        return "decode" if st["scheduled"] == st["tokens"] else "prefill"

    by_kind = {}
    for st in steps:
        by_kind.setdefault(kind(st), []).append(st["ms"])
    decode_steps = [st for st in steps if kind(st) == "decode"]
    dec_tokens = sum(st["tokens"] for st in decode_steps)
    dec_s = sum(st["ms"] for st in decode_steps) / 1e3
    ttft = sorted(first_token.values())
    summary = dict(
        card=card, requests=len(reqs), prompt_lens=[int(n) for n in lens],
        new_tokens=64, steps=len(steps), total_s=total_s,
        ttft_ms_mean=1e3 * sum(ttft) / len(ttft),
        ttft_ms_max=1e3 * ttft[-1],
        decode_steps=len(decode_steps),
        decode_tok_s=dec_tokens / dec_s if dec_s else None,
        decode_step_ms_mean=(1e3 * dec_s / len(decode_steps)
                             if decode_steps else None),
        step_ms_mean=sum(st["ms"] for st in steps) / len(steps),
        step_ms_by_kind={k: dict(count=len(v), mean=sum(v) / len(v),
                                 total=sum(v))
                         for k, v in by_kind.items()},
        tokens_generated=sum(len(t) for t in generated.values()),
        max_memory_allocated_gb=peak / 1e9,
        segments=segments, launches=launches)
    log("serving:", json.dumps(summary))
    log(f"segments: {segments}, launches: {launches}, checks: {checks}")
    if not all(checks.values()):
        raise RuntimeError(f"launch counts do not match the steps taken: "
                           f"{checks}")
    return summary, launches


def plain_vs_kernel(cfg, params):
    """The serving step (``step_sample``) on the kernel path and on the
    plain path, teacher-forced with the kernel path's tokens, every
    segment's logits compared.  The schedule covers each segment kind
    the serving run takes: a fresh prefill (flash), decode (paged, Q=1),
    a mixed step whose prefill segment is fresh, and a mixed step whose
    prefill segment is a Q=1024-bucket chunk over 1024 tokens of history
    (paged)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.v2 import SamplingParams
    plain = {"norm": "plain", "ragged_attention": "dense_gather",
             "fresh_prefill_attention": "mha_reference"}
    engines = {"kernel": build_engine(cfg, params, num_pages=64),
               "plain": build_engine(cfg, params, num_pages=64,
                                     implementations=plain)}
    segments = {name: [] for name in engines}
    for name, e in engines.items():
        def capture(*a, _step=e.model._step_impl, _out=segments[name], **k):
            # a = (params, kv, token_ids, q_lens, start_pos, page_table)
            logits = _step(*a, **k)
            live = a[3] > 0
            kind = ("fresh" if k.get("fresh") else
                    "decode" if a[2].shape[1] == 1 else
                    f"chunk Q={a[2].shape[1]} history<="
                    f"{int(a[4][live].max())}")
            _out.append((kind, logits[live]))
            return logits
        e.model._step_impl = capture

    rng = np.random.default_rng(SEED + 1)
    p0, p1, p2 = (rng.integers(0, cfg.vocab_size, n) for n in (700, 300, 2000))
    last = {}
    # (uids, inputs) per step; None stands for the uid's last token
    schedule = ([([0, 1], [p0, p1])] + [([0, 1], [None, None])] * 2
                + [([0, 1, 2], [None, None, p2[:1024]]),
                   ([0, 1, 2], [None, None, p2[1024:]])]
                + [([0, 1, 2], [None] * 3)] * 5)
    gen = {name: torch.Generator(device="cuda").manual_seed(SEED)
           for name in engines}
    mixed_steps = 0
    for uids, inputs in schedule:
        feed = [np.array([last[u]], np.int32) if x is None else x
                for u, x in zip(uids, inputs)]
        mixed_steps += (any(len(f) == 1 for f in feed)
                        and any(len(f) > 1 for f in feed))
        params_ = [SamplingParams()] * len(uids)
        for name, e in engines.items():
            toks, rows = e.step_sample(uids, feed, params_, gen[name])
            if name == "kernel":
                # teacher-force both paths with the kernel path's tokens
                toks = toks.tolist()
                last = {u: toks[r] for u, r in zip(uids, rows)}

    worst, agree, total, kinds = 0.0, 0, 0, []
    for (kind, a), (kind_b, b) in zip(segments["kernel"], segments["plain"]):
        if kind != kind_b or a.shape != b.shape:
            raise RuntimeError(f"segments differ: {kind} vs {kind_b}")
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise RuntimeError(f"non-finite logits in a {kind} segment")
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        total += a.shape[0]
        kinds.append(kind)
    res = dict(steps=len(schedule), mixed_steps=mixed_steps,
               segments=kinds, max_rel_logit_err=worst, tol=LOGIT_REL_TOL,
               greedy_agreement=agree / total, greedy_rows=total,
               greedy_min=GREEDY_AGREE_MIN)
    log("kernel vs plain at full width:", json.dumps(res))
    if len(segments["kernel"]) != len(segments["plain"]):
        raise RuntimeError("the two paths ran different segment counts")
    if mixed_steps != 2 or not any(k.startswith("chunk Q=1024") for k in kinds):
        raise RuntimeError(f"the schedule missed a segment kind: {kinds}")
    if worst > LOGIT_REL_TOL:
        raise RuntimeError(f"kernel path logits differ from the plain path "
                           f"by {worst:.3e} > {LOGIT_REL_TOL}")
    if agree / total < GREEDY_AGREE_MIN:
        raise RuntimeError(f"greedy agreement {agree}/{total} below "
                           f"{GREEDY_AGREE_MIN}")
    return res


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke test "
              "runs on the GPU only", file=sys.stderr)
        return 2
    # phase 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")

    # phase 2
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops import kernel_loader
    from deepspeed_tpu_torch.ops import normalization as N
    from deepspeed_tpu_torch.ops import paged_attention as PA
    kernels = {"paged_attention": PA.KERNEL, "rmsnorm": N.KERNEL,
               "flash_fwd": FA.KERNEL}
    t = time.perf_counter()
    kernel_loader.build_all(kernels.values())
    for k in kernels.values():
        k.lib()
    log(f"build: {time.perf_counter() - t:.1f} s "
        f"({', '.join(k.library_path.name for k in kernels.values())})")

    # phase 3
    checks = {"rmsnorm": check_rmsnorm(dev), "paged_attention":
              check_paged(dev), "flash_fwd": check_flash(dev)}
    for name, rows in checks.items():
        for r in rows:
            log(f"kernel {name} [{r['shape']}]: rms_rel_err "
                f"{r['rms_rel_err']:.3e} (tol {RMS_REL_TOL}), max_rel_err "
                f"{r['max_rel_err']:.3e} (tol {MAX_REL_TOL}), max_abs_err "
                f"{r['max_abs_err']:.3e}; kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            rel = [(r[k], RMS_REL_TOL) for k in r if k.endswith("rms_rel_err")]
            rel += [(r[k], MAX_REL_TOL) for k in r if k.endswith("max_rel_err")]
            if not all(err <= tol for err, tol in rel):
                raise RuntimeError(f"{name} kernel disagrees with its plain "
                                   f"version at [{r['shape']}]: {r}")

    # phase 4
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = llama_config("7b")
    t = time.perf_counter()
    params = init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"Llama-2-7B params: {cfg.n_params() / 1e9:.2f} B, bf16 init "
        f"{time.perf_counter() - t:.1f} s")
    summary, launches = serve(cfg, params, kernels, card)

    # phase 5
    plain_vs_kernel(cfg, params)

    # phase 6
    sources = {"paged_attention": ("deepspeed_tpu_torch/csrc/paged_attention.cu",
                                   "deepspeed_tpu/ops/paged_attention.py:240"),
               "rmsnorm": ("deepspeed_tpu_torch/csrc/rmsnorm.cu",
                           "deepspeed_tpu/ops/normalization.py:20"),
               "flash_fwd": ("deepspeed_tpu_torch/csrc/flash_fwd.cu",
                             "deepspeed_tpu/ops/flash_attention.py:79")}
    line = {"kernels": []}
    for name, rows in checks.items():
        head = rows[0]       # the decode / serving-step shape
        line["kernels"].append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            max_rel_err=max(r["max_rel_err"] for r in rows),
            rms_rel_err=max(r["rms_rel_err"] for r in rows),
            max_rel_tol=MAX_REL_TOL, rms_rel_tol=RMS_REL_TOL,
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], shape=head["shape"]))
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
