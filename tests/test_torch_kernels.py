"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card, in bf16.

These tests need an NVIDIA GPU (and ``nvcc`` to build the kernels at
first use) and skip without one; they import neither JAX nor
``deepspeed_tpu``, so a GPU machine without JAX runs them:
``python -m pytest tests/test_torch_kernels.py -m cuda``.  Tolerances,
relative to each case's reference (``assert_parity``): rms 1e-2, max
2.5e-2.  The outputs are bf16, and the kernels accumulate in fp32 where
the plain path rounds scores and probabilities to bf16.  The AdamW,
Lion and LAMB kernels are fp32 throughout and are held to 1e-6 of each
buffer's largest value as well (an ulp or two from fused multiply-adds;
Lion's signs must agree on every element, LAMB's norms within 1e-5 and
its stepped p within 1e-5).  The blockwise quantisation kernels and the
channelwise dequantise kernel are held to bit-equality with their plain
versions.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import fp_quantizer as tfq
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
from deepspeed_tpu_torch.ops import normalization as tnorm
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops import quantization as tq


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged_setup(S=3, Q=4, K=2, G=2, D=128, page=8, pages=32,
                 hist=(5, 0, 11), seed=0):
    """Numpy inputs: a cache with each slot's history written, the new
    q/k/v, page table, start_pos, q_lens."""
    rng = np.random.default_rng(seed)
    H = K * G
    kv = np.zeros((pages + 1, page, 2, K, D), np.float32)
    table = np.zeros((S, 8), np.int32)
    start = np.zeros(S, np.int32)
    q_lens = np.full(S, Q, np.int32)
    next_page = 1
    for s in range(S):
        h = hist[s]
        n_pages = -(-(h + Q) // page)
        pgs = np.arange(next_page, next_page + n_pages, dtype=np.int32)
        next_page += n_pages
        table[s, :n_pages] = pgs
        start[s] = h
        for t in range(h):
            kv[pgs[t // page], t % page] = rng.standard_normal((2, K, D))
    q = rng.standard_normal((S, Q, H, D)).astype(np.float32)
    k_new = rng.standard_normal((S, Q, K, D)).astype(np.float32)
    v_new = rng.standard_normal((S, Q, K, D)).astype(np.float32)
    return q, k_new, v_new, kv, table, start, q_lens


PAGED_CASES = {
    "q1": dict(Q=1),
    "q4": dict(Q=4),
    "q1_gqa4": dict(S=4, Q=1, G=4, hist=(0, 7, 16, 40)),
    "q8_gqa4": dict(S=2, Q=8, G=4, hist=(7, 16)),
    "q4_gqa1_ragged": dict(Q=4, G=1, hist=(13, 2, 30)),
}


# ---------------------------------------------------------------------------
# hand-written kernels vs their plain versions (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


RMS_REL_TOL = 1e-2
MAX_REL_TOL = 2.5e-2


def parity_errors(out, ref):
    """(rms(out - ref) / rms(ref), max|out - ref| / max|ref|)."""
    out, ref = out.float(), ref.float()
    d = out - ref
    return (float(d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()),
            float(d.abs().max() / ref.abs().max()))


def assert_parity(out, ref):
    """Kernel output against its plain version, relative to the scale of
    the reference.  Attention outputs over N(0,1) keys shrink as the
    context grows, so an absolute limit would not scale with them."""
    rms_rel, max_rel = parity_errors(out, ref)
    assert rms_rel <= RMS_REL_TOL and max_rel <= MAX_REL_TOL, \
        (rms_rel, max_rel)


def _tile_numerics(q, k_ctx, v_ctx, start, window=None, slopes=None,
                   v_scale=None):
    """What the tensor-core tile of the attention kernels computes, in
    plain PyTorch: fp32 scores of q and K, unnormalised p = exp(s - max)
    rounded to bf16 (times ``v_scale`` of each key first: the int8 fold)
    against V, fp32 sums, divided by the fp32 sum of the unrounded p and
    rounded to bf16.  k_ctx / v_ctx [S, C, K, D] fp32; v_scale [S, C, K]."""
    S, Q, H, D = q.shape
    K, C = k_ctx.shape[2], k_ctx.shape[1]
    qg = q.float().reshape(S, Q, K, H // K, D)
    scores = torch.einsum("sqkgd,sckd->skgqc", qg, k_ctx.float()) / np.sqrt(D)
    ctx = torch.arange(C)
    if slopes is not None:
        sl = torch.as_tensor(slopes, dtype=torch.float32).reshape(K, H // K)
        scores = scores + sl[None, :, :, None, None] * ctx.float()
    pos = tpa.token_positions(start, Q)
    mask = ctx[None, None, :] <= pos[:, :, None]
    if window is not None:
        mask &= ctx[None, None, :] > pos[:, :, None] - window
    scores = torch.where(mask[:, None, None], scores, tpa.MASK_VALUE)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    pv = p if v_scale is None else p * v_scale.permute(0, 2, 1)[:, :, None,
                                                                 None, :]
    out = torch.einsum("skgqc,sckd->sqkgd", pv.bfloat16().float(),
                       v_ctx.float()) / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(S, Q, H, D).bfloat16()


def _decode_case(gen, S=4, H=8, D=128, page=64, ctx=2048):
    """A decode batch over N(0,1) pages at contexts of 1024..2048."""
    n_pages = S * ctx // page
    kv = torch.randn(n_pages + 1, page, 2, H, D, generator=gen)
    table = (torch.randperm(n_pages, generator=gen) + 1).reshape(
        S, ctx // page).int()
    start = torch.randint(1024, ctx - 1, (S,), generator=gen).int()
    q = torch.randn(S, 1, H, D, generator=gen)
    return q, kv, table, start


@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_parity_limits_pass_rounding_and_fail_an_extra_key(variant):
    """The kernels differ from the plain versions by rounding only: both
    round P to bf16 before P . V, the kernels unnormalised (dividing by
    the fp32 sum at the end), the plain versions after the softmax.  The
    tile's arithmetic in plain PyTorch stands in for a kernel here, at
    the decode shape with contexts up to 2048: it passes
    ``assert_parity``, while the same arithmetic shifted one position (one
    key past the causal limit, or the window one key late) fails the rms
    limit."""
    g = torch.Generator().manual_seed(0)
    q, kv, table, start = _decode_case(g)
    kw = {"window": 512} if variant == "window" else {}
    slopes = alibi_slopes(q.shape[2]) if variant == "alibi" else None
    kvb = kv.bfloat16()
    ref = tpa.paged_attention(q.bfloat16(), kvb, table, start,
                              alibi_slopes=slopes, **kw)
    k_ctx, v_ctx = tpa.paged_context(kvb, table)
    tile = _tile_numerics(q.bfloat16(), k_ctx, v_ctx, start, slopes=slopes,
                          **kw)
    assert_parity(tile, ref)
    shifted = _tile_numerics(q.bfloat16(), k_ctx, v_ctx, start + 1,
                             slopes=slopes, **kw)
    assert parity_errors(shifted, ref)[0] > RMS_REL_TOL


def _bwd_tile_numerics(q, k, v, out, lse, do, window=None, extra_key=False,
                       with_delta=True, bf16_p_ds=True):
    """What the flash backward kernels compute, in plain PyTorch: 64-key
    and 64-row blocks over the kernels' block bounds, transposed products
    in dK/dV (S^T = K Q^T, dP^T = V dO^T), p = exp2(s scale log2e -
    lse log2e) masked to 0 outside the causal band, P and dS rounded to
    bf16 before their products (dS from the bf16 P), fp32 block sums, the
    GQA sum over the group inside the key block, bf16 outputs.  Faults:
    ``extra_key`` lets each query see one key past the causal limit,
    ``with_delta=False`` leaves delta out of dS, ``bf16_p_ds=False`` keeps
    P and dS in fp32 (the fp32-FMA kernels' numerics).  q, do [B, H, S,
    D] and k, v [B, K, S, D] bf16; out, lse from the forward."""
    B, H, S, D = q.shape
    K, G, n = k.shape[1], H // k.shape[1], -(-S // 64)
    scale, log2e = 1.0 / np.sqrt(D), 1.4426950408889634
    rnd = (lambda x: x.bfloat16().float()) if bf16_p_ds else (lambda x: x)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    lse2 = lse * log2e
    delta = tfa.bwd_delta(do, out)
    if not with_delta:
        delta = torch.zeros_like(delta)
    pos = torch.arange(S)

    def blk(i):
        return slice(64 * i, min(S, 64 * i + 64))

    def keep(qs, ks):                   # [queries, keys]
        qp, kp = pos[qs, None], pos[None, ks]
        ok = qp >= kp - (1 if extra_key else 0)
        return ok & ((qp - kp) < window) if window else ok

    dk = torch.zeros(B, K, S, D)
    dv = torch.zeros(B, K, S, D)
    for kb in range(n):
        ks = blk(kb)
        q_hi = n if not window else min(n, (64 * kb + 63 + window - 1) // 64
                                        + 1)
        for g in range(G):
            hs = slice(g, H, G)         # head g of each kv head's group
            for qb in range(kb, q_hi):
                qs = blk(qb)
                s_t = torch.einsum("bkcd,bkrd->bkcr", kf[:, :, ks],
                                   qf[:, hs, qs])
                p_t = torch.exp2(s_t * scale * log2e
                                 - lse2[:, hs, None, qs])
                p_t = rnd(torch.where(keep(qs, ks).T, p_t, 0.0))
                dv[:, :, ks] += torch.einsum("bkcr,bkrd->bkcd", p_t,
                                             dof[:, hs, qs])
                dp_t = torch.einsum("bkcd,bkrd->bkcr", vf[:, :, ks],
                                    dof[:, hs, qs])
                ds_t = rnd(p_t * (dp_t - delta[:, hs, None, qs]) * scale)
                dk[:, :, ks] += torch.einsum("bkcr,bkrd->bkcd", ds_t,
                                             qf[:, hs, qs])
    dq = torch.zeros(B, H, S, D)
    kr, vr = (torch.repeat_interleave(x, G, dim=1) for x in (kf, vf))
    for qb in range(n):
        qs = blk(qb)
        lo = 0 if not window else max(0, (64 * qb - window + 1) // 64)
        for kb in range(lo, qb + 1):
            ks = blk(kb)
            s_ = torch.einsum("bhrd,bhcd->bhrc", qf[:, :, qs], kr[:, :, ks])
            p = torch.exp2(s_ * scale * log2e - lse2[:, :, qs, None])
            p = rnd(torch.where(keep(qs, ks), p, 0.0))
            dp = torch.einsum("bhrd,bhcd->bhrc", dof[:, :, qs], vr[:, :, ks])
            ds = rnd(p * (dp - delta[:, :, qs, None]) * scale)
            dq[:, :, qs] += torch.einsum("bhrc,bhcd->bhrd", ds, kr[:, :, ks])
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


# (K, window) at B = 1, H = 4, S = 300, D = 128
BWD_STAND_IN_CASES = {"gqa2": (2, None), "window100_k4": (4, 100)}


def _bwd_case(case):
    kh, window = BWD_STAND_IN_CASES[case]
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((1, 4, 300, 128)))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, kh, 300, 128)))
            .bfloat16() for _ in range(2))
    out, lse = tfa.flash_reference(q, k, v, causal=True, window=window)
    ref = tfa.flash_bwd_reference(q, k, v, out, lse, do, True, None, window)
    return (q, k, v, out, lse, do), window, ref


def _bwd_errors(got, ref):
    """The worst (rms, max) of dq, dk, dv relative to the reference."""
    errs = [parity_errors(a, b) for a, b in zip(got, ref)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


@pytest.mark.parametrize("case", sorted(BWD_STAND_IN_CASES))
def test_bwd_tile_numerics_pass_the_limits(case):
    """The backward kernels' arithmetic differs from the plain backward
    by rounding only (exp2 against exp, block sums, dS from the bf16 P):
    it passes ``assert_parity`` for dq, dk and dv."""
    args, window, ref = _bwd_case(case)
    got = _bwd_tile_numerics(*args, window=window)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.bfloat16
        assert_parity(a, b)


@pytest.mark.parametrize("fault", ["extra_key", "no_delta"])
@pytest.mark.parametrize("case", sorted(BWD_STAND_IN_CASES))
def test_bwd_limits_fail_real_faults(case, fault):
    """The same arithmetic with each query seeing one key past the causal
    limit, or with delta left out of dS, fails the rms limit."""
    args, window, ref = _bwd_case(case)
    kw = {"extra_key": True} if fault == "extra_key" else {
        "with_delta": False}
    rms, _ = _bwd_errors(_bwd_tile_numerics(*args, window=window, **kw), ref)
    assert rms > RMS_REL_TOL, rms


@pytest.mark.parametrize("case", sorted(BWD_STAND_IN_CASES))
def test_bwd_limits_pass_fp32_p_and_ds_too(case):
    """P and dS kept in fp32 (the fp32-FMA kernels' numerics, where the
    TPU kernel and the plain backward round them to bf16) also pass: the
    limits hold rounding, and cannot tell where bf16 rounding happens;
    the wrong-mask and missing-delta faults above are what they catch."""
    args, window, ref = _bwd_case(case)
    rms, mx = _bwd_errors(
        _bwd_tile_numerics(*args, window=window, bf16_p_ds=False), ref)
    assert rms <= RMS_REL_TOL and mx <= MAX_REL_TOL, (rms, mx)


@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_int8_fold_limits_pass_rounding_and_fail_scales_one_key_off(variant):
    """The tile over int8 pages: K = bf16(code * k_scale), V's codes as
    the bf16 operand and bf16(p * v_scale) as P.  That arithmetic passes
    ``assert_parity`` against the plain version over ``KVPages``, while
    V's scales read one key off fail the rms limit."""
    g = torch.Generator().manual_seed(1)
    q, kv, table, start = _decode_case(g)
    pages = tpa.KVPages(*tpa.quantize_kv_blocks(kv))
    kw = {"window": 512} if variant == "window" else {}
    slopes = alibi_slopes(q.shape[2]) if variant == "alibi" else None
    qb = q.bfloat16()
    ref = tpa.paged_attention(qb, pages, table, start, alibi_slopes=slopes,
                              **kw)
    codes, scales = pages.payload[table.long()], pages.scale[table.long()]
    S, P, page = codes.shape[:3]
    k_ctx = (codes[..., 0, :, :].float() * scales[..., 0, :, None]
             ).bfloat16().reshape(S, P * page, *codes.shape[4:])
    v_codes = codes[..., 1, :, :].float().reshape(S, P * page,
                                                  *codes.shape[4:])
    v_scale = scales[..., 1, :].reshape(S, P * page, -1)
    fold = _tile_numerics(qb, k_ctx, v_codes, start, slopes=slopes,
                          v_scale=v_scale, **kw)
    assert_parity(fold, ref)
    off = _tile_numerics(qb, k_ctx, v_codes, start, slopes=slopes,
                         v_scale=torch.roll(v_scale, 1, dims=1), **kw)
    assert parity_errors(off, ref)[0] > RMS_REL_TOL


def _split_combine(q, kv, table, start, n_split, window=None,
                   skip_invisible=True):
    """The decode path's arithmetic in plain PyTorch: each split of the
    page table's columns gives fp32 partials (m, l, acc) over its keys
    (bf16 P against V), the combine weighs them by e^(m_i - M).  A split
    with no visible page writes (-inf, 0, 0) when ``skip_invisible``
    (the kernel's page range), or attends to masked keys only otherwise.
    Returns the output and the number of splits whose every key was
    masked or skipped for some row."""
    S, Q, H, D = q.shape
    page, K = kv.shape[1], kv.shape[3]
    G, P = H // K, table.shape[1]
    per = -(-P // n_split)
    k_ctx, v_ctx = tpa.paged_context(kv, table)
    qg = q.float().reshape(S, Q, K, G, D)
    pos = tpa.token_positions(start, Q)
    parts, dead = [], 0
    for i in range(n_split):
        c0, c1 = i * per * page, min(P, (i + 1) * per) * page
        ctx = torch.arange(c0, max(c0, c1))
        s = torch.einsum("sqkgd,sckd->skgqc", qg,
                         k_ctx[:, c0:c1].float()) / np.sqrt(D)
        mask = ctx[None, None, :] <= pos[:, :, None]
        if window is not None:
            mask &= ctx[None, None, :] > pos[:, :, None] - window
        visible = mask.any(-1)[:, None, None, :]            # [S,1,1,Q]
        s = torch.where(mask[:, None, None], s, tpa.MASK_VALUE)
        if c1 > c0:
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            l = p.sum(-1)
            acc = torch.einsum("skgqc,sckd->skgqd", p.bfloat16().float(),
                               v_ctx[:, c0:c1].float())
        else:
            m = torch.full((S, K, G, Q), -np.inf)
            l, acc = torch.zeros_like(m), torch.zeros(S, K, G, Q, D)
        if skip_invisible:
            m = torch.where(visible, m, -np.inf)
            l = torch.where(visible, l, 0.0)
            acc = torch.where(visible[..., None], acc, 0.0)
        dead += int((~visible).any())
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m, l, acc in parts:
        w = torch.where(m == -np.inf, 0.0, torch.exp(m - M))
        num = num + w[..., None] * acc
        den = den + w * l
    out = (num / den.clamp(min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(S, Q, H, D).bfloat16(), dead


@pytest.mark.parametrize("skip_invisible", [True, False])
@pytest.mark.parametrize("window", [None, 200])
def test_split_combine_matches_the_plain_attention(window, skip_invisible):
    """Split-KV partials and their combine, at the split count the
    wrapper picks for one slot at context 2048 (16 splits of 2 pages),
    hold against the plain version; under the window most splits see no
    key, and they contribute 0, never NaN."""
    g = torch.Generator().manual_seed(2)
    q, kv, table, _ = _decode_case(g, S=1)
    start = torch.tensor([2047], dtype=torch.int32)
    n_split = tpa.decode_splits(1, kv.shape[3], table.shape[1], sms=132)
    assert n_split == 16
    kvb = kv.bfloat16()
    out, dead = _split_combine(q.bfloat16(), kvb, table, start, n_split,
                               window, skip_invisible)
    ref = tpa.paged_attention(q.bfloat16(), kvb, table, start, window=window)
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)
    assert dead == (0 if window is None else 14)


def test_one_split_is_the_plain_attention():
    """Twenty slots of 32 kv heads fill the card at one split, where the
    kernel writes acc / l itself and no combine runs: one split of the
    whole table holds against the plain version."""
    assert tpa.decode_splits(20, 32, 16, sms=132) == 1
    g = torch.Generator().manual_seed(3)
    q, kv, table, start = _decode_case(g, S=2)
    kvb = kv.bfloat16()
    out, dead = _split_combine(q.bfloat16(), kvb, table, start, 1)
    assert dead == 0
    assert_parity(out, tpa.paged_attention(q.bfloat16(), kvb, table, start))


def test_decode_splits_cover_the_card_and_keep_two_pages():
    """Llama-2-7B decode (16 slots x 32 kv heads) takes 2 splits; one
    slot takes as many as two pages each allow; a tiny table one."""
    assert tpa.decode_splits(16, 32, 32, 132) == 2
    assert tpa.decode_splits(1, 32, 32, 132) == 16
    assert tpa.decode_splits(1, 8, 2, 132) == 1
    assert tpa.decode_splits(64, 32, 64, 132) == 1


# the row counts the serving step gives the norm kernels (1-16 decoding,
# 1024-4096 prefilling) at three widths
# E=2560 (Phi-2), 3072 (Phi-3-mini) and 4544 (Falcon-7B, no multiple of
# 128) are the widths the published families serve at
NORM_GRID = [(n, e) for n in (1, 8, 16, 1024, 4096)
             for e in (2560, 3072, 4096, 4544, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", NORM_GRID)
def test_rmsnorm_kernel_matches_plain(cuda_device, n, e):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(n, e, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    w = torch.rand(e, generator=g, device=cuda_device) + 0.5
    before = tnorm.KERNEL.launches_by_fn["rmsnorm_bf16"]
    out = tnorm.rmsnorm(x, w, 1e-5)
    assert tnorm.KERNEL.launches_by_fn["rmsnorm_bf16"] == before + 1
    ref = tnorm.rmsnorm_reference(x, w, 1e-5)
    assert_parity(out, ref)
    assert torch.equal(tnorm.rmsnorm(x, w, 1e-5), out)   # bit-equal repeat


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 200])
def test_flash_kernel_matches_plain(cuda_device, window):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 8, 300, 128, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    ref, ref_lse = tfa.flash_reference(q, k, v, causal=True, window=window)
    assert_parity(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-3)


# (B, S, H, K, window, [B, S, H, D] views): under one tile, uneven S, GQA,
# a window, and transposed views of [B, S, H, D] activations
FLASH_TILE_CASES = {"s17": (2, 17, 4, 4, None, False),
                    "s1000": (1, 1000, 4, 4, None, False),
                    "gqa4": (2, 300, 8, 2, None, False),
                    "window200": (1, 1000, 4, 4, 200, False),
                    "bshd_views": (2, 300, 8, 8, None, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_TILE_CASES))
def test_flash_tile_edges_match_plain(cuda_device, case):
    b, s, h, kh, window, views = FLASH_TILE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    if views:
        q, k, v = (torch.randn(b, s, n, 128, generator=g, device=cuda_device,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for n in (h, kh, kh))
    else:
        q, k, v = (torch.randn(b, n, s, 128, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for n in (h, kh, kh))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    ref, ref_lse = tfa.flash_reference(q, k, v, causal=True, window=window)
    assert_parity(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-3)


# (S, Q, H, K, context, window, ALiBi) at page 64: one slot at a full 2048
# context (the most splits), a window that leaves most splits no key,
# folded rows 8 and 16 (either side of the decode / tile switch), a
# Q=1024 chunk, GQA at Q=16, ALiBi on both paths
PAGED_TILE_CASES = {
    "single_slot_2048": (1, 1, 8, 8, 2048, None, False),
    "window_masks_splits": (1, 1, 8, 8, 2048, 200, False),
    "rows8": (2, 2, 8, 2, 1024, None, False),
    "rows16": (2, 4, 8, 2, 1024, None, False),
    "chunk_q1024": (1, 1024, 8, 8, 2048, None, False),
    "gqa_q16": (2, 16, 32, 8, 1024, None, False),
    "alibi_decode": (4, 1, 8, 8, 1024, None, True),
    "alibi_chunk": (2, 64, 8, 8, 1024, None, True),
    # 20 slots x 32 kv heads fill the card at one split: no combine
    "one_split": (20, 1, 32, 32, 1024, None, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(PAGED_TILE_CASES))
def test_paged_kernel_paths_match_plain(cuda_device, case, pages):
    S, Q, H, K, ctx, window, alibi = PAGED_TILE_CASES[case]
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(4)
    n_pages = S * ctx // 64
    kv = torch.randn(n_pages + 1, 64, 2, K, 128, generator=g, device=dev,
                     dtype=torch.bfloat16)
    table = (torch.randperm(n_pages, generator=g, device=dev) + 1).reshape(
        S, ctx // 64).int()
    start = torch.full((S,), ctx - Q, dtype=torch.int32, device=dev)
    start[1:] = torch.randint(0, ctx - Q + 1, (S - 1,), generator=g,
                              device=dev, dtype=torch.int32)
    if pages == "int8":
        kv = tpa.KVPages(*tpa.quantize_kv_blocks(kv))
    q = torch.randn(S, Q, H, 128, generator=g, device=dev,
                    dtype=torch.bfloat16)
    kw = dict(window=window,
              alibi_slopes=alibi_slopes(H) if alibi else None)
    before = dict(tpa.KERNEL.launches_by_fn)
    out = tpa.paged_decode_attention(q, kv, table, start, **kw)
    combines = tpa.KERNEL.launches_by_fn["paged_attention_combine"] - \
        before["paged_attention_combine"]
    splits = tpa.decode_splits(S, K, ctx // 64,
                               torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
    assert combines == (Q * H // K < tpa.DECODE_ROWS and splits > 1)
    if case == "one_split":
        assert splits == 1
    ref = tpa.paged_attention(q, kv, table, start, **kw)
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_paged_kernel_matches_plain(cuda_device, case, variant):
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(
        **PAGED_CASES[case])
    dev = cuda_device
    tkv = tpa.write_kv(_t(kv).to(dev, torch.bfloat16),
                       _t(k_new).to(dev, torch.bfloat16),
                       _t(v_new).to(dev, torch.bfloat16), _t(table).to(dev),
                       _t(start).to(dev), _t(q_lens).to(dev))
    kw = {"window": 6} if variant == "window" else {}
    if variant == "alibi":
        kw["alibi_slopes"] = alibi_slopes(q.shape[2])
    qd = _t(q).to(dev, torch.bfloat16)
    out = tpa.paged_decode_attention(qd, tkv, _t(table).to(dev),
                                     _t(start).to(dev), **kw)
    ref = tpa.paged_attention(qd, tkv, _t(table).to(dev), _t(start).to(dev),
                              **kw)
    assert_parity(out, ref)


# (S, H, K, window): S not a multiple of the 64-row blocks, under one
# tile (17) and one row past a tile (65, where a wrong leading or stride
# offset of a descriptor shows), GQA (the group sum inside the dK/dV
# block, up to G = 8), a sliding window of one block and one that
# crosses blocks, and a long uneven sequence over one kv head
FLASH_BWD_CASES = {"s300": (300, 8, 8, None), "gqa4": (300, 8, 2, None),
                   "window100": (256, 4, 4, 100),
                   "s1000_mqa": (1000, 4, 1, None),
                   "s17": (17, 4, 4, None), "s65": (65, 4, 4, None),
                   "window64": (256, 4, 4, 64),
                   "gqa8": (256, 32, 4, None)}


def _bshd(dev, g, s, h):
    """[B, H, S, D] views of [B, S, H, D] activations, as the model
    passes them."""
    return torch.randn(2, s, h, 128, generator=g, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CASES))
def test_flash_bwd_kernel_matches_plain(cuda_device, case):
    s, h, kh, window = FLASH_BWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (_bshd(cuda_device, g, s, n) for n in (h, kh, kh, h))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    copies = tfa.BWD_KERNEL.copies
    got = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    ref = tfa.flash_bwd_reference(q, k, v, out, lse, do, True, None, window)
    assert tfa.BWD_KERNEL.copies == copies      # strided dO read in place
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert_parity(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gqa4", "window100"])
def test_flash_bwd_kernel_is_bit_equal_across_calls(cuda_device, case):
    """No atomics: the sums run in one fixed order, so two calls on the
    same inputs give the same bits."""
    s, h, kh, window = FLASH_BWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, do = (_bshd(cuda_device, g, s, n) for n in (h, kh, kh, h))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    first = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    second = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.cuda
def test_flash_attention_autograd_node_on_the_card(cuda_device):
    """Forward and backward kernels through autograd, against autograd
    through the plain attention; ``.sum()`` hands the backward an
    expanded (stride 0) dO, which the wrapper copies and counts."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    leaves = [_bshd(cuda_device, g, 200, n).detach().requires_grad_()
              for n in (8, 2, 2)]
    copies = tfa.BWD_KERNEL.copies
    tfa.flash_attention(*leaves).sum().backward()
    assert tfa.BWD_KERNEL.copies == copies + 1
    plain = [x.detach().clone().requires_grad_() for x in leaves]
    tfa.mha_reference(*plain).sum().backward()
    for a, b in zip(leaves, plain):
        assert_parity(a.grad, b.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(dtype=torch.float32),
                                  dict(head_dim=16)])
def test_training_forward_outside_the_flash_layout_raises(cuda_device, over):
    """On the card the training forward's default attention takes the
    flash kernels or raises; "einsum" runs the dense path."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    ids = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)
    for impl in ("auto", "einsum"):
        model = LlamaForCausalLM("tiny", num_layers=1, attention_impl=impl,
                                 **over)
        params = model.init_params(seed=0, device=cuda_device)
        if impl == "einsum":
            assert torch.isfinite(model.loss(params, {"input_ids": ids}))
        else:
            with pytest.raises(NotImplementedError, match="item 11k"):
                model.loss(params, {"input_ids": ids})


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3001, 4096 * 1104])
def test_adamw_kernel_matches_plain(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p, grad, m = (torch.randn(n, generator=g, device=cuda_device)
                  for _ in range(3))
    v = torch.rand(n, generator=g, device=cuda_device)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, step=7)
    ref = [x.clone() for x in (p, grad, m, v)]
    tfo.fused_adamw_flat(p, grad, m, v, **kw)
    tfo.adamw_reference(*ref, **kw)
    for a, b in zip((p, m, v), (ref[0], ref[2], ref[3])):
        assert_parity(a, b)
        assert parity_errors(a, b)[1] <= 1e-6


# ---------------------------------------------------------------------------
# LayerNorm, residual RMSNorm and int8 paged attention
# ---------------------------------------------------------------------------

def _large_mean_rows(n, e, gen, device="cpu"):
    """bf16 rows whose mean (1000) is far above their spread: most values
    round to 1000 and a few to 996 or 1004, so mean^2 / var is ~1e6."""
    return (1000.0 + 0.85 * torch.randn(n, e, generator=gen, device=device)
            ).bfloat16()


def _norm_vectors(e, gen, device="cpu"):
    w = torch.rand(e, generator=gen, device=device) + 0.5
    b = 0.1 * torch.randn(e, generator=gen, device=device)
    return w, b


def test_layernorm_limits_pass_rounding_and_fail_a_one_pass_variance():
    """The kernel differs from the plain version by the order of its fp32
    sums.  The same arithmetic in fp64, rounded to bf16, stands in for it
    and passes ``assert_parity`` on N(0,1) rows and on rows with mean >>
    spread; a variance taken as E[x^2] - mean^2 in fp32 fails the rms
    limit on the large-mean rows, where it cancels catastrophically."""
    g = torch.Generator().manual_seed(0)
    w, b = _norm_vectors(4096, g)
    for x in (torch.randn(16, 4096, generator=g).bfloat16(),
              _large_mean_rows(16, 4096, g)):
        ref = tnorm.layernorm_reference(x, w, b, 1e-5)
        x64 = x.double()
        xc = x64 - x64.mean(-1, keepdim=True)
        fp64 = (xc / torch.sqrt(xc.pow(2).mean(-1, keepdim=True) + 1e-5)
                * w.double() + b.double()).bfloat16()
        assert_parity(fp64, ref)
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    one_pass = ((x32 - mean) * torch.rsqrt(var.clamp(min=0) + 1e-5) * w
                + b).bfloat16()
    assert parity_errors(one_pass, ref)[0] > RMS_REL_TOL


def test_rmsnorm_res_limits_pass_rounding_and_fail_a_rounded_sum():
    """Both outputs of the fused residual form in fp64, rounded to bf16,
    pass against the plain version (the new residual bit for bit).  The
    moment must come from the unrounded fp32 sum: the plain rmsnorm of the
    bf16-rounded sum differs from the fused form in one element in four,
    by an ulp, which ``assert_parity`` passes and equality does not."""
    g = torch.Generator().manual_seed(1)
    x, r = (torch.randn(16, 4096, generator=g).bfloat16() for _ in range(2))
    w = torch.rand(4096, generator=g) + 0.5
    out, res = tnorm.rmsnorm_res_reference(x, r, w, 1e-5)
    s64 = x.double() + r.double()
    out64 = (s64 / torch.sqrt(s64.pow(2).mean(-1, keepdim=True) + 1e-5)
             * w.double()).bfloat16()
    assert torch.equal(s64.bfloat16(), res)
    assert_parity(out64, out)
    two_ops = tnorm.rmsnorm_reference(res, w, 1e-5)
    assert_parity(two_ops, out)
    assert 0.05 < float((two_ops != out).float().mean()) < 0.6


def _int8_decode_case(gen, S=4, H=8, D=128, page=64, ctx=2048):
    """A decode batch over int8 pages quantised from N(0,1) keys."""
    n_pages = S * ctx // page
    kv = tpa.KVPages(*tpa.quantize_kv_blocks(
        torch.randn(n_pages + 1, page, 2, H, D, generator=gen)))
    table = (torch.randperm(n_pages, generator=gen) + 1).reshape(
        S, ctx // page).int()
    start = torch.randint(1024, ctx - 1, (S,), generator=gen).int()
    q = torch.randn(S, 1, H, D, generator=gen)
    return q, kv, table, start


def _int8_kernel_numerics(q, kv, table, start, **kw):
    """What the decode path of ``paged_attention_int8`` computes, in plain
    PyTorch: K is float(code) * scale rounded to bf16, V stays fp32,
    scores and probabilities are fp32, the output is rounded to bf16."""
    pages = tpa.dequantize_kv_blocks(kv.payload, kv.scale)
    pages[:, :, 0] = pages[:, :, 0].bfloat16().float()
    return tpa.paged_attention(q.bfloat16().float(), pages, table, start,
                               **kw).bfloat16()


@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_int8_parity_limits_pass_rounding_and_fail_real_faults(variant):
    """The int8 decode path keeps V and the probabilities in fp32 where
    the plain version over ``KVPages`` rounds them to bf16: rounding only,
    which ``assert_parity`` passes at the decode shape.  One key past the
    causal limit, or the scales of the neighbouring kv head, fail the rms
    limit."""
    g = torch.Generator().manual_seed(0)
    q, kv, table, start = _int8_decode_case(g)
    kw = {"window": 512} if variant == "window" else {}
    if variant == "alibi":
        kw["alibi_slopes"] = alibi_slopes(q.shape[2])
    ref = tpa.paged_attention(q.bfloat16(), kv, table, start, **kw)
    assert_parity(_int8_kernel_numerics(q, kv, table, start, **kw), ref)
    shifted = _int8_kernel_numerics(q, kv, table, start + 1, **kw)
    assert parity_errors(shifted, ref)[0] > RMS_REL_TOL
    neighbour = tpa.KVPages(kv.payload, torch.roll(kv.scale, 1, dims=-1))
    wrong = _int8_kernel_numerics(q, neighbour, table, start, **kw)
    assert parity_errors(wrong, ref)[0] > RMS_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["normal", "large_mean"])
@pytest.mark.parametrize("n,e", [(1000, 4096), (5, 8192), (33, 264),
                                 *NORM_GRID])
def test_layernorm_kernel_matches_plain(cuda_device, rows, n, e):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (_large_mean_rows(n, e, g, cuda_device) if rows == "large_mean"
         else torch.randn(n, e, generator=g, device=cuda_device,
                          dtype=torch.bfloat16))
    w, b = _norm_vectors(e, g, cuda_device)
    before = tnorm.LN_KERNEL.launches
    out = tnorm.layernorm(x, w, b, 1e-5)
    assert tnorm.LN_KERNEL.launches == before + 1
    assert_parity(out, tnorm.layernorm_reference(x, w, b, 1e-5))
    assert torch.equal(tnorm.layernorm(x, w, b, 1e-5), out)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e", [(16, 4096), (1000, 4096), (5, 8192),
                                 (33, 264)])
def test_rmsnorm_res_kernel_matches_plain(cuda_device, n, e):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x, r = (torch.randn(n, e, generator=g, device=cuda_device,
                        dtype=torch.bfloat16) for _ in range(2))
    w = torch.rand(e, generator=g, device=cuda_device) + 0.5
    x0, r0 = x.clone(), r.clone()
    before = tnorm.KERNEL.launches_by_fn["rmsnorm_res_bf16"]
    out, res = tnorm.rmsnorm(x, w, 1e-5, residual=r)
    assert tnorm.KERNEL.launches_by_fn["rmsnorm_res_bf16"] == before + 1
    ref_out, ref_res = tnorm.rmsnorm_res_reference(x, r, w, 1e-5)
    assert torch.equal(res, ref_res)            # bf16(fp32 sum), exactly
    assert_parity(out, ref_out)
    # two new tensors: the inputs are untouched
    assert torch.equal(x, x0) and torch.equal(r, r0)
    assert out.data_ptr() not in (x.data_ptr(), r.data_ptr())
    assert res.data_ptr() not in (x.data_ptr(), r.data_ptr())


def _int8_pages_on(dev, kv, k_new, v_new, table, start, q_lens):
    """The case's history quantised into int8 pages on ``dev``, and the
    new tokens appended through the quantising ``write_kv``."""
    pages = tpa.KVPages(*tpa.quantize_kv_blocks(_t(kv).to(dev)))
    return tpa.write_kv(pages, _t(k_new).to(dev, torch.bfloat16),
                        _t(v_new).to(dev, torch.bfloat16), _t(table).to(dev),
                        _t(start).to(dev), _t(q_lens).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_int8_paged_kernel_matches_plain(cuda_device, case, variant):
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(
        **PAGED_CASES[case])
    dev = cuda_device
    pages = _int8_pages_on(dev, kv, k_new, v_new, table, start, q_lens)
    kw = {"window": 6} if variant == "window" else {}
    if variant == "alibi":
        kw["alibi_slopes"] = alibi_slopes(q.shape[2])
    qd = _t(q).to(dev, torch.bfloat16)
    before = dict(tpa.KERNEL.launches_by_fn)
    out = tpa.paged_decode_attention(qd, pages, _t(table).to(dev),
                                     _t(start).to(dev), **kw)
    assert tpa.KERNEL.launches_by_fn["paged_attention_int8"] == \
        before["paged_attention_int8"] + 1
    assert tpa.KERNEL.launches_by_fn["paged_attention_bf16"] == \
        before["paged_attention_bf16"]
    ref = tpa.paged_attention(qd, pages, _t(table).to(dev),
                              _t(start).to(dev), **kw)
    assert_parity(out, ref)


@pytest.mark.cuda
def test_int8_paged_kernel_unwritten_rows_give_exact_zeros(cuda_device):
    """Rows never written have codes 0 and scale 0: a context of only
    such rows attends to zeros and returns exactly 0, never NaN; garbage
    in the null page and past the causal limit is never seen."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    S, H, K, page, P = 3, 8, 2, 64, 4
    pages = tpa.KVPages(
        torch.zeros(S * P + 1, page, 2, K, 128, dtype=torch.int8, device=dev),
        torch.zeros(S * P + 1, page, 2, K, dtype=torch.float32, device=dev))
    pages.payload[0] = 127                     # the null page holds garbage
    pages.scale[0] = 1e30
    table = torch.arange(1, S * P + 1, device=dev,
                         dtype=torch.int32).reshape(S, P)
    start = torch.tensor([0, 70, 200], device=dev, dtype=torch.int32)
    q = torch.randn(S, 1, H, 128, generator=g, device=dev,
                    dtype=torch.bfloat16)
    out = tpa.paged_decode_attention(q, pages, table, start)
    assert torch.equal(out, torch.zeros_like(out))
    # garbage one row past slot 1's limit changes nothing
    pages.payload[int(table[1, 1]), 71 - page] = 127
    pages.scale[int(table[1, 1]), 71 - page] = 1e30
    out = tpa.paged_decode_attention(q, pages, table, start)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(dtype=torch.float32),
                                  dict(dtype=torch.bfloat16)])
def test_serving_model_outside_the_kernels_layout_raises(cuda_device, over):
    """On the card the serving model runs the kernels or raises at build:
    the debug GPT (head_dim 16; fp32 also misses the norm kernel) never
    drops to the plain versions unasked, and serves through them when
    they are named."""
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.models.gpt import gpt_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = gpt_config("debug", **over)
    params = init_params(cfg, 0, device=cuda_device)
    with pytest.raises(NotImplementedError, match="item 11k"):
        T.implementation_for("gpt2")(cfg, params)
    model = T.implementation_for("gpt2")(cfg, params, implementations={
        "norm": "plain", "ragged_attention": "dense_gather",
        "fresh_prefill_attention": "mha_reference"})
    logits = T.InferenceEngineV2(model).put([0], [[1, 2, 3]])
    assert logits.device.type == "cuda"
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# blockwise quantisation, Lion and LAMB
# ---------------------------------------------------------------------------

def lion_signs(p_old, p_new, lr, wd):
    """The sign u that a Lion step applied, recovered from
    p_new = p_old - lr (u + wd p_old) (chip_smoke.py's check)."""
    return torch.round((p_old - p_new) / lr - wd * p_old)


def _tie_input(device="cpu"):
    """Blocks of absmax 127 (scale 1.0 exactly) full of k + 0.5 ties."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                     device=device).repeat(192)
    x[::512] = 127.0
    return x


def test_quantize_bit_equality_fails_half_away_from_zero_rounding():
    """A kernel rounding with roundf (half away from zero) instead of
    rintf (half to even) gives other codes on ties: the bit-equality
    check sees it."""
    x = _tie_input()
    q, s, _ = tq.quantize_blockwise_reference(x)
    scaled = x.reshape(-1, 512) / s[:, None]
    away = (torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)).clamp(
        -127, 127).to(torch.int8)
    assert not torch.equal(away, q)
    assert torch.equal(torch.round(scaled).to(torch.int8), q)


def test_lion_sign_check_fails_swapped_betas():
    """The plain Lion with b1 and b2 swapped, standing in for a kernel
    that mixes them up, applies other signs wherever m and g disagree;
    the sign check sees it, while the true plain version passes it."""
    g = torch.Generator().manual_seed(0)
    p, grad, m = (torch.randn(4096, generator=g) for _ in range(3))
    kw = dict(lr=3e-4, wd=0.1)
    runs = {}
    for name, (b1, b2) in (("right", (0.9, 0.99)), ("again", (0.9, 0.99)),
                           ("swapped", (0.99, 0.9))):
        bufs = [p.clone(), grad, m.clone()]
        tfo.lion_reference(*bufs, b1=b1, b2=b2, **kw)
        runs[name] = lion_signs(p, bufs[0], **kw)
    assert set(runs["right"].unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert torch.equal(runs["right"], runs["again"])
    assert not torch.equal(runs["swapped"], runs["right"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 3001, 512 * 7, 4096 * 1104 + 5])
def test_quantize_kernels_match_plain_bit_for_bit(cuda_device, n):
    """Odd sizes (a partial tail block), a zero block and a block below
    the 1e-12 floor; codes, scales, pad and both output types."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(n, generator=g, device=cuda_device)
    if n > 1024:
        x[:512] = 0.0
        x[512:1024] *= 1e-13
    for inp in (x, _tie_input(cuda_device)):
        q, s, pad = tq.quantize_blockwise(inp)
        rq, rs, rpad = tq.quantize_blockwise_reference(inp)
        assert pad == rpad and torch.equal(q, rq) and torch.equal(s, rs)
        for dt in (torch.float32, torch.bfloat16):
            out = tq.dequantize_blockwise(q, s, pad, inp.shape, dt)
            ref = tq.dequantize_blockwise_reference(rq, rs, rpad, inp.shape,
                                                    dt)
            assert out.dtype == dt and torch.equal(out, ref)


@pytest.mark.cuda
def test_quantize_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.randn(2048, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        tq.quantize_blockwise(x.bfloat16())
    with pytest.raises(ValueError, match="aligned"):
        tq.quantize_blockwise(x[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tq.quantize_blockwise(x.view(32, 64).t())
    with pytest.raises(ValueError, match="block"):
        tq.quantize_blockwise(x, block=64)
    q, s, pad = tq.quantize_blockwise(x)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        tq.dequantize_blockwise(q, s, pad, x.shape, torch.float16)
    with pytest.raises(ValueError, match="do not hold"):
        tq.dequantize_blockwise(q, s, pad, (2049,))
    with pytest.raises(TypeError, match="int8"):
        tq.dequantize_blockwise(q.int(), s, pad, x.shape)


def _opt_buffers(dev, n, count):
    g = torch.Generator(device=dev).manual_seed(n)
    bufs = [torch.randn(n, generator=g, device=dev) for _ in range(count)]
    if count == 4:
        bufs[3] = torch.rand(n, generator=g, device=dev)   # v >= 0
    return bufs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3001, 4096 * 1104])
def test_lion_kernel_matches_plain(cuda_device, n):
    p, grad, m = _opt_buffers(cuda_device, n, 3)
    kw = dict(lr=3e-4, b1=0.9, b2=0.99, wd=0.1)
    ref = [x.clone() for x in (p, grad, m)]
    p0 = p.clone()
    tfo.fused_lion_flat(p, grad, m, **kw)
    tfo.lion_reference(*ref, **kw)
    assert torch.equal(lion_signs(p0, p, kw["lr"], kw["wd"]),
                       lion_signs(p0, ref[0], kw["lr"], kw["wd"]))
    for a, b in ((p, ref[0]), (m, ref[2])):
        assert parity_errors(a, b)[1] <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3001, 4096 * 1104])
def test_lamb_kernel_matches_plain(cuda_device, n):
    p, grad, m, v = _opt_buffers(cuda_device, n, 4)
    hp = dict(b1=0.9, b2=0.95, eps=1e-6, wd=0.1, step=7)
    rp, rg, rm, rv = (x.clone() for x in (p, grad, m, v))
    m0, v0 = m.clone(), v.clone()
    u, norms = tfo.lamb_stage1(p, grad, m, v, **hp)
    ru, rnorms = tfo.lamb_stage1_reference(rp, rg, rm, rv, **hp)
    for a, b in ((u, ru), (m, rm), (v, rv)):
        assert parity_errors(a, b)[1] <= 1e-6
    rel = (norms.sum(0) - rnorms.sum(0)).abs() / rnorms.sum(0)
    assert float(rel.max()) <= 1e-5
    # a grid fixed by the size: the partial sums repeat bit for bit
    again = tfo.lamb_stage1(p, grad, m0.clone(), v0.clone(), **hp)[1]
    assert torch.equal(again, norms) and norms.shape[1] == 2
    tfo.lamb_trust_step(p, u, norms, 1e-2)
    tfo.lamb_trust_step(rp, ru, rnorms, 1e-2)
    assert parity_errors(p, rp)[1] <= 1e-5


@pytest.mark.cuda
def test_optimizer_kernels_reject_what_they_do_not_take(cuda_device):
    p, grad, m, v = _opt_buffers(cuda_device, 4096, 4)
    with pytest.raises(TypeError, match="fp32 or bf16 g"):
        tfo.fused_lion_flat(p, grad.half(), m, 1e-4, 0.9, 0.99, 0.0)
    with pytest.raises(ValueError, match="aligned"):
        tfo.fused_lion_flat(p[1:], grad[1:], m[1:], 1e-4, 0.9, 0.99, 0.0)
    with pytest.raises(ValueError, match="aligned"):
        tfo.lamb_stage1(p, grad, m[:-4], v, 0.9, 0.999, 1e-6, 0.0, 1)
    with pytest.raises(TypeError, match="fp32 v"):
        tfo.fused_lamb_flat(p, grad, m, v.half(), 1e-2, 0.9, 0.999, 1e-6,
                            0.0, 1)
    with pytest.raises(TypeError, match="fp32 v"):
        tfo.fused_adamw_flat(p, grad, m, v.bfloat16(), 1e-2, 0.9, 0.999,
                             1e-8, 0.0, 1)
    with pytest.raises(ValueError, match="1-based"):
        tfo.fused_lamb_flat(p, grad, m, v, 1e-2, 0.9, 0.999, 1e-6, 0.0, 0)


#: every mix of p's and g's dtypes but all-fp32 (the moments are fp32)
BF16_MIXES = [(p, g) for p in (torch.float32, torch.bfloat16)
              for g in (torch.float32, torch.bfloat16)
              if torch.bfloat16 in (p, g)]


def _mixed(bufs, dtypes):
    return [b.to(d) for b, d in zip(bufs, dtypes)]


def assert_update_matches(p0, p, ref):
    """The kernel's update of p against its plain version's, from the
    same ``p0``.  An fp32 p: the two updates ``p - p0`` within 1e-5 of
    the update's scale.  A bf16 p, where an update of 1e-4 is a few
    ulps: the plain version moves most elements (so a wrong update
    shows), every element is within one bf16 ulp of the larger of |p0|
    and the plain result (a rounding the other way, also where the step
    cancels most of a weight), at most 1e-3 of them differ, and the
    updates agree at the kernel rows' rms tolerance."""
    d, rd = p.float() - p0.float(), ref.float() - p0.float()
    if p.dtype == torch.float32:
        assert parity_errors(d, rd)[1] <= 1e-5
        return
    scale = torch.maximum(p0.float().abs(), ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(scale), torch.frexp(scale).exponent - 8)
    moved = float((ref != p0).float().mean())
    assert moved >= 0.5, moved
    assert float(((p.float() - ref.float()).abs() / ulp).max()) <= 1
    assert float((p != ref).float().mean()) <= 1e-3
    assert parity_errors(d, rd)[0] <= RMS_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3001, 4096 * 1104])
@pytest.mark.parametrize("dtypes", BF16_MIXES, ids=lambda d: "-".join(
    str(t).split(".")[-1] for t in d))
def test_bf16_instances_match_plain(cuda_device, dtypes, n):
    """Each bf16 instance of AdamW, Lion and LAMB stage 1 against its
    plain version on the same inputs, p at a trained weight's scale
    (0.02): fp32 arithmetic and one rounding per output in both, so Lion
    is bit-equal, AdamW's update is held by
    :func:`assert_update_matches`, and the fp32 moments, LAMB's fp32
    update and its norms as in the fp32 tests."""
    pd, gd = dtypes
    bufs = _opt_buffers(cuda_device, n, 4)
    p, grad, m, v = _mixed([0.02 * bufs[0]] + bufs[1:],
                           (pd, gd, torch.float32, torch.float32))
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, step=7)
    p0, ref = p.clone(), [x.clone() for x in (p, grad, m, v)]
    tfo.fused_adamw_flat(p, grad, m, v, **kw)
    tfo.adamw_reference(*ref, **kw)
    assert p.dtype == pd
    assert_update_matches(p0, p, ref[0])
    for a, b in ((m, ref[2]), (v, ref[3])):
        assert parity_errors(a, b)[1] <= 1e-6
    name = tfo.entry_point("fused_adamw", p, grad)
    assert tfo.KERNEL.launches_by_fn[name] >= 1

    bufs = _opt_buffers(cuda_device, n, 3)
    p, grad, m = _mixed([0.02 * bufs[0]] + bufs[1:],
                        (pd, gd, torch.float32))
    p0, ref = p.clone(), [x.clone() for x in (p, grad, m)]
    lkw = dict(lr=1e-4, b1=0.9, b2=0.99, wd=0.1)
    tfo.fused_lion_flat(p, grad, m, **lkw)
    tfo.lion_reference(*ref, **lkw)
    assert torch.equal(p, ref[0]) and torch.equal(m, ref[2])
    assert float((ref[0] != p0).float().mean()) >= 0.5

    p, grad, m, v = _mixed(_opt_buffers(cuda_device, n, 4),
                           (pd, gd, torch.float32, torch.float32))
    ref = [x.clone() for x in (p, grad, m, v)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-6, wd=0.1, step=7)
    u, norms = tfo.lamb_stage1(p, grad, m, v, **hp)
    ru, rnorms = tfo.lamb_stage1_reference(*ref, **hp)
    assert u.dtype == torch.float32
    for a, b in ((u, ru), (m, ref[2]), (v, ref[3])):
        assert parity_errors(a, b)[1] <= 1e-6
    rel = (norms.sum(0) - rnorms.sum(0)).abs() / rnorms.sum(0)
    assert float(rel.max()) <= 1e-5


# ---------------------------------------------------------------------------
# the norm wrappers' launch path under a side stream and a CUDA graph
# capture
# ---------------------------------------------------------------------------

def _norm_operands(dev, n, e, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, e, generator=g, device=dev, dtype=torch.bfloat16)
    w, b = _norm_vectors(e, g, dev)
    r = torch.randn(n, e, generator=g, device=dev, dtype=torch.bfloat16)
    return x, w, b, r


def _norm_call(kernel, x, w, b, r, plain=False):
    """The wrapper (or its plain version) as a tuple of outputs."""
    if kernel == "rmsnorm":
        return ((tnorm.rmsnorm_reference if plain else tnorm.rmsnorm)(
            x, w, 1e-5),)
    if kernel == "rmsnorm_res":
        if plain:
            return tnorm.rmsnorm_res_reference(x, r, w, 1e-5)
        return tnorm.rmsnorm(x, w, 1e-5, residual=r)
    return ((tnorm.layernorm_reference if plain else tnorm.layernorm)(
        x, w, b, 1e-5),)


def _assert_norm_outputs(kernel, outs, refs):
    assert_parity(outs[0], refs[0])
    if kernel == "rmsnorm_res":
        assert torch.equal(outs[1], refs[1])    # bf16(fp32 sum), exactly


def _launches(kernel):
    return (tnorm.LN_KERNEL if kernel == "layernorm"
            else tnorm.KERNEL).launches


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rmsnorm", "layernorm", "rmsnorm_res"])
def test_norm_wrappers_replay_under_cuda_graph_capture(cuda_device, kernel):
    """A wrapper captured into a CUDA graph launches on the capture's
    stream (one counted launch), and a replay normalises whatever x then
    holds."""
    x, w, b, r = _norm_operands(cuda_device, 16, 4096)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up off the capture
        _norm_call(kernel, x, w, b, r)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _launches(kernel)
    with torch.cuda.graph(graph):
        outs = _norm_call(kernel, x, w, b, r)
    assert _launches(kernel) == before + 1
    new_x, _, _, new_r = _norm_operands(cuda_device, 16, 4096, seed=1)
    x.copy_(new_x)
    r.copy_(new_r)
    graph.replay()
    torch.cuda.synchronize()
    _assert_norm_outputs(kernel, outs,
                         _norm_call(kernel, new_x, w, b, new_r, True))
    assert _launches(kernel) == before + 1        # a replay is no launch


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["rmsnorm", "layernorm", "rmsnorm_res"])
def test_norm_wrappers_launch_on_the_current_side_stream(cuda_device,
                                                         kernel):
    """Under ``torch.cuda.stream(side)`` the kernel runs after the side
    stream's earlier work: x is refilled there behind ~30 ms of spinning,
    so a launch on any other stream would read the old x."""
    x, w, b, r = _norm_operands(cuda_device, 8, 4096)
    new_x = _norm_operands(cuda_device, 8, 4096, seed=1)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.copy_(new_x)
        outs = _norm_call(kernel, x, w, b, r)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _assert_norm_outputs(kernel, outs,
                         _norm_call(kernel, new_x, w, b, r, True))


# ---------------------------------------------------------------------------
# CUDA graphs: the serving kernels captured and replayed
# ---------------------------------------------------------------------------

def _paged_graph_inputs(dev, case, pages, seed):
    S, Q, H, K, ctx, _, _ = PAGED_TILE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = S * ctx // 64
    kv = torch.randn(n_pages + 1, 64, 2, K, 128, generator=g, device=dev,
                     dtype=torch.bfloat16)
    if pages == "int8":
        kv = tpa.KVPages(*tpa.quantize_kv_blocks(kv))
    table = (torch.randperm(n_pages, generator=g, device=dev) + 1).reshape(
        S, ctx // 64).int()
    start = torch.randint(0, ctx - Q + 1, (S,), generator=g, device=dev,
                          dtype=torch.int32)
    q = torch.randn(S, Q, H, 128, generator=g, device=dev,
                    dtype=torch.bfloat16)
    return q, kv, table, start


def _refill(dst, src):
    if isinstance(dst, tpa.KVPages):
        dst.payload.copy_(src.payload)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", ["rows8", "chunk_q1024"])
def test_paged_wrapper_replays_a_captured_graph_on_new_inputs(
        cuda_device, case, pages):
    """The split-KV decode (rows8: split kernel + combine, its workspace
    from the graph's pool) and the tensor-core tile (chunk_q1024),
    captured once and replayed over new q, pages, table and start: equal
    to an eager call on the new inputs, and each replay counts its
    launches."""
    from deepspeed_tpu_torch.ops.kernel_loader import CountedGraph
    static = _paged_graph_inputs(cuda_device, case, pages, seed=1)
    graph = CountedGraph()
    before = dict(tpa.KERNEL.launches_by_fn)
    out = graph.capture(tpa.paged_decode_attention, *static)
    per_call = {fn: n - before[fn]
                for fn, n in tpa.KERNEL.launches_by_fn.items()}
    assert sum(per_call.values()) in (1, 2)      # the warm-up call ran
    for seed in (2, 3):
        new = _paged_graph_inputs(cuda_device, case, pages, seed)
        for dst, src in zip(static, new):
            _refill(dst, src)
        counts = dict(tpa.KERNEL.launches_by_fn)
        graph.replay()
        assert {fn: n - counts[fn] for fn, n in
                tpa.KERNEL.launches_by_fn.items()} == per_call
        eager = tpa.paged_decode_attention(*new)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_flash_forward_replays_a_captured_graph_on_new_inputs(cuda_device):
    from deepspeed_tpu_torch.ops.kernel_loader import CountedGraph
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def qkv():
        return [torch.randn(2, 8, 300, 128, generator=g, device=cuda_device,
                            dtype=torch.bfloat16) for _ in range(3)]

    static = qkv()
    graph = CountedGraph()
    out = graph.capture(tfa.flash_attention, *static, True)
    before = tfa.KERNEL.launches
    for _ in range(2):
        new = qkv()
        for dst, src in zip(static, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tfa.flash_attention(*new, True))
    assert tfa.KERNEL.launches == before + 4    # 2 replays + 2 eager calls


@pytest.mark.cuda
def test_sampled_graph_draws_anew_each_replay_and_reseeds(cuda_device):
    """A stochastic sampling graph over a registered generator: two
    replays draw different tokens, and the generator re-seeded replays
    the same draws again."""
    from deepspeed_tpu_torch.inference.v2 import sampling
    from deepspeed_tpu_torch.ops.kernel_loader import CountedGraph
    dev = cuda_device
    logits = torch.zeros(64, 1000, device=dev)          # uniform rows
    temps = torch.ones(64, device=dev)
    top_ks = torch.zeros(64, dtype=torch.int32, device=dev)
    top_ps = torch.ones(64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    graph = CountedGraph(generator=gen)
    out = graph.capture(sampling.sample_dynamic, logits, gen, temps, top_ks,
                        top_ps)

    def two_draws():
        draws = []
        for _ in range(2):
            graph.replay()
            draws.append(out.clone())
        return draws

    gen.manual_seed(11)
    a, b = two_draws()
    assert not torch.equal(a, b)
    gen.manual_seed(11)
    a2, b2 = two_draws()
    assert torch.equal(a, a2) and torch.equal(b, b2)


def _graph_llama(dev):
    """The debug llama at head_dim 128 (2 heads of 128, one kv head),
    bf16, so the kernels take it."""
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.models.llama import llama_config
    from deepspeed_tpu_torch.models.transformer import init_params
    cfg = llama_config("debug", hidden_size=256, num_heads=2,
                       num_kv_heads=1, intermediate_size=512,
                       max_seq_len=512)
    params = init_params(cfg, 0, device=dev)

    def engine(**serving):
        kv = T.KVCacheConfig(num_layers=cfg.num_layers, kv_heads=1,
                             head_dim=128, page_size=16, num_pages=128)
        return T.InferenceEngineV2(
            T.RaggedInferenceModel(cfg, params, kv_config=kv, device=dev),
            T.RaggedInferenceEngineConfig(
                state_manager=T.StateManagerConfig(
                    max_tracked_sequences=8, max_ragged_sequence_count=8,
                    max_ragged_batch_size=128),
                serving=T.ServingOptimizationConfig(**serving)))
    return T, engine


def _serve(T, eng, prompts, n_new=12, temperature=0.0, seed=0):
    sched = T.FastGenScheduler(eng, seed=seed)
    for uid, p in enumerate(prompts):
        sched.submit(uid, p, T.SamplingParams(max_new_tokens=n_new,
                                              temperature=temperature))
    return sched.run_to_completion()


def _graph_prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 128, 40).tolist()
    return [shared + rng.integers(0, 128, 5 + i).tolist() for i in range(3)] \
        + [rng.integers(0, 128, n).tolist() for n in (70, 9)]


@pytest.mark.cuda
def test_graph_greedy_tokens_equal_eager_on_the_debug_llama(cuda_device):
    """The default serving configuration (graphs, async chain, prefix
    cache) against the same scheduler on a model whose steps run their
    bodies eagerly: the same greedy tokens; every sampling and chained
    step was a replay."""
    T, engine = _graph_llama(cuda_device)
    prompts = _graph_prompts()
    eager = engine()
    eager.model._new_step = lambda key, kv, inputs=None: None
    ref = _serve(T, eager, prompts)
    eng = engine()
    out = _serve(T, eng, prompts)
    assert out == ref
    model = eng.model
    kinds = {k[4] for k in model.dispatch_counts}
    assert "chain" in kinds and "sample" in kinds
    assert all(model._step_cache[k] is not None
               for k in model.dispatch_counts)
    eng.state_manager.check_invariants()


@pytest.mark.cuda
def test_scheduler_seed_reproduces_sampled_graph_tokens(cuda_device):
    """Sampled requests through the graphs: one seed gives the same
    tokens twice (replays advance the scheduler's generator), another
    seed gives others."""
    T, engine = _graph_llama(cuda_device)
    prompts = _graph_prompts()
    runs = [_serve(T, engine(), prompts, temperature=1.0, seed=s)
            for s in (5, 5, 6)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]


@pytest.mark.cuda
def test_strict_precompile_then_traffic_captures_nothing(cuda_device):
    """precompile(strict=True) over a small lattice captures every
    sample and chain key; traffic inside it then captures nothing, and a
    key outside it raises."""
    T, engine = _graph_llama(cuda_device)
    eng = engine()
    keys = eng.precompile(max_prompt=64, max_concurrency=4,
                          max_new_tokens=16, strict=True, sampling=True)
    model = eng.model
    graphs = sum(g is not None for g in model._step_cache.values())
    assert graphs == len(keys) > 0      # logits keys are graphs too
    captured = model.capture_seconds
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, n).tolist() for n in (30, 20, 12)]
    out = _serve(T, eng, prompts, n_new=10)
    assert all(len(t) == 10 for t in out.values())
    assert model.capture_seconds == captured
    assert sum(g is not None for g in model._step_cache.values()) == graphs
    sched = T.FastGenScheduler(eng)
    sched.submit(9, rng.integers(0, 128, 100).tolist())   # Q=128 > 64
    with pytest.raises(RuntimeError, match="not precompiled"):
        sched.step()


@pytest.mark.cuda
def test_a_dropped_engine_frees_its_graphs_without_the_collector(
        cuda_device):
    """Step graphs hold no reference to their model: with the garbage
    collector off, dropping a served engine frees the model, its graphs
    and its KV cache by reference counts alone."""
    import gc
    import weakref
    T, engine = _graph_llama(cuda_device)
    eng = engine()
    _serve(T, eng, _graph_prompts())
    model = eng.model
    refs = [weakref.ref(model)] + [weakref.ref(g) for g in
                                   model._step_cache.values()
                                   if g is not None]
    assert len(refs) > 1
    kv_bytes = model.kv_config.total_bytes()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng, model
        torch.cuda.synchronize()
        assert [r() for r in refs] == [None] * len(refs)
        assert held - torch.cuda.memory_allocated() >= kv_bytes
    finally:
        if collecting:
            gc.enable()


# ---------------------------------------------------------------------------
# preemption: page blobs, graphs across an offload/restore cycle, and
# windowed tables whose evicted slots point at a NaN null page
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("geometry", [(32, 32), (32, 8)],
                         ids=["llama_opt_7b", "mistral_7b"])
def test_offload_restore_round_trip_is_bit_equal(cuda_device, geometry,
                                                 pages):
    """A 7B model's page geometry (L layers, K kv heads of 128, 64-token
    pages; Llama-2-7B and OPT-6.7B share 32 x 32, Mistral has 8 kv
    heads): 18 pages to a pinned host blob and back into fresh pages of
    the same cache tensor, bit for bit, codes and scales alike."""
    from deepspeed_tpu_torch.inference.v2 import ragged as TR
    L, K = geometry
    cache = TR.BlockedKVCache(TR.KVCacheConfig(
        num_layers=L, kv_heads=K, head_dim=128, page_size=64, num_pages=40,
        quantization="int8" if pages == "int8" else "none"), cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    stores = ([cache.data.payload, cache.data.scale] if pages == "int8"
              else [cache.data])
    for t in stores:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=cuda_device, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=cuda_device))
    ptrs = [t.data_ptr() for t in stores]
    held = [int(p) for p in cache.reserve(20)]
    moved = held[1::2][:10] + held[:16:2][:8]
    before = [t[:, moved].clone() for t in stores]
    blob = cache.offload_pages(moved)
    torch.cuda.synchronize()
    parts = [blob.payload, blob.scale] if pages == "int8" else [blob]
    assert all(p.is_pinned() for p in parts)
    for part, ref in zip(parts, before):
        assert torch.equal(part, ref.cpu())
    for t in stores:                     # the freed pages are overwritten
        t[:, moved] = 0
    new = [int(p) for p in cache.restore_pages(blob)]
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in stores] == ptrs
    for t, ref in zip(stores, before):
        assert torch.equal(t[:, new], ref)


@pytest.mark.cuda
def test_graph_captured_before_an_offload_replays_after_restore(
        cuda_device):
    """A decode key's graph captured before sequence 1 is offloaded, its
    pages reused by sequence 2 and restored elsewhere: the replays after
    the restore give the tokens of an uninterrupted run."""
    T, engine = _graph_llama(cuda_device)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 128, 40).tolist()
    other = rng.integers(0, 128, 60).tolist()

    def run(interrupt):
        eng = engine(async_scheduling=False, prefix_caching=False)
        logits, toks = eng.put([1], [prompt]), []
        for i in range(10):
            if i == 5 and interrupt:
                model = eng.model
                captured = set(model._step_cache)
                decode = {k for k in captured if k[1] == 1}
                assert decode                       # captured already
                eng.offload_sequence(1)
                eng.put([2], [other])
                eng.flush(2)
                eng.restore_sequence(1)
                eng.state_manager.check_invariants()
            toks.append(int(logits[0].argmax()))
            logits = eng.put([1], [np.array([toks[-1]], np.int32)])
        if interrupt:
            assert decode <= set(eng.model._step_cache)
            assert all(eng.model._step_cache[k] is not None for k in decode)
        return toks

    assert run(True) == run(False)


WINDOW_CASES = {"decode": (4, 1, 6144), "chunk_q1024": (2, 1024, 5120)}


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_paged_kernel_over_an_evicted_table_skips_the_null_page(
        cuda_device, case, pages):
    """GQA 4:1 (32 heads over 8 kv heads), window 4096: the kernel over a
    table whose slots below the window point at a NaN-filled null page
    (what the engine leaves after eviction) gives the plain version over
    the whole table, and nothing non-finite."""
    S, Q, hist = WINDOW_CASES[case]
    H, K, window, dev = 32, 8, 4096, cuda_device
    g = torch.Generator(device=dev).manual_seed(5)
    width = -(-(hist + Q) // 64)
    n_pages = S * width
    kv = torch.randn(n_pages + 1, 64, 2, K, 128, generator=g, device=dev,
                     dtype=torch.bfloat16)
    kv[0] = float("nan")
    if pages == "int8":
        codes, scale = tpa.quantize_kv_blocks(kv[1:])
        kv = tpa.KVPages(
            torch.cat([torch.zeros_like(codes[:1]), codes]),
            torch.cat([torch.full_like(scale[:1], float("nan")), scale]))
    table = (torch.randperm(n_pages, generator=g, device=dev) + 1).reshape(
        S, width).int()
    start = torch.full((S,), hist, dtype=torch.int32, device=dev)
    start[1:] -= torch.randint(0, 64, (S - 1,), generator=g, device=dev,
                               dtype=torch.int32)
    evicted = table.clone()
    for s in range(S):
        first_live = max(int(start[s]) - window + 1, 0) // 64
        evicted[s, :first_live] = 0
    assert int((evicted == 0).sum()) >= S * 15
    q = torch.randn(S, Q, H, 128, generator=g, device=dev,
                    dtype=torch.bfloat16)
    out = tpa.paged_decode_attention(q, kv, evicted, start, window=window)
    ref = tpa.paged_attention(q, kv, table, start, window=window)
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)


# ---------------------------------------------------------------------------
# speculative decoding: the verify shape and its step graphs
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("groups", [1, 4], ids=["G1_split", "G4_tile"])
def test_paged_kernel_at_the_verify_shape_over_ragged_histories(
        cuda_device, groups, pages):
    """Q = 1 + spec_max_draft = 4 rows a slot with a causal limit each
    (G=1: 4 folded rows, the split-KV path; G=4: 16, the tile) over
    ragged histories, every table column past a slot's pages on a
    NaN-filled null page: finite, and the plain version's output over a
    finite null page."""
    dev, S, Q, H = cuda_device, 16, 4, 32
    K = H // groups
    g = torch.Generator(device=dev).manual_seed(9)
    hist = torch.randint(0, 1500, (S,), generator=g, device=dev,
                         dtype=torch.int32)
    hist[:3] = torch.tensor([0, 63, 64], dtype=torch.int32)
    need = [-(-(int(h) + Q) // 64) for h in hist]
    width = max(need) + 2
    kv = torch.randn(sum(need) + 1, 64, 2, K, 128, generator=g, device=dev,
                     dtype=torch.bfloat16)
    ids = (torch.randperm(sum(need), generator=g, device=dev) + 1).int()
    table = torch.zeros(S, width, dtype=torch.int32, device=dev)
    at = 0
    for s, n in enumerate(need):
        table[s, :n] = ids[at:at + n]
        at += n
    finite = kv.clone()
    finite[0] = 0.0
    kv[0] = float("nan")
    if pages == "int8":
        codes, scale = tpa.quantize_kv_blocks(finite)
        finite = tpa.KVPages(codes, scale)
        kv = tpa.KVPages(codes.clone(), scale.clone())
        kv.scale[0] = float("nan")
    q = torch.randn(S, Q, H, 128, generator=g, device=dev,
                    dtype=torch.bfloat16)
    out = tpa.paged_decode_attention(q, kv, table, hist)
    ref = tpa.paged_attention(q, finite, table, hist)
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)


def _spec_llama(dev, **serving):
    T, engine = _graph_llama(dev)
    return T, engine(speculative=True, prefix_caching=False, **serving)


def _held_against_eager(eng):
    """Every dispatch of ``eng``'s model runs its key's step body eagerly
    first, then the key's graph, on the same inputs: each spec and
    draft_spec verdict must be bit-equal, and a draft_fill graph must
    leave the draft pool as its eager body left it.  Returns the
    dispatches checked by kind.  (The null page is left out of the pool
    comparison: padding positions all write it, in no fixed order.)"""
    model = eng.model
    dispatch = model._dispatch
    checked = {}

    def compared(key, kv, generator, inputs):
        kind = key[4] if len(key) > 4 else "logits"
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(model.device)
             if isinstance(a, np.ndarray) else a for a in inputs]
        gen = None
        if generator is not None:
            gen = torch.Generator(device=model.device)
            gen.set_state(generator.get_state())
        ref = model._call(key, kv, gen, *t)
        pool = (eng.draft_kv[:, 1:].clone() if kind == "draft_fill"
                else None)
        out = dispatch(key, kv, generator, inputs)
        if kind in ("spec", "draft_spec"):
            assert torch.equal(out, ref), key
        elif kind == "draft_fill":
            assert out is None, key
            assert torch.equal(eng.draft_kv[:, 1:], pool), key
        checked[kind] = checked.get(kind, 0) + 1
        return out

    model._dispatch = compared
    return checked


@pytest.mark.cuda
@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_graphs_replay_equal_to_their_eager_bodies(cuda_device,
                                                        drafter):
    """A small spec-on engine (the debug llama at head_dim 128, bf16):
    every spec (n-gram) or draft_spec and draft_fill (self-draft) graph
    replay equals its eager body on the same inputs, every step is a
    replay, and the requests complete at full length."""
    T, eng = _spec_llama(cuda_device, spec_drafter=drafter)
    checked = _held_against_eager(eng)
    prompts = ([[7] * 12] * 2 if drafter == "ngram" else [])
    prompts += _graph_prompts()[3:]
    out = _serve(T, eng, prompts, n_new=24)
    assert all(len(v) == 24 for v in out.values())
    model = eng.model
    if drafter == "ngram":
        assert checked.get("spec")
    else:
        assert checked.get("draft_spec") and checked.get("draft_fill")
    assert all(model._step_cache[k] is not None
               for k in model.dispatch_counts)
    eng.state_manager.check_invariants()


def _replays_checked_locked(eng, lock):
    """Every sample / chain / mixed dispatch of ``eng``'s model runs its
    key's body eagerly first, then the graph, on the same inputs (the
    greedy tokens must be bit-equal); returns the dispatches checked."""
    model = eng.model
    dispatch = model._dispatch
    checked = []

    def compared(key, kv, generator, inputs):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(model.device)
             if isinstance(a, np.ndarray) else a for a in inputs]
        ref = model._call(key, kv, None, *t)
        out = dispatch(key, kv, generator, inputs)
        assert torch.equal(out, ref), key
        with lock:
            checked.append(key)
        return out

    model._dispatch = compared
    return checked


@pytest.mark.cuda
def test_two_engines_replay_from_two_threads(cuda_device):
    """Two debug engines in one process capture their graphs up front,
    then serve from a thread each (``serving.ReplicaPool.start``; the
    mixed keys, outside the power lattice, capture on the path while the
    other thread replays): every replay is bit-equal to its eager body,
    the tokens are one engine's synchronous run's, and in a second
    threaded run nothing is captured and the launch counts
    (process-global) hold exactly the replays of both replicas."""
    import threading
    from deepspeed_tpu_torch import serving as TS
    from deepspeed_tpu_torch.ops.kernel_loader import snapshot_launches
    T, engine = _graph_llama(cuda_device)
    prompts = _graph_prompts() + [_graph_prompts()[0][:50]]
    want = _serve(T, engine(), prompts)
    engines = [engine(), engine()]
    for eng in engines:
        eng.precompile(128, max_concurrency=8, max_new_tokens=16,
                       sampling=True)
    lock = threading.Lock()
    checked = [_replays_checked_locked(eng, lock) for eng in engines]

    def serve():
        pool = TS.ReplicaPool(lambda label: T.FastGenScheduler(
            engines[int(label[1:])]), replicas=2)
        pool.start()
        try:
            for uid, p in enumerate(prompts):
                pool.submit(uid, p, T.SamplingParams(max_new_tokens=12))
            assert pool.serve_until_idle(timeout_s=120.0)
        finally:
            pool.stop()
        assert not pool.errors
        return {u: [int(t) for t in v] for u, v in pool.results().items()}

    assert serve() == {u: [int(t) for t in v] for u, v in want.items()}
    assert all(checked) and sum(map(len, checked)) > len(prompts)
    for eng in engines:
        eng.model._dispatch = type(eng.model)._dispatch.__get__(eng.model)
        eng.reset_prefix_cache()
    # the counts of a second threaded run: exactly its replays' launches
    before = snapshot_launches()
    dispatched = [dict(eng.model.dispatch_counts) for eng in engines]
    captures = [eng.model.path_captures for eng in engines]
    assert serve() == {u: [int(t) for t in v] for u, v in want.items()}
    assert [eng.model.path_captures for eng in engines] == captures
    expect = 0
    for eng, old in zip(engines, dispatched):
        for key, n in eng.model.dispatch_counts.items():
            per = sum(sum(c.values())
                      for _, c in eng.model._step_cache[key].graph.launches)
            expect += (n - old.get(key, 0)) * per
    got = sum(k.launches_by_fn[fn] - c for k, counts in before
              for fn, c in counts.items())
    assert got == expect > 0


# ---------------------------------------------------------------------------
# keyed sampling and snapshots on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_keyed_draw_on_the_card_equals_the_cpu_draw(cuda_device):
    """The keyed draw's integer work (row keys, Threefry bits) is bit-equal
    on the card and on the CPU, the gumbel noise within 2 ulp of max(|g|,
    1) (each log within 1 ulp of the other's), and the tokens drawn from
    the same fp32 logits equal, greedy, temperature, top-k and top-p rows
    mixed (Llama-2's vocab)."""
    from deepspeed_tpu_torch.inference.v2 import sampling, threefry
    rng = np.random.default_rng(0)
    S, V = 16, 32000
    logits = _t((rng.standard_normal((S, V)) * 3).astype(np.float32))
    temps = _t(np.tile(np.array([0.0, 0.8, 1.0, 0.7], np.float32), S // 4))
    top_ks = _t(np.tile(np.array([0, 0, 50, 0], np.int32), S // 4))
    top_ps = _t(np.tile(np.array([1.0, 1.0, 1.0, 0.95], np.float32), S // 4))
    uids = _t(rng.integers(-2 ** 31, 2 ** 31, S).astype(np.int32))
    pos = _t(rng.integers(0, 4096, S).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda_device):
        base = threefry.key_from_seed(2 ** 32 + 5, device=dev)
        keys = sampling.derive_row_keys(base, uids.to(dev), pos.to(dev))
        out[str(dev)] = dict(
            keys=keys.cpu(), bits=threefry.random_bits(keys, V).cpu(),
            gumbel=threefry.gumbel(keys, V).cpu(),
            tokens=sampling.sample_keyed(
                logits.to(dev), keys, temps.to(dev), top_ks.to(dev),
                top_ps.to(dev)).cpu())
    cpu, card = out["cpu"], out[str(cuda_device)]
    assert torch.equal(cpu["keys"], card["keys"])
    assert torch.equal(cpu["bits"], card["bits"])
    g = cpu["gumbel"].numpy()
    spacing = np.spacing(np.maximum(np.abs(g), 1.0).astype(np.float32))
    assert (np.abs(g - card["gumbel"].numpy()) / spacing).max() <= 2.0
    assert torch.equal(cpu["tokens"], card["tokens"])


@pytest.mark.cuda
def test_keyed_graphs_serve_the_eager_keyed_tokens(cuda_device):
    """The default serving configuration with keyed sampling on the card:
    the graphs' tokens equal the same scheduler's over a model that runs
    its step bodies eagerly, every sampling step was a replay, and no
    graph drew from the generator."""
    T, engine = _graph_llama(cuda_device)
    prompts = _graph_prompts()

    def serve(eng):
        sched = T.FastGenScheduler(eng, seed=5)
        state = sched._generator.get_state()
        for uid, p in enumerate(prompts):
            sched.submit(uid, p, T.SamplingParams(
                max_new_tokens=12, temperature=0.8 * (uid % 2), top_k=40))
        out = sched.run_to_completion()
        assert torch.equal(sched._generator.get_state(), state)
        return out

    eager = engine(keyed_sampling=True)
    eager.model._new_step = lambda key, kv, inputs=None: None
    eng = engine(keyed_sampling=True)
    assert serve(eng) == serve(eager)
    model = eng.model
    assert all(model._step_cache[k] is not None
               for k in model.dispatch_counts)
    assert not any(g.stochastic for g in model._step_cache.values())


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_snapshot_pages_export_and_import_bit_equal_on_the_card(cuda_device,
                                                               pages):
    """A state manager's pages at Llama-2-7B's geometry (32 layers, 32 kv
    heads of 128, 64-token pages): exported to a bundle on the host and
    imported into a fresh manager on the card, every referenced page bit
    for bit (codes and scales alike), shared pages shared again."""
    from deepspeed_tpu_torch.inference.v2 import ragged as TR
    from deepspeed_tpu_torch.inference.v2 import snapshot as tsnap
    cfg = TR.KVCacheConfig(num_layers=32, kv_heads=32, head_dim=128,
                           page_size=64, num_pages=24,
                           quantization="int8" if pages == "int8" else "none")
    src = TR.StateManager(cfg, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for t in src.kv_cache._stores():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=cuda_device, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=cuda_device))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 32000, 200).astype(np.int32)
    for uid in (0, 1):
        sd = src.get_or_create_sequence(uid)
        src.match_prefix(sd, prompt)
        src.allocate_for(sd, 200)
        sd.pre_forward(200)
        sd.post_forward()
        src.index_prefix(sd)
    meta, arrays = src.export_state()
    data = tsnap.pack_bundle(dict(meta=meta, version=1), arrays)
    m, a = tsnap.unpack_bundle(data)
    dst = TR.StateManager(cfg, cuda_device)
    dst.import_state(m["meta"], a)
    dst.check_invariants()
    for uid in (0, 1):
        old, new = src.get_sequence(uid).pages, dst.get_sequence(uid).pages
        for so, sn in zip(src.kv_cache._stores(), dst.kv_cache._stores()):
            assert torch.equal(so[:, old], sn[:, new])
    assert dst.get_sequence(1).pages[:3] == dst.get_sequence(0).pages[:3]


# ---------------------------------------------------------------------------
# mined lattices and the host/disk page tier on the card
# ---------------------------------------------------------------------------

# Q tops a mined lattice takes from prompt lengths: multiples of neither
# 64 (the flash tile's rows) nor 16 (the paged tile's row block)
MINED_Q = [47, 333, 1091]


@pytest.mark.cuda
@pytest.mark.parametrize("Q", MINED_Q)
def test_flash_forward_at_a_mined_q_top_matches_plain(cuda_device, Q):
    """A fresh prefill bucketed at a mined top: partial query and key
    tiles, the causal limit of the last row."""
    g = torch.Generator(device=cuda_device).manual_seed(Q)
    q, k, v = (torch.randn(2, 8, Q, 128, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    out, lse = tfa.flash_fwd(q, k, v, causal=True)
    ref, ref_lse = tfa.flash_reference(q, k, v, causal=True)
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)
    assert_parity(lse, ref_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("Q", MINED_Q)
def test_paged_kernel_at_a_mined_q_top_matches_plain(cuda_device, Q, pages):
    """A continued prefill chunk at a mined top over paged history (the
    tile, Q·G rows not a multiple of its row block), two slots with
    different histories, one ending at the context's last position."""
    S, H, K, ctx = 2, 8, 2, 2048
    g = torch.Generator(device=cuda_device).manual_seed(Q + 1)
    n_pages = S * ctx // 64
    kv = torch.randn(n_pages + 1, 64, 2, K, 128, generator=g,
                     device=cuda_device, dtype=torch.bfloat16)
    if pages == "int8":
        kv = tpa.KVPages(*tpa.quantize_kv_blocks(kv))
    table = (torch.randperm(n_pages, generator=g, device=cuda_device)
             + 1).reshape(S, ctx // 64).int()
    start = torch.tensor([ctx - Q, 37], dtype=torch.int32,
                         device=cuda_device)
    q = torch.randn(S, Q, H, 128, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    out = tpa.paged_decode_attention(q, kv, table, start)
    ref = tpa.paged_attention(q, kv, table, start)
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pages", ["bf16", "int8"])
def test_a_page_demoted_spilled_and_promoted_is_bit_equal(cuda_device,
                                                          pages, tmp_path):
    """One page of a 7B geometry (32 layers, 32 kv heads of 128, 64
    tokens) read to a pinned host blob, split into single-page blobs,
    spilled from a one-page host ring to disk, read back and restored
    into a fresh page of the same cache tensor, bit for bit."""
    from deepspeed_tpu_torch.inference.v2 import ragged as TR
    from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import (
        blob_columns, concat_blobs)
    from deepspeed_tpu_torch.inference.v2.ragged.kv_tiers import (
        TieredPageStore)
    cache = TR.BlockedKVCache(TR.KVCacheConfig(
        num_layers=32, kv_heads=32, head_dim=128, page_size=64,
        num_pages=8, quantization="int8" if pages == "int8" else "none"),
        cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    stores = ([cache.data.payload, cache.data.scale] if pages == "int8"
              else [cache.data])
    for t in stores:
        t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                              device=cuda_device, dtype=torch.int8)
                if t.dtype == torch.int8
                else torch.randn(t.shape, generator=g, device=cuda_device))
    held = [int(p) for p in cache.reserve(2)]
    before = [t[:, held].clone() for t in stores]
    blob = cache.read_pages(held)
    torch.cuda.synchronize()
    store = TieredPageStore(1, disk_pages=2, disk_dir=str(tmp_path),
                            bytes_per_page=cache.cfg.bytes_per_page)
    store.put(b"a" * 16, blob_columns(blob, [0]))
    store.put(b"b" * 16, blob_columns(blob, [1]))   # "a" spills to disk
    assert store.contains(b"a" * 16) == "disk"
    got, tiers = store.take_many([b"a" * 16, b"b" * 16])
    assert tiers == ["disk", "host"]
    new = [int(p) for p in cache.restore_pages(concat_blobs(got))]
    store.landed(2)
    torch.cuda.synchronize()
    for t, ref in zip(stores, before):
        assert torch.equal(t[:, new], ref)
    store.check_invariants()
    store.close()


def _replays_against_eager(eng):
    """Every dispatch of ``eng``'s model runs its key's step body eagerly
    first, then the key's graph, on the same inputs: greedy tokens (and
    logits) bit-equal.  Returns the dispatches checked by key."""
    model = eng.model
    dispatch = model._dispatch
    checked = {}

    def compared(key, kv, generator, inputs):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(model.device)
             if isinstance(a, np.ndarray) else a for a in inputs]
        ref = model._call(key, kv, None, *t)
        out = dispatch(key, kv, generator, inputs)
        assert torch.equal(out, ref), key
        checked[key] = checked.get(key, 0) + 1
        return out

    model._dispatch = compared
    return checked


@pytest.mark.cuda
def test_a_mined_lattice_engine_replays_every_key_equal_to_eager(
        cuda_device, tmp_path):
    """The debug llama's traffic traced on the power lattice, the trace
    mined, and a fresh engine under ``lattice="auto:<artifact>"``:
    precompiled, it serves the traffic capturing nothing more, every key
    a replay bit-equal to its eager body, with the power engine's
    tokens."""
    from deepspeed_tpu_torch.inference.v2 import lattice as tlat
    from deepspeed_tpu_torch.telemetry.workload_trace import (
        get_workload_trace)
    T, engine = _graph_llama(cuda_device)
    rng = np.random.default_rng(3)
    # two prompts: a fresh step of more rows would pad S * Q past the
    # 128-token budget, a key no lattice enumerates (captured on the
    # path, in the JAX package too)
    prompts = [rng.integers(0, 128, n).tolist() for n in (37, 41)]
    trace = str(tmp_path / "trace.jsonl")
    get_workload_trace().configure(trace)
    try:
        ref = _serve(T, engine(), prompts)
    finally:
        get_workload_trace().close()
    art = str(tmp_path / "lattice.json")
    tlat.write_artifact(tlat.mine_lattice(tlat.load_trace_facts(trace),
                                          max_ragged_batch_size=128), art)
    eng = engine(lattice=f"auto:{art}")
    assert any(q & (q - 1) for q in eng.lattice.q_tops)
    eng.precompile(max_prompt=64, sampling=True)
    model = eng.model
    checked = _replays_against_eager(eng)
    assert _serve(T, eng, prompts) == ref
    assert model.path_captures == 0
    assert checked and all(model._step_cache[k] is not None
                           for k in model.dispatch_counts)
    eng.state_manager.check_invariants()


# ---------------------------------------------------------------------------
# head dims 64, 80 and 96 (Falcon-7B, Phi-2, Phi-3-mini), and one the
# kernels refuse
# ---------------------------------------------------------------------------

# (S, Q, H, K, context, window, ALiBi) at page 64: the split-KV decode,
# Falcon's multi-query decode (71 folded rows: the tile), a prefill chunk
# over history, Phi-3-mini's 2047-token window past a 4096 context, ALiBi
# on both paths, and a short last page
HEAD_DIM_PAGED_CASES = {
    "split_decode": (16, 1, 8, 8, 1024, None, False, 64),
    "mqa_decode_71": (4, 1, 71, 1, 1024, None, False, 64),
    "chunk_q256": (2, 256, 8, 8, 1024, None, False, 64),
    "window_2047": (2, 4, 8, 8, 4096, 2047, False, 64),
    "alibi_decode": (4, 1, 8, 8, 1024, None, True, 64),
    "alibi_chunk": (2, 64, 8, 8, 1024, None, True, 64),
    "page_48": (3, 20, 8, 2, 960, None, False, 48)}


def _head_dim_paged_inputs(dev, case, d, pages, seed=5):
    S, Q, H, K, ctx, _, _, page = HEAD_DIM_PAGED_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = S * ctx // page
    kv = torch.randn(n_pages + 1, page, 2, K, d, generator=g, device=dev,
                     dtype=torch.bfloat16)
    table = (torch.randperm(n_pages, generator=g, device=dev) + 1).reshape(
        S, ctx // page).int()
    start = torch.full((S,), ctx - Q, dtype=torch.int32, device=dev)
    start[1:] = torch.randint(0, ctx - Q + 1, (S - 1,), generator=g,
                              device=dev, dtype=torch.int32)
    if pages == "int8":
        kv = tpa.KVPages(*tpa.quantize_kv_blocks(kv))
    q = torch.randn(S, Q, H, d, generator=g, device=dev, dtype=torch.bfloat16)
    return q, kv, table, start


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("pages", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(HEAD_DIM_PAGED_CASES))
def test_paged_kernel_head_dims_match_plain(cuda_device, case, pages, d):
    """Both paths of the paged kernel at the narrower head dims, over bf16
    and int8 pages: the split-KV decode (threads past D sit out the P . V
    sum, the combine reads D-wide partials) and the tensor-core tile
    (round_up(D, 64)-wide tiles with zero padding columns)."""
    _, Q, H, K, _, window, alibi, _ = HEAD_DIM_PAGED_CASES[case]
    q, kv, table, start = _head_dim_paged_inputs(cuda_device, case, d, pages)
    kw = dict(window=window,
              alibi_slopes=alibi_slopes(H) if alibi else None)
    out = tpa.paged_decode_attention(q, kv, table, start, **kw)
    ref = tpa.paged_attention(q, kv, table, start, **kw)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    assert_parity(out, ref)


# (B, S, H, K, window, [B, S, H, D] views): uneven S, Falcon's one kv head
# under 71 query heads, a window, transposed views
HEAD_DIM_FLASH_CASES = {"s300": (2, 300, 8, 8, None, False),
                        "mqa_71": (1, 200, 71, 1, None, False),
                        "window_200": (1, 1000, 4, 4, 200, False),
                        "bshd_views": (2, 130, 8, 2, None, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("case", sorted(HEAD_DIM_FLASH_CASES))
def test_flash_kernel_head_dims_match_plain(cuda_device, case, d):
    b, s, h, kh, window, views = HEAD_DIM_FLASH_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(6)
    if views:
        q, k, v = (torch.randn(b, s, n, d, generator=g, device=cuda_device,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for n in (h, kh, kh))
    else:
        q, k, v = (torch.randn(b, n, s, d, generator=g, device=cuda_device,
                               dtype=torch.bfloat16) for n in (h, kh, kh))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    ref, ref_lse = tfa.flash_reference(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    assert_parity(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=1e-3)


# (S, H, K, window): uneven S, Falcon's one kv head under 71 query heads
# (the dK/dV block's group sum over 71 heads), GQA, a window that
# crosses blocks, one row past a tile
HEAD_DIM_FLASH_BWD_CASES = {"s300": (300, 8, 8, None),
                            "mqa_71": (200, 71, 1, None),
                            "gqa4": (256, 8, 2, None),
                            "window100": (256, 4, 4, 100),
                            "s65": (65, 4, 4, None)}


def _bshd_d(dev, g, s, h, d):
    return torch.randn(2, s, h, d, generator=g, device=dev,
                       dtype=torch.bfloat16).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 96])
@pytest.mark.parametrize("case", sorted(HEAD_DIM_FLASH_BWD_CASES))
def test_flash_bwd_kernel_head_dims_match_plain(cuda_device, case, d):
    s, h, kh, window = HEAD_DIM_FLASH_BWD_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (_bshd_d(cuda_device, g, s, n, d) for n in (h, kh, kh, h))
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    launches = dict(tfa.BWD_KERNEL.launches_by_fn)
    got = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    again = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    ref = tfa.flash_bwd_reference(q, k, v, out, lse, do, True, None, window)
    torch.cuda.synchronize()
    for fn in ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"):
        assert tfa.BWD_KERNEL.launches_by_fn[fn] == launches.get(fn, 0) + 2
    for name, a, b, c in zip("qkv", got, again, ref):
        assert a.shape == c.shape and a.dtype == c.dtype, name
        assert torch.equal(a, b), f"d{name} differs between two calls"
        assert_parity(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["falcon", "phi", "phi3"])
def test_training_at_head_dim_runs_the_backward_kernels(cuda_device,
                                                        family):
    """A two-layer model of each family at its head dim under "auto"
    trains through the flash kernels (one dK/dV and one dQ launch a
    layer) and its gradients agree with the einsum path's."""
    from deepspeed_tpu_torch.models.transformer import CausalLM, \
        TransformerConfig
    from deepspeed_tpu_torch.tree import tree_leaves, tree_map
    fields = {"falcon": dict(num_heads=8, num_kv_heads=1, head_dim=64,
                             activation="gelu_exact", parallel_residual=True,
                             norm="layernorm"),
              "phi": dict(num_heads=4, head_dim=80, rope_pct=0.4,
                          activation="gelu", parallel_residual=True,
                          norm="layernorm", use_bias=True),
              "phi3": dict(num_heads=4, head_dim=96, sliding_window=100,
                           activation="silu_gated")}[family]
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, max_seq_len=512, **fields)
    model = CausalLM(TransformerConfig(**base))
    params = model.init_params(seed=0, device=cuda_device)
    ids = torch.randint(0, 512, (2, 300), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(0))
    grads = []
    for impl in ("auto", "einsum"):
        m = CausalLM(TransformerConfig(attention_impl=impl, **base))
        params_c = tree_map(
            lambda t: t.detach().to(torch.bfloat16).requires_grad_(), params)
        before = dict(tfa.BWD_KERNEL.launches_by_fn)
        m.loss(params_c, {"input_ids": ids}).backward()
        ran = {fn: tfa.BWD_KERNEL.launches_by_fn[fn] - before.get(fn, 0)
               for fn in ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")}
        assert ran == dict.fromkeys(ran, 2 if impl == "auto" else 0), ran
        grads.append([c.grad.float() for c in tree_leaves(params_c)])
    for a, b in zip(*grads):
        rms = float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
        assert rms <= 5e-2, rms


@pytest.mark.cuda
def test_attention_kernels_refuse_head_dim_112(cuda_device):
    """D = 112 is no instantiation: the wrappers raise before a launch, and
    the C entry points, called around the wrappers, return
    cudaErrorInvalidValue (a RuntimeError) and launch nothing, the flash
    backward's too."""
    from deepspeed_tpu_torch.ops.kernel_loader import stream_of
    dev = cuda_device
    q, kv, table, start = _head_dim_paged_inputs(dev, "split_decode", 64,
                                                 "bf16")
    q112 = torch.randn(*q.shape[:3], 112, device=dev, dtype=torch.bfloat16)
    kv112 = torch.randn(*kv.shape[:4], 112, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_decode_attention(q112, kv112, table, start)
    S, Q, H, _ = q112.shape
    K = kv112.shape[3]
    out = torch.empty_like(q112)
    work = torch.empty(S * K * 2 * Q * H // K * (112 + 2),
                       dtype=torch.float32, device=dev)
    before = dict(tpa.KERNEL.launches_by_fn)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpa.KERNEL.launch("paged_attention_bf16", q112.data_ptr(),
                          kv112.data_ptr(), table.data_ptr(),
                          start.data_ptr(), None, out.data_ptr(),
                          work.data_ptr(), S, Q, H, K, 112, table.shape[1],
                          64, 0.1, 0, 2, stream_of(q112))
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpa.KERNEL.launch("paged_attention_combine", work.data_ptr(),
                          out.data_ptr(), S, Q, H, K, 112, 2,
                          stream_of(q112))
    assert tpa.KERNEL.launches_by_fn == before
    a = torch.randn(1, 4, 64, 112, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_fwd(a, a, a)
    lse = torch.empty(1, 4, 64, device=dev, dtype=torch.float32)
    before = tfa.KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfa.KERNEL.launch("flash_fwd_bf16", a.data_ptr(), a.data_ptr(),
                          a.data_ptr(), torch.empty_like(a).data_ptr(),
                          lse.data_ptr(), 1, 4, 4, 64, 64, 112,
                          *a.stride()[:3], *a.stride()[:3], *a.stride()[:3],
                          *a.stride()[:3], 0.1, 1, 0, stream_of(a))
    assert tfa.KERNEL.launches == before
    out = torch.empty_like(a)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_bwd(a, a, a, out, lse, torch.ones_like(a))
    delta = torch.zeros_like(lse)
    args = tfa.bwd_launch_args(a, a, a, a, lse, delta, out, out, out, True,
                               None, None)
    before = dict(tfa.BWD_KERNEL.launches_by_fn)
    for fn, fn_args in args.items():
        with pytest.raises(RuntimeError, match="CUDA error"):
            tfa.BWD_KERNEL.launch(fn, *fn_args)
    assert tfa.BWD_KERNEL.launches_by_fn == before


# ---------------------------------------------------------------------------
# the channelwise dequantise kernel (weight-only quantised serving)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "int8", "fp4_e2m1"])
@pytest.mark.parametrize("shape,batch_dims", [
    ((8, 512, 1792), 1),          # Mixtral's expert leaf at an eighth
    ((2, 4, 256, 448), 2),        # stacked over layers, per expert
    ((4096, 32, 128), 0),         # an attention wq, per channel
    ((32, 128, 4096), 0),         # an attention wo
    ((48, 32), 1),                # no reduced dim
])
def test_fp_dequant_kernel_matches_plain_bit_for_bit(cuda_device, fmt, shape,
                                                     batch_dims):
    g = torch.Generator(device=cuda_device).manual_seed(len(shape))
    w = torch.randn(shape, generator=g, device=cuda_device)
    w[0] *= 30.0                                  # an outlier slice
    leaf = tfq.quantize_channelwise(w, fmt, batch_dims)
    before = tfq.KERNEL.launches
    out = tfq.dequantize_channelwise(leaf)
    torch.cuda.synchronize()
    assert tfq.KERNEL.launches == before + 1
    ref = tfq.dequantize_channelwise_reference(leaf)
    assert out.dtype == torch.bfloat16 and torch.equal(out, ref)


@pytest.mark.cuda
def test_fp_dequant_kernel_refuses_what_it_does_not_take(cuda_device):
    from deepspeed_tpu_torch.ops.kernel_loader import stream_of
    w = torch.randn(8, 64, 32, device=cuda_device)
    leaf = tfq.quantize_channelwise(w, "fp8_e4m3", 1)
    with pytest.raises(TypeError, match="bfloat16"):
        tfq.dequantize_channelwise(leaf, torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        tfq.dequantize_channelwise(tfq.quantize_channelwise(
            torch.randn(8, 64, 24, device=cuda_device), "int8", 1))
    strided = leaf["q"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfq.dequantize_channelwise({"q": strided, "scale": leaf["scale"]})
    before = tfq.KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfq.KERNEL.launch("fp_dequant_e4m3_bf16", leaf["q"].data_ptr(),
                          leaf["scale"].data_ptr(),
                          torch.empty(w.shape, dtype=torch.bfloat16,
                                      device=cuda_device).data_ptr(),
                          w.numel(), 24, 64 * 24, stream_of(w))
    assert tfq.KERNEL.launches == before


@pytest.mark.cuda
def test_quantised_moe_model_serves_on_the_card(cuda_device):
    """A small Mixtral at head_dim 64 (the paged kernels' width) with fp8
    weights: every step a graph replay through the dequantise kernel, and
    the same greedy tokens as its eager bodies."""
    from deepspeed_tpu_torch.inference import v2 as T
    from deepspeed_tpu_torch.models.mixtral import mixtral_config
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.moe.layer import MoEConfig, init_moe_params
    cfg = mixtral_config("tiny", hidden_size=256, num_heads=4,
                         num_kv_heads=2, num_layers=2, moe_num_experts=4,
                         moe_top_k=2)
    params = init_params(cfg, 0, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    params["layers"]["mlp"] = {
        k: torch.stack([v, v]) for k, v in init_moe_params(
            MoEConfig(num_experts=4), 256, 256, gen, torch.bfloat16,
            cuda_device).items()}
    conf = T.RaggedInferenceEngineConfig.from_dict(
        {"quantization": {"enabled": True, "fmt": "fp8_e4m3"},
         "kv_cache": {"num_pages": 32}})
    engine = T.InferenceEngineV2(T.implementation_for("mixtral")(
        cfg, params, device=cuda_device), conf)
    assert engine.model.params["layers"]["mlp"]["wi"]["q"].dtype == \
        torch.float8_e4m3fn
    prompts = [[1, 5, 9, 2, 17, 33], [3, 4, 8]]
    before = tfq.KERNEL.launches
    graphs = T.generate(engine, prompts, T.SamplingParams(max_new_tokens=6))
    assert tfq.KERNEL.launches > before
    model = engine.model

    def eager(key, kv, generator, inputs):
        return model._call(key, kv, generator, *(
            torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
            if isinstance(a, np.ndarray) else a for a in inputs))
    engine.reset_prefix_cache()
    model._dispatch = eager
    try:
        assert T.generate(engine, prompts,
                          T.SamplingParams(max_new_tokens=6)) == graphs
    finally:
        del model._dispatch


# ---------------------------------------------------------------------------
# telemetry on the card: scrapes beside graph captures, the memory ledger
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_scrapes_while_step_graphs_capture(cuda_device):
    """A thread scrapes the port's metrics server (every route a gauge
    callback feeds: /metrics, /snapshot?raw=1, /memory, /healthz) while
    the serving thread captures a lattice of step graphs and then
    serves: every capture completes, every scrape answers, the tokens are
    those of an engine served with no scraper, and each step-cache miss
    is one capture."""
    import threading
    import urllib.request
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.telemetry import metrics as tm
    T, engine = _graph_llama(cuda_device)
    prompts = _graph_prompts()
    want = _serve(T, engine(), prompts)
    eng = engine()
    telemetry.enable()
    port = telemetry.start_http_server(0).server_address[1]
    stop, seen, errors = threading.Event(), [], []

    def scrape():
        paths = ("/metrics", "/snapshot?raw=1", "/memory?json=1",
                 "/healthz", "/snapshot?digests=1")
        while not stop.is_set():
            for path in paths:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}",
                            timeout=10) as r:
                        seen.append((path, r.status))
                except Exception as e:  # noqa: BLE001 (reported below)
                    errors.append((path, repr(e)))

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    try:
        keys = eng.precompile(128, max_concurrency=8, max_new_tokens=16,
                              sampling=True)
        captures0 = eng.model.path_captures
        misses0 = tm.FASTGEN_STEP_CACHE_MISS.value
        out = _serve(T, eng, prompts)
    finally:
        stop.set()
        t.join(timeout=30)
        telemetry.stop_http_server()
        telemetry.disable()
    assert not t.is_alive() and not errors, errors[:3]
    assert len(seen) >= 10 and {s for _, s in seen} == {200}
    assert len(keys) > 0 and all(eng.model._step_cache[k] is not None
                                 for k in keys)
    assert out == want
    assert tm.FASTGEN_STEP_CACHE_MISS.value - misses0 \
        == eng.model.path_captures - captures0


@pytest.mark.cuda
def test_memory_ledger_measures_the_card(cuda_device):
    """On the card the ledger's truth is the caching allocator's
    ``memory_allocated``, source "device": it follows a 1 GiB tensor as
    it comes and goes."""
    from deepspeed_tpu_torch.telemetry.memory import MemoryLedger
    led = MemoryLedger()
    led.register("weights", lambda: 0)

    def measured():
        led._measure_cache = (-1e9, None, "none")    # no cached probe
        return led.measured_bytes()

    torch.cuda.synchronize()
    base, source = measured()
    assert source == "device" and base == torch.cuda.memory_allocated()
    x = torch.empty(1 << 30, dtype=torch.uint8, device=cuda_device)
    grown, _ = measured()
    assert grown - base == 1 << 30 == torch.cuda.memory_allocated() - base
    assert led.breakdown()["measured_source"] == "device"
    del x
    assert measured() == (base, "device")


@pytest.mark.cuda
def test_optimized_linear_kernel_path_matches_plain(cuda_device):
    """``OptimizedLinear`` with an int8 base at a 4096 -> 11008 MLP
    shape, LoRA rank 16, bf16: on the card the base is quantised once by
    the quantise kernel (codes and scales bit-equal to the plain
    version's on the CPU) and dequantised by the dequantise kernel at
    every forward; the forward is held to the plain path's at
    ``assert_parity``'s tolerance, only the adapters get gradients."""
    from deepspeed_tpu_torch.linear import (LoRAConfig, OptimizedLinear,
                                            QuantizationConfig)
    lin = OptimizedLinear(4096, 11008, lora_config=LoRAConfig(lora_r=16),
                          quantization_config=QuantizationConfig(),
                          dtype=torch.bfloat16)
    base = torch.empty(4096, 11008).uniform_(
        -1 / 64, 1 / 64, generator=torch.Generator().manual_seed(0))
    n0 = dict(tq.KERNEL.launches_by_fn)
    card = lin.init(0, base_weight=base, device=cuda_device)
    plain = lin.init(0, base_weight=base, device="cpu")
    assert tq.KERNEL.launches_by_fn["quantize_blockwise_f32"] \
        == n0["quantize_blockwise_f32"] + 1
    for k in ("base_q", "base_scale"):
        assert torch.equal(card[k].cpu(), plain[k])
    with torch.no_grad():
        b = torch.randn(16, 11008, generator=torch.Generator().manual_seed(1))
        for p in (card, plain):
            p["lora_a"].copy_(plain["lora_a"])
            p["lora_b"].copy_(b.to(p["lora_b"].device, torch.bfloat16) / 16)
    x = torch.randn(64, 4096, generator=torch.Generator().manual_seed(2))
    out = lin.apply(card, x.to(cuda_device, torch.bfloat16))
    assert tq.KERNEL.launches_by_fn["dequantize_blockwise_bf16"] \
        == n0["dequantize_blockwise_bf16"] + 1
    ref = lin.apply(plain, x.bfloat16())
    assert_parity(out.float().cpu(), ref.float())
    out.float().square().mean().backward()
    assert {k for k, t in card.items() if t.grad is not None} \
        == {"lora_a", "lora_b"}
    merged = lin.merge(card)
    torch.testing.assert_close(merged.cpu(), lin.merge(plain), rtol=0,
                               atol=1e-6)


@pytest.mark.cuda
def test_sparse_embedding_gradient_on_the_card(cuda_device):
    """The sparse backward's table gradient (``index_add_`` of fp32 rows,
    atomics in no fixed order on the card) against the dense backward's
    in fp32: within 1e-5 of the largest row sum."""
    from deepspeed_tpu_torch.runtime.sparse_tensor import embedding_lookup
    g = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randn(50257, 256, generator=g, device=cuda_device)
    ids = torch.randint(0, 50257, (4, 512), generator=g, device=cuda_device)
    ids[:, ::8] = 11
    ct = torch.randn(4, 512, 256, generator=g, device=cuda_device)
    grads = []
    for fn in (embedding_lookup, lambda t, i: t[i.long()]):
        t = table.clone().requires_grad_()
        (fn(t, ids) * ct).sum().backward()
        grads.append(t.grad)
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(err) <= 1e-5
