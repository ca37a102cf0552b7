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
its stepped p within 1e-5).  The blockwise quantisation kernels are held
to bit-equality with their plain versions.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as tfa
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
NORM_GRID = [(n, e) for n in (1, 8, 16, 1024, 4096) for e in (2560, 4096,
                                                              8192)]


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
    with pytest.raises(TypeError, match="fp32 g"):
        tfo.fused_lion_flat(p, grad.bfloat16(), m, 1e-4, 0.9, 0.99, 0.0)
    with pytest.raises(ValueError, match="aligned"):
        tfo.fused_lion_flat(p[1:], grad[1:], m[1:], 1e-4, 0.9, 0.99, 0.0)
    with pytest.raises(ValueError, match="aligned"):
        tfo.lamb_stage1(p, grad, m[:-4], v, 0.9, 0.999, 1e-6, 0.0, 1)
    with pytest.raises(TypeError, match="fp32 v"):
        tfo.fused_lamb_flat(p, grad, m, v.half(), 1e-2, 0.9, 0.999, 1e-6,
                            0.0, 1)
    with pytest.raises(ValueError, match="1-based"):
        tfo.fused_lamb_flat(p, grad, m, v, 1e-2, 0.9, 0.999, 1e-6, 0.0, 0)


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
