"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card, in bf16.

These tests need an NVIDIA GPU (and ``nvcc`` to build the kernels at
first use) and skip without one; they import neither JAX nor
``deepspeed_tpu``, so a GPU machine without JAX runs them:
``python -m pytest tests/test_torch_kernels.py -m cuda``.  Tolerances,
relative to each case's reference (``assert_parity``): rms 1e-2, max
2.5e-2.  The outputs are bf16, and the kernels accumulate in fp32 where
the plain path rounds scores and probabilities to bf16.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import normalization as tnorm
from deepspeed_tpu_torch.ops import paged_attention as tpa


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


@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_parity_limits_pass_rounding_and_fail_an_extra_key(variant):
    """The kernels differ from the plain versions by rounding only: they
    keep scores and probabilities in fp32 where the plain versions round
    them to bf16.  The plain function run in fp32 and rounded to bf16 at
    the end stands in for a kernel here, at the decode shape with
    contexts up to 2048: it passes ``assert_parity``, while the same
    function shifted one position (one key past the causal limit, or the
    window one key late) fails the rms limit."""
    g = torch.Generator().manual_seed(0)
    S, H, D, page, ctx = 4, 8, 128, 64, 2048
    kv = torch.randn(S * ctx // page + 1, page, 2, H, D, generator=g)
    table = (torch.randperm(S * ctx // page, generator=g) + 1).reshape(
        S, ctx // page).int()
    start = torch.randint(1024, ctx - 1, (S,), generator=g).int()
    q = torch.randn(S, 1, H, D, generator=g)
    kw = {"window": 512} if variant == "window" else {}
    if variant == "alibi":
        kw["alibi_slopes"] = alibi_slopes(H)
    ref = tpa.paged_attention(q.bfloat16(), kv.bfloat16(), table, start, **kw)
    fp32 = tpa.paged_attention(q, kv, table, start, **kw).bfloat16()
    assert_parity(fp32, ref)
    shifted = tpa.paged_attention(q, kv, table, start + 1, **kw).bfloat16()
    assert parity_errors(shifted, ref)[0] > RMS_REL_TOL


@pytest.mark.cuda
def test_rmsnorm_kernel_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(1024, 4096, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    w = torch.rand(4096, generator=g, device=cuda_device) + 0.5
    out = tnorm.rmsnorm(x, w, 1e-5)
    ref = tnorm.rmsnorm_reference(x, w, 1e-5)
    assert_parity(out, ref)


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
