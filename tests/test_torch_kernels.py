"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card, in bf16.

These tests need an NVIDIA GPU (and ``nvcc`` to build the kernels at
first use) and skip without one; they import neither JAX nor
``deepspeed_tpu``, so a GPU machine without JAX runs them:
``python -m pytest tests/test_torch_kernels.py -m cuda``.  Tolerances,
relative to each case's reference (``assert_parity``): rms 1e-2, max
2.5e-2.  The outputs are bf16, and the kernels accumulate in fp32 where
the plain path rounds scores and probabilities to bf16.  The AdamW
kernel is fp32 throughout and is held to 1e-6 of each buffer's largest
value as well (an ulp or two from fused multiply-adds).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.transformer import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
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


# (S, H, K, window): S not a multiple of the 64-row blocks, GQA (the
# group sum inside the dK/dV block), a sliding window, and a long uneven
# sequence over one kv head
FLASH_BWD_CASES = {"s300": (300, 8, 8, None), "gqa4": (300, 8, 2, None),
                   "window100": (256, 4, 4, 100),
                   "s1000_mqa": (1000, 4, 1, None)}


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
