"""Port ops (deepspeed_tpu_torch.ops) held against the JAX package's.

The same seeded numpy inputs go through the JAX function (Pallas kernels
in interpret mode, as tests/test_ops.py and tests/test_inference_v2.py
run them) and the port's plain PyTorch version, in fp32.  Tolerances:
1e-5 for the norms (fp32 reductions over E; bf16 outputs within one bf16
ulp at the output's scale), 2e-5 for attention (the
JAX kernel tests' own bound: fp32 softmax sums in another order).  The
kernel-vs-plain tests live in test_torch_kernels.py (no JAX import, so
they run on a GPU machine without JAX).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes
from deepspeed_tpu.ops import normalization as jnorm
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import normalization as tnorm
from deepspeed_tpu_torch.ops import paged_attention as tpa
from test_torch_kernels import PAGED_CASES, _paged_setup

# the JAX ops package re-exports the function under the module's name
jfa = importlib.import_module("deepspeed_tpu.ops.flash_attention")

ATTN_TOL = 2e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,eps", [((4, 32, 256), 1e-6), ((8, 64), 1e-5)])
def test_rmsnorm_plain_matches_jax_kernel(shape, eps):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    ref = jnorm.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps, interpret=True)
    out = tnorm.rmsnorm(_t(x), _t(w), eps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_rmsnorm_bf16_casts_back():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    out = tnorm.rmsnorm(x.bfloat16(), torch.ones(64))
    assert out.dtype == torch.bfloat16
    ref = tnorm.rmsnorm_reference(x.bfloat16().float(), torch.ones(64))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def _bf16_ulp(ref: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of ``ref`` (8 significant
    bits: 2^-7 relative to the leading power of two)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# fused residual RMSNorm and LayerNorm (cases of tests/test_ops.py:108-137)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,eps", [((8, 128), 1e-6), ((2, 5, 64), 1e-5)])
def test_rmsnorm_residual_plain_matches_jax_kernel(shape, eps):
    rng = np.random.default_rng(5)
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    ref, ref_res = jnorm.rmsnorm(jnp.asarray(x), jnp.asarray(w), eps,
                                 residual=jnp.asarray(r), interpret=True)
    out, res = tnorm.rmsnorm(_t(x), _t(w), eps, residual=_t(r))
    assert out.shape == shape and res.shape == shape
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_rmsnorm_residual_bf16_norms_the_unrounded_sum():
    """bf16 in and out: the new residual is bf16(fp32 sum) bit for bit,
    and the normed output (from the UNROUNDED sum) is within one bf16 ulp
    of the JAX kernel's."""
    rng = np.random.default_rng(6)
    x, r = (rng.standard_normal((8, 128)).astype(np.float32)
            for _ in range(2))
    w = (rng.standard_normal(128) + 1.0).astype(np.float32)
    ref, ref_res = jnorm.rmsnorm(_jbf16(x), jnp.asarray(w), 1e-5,
                                 residual=_jbf16(r), interpret=True)
    out, res = tnorm.rmsnorm(_t(x).bfloat16(), _t(w), 1e-5,
                             residual=_t(r).bfloat16())
    assert out.dtype == res.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        res.float().numpy(), np.asarray(ref_res.astype(jnp.float32)))
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref32,
                               atol=_bf16_ulp(ref32), rtol=0)


def _layernorm_inputs(shape, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + mean).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,eps,mean", [
    ((16, 128), 1e-5, 0.0), ((2, 5, 64), 1e-6, 0.0),
    ((16, 128), 1e-5, 300.0)])          # a row with mean >> std
def test_layernorm_plain_matches_jax_kernel(shape, eps, mean):
    x, w, b = _layernorm_inputs(shape, 7, mean)
    ref = jnorm.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          eps, interpret=True)
    out = tnorm.layernorm(_t(x), _t(w), _t(b), eps)
    # at mean 300 an fp32 ulp is 3.05e-5, so two orders of summing the
    # row's mean differ by about that, and (x - mean) * w with |w| up to
    # ~4 carries it to a few 1e-4; a one-pass variance would be off by
    # 1e-2 here
    atol = 3e-4 if mean else 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=1e-5)
    # and the numpy statement of tests/test_ops.py:127-136
    mu = x.mean(-1, keepdims=True)
    np_ref = (x - mu) / np.sqrt(x.var(-1, keepdims=True) + eps) * w + b
    np.testing.assert_allclose(out.numpy(), np_ref, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("mean", [0.0, 300.0])
def test_layernorm_bf16_within_one_ulp_of_jax_kernel(mean):
    x, w, b = _layernorm_inputs((16, 128), 8, mean)
    ref = jnorm.layernorm(_jbf16(x), jnp.asarray(w), jnp.asarray(b), 1e-5,
                          interpret=True)
    out = tnorm.layernorm(_t(x).bfloat16(), _t(w), _t(b), 1e-5)
    assert out.dtype == torch.bfloat16
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref32,
                               atol=_bf16_ulp(ref32), rtol=0)


def test_layernorm_plain_is_the_model_norm():
    """The registry's plain norm (``_norm_apply``) and the op's plain
    version are the same function of the same inputs."""
    from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                        _norm_apply)
    x, w, b = _layernorm_inputs((4, 64), 9, 5.0)
    cfg = TransformerConfig(norm="layernorm", norm_eps=1e-5)
    out = _norm_apply(cfg, {"scale": _t(w), "bias": _t(b)}, _t(x).bfloat16())
    ref = tnorm.layernorm_reference(_t(x).bfloat16(), _t(w), _t(b), 1e-5)
    assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,seq", [
    (True, None, 128), (True, 48, 128), (False, None, 128), (True, None, 96)])
def test_flash_plain_matches_jax_kernel(causal, window, seq):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 2, seq, 32)).astype(np.float32)
               for _ in range(3))
    scale = 32 ** -0.5
    ref_out, ref_lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale, causal, 64, 32,
                                      True, window)
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), causal=causal,
                             sm_scale=scale, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    ref = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window)
    np.testing.assert_allclose(
        tfa.mha_reference(_t(q), _t(k), _t(v), causal=causal,
                          window=window).numpy(),
        np.asarray(ref), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_flash_gqa_reads_kv_head_h_over_g():
    """Port k/v with K < H heads == JAX with kv repeated up to H."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 64, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
            for _ in range(2))
    ref = jfa.mha_reference(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 1),
                            jnp.repeat(jnp.asarray(v), 2, 1), causal=True)
    out = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# paged attention (cases of tests/test_inference_v2.py:125-195 and
# tests/test_fused_serving.py:439-482)
# ---------------------------------------------------------------------------

def _write_both(q, k_new, v_new, kv, table, start, q_lens):
    jkv = jpa.write_kv(jnp.asarray(kv), jnp.asarray(k_new),
                       jnp.asarray(v_new), jnp.asarray(table),
                       jnp.asarray(start), jnp.asarray(q_lens))
    tkv = tpa.write_kv(_t(kv), _t(k_new), _t(v_new), _t(table), _t(start),
                       _t(q_lens))
    return jkv, tkv


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_paged_plain_matches_jax(case, variant):
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(
        **PAGED_CASES[case])
    jkv, tkv = _write_both(q, k_new, v_new, kv, table, start, q_lens)
    kw = {}
    if variant == "window":
        kw["window"] = 6
    if variant == "alibi":
        kw["alibi_slopes"] = alibi_slopes(q.shape[2])
    args = (jnp.asarray(q), jkv, jnp.asarray(table), jnp.asarray(start))
    ref_kernel = jpa.paged_decode_attention(*args, interpret=True, **kw)
    ref_dense = jpa.paged_attention(*args, jnp.asarray(q_lens),
                                    use_kernel=False, **kw)
    out = tpa.paged_decode_attention(_t(q), tkv, _t(table), _t(start), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_dense),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_paged_matches_dense_attention_reference(window):
    """Paged attention over written pages == the dense ground truth over
    the unpaged context, in both packages."""
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(D=16)
    _, tkv = _write_both(q, k_new, v_new, kv, table, start, q_lens)
    S, Q = q.shape[:2]
    C = table.shape[1] * kv.shape[1]
    pages = tkv.numpy()[table]                    # [S, P, page, 2, K, D]
    k_ctx = pages[..., 0, :, :].reshape(S, C, 2, 16)
    v_ctx = pages[..., 1, :, :].reshape(S, C, 2, 16)
    ref = jpa.attention_reference(jnp.asarray(q), jnp.asarray(k_ctx),
                                  jnp.asarray(v_ctx), jnp.asarray(start),
                                  jnp.asarray(q_lens), window=window)
    dense = tpa.attention_reference(_t(q), _t(k_ctx), _t(v_ctx), _t(start),
                                    _t(q_lens), window=window)
    paged = tpa.paged_attention(_t(q), tkv, _t(table), _t(start), _t(q_lens),
                                window=window)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


def test_write_kv_pages_bit_identical_to_jax():
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(hist=(5, 0, 11))
    q_lens[1] = 0                      # slot 1 becomes padding
    q_lens[2] = 2                      # ragged: rows 2, 3 are padding
    jkv, tkv = _write_both(q, k_new, v_new, kv, table, start, q_lens)
    # page 0 absorbs every padding row; which duplicate lands there is
    # unspecified in both packages, so compare the real pages
    np.testing.assert_array_equal(tkv.numpy()[1:], np.asarray(jkv)[1:])
    pages_1 = table[1][table[1] > 0]
    np.testing.assert_array_equal(tkv.numpy()[pages_1], kv[pages_1])


def test_rope_write_kv_matches_jax():
    from deepspeed_tpu.models.llama import llama_config as jcfg
    from deepspeed_tpu.models.transformer import rope_table as jrope
    from deepspeed_tpu_torch.models.llama import llama_config as tcfg
    from deepspeed_tpu_torch.models.transformer import rope_table as trope
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(D=16)
    sin, cos = jrope(jcfg("debug", head_dim=16),
                     jpa.token_positions(jnp.asarray(start), 4))
    jkv = jpa.rope_write_kv(jnp.asarray(kv), jnp.asarray(k_new),
                            jnp.asarray(v_new), sin, cos, jnp.asarray(table),
                            jnp.asarray(start), jnp.asarray(q_lens))
    tsin, tcos = trope(tcfg("debug", head_dim=16),
                       tpa.token_positions(_t(start), 4))
    tkv = tpa.rope_write_kv(_t(kv), _t(k_new), _t(v_new), tsin, tcos,
                            _t(table), _t(start), _t(q_lens))
    np.testing.assert_allclose(tkv.numpy()[1:], np.asarray(jkv)[1:],
                               atol=1e-6, rtol=1e-6)


def test_padding_rows_stay_finite_and_mask_is_jax_value():
    assert tpa.MASK_VALUE == jpa.MASK_VALUE
    assert tfa.DEFAULT_MASK_VALUE == jfa.DEFAULT_MASK_VALUE
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(hist=(5, 0, 11))
    q_lens[0] = 1
    kv[0] = 1e4                        # garbage in the null page
    _, tkv = _write_both(q, k_new, v_new, kv, table, start, q_lens)
    out = tpa.paged_decode_attention(_t(q), tkv, _t(table), _t(start),
                                     window=3)
    assert torch.isfinite(out).all()


def test_gather_last_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    q_lens = np.array([3, 8, 0, 1], np.int32)
    ref = jpa.gather_last(jnp.asarray(x), jnp.asarray(q_lens))
    np.testing.assert_array_equal(tpa.gather_last(_t(x), _t(q_lens)).numpy(),
                                  np.asarray(ref))
