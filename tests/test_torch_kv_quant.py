"""The port's int8 KV pages held against the JAX package's.

``quantize_kv_blocks`` / ``dequantize_kv_blocks`` must give JAX's codes
and scales bit for bit (both compute in fp32 and round half to even), so
that a page written by either package reads the same.  ``write_kv`` and
``paged_attention`` over ``KVPages`` are held to the JAX jnp path (fp32,
1e-5: the same sums in another order) and to the JAX Pallas kernel in
interpret mode (2e-3: that kernel rounds the dequantised K to ``q.dtype``
and keeps V and the probabilities in fp32; in fp32 the difference is
summation order only, and the bound is the one the JAX suite uses for
its own quantised kernel).  Shapes are those of
tests/test_inference_v2.py:125-195.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.ragged import kv_cache as jkvc
from deepspeed_tpu.models.transformer import alibi_slopes
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as tkvc
from deepspeed_tpu_torch.ops import paged_attention as tpa
from test_torch_kernels import PAGED_CASES, _paged_setup

JNP_TOL = 1e-5
KERNEL_TOL = 2e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# quantise / dequantise
# ---------------------------------------------------------------------------

def _blocks(seed=0):
    """[4, 16, 2, 2, 16] values x3 with special blocks: all zero, an amax
    below the 1e-30 floor of the divisor, one tiny normal amax, exact
    .5 ties (which must round to even), and a block at the clip edge."""
    rng = np.random.default_rng(seed)
    kv = (rng.standard_normal((4, 16, 2, 2, 16)) * 3.0).astype(np.float32)
    kv[0, 0, 0, 0] = 0.0
    kv[0, 1, 0, 0] = rng.standard_normal(16).astype(np.float32) * 1e-36
    kv[0, 2, 0, 0] = rng.standard_normal(16).astype(np.float32) * 1e-25
    kv[0, 3, 0, 0] = np.arange(16, dtype=np.float32) * 0.5   # amax 7.5
    kv[0, 3, 0, 0, -1] = 127.0           # scale 1: codes k/2, ties at .5
    kv[0, 4, 0, 0] = -127.0
    return kv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_blocks_bit_equal_to_jax(dtype):
    kv = _blocks()
    if dtype == "bfloat16":
        jkv = jnp.asarray(kv).astype(jnp.bfloat16)
        tkv = _t(kv).bfloat16()
    else:
        jkv, tkv = jnp.asarray(kv), _t(kv)
    jcodes, jscale = jpa.quantize_kv_blocks(jkv)
    codes, scale = tpa.quantize_kv_blocks(tkv)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    assert codes.shape == kv.shape and scale.shape == kv.shape[:-1]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))
    assert int(codes[0, 0, 0, 0].abs().max()) == 0 and \
        float(scale[0, 0, 0, 0]) == 0.0          # the zero block
    assert int(codes[0, 1, 0, 0].abs().max()) == 0   # below the floor
    if dtype == "float32":
        # ties round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert codes[0, 3, 0, 0, 1:6].tolist() == [0, 1, 2, 2, 2]
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        back = tpa.dequantize_kv_blocks(codes, scale, out_dtype)
        jback = jpa.dequantize_kv_blocks(jcodes, jscale, jdt)
        np.testing.assert_array_equal(
            back.float().numpy(), np.asarray(jback.astype(jnp.float32)))


def test_roundtrip_error_bounded_by_half_scale():
    """tests/test_kv_tiers.py:146-164 on the port's functions."""
    rng = np.random.default_rng(0)
    kv = _t((rng.normal(size=(4, 16, 2, 2, 16)) * 3.0).astype(np.float32))
    codes, scale = tpa.quantize_kv_blocks(kv)
    assert int(codes.abs().max()) <= 127
    err = (tpa.dequantize_kv_blocks(codes, scale) - kv).abs()
    assert bool((err <= scale[..., None] * 0.5 + 1e-6).all())
    zeros = torch.zeros(1, 4, 2, 1, 8)
    codes, scale = tpa.quantize_kv_blocks(zeros)
    back = tpa.dequantize_kv_blocks(codes, scale)
    assert int(codes.abs().max()) == 0
    assert bool((back == 0).all()) and bool(torch.isfinite(back).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_cache_config_footprint_matches_jax(dtype):
    """tests/test_kv_tiers.py:166-175: bytes_per_page counts codes and
    the scale sidecar, equal to JAX's, and funds >= 1.7x the fp32
    pages."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jfp = jkvc.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                             page_size=16, num_pages=7, dtype=jdt)
    tfp = tkvc.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                             page_size=16, num_pages=7, dtype=tdt)
    jq = dataclasses.replace(jfp, quantization="int8")
    tq = dataclasses.replace(tfp, quantization="int8")
    assert not tfp.quantized and tq.quantized
    for j, t in ((jfp, tfp), (jq, tq)):
        assert t.bytes_per_page == j.bytes_per_page
        assert t.total_bytes() == j.total_bytes()
    if dtype == "float32":
        assert tfp.bytes_per_page / tq.bytes_per_page >= 1.7
    with pytest.raises(ValueError, match="int4"):
        tkvc.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                           quantization="int4")


def test_blocked_kv_cache_builds_zeroed_kv_pages():
    cfg = tkvc.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                             page_size=8, num_pages=5, quantization="int8")
    cache = tkvc.BlockedKVCache(cfg, torch.device("cpu"))
    data = cache.data
    assert isinstance(data, tpa.KVPages)
    assert data.shape == (2, 6, 8, 2, 2, 16) and data.dtype == torch.int8
    assert data.scale.shape == (2, 6, 8, 2, 2)
    assert data.scale.dtype == torch.float32
    assert not data.payload.any() and not data.scale.any()
    layer = data[1]                      # a view: writes reach the cache
    layer.payload[3, 0] = 5
    layer.scale[3, 0] = 2.0
    assert int(data.payload[1, 3, 0, 0, 0, 0]) == 5
    assert float(data.scale[1, 3, 0, 0, 0]) == 2.0
    fp = tkvc.BlockedKVCache(dataclasses.replace(cfg, quantization="none"),
                             torch.device("cpu"))
    assert isinstance(fp.data, torch.Tensor)
    assert fp.data.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# write_kv + paged attention over KVPages
# ---------------------------------------------------------------------------

def _quantised_caches(kv):
    """The case's fp history quantised into a JAX and a port KVPages."""
    jcodes, jscale = jpa.quantize_kv_blocks(jnp.asarray(kv))
    return (jpa.KVPages(jcodes, jscale),
            tpa.KVPages(_t(np.asarray(jcodes)), _t(np.asarray(jscale))))


def _write_both(k_new, v_new, kv, table, start, q_lens):
    jkv, tkv = _quantised_caches(kv)
    jkv = jpa.write_kv(jkv, jnp.asarray(k_new), jnp.asarray(v_new),
                       jnp.asarray(table), jnp.asarray(start),
                       jnp.asarray(q_lens))
    out = tpa.write_kv(tkv, _t(k_new), _t(v_new), _t(table), _t(start),
                       _t(q_lens))
    assert out is tkv                     # in place
    return jkv, tkv


def test_write_kv_quantises_at_append_bit_identical_to_jax():
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(hist=(5, 0, 11))
    q_lens[1] = 0                      # slot 1 becomes padding
    q_lens[2] = 2                      # ragged: rows 2, 3 are padding
    jkv, tkv = _write_both(k_new, v_new, kv, table, start, q_lens)
    # page 0 absorbs the padding rows (which duplicate lands is
    # unspecified in both packages): compare the real pages
    np.testing.assert_array_equal(tkv.payload.numpy()[1:],
                                  np.asarray(jkv.payload)[1:])
    np.testing.assert_array_equal(tkv.scale.numpy()[1:],
                                  np.asarray(jkv.scale)[1:])
    # a written row is self-consistent: its codes and its scale are those
    # of quantising that row alone
    page, slot = int(table[0, 0]), int(start[0])
    codes, scale = tpa.quantize_kv_blocks(
        torch.stack([_t(k_new)[0, 0], _t(v_new)[0, 0]]))
    assert torch.equal(tkv.payload[page, slot], codes)
    assert torch.equal(tkv.scale[page, slot], scale)
    k_ctx, v_ctx = tpa.paged_context(tkv, _t(table))
    jk, jv = jpa.paged_context(jkv, jnp.asarray(table))
    live = table > 0                   # null-page columns hold the padding
    S, page_size = table.shape[0], kv.shape[1]
    keep = np.repeat(live, page_size, axis=1)
    np.testing.assert_array_equal(k_ctx.numpy()[keep], np.asarray(jk)[keep])
    np.testing.assert_array_equal(v_ctx.numpy()[keep], np.asarray(jv)[keep])
    assert k_ctx.dtype == torch.float32 and k_ctx.shape[:2] == (
        S, table.shape[1] * page_size)


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("variant", ["plain", "window", "alibi"])
def test_paged_attention_over_kv_pages_matches_jax(case, variant):
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(
        **PAGED_CASES[case])
    jkv, tkv = _write_both(k_new, v_new, kv, table, start, q_lens)
    kw = {}
    if variant == "window":
        kw["window"] = 6
    if variant == "alibi":
        kw["alibi_slopes"] = alibi_slopes(q.shape[2])
    args = (jnp.asarray(q), jkv, jnp.asarray(table), jnp.asarray(start))
    ref_jnp = jpa.paged_attention(*args, jnp.asarray(q_lens),
                                  use_kernel=False, **kw)
    ref_kernel = jpa.paged_attention(*args, jnp.asarray(q_lens),
                                     interpret=True, **kw)
    for fn in (tpa.paged_attention, tpa.paged_decode_attention):
        out = fn(_t(q), tkv, _t(table), _t(start), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_jnp),
                                   atol=JNP_TOL, rtol=JNP_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel),
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_paged_attention_dequantises_to_the_query_dtype():
    """bf16 queries over int8 pages: the gathered context is dequantised
    to bf16 (as the JAX jnp path does), the output is bf16, and it equals
    plain attention over the dequantised fp pages."""
    q, k_new, v_new, kv, table, start, q_lens = _paged_setup(D=16)
    _, tkv = _write_both(k_new, v_new, kv, table, start, q_lens)
    qb = _t(q).bfloat16()
    out = tpa.paged_attention(qb, tkv, _t(table), _t(start))
    assert out.dtype == torch.bfloat16
    fp_pages = tpa.dequantize_kv_blocks(tkv.payload, tkv.scale,
                                        torch.bfloat16)
    assert torch.equal(out, tpa.paged_attention(qb, fp_pages, _t(table),
                                                _t(start)))


def test_unwritten_rows_dequantise_to_exact_zero():
    cfg = tkvc.KVCacheConfig(num_layers=1, kv_heads=2, head_dim=16,
                             page_size=8, num_pages=4, quantization="int8")
    layer = tkvc.BlockedKVCache(cfg, torch.device("cpu")).data[0]
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    q = torch.randn(1, 1, 4, 16)
    out = tpa.paged_decode_attention(q, layer, table,
                                     torch.tensor([9], dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))
