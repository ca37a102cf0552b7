"""The port's model (bridge, blocks, layer, step) held against JAX.

Weights come from the JAX initializer of the ``debug`` llama and cross
through ``checkpoint/from_jax.py``; inputs are seeded numpy; everything
runs in fp32 on the CPU.  Layer and logits tolerance: 1e-5 absolute for
one layer, 1e-4 relative for full-model logits (fp32 matmuls summed in
another order across two layers and the lm head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.models import transformer as TT
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.ops import paged_attention as tpa

PAGE, PAGES = 8, 24


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _jax_tree(scan_layers=True):
    md = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32,
                          scan_layers=scan_layers)
    return md.cfg, meta.unbox(md.init_params(jax.random.key(0)))


def _tcfg(**kw):
    return llama_config("debug", max_seq_len=256, dtype=torch.float32, **kw)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = _jax_tree()
    tcfg = _tcfg()
    tparams = from_jax(_np_tree(jparams), tcfg, device="cpu")
    jkv = J.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                          page_size=PAGE, num_pages=PAGES, dtype=jnp.float32)
    tkv = T.KVCacheConfig(num_layers=2, kv_heads=2, head_dim=16,
                          page_size=PAGE, num_pages=PAGES,
                          dtype=torch.float32)
    jm = J.RaggedInferenceModel(jcfg, jparams, kv_config=jkv)
    tm = T.RaggedInferenceModel(tcfg, tparams, kv_config=tkv, device="cpu")
    return jm, tm


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

def test_bridge_keeps_both_layer_layouts():
    """The JAX initializer draws the same per-layer values for both
    layouts, so the bridged stacked leaves equal the per-layer ones."""
    _, stacked = _jax_tree(True)
    _, per_layer = _jax_tree(False)
    ts = from_jax(_np_tree(stacked), _tcfg(), device="cpu")
    tl = from_jax(_np_tree(per_layer), _tcfg(scan_layers=False),
                  device="cpu")
    assert ts["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert tl["layers"]["layer_1"]["attn"]["wk"].shape == (64, 2, 16)
    assert tl["lm_head"].shape == (64, 128)
    for i in range(2):
        a = TT.layer_params(_tcfg(), ts, i)
        b = TT.layer_params(_tcfg(scan_layers=False), tl, i)
        for group in ("attn", "mlp", "norm1", "norm2"):
            for name in a[group]:
                torch.testing.assert_close(a[group][name], b[group][name],
                                           rtol=0, atol=0)
    np.testing.assert_array_equal(
        tl["layers"]["layer_0"]["mlp"]["wg"].numpy(),
        np.asarray(per_layer["layers"]["layer_0"]["mlp"]["wg"]))


def test_bridge_rejects_a_layout_mismatch():
    _, per_layer = _jax_tree(False)
    with pytest.raises(ValueError):
        from_jax(_np_tree(per_layer), _tcfg(), device="cpu")
    _, stacked = _jax_tree(True)
    bad = _np_tree(stacked)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :2]
    with pytest.raises(ValueError):
        from_jax(bad, _tcfg(), device="cpu")


def test_bridge_casts_matrices_and_keeps_norms_fp32():
    _, stacked = _jax_tree(True)
    t = from_jax(_np_tree(stacked), _tcfg(), device="cpu",
                 dtype=torch.bfloat16)
    assert t["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert t["layers"]["norm1"]["scale"].dtype == torch.float32
    assert t["final_norm"]["scale"].dtype == torch.float32


# ---------------------------------------------------------------------------
# one layer and the full step
# ---------------------------------------------------------------------------

def _batch(S=3, Q=4, hist=(5, 0, 11), seed=0, fresh=False):
    rng = np.random.default_rng(seed)
    if fresh:
        hist = (0,) * S
    table = np.zeros((S, 8), np.int32)
    nxt = 1
    for s in range(S):
        n = -(-(hist[s] + Q) // PAGE)
        table[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    start = np.asarray(hist, np.int32)
    q_lens = np.full(S, Q, np.int32)
    q_lens[-1] = Q - 1                         # one ragged row of padding
    tokens = rng.integers(0, 128, (S, Q)).astype(np.int32)
    return tokens, q_lens, start, table


@pytest.mark.parametrize("fresh", [False, True])
def test_layer_body_matches_jax(models, fresh):
    jm, tm = models
    tokens, q_lens, start, table = _batch(fresh=fresh)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 64)).astype(np.float32)
    kv = (rng.standard_normal((PAGES + 1, PAGE, 2, 2, 16)) * 0.5).astype(
        np.float32)
    pos = jpa.token_positions(jnp.asarray(start), 4)
    sin, cos = JT.rope_table(jm.cfg, pos)
    lp = jax.tree.map(lambda a: a[0], jm.params["layers"])
    jx, jkv = jm._layer_body(
        jnp.asarray(x), lp, jnp.asarray(kv), pos=pos, sin=sin, cos=cos,
        q_lens=jnp.asarray(q_lens), start_pos=jnp.asarray(start),
        page_table=jnp.asarray(table), fresh=fresh)
    tstart = torch.from_numpy(start)
    tsin, tcos = TT.rope_table(tm.cfg, tpa.token_positions(tstart, 4))
    tkv = torch.from_numpy(kv.copy())
    tx = tm._layer_body(
        torch.from_numpy(x), TT.layer_params(tm.cfg, tm.params, 0), tkv,
        sin=tsin, cos=tcos, q_lens=torch.from_numpy(q_lens),
        start_pos=tstart, page_table=torch.from_numpy(table), fresh=fresh)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tkv.numpy()[1:], np.asarray(jkv)[1:],
                               atol=1e-6, rtol=1e-6)


def test_step_logits_match_jax_prefill_then_decode(models):
    """A fresh prefill and a ragged decode step over the KV cache the
    prefill wrote: fp32 logits within 1e-4 relative of JAX's."""
    jm, tm = models
    jkv = jnp.zeros((2, PAGES + 1, PAGE, 2, 2, 16), jnp.float32)
    tkv = torch.zeros((2, PAGES + 1, PAGE, 2, 2, 16))
    tokens, q_lens, start, table = _batch(fresh=True)
    dec = np.asarray([[7], [11], [3]], np.int32)
    for step, (tok, ql, sp, fresh) in enumerate([
            (tokens, q_lens, start, True),
            (dec, np.ones(3, np.int32), q_lens.copy(), False)]):
        jl, jkv = jm._step_impl(jm.params, jkv, jnp.asarray(tok),
                                jnp.asarray(ql), jnp.asarray(sp),
                                jnp.asarray(table), fresh=fresh)
        tl = tm._step_impl(tm.params, tkv, torch.from_numpy(tok),
                           torch.from_numpy(ql), torch.from_numpy(sp),
                           torch.from_numpy(table), fresh=fresh)
        scale = float(np.abs(np.asarray(jl)).max())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-4 * scale, rtol=1e-4)
        assert tl.dtype == torch.float32
    np.testing.assert_allclose(tkv.numpy()[:, 1:], np.asarray(jkv)[:, 1:],
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# traps
# ---------------------------------------------------------------------------

def test_rope_rotates_interleaved_pairs_in_fp32():
    cfg = _tcfg()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 7
    jsin, jcos = JT.rope_table(_jax_tree()[0], jnp.asarray(pos))
    ref = JT.apply_rope(jnp.asarray(x), jsin, jcos)
    tsin, tcos = TT.rope_table(cfg, torch.from_numpy(pos))
    out = TT.apply_rope(torch.from_numpy(x), tsin, tcos)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    # HF's half-split rotation gives a different answer
    xt = torch.from_numpy(x)
    c = torch.cat([tcos, tcos], -1)[:, :, None]
    s = torch.cat([tsin, tsin], -1)[:, :, None]
    half = xt * c + torch.cat([-xt[..., 8:], xt[..., :8]], -1) * s
    assert not torch.allclose(out, half, atol=1e-3)
    # bf16 input rotates in fp32 and casts back once
    outb = TT.apply_rope(xt.bfloat16(), tsin, tcos)
    assert outb.dtype == torch.bfloat16
    refb = JT.apply_rope(jnp.asarray(x, jnp.bfloat16), jsin, jcos)
    np.testing.assert_array_equal(outb.float().numpy(),
                                  np.asarray(refb.astype(jnp.float32)))


@pytest.mark.parametrize("activation", ["silu_gated", "gelu_gated"])
def test_mlp_wi_is_up_and_wg_is_gate(activation):
    rng = np.random.default_rng(3)
    p = {"wi": rng.standard_normal((16, 24)).astype(np.float32),
         "wg": rng.standard_normal((16, 24)).astype(np.float32),
         "wo": rng.standard_normal((24, 16)).astype(np.float32)}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    jcfg = JT.TransformerConfig(activation=activation, dtype=jnp.float32)
    tcfg = TT.TransformerConfig(activation=activation, dtype=torch.float32)
    ref = JT._mlp_block(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out = TT._mlp_block(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)
    swapped = TT._mlp_block(tcfg, dict(tp, wi=tp["wg"], wg=tp["wi"]),
                            torch.from_numpy(x))
    assert not torch.allclose(out, swapped, atol=1e-2)


def test_norm_computes_in_fp32_and_casts_back():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64)).astype(np.float32) * 4
    w = (rng.standard_normal(64) + 1).astype(np.float32)
    jcfg = JT.TransformerConfig(norm_eps=1e-5)
    ref = JT._norm_apply(jcfg, {"scale": jnp.asarray(w)},
                         jnp.asarray(x, jnp.bfloat16))
    out = TT._norm_apply(_tcfg(), {"scale": torch.from_numpy(w)},
                         torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
