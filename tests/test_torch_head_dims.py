"""Head dims 64, 80 and 96 (Falcon-7B, Phi-2, Phi-3-mini) held against
the JAX package on the CPU.

Debug-width models with ``head_dim`` set to 64, 80 and 96 (2 layers) in
four shapes: Llama (RMSNorm, SwiGLU, grouped KV), Falcon (one kv head,
the parallel block), Phi (partial rotary at 40% of the head, the
parallel block, biases) and a Llama with a sliding window.  The JAX
initialiser's tree, norms and biases replaced by seeded noise, crosses
through ``checkpoint/from_jax.py``.  The port's logits equal JAX's
within 1e-5 in fp32 on a fresh prefill, a decode step and a mixed ragged
step; both schedulers serve the same greedy tokens step by step in the
default serving configuration (the async chain, prefix caching) over fp
and int8 pages.  The plain attention functions at D = 80 and 96 equal
the JAX Pallas kernels (run in interpret mode, as the JAX suite runs
them on the CPU) within 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.models import transformer as TT
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import paged_attention as tpa

# the module, which deepspeed_tpu.ops shadows with its function
jfa = importlib.import_module("deepspeed_tpu.ops.flash_attention")

TOL = 1e-5
PAGE, PAGES = 8, 32

_BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, max_seq_len=256, norm_eps=1e-5)
SHAPES = {
    "llama": dict(num_heads=4, num_kv_heads=2, norm="rmsnorm",
                  activation="silu_gated", pos_emb="rope"),
    "falcon": dict(num_heads=4, num_kv_heads=1, norm="layernorm",
                   activation="gelu_exact", pos_emb="rope",
                   parallel_residual=True),
    "phi": dict(num_heads=2, num_kv_heads=2, norm="layernorm",
                activation="gelu", pos_emb="rope", rope_pct=0.4,
                parallel_residual=True, use_bias=True),
    "window": dict(num_heads=4, num_kv_heads=2, norm="rmsnorm",
                   activation="silu_gated", pos_emb="rope",
                   sliding_window=11),
}
HEAD_DIMS = (64, 80, 96)
CASES = [(s, d) for s in sorted(SHAPES) for d in HEAD_DIMS]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _configs(shape, d):
    fields = dict(_BASE, head_dim=d, **SHAPES[shape])
    return (JT.TransformerConfig(dtype=jnp.float32, **fields),
            TT.TransformerConfig(dtype=torch.float32, **fields))


def _tree(jcfg, seed=0):
    """The JAX initialiser's tree as numpy, norm scales ~1 + 0.2 N and
    biases 0.1 N so that they count."""
    tree = jax.tree.map(np.array, meta.unbox(
        JT.init_params(jcfg, jax.random.key(seed))))
    rng = np.random.default_rng(seed)

    def visit(node):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                visit(leaf)
            elif key == "scale":
                node[key] = (1 + 0.2 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
            elif key.startswith("b"):
                node[key] = (0.1 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
    visit(tree)
    return tree


def _kv(cfg, quant="none"):
    return dict(num_layers=2, kv_heads=cfg.kv_heads,
                head_dim=cfg.dims_per_head, page_size=PAGE,
                num_pages=PAGES, quantization=quant)


def _models(shape, d, quant="none"):
    jcfg, tcfg = _configs(shape, d)
    tree = _tree(jcfg)
    jm = J.RaggedInferenceModel(
        jcfg, jax.tree.map(jnp.asarray, tree),
        kv_config=J.KVCacheConfig(dtype=jnp.float32, **_kv(jcfg, quant)))
    tm = T.RaggedInferenceModel(
        tcfg, from_jax(tree, tcfg, device="cpu"), device="cpu",
        kv_config=T.KVCacheConfig(dtype=torch.float32, **_kv(tcfg, quant)))
    return jm, tm


def _table(hist, q):
    table = np.zeros((len(hist), 8), np.int32)
    nxt = 1
    for s, h in enumerate(hist):
        n = -(-(h + q) // PAGE)
        table[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return table


def _steps():
    """(tokens, q_lens, start_pos, fresh, table): a fresh prefill of 16
    tokens (past the window of 11), a decode step, and a mixed ragged
    step (a decode-like row, a chunk, a padding slot) over the pages the
    earlier steps wrote."""
    rng = np.random.default_rng(3)
    table = _table((0, 0, 0), 40)
    q1 = np.array([16, 5, 13], np.int32)
    yield (rng.integers(0, 128, (3, 16)).astype(np.int32), q1,
           np.zeros(3, np.int32), True, table)
    yield (rng.integers(0, 128, (3, 1)).astype(np.int32),
           np.ones(3, np.int32), q1.copy(), False, table)
    q3 = np.array([1, 16, 0], np.int32)
    yield (rng.integers(0, 128, (3, 16)).astype(np.int32), q3, q1 + 1, False,
           table)


@pytest.mark.parametrize("shape,d", CASES)
def test_logits_match_jax_at_the_new_head_dims(shape, d):
    jm, tm = _models(shape, d)
    K = jm.cfg.kv_heads
    jkv = jnp.zeros((2, PAGES + 1, PAGE, 2, K, d), jnp.float32)
    tkv = torch.zeros((2, PAGES + 1, PAGE, 2, K, d))
    for tok, ql, sp, fresh, table in _steps():
        jl, jkv = jm._step_impl(jm.params, jkv, jnp.asarray(tok),
                                jnp.asarray(ql), jnp.asarray(sp),
                                jnp.asarray(table), fresh=fresh)
        tl = tm._step_impl(tm.params, tkv, torch.from_numpy(tok),
                           torch.from_numpy(ql), torch.from_numpy(sp),
                           torch.from_numpy(table), fresh=fresh)
        live = ql > 0
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tkv.numpy()[:, 1:], np.asarray(jkv)[:, 1:],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("shape,d", [("falcon", 64), ("phi", 80),
                                     ("window", 96), ("llama", 80)])
def test_greedy_tokens_match_jax_step_by_step(shape, d, quant, monkeypatch):
    """ServingOptimizationConfig() defaults on both sides (async chain,
    prefix caching) over fp or int8 pages: the same {uid: token} at every
    step and the same prefix hits (a 20-token prefix: two full pages of 8
    shared), the page audit after every step."""
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    jm, tm = _models(shape, d, quant)
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=48)
    jeng = J.InferenceEngineV2(jm, J.RaggedInferenceEngineConfig(
        state_manager=J.StateManagerConfig(**sm),
        serving=J.ServingOptimizationConfig(kv_quantization=quant)))
    teng = T.InferenceEngineV2(tm, T.RaggedInferenceEngineConfig(
        state_manager=T.StateManagerConfig(**sm),
        serving=T.ServingOptimizationConfig(kv_quantization=quant)))
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 128, 20)
    prompts = [np.concatenate([shared, rng.integers(0, 128, 5)]),
               rng.integers(0, 128, 30),
               np.concatenate([shared, rng.integers(0, 128, 9)]),
               rng.integers(0, 128, 12)]
    new = [9, 6, 10, 7]
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))
    hits = {"jax": {}, "port": {}}
    for name, eng in (("jax", jeng), ("port", teng)):
        def recorded(uid, prompt, _m=eng.match_prefix, _h=hits[name]):
            _h[uid] = _m(uid, prompt)
            return _h[uid]
        eng.match_prefix = recorded
    tokens = {}
    while jsched.has_work or tsched.has_work:
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}
        for u, t in tout.items():
            tokens.setdefault(u, []).append(t)
    assert hits["port"] == hits["jax"]
    assert hits["port"][2] == 16
    assert all(len(tokens[u]) == n for u, n in enumerate(new))
    assert isinstance(teng.state_manager.kv_cache.data,
                      tpa.KVPages) == (quant == "int8")
    teng.state_manager.check_invariants()
    assert teng.free_blocks == PAGES


# ---------------------------------------------------------------------------
# the plain attention functions against the JAX kernels
# ---------------------------------------------------------------------------

def _paged_inputs(d, S=3, Q=4, K=2, G=3, hist=(5, 0, 19), seed=0):
    """Numpy q [S, Q, H, D], a cache with each slot's history and its new
    rows written, page table and start positions."""
    rng = np.random.default_rng(seed)
    kv = np.zeros((PAGES + 1, PAGE, 2, K, d), np.float32)
    table = np.zeros((S, 8), np.int32)
    nxt = 1
    for s, h in enumerate(hist):
        n = -(-(h + Q) // PAGE)
        table[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
        for t in range(h + Q):
            kv[table[s, t // PAGE], t % PAGE] = rng.standard_normal((2, K, d))
    q = rng.standard_normal((S, Q, K * G, d)).astype(np.float32)
    return q, kv, table, np.asarray(hist, np.int32)


@pytest.mark.parametrize("variant", ["plain", "window", "alibi", "int8"])
@pytest.mark.parametrize("d", [80, 96])
def test_plain_paged_attention_matches_the_jax_kernel(d, variant):
    q, kv, table, start = _paged_inputs(d)
    kw = {}
    if variant == "window":
        kw["window"] = 6
    if variant == "alibi":
        kw["alibi_slopes"] = TT.alibi_slopes(q.shape[2])
    jkv, tkv = jnp.asarray(kv), torch.from_numpy(kv)
    if variant == "int8":
        codes, scale = tpa.quantize_kv_blocks(tkv)
        tkv = tpa.KVPages(codes, scale)
        jkv = jpa.KVPages(jnp.asarray(codes.numpy()),
                          jnp.asarray(scale.numpy()))
    ref = jpa.paged_decode_attention(
        jnp.asarray(q), jkv, jnp.asarray(table), jnp.asarray(start),
        interpret=True, **{k: (jnp.asarray(v) if k == "alibi_slopes" else v)
                           for k, v in kw.items()})
    out = tpa.paged_attention(torch.from_numpy(q), tkv,
                              torch.from_numpy(table),
                              torch.from_numpy(start), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("d", [80, 96])
def test_plain_flash_matches_the_jax_kernel(d, window):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 3, 128, d)).astype(np.float32)
               for _ in range(3))
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              block_q=64, block_k=64, interpret=True,
                              window=window)
    jref = jfa.mha_reference(*map(jnp.asarray, (q, k, v)), causal=True,
                             window=window)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = tfa.mha_reference(tq, tk, tv, causal=True, window=window)
    flash, _ = tfa.flash_fwd(tq, tk, tv, causal=True, window=window)
    for got in (out, flash):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=TOL,
                                   rtol=TOL)
