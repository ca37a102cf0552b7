"""LayerNorm model families and int8-page serving held against JAX.

Each family's configuration at debug width runs through the JAX
``RaggedInferenceModel`` and the port's, in fp32 on the CPU, with the
same weights: the JAX initialiser's tree, with every bias and norm leaf
(zeros and ones at init) replaced by seeded numpy noise so that they
count, bridged through ``checkpoint/from_jax.py``.  Logits must agree to
1e-4 of the largest logit (fp32 matmuls summed in another order across
two layers and the lm head) on a fresh prefill, a decode step and a mixed
ragged step over history.  The serving path as a whole: the port's
``FastGenScheduler`` serves debug OPT with the JAX scheduler's greedy
tokens, over fp pages and over int8 pages.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.checkpoint import hf as jhf
from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import model_implementations as jimpl
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.gpt import GPTForCausalLM as JGPT
from deepspeed_tpu.models.gpt import gpt_config as jgpt_config
from deepspeed_tpu_torch.checkpoint import hf as thf
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import model_implementations as timpl
from deepspeed_tpu_torch.models import transformer as TT
from deepspeed_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
from deepspeed_tpu_torch.ops.paged_attention import KVPages

PAGE, PAGES = 8, 24
LOGIT_TOL = 1e-4

_DEBUG = dict(vocab_size=128, hidden_size=64, intermediate_size=256,
              num_layers=2, num_heads=4, max_seq_len=256, norm="layernorm",
              norm_eps=1e-5)
# family -> the fields its published configs set (checkpoint/hf.py)
FAMILIES = {
    "gpt2": dict(activation="gelu", pos_emb="learned", tie_embeddings=True,
                 use_bias=True),
    "opt": dict(activation="relu", pos_emb="learned", tie_embeddings=True,
                use_bias=True),
    "bloom": dict(activation="gelu", pos_emb="alibi", embed_layernorm=True,
                  tie_embeddings=True, use_bias=True),
    "gpt_neox": dict(activation="gelu_exact", pos_emb="rope", rope_pct=0.25,
                     parallel_residual=True, use_bias=True),
    "phi": dict(activation="gelu", pos_emb="rope", rope_pct=0.4,
                parallel_residual=True, use_bias=True),
    "falcon": dict(activation="gelu_exact", pos_emb="rope",
                   parallel_residual=True, num_kv_heads=1,
                   tie_embeddings=True),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _configs(family):
    fields = dict(_DEBUG, **FAMILIES[family])
    return (JT.TransformerConfig(dtype=jnp.float32, **fields),
            TT.TransformerConfig(dtype=torch.float32, **fields))


def _noisy_tree(jcfg, family, seed=0):
    """The JAX initialiser's tree as numpy, biases and norm leaves
    replaced by noise (scale ~1, bias ~0.1), plus the phi family's
    ``lm_head_bias``."""
    tree = jax.tree.map(np.array, meta.unbox(
        JT.init_params(jcfg, jax.random.key(seed))))
    rng = np.random.default_rng(seed)

    def visit(node, path):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                visit(leaf, path + (key,))
            elif key == "scale":
                node[key] = (1 + 0.2 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
            elif key.startswith("b"):
                node[key] = (0.1 * rng.standard_normal(leaf.shape)
                             ).astype(np.float32)
    visit(tree, ())
    if family == "phi":
        tree["lm_head_bias"] = (0.1 * rng.standard_normal(jcfg.vocab_size)
                                ).astype(np.float32)
    return tree


def _models(family, quant="none"):
    jcfg, tcfg = _configs(family)
    tree = _noisy_tree(jcfg, family)
    kv = dict(num_layers=2, kv_heads=jcfg.kv_heads, head_dim=16,
              page_size=PAGE, num_pages=PAGES, quantization=quant)
    jm = J.RaggedInferenceModel(
        jcfg, jax.tree.map(jnp.asarray, tree),
        kv_config=J.KVCacheConfig(dtype=jnp.float32, **kv))
    tm = T.RaggedInferenceModel(
        tcfg, from_jax(tree, tcfg, device="cpu"), device="cpu",
        kv_config=T.KVCacheConfig(dtype=torch.float32, **kv))
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
    """(tokens, q_lens, start_pos, fresh) of a fresh prefill, a decode
    step and a mixed ragged step (a decode-like row, a chunk, a padding
    slot) over the pages the earlier steps wrote."""
    rng = np.random.default_rng(3)
    table = _table((0, 0, 0), 24)
    q1 = np.array([8, 5, 7], np.int32)
    yield (rng.integers(0, 128, (3, 8)).astype(np.int32), q1,
           np.zeros(3, np.int32), True, table)
    yield (rng.integers(0, 128, (3, 1)).astype(np.int32),
           np.ones(3, np.int32), q1.copy(), False, table)
    q3 = np.array([1, 8, 0], np.int32)
    yield (rng.integers(0, 128, (3, 8)).astype(np.int32), q3, q1 + 1, False,
           table)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_logits_match_jax(family):
    jm, tm = _models(family)
    heads = jm.cfg.kv_heads
    jkv = jnp.zeros((2, PAGES + 1, PAGE, 2, heads, 16), jnp.float32)
    tkv = torch.zeros((2, PAGES + 1, PAGE, 2, heads, 16))
    assert tm.implementations["norm"] == "plain"
    if family == "bloom":       # ALiBi prefill stays on the paged path
        assert tm.implementations["fresh_prefill_attention"] is None
    for tok, ql, sp, fresh, table in _steps():
        jl, jkv = jm._step_impl(jm.params, jkv, jnp.asarray(tok),
                                jnp.asarray(ql), jnp.asarray(sp),
                                jnp.asarray(table), fresh=fresh)
        tl = tm._step_impl(tm.params, tkv, torch.from_numpy(tok),
                           torch.from_numpy(ql), torch.from_numpy(sp),
                           torch.from_numpy(table), fresh=fresh)
        live = ql > 0
        ref = np.asarray(jl)[live]
        scale = float(np.abs(ref).max())
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy()[live], ref,
                                   atol=LOGIT_TOL * scale, rtol=LOGIT_TOL)
    np.testing.assert_allclose(tkv.numpy()[:, 1:], np.asarray(jkv)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_learned_positions_clamp_at_the_table_end():
    """Positions past ``max_seq_len - 1`` read the last row, as the JAX
    step's ``jnp.minimum`` does."""
    jcfg, tcfg = _configs("opt")
    jcfg = dataclasses.replace(jcfg, max_seq_len=12)
    tcfg = dataclasses.replace(tcfg, max_seq_len=12)
    tree = _noisy_tree(jcfg, "opt")
    kv = dict(num_layers=2, kv_heads=4, head_dim=16, page_size=PAGE,
              num_pages=PAGES)
    jm = J.RaggedInferenceModel(
        jcfg, jax.tree.map(jnp.asarray, tree),
        kv_config=J.KVCacheConfig(dtype=jnp.float32, **kv))
    tm = T.RaggedInferenceModel(
        tcfg, from_jax(tree, tcfg, device="cpu"), device="cpu",
        kv_config=T.KVCacheConfig(dtype=torch.float32, **kv))
    tok = np.arange(16, dtype=np.int32)[None]
    ql, sp = np.array([16], np.int32), np.array([0], np.int32)
    table = _table((0,), 16)
    jl, _ = jm._step_impl(jm.params,
                          jnp.zeros((2, PAGES + 1, PAGE, 2, 4, 16)),
                          jnp.asarray(tok), jnp.asarray(ql), jnp.asarray(sp),
                          jnp.asarray(table), fresh=True)
    tl = tm._step_impl(tm.params, torch.zeros((2, PAGES + 1, PAGE, 2, 4, 16)),
                       torch.from_numpy(tok), torch.from_numpy(ql),
                       torch.from_numpy(sp), torch.from_numpy(table),
                       fresh=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# configs, the bridge and the family classes
# ---------------------------------------------------------------------------

def _same_fields(tcfg, jcfg):
    for f in dataclasses.fields(tcfg):
        if f.name == "dtype":
            assert str(tcfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


# facebook/opt-6.7b config.json
OPT_6_7B = dict(vocab_size=50272, hidden_size=4096, ffn_dim=16384,
                num_hidden_layers=32, num_attention_heads=32,
                max_position_embeddings=2048, activation_function="relu",
                do_layer_norm_before=True, word_embed_proj_dim=4096)


def test_opt_config_from_hf_equals_jax_field_by_field():
    hf_cfg = types.SimpleNamespace(**OPT_6_7B)
    tcfg = thf.opt_config_from_hf(hf_cfg)
    _same_fields(tcfg, jhf.opt_config_from_hf(hf_cfg))
    assert (tcfg.norm, tcfg.pos_emb, tcfg.activation) == (
        "layernorm", "learned", "relu")
    assert tcfg.tie_embeddings and tcfg.use_bias
    assert tcfg.dims_per_head == 128 and tcfg.kv_heads == 32
    assert 6.6e9 < tcfg.n_params() < 6.7e9
    for bad in (dict(word_embed_proj_dim=512), dict(do_layer_norm_before=False),
                dict(activation_function="swish")):
        with pytest.raises(ValueError):
            thf.opt_config_from_hf(types.SimpleNamespace(**{**OPT_6_7B,
                                                            **bad}))


@pytest.mark.parametrize("size", ["125m", "350m", "1.3b", "2.7b", "debug"])
def test_gpt_presets_equal_jax(size):
    _same_fields(gpt_config(size), jgpt_config(size))
    _same_fields(gpt_config(size, max_seq_len=77, dtype=torch.float32),
                 jgpt_config(size, max_seq_len=77, dtype=jnp.float32))
    assert GPTForCausalLM(size).cfg == gpt_config(size)
    cfg = gpt_config(size)                 # the port counts the positions
    assert cfg.n_params() == (JGPT(size).cfg.n_params()
                              + cfg.max_seq_len * cfg.hidden_size)


def test_init_params_has_the_jax_tree_for_every_family():
    """The port's seeded initialiser builds the leaves, shapes and norm
    dtypes of JAX's (the draws differ), and the bridge takes both."""
    for family in FAMILIES:
        jcfg, tcfg = _configs(family)
        jtree = jax.tree.map(np.asarray, meta.unbox(
            JT.init_params(jcfg, jax.random.key(0))))
        ttree = TT.init_params(tcfg, 0, device="cpu")
        jflat = {jax.tree_util.keystr(k): v.shape for k, v in
                 jax.tree_util.tree_flatten_with_path(jtree)[0]}
        tflat = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                 jax.tree_util.tree_flatten_with_path(ttree)[0]}
        assert tflat == jflat, family
        assert ttree["final_norm"]["bias"].dtype == torch.float32
        from_jax(jtree, tcfg, device="cpu")
    gpt = gpt_config("debug", dtype=torch.float32)
    params = GPTForCausalLM("debug", dtype=torch.float32).init_params(
        0, device="cpu")
    assert params["embed"]["positions"].shape == (64, 64)
    with pytest.raises(NotImplementedError, match="item 10"):
        TT.forward(gpt, params, torch.zeros((1, 4), dtype=torch.int64))


def test_bridge_checks_every_leaf_the_config_calls_for():
    jcfg, tcfg = _configs("bloom")
    tree = _noisy_tree(jcfg, "bloom")
    t = from_jax(tree, tcfg, device="cpu", dtype=torch.bfloat16)
    assert t["embed"]["norm"]["scale"].dtype == torch.float32
    assert t["embed"]["norm"]["bias"].dtype == torch.float32
    assert t["layers"]["attn"]["bq"].dtype == torch.float32
    assert t["embed"]["tokens"].dtype == torch.bfloat16
    for drop in (("embed", "norm"), ("layers", "attn", "bo"),
                 ("layers", "norm1", "bias"), ("final_norm", "bias")):
        broken = jax.tree.map(lambda a: a, tree)
        node = broken
        for key in drop[:-1]:
            node = node[key]
        del node[drop[-1]]
        with pytest.raises(KeyError):
            from_jax(broken, tcfg, device="cpu")
    jcfg, tcfg = _configs("phi")
    tree = _noisy_tree(jcfg, "phi")
    assert from_jax(tree, tcfg, device="cpu", dtype=torch.bfloat16)[
        "lm_head_bias"].dtype == torch.float32
    tree["lm_head_bias"] = tree["lm_head_bias"][:-1]
    with pytest.raises(ValueError):
        from_jax(tree, tcfg, device="cpu")
    jcfg, tcfg = _configs("opt")
    tree = _noisy_tree(jcfg, "opt")
    tree["embed"]["positions"] = tree["embed"]["positions"][:10]
    with pytest.raises(ValueError):
        from_jax(tree, tcfg, device="cpu")


def test_model_implementations_mirror_jax():
    assert timpl.supported_model_types() == jimpl.supported_model_types()
    for mt in list(jimpl.supported_model_types()) + ["OPT", "unknown-arch"]:
        assert timpl.implementation_for(mt).__name__ == \
            jimpl.implementation_for(mt).__name__
    assert T.implementation_for("opt") is timpl.OPTInferenceModel
    _, opt = _configs("opt")
    _, bloom = _configs("bloom")
    llama = TT.TransformerConfig(vocab_size=128, hidden_size=64,
                                 intermediate_size=176, num_layers=2,
                                 num_heads=4, dtype=torch.float32)
    params = {c: TT.init_params(c, 0, device="cpu")
              for c in (opt, bloom, llama)}
    ok = [(timpl.OPTInferenceModel, opt), (timpl.BloomInferenceModel, bloom),
          (timpl.LlamaV2InferenceModel, llama),
          (timpl.MistralInferenceModel, llama),
          (timpl.GPT2InferenceModel, opt)]
    for cls, cfg in ok:
        assert cls(cfg, params[cfg], device="cpu").cfg is cfg
    bad = [(timpl.OPTInferenceModel, llama), (timpl.BloomInferenceModel, opt),
           (timpl.LlamaV2InferenceModel, opt),
           (timpl.LlamaV2InferenceModel,
            dataclasses.replace(llama, activation="gelu")),
           (timpl.Qwen2InferenceModel, llama),
           (timpl.MixtralInferenceModel, llama)]
    for cls, cfg in bad:
        with pytest.raises(AssertionError):
            cls(cfg, params.get(cfg, params[llama]), device="cpu")
    assert timpl.Qwen2InferenceModel(
        dataclasses.replace(llama, qkv_bias=True),
        TT.init_params(dataclasses.replace(llama, qkv_bias=True), 0,
                       device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# the serving knob and the engine
# ---------------------------------------------------------------------------

def test_serving_config_fixes_the_reduced_flags():
    sv = T.ServingOptimizationConfig(kv_quantization="int8")
    assert (sv.fused_step, sv.on_device_sampling, sv.async_scheduling,
            sv.prefix_caching, sv.speculative, sv.tp_degree,
            sv.keyed_sampling) == (True, True, False, False, False, 1, False)
    for flag, value, item in [("fused_step", False, "item 4"),
                              ("on_device_sampling", False, "item 4"),
                              ("async_scheduling", True, "item 7"),
                              ("prefix_caching", True, "item 6"),
                              ("speculative", True, "item 8"),
                              ("tp_degree", 2, "item 13"),
                              ("keyed_sampling", True, "item 3")]:
        with pytest.raises(NotImplementedError, match=item):
            T.ServingOptimizationConfig(**{flag: value})
    # set after construction: the engine's build still refuses it
    sv.prefix_caching = True
    _, tm = _models("opt")
    with pytest.raises(NotImplementedError, match="item 6"):
        T.InferenceEngineV2(tm, T.RaggedInferenceEngineConfig(serving=sv))


def _engine_config(quant, **kw):
    return T.RaggedInferenceEngineConfig(
        state_manager=T.StateManagerConfig(
            max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=64),
        serving=T.ServingOptimizationConfig(kv_quantization=quant), **kw)


def test_engine_knob_wins_over_the_models_cache_encoding():
    # explicit kv_config: geometry kept, encoding replaced, both ways
    _, tm = _models("opt")
    eng = T.InferenceEngineV2(tm, _engine_config("int8"))
    assert tm.kv_config.quantization == "int8"
    assert (tm.kv_config.page_size, tm.kv_config.num_pages) == (PAGE, PAGES)
    data = eng.state_manager.kv_cache.data
    assert isinstance(data, KVPages)
    assert data.shape == (2, PAGES + 1, PAGE, 2, 4, 16)
    _, tm = _models("opt", quant="int8")
    eng = T.InferenceEngineV2(tm, _engine_config("none"))
    assert tm.kv_config.quantization == "none"
    assert isinstance(eng.state_manager.kv_cache.data, torch.Tensor)
    # no kv_config on the model: its default geometry and dtype stay,
    # and the knob still sets the encoding
    _, tcfg = _configs("opt")
    for quant in ("none", "int8"):
        tm = T.RaggedInferenceModel(
            tcfg, TT.init_params(tcfg, 0, device="cpu"), device="cpu")
        default = tm.kv_config
        assert default.dtype == tcfg.dtype == torch.float32
        eng = T.InferenceEngineV2(tm, _engine_config(quant))
        assert tm.kv_config == dataclasses.replace(default,
                                                   quantization=quant)
        data = eng.state_manager.kv_cache.data
        if quant == "int8":
            assert data.scale.shape == (2, default.num_pages + 1,
                                        default.page_size, 2, 4)
        else:
            assert data.dtype == torch.float32
        assert eng.free_blocks == default.num_pages
        logits = eng.put([0], [[1, 2, 3]])
        assert logits.shape == (1, 128)
        assert bool(torch.isfinite(logits).all())


def test_unknown_kv_quantization_raises_at_engine_build():
    _, tm = _models("opt")
    with pytest.raises(ValueError, match="int4"):
        T.InferenceEngineV2(tm, _engine_config("int4"))


def test_scheduler_refuses_a_serving_config_the_cache_was_not_built_for():
    _, tm = _models("opt")
    eng = T.InferenceEngineV2(tm, _engine_config("int8"))
    assert T.FastGenScheduler(eng, serving=eng._config.serving)
    assert T.FastGenScheduler(eng)
    with pytest.raises(ValueError, match="fixed at engine build"):
        T.FastGenScheduler(eng, serving=T.ServingOptimizationConfig())
    sv = T.ServingOptimizationConfig(kv_quantization="int8")
    sv.speculative = True
    with pytest.raises(NotImplementedError, match="item 8"):
        T.FastGenScheduler(eng, serving=sv)


# ---------------------------------------------------------------------------
# the serving path as a whole: debug OPT through both schedulers
# ---------------------------------------------------------------------------

SERVE_PAGE, SERVE_PAGES, BUDGET = 16, 96, 64
PROMPT_LENS = [3, 61, 30, 150, 20, 9]
NEW_TOKENS = [8, 24, 12, 16, 10, 20]


def _serve_both(quant):
    jcfg, tcfg = _configs("opt")
    tree = _noisy_tree(jcfg, "opt")
    kv = dict(num_layers=2, kv_heads=4, head_dim=16, page_size=SERVE_PAGE,
              num_pages=SERVE_PAGES)
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=BUDGET)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(
            jcfg, jax.tree.map(jnp.asarray, tree),
            kv_config=J.KVCacheConfig(dtype=jnp.float32, **kv)),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            serving=J.ServingOptimizationConfig(
                fused_step=True, on_device_sampling=True,
                async_scheduling=False, prefix_caching=False,
                kv_quantization=quant)))
    teng = T.InferenceEngineV2(
        timpl.OPTInferenceModel(
            tcfg, from_jax(tree, tcfg, device="cpu"), device="cpu",
            kv_config=T.KVCacheConfig(dtype=torch.float32, **kv)),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(kv_quantization=quant)))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, n) for n in PROMPT_LENS]
    jsched = J.FastGenScheduler(jeng, serving=jeng._config.serving)
    tsched = T.FastGenScheduler(teng, serving=teng._config.serving)
    shapes = []
    step_impl = teng.model._step_impl

    def record(params, kv_, tok, *a, fresh=False):
        shapes.append((tuple(tok.shape), fresh))
        return step_impl(params, kv_, tok, *a, fresh=fresh)

    teng.model._step_impl = record
    for uid, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))
    ref = {u: list(map(int, t)) for u, t in jsched.run_to_completion().items()}
    out = tsched.run_to_completion()
    teng.state_manager.check_invariants()
    assert teng.free_blocks == SERVE_PAGES
    return ref, out, shapes, teng


def test_opt_greedy_tokens_identical_to_jax_on_fp_pages():
    ref, out, shapes, _ = _serve_both("none")
    assert out == ref
    assert all(len(out[u]) == n for u, n in enumerate(NEW_TOKENS))
    assert shapes[0] == ((2, 64), True)          # the fresh prefill step


def test_opt_greedy_tokens_identical_to_jax_on_int8_pages():
    """Both schedulers make the same admission decisions, so the dispatch
    shapes are equal step for step and the JAX contract (equal shapes =>
    equal tokens, tests/test_kv_tiers.py:341-352) carries across the two
    packages: the codes written are bit-equal, so the tokens are too."""
    ref, out, shapes, teng = _serve_both("int8")
    assert isinstance(teng.state_manager.kv_cache.data, KVPages)
    assert out == ref
    fp_ref, _, fp_shapes, _ = _serve_both("none")
    assert shapes == fp_shapes                   # the knob changes no shape
    agree = np.mean([a == b for u in ref for a, b in zip(ref[u], fp_ref[u])])
    assert agree >= 0.75                         # the JAX suite's own floor


# ---------------------------------------------------------------------------
# chip_smoke.py's full-width serving limits over int8 pages, on a CPU
# stand-in
# ---------------------------------------------------------------------------

# chip_smoke.py holds the kernel path against the plain path, both over
# int8 pages, teacher-forced: max |logit difference| over the largest
# |logit| of each segment <= 3e-2, and greedy agreement >= 0.75
LOGIT_REL_TOL = 3e-2
GREEDY_AGREE_MIN = 0.75


def _bf16_opt(layers, seed=0):
    cfg = TT.TransformerConfig(
        vocab_size=512, hidden_size=128, intermediate_size=512,
        num_layers=layers, num_heads=4, max_seq_len=2048, norm="layernorm",
        activation="relu", pos_emb="learned", tie_embeddings=True,
        use_bias=True, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(seed + 1)
    params = TT.init_params(cfg, seed, device="cpu")
    for norm in (params["layers"]["norm1"], params["layers"]["norm2"],
                 params["final_norm"]):
        norm["scale"] = 1 + 0.2 * torch.randn(norm["scale"].shape,
                                              generator=g)
        norm["bias"] = 0.1 * torch.randn(norm["bias"].shape, generator=g)
    return cfg, params


def _tile_softmax_v(scores, v, v_scale=None):
    """The tensor-core tile's softmax and P . V: unnormalised p =
    exp(s - max) rounded to bf16 (times ``v_scale`` of each key first: the
    int8 fold) against V, divided by the fp32 sum of the unrounded p.
    scores [..., Q, C] fp32, masked; v [..., C, D]; v_scale [..., C]."""
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    pv = p if v_scale is None else p * v_scale[..., None, :]
    return (pv.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)


def _kernel_numerics(roll_scales=False):
    """The int8 paged kernel's arithmetic as the model's attention, on
    both of its paths.  K is float(code) * scale rounded to bf16 on both.
    Fewer than 16 folded rows (decode) take the split-KV path: V, scores
    and probabilities stay fp32.  More (prefill chunks) take the tile:
    bf16(p * v_scale) against V's codes.  (The plain version rounds V and
    the normalised probabilities to bf16.)  ``roll_scales`` is the fault:
    each kv head reads its neighbour's scales."""
    from deepspeed_tpu_torch.ops import paged_attention as tpa

    def attn(q, kv_layer, page_table, start_pos, q_lens):
        scale = (torch.roll(kv_layer.scale, 1, dims=-1) if roll_scales
                 else kv_layer.scale)
        S, Q, H, D = q.shape
        K = kv_layer.shape[3]
        if Q * (H // K) < tpa.DECODE_ROWS:
            pages = tpa.dequantize_kv_blocks(kv_layer.payload, scale)
            pages[:, :, 0] = pages[:, :, 0].bfloat16().float()
            return tpa.paged_attention(q.float(), pages, page_table,
                                       start_pos).to(q.dtype)
        table = page_table.long()
        codes, sc = kv_layer.payload[table].float(), scale[table]
        C = codes.shape[1] * codes.shape[2]
        # [S, K, C, D] keys and V codes, [S, K, C] V scales
        k_ctx = (codes[..., 0, :, :] * sc[..., 0, :, None]).bfloat16()
        k_ctx = k_ctx.float().reshape(S, C, K, D).transpose(1, 2)
        v_codes = codes[..., 1, :, :].reshape(S, C, K, D).transpose(1, 2)
        v_scale = sc[..., 1, :].reshape(S, C, K).transpose(1, 2)
        qg = q.float().reshape(S, Q, K, H // K, D).permute(0, 2, 3, 1, 4)
        scores = qg @ k_ctx[:, :, None].transpose(-1, -2) / np.sqrt(D)
        pos = tpa.token_positions(start_pos, Q)
        mask = torch.arange(C)[None, None, :] <= pos[:, :, None]
        scores = torch.where(mask[:, None, None], scores, tpa.MASK_VALUE)
        out = _tile_softmax_v(scores, v_codes[:, :, None],
                              v_scale[:, :, None])
        return out.permute(0, 3, 1, 2, 4).reshape(S, Q, H, D).to(q.dtype)
    return attn


def _tile_fresh(q, k, v):
    """The flash forward kernel's arithmetic on the fresh prefill: causal
    attention over [B, S, H, D] through the tile's softmax and P . V."""
    dtype = q.dtype
    q, k, v = (x.transpose(1, 2).float() for x in (q, k, v))
    Sq = q.shape[2]
    scores = q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1])
    causal = torch.ones(Sq, Sq, dtype=torch.bool).tril()
    scores = torch.where(causal, scores, -1e30)
    return _tile_softmax_v(scores, v).transpose(1, 2).to(dtype)


def _teacher_forced_segments(cfg, params, variants):
    """Every variant's logits per segment over ten steps (fresh prefill,
    decode, two mixed steps, one with a chunk over history), all fed the
    first variant's tokens."""
    engines, segments = {}, {}
    for name, (quant, attn) in variants.items():
        kv = T.KVCacheConfig(num_layers=cfg.num_layers, kv_heads=4,
                             head_dim=32, page_size=16, num_pages=64)
        eng = T.InferenceEngineV2(
            T.RaggedInferenceModel(cfg, params, kv_config=kv, device="cpu"),
            T.RaggedInferenceEngineConfig(
                state_manager=T.StateManagerConfig(
                    max_tracked_sequences=8, max_ragged_sequence_count=8,
                    max_ragged_batch_size=512),
                serving=T.ServingOptimizationConfig(kv_quantization=quant)))
        if attn is not None:
            eng.model._attention, eng.model._fresh_attention = \
                attn, _tile_fresh
        out = segments[name] = []

        def capture(*a, _step=eng.model._step_impl, _out=out, **k):
            logits = _step(*a, **k)
            _out.append(logits[a[3] > 0])
            return logits
        eng.model._step_impl = capture
        engines[name] = eng
    rng = np.random.default_rng(1)
    p0, p1, p2 = (rng.integers(0, cfg.vocab_size, n) for n in (170, 75, 500))
    schedule = ([([0, 1], [p0, p1])] + [([0, 1], [None, None])] * 2
                + [([0, 1, 2], [None, None, p2[:256]]),
                   ([0, 1, 2], [None, None, p2[256:]])]
                + [([0, 1, 2], [None] * 3)] * 5)
    gens = {name: torch.Generator().manual_seed(0) for name in engines}
    last = {}
    for uids, inputs in schedule:
        feed = [np.array([last[u]], np.int32) if x is None else x
                for u, x in zip(uids, inputs)]
        sp = [T.SamplingParams()] * len(uids)
        for i, (name, eng) in enumerate(engines.items()):
            toks, rows = eng.step_sample(uids, feed, sp, gens[name])
            if i == 0:
                toks = toks.tolist()
                forced = {u: toks[r] for u, r in zip(uids, rows)}
        last = forced
    return segments


def _segment_errors(segs, ref):
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(segs, ref))
    agree = sum(int((a.argmax(-1) == b.argmax(-1)).sum())
                for a, b in zip(segs, ref))
    return worst, agree / sum(b.shape[0] for b in ref)


@pytest.mark.parametrize("layers", [2, 8])
def test_int8_serving_limits_pass_rounding_and_fail_a_wrong_scale(layers):
    """A bf16 OPT at E = 128 over int8 pages.  The plain path against the
    kernels' arithmetic (the split-KV path on decode segments, the
    tensor-core tile on prefill chunks and the fresh prefill) differs by
    rounding (and by the codes that rounding flips at append): 1.09e-2 of
    the largest logit at 2 layers, 1.12e-2 at 8, inside the 3e-2 limit.
    Scales read from the neighbouring kv head move the logits by 0.37 to
    0.51 and fail it.  One
    key past the causal limit does not show reliably at this level
    (random weights attend almost evenly over hundreds of keys); the
    per-kernel limits of test_torch_kernels.py catch that.  Greedy picks
    over int8 pages agree with those over bf16 pages above the 0.75
    floor."""
    cfg, params = _bf16_opt(layers)
    segs = _teacher_forced_segments(cfg, params, {
        "plain": ("int8", None),
        "kernel": ("int8", _kernel_numerics()),
        "wrong_scale": ("int8", _kernel_numerics(roll_scales=True)),
        "bf16_pages": ("none", None)})
    assert len(segs["plain"]) == 12              # 8 single + 2 x 2 segments
    rounding, agree = _segment_errors(segs["kernel"], segs["plain"])
    fault, _ = _segment_errors(segs["wrong_scale"], segs["plain"])
    _, page_agree = _segment_errors(segs["plain"], segs["bf16_pages"])
    print(f"{layers} layers: rounding {rounding:.2e} (agreement {agree:.3f})"
          f", wrong scale {fault:.2e}, int8 vs bf16 pages {page_agree:.3f}")
    assert rounding <= LOGIT_REL_TOL and agree >= GREEDY_AGREE_MIN
    assert fault > LOGIT_REL_TOL
    assert page_agree >= GREEDY_AGREE_MIN
