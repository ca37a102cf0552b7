"""Mixtral serving in the port held against the JAX package, on the CPU.

The slice as a whole: a debug Mixtral (4 experts, top-2, fp32; the JAX
initialiser's tree bridged through ``checkpoint/from_jax.py``) served by
both packages' ``FastGenScheduler`` in the default serving configuration
(the async chain, prefix caching) over prefill chunks, chained decode
and a prefix hit: the same ``{uid: token}`` at every step and the same
prefix hits, with full-precision weights and with the engines
quantising them to fp8_e4m3 or int8 at build.  The HF side: the
published Mixtral-8x7B ``config.json`` fields give JAX's config,
``load_mixtral`` on a synthetic HF state dict gives JAX's tree leaf for
leaf, and ``build_hf_engine`` on a tiny ``transformers`` Mixtral serves
JAX's greedy tokens, its bf16 logits within 2e-2 of max|ref| of the HF
model's fp32 ones (4.8e-3 measured).
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
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from deepspeed_tpu.models.mixtral import mixtral_config as jmixtral_config
from deepspeed_tpu_torch.checkpoint import hf as thf
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import model_implementations as timpl
from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from test_torch_hf import _flat, _same_fields
from test_torch_serving import _shared_prefix_traffic, serve_in_lockstep

PAGE, PAGES, BUDGET = 16, 96, 64
EXPERTS, TOP_K = 4, 2
MIXTRAL_8X7B = thf.PUBLISHED_CONFIGS["mistralai/Mixtral-8x7B-v0.1"]
HF_LOGIT_TOL = 2e-2


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    model = JMixtral("debug", num_experts=EXPERTS, top_k=TOP_K,
                     max_seq_len=256, dtype=jnp.float32)
    jcfg = dataclasses.replace(model.cfg, moe_num_experts=EXPERTS,
                               moe_top_k=TOP_K)
    tree = jax.tree.map(np.asarray,
                        meta.unbox(model.init_params(jax.random.key(0))))
    tcfg = mixtral_config("debug", max_seq_len=256, dtype=torch.float32,
                          moe_num_experts=EXPERTS, moe_top_k=TOP_K)
    return jcfg, tree, tcfg


def _econf(mod, quant):
    d = {"quantization": {"enabled": True, "fmt": quant}} if quant else {}
    conf = mod.RaggedInferenceEngineConfig.from_dict(d)
    conf.state_manager = mod.StateManagerConfig(
        max_tracked_sequences=8, max_ragged_sequence_count=8,
        max_ragged_batch_size=BUDGET)
    return conf


def _engines(weights, quant=None):
    jcfg, tree, tcfg = weights
    kv = dict(num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
              head_dim=jcfg.dims_per_head, page_size=PAGE, num_pages=PAGES)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jax.tree.map(jnp.asarray, tree),
                               kv_config=J.KVCacheConfig(dtype=jnp.float32,
                                                         **kv)),
        _econf(J, quant))
    teng = T.InferenceEngineV2(
        timpl.MixtralInferenceModel(
            tcfg, from_jax(tree, tcfg, device="cpu"), device="cpu",
            kv_config=T.KVCacheConfig(dtype=torch.float32, **kv)),
        _econf(T, quant))
    return jeng, teng


@pytest.mark.parametrize("quant", [None, "fp8_e4m3", "int8"])
def test_mixtral_serves_jax_greedy_tokens_step_by_step(weights, quant,
                                                       monkeypatch):
    """Prefill chunks under a 64-token budget, chained decode, prefix
    hits: every step delivers the JAX scheduler's tokens, the page audit
    passes after every step (DS_KV_DEBUG=1)."""
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    jeng, teng = _engines(weights, quant)
    assert teng.model.moe_cfg.num_experts == EXPERTS
    assert teng.model.quantized_fmt == quant
    if quant:
        wi = teng.model.params["layers"]["mlp"]["wi"]
        assert wi["scale"].shape == (2, EXPERTS, 1, 128)
    rng = np.random.default_rng(4)
    prompts, new = _shared_prefix_traffic(rng)
    prompts[1] = rng.integers(0, 128, 150)         # a chunked prefill
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))
    tokens, hits = serve_in_lockstep(jsched, tsched, jeng, teng)
    assert hits["port"] == hits["jax"]
    assert [hits["port"][u] for u in (0, 2, 4)] == [0, 32, 32]
    assert all(len(tokens[u]) == n for u, n in enumerate(new))
    keys = teng.compiled_keys()
    assert {"chain", "mixed"} <= {k[4] for k in keys if len(k) > 4}
    # a prefill chunk over history: a mixed key's paged prefill segment
    assert any(k[4] == "mixed" and k[6] > 1 and not k[8] for k in keys
               if len(k) > 4)
    teng.state_manager.check_invariants()


def test_quantised_tokens_stay_close_to_full_precision(weights):
    """Weight-only quantisation changes the weights, not the path: the
    fp8 engine's greedy tokens mostly agree with the fp32 engine's (the
    JAX test's bar, half)."""
    prompts = [[1, 5, 9, 2, 17], [3, 4]]
    sp = T.SamplingParams(max_new_tokens=8)
    full = T.generate(_engines(weights)[1], prompts, sp)
    quant = T.generate(_engines(weights, "fp8_e4m3")[1], prompts, sp)
    flat_f = [t for seq in full for t in seq]
    flat_q = [t for seq in quant for t in seq]
    assert sum(a == b for a, b in zip(flat_f, flat_q)) >= len(flat_f) // 2


# ---------------------------------------------------------------------------
# configs, the tree, the loader and the factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["8x7b", "tiny", "debug"])
def test_mixtral_presets_equal_jax(size):
    _same_fields(mixtral_config(size), jmixtral_config(size))
    _same_fields(mixtral_config(size, max_seq_len=77, dtype=torch.float32),
                 jmixtral_config(size, max_seq_len=77, dtype=jnp.float32))


def test_published_mixtral_config_equals_jax():
    hf_cfg = types.SimpleNamespace(**MIXTRAL_8X7B)
    tcfg = thf.mixtral_config_from_hf(hf_cfg)
    _same_fields(tcfg, jhf.mixtral_config_from_hf(hf_cfg))
    assert (tcfg.moe_num_experts, tcfg.moe_top_k) == (8, 2)
    assert (tcfg.num_heads, tcfg.kv_heads, tcfg.dims_per_head) == (32, 8, 128)
    assert tcfg.rope_theta == 1e6 and tcfg.sliding_window is None
    assert tcfg.max_seq_len == 32768 and not tcfg.tie_embeddings


@pytest.mark.parametrize("scan_layers", [True, False])
def test_init_params_has_jax_s_tree_and_training_raises(scan_layers):
    kw = dict(num_experts=3, top_k=2, scan_layers=scan_layers)
    jtree = jax.tree.map(np.asarray, meta.unbox(
        JMixtral("debug", **kw).init_params(jax.random.key(0))))
    model = MixtralForCausalLM("debug", **kw)
    ttree = model.init_params(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(ttree).items()} == \
        {k: v.shape for k, v in _flat(jtree).items()}
    assert model.moe_cfg.num_experts == 3
    for fn in ("loss", "logits", "eval_loss"):
        with pytest.raises(NotImplementedError, match="11h"):
            getattr(model, fn)(ttree, {"input_ids": torch.zeros(1, 4)})


def _synthetic_state_dict(L=2, E=64, F=96, X=EXPERTS, H=4, K=2, V=128,
                          seed=0):
    rng = np.random.default_rng(seed)
    D = E // H

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    sd = {"model.embed_tokens.weight": w(V, E), "model.norm.weight": w(E),
          "lm_head.weight": w(V, E)}
    for i in range(L):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": w(H * D, E),
                   p + "self_attn.k_proj.weight": w(K * D, E),
                   p + "self_attn.v_proj.weight": w(K * D, E),
                   p + "self_attn.o_proj.weight": w(E, H * D),
                   p + "input_layernorm.weight": w(E),
                   p + "post_attention_layernorm.weight": w(E),
                   p + "block_sparse_moe.gate.weight": w(X, E)})
        for e in range(X):
            q = p + f"block_sparse_moe.experts.{e}."
            sd.update({q + "w1.weight": w(F, E), q + "w3.weight": w(F, E),
                       q + "w2.weight": w(E, F)})
    hf_cfg = types.SimpleNamespace(
        vocab_size=V, hidden_size=E, intermediate_size=F,
        num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=K,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=1e6,
        sliding_window=None, num_local_experts=X, num_experts_per_tok=2,
        tie_word_embeddings=False)
    return sd, hf_cfg


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_mixtral_gives_jax_s_tree(dtype, scan_layers):
    sd, hf_cfg = _synthetic_state_dict()
    tcfg = dataclasses.replace(thf.mixtral_config_from_hf(hf_cfg),
                               scan_layers=scan_layers)
    jcfg = dataclasses.replace(jhf.mixtral_config_from_hf(hf_cfg),
                               scan_layers=scan_layers)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    jtree = jax.tree.map(np.asarray, jhf.load_mixtral(sd, jcfg, jdt))
    want = _flat(from_jax(jtree, tcfg, device="cpu"))
    got = _flat(thf.load_mixtral(sd, tcfg, tdt, "cpu"))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    lay = "layers." if scan_layers else "layers.layer_0."
    lead = (2,) if scan_layers else ()
    assert got[lay + "mlp.wi"].shape == lead + (EXPERTS, 64, 96)
    assert got[lay + "mlp.wo"].shape == lead + (EXPERTS, 96, 64)
    assert got[lay + "mlp.gate"].shape == lead + (64, EXPERTS)
    with pytest.raises(KeyError, match="experts"):
        thf.load_mixtral({k: v for k, v in sd.items()
                          if "experts" not in k}, tcfg, device="cpu")


def test_the_bridge_checks_the_moe_leaves(weights):
    _, tree, tcfg = weights
    broken = jax.tree.map(lambda a: a, tree)
    broken["layers"]["mlp"]["wi"] = broken["layers"]["mlp"]["wi"][:, :3]
    with pytest.raises(ValueError, match="mlp.wi"):
        from_jax(broken, tcfg, device="cpu")
    dense = dataclasses.replace(tcfg, moe_num_experts=0)
    with pytest.raises(ValueError):
        from_jax(tree, dense, device="cpu")


def _tiny_hf_mixtral():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=EXPERTS, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.MixtralForCausalLM(cfg).eval()


def test_build_hf_engine_serves_mixtral_as_jax_and_hf_do():
    hf = _tiny_hf_mixtral()
    prompts = [[1, 5, 9, 2], [7, 3, 3, 8, 1, 4, 4]]
    teng = T.build_hf_engine(hf, dtype=torch.float32, device="cpu")
    jeng = J.build_hf_engine(hf, dtype=jnp.float32)
    assert type(teng.model) is timpl.MixtralInferenceModel
    assert teng.model.cfg.moe_num_experts == EXPERTS
    ours = T.generate(teng, prompts, T.SamplingParams(max_new_tokens=5))
    ref = J.generate(jeng, prompts, J.SamplingParams(max_new_tokens=5))
    assert ours == ref
    ids = np.arange(1, 17, dtype=np.int64) % 128
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(ids)[None]).logits[0, -1]
    logits = teng.put([99], [ids.astype(np.int32)])[0]
    teng.flush(99)
    # the engines compute in bf16 (the published configs' dtype), the HF
    # model in fp32: a few bf16 ulps of the logits after two layers
    scale = float(hf_logits.abs().max())
    assert float((torch.as_tensor(logits) - hf_logits).abs().max()) \
        <= HF_LOGIT_TOL * scale
