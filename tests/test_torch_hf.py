"""The Hugging Face configs, loaders, policy table and engine factory of
the port held against the JAX package's.

Each family's tiny ``transformers`` model is built from a config with
random weights (seeded, nothing fetched).  Its ``state_dict()`` goes
through the JAX ``load_*`` and the port's: the JAX tree bridged
(``checkpoint/from_jax.py``) equals the port's leaf for leaf, in fp32
and in bf16.  Every ``*_config_from_hf`` equals JAX's field by field, on
the tiny configs and on the published ``config.json`` fields of
Falcon-7B, Phi-2 and Phi-3-mini-4k-instruct.  Logits of the port's
serving model on the loaded tree equal the JAX model's within 1e-5
(fp32, absolute: the tiny models' logits are of order 0.1).  The
policy tables claim the same ``model_type``s and raise the same error;
``build_hf_engine`` serves the tiny Llama's greedy tokens as JAX's
does.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.checkpoint import hf as jhf
from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.module_inject import policies as jpol
from deepspeed_tpu_torch.checkpoint import hf as thf
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.module_inject import policies as tpol

transformers = pytest.importorskip("transformers")

LOGIT_TOL = 1e-5
PAGE, PAGES = 8, 24


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _seeded(model_cls, cfg):
    torch.manual_seed(0)
    return model_cls(cfg).eval()


def _llama():
    return _seeded(transformers.LlamaForCausalLM, transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False))


def _qwen2():
    return _seeded(transformers.Qwen2ForCausalLM, transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False))


def _gpt_neox():
    return _seeded(transformers.GPTNeoXForCausalLM,
                   transformers.GPTNeoXConfig(
                       vocab_size=128, hidden_size=64, intermediate_size=256,
                       num_hidden_layers=2, num_attention_heads=4,
                       rotary_pct=0.25, max_position_embeddings=128,
                       layer_norm_eps=1e-5, use_parallel_residual=True,
                       tie_word_embeddings=False))


def _gpt2():
    return _seeded(transformers.GPT2LMHeadModel, transformers.GPT2Config(
        vocab_size=128, n_positions=128, n_embd=64, n_layer=2, n_head=4))


def _falcon(new_arch):
    return _seeded(transformers.FalconForCausalLM, transformers.FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, new_decoder_architecture=new_arch,
        multi_query=not new_arch, num_kv_heads=2 if new_arch else None,
        parallel_attn=True, bias=False, alibi=False,
        max_position_embeddings=128, layer_norm_epsilon=1e-5))


def _opt():
    return _seeded(transformers.OPTForCausalLM, transformers.OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128,
        activation_function="relu", do_layer_norm_before=True,
        word_embed_proj_dim=64))


def _phi():
    return _seeded(transformers.PhiForCausalLM, transformers.PhiConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        partial_rotary_factor=0.5, max_position_embeddings=128,
        layer_norm_eps=1e-5))


def _phi3():
    return _seeded(transformers.Phi3ForCausalLM, transformers.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, pad_token_id=0,
        sliding_window=9))


def _bloom():
    return _seeded(transformers.BloomForCausalLM, transformers.BloomConfig(
        vocab_size=128, hidden_size=64, n_layer=2, n_head=4,
        layer_norm_epsilon=1e-5))


def _gptj():
    return _seeded(transformers.GPTJForCausalLM, transformers.GPTJConfig(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=128,
        rotary_dim=8, n_inner=None))


FAMILIES = {"llama": _llama, "qwen2": _qwen2, "gpt_neox": _gpt_neox,
            "gpt2": _gpt2, "falcon_mqa": lambda: _falcon(False),
            "falcon_new_arch": lambda: _falcon(True), "opt": _opt,
            "phi": _phi, "phi3": _phi3, "bloom": _bloom, "gptj": _gptj}

_CACHE = {}


def _hf(family):
    if family not in _CACHE:
        _CACHE[family] = FAMILIES[family]()
    return _CACHE[family]


def _same_fields(tcfg, jcfg):
    """Every field of the port's config equals JAX's (the dtype by
    name)."""
    for f in dataclasses.fields(tcfg):
        if f.name == "dtype":
            assert str(tcfg.dtype).split(".")[-1] == \
                jnp.dtype(jcfg.dtype).name
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


FALCON_7B = thf.PUBLISHED_CONFIGS["tiiuae/falcon-7b"]
PHI_2 = thf.PUBLISHED_CONFIGS["microsoft/phi-2"]
PHI3_MINI_4K = thf.PUBLISHED_CONFIGS["microsoft/Phi-3-mini-4k-instruct"]
PUBLISHED = {"falcon-7b": ("falcon_config_from_hf", FALCON_7B, 64),
             "phi-2": ("phi_config_from_hf", PHI_2, 80),
             "phi-3-mini-4k": ("phi3_config_from_hf", PHI3_MINI_4K, 96)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_from_hf_equals_jax_field_by_field(family):
    hf = _hf(family)
    mt = hf.config.model_type
    tcfg = tpol.replace_policy_for(mt).config_from_hf(hf.config)
    _same_fields(tcfg, jpol.replace_policy_for(mt).config_from_hf(hf.config))
    assert tcfg.dtype == torch.bfloat16


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_configs_equal_jax_at_their_head_dims(name):
    fn, fields, head_dim = PUBLISHED[name]
    hf_cfg = types.SimpleNamespace(**fields)
    tcfg = getattr(thf, fn)(hf_cfg)
    _same_fields(tcfg, getattr(jhf, fn)(hf_cfg))
    assert tcfg.dims_per_head == head_dim
    if name == "falcon-7b":
        assert tcfg.kv_heads == 1 and tcfg.parallel_residual
        assert tcfg.intermediate_size == 4 * 4544
    if name == "phi-2":
        assert thf._rot_dims(tcfg.dims_per_head, tcfg.rope_pct) == 32
    if name == "phi-3-mini-4k":
        assert tcfg.sliding_window == 2047 and tcfg.norm == "rmsnorm"


def test_config_refusals_match_jax():
    """The same published variants are refused with ValueError, and
    both packages build the same Mixtral config."""
    bad = [("falcon_config_from_hf", dict(FALCON_7B, alibi=True)),
           ("falcon_config_from_hf", dict(FALCON_7B, bias=True)),
           ("phi_config_from_hf", dict(PHI_2, qk_layernorm=True)),
           ("phi3_config_from_hf",
            dict(PHI3_MINI_4K, rope_scaling={"type": "longrope"})),
           ("gpt_neox_config_from_hf",
            dict(vocab_size=8, hidden_size=8, intermediate_size=8,
                 num_hidden_layers=1, num_attention_heads=2,
                 max_position_embeddings=8, layer_norm_eps=1e-5,
                 hidden_act="swish"))]
    for fn, fields in bad:
        for mod in (thf, jhf):
            with pytest.raises(ValueError):
                getattr(mod, fn)(types.SimpleNamespace(**fields))
    mixtral = types.SimpleNamespace(
        **thf.PUBLISHED_CONFIGS["mistralai/Mixtral-8x7B-v0.1"])
    _same_fields(thf.mixtral_config_from_hf(mixtral),
                 jhf.mixtral_config_from_hf(mixtral))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def _trees(family, jdtype, tdtype):
    hf = _hf(family)
    mt = hf.config.model_type
    sd = hf.state_dict()
    tp, jp = tpol.replace_policy_for(mt), jpol.replace_policy_for(mt)
    tcfg = tp.config_from_hf(hf.config)
    jcfg = jp.config_from_hf(hf.config)
    jtree = jax.tree.map(np.asarray, jp.load(sd, jcfg, jdtype))
    return (tcfg, jcfg, jtree, from_jax(jtree, tcfg, device="cpu"),
            tp.load(sd, tcfg, tdtype, "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loader_tree_equals_the_bridged_jax_tree(family, dtype):
    tcfg, _, _, bridged, tree = _trees(family, getattr(jnp, dtype),
                                       getattr(torch, dtype))
    got, want = _flat(tree), _flat(bridged)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert leaf.dtype == want[name].dtype, name
        assert leaf.shape == want[name].shape, name
        assert torch.equal(leaf, want[name]), name
    assert got["embed.tokens"].dtype == getattr(torch, dtype)
    assert got["final_norm.scale"].dtype == torch.float32


def _models(family):
    tcfg, jcfg, jtree, _, tree = _trees(family, jnp.float32, torch.float32)
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    mt = _hf(family).config.model_type
    kv = dict(num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
              head_dim=tcfg.dims_per_head, page_size=PAGE, num_pages=PAGES)
    jm = J.implementation_for(mt)(
        jcfg, jax.tree.map(jnp.asarray, jtree),
        kv_config=J.KVCacheConfig(dtype=jnp.float32, **kv))
    tm = T.implementation_for(mt)(
        tcfg, tree, device="cpu",
        kv_config=T.KVCacheConfig(dtype=torch.float32, **kv))
    return jm, tm


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_on_the_loaded_tree_equal_jax(family):
    """Two prompts prefilled, then two decode steps (each feeding the
    JAX model's greedy pick to both), through each package's engine."""
    jm, tm = _models(family)
    je, te = J.InferenceEngineV2(jm), T.InferenceEngineV2(tm)
    rng = np.random.default_rng(1)
    feed = [rng.integers(0, 128, n).tolist() for n in (13, 6)]
    for _ in range(3):
        jl = np.asarray(je.put([0, 1], feed))
        tl = te.put([0, 1], feed)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, atol=LOGIT_TOL, rtol=0)
        feed = [[int(t)] for t in jl.argmax(-1)]


# ---------------------------------------------------------------------------
# the policy table, from_pretrained and the factory
# ---------------------------------------------------------------------------

def test_policy_tables_claim_the_same_model_types():
    """The same model types in the same groups, each resolving to the
    converter and loader of the family JAX's policy forwards to."""
    assert list(tpol.POLICIES) == [p.MODEL_TYPES for p in jpol._POLICIES]
    for pol in jpol._POLICIES:
        family = pol.__name__.removesuffix("Policy").lower()
        for mt in pol.MODEL_TYPES + (pol.MODEL_TYPES[0].upper(),):
            got = tpol.replace_policy_for(mt)
            assert jpol.replace_policy_for(mt) is pol
            assert got.config_from_hf.__name__.replace("_", "") == \
                f"{family}configfromhf"
            assert got.load.__name__.replace("_", "") == f"load{family}"
    errors = []
    for mod in (tpol, jpol):
        with pytest.raises(ValueError) as e:
            mod.replace_policy_for("no-such-arch")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("family", ["falcon_mqa", "phi", "phi3"])
def test_from_pretrained_dispatches_as_jax(family):
    hf = _hf(family)
    tcfg, tree = thf.from_pretrained(hf, dtype=torch.float32, device="cpu")
    jcfg, jtree = jhf.from_pretrained(hf, dtype=jnp.float32)
    _same_fields(tcfg, jcfg)
    want = _flat(from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                          device="cpu"))
    got = _flat(tree)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_from_pretrained_of_a_path_without_transformers_names_it(
        monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name.split(".")[0] == "transformers":
            raise ImportError("no transformers")
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="`transformers` package"):
        thf.from_pretrained(str(tmp_path), device="cpu")


def test_build_hf_engine_serves_jax_greedy_tokens():
    """The tiny Llama through both factories (bf16 weights, the
    published configs' bf16 compute): the same greedy tokens."""
    hf = _hf("llama")
    prompts = [[1, 5, 9, 2], [7, 3, 3, 8, 1, 4, 4]]
    sp = dict(max_new_tokens=6)
    jeng = J.build_hf_engine(hf)
    teng = T.build_hf_engine(hf, device="cpu")
    assert teng.model.cfg.dtype == torch.bfloat16
    assert teng.model.params["embed"]["tokens"].dtype == torch.bfloat16
    ours = T.generate(teng, prompts, T.SamplingParams(**sp))
    ref = J.generate(jeng, prompts, J.SamplingParams(**sp))
    assert ours == ref


def test_hf_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    hf = _hf("phi3")
    with pytest.raises(RuntimeError, match="CUDA"):
        thf.from_pretrained(hf)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build_hf_engine(hf)
