"""``init_inference`` (``inference/engine.py``) and AutoTP
(``module_inject/auto_tp.py``) held against the JAX package's on the
CPU.

The debug llama in fp32 at tp 1, the JAX initializer's weights bridged
through ``from_jax``: ``generate``'s greedy tokens are identical to the
JAX engine's, ``forward``'s logits within 1e-5, and the guard rails,
the unknown-key warning, the dtype map and the tp parser are JAX's.
"""

import contextlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from jax.sharding import Mesh

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.inference import engine as jv1
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.module_inject import AutoTP as JAutoTP
from deepspeed_tpu.module_inject import classify as jclassify
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import engine as tv1
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.module_inject import AutoTP, classify

CFG = {"dtype": "float32", "max_out_tokens": 64}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines():
    jm = JLlama("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(jm.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    je = dst.init_inference(model=(jm.cfg, params), config=dict(CFG))
    te = dtt.init_inference(model=(tcfg, tparams), config=dict(CFG),
                            device="cpu")
    return je, te


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 128, n).tolist() for n in (9, 5, 70)]


def test_generate_is_token_for_token_jax_s(engines):
    je, te = engines
    prompts = _prompts()
    assert te.generate(prompts, max_new_tokens=6) == \
        je.generate(prompts, max_new_tokens=6)
    # max_length: a per-prompt budget of the total length
    assert te.generate(prompts[:2], max_length=12) == \
        je.generate(prompts[:2], max_length=12)
    # a 2-D array is a batch of prompts, a 1-D one a single prompt (the
    # port's normalisation is JAX's; the tokens are the lists' above)
    arr = np.asarray([prompts[0], prompts[0]], np.int32)
    for x in (arr, np.asarray(prompts[1]), [prompts[1]]):
        assert te._normalize_prompts(x) == je._normalize_prompts(x)
    assert te.generate(arr, max_new_tokens=6) == \
        te.generate([prompts[0]] * 2, max_new_tokens=6)


def test_forward_logits_are_jax_s_and_greedy_continues_them(engines):
    je, te = engines
    p = _prompts()[0]
    ids = np.asarray([p], np.int32)
    got = te.forward(ids)
    ref = np.asarray(je.forward(ids))
    assert got.shape == ref.shape == (1, 9, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    first = te.generate([p], max_new_tokens=1)[0][0]
    assert first == int(got[0, -1].argmax())
    # a padding mask goes through as in JAX
    am = np.ones_like(ids)
    am[0, :2] = 0
    np.testing.assert_allclose(te.forward(ids, attention_mask=am).numpy(),
                               np.asarray(je.forward(ids, attention_mask=am)),
                               rtol=1e-5, atol=1e-5)


def test_the_guard_rails_are_jax_s(engines):
    je, te = engines
    for eng in (je, te):
        with pytest.raises(ValueError, match="max_out_tokens"):
            eng.generate([[1, 2, 3]], max_new_tokens=100)
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = te.module.params
    with pytest.raises(NotImplementedError, match="item 13"):
        dtt.init_inference(model=(tcfg, tparams), device="cpu",
                           config={"dtype": "float32",
                                   "tensor_parallel": {"tp_size": 2}})


@contextlib.contextmanager
def _warnings(logger):
    seen = []

    class _H(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                seen.append(record.getMessage())
    h = _H()
    logger.addHandler(h)
    try:
        yield seen
    finally:
        logger.removeHandler(h)


def test_unknown_keys_warn_and_the_dtype_map_is_jax_s(engines):
    _, te = engines
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    with _warnings(dtt.logger) as seen:
        eng = dtt.init_inference(model=(tcfg, te.module.params),
                                 config={"dtype": "fp16", "mp_size": 1,
                                         "kv_cache_pages": 12},
                                 device="cpu")
    assert seen == ["init_inference: ignoring config key 'mp_size'"]
    assert eng.module_config.dtype == torch.bfloat16
    assert eng.module.kv_config.num_pages == 12
    assert {k: str(v).split(".")[-1] for k, v in tv1.DTYPES.items()} == \
        {k: jnp.dtype(v).name for k, v in jv1.DTYPES.items()}
    tf = {f for f in tv1.InferenceConfig.__dataclass_fields__}
    assert tf == set(jv1.InferenceConfig.model_fields)
    assert vars(tv1.InferenceConfig().tensor_parallel) == \
        jv1.InferenceConfig().tensor_parallel.model_dump()


def test_autotp_classifies_and_parses_as_jax_at_tp_1():
    names = ["model.layers.0.self_attn.q_proj.weight",
             "model.layers.0.mlp.gate_proj.weight",
             "model.layers.0.self_attn.o_proj.weight",
             "model.layers.0.mlp.down_proj.weight",
             "transformer.h.0.mlp.c_fc.weight", "model.embed_tokens.weight",
             "model.norm.weight", "lm_head", "attn.out.bias"]
    assert [classify(n) for n in names] == [jclassify(n) for n in names]
    params = {"layers": {"0": {
        "q_proj": np.zeros((16, 32), np.float32),
        "o_proj": np.zeros((32, 16), np.float32),
        "q_proj_bias": np.zeros((32,), np.float32),
        "norm": np.zeros((16,), np.float32)}},
        "embed_tokens": np.zeros((64, 16), np.float32),
        "stack": [np.zeros((4, 8), np.float32)]}
    mesh = Mesh(np.array(jax.devices()[:1]), ("tensor",))
    for layout in ("in_out", "out_in"):
        jtp, ttp = JAutoTP(mesh, weight_layout=layout), \
            AutoTP(weight_layout=layout)
        assert ttp.replication_report(params) == \
            jtp.replication_report(params)
        jspecs = jax.tree.leaves(jtp.tp_parser(params),
                                 is_leaf=lambda x: isinstance(
                                     x, jax.sharding.PartitionSpec))
        tspecs = jax.tree.leaves(ttp.tp_parser(params),
                                 is_leaf=lambda x: isinstance(x, tuple))
        assert [tuple(s) for s in tspecs] == [tuple(s) for s in jspecs]
    assert AutoTP().shard(params) is params
    with pytest.raises(NotImplementedError, match="item 13"):
        AutoTP(tp_size=2)
