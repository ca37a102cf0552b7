"""The RLHF hybrid engine (``runtime/hybrid_engine.py``) held against the
JAX package's on the CPU.

``tests/test_inference_v1.py``'s ``HYBRID_CFG`` without its ``tpu.mesh``
(one device), the debug llama in fp32, the JAX engine's initial weights
bridged into the port: the greedy rollouts before and after 3
``train_batch`` steps are identical to JAX's, the losses within 1e-5
relative, the rollout weights are refreshed (``_inference_params_step ==
global_steps``) by copies into the rollout model's own tensors, whose
data pointers stay.  After a refresh the rollouts equal a fresh
``init_inference`` engine's over the same weights, also for prompts
longer than a KV page, whose cached prefix pages the refresh drops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.tree import tree_leaves
from test_torch_training import jax_engine, jax_params

HYBRID_CFG = {
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
    "hybrid_engine": {"enabled": True},
    "tpu": {"compute_dtype": "float32", "param_dtype": "float32"},
    "bf16": {"enabled": False},
    "checkpoint": {"async_save": False},
}
PROMPTS = [[1, 2, 3, 4], [7, 8]]
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _batch(seq=16):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, size=(2, seq + 1))
    return {"input_ids": ids[:, :-1].astype(np.int32),
            "labels": ids[:, 1:].astype(np.int32)}


@pytest.fixture(scope="module")
def runs():
    """Both engines: rollouts, 3 steps, rollouts; the port's rollout
    tensors' data pointers before and after the refresh."""
    je = jax_engine(JLlama("debug", max_seq_len=256, dtype=jnp.float32),
                    HYBRID_CFG)
    model = LlamaForCausalLM("debug", max_seq_len=256, dtype=torch.float32)
    te, *_ = dtt.initialize(model=model, config=HYBRID_CFG, device="cpu",
                            model_parameters=from_jax(
                                jax_params(je), model.cfg, device="cpu"))
    out = {"te": te, "je": je}
    for name, eng in (("jax", je), ("port", te)):
        before = eng.generate(PROMPTS, max_new_tokens=3, do_sample=False)
        if name == "port":
            out["ptrs"] = [t.data_ptr() for t in tree_leaves(
                te._inflight_engine.model.params)]
        losses = [eng.train_batch(_batch()) for _ in range(3)]
        after = eng.generate(PROMPTS, max_new_tokens=3, do_sample=False)
        out[name] = (before, losses, after)
    return out


def test_rollouts_and_losses_equal_the_jax_hybrid_engine(runs):
    jb, jl, ja = runs["jax"]
    tb, tl, ta = runs["port"]
    assert tb == jb and all(len(o) == 3 for o in tb)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert ta == ja
    te = runs["te"]
    assert te._inference_params_step == te.global_steps == 3
    assert te.generate_throughput() > 0


def test_the_refresh_copies_into_the_rollout_model_s_tensors(runs):
    te = runs["te"]
    leaves = tree_leaves(te._inflight_engine.model.params)
    assert [t.data_ptr() for t in leaves] == runs["ptrs"]
    # they hold the current masters, cast to the compute dtype
    for t, m in zip(leaves, te.masters):
        torch.testing.assert_close(t, m.to(te.compute_dtype), rtol=0, atol=0)
    assert te.refresh_seconds > 0
    # no step since the refresh: the next rollout refreshes nothing
    eng = te._inference_engine()
    assert eng is te._inflight_engine


def test_rollouts_after_a_refresh_equal_a_fresh_engine(runs):
    """Prompts over a KV page (64 tokens): the first rollout leaves their
    full pages in the prefix cache; after a step those pages hold KV of
    the old weights, and the refresh drops them, so the rollout equals a
    fresh ``init_inference`` engine's over the new weights."""
    te = runs["te"]
    rng = np.random.default_rng(5)
    long = [rng.integers(0, 128, n).tolist() for n in (130, 70)]
    te.generate(long, max_new_tokens=4, do_sample=False)
    te.set_lr(0.05)         # a step large enough to change these tokens
    te.train_batch(_batch())
    got = te.generate(long, max_new_tokens=4, do_sample=False)
    fresh = dtt.init_inference(
        model=(te.module.cfg, te._cast_masters()),
        config={"dtype": "float32", "max_out_tokens": 64}, device="cpu")
    assert got == fresh.generate(long, max_new_tokens=4)


def test_serving_optimization_reaches_the_rollout_engine():
    cfg = dict(HYBRID_CFG, serving_optimization={"keyed_sampling": True,
                                                 "prefix_caching": False})
    te, *_ = dtt.initialize(
        model=LlamaForCausalLM("debug", max_seq_len=256,
                               dtype=torch.float32),
        config=cfg, device="cpu")
    assert isinstance(te, dtt.DeepSpeedHybridEngine)
    # the optimizer's state exists from the build on, as JAX's optax state
    assert all(st["step"] == 0 for st in te.optimizer.state.values())
    # the step probe that sizes the KV pool leaves the engine as it was
    # (the CPU reports no memory, so it measures nothing here)
    before = [t.clone() for t in list(te.masters) + list(te._grads)]
    counts = (te.micro_steps, te._pending, te.global_steps)
    assert te._step_transient_bytes() is None
    assert all(torch.equal(a, b) for a, b in zip(
        before, list(te.masters) + list(te._grads)))
    assert (te.micro_steps, te._pending, te.global_steps) == counts
    assert te._params_c is None
    te.eval()
    assert te._in_eval
    te.train()
    out = te.generate(PROMPTS, max_new_tokens=2, do_sample=True,
                      temperature=0.7)
    serving = te._inflight_engine._config.serving
    assert serving.keyed_sampling and not serving.prefix_caching
    assert [len(o) for o in out] == [2, 2]
    bad = dict(HYBRID_CFG, serving_optimization={"tp_degree": 2})
    te, *_ = dtt.initialize(model=LlamaForCausalLM("debug",
                                                   dtype=torch.float32),
                            config=bad, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        te.generate(PROMPTS, max_new_tokens=1)
