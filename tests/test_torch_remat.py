"""Remat policies in the port held against ``nothing_saveable`` and against
the JAX package's policies, on the CPU.

A policy changes what the backward finds saved, never a number: in the
port the loss and every gradient of the debug llama (2 layers, E = 64)
are bit-equal to ``nothing_saveable``'s under every policy, on the flash
path and on the dense einsum path.  Against JAX's ``jax.checkpoint``
under the same policy (fp32, the same bridged weights): loss rtol 1e-5,
each gradient 1e-5 of its leaf's largest magnitude (measured: the
losses equal, gradients <= 1.8e-6).  The ``activation_checkpointing`` and ``tpu`` sections map
onto the model's config as JAX's engine maps them.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.runtime.config import load_config as j_load_config
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models import transformer as T
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.tree import tree_leaves, tree_map

LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
POLICIES = T.REMAT_POLICY_NAMES


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, (2, 32)).astype(np.int32)}


def _port_loss_and_grads(model, params, batch):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = model.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), [t.grad for t in tree_leaves(p)]


@pytest.fixture(scope="module")
def jax_weights():
    jmodel = JLlama("debug", dtype=jnp.float32)
    return jax.tree.map(np.asarray,
                        meta.unbox(jmodel.init_params(jax.random.key(0))))


def test_policy_names_are_jax_names():
    for name in POLICIES:
        assert T.resolve_remat_policy(name).name == name
    assert len(POLICIES) == 7
    from deepspeed_tpu.models.transformer import \
        resolve_remat_policy as j_resolve
    for name in POLICIES:
        j_resolve(name)
    with pytest.raises(ValueError) as ref:
        j_resolve("bogus")
    with pytest.raises(ValueError) as got:
        T.resolve_remat_policy("bogus")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("impl", ["auto", "einsum"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bit_equal_to_nothing_saveable(jax_weights, policy, impl):
    model = LlamaForCausalLM("debug", dtype=torch.float32,
                             attention_impl=impl)
    params = from_jax(jax_weights, model.cfg, device="cpu")
    batch = _batch()
    ref_loss, ref_grads = _port_loss_and_grads(model, params, batch)
    model.cfg = dataclasses.replace(model.cfg, remat_policy=policy)
    loss, grads = _port_loss_and_grads(model, params, batch)
    assert loss == ref_loss
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_the_jax_policy(jax_weights, policy):
    jmodel = JLlama("debug", dtype=jnp.float32, remat_policy=policy)
    batch = _batch(1)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, batch, jax.random.key(0))))(jax_weights)
    model = LlamaForCausalLM("debug", dtype=torch.float32,
                             remat_policy=policy)
    params = from_jax(jax_weights, model.cfg, device="cpu")
    loss, grads = _port_loss_and_grads(model, params, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    port = to_numpy(tree_map(lambda g: g, _as_tree(params, grads)))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port),
                            jax.tree.leaves(jgrads)):
        b = np.asarray(b)
        scale = float(np.abs(b).max()) or 1.0
        assert float(np.abs(a - b).max()) <= GRAD_REL * scale, path


def _as_tree(params, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def test_offload_policy_keeps_its_saves_on_the_host_path():
    """On the CPU the offload policies keep the saved values where they
    are; the selective modes still record and return them (the
    recomputation pops every value the backward needs)."""
    model = LlamaForCausalLM("debug", dtype=torch.float32,
                             remat_policy="offload_dots")
    params = model.init_params(0, "cpu")
    loss, grads = _port_loss_and_grads(model, params, _batch())
    assert np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    keep = T._SavePolicy(T.resolve_remat_policy("offload_dots")).keep
    x = torch.ones(3)
    assert keep(x).data_ptr() == x.data_ptr()    # a CPU value stays put


# ---------------------------------------------------------------------------
# the engine's mapping of the config sections (JAX engine.py:288-345)
# ---------------------------------------------------------------------------

MAPPINGS = {
    "policy_full": {"activation_checkpointing": {"policy": "full"}},
    "policy_nothing": {"activation_checkpointing": {"policy": "nothing"}},
    "policy_dots": {"activation_checkpointing": {"policy": "dots"}},
    "policy_no_batch": {"activation_checkpointing": {
        "policy": "dots_with_no_batch_dims"}},
    "policy_offload_dots": {"activation_checkpointing": {
        "policy": "offload_dots"}},
    "policy_by_name": {"activation_checkpointing": {
        "policy": "save_attn_out"}},
    "cpu_ckpt_default": {"activation_checkpointing": {
        "cpu_checkpointing": True}},
    "cpu_ckpt_dots": {"activation_checkpointing": {
        "cpu_checkpointing": True, "policy": "dots"}},
    "cpu_ckpt_attn": {"activation_checkpointing": {
        "cpu_checkpointing": True},
        "tpu": {"remat_policy": "save_attn_out"}},
    "tpu_keys": {"tpu": {"remat": False, "attention_impl": "einsum",
                         "scan_layers": False}},
    "partition_activations": {"activation_checkpointing": {
        "partition_activations": True, "policy": "full"}},
}


def _port_cfg(over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "bf16": {"enabled": False},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("case", sorted(MAPPINGS))
def test_config_sections_map_onto_the_model_as_jax(case):
    cfg = _port_cfg(MAPPINGS[case])
    jmodel = JLlama("debug", dtype=jnp.float32)
    JEngine._apply_model_overrides(types.SimpleNamespace(
        module=jmodel, config=j_load_config(cfg)))
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    engine, *_ = dtt.initialize(model=model, config=cfg, device="cpu")
    for key in ("remat", "remat_policy", "attention_impl", "scan_layers"):
        assert getattr(model.cfg, key) == getattr(jmodel.cfg, key), key
    if case == "tpu_keys":
        assert "layer_0" in engine.params["layers"]
    # and the mapped policy trains
    assert np.isfinite(engine.train_batch({
        "input_ids": _batch()["input_ids"]}))


def test_cpu_checkpointing_over_everything_saveable_raises_as_jax():
    cfg = _port_cfg({"activation_checkpointing": {
        "cpu_checkpointing": True, "policy": "nothing"}})
    with pytest.raises(ValueError) as ref:
        JEngine._apply_model_overrides(types.SimpleNamespace(
            module=JLlama("debug"), config=j_load_config(cfg)))
    with pytest.raises(ValueError) as got:
        dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                       config=cfg, device="cpu")
    assert str(got.value) == str(ref.value)
