"""The port's Lion and LAMB held against the JAX package's, on the CPU:
the plain versions against the Pallas kernels (interpret mode) and
optax, and the training engine against the one-device JAX engine.

Tolerances: the ops rtol 1e-5, atol 1e-6 (tests/test_ops.py:343,361's;
the same fp32 expressions, sums and square roots in another order);
engine parity as tests/test_torch_training.py (losses rtol 1e-4,
params 1e-4 absolute and in rms relative to the leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.ops import fused_optimizer as jfo
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
from deepspeed_tpu_torch.runtime.config import OptimizerParams
from deepspeed_tpu_torch.runtime.optimizers import get_optimizer
from test_torch_training import (LOSS_RTOL, assert_params_close, jax_engine,
                                 jax_params, llama_config, token_batches)

RTOL, ATOL = 1e-5, 1e-6
LION = dict(lr=1e-2, b1=0.9, b2=0.99)
LAMB = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-6)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(n=3000, seed=0):
    """tests/test_ops.py's inputs: p ~ N(0, 1), g ~ 0.1 N(0, 1); n = 3000
    is not a multiple of the TPU kernels' 1024 lanes (their padding)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32),
            (rng.normal(size=n) * 0.1).astype(np.float32))


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the plain versions against the TPU kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_lion_plain_matches_jax_kernel_over_steps(wd):
    p, g = _flat()
    jp, jm = jnp.asarray(p), jnp.zeros(p.size)
    tp, tm = _t(p), torch.zeros(p.size)
    for step in (1, 2, 3):
        gs = g * step
        jp, jm = jfo.fused_lion_flat(jp, jnp.asarray(gs), jm, wd=wd,
                                     interpret=True, **LION)
        tfo.fused_lion_flat(tp, _t(gs), tm, wd=wd, **LION)
        _close(tp, jp)
        _close(tm, jm)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_lamb_plain_matches_jax_kernel_over_steps(wd):
    p, g = _flat(seed=1)
    jp, jm, jv = jnp.asarray(p), jnp.zeros(p.size), jnp.zeros(p.size)
    tp, tm, tv = _t(p), torch.zeros(p.size), torch.zeros(p.size)
    for step in (1, 2, 3):
        gs = g * step
        jp, jm, jv = jfo.fused_lamb_flat(jp, jnp.asarray(gs), jm, jv,
                                         wd=wd, step=float(step),
                                         interpret=True, **LAMB)
        tfo.fused_lamb_flat(tp, _t(gs), tm, tv, wd=wd, step=step, **LAMB)
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            _close(a, b)


@pytest.mark.parametrize("zero", ["p", "g"])
def test_lamb_zero_norm_leaf_takes_ratio_one(zero):
    """A leaf whose p is 0 (||p|| = 0), or whose first update is 0 (g = 0
    and no decay: ||u|| = 0), steps with trust ratio 1, as in JAX."""
    p, g = _flat(n=1500, seed=2)
    if zero == "p":
        p = np.zeros_like(p)
    else:
        g = np.zeros_like(g)
    jp, _, _ = jfo.fused_lamb_flat(jnp.asarray(p), jnp.asarray(g),
                                   jnp.zeros(p.size), jnp.zeros(p.size),
                                   wd=0.0, step=1.0, interpret=True, **LAMB)
    tp, tm, tv = _t(p), torch.zeros(p.size), torch.zeros(p.size)
    u, norms = tfo.lamb_stage1(tp, _t(g), tm, tv, LAMB["b1"], LAMB["b2"],
                               LAMB["eps"], 0.0, 1)
    assert norms.shape == (1, 2)
    assert float(norms[0, int(zero == "g")]) == 0.0
    expect = tp - LAMB["lr"] * u          # ratio 1
    tfo.lamb_trust_step(tp, u, norms, LAMB["lr"])
    torch.testing.assert_close(tp, expect, rtol=0, atol=0)
    _close(tp, jp)


def _tree_steps(tx, opt, tparams, params, n=3):
    rng = np.random.default_rng(5)
    grads = [{k: rng.standard_normal(x.shape).astype(np.float32)
              for k, x in params.items()} for _ in range(n)]
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    for gr in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, gr), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, t in tparams.items():
            t.grad = _t(gr[k])
        opt.step()
        for k, t in tparams.items():
            _close(t, jparams[k])


def _leaves(seed=3):
    p, _ = _flat(seed=seed)
    return {"a": p.reshape(60, 50), "b": p[:100]}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_lion_optimizer_matches_optax_lion(wd):
    params = _leaves()
    tparams = {k: _t(x) for k, x in params.items()}
    opt = tfo.FusedLion(tparams.values(), lr=LION["lr"],
                        betas=(LION["b1"], LION["b2"]), weight_decay=wd)
    tx = optax.lion(LION["lr"], b1=LION["b1"], b2=LION["b2"],
                    weight_decay=wd)
    _tree_steps(tx, opt, tparams, params)
    assert opt.state[tparams["a"]]["step"] == 3
    assert set(opt.state[tparams["a"]]) == {"step", "exp_avg"}


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_lamb_optimizer_matches_optax_lamb(wd):
    """optax.lamb's trust ratio is per leaf, as the port's: two leaves of
    different scale."""
    params = _leaves(seed=4)
    params["b"] = params["b"] * 10
    tparams = {k: _t(x) for k, x in params.items()}
    opt = tfo.FusedLamb(tparams.values(), lr=LAMB["lr"],
                        betas=(LAMB["b1"], LAMB["b2"]), eps=LAMB["eps"],
                        weight_decay=wd)
    tx = optax.lamb(LAMB["lr"], b1=LAMB["b1"], b2=LAMB["b2"],
                    eps=LAMB["eps"], weight_decay=wd)
    _tree_steps(tx, opt, tparams, params)


def test_optimizer_wrappers_run_no_kernel_on_cpu():
    p, g = (_t(a) for a in _flat(16))
    before = (tfo.LION_KERNEL.launches, tfo.LAMB_KERNEL.launches)
    tfo.fused_lion_flat(p, g, torch.zeros(16), wd=0.1, **LION)
    tfo.fused_lamb_flat(p, g, torch.zeros(16), torch.zeros(16), wd=0.1,
                        step=1, **LAMB)
    assert (tfo.LION_KERNEL.launches, tfo.LAMB_KERNEL.launches) == before
    with pytest.raises(ValueError, match="1-based"):
        tfo.lamb_stage1(p, g, torch.zeros(16), torch.zeros(16), 0.9, 0.999,
                        1e-6, 0.0, 0)


# ---------------------------------------------------------------------------
# the factory: JAX get_optimizer's hyper-parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cls,group", [
    ("lion", tfo.FusedLion, dict(betas=(0.9, 0.999), weight_decay=0.0)),
    ("FusedLion", tfo.FusedLion, dict(betas=(0.9, 0.999), weight_decay=0.0)),
    ("lamb", tfo.FusedLamb, dict(betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.0)),
    ("fused_lamb", tfo.FusedLamb, dict(betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=0.0)),
    ("adamw", tfo.FusedAdamW, dict(betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=0.0)),
])
def test_factory_gives_jax_hyper_parameters(name, cls, group):
    """JAX optimizers.py:62-67 under the default params: Lion's b2 is
    betas[1] = 0.999 (not Lion's customary 0.99) and it takes no eps;
    LAMB's eps is the config's 1e-8 (not optax's 1e-6)."""
    opt = get_optimizer(name, OptimizerParams(), [torch.zeros(4)])
    assert type(opt) is cls
    got = {k: v for k, v in opt.param_groups[0].items()
           if k not in ("params", "lr")}
    assert got == group


@pytest.mark.parametrize("name,item", [
    ("cpuadam", "11g"), ("cpulion", "11g"), ("sgd", "11d"),
    ("adagrad", "11d"), ("onebitlamb", "11d"), ("muon", "11d")])
def test_factory_raises_for_the_other_optimizers(name, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        get_optimizer(name, OptimizerParams(), [torch.zeros(4)])


# ---------------------------------------------------------------------------
# engine parity with JAX
# ---------------------------------------------------------------------------

OPTIMIZERS = {"lion": {"lr": 1e-3, "weight_decay": 0.01},
              "lamb": {"lr": 1e-2, "weight_decay": 0.01},
              "fusedlamb": {"lr": 1e-2, "weight_decay": 0.01,
                            "betas": [0.9, 0.95], "eps": 1e-6}}


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_training_matches_jax_engine(name, scan_layers):
    """tests/test_torch_training.py's parity run (the debug llama in
    fp32, gas 2, clipping, WarmupDecayLR), with Lion or LAMB."""
    cfg = llama_config(optimizer={"type": name, "params": OPTIMIZERS[name]})
    je = jax_engine(JLlama("debug", dtype=jnp.float32,
                           scan_layers=scan_layers), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32,
                             scan_layers=scan_layers)
    te, opt, _, _ = dtt.initialize(
        model=model, config=cfg, device="cpu",
        model_parameters=from_jax(jax_params(je), model.cfg, device="cpu"))
    assert type(opt) is (tfo.FusedLion if name == "lion" else tfo.FusedLamb)
    losses = []
    for batch in token_batches(5):
        ref = je.train_batch(batch)
        losses.append(te.train_batch(batch))
        np.testing.assert_allclose(losses[-1], ref, rtol=LOSS_RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(),
                                   je.get_global_grad_norm(), rtol=LOSS_RTOL)
    assert te.get_lr() == je.get_lr()
    assert_params_close(to_numpy(te.params), jax_params(je))
