"""Every optimizer name of the JAX factory, held against the JAX package
on the CPU: the port's optimizer classes against the optax transforms
JAX ``get_optimizer`` builds (the same seeded leaves and gradients, 3
updates, fp32, rtol 1e-5 / atol 1e-7), and the training engine against
the one-device JAX engine for each name the JAX engine builds (the
debug llama; losses rtol 1e-5, params as ``tests/test_torch_training.py``
holds them, but for the 1-bit family's absolute bound, 2e-4: under
WarmupLR its lr, read at the 1-based count, is larger from the first
update, and a gradient element at rounding level can take either sign
through Adam's normalisation, moving its weight by up to 2 lr; measured
1.4e-4 on one element of 22528, rms relative 5.7e-5).  The 1-bit family
runs under WarmupLR, so a learning rate read at the wrong count shows,
and with ``freeze_step`` 2 through the functions, so the compression
phase runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.runtime import optimizers as jopt
from deepspeed_tpu.runtime.comm import compressed as jcomp
from deepspeed_tpu.runtime.config import OptimizerParams as JParams
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime import optimizers as topt
from deepspeed_tpu_torch.runtime.comm import compressed as tcomp
from deepspeed_tpu_torch.runtime.config import OptimizerParams
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from test_torch_training import (assert_params_close, jax_engine, jax_params,
                                 llama_config, token_batches)

RTOL, ATOL = 1e-5, 1e-7
LOSS_RTOL = 1e-5
#: leaves of the shapes a scanned model has: a stacked [L, in, out]
#: weight with two dims >= 128 (Adafactor factors it), a 2-D embedding
#: (Muon orthogonalises it, wider than tall and taller than wide), a
#: small 2-D leaf (Adafactor keeps it whole) and a norm scale
SHAPES = {"embed": (160, 136), "head": (136, 200),
          "layers/w": (2, 136, 144), "small": (8, 12), "norm": (136,)}
WARMUP = {"warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
          "warmup_num_steps": 3}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 0.1 * (i + 1)).astype(np.float32)
              for k, s in SHAPES.items()} for i in range(3)]
    return params, grads


def _run_pair(tx, opt_factory, schedule=None):
    """3 updates of an optax transform and the port's optimizer from the
    same leaves; returns both parameter trees."""
    params, grads = _leaves()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = opt_factory(list(tp.values()))
    for k, g in enumerate(grads):
        updates, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        if schedule is not None:
            lr = schedule(k + type(opt).lr_count_offset)
            for group in opt.param_groups:
                group["lr"] = lr
        opt.step(grads=[torch.from_numpy(g[n]) for n in tp])
    return jp, tp


def _assert_trees(jp, tp):
    for name in SHAPES:
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


# (name, params) of every name of JAX get_optimizer the port runs with
# torch ops; AdamW, Lion and LAMB are tests/test_torch_optimizers.py's
FACTORY = [
    ("sgd", {"lr": 1e-2}),
    ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    ("adagrad", {"lr": 1e-2}),
    ("cpuadagrad", {"lr": 1e-2, "eps": 1e-6}),
    ("adafactor", {"lr": 1e-2}),
    ("muon", {"lr": 1e-2}),
    ("adam", {"lr": 1e-2, "adam_w_mode": False, "weight_decay": 0.1}),
    ("fusedadam", {"lr": 1e-2, "adam_w_mode": False}),
]


@pytest.mark.parametrize("name,params", FACTORY)
def test_optimizer_matches_optax(name, params):
    """Each name's update against the optax transform JAX builds for it,
    at a constant lr."""
    tx = jopt.get_optimizer(name, JParams(**params))
    jp, tp = _run_pair(tx, lambda ps: topt.get_optimizer(
        name, OptimizerParams(**params), ps))
    _assert_trees(jp, tp)


@pytest.mark.parametrize("name", ["onebitadam", "zerooneadam", "onebitlamb"])
@pytest.mark.parametrize("freeze_step", [100, 2])
def test_onebit_matches_jax_under_warmup(name, freeze_step):
    """The 1-bit family through JAX ``onebit_optimizer`` with WarmupLR (lr
    read at the 1-based count) and ``freeze_step`` 2 (updates 3 on are
    compressed, the variance frozen)."""
    sched = get_lr_schedule("WarmupLR", WARMUP, 1e-2)
    tx = jcomp.onebit_optimizer(name, sched, weight_decay=0.01,
                                freeze_step=freeze_step)
    jp, tp = _run_pair(tx, lambda ps: tcomp.onebit_optimizer(
        name, ps, 1e-2, weight_decay=0.01, freeze_step=freeze_step), sched)
    _assert_trees(jp, tp)


def test_sign_compress_matches_jax():
    x = np.random.default_rng(3).normal(size=(7, 9)).astype(np.float32)
    jq, je = jcomp._sign_compress({"x": jnp.asarray(x)})
    tq, te = tcomp._sign_compress(torch.from_numpy(x))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq["x"]), rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je["x"]), rtol=1e-6,
                               atol=1e-7)


def test_muon_orthogonalises_only_two_dim_leaves():
    """optax.contrib.muon labels a leaf 'muon' only at ndim 2: a stacked
    [L, in, out] layer weight takes Adam (kept for parity)."""
    opt = topt.get_optimizer("muon", OptimizerParams(lr=1e-2),
                             [torch.zeros(SHAPES[n]) for n in SHAPES])
    opt.step(grads=[torch.ones(SHAPES[n]) for n in SHAPES])
    assert [("exp_avg_sq" in st) for st in opt.state.values()] == \
        [len(SHAPES[n]) != 2 for n in SHAPES]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

ENGINE = [
    ("sgd", {"lr": 1e-2, "momentum": 0.9}, None),
    ("adagrad", {"lr": 1e-2}, None),
    ("adam", {"lr": 1e-2, "adam_w_mode": False, "weight_decay": 0.01}, None),
    ("onebitadam", {"lr": 1e-2}, WARMUP),
    ("onebitlamb", {"lr": 1e-2}, WARMUP),
    ("zerooneadam", {"lr": 1e-2, "weight_decay": 0.01}, WARMUP),
]


@pytest.mark.parametrize("name,params,warmup", ENGINE)
def test_engine_matches_jax_engine(name, params, warmup):
    over = {"optimizer": {"type": name, "params": params}}
    if warmup:
        over["scheduler"] = {"type": "WarmupLR", "params": warmup}
    cfg = llama_config(**over)
    je = jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    te, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                            model_parameters=from_jax(jax_params(je),
                                                      model.cfg, device="cpu"))
    for batch in token_batches(3):
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=LOSS_RTOL)
    assert te.get_lr() == pytest.approx(je.get_lr())
    if warmup:
        for a, b in zip(jax.tree.leaves(to_numpy(te.params)),
                        jax.tree.leaves(jax_params(je))):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4)
            assert np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)) <= 1e-4
    else:
        assert_params_close(to_numpy(te.params), jax_params(je))


@pytest.mark.parametrize("name", ["muon", "adafactor"])
def test_engine_refuses_what_the_jax_engine_refuses(name):
    """The JAX engine cannot place Muon's partitioned state or
    Adafactor's factored statistics beside the transformer's parameter
    shardings and raises ValueError at build; the port raises the same
    type (the optimizers themselves run, held to optax above)."""
    cfg = llama_config(optimizer={"type": name, "params": {"lr": 1e-2}})
    with pytest.raises(ValueError):
        jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    with pytest.raises(ValueError, match=name):
        dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                       config=cfg, device="cpu")


def test_unknown_optimizer_raises_value_error_as_in_jax():
    with pytest.raises(ValueError, match="unsupported optimizer"):
        jopt.get_optimizer("adamax", JParams())
    with pytest.raises(ValueError, match="unsupported optimizer"):
        dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                       config=llama_config(optimizer={"type": "adamax"}),
                       device="cpu")


# ---------------------------------------------------------------------------
# the new optimizers' state through universal atoms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,params", [
    ("sgd", {"lr": 1e-2}), ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    ("adagrad", {"lr": 1e-2}), ("adafactor", {"lr": 1e-2}),
    ("adam", {"lr": 1e-2, "adam_w_mode": False, "weight_decay": 0.01}),
    ("onebitlamb", {"lr": 1e-2})])
def test_optimizer_state_crosses_universal_atoms(name, params, tmp_path):
    """The MLP (the one model the JAX engine trains under Adafactor): 2
    JAX steps, JAX's universal atoms into the port (strict), the port's
    own atoms equal to them bit for bit; then the port's atoms into the
    JAX engine (strict) and one more step in each, equal."""
    from deepspeed_tpu.checkpoint import universal as J_universal
    from deepspeed_tpu.models.base import SimpleModel as JSimple
    from deepspeed_tpu_torch.checkpoint import universal as T_universal
    from deepspeed_tpu_torch.models.base import SimpleModel
    from test_torch_checkpoint import _atoms
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "bf16": {"enabled": False},
           "optimizer": {"type": name, "params": params},
           "checkpoint": {"async_save": False}}
    je = jax_engine(JSimple(16), cfg)
    rng = np.random.default_rng(0)
    batches = [{k: rng.normal(size=(4, 16)).astype(np.float32)
                for k in ("x", "y")} for _ in range(3)]
    for b in batches[:2]:
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path / "jax"))
    judir = J_universal.ds_to_universal(str(tmp_path / "jax"))
    te, *_ = dtt.initialize(model=SimpleModel(16), config=dict(
        cfg, checkpoint={"async_save": False, "load_universal": True}),
        device="cpu")
    te.load_checkpoint(judir)
    te.save_checkpoint(str(tmp_path / "port"))
    tudir = T_universal.ds_to_universal(str(tmp_path / "port"))
    jatoms, tatoms = _atoms(judir), _atoms(tudir)
    assert sorted(tatoms) == sorted(jatoms)
    for k in jatoms:
        np.testing.assert_array_equal(tatoms[k], jatoms[k], err_msg=k)
    je2 = jax_engine(JSimple(16), cfg)
    J_universal.load_universal_into_engine(je2, tudir)
    np.testing.assert_allclose(te.train_batch(batches[2]),
                               je2.train_batch(batches[2]), rtol=1e-5)
