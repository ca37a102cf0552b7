"""The port's checkpoints held against the JAX package's, on the CPU.

A JAX engine trains, saves through Orbax and converts the checkpoint with
its ``ds_to_universal``; the port loads the atoms (``checkpoint.
load_universal``), both take two more steps, then the port saves and
converts with its own ``ds_to_universal`` and the JAX engine loads that
with ``load_universal_into_engine``: two more steps again.  At each
crossing the masters and moments arrive bit for bit, and the atom keys
of the two converters are equal (the optax layout is read from the JAX
checkpoint, not written down by hand here).  The steps after a crossing
are held to tests/test_torch_training.py's limits (losses rtol 1e-4,
masters 1e-4 absolute).  Within the port a resume is bit-equal.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.checkpoint import universal as J_universal
from deepspeed_tpu.checkpoint import zero_to_fp32 as J_z2f
from deepspeed_tpu.models.base import SimpleModel as JSimple
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu_torch.checkpoint import engine as T_engine
from deepspeed_tpu_torch.checkpoint import universal as T_universal
from deepspeed_tpu_torch.checkpoint import zero_to_fp32 as T_z2f
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.tree import tree_leaves
from test_torch_training import (LOSS_RTOL, PARAM_ATOL, jax_engine,
                                 jax_params, llama_config, token_batches)

HIDDEN = 16
#: optimizer -> its params (tests/test_torch_optimizers.py's, AdamW the
#: parity run's)
OPTIMIZERS = {"adamw": {"lr": 1e-2, "weight_decay": 0.01},
              "lion": {"lr": 1e-3, "weight_decay": 0.01},
              "lamb": {"lr": 1e-2, "weight_decay": 0.01}}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _config(opt, stage=0, **over):
    cfg = llama_config(optimizer={"type": opt, "params": OPTIMIZERS[opt]},
                       zero_optimization={"stage": stage},
                       checkpoint={"async_save": False})
    cfg.update(over)
    return cfg


def _models(kind):
    """(JAX model, port model) of one kind, fp32, two layers."""
    if kind == "simple":
        return JSimple(HIDDEN), SimpleModel(HIDDEN)
    return (JLlama("debug", dtype=jnp.float32),
            LlamaForCausalLM("debug", dtype=torch.float32))


def _batches(kind, n, seed=0):
    if kind != "simple":
        return token_batches(n, seed=seed)
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=(4, HIDDEN)).astype(np.float32)
             for k in ("x", "y")} for _ in range(n)]


def _port(model, cfg, params=None):
    params = params if params is not None else model.init_params(0, "cpu")
    engine, *_ = dtt.initialize(model=model, config=cfg,
                                model_parameters=params, device="cpu")
    return engine


def _atoms(udir):
    with np.load(os.path.join(udir, "atoms.npz")) as z:
        return {k: z[k] for k in z.files}


def _port_atoms(engine):
    """The port engine's state as atoms: the same walk ds_to_universal
    makes, read from the live engine."""
    moments, counts = T_universal.OPTAX_LAYOUT[engine.optimizer_kind]
    out = {}
    for path, p in zip(engine.param_paths, engine.masters):
        out[f"params/{path}"] = p.numpy()
        st = engine.optimizer.state[p]
        for name, sub in moments.items():
            out[f"opt_state/{sub}/{path}"] = st[name].numpy()
        for c in counts:
            out[f"opt_state/{c}"] = np.asarray(st["step"], np.int32)
    return out


def _jax_atoms(je):
    out = {f"params/{k}": v for k, v in J_z2f.flatten_state_dict(
        jax_params(je), sep="/").items()}
    out.update({f"opt_state/{k}": v for k, v in J_z2f.flatten_state_dict(
        meta.unbox(je.state.opt_state), sep="/").items()})
    return out


def _assert_atoms_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _steps_agree(te, je, batches):
    for b in batches:
        np.testing.assert_allclose(te.train_batch(b), je.train_batch(b),
                                   rtol=LOSS_RTOL)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(to_numpy(te.params)),
            jax.tree.leaves(jax_params(je))):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))
    assert te.global_steps == je.global_steps


# ---------------------------------------------------------------------------
# JAX -> port -> JAX through universal atoms
# ---------------------------------------------------------------------------

#: (model, optimizer, ZeRO stage): every optimizer at both stages on the
#: MLP; the debug llama (the JAX step costs ~10 s a case) at stage 0,
#: since on one rank stage 3 changes neither package's layout
CROSSINGS = ([("simple", opt, stage) for opt in sorted(OPTIMIZERS)
              for stage in (0, 3)]
             + [("llama", opt, 0) for opt in sorted(OPTIMIZERS)])


@pytest.mark.parametrize("kind,opt,stage", CROSSINGS)
def test_a_checkpoint_crosses_between_the_packages(kind, opt, stage,
                                                   tmp_path):
    jmodel, tmodel = _models(kind)
    cfg = _config(opt, stage)
    je = jax_engine(jmodel, cfg)
    batches = _batches(kind, 7)
    for b in batches[:3]:
        je.train_batch(b)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    je.save_checkpoint(jdir)
    judir = J_universal.ds_to_universal(jdir)

    # JAX -> port: masters, moments and counts arrive bit for bit
    te = _port(tmodel, _config(opt, stage, checkpoint={
        "async_save": False, "load_universal": True}))
    assert te.load_checkpoint(jdir)[0] == jdir
    assert (te.global_steps, te.global_samples, te.micro_steps) == (
        je.global_steps, je.global_samples, je.micro_steps)
    _assert_atoms_equal(_port_atoms(te), _atoms(judir))
    _steps_agree(te, je, batches[3:5])

    # port -> JAX: the port's converter writes the JAX converter's keys,
    # and the JAX engine takes the port's state bit for bit
    te.save_checkpoint(tdir)
    tudir = T_universal.ds_to_universal(tdir)
    assert sorted(_atoms(tudir)) == sorted(_atoms(judir))
    J_universal.load_universal_into_engine(je, tudir)
    _assert_atoms_equal(_jax_atoms(je), _atoms(tudir))
    with open(os.path.join(judir, "universal_meta.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tudir, "universal_meta.json")) as f:
        tmeta = json.load(f)
    assert set(tmeta) == set(jmeta)
    assert tmeta["step"] == tmeta["good_steps"] == 5
    assert (tmeta["loss_scale"], tmeta["skipped_steps"],
            tmeta["hysteresis"]) == (jmeta["loss_scale"],
                                     jmeta["skipped_steps"],
                                     jmeta["hysteresis"])
    # the JAX random stream rides through the port unchanged
    assert tmeta["client_state"]["rng_key_data"] == \
        jmeta["client_state"]["rng_key_data"]
    assert set(tmeta["client_state"]) == set(jmeta["client_state"])
    _steps_agree(te, je, batches[5:7])


def test_universal_load_refuses_another_layout(tmp_path):
    """Strict loads, as in JAX: an atom the engine's layout lacks (AdamW's
    ``nu`` into Lion) or a missing one raises ``KeyError``; another
    model's shape raises ``ValueError``."""
    udirs = {}
    for opt in ("adamw", "lion"):
        te = _port(SimpleModel(HIDDEN), _config(opt))
        te.train_batch(_batches("simple", 1)[0])
        te.save_checkpoint(str(tmp_path / opt))
        udirs[opt] = T_universal.ds_to_universal(str(tmp_path / opt))
    udir = udirs["adamw"]
    lion = _port(SimpleModel(HIDDEN), _config("lion"))
    with pytest.raises(KeyError, match="not in this engine's layout"):
        T_universal.load_universal_into_engine(lion, udir)
    adamw = _port(SimpleModel(HIDDEN), _config("adamw"))
    with pytest.raises(KeyError, match="missing atom 'opt_state/0/nu/"):
        T_universal.load_universal_into_engine(adamw, udirs["lion"])
    wide = _port(SimpleModel(2 * HIDDEN), _config("adamw"))
    with pytest.raises(ValueError, match="different MODEL"):
        T_universal.load_universal_into_engine(wide, udir)
    # weights only: the masters load, the optimizer stays fresh
    T_universal.load_universal_into_engine(lion, udir, strict=False,
                                           load_optimizer_states=False)
    with np.load(os.path.join(udir, "atoms.npz")) as z:
        for path, p in zip(lion.param_paths, lion.masters):
            np.testing.assert_array_equal(p.numpy(), z[f"params/{path}"])
    assert not lion.optimizer.state and lion.global_steps == 1


# ---------------------------------------------------------------------------
# port -> port
# ---------------------------------------------------------------------------

def _state(engine):
    return ([p.clone() for p in engine.masters],
            [{k: (v.clone() if torch.is_tensor(v) else v)
              for k, v in engine.optimizer.state[p].items()}
             for p in engine.masters])


def _assert_same_state(a, b):
    (ma, oa), (mb, ob) = _state(a), _state(b)
    for x, y in zip(ma, mb):
        assert torch.equal(x, y)
    for x, y in zip(oa, ob):
        assert x.keys() == y.keys()
        for k in x:
            assert (torch.equal(x[k], y[k]) if torch.is_tensor(x[k])
                    else x[k] == y[k])


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_resume_is_bit_equal(opt, async_save, tmp_path):
    """4 steps straight against 2, a save, a fresh engine's load and 2
    more; the async save's writer runs while the saving engine takes its
    next steps (``save_latest=False``), and its copy is the pre-step
    state."""
    cfg = _config(opt, checkpoint={"async_save": async_save})
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    batches = _batches("llama", 4)
    straight = _port(model, cfg)
    ref = [straight.train_batch(b) for b in batches]
    a = _port(model, cfg)
    losses = [a.train_batch(b) for b in batches[:2]]
    a.save_checkpoint(str(tmp_path), save_latest=False)
    assert [a.train_batch(b) for b in batches[2:]] == ref[2:]
    a.checkpoint_engine.wait()
    a.checkpoint_engine.write_latest(str(tmp_path), "global_step2")
    b = _port(model, cfg)
    tag, client = b.load_checkpoint(str(tmp_path))
    assert tag == "global_step2" and client["global_steps"] == 2
    assert b._params_c is None and all(not p.grad.any() for p in b.masters)
    losses += [b.train_batch(x) for x in batches[2:]]
    assert losses == ref
    _assert_same_state(b, straight)
    assert (b.global_steps, b.global_samples, b.micro_steps,
            b.lr_scheduler.last_batch_iteration) == (4, 16, 8, 4)


def test_async_saves_hold_the_state_of_their_call(tmp_path):
    """A save per step, each written by the async writer while the next
    steps update the masters in place, with the interpreter switching
    threads every microsecond: every tag holds the masters and moments
    of the moment its save was called.  A writer's error is raised by
    the next ``wait()``."""
    te = _port(SimpleModel(HIDDEN), _config("adamw", checkpoint={
        "async_save": True}))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    want = {}
    try:
        for i, b in enumerate(_batches("simple", 6)):
            te.train_batch(b)
            want[f"t{i}"] = [t.clone() for t in _state(te)[0]]
            te.save_checkpoint(str(tmp_path), tag=f"t{i}", save_latest=False)
        te.checkpoint_engine.wait()
    finally:
        sys.setswitchinterval(switch)
    assert te.checkpoint_engine._thread is None
    for tag, masters in want.items():
        state, _, _ = T_engine.read_checkpoint(str(tmp_path), tag)
        for a, b in zip(tree_leaves(state["module"]), masters):
            assert torch.equal(a, b), tag
    ck = te.checkpoint_engine
    ck.save(str(tmp_path / "x"), "bad", {   # a lambda does not pickle
        "module": te.params, "optimizer": "adamw",
        "optimizer_state_dict": lambda: 0}, {})
    with pytest.raises((AttributeError, pickle.PicklingError)):
        ck.wait()
    ck.wait()                       # reported once, then clear


def test_load_copies_into_the_engine_tensors(tmp_path):
    """A load overwrites the masters and moments in place: the optimizer
    keeps its parameters, the tree its leaves, and a compute copy cast
    before the load is dropped."""
    cfg = _config("adamw")
    model = SimpleModel(HIDDEN)
    batches = _batches("simple", 3)
    a = _port(model, cfg)
    a.train_batch(batches[0])
    a.save_checkpoint(str(tmp_path), tag="one")
    b = _port(model, cfg)
    b.train_batch(batches[1])
    b.train_batch(batches[2])
    ids = [id(p) for p in b.masters]
    moment = b.optimizer.state[b.masters[0]]["exp_avg"]
    b.forward(batches[0])            # casts a compute copy of the old masters
    b.load_checkpoint(str(tmp_path), tag="one")
    assert [id(p) for p in b.masters] == ids
    assert [id(p) for p in b.optimizer.param_groups[0]["params"]] == ids
    assert b.optimizer.state[b.masters[0]]["exp_avg"] is moment
    _assert_same_state(b, a)
    assert b.train_batch(batches[1]) == a.train_batch(batches[1])


@pytest.mark.parametrize("how", [{"load_module_only": True},
                                 {"load_optimizer_states": False}])
def test_weights_only_load_starts_a_fresh_optimizer(how, tmp_path):
    """Only the masters load; the optimizer (and the LR schedule, which
    reads its count, as JAX's reads optax's) starts fresh, as an engine
    built from those weights; the counters come from the checkpoint, as
    in JAX."""
    cfg = _config("adamw")
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    batches = _batches("llama", 4)
    a = _port(model, cfg)
    for x in batches[:2]:
        a.train_batch(x)
    a.save_checkpoint(str(tmp_path))
    fresh = _port(model, cfg, params=a.params)
    b = _port(model, cfg)
    b.load_checkpoint(str(tmp_path), **how)
    assert not b.optimizer.state and b.global_steps == 2
    assert [b.train_batch(x) for x in batches[2:]] == \
        [fresh.train_batch(x) for x in batches[2:]]
    for x, y in zip(b.masters, fresh.masters):
        assert torch.equal(x, y)


def test_files_load_with_weights_only(tmp_path):
    """The reference DeepSpeed's file names; each loads with
    ``torch.load(weights_only=True)``; ``latest`` is written atomically
    and last; client_state.json holds the JAX engine's keys."""
    te = _port(SimpleModel(HIDDEN), _config("lamb"))
    te.train_batch(_batches("simple", 1)[0])
    te.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    tag_dir = tmp_path / "global_step1"
    assert sorted(os.listdir(tag_dir)) == sorted([
        T_engine.CLIENT_FILE, "mp_rank_00_model_states.pt",
        "zero_pp_rank_0_mp_rank_00_optim_states.pt"])
    assert (tmp_path / "latest").read_text() == "global_step1"
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    model = torch.load(tag_dir / T_engine.MODEL_FILE, weights_only=True)
    optim = torch.load(tag_dir / T_engine.OPTIM_FILE, weights_only=True)
    assert list(model["module"]) == ["layer_0", "layer_1"]
    assert torch.equal(model["module"]["layer_1"]["w"],
                       te.params["layer_1"]["w"])
    assert optim["optimizer"] == "lamb"
    assert set(optim["optimizer_state_dict"]["state"][0]) == {
        "step", "exp_avg", "exp_avg_sq"}
    client = json.loads((tag_dir / T_engine.CLIENT_FILE).read_text())
    assert set(client) == {"epoch", "global_steps", "global_samples",
                           "micro_steps", "lr_scheduler", "pipe_stages"}


# ---------------------------------------------------------------------------
# the offline tools
# ---------------------------------------------------------------------------

def test_offline_tools_match_the_jax_tools(tmp_path, capsys):
    """zero_to_fp32 gives the JAX tool's keys and values from the same
    weights, the CLI writes them, and save_16bit_model's files are bit
    for bit the JAX engine's."""
    cfg = _config("adamw")
    je = jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    te = _port(model, cfg, params=from_jax(jax_params(je), model.cfg,
                                           device="cpu"))
    je.save_checkpoint(str(tmp_path / "jax"))
    te.save_checkpoint(str(tmp_path / "port"))
    want = J_z2f.flatten_state_dict(
        J_z2f.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "jax")))
    got_tree = T_z2f.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "port"))
    got = T_z2f.flatten_state_dict(got_tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    live = te.get_fp32_state_dict()
    for a, b in zip(jax.tree.leaves(live), jax.tree.leaves(got_tree)):
        np.testing.assert_array_equal(a, b)
    out = str(tmp_path / "fp32.npz")
    assert T_z2f.main([str(tmp_path / "port"), out]) == 0
    assert "tensors" in capsys.readouterr().out
    with np.load(out) as z:
        assert list(z.files) == list(want)
    jpath = je.save_16bit_model(str(tmp_path / "j16"))
    tpath = te.save_16bit_model(str(tmp_path / "t16"))
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert list(tz.files) == list(jz.files)
        for k in jz.files:
            assert tz[k].dtype == np.uint16
            np.testing.assert_array_equal(tz[k], jz[k], err_msg=k)
    with open(jpath + ".dtypes.json") as f, open(tpath + ".dtypes.json") as g:
        assert json.load(f) == json.load(g)
