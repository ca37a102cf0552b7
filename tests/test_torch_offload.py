"""ZeRO-Offload in the port held against the JAX package, on the CPU.

A counterpart of each test of ``tests/test_offload.py`` runs the port's
engine (``device="cpu"``), and the engines are held to each other: the
JAX engine over one device and the port's over the same initial weights
(bridged as numpy) train on the same batches with the optimizer
offloaded.  Both host steps run the same C++ source, so what parts them
is the fp32 summation order of the gradients: losses rtol 1e-4 and
masters 1e-4 absolute (measured: losses <= 7.3e-7 relative, masters
<= 2.1e-5 on the debug llama, <= 4.3e-6 on the MLP).
Within the port, NVMe against cpu offload and a checkpoint round trip
are bit-equal.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.base import SimpleModel as JSimple
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.runtime.config import load_config as j_load_config
from deepspeed_tpu.runtime.engine import _topology_from_config
from deepspeed_tpu.runtime.zero.offload import \
    HostOffloadOptimizer as JHostOffload
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime.config import load_config
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffloadOptimizer,
                                                      flatten_sorted)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _config(offload_device="cpu", ratio=1.0, nvme_path=None, stage=1,
            opt_type="adamw", **over):
    off = {"device": offload_device, "ratio": ratio}
    if nvme_path:
        off["nvme_path"] = str(nvme_path)
    cfg = {
        "train_micro_batch_size_per_gpu": 4,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": opt_type,
                      "params": {"lr": 1e-2, "weight_decay": 0.01}},
        "zero_optimization": {"stage": stage, "offload_optimizer": off},
        "checkpoint": {"async_save": False},
    }
    cfg.update(over)
    return cfg


def _device_config():
    cfg = _config()
    cfg["zero_optimization"].pop("offload_optimizer")
    return cfg


def _data(n=4, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, d)).astype(np.float32),
            "y": rng.normal(size=(n, d)).astype(np.float32)}


def _engine(cfg, d=32, model=None):
    model = model or SimpleModel(d)
    params = model.init_params(seed=0, device="cpu")
    engine, *_ = dtt.initialize(model=model, config=cfg,
                                model_parameters=params, device="cpu")
    return engine


def _train(engine, batch, steps=5):
    return [float(engine.train_batch(batch)) for _ in range(steps)]


def _fp32(engine):
    return [leaf for _, leaf in flatten_sorted(engine.get_fp32_state_dict())]


def _jax_engine(model, cfg):
    topo = _topology_from_config(j_load_config(cfg),
                                 devices=jax.devices()[:1])
    engine, *_ = dst.initialize(model=model, config=cfg, topology=topo)
    return engine


def _jax_masters(je):
    """The JAX engine's fp32 weights in flatten order: the host masters
    of offloaded leaves, the device masters of the others."""
    flat = [np.asarray(x, np.float32)
            for x in jax.tree.leaves(meta.unbox(je.state.params))]
    for k, i in enumerate(je.offload.offload_idx):
        flat[i] = je.offload.masters[k].reshape(flat[i].shape)
    return flat


# ---------------------------------------------------------------------------
# counterparts of tests/test_offload.py
# ---------------------------------------------------------------------------

def test_cpu_offload_matches_device_path():
    batch = _data()
    ref_losses = _train(_engine(_device_config()), batch)
    off_engine = _engine(_config("cpu"))
    off_losses = _train(off_engine, batch)
    assert off_engine.offload is not None
    assert len(off_engine.offload.offload_idx) > 0
    # the host C++ AdamW tracks the device AdamW kernel (JAX's limits)
    np.testing.assert_allclose(off_losses, ref_losses, rtol=2e-3, atol=2e-4)


def test_offload_moments_not_on_device():
    engine = _engine(_config("cpu"), d=16)
    # full offload: no device optimizer, so no device moments
    assert engine.optimizer is None
    for p, off in zip(engine.masters, engine._offloaded):
        assert off and p.dtype == engine.compute_dtype
    n_host = sum(m.size for m in engine.offload.masters)
    assert n_host == sum(p.numel() for p in engine.masters)
    _train(engine, _data(d=16), steps=1)
    assert set(engine.offload.host_opt._state) == \
        set(range(len(engine.offload.offload_idx)))


@pytest.mark.parametrize("ratio", [0.3, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("model", ["simple", "llama"])
def test_partial_offload_picks_the_leaves_jax_picks(model, ratio):
    """Largest first until the ratio, ties in flatten order: the debug
    llama's stacked leaves differ in size, four of them at 8192."""
    cfg = _config("cpu", ratio=ratio)
    if model == "simple":
        jmodel, tmodel = JSimple(32), SimpleModel(32)
    else:
        jmodel = JLlama("debug", dtype=jnp.float32)
        tmodel = LlamaForCausalLM("debug", dtype=torch.float32)
    abstract = jax.eval_shape(
        lambda: meta.unbox(jmodel.init_params(jax.random.key(0))))
    ref = JHostOffload(abstract, j_load_config(cfg))
    got = HostOffloadOptimizer(tmodel.init_params(0, "cpu"),
                               load_config(cfg))
    assert got.offload_idx == ref.offload_idx
    jpaths = ["/".join(str(getattr(k, "key", k)) for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(abstract)]
    assert got.offload_paths == [jpaths[i] for i in ref.offload_idx]
    assert got.device_mask() == jax.tree.leaves(ref.device_mask())
    if ratio < 1.0:
        n_off = sum(int(np.prod(got._flat[i].shape))
                    for i in got.offload_idx)
        n_all = sum(int(np.prod(leaf.shape)) for leaf in got._flat)
        assert ratio * n_all <= n_off < n_all


def test_partial_offload_ratio_trains():
    engine = _engine(_config("cpu", ratio=0.5))
    assert engine.optimizer is not None
    assert 0 < len(engine.offload.offload_idx) < len(engine.masters)
    losses = _train(engine, _data())
    assert losses[-1] < losses[0]


def test_nvme_offload_trains(tmp_path):
    engine = _engine(_config("nvme", nvme_path=tmp_path / "swap"))
    losses = _train(engine, _data())
    assert losses[-1] < losses[0]
    # the states live on disk, not in RAM
    assert engine.offload.swapper is not None
    assert len(engine.offload.host_opt._state) == 0
    files = glob.glob(str(tmp_path / "swap" / "rank0" / "*.bin"))
    assert len(files) == 2 * len(engine.offload.offload_idx)  # m + v


@pytest.mark.parametrize("opt_type", ["adamw", "lion"])
def test_nvme_is_bit_equal_to_cpu_offload(tmp_path, opt_type):
    batch = _data(d=24)
    cpu = _engine(_config("cpu", opt_type=opt_type), d=24)
    nvme = _engine(_config("nvme", nvme_path=tmp_path / "swap",
                           opt_type=opt_type), d=24)
    assert _train(nvme, batch, steps=4) == _train(cpu, batch, steps=4)
    for a, b in zip(_fp32(nvme), _fp32(cpu)):
        np.testing.assert_array_equal(a, b)
    assert nvme.offload_times["nvme_wait"] >= 0.0


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_checkpoint_round_trip_is_bit_equal(tmp_path, device):
    batch = _data(d=16)
    cfg = _config(device, nvme_path=tmp_path / "swap", ratio=0.5)
    engine = _engine(cfg, d=16)
    _train(engine, batch, steps=3)
    engine.save_checkpoint(str(tmp_path / "ck"), tag="t")
    assert os.path.exists(tmp_path / "ck" / "t" / "offload_rank0.npz")
    continued = _train(engine, batch, steps=2)
    cfg2 = _config(device, nvme_path=tmp_path / "swap2", ratio=0.5)
    engine2 = _engine(cfg2, d=16)
    engine2.load_checkpoint(str(tmp_path / "ck"), tag="t")
    assert _train(engine2, batch, steps=2) == continued
    for a, b in zip(_fp32(engine2), _fp32(engine)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_lion(tmp_path, device):
    engine = _engine(_config(device, nvme_path=tmp_path / "swap",
                             opt_type="lion"), d=16)
    losses = _train(engine, _data(d=16), steps=4)
    assert losses[-1] < losses[0]


def test_module_only_load_resyncs_masters(tmp_path):
    batch = _data(d=16)
    engine = _engine(_config("cpu"), d=16)
    _train(engine, batch, steps=3)
    trained_loss = engine.eval_batch(batch)
    engine.save_checkpoint(str(tmp_path / "ck"), tag="t")
    engine2 = _engine(_config("cpu"), d=16)
    engine2.load_checkpoint(str(tmp_path / "ck"), tag="t",
                            load_module_only=True)
    # the host masters hold the loaded weights, not the init-era ones
    for m, path in zip(engine2.offload.masters,
                       engine2.offload.offload_paths):
        p = engine.masters[engine.param_paths.index(path)]
        np.testing.assert_array_equal(m, p.float().reshape(-1).numpy())
    engine2.train_batch(batch)
    assert engine2.eval_batch(batch) < trained_loss * 1.5


def test_offload_rejects_unsupported_optimizer_with_jax_message():
    with pytest.raises(ValueError) as ref:
        dst.initialize(model=JSimple(16), config=_config("cpu",
                                                         opt_type="lamb"))
    with pytest.raises(ValueError) as got:
        _engine(_config("cpu", opt_type="lamb"), d=16)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the port against the JAX engine
# ---------------------------------------------------------------------------

def _llama_cfg(**kw):
    """``tests/test_torch_training.py``'s llama config (its warm-up keeps
    Adam's first steps, which normalise near-zero gradients to about lr,
    from turning a summation-order difference into a whole step)."""
    return _config(train_micro_batch_size_per_gpu=2,
                   gradient_accumulation_steps=2, gradient_clipping=1.0,
                   bf16={"enabled": False},
                   scheduler={"type": "WarmupDecayLR", "params": {
                       "total_num_steps": 10, "warmup_num_steps": 3,
                       "warmup_min_lr": 1e-3}}, **kw)


def _bridged_engine(je, tmodel, cfg):
    """The port engine over the JAX engine's initial weights: its device
    params, and for offloaded leaves its fp32 host masters."""
    init = jax.tree.map(np.asarray, meta.unbox(je.state.params))
    if isinstance(tmodel, LlamaForCausalLM):
        params = from_jax(init, tmodel.cfg, device="cpu")
    else:
        params = jax.tree.map(lambda a: torch.from_numpy(
            np.asarray(a, np.float32).copy()), init)
    flat = jax.tree.leaves(params)      # dict keys sorted: flatten order
    for k, i in enumerate(je.offload.offload_idx):
        flat[i].copy_(torch.from_numpy(np.array(
            je.offload.masters[k]).reshape(tuple(flat[i].shape))))
    te, *_ = dtt.initialize(model=tmodel, config=cfg,
                            model_parameters=params, device="cpu")
    assert te.offload.offload_idx == je.offload.offload_idx
    return te


@pytest.mark.parametrize("case", ["simple_cpu_bf16", "simple_nvme_lion",
                                  "llama_cpu_half"])
def test_offload_engine_matches_the_jax_engine(tmp_path, case):
    """Same config and weights, 4 steps: losses and every fp32 master
    (host masters of offloaded leaves) within the stated tolerance."""
    if case == "simple_cpu_bf16":
        cfg = _config("cpu")
        jmodel, tmodel = JSimple(32), SimpleModel(32)
        batches = [_data(d=32, seed=s) for s in range(4)]
    elif case == "simple_nvme_lion":
        cfg = _config("nvme", nvme_path=tmp_path / "swap", opt_type="lion",
                      bf16={"enabled": False})
        jmodel, tmodel = JSimple(32), SimpleModel(32)
        batches = [_data(d=32, seed=s) for s in range(4)]
    else:
        cfg = _llama_cfg(ratio=0.5)
        jmodel = JLlama("debug", dtype=jnp.float32)
        tmodel = LlamaForCausalLM("debug", dtype=torch.float32)
        rng = np.random.default_rng(0)
        batches = [{"input_ids": rng.integers(0, 128, (4, 32)).astype(
            np.int32)} for _ in range(4)]
    je = _jax_engine(jmodel, cfg)
    te = _bridged_engine(je, tmodel, cfg)
    for batch in batches:
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=LOSS_RTOL)
    for a, b in zip(_fp32(te), _jax_masters(je)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_offload_npz_crosses_between_the_packages(tmp_path):
    """A JAX ``offload_rank0.npz`` loads into the port's host optimizer
    and the port's npz into JAX's, bit for bit."""
    cfg = _config("cpu", ratio=0.6)
    je = _jax_engine(JSimple(16), cfg)
    for s in range(2):
        je.train_batch(_data(d=16, seed=s))
    jpath = str(tmp_path / "jax.npz")
    je.offload.save_npz(jpath)
    te = _engine(cfg, d=16)
    assert te.offload.offload_idx == je.offload.offload_idx
    te.offload.load_npz(jpath)
    jsd, tsd = je.offload.state_dict(), te.offload.state_dict()
    assert tsd["steps"] == jsd["steps"] == {0: 2, 1: 2}
    for a, b in zip(tsd["masters"], jsd["masters"]):
        np.testing.assert_array_equal(a, b)
    tpath = str(tmp_path / "port.npz")
    te.offload.save_npz(tpath)
    je2 = _jax_engine(JSimple(16), cfg)
    je2.offload.load_npz(tpath)
    back = je2.offload.state_dict()
    assert back["steps"] == jsd["steps"]
    for k in jsd["state"]:
        for slot in jsd["state"][k]:
            np.testing.assert_array_equal(back["state"][k][slot],
                                          jsd["state"][k][slot])
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)


def test_full_offload_has_no_device_optimizer_and_the_schedule_advances():
    cfg = _config("cpu", scheduler={"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
        "warmup_num_steps": 4, "warmup_type": "linear"}})
    je = _jax_engine(JSimple(16), cfg)
    te = _bridged_engine(je, SimpleModel(16), cfg)
    assert te.optimizer is None
    for s in range(3):
        batch = _data(d=16, seed=s)
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=LOSS_RTOL)
        assert te._update_count() == s + 1
        assert te.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)
    assert te.get_lr()[0] > 0


def test_offload_universal_atoms_are_jax_atoms(tmp_path):
    """``ds_to_universal`` of an offload checkpoint writes JAX's atom
    keys: the masked optax layout, the offloaded leaves' compute copies
    and no moments for them (JAX reads the engine state, not the npz);
    the atoms load back into a port offload engine."""
    from deepspeed_tpu.checkpoint import ds_to_universal as j_universal
    from deepspeed_tpu_torch.checkpoint.universal import (
        ds_to_universal, load_universal_into_engine)
    cfg = _config("cpu", ratio=0.6)
    je = _jax_engine(JSimple(16), cfg)
    te = _engine(cfg, d=16)
    for s in range(2):
        je.train_batch(_data(d=16, seed=s))
        te.train_batch(_data(d=16, seed=s))
    je.save_checkpoint(str(tmp_path / "j"), tag="t")
    te.save_checkpoint(str(tmp_path / "t"), tag="t")
    with np.load(os.path.join(j_universal(str(tmp_path / "j")),
                              "atoms.npz")) as z:
        jkeys = {k: z[k].shape for k in z.files}
    udir = ds_to_universal(str(tmp_path / "t"))
    with np.load(os.path.join(udir, "atoms.npz")) as z:
        tkeys = {k: z[k].shape for k in z.files}
        for k in te.offload.offload_paths:
            np.testing.assert_array_equal(
                z[f"params/{k}"],
                te.masters[te.param_paths.index(k)].float().numpy())
    assert tkeys == jkeys
    fresh = _engine(cfg, d=16)
    load_universal_into_engine(fresh, udir)
    batch = _data(d=16, seed=9)
    assert fresh.eval_batch(batch) == te.eval_batch(batch)
