"""fp16 with loss scaling and pure bf16 in the port's engine, held
against the JAX engine on the CPU.

fp16 (JAX ``engine.py:178-186, :678-822``): fp32 masters, bf16 compute,
the loss scaled before the backward and the gradients divided by ``gas *
scale``; a non-finite gradient norm skips the update and, with a
dynamic scale, moves hysteresis and the scale.  The debug llama (fp32
weights, computed in bf16 as JAX computes fp16) starts at ``2 ** 124``,
so the first steps overflow and the scale walks down by JAX's rule; at
every step the scale, hysteresis, ``skipped_steps`` and
``was_step_applied`` are JAX's exactly, a skipped step leaves masters,
moments and counts bit-equal, and the losses (inf on an overflow of the
scaled loss, as JAX reports them) and masters are held at the bf16
compute's bar (:func:`_assert_fp16_masters`).  With ZeRO-Offload the
host step is skipped with the device step.  The fp16 state crosses
universal checkpoints both ways.

Pure bf16 (``bf16.master_weights`` / ``accumulate_grads_in_fp32``
false): bf16 masters and / or bf16 accumulators under AdamW, Lion and
LAMB (the fused kernels' bf16 instances on the card, their plain
versions here), every mix on the JAX tests' two-layer MLP and one on
the debug llama.  JAX rounds after each bf16 operation and the port once
per output, so the bar is bf16's: losses rtol 2e-4 (measured 6e-5) and
masters within 2 ulp of bf16 at the weights' scale, 8e-3 absolute
(measured 3.9e-3: one ulp of a weight near 1, as Lion moves a weight by
lr each step).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.checkpoint import universal as J_universal
from deepspeed_tpu.models.base import SimpleModel as JSimple
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.ops import fused_optimizer as jfo
from deepspeed_tpu_torch.checkpoint import universal as T_universal
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.base import SimpleModel, random_dataset
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
from deepspeed_tpu_torch.telemetry import metrics as tm
from deepspeed_tpu_torch.telemetry.state import state as telemetry_state
from test_torch_offload import _bridged_engine, _fp32, _jax_masters
from test_torch_training import (jax_engine, jax_params, llama_config,
                                 token_batches)

HIDDEN = 64
BF16_LOSS_RTOL = 2e-4
BF16_PARAM_ATOL = 8e-3
FP16_PARAM_ATOL = 2e-2
FP16_PARAM_RMS_REL = 1e-2
#: the fp16 runs' initial scale power: ``2 ** 124`` overflows the debug
#: llama's gradients until the scale is below about ``2 ** 121``
POWER = 124


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _fp16_config(**fp16):
    cfg = llama_config(fp16={"enabled": True, **fp16})
    cfg.pop("bf16")
    return cfg


def _pair(cfg, **model_kw):
    je = jax_engine(JLlama("debug", dtype=jnp.float32, **model_kw), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32, **model_kw)
    te, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                            model_parameters=from_jax(jax_params(je),
                                                      model.cfg, device="cpu"))
    return je, te


def _state(te):
    """Masters, moments and counts of the port engine, copied."""
    return ([p.clone() for p in te.masters],
            {i: {k: (v.clone() if torch.is_tensor(v) else v)
                 for k, v in st.items()}
             for i, st in enumerate(te.optimizer.state.values())})


def _same_state(a, b):
    (pa, sa), (pb, sb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert (torch.equal(sa[i][k], sb[i][k]) if torch.is_tensor(
                sa[i][k]) else sa[i][k] == sb[i][k]), (i, k)


def _assert_fp16_masters(port, ref):
    """fp16 computes in bf16 in both packages, which round its products
    apart; a gradient element at that rounding level can take either
    sign through Adam's normalisation, moving its weight by up to 2 lr
    (2e-2) in a step.  So the fp32 masters are held at 2e-2 absolute and
    1e-2 rms relative to the leaf."""
    for a, b in zip(port, ref):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=FP16_PARAM_ATOL)
        assert np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)) <= \
            FP16_PARAM_RMS_REL


def _scale_row(engine):
    hyst = (int(engine.state.hysteresis) if hasattr(engine, "state")
            else engine._hysteresis)
    return (engine.loss_scale, hyst, engine.skipped_steps,
            engine.was_step_applied())


@pytest.mark.parametrize("hysteresis,window", [(2, 3), (1, 2)])
def test_dynamic_loss_scale_matches_jax_step_by_step(hysteresis, window):
    cfg = _fp16_config(initial_scale_power=POWER, hysteresis=hysteresis,
                       loss_scale_window=window)
    je, te = _pair(cfg)
    assert (te.compute_dtype, te.master_dtype, te.acc_dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    assert te.fp16_enabled() and te.dynamic_loss_scale()
    assert te.loss_scale == je.loss_scale == 2.0 ** POWER
    skipped = 0
    for batch in token_batches(12):
        before = _state(te)
        ref, got = je.train_batch(batch), te.train_batch(batch)
        np.testing.assert_allclose(got, ref, rtol=BF16_LOSS_RTOL)
        assert _scale_row(te) == _scale_row(je)
        if not te.was_step_applied():
            skipped += 1
            _same_state(before, _state(te))
    assert 0 < skipped == te.skipped_steps < 12
    assert te.global_steps == je.global_steps == 12
    assert te.get_lr() == je.get_lr()
    _assert_fp16_masters(jax.tree.leaves(to_numpy(te.params)),
                         jax.tree.leaves(jax_params(je)))


def test_static_loss_scale_matches_jax():
    je, te = _pair(_fp16_config(loss_scale=1024))
    assert not te.dynamic_loss_scale() and te.loss_scale == 1024.0
    for batch in token_batches(4):
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=BF16_LOSS_RTOL)
        assert _scale_row(te) == _scale_row(je) == (1024.0, 2, 0, True)
    _assert_fp16_masters(jax.tree.leaves(to_numpy(te.params)),
                         jax.tree.leaves(jax_params(je)))


def test_an_overflow_skip_is_routine_for_telemetry_and_self_healing():
    """A skipped step counts in ``ds_train_overflow_skip_total``, never
    as a non-finite step, and self-healing does not roll it back (JAX
    engine.py:999-1006, :1182-1198)."""
    cfg = _fp16_config(initial_scale_power=127)
    cfg["fault_tolerance"] = {"self_healing": True}
    je, te = _pair(cfg)
    was = telemetry_state.enabled
    telemetry_state.enabled = True
    try:
        skips0 = tm.TRAIN_OVERFLOW_SKIP.value
        nonfinite0 = tm.TRAIN_NONFINITE.value
        rollbacks0 = tm.TRAIN_ROLLBACK.value
        for batch in token_batches(3):
            te.train_batch(batch)
        assert te.skipped_steps == 3
        assert tm.TRAIN_OVERFLOW_SKIP.value - skips0 == 3
        assert tm.TRAIN_NONFINITE.value == nonfinite0
        assert tm.TRAIN_ROLLBACK.value == rollbacks0
    finally:
        telemetry_state.enabled = was


def test_fp16_with_offload_skips_the_host_step():
    """Half the elements offloaded (JAX's leaf choice): on an overflow
    the host masters stay bit-equal, and every step matches JAX."""
    cfg = _fp16_config(initial_scale_power=POWER, hysteresis=1,
                       loss_scale_window=2)
    cfg["zero_optimization"] = {"stage": 1, "offload_optimizer": {
        "device": "cpu", "ratio": 0.5}}
    je = jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    te = _bridged_engine(je, LlamaForCausalLM("debug", dtype=torch.float32),
                         cfg)
    for batch in token_batches(6):
        host = [m.copy() for m in te.offload.masters]
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=BF16_LOSS_RTOL)
        assert _scale_row(te) == _scale_row(je)
        if not te.was_step_applied():
            assert all(np.array_equal(a, b)
                       for a, b in zip(host, te.offload.masters))
    assert 0 < te.skipped_steps < 6
    _assert_fp16_masters(_fp32(te), _jax_masters(je))


def test_fp16_state_crosses_universal_checkpoints_both_ways(tmp_path):
    cfg = _fp16_config(initial_scale_power=POWER, hysteresis=2,
                       loss_scale_window=2)
    cfg["checkpoint"] = {"async_save": False}
    je, te = _pair(cfg)
    batches = token_batches(6)
    for b in batches[:4]:
        je.train_batch(b)
        te.train_batch(b)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    je.save_checkpoint(jdir)
    te.save_checkpoint(tdir)
    judir = J_universal.ds_to_universal(jdir)
    tudir = T_universal.ds_to_universal(tdir)
    metas = []
    for udir in (judir, tudir):
        with open(os.path.join(udir, "universal_meta.json")) as f:
            metas.append(json.load(f))
    keys = ("step", "loss_scale", "good_steps", "skipped_steps",
            "hysteresis")
    assert [m[k] for m in metas for k in keys][:5] == \
        [m[k] for m in metas for k in keys][5:]
    assert metas[1]["skipped_steps"] > 0

    # JAX -> port: a fresh port engine takes JAX's fp16 state
    cfg_u = dict(cfg, checkpoint={"async_save": False,
                                  "load_universal": True})
    _, fresh = _pair(cfg_u)
    fresh.load_checkpoint(jdir)
    assert _scale_row(fresh)[:3] == _scale_row(je)[:3]
    # port -> JAX
    _, je2 = None, jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    J_universal.load_universal_into_engine(je2, tudir)
    assert _scale_row(je2)[:3] == _scale_row(te)[:3]
    # and a plain port checkpoint round trip keeps it too
    again = _pair(cfg)[1]
    again.load_checkpoint(tdir)
    assert _scale_row(again)[:3] == _scale_row(te)[:3]
    for b in batches[4:]:
        np.testing.assert_allclose(fresh.train_batch(b), je.train_batch(b),
                                   rtol=BF16_LOSS_RTOL)
        assert _scale_row(fresh) == _scale_row(je)


# ---------------------------------------------------------------------------
# pure bf16
# ---------------------------------------------------------------------------

FLAGS = [(False, True), (True, False), (False, False)]
OPTIMIZERS = {"adamw": {"lr": 1e-3, "weight_decay": 0.01},
              "lion": {"lr": 1e-3, "weight_decay": 0.01},
              "lamb": {"lr": 1e-3, "weight_decay": 0.01}}


def _mlp_pair(cfg):
    je = jax_engine(JSimple(HIDDEN), cfg)
    # bf16 masters widen exactly, and the port narrows them back
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                          jax_params(je))
    te = dtt.initialize(model=SimpleModel(HIDDEN), config=cfg,
                        model_parameters=params, device="cpu")[0]
    return je, te


def _mlp_batches(n):
    data = random_dataset(4 * n, HIDDEN, seed=3)
    return [{k: np.stack([d[k] for d in data[4 * i:4 * i + 4]])
             for k in ("x", "y")} for i in range(n)]


#: every flag mix with AdamW, Lion and LAMB on the two-layer MLP, and
#: the first mix with AdamW on the debug llama too
PURE_BF16 = ([("mlp", name, mw, acc) for name in sorted(OPTIMIZERS)
              for mw, acc in FLAGS] + [("llama", "adamw", False, True)])


@pytest.mark.parametrize("model,name,master_weights,acc_fp32", PURE_BF16)
def test_pure_bf16_matches_jax(model, name, master_weights, acc_fp32):
    cfg = llama_config(bf16={"enabled": True,
                             "master_weights": master_weights,
                             "accumulate_grads_in_fp32": acc_fp32},
                       optimizer={"type": name, "params": OPTIMIZERS[name]})
    if model == "llama":
        je, te = _pair(cfg)
        batches = token_batches(4)
    else:
        je, te = _mlp_pair(cfg)
        batches = _mlp_batches(4)
    assert te.master_dtype == (torch.float32 if master_weights
                               else torch.bfloat16)
    assert te.acc_dtype == (torch.float32 if acc_fp32 else torch.bfloat16)
    assert all(p.dtype == te.master_dtype for p in te.masters)
    for batch in batches:
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch),
                                   rtol=BF16_LOSS_RTOL)
    # the JAX optax state holds fp32 moments after the first update
    assert {str(x.dtype) for x in jax.tree.leaves(
        meta.unbox(je.state.opt_state))} <= {"float32", "int32"}
    assert all(v.dtype == torch.float32 for st in te.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))
    for a, b in zip(jax.tree.leaves(to_numpy(te.params)),
                    jax.tree.leaves(jax_params(je))):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=BF16_PARAM_ATOL)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_bf16_p_matches_the_jax_kernel(g_dtype):
    """The Pallas op's own reach, bf16 p over fp32 moments (JAX
    ``fused_adamw_flat`` in interpret mode): p rounded once, moments
    fp32 (rtol 1e-5)."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=3000).astype(np.float32)
    jp = jnp.asarray(p, jnp.bfloat16)
    tp = torch.from_numpy(p).to(torch.bfloat16)
    jm = jv = jnp.zeros(3000)
    tm_, tv = torch.zeros(3000), torch.zeros(3000)
    for step in (1, 2, 3):
        g = (rng.normal(size=3000) * 0.1).astype(np.float32)
        jg = jnp.asarray(g, jnp.bfloat16 if g_dtype == torch.bfloat16
                         else jnp.float32)
        jp, jm, jv = jfo.fused_adamw_flat(jp, jg, jm, jv, 1e-2, 0.9, 0.999,
                                          1e-8, 0.01, step, interpret=True)
        tfo.fused_adamw_flat(tp, torch.from_numpy(g).to(g_dtype), tm_, tv,
                             1e-2, 0.9, 0.999, 1e-8, 0.01, step)
        assert tp.dtype == torch.bfloat16 and jp.dtype == jnp.bfloat16
        np.testing.assert_array_equal(
            tp.float().numpy(), np.asarray(jp, np.float32))
        np.testing.assert_allclose(tm_.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-9)


def test_entry_point_names_the_instance_for_the_dtypes():
    bf, f = torch.zeros(4, dtype=torch.bfloat16), torch.zeros(4)
    assert tfo.entry_point("fused_adamw", f, f) == "fused_adamw_f32"
    assert tfo.entry_point("fused_lion", bf, f) == "fused_lion_bf16_f32"
    assert tfo.entry_point("fused_lamb_stage1", bf, bf) == \
        "fused_lamb_stage1_bf16_bf16"
    for kernel in (tfo.KERNEL, tfo.LION_KERNEL, tfo.LAMB_KERNEL):
        assert len(kernel.functions) == 4
    with pytest.raises(TypeError, match="fp32 or bf16 p"):
        tfo._check_buffers("adamw", torch.zeros(4, dtype=torch.float16),
                           f, m=f, v=f)
    with pytest.raises(TypeError, match="fp32 m"):
        tfo._check_buffers("adamw", bf, f, m=bf, v=f)


@pytest.mark.parametrize("precision,torch_name", [
    ("default", "highest"), ("tensorfloat32", "high"),
    ("bfloat16", "medium"), ("float32", "highest")])
def test_tpu_dtype_keys_are_read_as_jax_reads_them(precision, torch_name):
    """``tpu.param_dtype`` and ``compute_dtype`` are parsed and unread
    (JAX's dtypes come from the precision sections); the matmul
    precision is set at every build, "default" resetting it."""
    cfg = llama_config(tpu={"param_dtype": "bfloat16",
                            "compute_dtype": "float32",
                            "matmul_precision": precision})
    before = torch.get_float32_matmul_precision()
    try:
        te = dtt.initialize(model=LlamaForCausalLM("debug",
                                                   dtype=torch.float32),
                            config=cfg, device="cpu")[0]
        assert torch.get_float32_matmul_precision() == torch_name
        assert te.compute_dtype == te.master_dtype == torch.float32
        dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                       config=llama_config(), device="cpu")
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.set_float32_matmul_precision(before)
    with pytest.raises(ValueError, match="matmul_precision"):
        dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                       config=llama_config(tpu={"matmul_precision": "x"}),
                       device="cpu")


def test_bf16_masters_round_trip_through_checkpoints(tmp_path):
    """bf16 masters and their fp32 moments come back bit for bit from a
    port checkpoint and from its universal atoms (bf16 values are exact
    in the fp32 atoms)."""
    cfg = llama_config(bf16={"enabled": True, "master_weights": False},
                       checkpoint={"async_save": False})
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    params = model.init_params(0, device="cpu")
    te = dtt.initialize(model=model, config=cfg, model_parameters=params,
                        device="cpu")[0]
    for b in token_batches(2):
        te.train_batch(b)
    te.save_checkpoint(str(tmp_path / "ckpt"))
    udir = T_universal.ds_to_universal(str(tmp_path / "ckpt"))
    for how, load_cfg, src in (
            ("torch.save", cfg, str(tmp_path / "ckpt")),
            ("universal", dict(cfg, checkpoint={"async_save": False,
                                                "load_universal": True}),
             udir)):
        fresh = dtt.initialize(model=LlamaForCausalLM(
            "debug", dtype=torch.float32), config=load_cfg,
            model_parameters=params, device="cpu")[0]
        fresh.load_checkpoint(src)
        assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
                   for a, b in zip(fresh.masters, te.masters)), how
        for p, q in zip(fresh.masters, te.masters):
            a, b = fresh.optimizer.state[p], te.optimizer.state[q]
            assert a["step"] == b["step"], how
            assert torch.equal(a["exp_avg"], b["exp_avg"]), how
        assert fresh.global_steps == te.global_steps == 2
