"""The port's self-healing training and checkpoint durability held against
the JAX package's, on the CPU (the port's side of tests/test_chaos.py's
checkpoint and training classes).

Both engines train the MLP in fp32 with ``fault_tolerance.self_healing``
from the same weights; each package's fault injector is armed with the
same site specs at the same calls.  Under one fault schedule the two
give the same sequence of finite and non-finite losses, the same
exceptions and the same ``global_steps`` (finite losses within
tests/test_torch_training.py's rtol 1e-4), and a rollback leaves the
port's masters and moments bit-equal to the last good state.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu import telemetry as J_tel
from deepspeed_tpu.models.base import SimpleModel as JSimple
from deepspeed_tpu.runtime import fault_injection as J_fi
from deepspeed_tpu_torch import telemetry as T_tel
from deepspeed_tpu_torch.checkpoint.engine import TorchCheckpointEngine
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.runtime import fault_injection as T_fi
from deepspeed_tpu_torch.telemetry import metrics as tm
from test_torch_training import LOSS_RTOL, jax_engine, jax_params

HIDDEN = 32
CONFIG = {
    "train_micro_batch_size_per_gpu": 2,
    "bf16": {"enabled": False},
    "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
    "zero_optimization": {"stage": 0},
    "steps_per_print": 10 ** 9,
    "checkpoint": {"async_save": False},
    "fault_tolerance": {"self_healing": True, "max_retries": 2,
                        "backoff_s": 0.001, "snapshot_interval": 1},
}


@pytest.fixture(autouse=True)
def _hygiene():
    """Disarmed injectors, telemetry off and clean watchdogs in both
    packages, before and after."""
    def reset():
        for tel, fi in ((T_tel, T_fi), (J_tel, J_fi)):
            fi.get_fault_injector().disarm()
            tel.disable()
            tel.get_watchdog().reset()
            tel.get_flight_recorder().clear()
    torch.set_num_threads(1)
    reset()
    yield
    reset()


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(2, HIDDEN)).astype(np.float32)
            for k in ("x", "y")}


def _engines():
    je = jax_engine(JSimple(HIDDEN), CONFIG)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                          jax_params(je))
    te, *_ = dtt.initialize(model=SimpleModel(HIDDEN), config=CONFIG,
                            model_parameters=params, device="cpu")
    return je, te


def _masters(te):
    return [p.clone() for p in te.masters], [
        {k: v.clone() for k, v in te.optimizer.state[p].items()
         if torch.is_tensor(v)} for p in te.masters]


def _assert_at(te, good):
    for a, b in zip(te.masters, good[0]):
        assert torch.equal(a, b)
    for p, want in zip(te.masters, good[1]):
        for k, v in want.items():
            assert torch.equal(te.optimizer.state[p][k], v)


# ---------------------------------------------------------------------------
# one fault schedule, both packages
# ---------------------------------------------------------------------------

#: (action, argument): "train" a batch seed under the armed sites,
#: "arm" a site spec (None disarms), "save" a tag, "forget" the
#: checkpoint (the next rollback takes the snapshot)
SCHEDULE = [
    ("train", 0), ("train", 1),
    ("arm", {"train.nan_grad": {"at_calls": [1]}}),
    ("train", 9),            # NaN step: rolled back to the snapshot
    ("arm", None), ("train", 3),
    ("save", "good"), ("train", 4), ("train", 5),
    ("arm", {"train.nan_grad": {"at_calls": [1]}}),
    ("train", 8),            # rolled back to the checkpoint, not the snapshot
    ("forget", None), ("arm", None), ("train", 2),
    ("arm", {"train.nan_grad": {"p": 1.0}}),
    ("train", 2), ("train", 2),      # two rollbacks absorb these
    ("train", 2),                    # the third exceeds max_retries
    ("arm", None), ("reset", None), ("train", 5),
    ("arm", {"comm.collective_failure": {"at_calls": [1]}}),
    ("train", 6),            # transient: the same batch retried
    ("arm", {"comm.collective_failure": {"p": 1.0}}),
    ("train", 6),            # the retry budget is spent: raises
    ("arm", None), ("train", 7),
]


def _run(engine, fi, tmp):
    """Each train call's outcome: (finite?, global_steps) or the
    exception's class name; and the loss of each finite call."""
    outcomes, losses = [], []
    for action, arg in SCHEDULE:
        if action == "arm":
            if arg is None:
                fi.disarm()
            else:
                fi.configure(arg)
        elif action == "save":
            engine.save_checkpoint(tmp, tag=arg)
        elif action == "forget":
            engine._last_good_ckpt = None
        elif action == "reset":
            engine._rollback_streak = 0
        else:
            try:
                loss = engine.train_batch(_batch(arg))
            except Exception as e:
                outcomes.append(type(e).__name__)
                continue
            outcomes.append((math.isfinite(loss), engine.global_steps))
            if math.isfinite(loss):
                losses.append(loss)
    return outcomes, losses


def test_both_packages_heal_the_same_way(tmp_path):
    je, te = _engines()
    j_out, j_losses = _run(je, J_fi.get_fault_injector(),
                           str(tmp_path / "jax"))
    t_out, t_losses = _run(te, T_fi.get_fault_injector(),
                           str(tmp_path / "port"))
    assert t_out == j_out
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    assert "RuntimeError" in t_out and "InjectedCollectiveFault" in t_out
    assert (False, 3) in t_out      # a rolled-back step keeps global_steps


# ---------------------------------------------------------------------------
# the port alone: what a rollback restores, counters and events
# ---------------------------------------------------------------------------

def _port_engine(**ft):
    cfg = dict(CONFIG, fault_tolerance=dict(CONFIG["fault_tolerance"], **ft))
    model = SimpleModel(HIDDEN)
    engine, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                                model_parameters=model.init_params(0, "cpu"))
    return engine


def test_rollback_restores_the_last_good_state_bit_for_bit(tmp_path):
    te = _port_engine()
    T_tel.enable()
    fi = T_fi.get_fault_injector()
    te.train_batch(_batch(0))
    good = _masters(te)
    rollbacks = tm.TRAIN_ROLLBACK.value
    fi.configure({"train.nan_grad": {"at_calls": [1]}})
    assert not math.isfinite(te.train_batch(_batch(9)))
    _assert_at(te, good)                   # the snapshot, in place
    assert tm.TRAIN_ROLLBACK.value == rollbacks + 1
    kinds = [e["kind"] for e in T_tel.get_flight_recorder().events()]
    assert "selfheal.rollback" in kinds and "watchdog.nonfinite" in kinds
    fi.disarm()
    te.train_batch(_batch(1))
    te.save_checkpoint(str(tmp_path), tag="good")
    good = _masters(te)
    te.train_batch(_batch(2))              # the snapshot is now fresher
    fi.configure({"train.nan_grad": {"at_calls": [1]}})
    te.train_batch(_batch(3))
    _assert_at(te, good)                   # the checkpoint wins
    assert te.global_steps == 2


def test_a_retry_replays_the_same_batch():
    """``comm.collective_failure`` at call 1: the retried step equals an
    unfaulted step bit for bit.  The batch comes from a one-batch
    iterator, so a retry that read it again would stop the iteration."""
    a, b = _port_engine(), _port_engine()
    retries = tm.TRAIN_RETRY.value
    want = a.train_batch(_batch(4))
    T_fi.get_fault_injector().configure(
        {"comm.collective_failure": {"at_calls": [1]}})
    assert b.train_batch(data_iter=iter([_batch(4)])) == want
    assert tm.TRAIN_RETRY.value == retries + 1 and b.global_steps == 1
    for x, y in zip(a.masters, b.masters):
        assert torch.equal(x, y)


def test_nan_site_skips_a_token_batch():
    """A batch of token ids only has nothing to poison: the site is not
    probed (not counted), the step is healthy (JAX engine.py:1108)."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    cfg = dict(CONFIG, train_micro_batch_size_per_gpu=2)
    engine, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                                model_parameters=model.init_params(0, "cpu"))
    fi = T_fi.get_fault_injector()
    fi.configure({"train.nan_grad": {"p": 1.0}})
    ids = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(np.int32)
    assert math.isfinite(engine.train_batch({"input_ids": ids}))
    assert fi.stats()["train.nan_grad"]["fires"] == 0
    assert engine._nan_site_warned


def test_slow_step_feeds_the_anomaly_detector():
    te = _port_engine()
    T_tel.enable()
    wd = T_tel.get_watchdog()
    wd.configure(threshold=3.0, warmup=4)
    for i in range(6):
        te.train_batch(_batch(10 + i))
    anomalies = tm.TRAIN_ANOMALY.value
    T_fi.get_fault_injector().configure(
        {"train.slow_step": {"at_calls": [1], "value": 400.0}})
    te.train_batch(_batch(20))
    assert tm.TRAIN_ANOMALY.value > anomalies


def test_a_crash_leaves_a_postmortem_bundle(tmp_path):
    te = _port_engine(max_retries=0)
    T_tel.enable()
    rec = T_tel.get_flight_recorder()
    saved = (rec.postmortem_dir, rec._crash_dumped)
    rec.postmortem_dir, rec._crash_dumped = str(tmp_path), False
    try:
        T_fi.get_fault_injector().configure(
            {"comm.collective_failure": {"p": 1.0}})
        with pytest.raises(T_fi.InjectedCollectiveFault):
            te.train_batch(_batch(0))
    finally:
        rec.postmortem_dir, rec._crash_dumped = saved
    assert "events.json" in os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# checkpoint durability (tests/test_chaos.py TestCheckpointDurability)
# ---------------------------------------------------------------------------

def _ckpt():
    return TorchCheckpointEngine(async_save=False, save_retries=2,
                                 save_backoff_s=0.001)


def test_write_latest_is_atomic_and_ignores_a_stale_tmp(tmp_path):
    ck = _ckpt()
    (tmp_path / "latest.tmp.12345").write_text("torn-garbage")
    ck.write_latest(str(tmp_path), "good")
    assert ck.read_latest(str(tmp_path)) == "good"
    assert sorted(os.listdir(tmp_path)) == ["latest", "latest.tmp.12345"]
    (tmp_path / "latest").write_text("")
    assert ck.read_latest(str(tmp_path)) is None


@pytest.mark.parametrize("spec,ok", [({"at_calls": [1]}, True),
                                     ({"p": 1.0}, False)])
def test_injected_io_errors_retry_then_succeed_or_raise(spec, ok, tmp_path):
    """``latest`` under ``ckpt.io_error``: retried (and counted) until it
    lands or the retries run out, as the JAX engine does under the same
    spec."""
    from deepspeed_tpu.checkpoint.engine import OrbaxCheckpointEngine

    def write(fi, ck, d):
        d.mkdir()
        fi.get_fault_injector().configure({"ckpt.io_error": spec})
        try:
            ck.write_latest(str(d), "steady")
        except OSError as e:
            assert "injected" in str(e)
        return ck.read_latest(str(d))

    want = write(J_fi, OrbaxCheckpointEngine(
        async_save=False, save_retries=2, save_backoff_s=0.001),
        tmp_path / "jax")
    before = tm.TRAIN_CKPT_RETRY.value
    with pytest.warns(UserWarning, match="retry"):
        got = write(T_fi, _ckpt(), tmp_path / "port")
    assert got == want == ("steady" if ok else None)
    assert tm.TRAIN_CKPT_RETRY.value == before + (1 if ok else 2)


def test_a_save_under_io_faults_never_tears_latest(tmp_path):
    """``ckpt.io_error`` at call 1 of a save is retried and ``latest``
    names the new tag; armed at every call, the save raises, ``latest``
    still names the previous tag and no tmp file is left."""
    te = _port_engine()
    fi = T_fi.get_fault_injector()
    te.train_batch(_batch(0))
    te.save_checkpoint(str(tmp_path), tag="v1")
    fi.configure({"ckpt.io_error": {"at_calls": [1]}})
    with pytest.warns(UserWarning, match="retry"):
        te.save_checkpoint(str(tmp_path), tag="v2")
    assert te.checkpoint_engine.read_latest(str(tmp_path)) == "v2"
    fi.configure({"ckpt.io_error": {"p": 1.0}})
    with pytest.warns(UserWarning, match="retry"):
        with pytest.raises(OSError, match="injected"):
            te.save_checkpoint(str(tmp_path), tag="v3")
    assert te.checkpoint_engine.read_latest(str(tmp_path)) == "v2"
    assert not [p for d, _, fs in os.walk(tmp_path) for p in fs
                if ".tmp." in p]
