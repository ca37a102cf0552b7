"""The training engine's telemetry held against the JAX engine's, on the
CPU: the monitor's files, the spans, the watchdog's goodput phases and
the timers, and the config sections that carry them.

Both engines train the MLP in fp32 from the same weights on the same
batches; the CSV monitor's ``Train/`` files hold the same tags and steps
with values within tests/test_torch_training.py's rtol 1e-4, and the
registry snapshot at ``steps_per_print`` writes the same training
metrics' files at the same steps.
"""

import csv
import os
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu import telemetry as J_tel
from deepspeed_tpu.models.base import SimpleModel as JSimple
from deepspeed_tpu.utils import timer as J_timer
from deepspeed_tpu_torch import telemetry as T_tel
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.monitor import monitor as T_monitor
from deepspeed_tpu_torch.runtime.config import load_config
from deepspeed_tpu_torch.telemetry import metrics as tm
from deepspeed_tpu_torch.utils import logging as T_logging
from deepspeed_tpu_torch.utils import timer as T_timer
from test_torch_training import LOSS_RTOL, jax_engine, jax_params

HIDDEN = 16
STEPS = 4


@pytest.fixture(autouse=True)
def _hygiene():
    def reset():
        for tel in (T_tel, J_tel):
            tel.disable()
            tel.get_watchdog().reset()
            tel.get_tracer().clear()
    torch.set_num_threads(1)
    reset()
    yield
    reset()


def _config(tmp, **over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "bf16": {"enabled": False},
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 3}},
           "steps_per_print": 2,
           "csv_monitor": {"enabled": True, "output_path": str(tmp),
                           "job_name": "run"},
           "checkpoint": {"async_save": False}}
    cfg.update(over)
    return cfg


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    return [{k: rng.normal(size=(4, HIDDEN)).astype(np.float32)
             for k in ("x", "y")} for _ in range(n)]


def _port(cfg, params=None):
    model = SimpleModel(HIDDEN)
    engine, *_ = dtt.initialize(
        model=model, config=cfg, device="cpu",
        model_parameters=(params if params is not None
                          else model.init_params(0, "cpu")))
    return engine


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [(int(s), float(v)) for s, v in rows[1:]]


def test_csv_monitor_writes_the_jax_files(tmp_path):
    je = jax_engine(JSimple(HIDDEN), _config(tmp_path / "jax"))
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                          jax_params(je))
    te = _port(_config(tmp_path / "port"), params)
    for b in _batches():
        np.testing.assert_allclose(te.train_batch(b), je.train_batch(b),
                                   rtol=LOSS_RTOL)
    te.monitor.monitors[0].close()
    je.monitor.monitors[0].close()
    jdir, tdir = tmp_path / "jax" / "run", tmp_path / "port" / "run"
    for name in ("Train_Samples_train_loss.csv", "Train_Samples_lr.csv"):
        (jh, jrows), (th, trows) = (_read_csv(jdir / name),
                                    _read_csv(tdir / name))
        assert th == jh and [s for s, _ in trows] == [s for s, _ in jrows]
        assert [s for s, _ in trows] == [4, 8, 12, 16]
        np.testing.assert_allclose([v for _, v in trows],
                                   [v for _, v in jrows], rtol=LOSS_RTOL)
    # the registry at steps_per_print: the training metrics' files, at
    # the same samples (which other metrics a process touched is its own)
    for metric in ("ds_train_samples_per_sec", "ds_train_step_time_ms_p50",
                   "ds_train_step_time_ms_count"):
        name = f"Telemetry_{metric}.csv"
        (jh, jrows), (th, trows) = (_read_csv(jdir / name),
                                    _read_csv(tdir / name))
        assert th == jh and [s for s, _ in trows] == [s for s, _ in jrows]
    assert [v for _, v in _read_csv(
        tdir / "Telemetry_ds_train_step_time_ms_count.csv")[1]][-1] >= 3


def test_spans_and_goodput_phases_match_jax(tmp_path):
    """With telemetry on, a run with a save and a load records JAX's
    span names and fills the watchdog's phases as JAX's do."""
    runs = {}
    for tel, make in ((J_tel, lambda: jax_engine(
            JSimple(HIDDEN), _config(tmp_path / "jm"))),
            (T_tel, lambda: _port(_config(tmp_path / "tm")))):
        engine = make()
        tel.enable()
        for b in _batches():
            engine.train_batch(b)
        engine.save_checkpoint(str(tmp_path / tel.__name__))
        engine.load_checkpoint(str(tmp_path / tel.__name__))
        names = {r[0] for r in tel.get_tracer().records()}
        goodput = tel.get_watchdog().goodput()
        runs[tel] = ({n for n in names if n.startswith("train.")},
                     {p for p, v in goodput.items() if v > 0})
        tel.disable()
    assert runs[T_tel] == runs[J_tel]
    assert {"train.batch", "train.step", "train.place_batch"} <= \
        runs[T_tel][0]
    assert {"compile", "step", "checkpoint"} <= runs[T_tel][1]


def test_timers_count_as_jax_timers():
    """Driven with the same calls, the two packages' timers count the
    same steps and gate the registry on ``start_step`` alike."""
    for pkg in (J_timer, T_timer):
        timers = pkg.SynchronizedWallClockTimer()
        t = timers(pkg.TRAIN_BATCH_TIMER)
        for _ in range(3):
            t.start()
            t.stop()
        t.stop()                      # not started: ignored
        assert t.count == 3 and t.elapsed(reset=False) > 0
        t.start()
        t.stop(reset=True)
        assert t.count == 1
        tput = pkg.ThroughputTimer(batch_size=8, start_step=2,
                                   steps_per_output=10 ** 9)
        tput.start()
        tput.stop()
        assert tput.total_elapsed_time == 0.0    # the first step is out
        for _ in range(3):
            tput.start()
            tput.stop()
        assert tput.global_step_count == 4 and tput.avg_samples_per_sec() > 0
    assert tm.TRAIN_SAMPLES_PER_SEC.touched


def test_wall_clock_breakdown_logs_the_step_time(tmp_path, monkeypatch):
    """The timer synchronises only on the card under
    ``wall_clock_breakdown``; the step time is logged at
    ``steps_per_print``."""
    te = _port(_config(tmp_path, wall_clock_breakdown=True))
    assert te.timers.synchronize is False          # a CPU engine
    assert _port(_config(tmp_path)).timers.synchronize is False
    lines = []
    monkeypatch.setattr(T_logging.logger, "info",
                        lambda fmt, *a: lines.append(fmt % a if a else fmt))
    for b in _batches():
        te.train_batch(b)
    logged = [ln for ln in lines if ln.startswith("time (ms)")]
    assert len(logged) == 2 and "train_batch" in logged[0]


def test_monitors_without_their_package_disable_themselves(tmp_path,
                                                           monkeypatch):
    """TensorBoard, W&B and Comet warn and turn off when their package
    is missing (the card's machine has none); training runs on."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "comet_ml", None)
    warned = []
    monkeypatch.setattr(T_logging.logger, "warning",
                        lambda fmt, *a: warned.append(fmt % a if a else fmt))
    cfg = _config(tmp_path, csv_monitor={"enabled": False},
                  tensorboard={"enabled": True, "output_path": str(tmp_path)},
                  wandb={"enabled": True}, comet={"enabled": True})
    te = _port(cfg)
    assert [type(m).__name__ for m in te.monitor.monitors] == [
        "TensorBoardMonitor", "WandbMonitor", "CometMonitor"]
    assert not te.monitor.enabled
    assert sorted(w.split()[0] for w in warned) == [
        "comet_ml", "tensorboard", "wandb"]
    te.train_batch(_batches(1)[0])
    assert os.listdir(tmp_path) == []


def test_a_failing_monitor_drops_the_write_not_the_step(tmp_path):
    te = _port(_config(tmp_path))
    drops = tm.TRAIN_MONITOR_DROP.value

    def fail(*a):
        raise OSError("disk full")
    te.monitor.monitors[0].write_events = fail
    for b in _batches(2):
        te.train_batch(b)
    assert te.global_steps == 2
    assert tm.TRAIN_MONITOR_DROP.value == drops + 3   # 2 steps + 1 snapshot


def test_the_sections_are_read_and_unknown_keys_raise():
    cfg = load_config({
        "checkpoint": {"async_save": False, "save_retries": 5,
                       "tag_validation": "Fail", "load_universal": True,
                       "use_node_local_storage": True,
                       "parallel_write": {"pipeline_stage": True}},
        "fault_tolerance": {"self_healing": True, "snapshot_interval": 2},
        "fault_injection": {"enabled": False, "seed": 3},
        "telemetry": {"enabled": False, "watchdog_warmup": 2},
        "wall_clock_breakdown": True,
        "tensorboard": {"enabled": False, "job_name": "x"},
        "wandb": {"project": "p"}, "comet": {"team": "t"}})
    assert (cfg.checkpoint.async_save, cfg.checkpoint.save_retries,
            cfg.checkpoint.load_universal) == (False, 5, True)
    assert cfg.fault_tolerance.snapshot_interval == 2
    assert cfg.telemetry.watchdog_warmup == 2 and cfg.wall_clock_breakdown
    assert cfg.wandb.project == "p" and cfg.comet.team == "t"
    for section in ("checkpoint", "fault_tolerance", "telemetry",
                    "csv_monitor"):
        with pytest.raises(NotImplementedError, match="typo"):
            load_config({section: {"typo": 1}})
    with pytest.raises(ValueError, match="unknown fault-injection site"):
        _port(_config(".", fault_injection={
            "enabled": True, "sites": {"train.bogus": {"p": 1.0}}}))
