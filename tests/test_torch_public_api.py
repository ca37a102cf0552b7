"""The port's one-card public API held against the JAX package's.

``deepspeed_tpu_torch`` exports the JAX package's top-level names but
those that wait for a named ROADMAP item; ``load_config`` reads every
top-level field of JAX ``DeepSpeedTPUConfig`` (the list is JAX's
``model_fields``, so a field JAX adds later is covered the day it
lands); the engine's accessors give the JAX engine's values on a config
that sets each key (the JAX engine's accessor methods over its parsed
config: they read nothing else); ``initialize`` takes JAX's signature (``args`` with
``deepspeed_config``, ``config_params``, the hybrid engine under
``hybrid_engine.enabled``).  The debug llama in fp32 on the CPU.
"""

import argparse
import ast
import contextlib
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.runtime.config import DeepSpeedTPUConfig
from deepspeed_tpu.runtime.config import load_config as j_load_config
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.runtime.engine import _topology_from_config
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime import config as tconfig
from test_torch_training import (jax_engine, jax_params, llama_config,
                                 token_batches)

#: JAX top-level names the port does not have yet, with their item
WAITING = {"pipe": "11h", "PipelineEngine": "11h"}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@contextlib.contextmanager
def captured(logger):
    """The messages ``logger`` emits inside the block (the port's logger
    does not propagate, so pytest's caplog cannot see it)."""
    records = []

    class _H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    h = _H()
    logger.addHandler(h)
    try:
        yield records
    finally:
        logger.removeHandler(h)


def _exports(mod):
    """The public names a package's ``__init__.py`` binds (read from its
    source: ``dir()`` also lists whatever submodule any test imported)."""
    tree = ast.parse(open(mod.__file__).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {a.asname or a.name.split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_the_export_lists_are_jax_s_but_the_waiting_names():
    missing = _exports(dst) - _exports(dtt)
    assert missing == set(WAITING), missing
    assert _exports(dtt) - _exports(dst) == set()
    for name in _exports(dtt):
        assert hasattr(dtt, name), name
    assert dtt.__version__ == dst.__version__
    from deepspeed_tpu_torch.inference.engine import InferenceConfig
    assert dtt.DeepSpeedInferenceConfig is InferenceConfig
    assert _exports(dst.comm) <= _exports(dtt.comm)
    for name in WAITING:
        assert name in dtt.__doc__, name


@pytest.mark.parametrize("field", sorted(DeepSpeedTPUConfig.model_fields))
def test_load_config_reads_every_jax_field(field):
    """Each top-level field of JAX ``DeepSpeedTPUConfig`` at JAX's
    default value (every nested key of the section with it) loads."""
    value = DeepSpeedTPUConfig().model_dump()[field]
    tconfig.load_config({field: value})


def test_load_config_reads_the_whole_jax_default_config():
    d = DeepSpeedTPUConfig().model_dump()
    cfg = tconfig.load_config(d)
    jcfg = DeepSpeedTPUConfig(**d)
    assert cfg.serving_optimization.to_v2_dict() \
        == jcfg.serving_optimization.to_v2_dict()
    for section in ("comms_logger", "elasticity", "autotuning",
                    "hybrid_engine"):
        assert vars(getattr(cfg, section)) \
            == getattr(jcfg, section).model_dump(), section
    # only an _OUTSIDE_SLICE section that is switched on raises
    for key, section in (("compression_training",
                          {"weight_quantization": {"a": 1}}),
                         ("moe", {"enabled": True})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tconfig.load_config({key: section})
    with pytest.raises(NotImplementedError, match="DeepSpeedTPUConfig"):
        tconfig.load_config({"not_a_key": 1})
    with pytest.raises(NotImplementedError, match="hybrid_engine"):
        tconfig.load_config({"hybrid_engine": {"typo": 1}})


#: a config that sets every key this slice added
SET_EVERY_KEY = {
    "prescale_gradients": True, "gradient_predivide_factor": 2.0,
    "communication_data_type": "fp32",
    "seq_parallel_communication_data_type": "bf16",
    "sparse_gradients": True, "dump_state": True,
    "disable_allgather": True,
    "comms_logger": {"enabled": True, "verbose": False,
                     "prof_ops": ["all_reduce"]},
    "elasticity": {"enabled": True, "micro_batch_sizes": [2, 4]},
    "autotuning": {"enabled": True, "metric": "latency"},
    "serving_optimization": {"keyed_sampling": True},
}

ACCESSORS = ["gradient_predivide_factor", "postscale_gradients",
             "communication_data_type", "sparse_gradients_enabled",
             "elasticity_enabled", "autotuning_enabled"]


def _jax_accessors(cfg):
    """The JAX engine's accessor methods over its parsed ``cfg``, and its
    model overrides applied to the debug llama (no engine built: they
    read ``config`` and ``module`` alone)."""
    je = JEngine.__new__(JEngine)
    je.config = j_load_config(cfg)
    je.module = JLlama("debug", dtype=jnp.float32)
    JEngine._apply_model_overrides(je)
    return je


@pytest.fixture(scope="module")
def engine_pair():
    cfg = llama_config(**SET_EVERY_KEY)
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    with captured(dtt.logger) as msgs:
        te, *_ = dtt.initialize(model=model, config=cfg, device="cpu")
    yield _jax_accessors(cfg), te, msgs
    # the engine configured the comms logger: a later test in this worker
    # must see none
    dtt.comm.comm._comms_logger = None


@pytest.mark.parametrize("over", [{}, SET_EVERY_KEY])
def test_the_new_accessors_equal_the_jax_engine_s(over, engine_pair):
    if over:
        je, te, _ = engine_pair
    else:
        je = _jax_accessors(llama_config())
        te, *_ = dtt.initialize(
            model=LlamaForCausalLM("debug", dtype=torch.float32),
            config=llama_config(), device="cpu")
    for name in ACCESSORS:
        assert getattr(te, name)() == getattr(je, name)(), name
    assert te.module.cfg.sparse_gradients == je.module.cfg.sparse_gradients
    assert te.config.elasticity.micro_batch_sizes == \
        je.config.elasticity.micro_batch_sizes
    assert te.config.autotuning.metric == je.config.autotuning.metric


def test_the_comms_logger_is_configured_and_the_noop_keys_warn(engine_pair):
    je, te, msgs = engine_pair
    assert dtt.comm.get_comms_logger() is not None
    assert dtt.comm.get_comms_logger().enabled
    for key in ("dump_state", "disable_allgather",
                "seq_parallel_communication_data_type"):
        assert any(key in m and "no effect" in m for m in msgs), key


def test_dump_state_logs_what_jax_logs(engine_pair):
    je, te, _ = engine_pair
    te.train_batch(token_batches(1)[0])
    with captured(dtt.logger) as msgs:
        te.dump_state()
    assert len(msgs) == 1 and msgs[0].startswith("engine state: step=1 ")
    for word in ("lr=", "loss_scale=", "skipped=", "zero_stage=",
                 "device=cpu"):
        assert word in msgs[0]


def test_initialize_takes_jax_s_signature(tmp_path):
    """``args.deepspeed_config`` (a JSON path), ``config_params`` and the
    positional order of JAX ``initialize``: the JAX engine's batch sizes,
    and the first loss of an engine built with ``config=``."""
    cfg = llama_config()
    path = tmp_path / "ds_config.json"
    path.write_text(json.dumps(cfg))
    parser = dtt.add_config_arguments(argparse.ArgumentParser())
    args = parser.parse_args(["--deepspeed", "--deepspeed_config",
                              str(path)])
    jargs = dst.add_config_arguments(argparse.ArgumentParser()).parse_args(
        ["--deepspeed", "--deepspeed_config", str(path)])
    assert vars(args) == vars(jargs)
    je, *_ = dst.initialize(jargs, JLlama("debug", dtype=jnp.float32),
                            topology=_topology_from_config(
                                j_load_config(cfg),
                                devices=jax.devices()[:1]))
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    params = jax_params(je)
    batch = token_batches(1)[0]
    ref, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                             model_parameters=from_jax(params, model.cfg,
                                                       device="cpu"))
    ref = ref.train_batch(batch)
    built = [
        dtt.initialize(args, model, None,
                       from_jax(params, model.cfg, device="cpu"),
                       device="cpu"),
        dtt.initialize(model=model, config_params=cfg, device="cpu",
                       model_parameters=from_jax(params, model.cfg,
                                                 device="cpu"))]
    for engine, opt, loader, sched in built:
        assert type(engine) is dtt.DeepSpeedEngine
        assert opt is engine.optimizer and loader is None
        assert (engine.train_batch_size(),
                engine.gradient_accumulation_steps()) == \
            (je.train_batch_size(), je.gradient_accumulation_steps())
        assert engine.train_batch(batch) == ref
        assert engine.state.step == 1 and engine.state.params is \
            engine.params


def test_initialize_picks_the_hybrid_engine_as_jax_does():
    cfg = llama_config(hybrid_engine={"enabled": True})
    je = jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    te, *_ = dtt.initialize(model=LlamaForCausalLM("debug",
                                                   dtype=torch.float32),
                            config=cfg, device="cpu")
    assert type(je).__name__ == type(te).__name__ == "DeepSpeedHybridEngine"
    assert isinstance(te, dtt.DeepSpeedEngine)


def test_the_argument_helpers_and_the_inference_default_equal_jax():
    flags = ["--lr_schedule", "WarmupDecayLR", "--total_num_steps", "10",
             "--warmup_num_steps", "3"]
    t = dtt.add_tuning_arguments(argparse.ArgumentParser()).parse_args(flags)
    j = dst.add_tuning_arguments(argparse.ArgumentParser()).parse_args(flags)
    assert vars(t) == vars(j)
    from deepspeed_tpu.runtime.lr_schedules import convert_lr_tuning_args
    from deepspeed_tpu_torch.runtime.lr_schedules import \
        convert_lr_tuning_args as tconvert
    assert tconvert(t) == convert_lr_tuning_args(j)
    td, jd = dtt.default_inference_config(), dst.default_inference_config()
    assert set(td) == set(jd)
    for block in ("state_manager", "quantization", "fault_injection"):
        assert td[block] == jd[block], block
    assert td["serving"] == {k: v for k, v in jd["serving"].items()
                             if k in td["serving"]}


def test_init_distributed_and_the_accelerator_at_one_process(monkeypatch):
    dtt.init_distributed()
    assert dtt.comm.is_initialized()
    assert dtt.comm.get_rank() == 0 and dtt.comm.get_world_size() == 1
    monkeypatch.setattr(dtt.comm.comm, "_initialized", False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_PORT", "29611")
    # several processes join over NCCL by default, which needs a card of
    # its own per local rank: without a card, or with more local ranks
    # than cards, the join raises, and no backend is switched quietly
    # (tests/test_torch_zero_ranks.py joins over gloo)
    monkeypatch.setenv("LOCAL_SIZE", str(torch.cuda.device_count() + 1))
    with pytest.raises(RuntimeError, match="nccl") as err:
        dtt.init_distributed()
    assert "127.0.0.1:29611" in str(err.value)
    assert not dtt.comm.is_initialized()
    monkeypatch.setenv("DS_ACCELERATOR", "cpu")
    from deepspeed_tpu_torch.accelerator import real_accelerator
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    acc = dtt.get_accelerator()
    assert acc.device_name() == "cpu" and acc.device_count() == 1
    assert acc.communication_backend_name() == "gloo"
