"""The rest of the JAX engine's public API on the port's engine, held
against the JAX engine on the CPU (the debug llama in fp32, the weights
bridged from the JAX engine): ``set_lr``, a forced partial boundary on
the forward / backward / step path, the batch-size setters, ``train`` /
``eval``, ``destroy``, ``dump_state`` and every config accessor.  Losses
rtol 1e-4 and masters as ``tests/test_torch_training.py`` holds them.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine as TEngine
from test_torch_training import (LOSS_RTOL, assert_params_close, jax_engine,
                                 jax_params, llama_config, token_batches)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _pair(cfg):
    je = jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    te, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                            model_parameters=from_jax(jax_params(je),
                                                      model.cfg, device="cpu"))
    return je, te


def _public(cls):
    return {n for n, _ in inspect.getmembers(cls) if not n.startswith("_")}


def test_every_public_method_of_the_jax_engine_exists():
    """The ``comm`` of the two engines' public names: nothing the JAX
    engine offers is missing from the port's."""
    assert _public(JEngine) - _public(TEngine) == set()


def test_set_lr_fixes_the_lr_from_the_next_step():
    je, te = _pair(llama_config())
    batches = token_batches(4)
    for b in batches[:2]:
        je.train_batch(b)
        te.train_batch(b)
    je.set_lr(5e-3)
    te.set_lr(5e-3)
    assert te.get_lr() == je.get_lr() == [5e-3]
    for b in batches[2:]:
        np.testing.assert_allclose(te.train_batch(b), je.train_batch(b),
                                   rtol=LOSS_RTOL)
    assert te._last_lr == 5e-3
    assert_params_close(to_numpy(te.params), jax_params(je))


def test_a_forced_partial_boundary_averages_the_micro_batches_taken():
    """gas 2, boundary forced after one micro-batch: the JAX engine's
    one-off step over that micro-batch, equal in the port to a gas-1
    engine's step on it (1e-6), and deferring holds the update back."""
    je, te = _pair(llama_config())
    init = jax_params(je)
    mb = {"input_ids": token_batches(1)[0]["input_ids"][:2]}
    # deferred: nothing happens at step()
    te.set_gradient_accumulation_boundary(False)
    te.backward(te.forward(mb))
    te.backward(te.forward(mb))
    assert not te.is_gradient_accumulation_boundary()
    te.step()
    assert te.global_steps == 0
    te._pending = 0
    te._params_c = None
    # forced after one micro-batch
    te.set_gradient_accumulation_boundary(True)
    je.set_gradient_accumulation_boundary(True)
    je.forward(mb)
    je.step()
    te.backward(te.forward(mb))
    assert te.is_gradient_accumulation_boundary()
    te.step()
    assert te.global_steps == je.global_steps == 1
    assert te.global_samples == je.global_samples == 2
    assert_params_close(to_numpy(te.params), jax_params(je))
    # the same update as a gas-1 engine's step on that micro-batch
    cfg1 = llama_config(gradient_accumulation_steps=1)
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    one, *_ = dtt.initialize(model=model, config=cfg1, device="cpu",
                             model_parameters=from_jax(init, model.cfg,
                                                       device="cpu"))
    one.train_batch(mb)
    for a, b in zip(one.masters, te.masters):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_batch_size_setters_follow_the_jax_rules():
    je, te = _pair(llama_config())
    for engine in (je, te):
        engine.set_train_batch_size(8)
        assert engine.get_batch_info() == (8, 2, 4)
        with pytest.raises(ValueError, match="train_batch_size 7"):
            engine.set_train_batch_size(7)
        engine.set_train_micro_batch_size(1)
        assert engine.get_batch_info() == (4, 1, 4)
        assert engine.tput_timer.batch_size == 4
    batch = {"input_ids": token_batches(1, shape=(4, 32))[0]["input_ids"]}
    np.testing.assert_allclose(te.train_batch(batch), je.train_batch(batch),
                               rtol=LOSS_RTOL)
    assert te.global_samples == je.global_samples == 4


def test_modes_destroy_and_the_small_methods_match_jax(tmp_path):
    je, te = _pair(llama_config())
    for engine in (je, te):
        assert engine.train() is engine and engine.eval() is engine
        assert engine.compile() is engine and engine.is_compiled()
        engine.zero_grad()
        assert engine.was_step_applied()
        assert engine.comm_stats() is None
    batch = token_batches(1)[0]
    np.testing.assert_allclose(te.train_batch(batch), je.train_batch(batch),
                               rtol=LOSS_RTOL)
    # train_batch under eval() warns once and runs the training regime
    assert te._eval_mode_warned and je._eval_mode_warned
    assert te.loss_scale == je.loss_scale == 1.0
    assert te.skipped_steps == je.skipped_steps == 0
    te.dump_state()
    msd, fp32 = te.module_state_dict(), te.get_fp32_state_dict()
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(msd), jax.tree.leaves(fp32)))
    path = te.save_fp16_model(str(tmp_path))
    assert path.endswith("model_weights.npz")
    je.destroy()
    te.destroy()
    for engine in (je, te):
        for call in (lambda: engine.train_batch(batch),
                     lambda: engine.eval_batch(batch),
                     engine.dump_state):
            with pytest.raises(RuntimeError, match="engine destroyed"):
                call()


ACCESSORS = [
    "zero_optimization", "zero_optimization_stage",
    "zero_optimization_partition_gradients",
    "zero_optimization_partition_weights", "zero_allgather_bucket_size",
    "zero_allgather_partitions", "zero_reduce_bucket_size",
    "zero_reduce_scatter", "zero_contiguous_gradients", "zero_overlap_comm",
    "zero_sub_group_size", "zero_max_live_parameters",
    "zero_max_reuse_distance", "zero_prefetch_bucket_size",
    "zero_param_persistence_threshold", "zero_model_persistence_threshold",
    "zero_gather_16bit_weights_on_model_save", "zero_hpz_partition_size",
    "zero_quantized_weights", "zero_quantized_gradients", "mics_shard_size",
    "zero_cpu_offload", "zero_has_nvme_offload",
    "zero_round_robin_gradients", "fp16_enabled", "bfloat16_enabled",
    "fp16_auto_cast", "fp16_master_weights_and_gradients",
    "dynamic_loss_scale", "initial_dynamic_scale",
    "dynamic_loss_scale_args", "gradient_clipping",
    "gradient_predivide_factor", "postscale_gradients",
    "communication_data_type", "sparse_gradients_enabled",
    "steps_per_print", "wall_clock_breakdown", "optimizer_name",
    "scheduler_name", "scheduler_params", "elasticity_enabled",
    "autotuning_enabled", "flops_profiler_enabled",
    "flops_profiler_profile_step", "data_efficiency_enabled",
    "data_sampling_enabled", "data_sampling_config",
    "curriculum_learning_enabled", "curriculum_learning_config",
    "random_ltd_enabled", "random_ltd_config", "get_batch_info",
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "gradient_accumulation_steps"]


@pytest.mark.parametrize("over", [
    {},
    {"fp16": {"enabled": True, "loss_scale": 128.0, "auto_cast": True,
              "hysteresis": 3, "loss_scale_window": 50},
     "zero_optimization": {"stage": 3, "reduce_bucket_size": 1000,
                           "overlap_comm": False,
                           "stage3_max_live_parameters": 7,
                           "round_robin_gradients": True,
                           "zero_quantized_weights": True},
     "flops_profiler": {"enabled": True, "profile_step": 3},
     "data_efficiency": {"enabled": True, "data_sampling": {
         "enabled": True, "curriculum_learning": {"enabled": True}},
         "data_routing": {"random_ltd": {"enabled": True,
                                         "min_value": 16}}},
     "steps_per_print": 7, "wall_clock_breakdown": True}])
def test_config_accessors_match_jax(over):
    cfg = llama_config(**over)
    if "fp16" in over:
        cfg.pop("bf16")
    je, te = _pair(cfg)
    for name in ACCESSORS:
        assert getattr(te, name)() == getattr(je, name)(), name
    assert te.optimizer_params().lr == je.optimizer_params().lr
    assert te.zero_offload_optimizer().device == \
        je.zero_offload_optimizer().device
    assert te.aio_config().block_size == je.aio_config().block_size
    assert te.data_efficiency_config().data_routing == \
        je.data_efficiency_config().data_routing
