"""The port's training engine held against the JAX engine, on the CPU.

The JAX engine runs over one device (tests/conftest.py forces eight);
its initial ``state.params`` cross into the port through
``checkpoint/from_jax.py``, and both train on the same seeded numpy
batches.  Tolerances, fp32 (``"bf16": {"enabled": false}``, the debug
llama with GQA): losses and global grad norms rtol 1e-4 (measured
<= 1e-6 and <= 1e-5); final params 1e-4 absolute (Adam normalises every
update to ~lr = 1e-2, so an fp32 summation-order difference in a
near-zero gradient moves a weight by a small fraction of lr; measured
<= 2e-5) and 1e-4 in rms relative to the leaf (measured <= 3e-5).
"""

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
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.base import SimpleModel, random_dataset
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.models.llama import llama_config as model_config
from deepspeed_tpu_torch.models.transformer import check_flash_layout
from deepspeed_tpu_torch.models.transformer import forward as \
    transformer_forward
from deepspeed_tpu_torch.runtime.config import load_config

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
PARAM_RMS_REL = 1e-4
HIDDEN = 64


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def llama_config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "bf16": {"enabled": False},
           "gradient_clipping": 1.0,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"total_num_steps": 10,
                                    "warmup_num_steps": 3,
                                    "warmup_min_lr": 1e-3}}}
    cfg.update(over)
    return cfg


def jax_engine(model, cfg):
    topo = _topology_from_config(j_load_config(cfg),
                                 devices=jax.devices()[:1])
    engine, *_ = dst.initialize(model=model, config=cfg, topology=topo)
    return engine


def jax_params(engine):
    return jax.tree.map(np.asarray, meta.unbox(engine.state.params))


def token_batches(n, shape=(4, 32), vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, shape).astype(np.int32)}
            for _ in range(n)]


def assert_params_close(port, ref):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(port),
                            jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(path))
        rms = np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2))
        assert rms <= PARAM_RMS_REL, (path, rms)


# ---------------------------------------------------------------------------
# engine parity with JAX, the slice's bar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attention_impl,scan_layers", [
    ("auto", True), ("einsum", True), ("auto", False)])
def test_llama_training_matches_jax_engine(attention_impl, scan_layers):
    kw = dict(scan_layers=scan_layers, attention_impl=attention_impl)
    cfg = llama_config()
    je = jax_engine(JLlama("debug", dtype=jnp.float32, **kw), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32, **kw)
    params = from_jax(jax_params(je), model.cfg, device="cpu")
    te, opt, loader, sched = dtt.initialize(model=model, config=cfg,
                                            model_parameters=params,
                                            device="cpu")
    assert loader is None and opt is te.optimizer
    for batch in token_batches(5):
        ref = je.train_batch(batch)
        got = te.train_batch(batch)
        np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(),
                                   je.get_global_grad_norm(), rtol=LOSS_RTOL)
    assert te.global_steps == 5 and sched.last_batch_iteration == 5
    assert te.get_lr() == je.get_lr()
    assert_params_close(to_numpy(te.params), jax_params(je))


def test_simple_model_matches_jax_engine_in_bf16():
    """The JAX engine tests' base_config (tests/test_engine.py:24-44):
    bf16 compute (the default) over fp32 masters.  The model computes in
    fp32 on bf16-rounded weights and both engines round the gradients to
    bf16 before the fp32 sum, so the numbers stay within 1e-4 too."""
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": 0},
           "steps_per_print": 1000}
    je = jax_engine(JSimple(HIDDEN), cfg)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                          jax_params(je))
    te, *_ = dtt.initialize(model=SimpleModel(HIDDEN), config=cfg,
                            model_parameters=params, device="cpu")
    assert te.compute_dtype == torch.bfloat16
    data = random_dataset(10, HIDDEN, seed=3)
    for s in range(5):
        batch = {k: np.stack([d[k] for d in data[2 * s:2 * s + 2]])
                 for k in ("x", "y")}
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=LOSS_RTOL)
    assert_params_close(to_numpy(te.params), jax_params(je))


def test_fp32_masters_round_trip_through_the_bridge():
    je = jax_engine(JLlama("debug", dtype=jnp.float32), llama_config())
    ref = jax_params(je)
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    params = from_jax(ref, model.cfg, device="cpu")
    assert params["layers"]["attn"]["wq"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(to_numpy(params)), jax.tree.leaves(ref)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _port_engine(model=None, **over):
    model = model or LlamaForCausalLM("debug", dtype=torch.float32)
    params = model.init_params(seed=0, device="cpu")
    engine, *_ = dtt.initialize(model=model, config=llama_config(**over),
                                model_parameters=params, device="cpu")
    return engine


def test_remat_on_and_off_give_the_same_numbers():
    runs = []
    for remat in (True, False):
        engine = _port_engine(LlamaForCausalLM("debug", dtype=torch.float32,
                                               remat=remat))
        losses = [engine.train_batch(b) for b in token_batches(2)]
        runs.append((losses, engine.get_global_grad_norm(), engine.params))
    (la, na, pa), (lb, nb, pb) = runs
    assert la == lb and na == nb
    for a, b in zip(jax.tree.leaves(to_numpy(pa)), jax.tree.leaves(
            to_numpy(pb))):
        np.testing.assert_array_equal(a, b)


def test_forward_backward_step_matches_train_batch():
    a, b = _port_engine(), _port_engine()
    for batch in token_batches(2):
        ref = a.train_batch(batch)
        ids = batch["input_ids"]
        losses = []
        for mb in (ids[:2], ids[2:]):
            assert not b.is_gradient_accumulation_boundary()
            loss = b.forward({"input_ids": mb})
            b.backward(loss)
            losses.append(float(loss.detach()))
            b.step()                  # a no-op before the boundary
        assert b.global_steps == a.global_steps
        np.testing.assert_allclose(np.mean(losses), ref, rtol=1e-6)
    for x, y in zip(jax.tree.leaves(to_numpy(a.params)),
                    jax.tree.leaves(to_numpy(b.params))):
        np.testing.assert_array_equal(x, y)


def test_gradient_accumulation_equivalence():
    """gas=4 x micro 1 equals gas=1 x micro 4 over the same global batch
    (tests/test_engine.py:85-93), here in fp32."""
    runs = []
    for micro, gas in ((4, 1), (1, 4)):
        engine, *_ = dtt.initialize(
            model=SimpleModel(HIDDEN),
            model_parameters=SimpleModel(HIDDEN).init_params(0, "cpu"),
            config={"train_micro_batch_size_per_gpu": micro,
                    "gradient_accumulation_steps": gas,
                    "bf16": {"enabled": False}, "gradient_clipping": 1.0,
                    "optimizer": {"type": "adamw", "params": {"lr": 1e-2}}},
            device="cpu")
        rng = np.random.default_rng(0)
        runs.append([engine.train_batch(
            {k: rng.normal(size=(4, HIDDEN)).astype(np.float32)
             for k in ("x", "y")}) for _ in range(3)])
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5)


def test_training_lowers_the_loss_on_a_fixed_batch():
    engine = _port_engine(scheduler=None)
    batch = token_batches(1)[0]
    before = engine.eval_batch(batch)
    assert engine.global_steps == 0           # eval_batch does not train
    losses = [engine.train_batch(batch) for _ in range(4)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    # the loss of a 4-row batch is the mean of its two micro-batches'
    halves = [engine.eval_batch({"input_ids": batch["input_ids"][i:i + 2]})
              for i in (0, 2)]
    assert engine.eval_batch(batch) < before
    np.testing.assert_allclose(
        np.mean(halves), engine.eval_batch(batch), rtol=1e-2)
    assert (engine.global_steps, engine.micro_steps,
            engine.global_samples) == (4, 8, 16)


@pytest.mark.parametrize("over,match", [
    # fp16, every optimizer name, adam_w_mode=False and pure bf16 run since
    # the one-GPU training slice (tests/test_torch_fp16.py,
    # test_torch_optimizers_all.py); the multi-rank keys since the ranks
    # slice (below, and tests/test_torch_zero_ranks.py), tensor_parallel,
    # sequence_parallel and the tensor and seq mesh axes since the model
    # parallel slice (tests/test_torch_tensor_parallel.py); what still
    # raises:
    ({"moe": {"enabled": True}}, "moe"),
    ({"compression_training": {"weight_quantization": {"a": 1}}},
     "compression_training"),
    ({"pipeline": {"stages": 2}}, "pipeline"),
    ({"tpu": {"mesh": {"fsdp": -1, "pipe": 2}}}, "tpu.mesh"),
    ({"tpu": {"mesh": {"fsdp": -1, "expert": 2}}}, "tpu.mesh"),
])
def test_options_outside_the_slice_raise(over, match):
    with pytest.raises(NotImplementedError, match=match) as err:
        _port_engine(**over)
    assert "ROADMAP" in str(err.value)


@pytest.mark.parametrize("over,match", [
    ({"comm_optimization": {"enabled": True}}, "comm_optimization"),
    ({"zero_optimization": {"stage": 3, "zero_quantized_gradients": True}},
     "zero_quantized_gradients"),
    ({"zero_optimization": {"stage": 3, "mics_shard_size": 2}},
     "mics_shard_size"),
    ({"zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
     "zero_hpz_partition_size"),
    ({"tpu": {"mesh": {"data": 2}}}, "tpu.mesh"),
    ({"zero_optimization": {"stage": 2, "zero_quantized_gradients": True}},
     "zero_quantized_gradients"),
    ({"tensor_parallel": {"enabled": True}}, "tensor_parallel"),
    ({"tensor_parallel": {"enabled": True, "tp_size": 2}}, "tp_size"),
    ({"sequence_parallel": {"enabled": True, "sp_size": 2,
                            "mode": "ring"}}, "sp_size"),
    ({"tpu": {"mesh": {"fsdp": -1, "tensor": 2}}}, "tpu.mesh tensor"),
])
def test_multi_rank_options_at_one_rank_as_jax(over, match):
    """The keys of several ranks at one rank do what they do to the JAX
    engine on one device: a mesh the device count cannot hold (hpZ 2,
    MiCS 2, data 2) raises JAX's ValueError from the topology, and the
    scheduler's keys build no scheduler (nothing to reduce)."""
    cfg = llama_config(**over)
    try:
        _topology_from_config(j_load_config(cfg), devices=jax.devices()[:1])
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            _port_engine(**over)
        assert str(err.value) == str(e), match
        return
    engine = _port_engine(**over)
    assert engine.comm_scheduler is None and engine.comm_stats() is None
    assert engine.topology.world_size == 1, match


def test_unknown_zero_key_raises():
    with pytest.raises(NotImplementedError, match="stage3_typo"):
        load_config({"zero_optimization": {"stage": 3, "stage3_typo": 1}})
    with pytest.raises(ValueError, match="ZeRO stage"):
        load_config({"zero_optimization": {"stage": 4}})


def test_engine_calls_outside_the_slice_raise():
    """An unknown remat policy raises JAX's ValueError at the first
    forward; a batch-less ``train_batch`` on an engine without a loader
    is the JAX engine's ValueError."""
    engine = _port_engine()
    with pytest.raises(ValueError, match="no batch and no dataloader"):
        engine.train_batch()
    with pytest.raises(ValueError, match="unknown remat policy 'bogus'"):
        _port_engine(LlamaForCausalLM("debug", dtype=torch.float32,
                                      remat_policy="bogus")
                     ).train_batch(token_batches(1)[0])


def test_batch_arithmetic_follows_the_jax_rules(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text('{"train_batch_size": 8, '
                    '"train_micro_batch_size_per_gpu": 2}')
    cfg = load_config(str(path))
    cfg.resolve_batch_sizes()
    assert cfg.gradient_accumulation_steps == 4
    for given, want in (({"train_batch_size": 8,
                          "gradient_accumulation_steps": 2}, (8, 4, 2)),
                        ({"train_batch_size": 6}, (6, 6, 1)),
                        ({"train_micro_batch_size_per_gpu": 3}, (3, 3, 1)),
                        ({}, (1, 1, 1))):
        cfg = load_config(given)
        cfg.resolve_batch_sizes()
        assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                cfg.gradient_accumulation_steps) == want, given
    for bad in ({"train_batch_size": 6, "train_micro_batch_size_per_gpu": 2,
                 "gradient_accumulation_steps": 2},
                {"train_batch_size": 7, "train_micro_batch_size_per_gpu": 2},
                {"train_batch_size": 7, "gradient_accumulation_steps": 2}):
        with pytest.raises(ValueError, match="train_batch_size 7|6"):
            load_config(bad).resolve_batch_sizes()
    engine = _port_engine()
    with pytest.raises(ValueError, match="gas=2 x micro=2"):
        engine.train_batch({"input_ids": np.zeros((3, 8), np.int32)})


@pytest.mark.parametrize("impl", ["auto", "flash"])
@pytest.mark.parametrize("over", [dict(dtype=torch.float32),
                                  dict(head_dim=256)])
def test_flash_outside_the_kernels_layout_raises_on_the_card(impl, over):
    """On the card, "auto" and "flash" take the kernels' layout (bf16 at
    head_dim 64, 80, 96 or 128) or raise: they never run the dense path,
    which only "einsum" chooses.  On the CPU the plain versions take any
    layout.  The forward decides from its input's device before it reads
    a weight, so a meta tensor stands in for one on the card."""
    cfg = model_config("7b", attention_impl=impl, **over)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11k"):
        check_flash_layout(cfg, torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11k"):
        transformer_forward(cfg, {}, torch.zeros((1, 8), dtype=torch.int32,
                                                 device="meta"))
    check_flash_layout(cfg, torch.device("cpu"))
    for d in (64, 80, 96, 128):
        check_flash_layout(model_config("7b", attention_impl=impl,
                                        head_dim=d), torch.device("cuda"))


def test_initialize_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        dtt.initialize(model=SimpleModel(HIDDEN), config={})
