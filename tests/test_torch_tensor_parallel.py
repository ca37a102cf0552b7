"""Tensor and sequence parallelism in training: the port's ``tensor`` and
``seq`` mesh axes (Megatron-sharded blocks, DeepSpeed-Ulysses and ring
attention) held against the JAX engine on the same mesh.

Without ranks: the partitioner gives JAX's specs for every leaf under
``tensor`` 2, 4 and 8, with and without ``fsdp``, at stages 0-3 (the
debug llama with GQA, a BLOOM-layout config and the tied GPT preset);
each rank's piece of a leaf sharded over two axes is JAX's shard on
that device; the config's ``tensor_parallel``, ``sequence_parallel``
and ``tpu.mesh`` give JAX's topology (and its errors); the mesh's groups
and each rank's rows and tokens are where JAX places them.

Over ranks (gloo processes on the CPU, ``tests/torch_rank_worker.py``
through ``tests/torch_rank_launch.py``, one launch per world size):
each scenario trains 3 steps of gas 2 (one row a batch shard a
micro-batch, 32 tokens) in fp32 from the JAX engine's initial weights,
and each step's loss and global gradient norm, and rank r's master and
moment pieces after the steps, are held against the JAX engine over
``jax.devices()[:W]``.  The scenarios: tensor=2 at stage 0; tensor=2 x
seq=2 Ulysses at stage 1, once with ``partition_activations``; seq=4
ring on a Mistral-style config (GQA, a 12-token window under 32
tokens); seq=2 ring beside tensor=2; tensor=2 x fsdp=2 at stage 3;
tensor=2 x data=2 with ``comm_optimization`` (per layer: the scheduler
runs with the tensor shards' direct sums; stacked: JAX's gate keeps the
per-leaf sums); BLOOM's ALiBi at tensor=2 (the dense path); the GPT
preset at tensor=2 (tied, learned positions); tensor=4 on the debug
llama, whose 2 kv heads do not divide 4 (the repeat path, kv leaves
replicated).  Checkpoints move between tensor=2 x seq=2 and one rank
both ways, and the offline tools read the sharded save.  The direct op
tests: ring attention (causal, full, windowed) forward and backward
and the Ulysses sandwich against JAX's on the same inputs, and the
vocab-parallel cross-entropy against ``cross_entropy_loss`` with labels
< 0 and a mask.

Tolerances (fp32; gloo sums in its order, XLA in its own): losses and
gradient norms rtol 1e-5 (the int8 wire 1e-4); each master and first
moment piece within 2e-5 of the JAX shard's norm (measured <= 7.4e-6
and 1.4e-5), second moments within 4e-5 (measured 2.3e-5, the
embedding's at stage 3), masters within 1e-4 absolute; the int8 wire's
pieces within 2e-3 of the norm (measured 1.5e-3: codes that fp32
rounding moves across a rounding boundary); the key bias is skipped
(its gradient is zero, rounding noise in both packages); the op tests
2e-5 (ring, Ulysses) and 1e-6 (cross-entropy).
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta
from jax.sharding import NamedSharding, PartitionSpec as P

import deepspeed_tpu as dst
import deepspeed_tpu_torch as dtt
from deepspeed_tpu.checkpoint.hf import bloom_config_from_hf as j_bloom
from deepspeed_tpu.models.gpt import GPTForCausalLM as JGPT
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.models.transformer import CausalLM as JCausalLM
from deepspeed_tpu.models.transformer import cross_entropy_loss as j_ce
from deepspeed_tpu.parallel.topology import MeshTopology as JMesh
from deepspeed_tpu.parallel.topology import TopologyConfig as JTopo
from deepspeed_tpu.runtime.config import load_config as j_load_config
from deepspeed_tpu.runtime.engine import _topology_from_config
from deepspeed_tpu.runtime.zero.partitioner import \
    ZeroPartitioner as JPartitioner
from deepspeed_tpu.sequence.layer import \
    DistributedAttention as JDistributedAttention
from deepspeed_tpu.sequence.ring import ring_attention_sharded
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.checkpoint.from_jax import from_shards, to_shards
from deepspeed_tpu_torch.checkpoint.hf import bloom_config_from_hf
from deepspeed_tpu_torch.checkpoint.universal import (ds_to_universal,
                                                      leaf_paths)
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import \
    get_fp32_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.models.gpt import GPTForCausalLM
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.models.transformer import CausalLM
from deepspeed_tpu_torch.parallel import MESH_AXES, MeshTopology
from deepspeed_tpu_torch.parallel.topology import TopologyConfig
from deepspeed_tpu_torch.runtime.config import load_config
from deepspeed_tpu_torch.runtime.engine import topology_from_config
from deepspeed_tpu_torch.runtime.zero.partitioner import (
    ZeroPartitioner, blocked_dims_of, cut, leaf_names_of)
from deepspeed_tpu_torch.tree import tree_leaves
from test_torch_zero_ranks import _jax_state, nest
from torch_rank_launch import result, run_ranks, shared_root

LOSS_RTOL = 1e-5
QUANT_LOSS_RTOL = 1e-4
STATE_RTOL = 2e-5
#: Adam's second moments squash the gradients' summation order less
#: kindly (the embedding's and the norm scales')
NU_RTOL = 4e-5
QUANT_STATE_RTOL = 2e-3
PARAM_ATOL = 1e-4
OP_TOL = 2e-5
CE_TOL = 1e-6
#: (scenario, key, norm-relative error, max abs error) of every
#: comparison made
MEASURED = []
STEPS = 3
GAS = 2
SEQ = 32


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# models and configs
# ---------------------------------------------------------------------------

_BLOOM = types.SimpleNamespace(vocab_size=128, hidden_size=64, n_layer=2,
                               n_head=4, seq_length=64,
                               layer_norm_epsilon=1e-5)


def jax_model(name):
    if name == "llama":
        return JLlama("debug", dtype=jnp.float32)
    if name == "llama_window":
        return JLlama("debug", dtype=jnp.float32, sliding_window=12)
    if name == "gpt":
        return JGPT("debug", dtype=jnp.float32)
    if name == "bloom":
        return JCausalLM(dataclasses.replace(j_bloom(_BLOOM),
                                             dtype=jnp.float32))
    raise ValueError(name)


def port_model(name):
    if name == "llama":
        return LlamaForCausalLM("debug", dtype=torch.float32)
    if name == "llama_window":
        return LlamaForCausalLM("debug", dtype=torch.float32,
                                sliding_window=12)
    if name == "gpt":
        return GPTForCausalLM("debug", dtype=torch.float32)
    if name == "bloom":
        return CausalLM(dataclasses.replace(bloom_config_from_hf(_BLOOM),
                                            dtype=torch.float32))
    raise ValueError(name)


def config(stage, mesh=None, **extra):
    cfg = {"train_micro_batch_size_per_gpu": 1,
           "gradient_accumulation_steps": GAS,
           "bf16": {"enabled": False}, "gradient_clipping": 1.0,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 64},
           "checkpoint": {"async_save": False}}
    tpu = dict(extra.pop("tpu", {}))
    if mesh:
        tpu["mesh"] = mesh
    if tpu:
        cfg["tpu"] = tpu
    cfg.update(extra)
    return cfg


def _ring(sp):
    return {"enabled": True, "sp_size": sp, "mode": "ring"}


#: scenario -> (ranks, model, config)
SCENARIOS = {
    "tp2": (2, "llama", config(0, {"tensor": 2})),
    "tp2_sp2": (4, "llama", config(1, {"tensor": 2, "seq": 2})),
    "tp2_sp2_partitioned": (4, "llama", config(
        1, {"tensor": 2, "seq": 2}, activation_checkpointing={
            "partition_activations": True, "policy": "full"})),
    "sp4_ring_window": (4, "llama_window", config(
        0, sequence_parallel=_ring(4))),
    "sp2_ring_tp2": (4, "llama", config(
        0, {"tensor": 2}, sequence_parallel=_ring(2))),
    "tp2_fsdp2_stage3": (4, "llama", config(3, {"tensor": 2, "fsdp": 2})),
    # per-layer leaves: JAX keeps the scheduler, whose direct sums carry
    # the tensor shards; stacked layers: JAX's gate keeps its psum
    "tp2_data2_comm": (4, "llama", config(
        2, {"tensor": 2, "data": 2}, comm_optimization={"enabled": True},
        tpu={"scan_layers": False})),
    "tp2_data2_comm_stacked": (4, "llama", config(
        2, {"tensor": 2, "data": 2}, comm_optimization={"enabled": True})),
    "alibi_tp2": (2, "bloom", config(0, {"tensor": 2})),
    "gpt_tp2": (2, "gpt", config(0, {"tensor": 2})),
    "gqa_tp4": (4, "llama", config(0, {"tensor": 4})),
}
QUANTIZED = ("tp2_data2_comm",)


def _scan(cfg):
    return cfg.get("tpu", {}).get("scan_layers", True)


def batches(world_batch_shards, seed=0):
    rng = np.random.default_rng(seed)
    rows = GAS * world_batch_shards
    return {"input_ids": rng.integers(0, 128, (STEPS, rows, SEQ)
                                      ).astype(np.int32)}


_INIT = {}


def init_params(model, scan=True):
    """The JAX engine's initial weights of ``model`` (numpy by ``/``
    path), stacked or per layer."""
    key = (model, scan)
    if key not in _INIT:
        cfg = config(0, tpu={} if scan else {"scan_layers": False})
        topo = _topology_from_config(j_load_config(cfg),
                                     devices=jax.devices()[:1])
        je, *_ = dst.initialize(model=jax_model(model), config=cfg,
                                topology=topo)
        tree = jax.tree.map(np.asarray, meta.unbox(je.state.params))
        _INIT[key] = dict(zip(leaf_paths(tree), jax.tree.leaves(tree)))
    return dict(_INIT[key])


def _batch_shards(name):
    world, _, cfg = SCENARIOS[name]
    return topology_from_config(load_config(cfg), world_size=world, rank=0,
                                groups=False).batch_shard_size


def one_rank_engine(cfg, model="llama", rows=1):
    cfg = dict(cfg, train_micro_batch_size_per_gpu=rows)
    cfg.pop("tpu", None)
    cfg.pop("sequence_parallel", None)
    engine, *_ = dtt.initialize(
        model=port_model(model), config=cfg,
        model_parameters=nest(init_params(model)), device="cpu")
    return engine


# ---------------------------------------------------------------------------
# the rank launches
# ---------------------------------------------------------------------------

def seq_op_inputs():
    rng = np.random.default_rng(11)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    b, h, s, d = 1, 2, 64, 32
    labels = rng.integers(-1, 16, (2, 8)).astype(np.int64)
    return {"q": n(b, h, s, d), "k": n(b, h, s, d), "v": n(b, h, s, d),
            "ct": n(b, h, s, d), "window": np.int64(12),
            "uq": n(2, 16, 4, 8), "uk": n(2, 16, 4, 8), "uv": n(2, 16, 4, 8),
            "uct": n(2, 16, 4, 8), "logits": n(2, 8, 16) * 3,
            "labels": labels,
            "mask": (rng.random((2, 8)) > 0.2).astype(np.int64)}


def _plan(world):
    def build(d):
        scenarios = []
        for name, (w, model, cfg) in SCENARIOS.items():
            if w != world:
                continue
            scan = _scan(cfg)
            tag = f"{model}_{int(scan)}"
            params = os.path.join(d, f"params_{tag}.npz")
            if not os.path.exists(params):
                np.savez(params, **init_params(model, scan))
            bpath = os.path.join(d, f"batches_{name}.npz")
            np.savez(bpath, **batches(_batch_shards(name)))
            sc = {"name": name, "kind": "train", "model": model,
                  "params": params, "batches": bpath, "steps": STEPS,
                  "config": cfg}
            if name == "tp2_sp2":
                sc["save"] = os.path.join(d, "ckpt_mp")
            scenarios.append(sc)
        if world == 4:
            # a one-rank checkpoint of two steps, loaded by tensor=2 x
            # seq=2 ranks
            engine = one_rank_engine(config(1))
            b = batches(1)
            for s in range(2):
                engine.train_batch({k: v[s] for k, v in b.items()})
            engine.save_checkpoint(os.path.join(d, "ckpt_1"), tag="one")
            scenarios.append({
                "name": "load_one", "kind": "train", "model": "llama",
                "params": os.path.join(d, "params_llama_1.npz"),
                "batches": os.path.join(d, "batches_tp2_sp2.npz"),
                "steps": 0, "config": SCENARIOS["tp2_sp2"][2],
                "load": os.path.join(d, "ckpt_1")})
            np.savez(os.path.join(d, "seq_ops.npz"), **seq_op_inputs())
            scenarios.append({"name": "seq_ops", "kind": "seq_ops",
                              "inputs": os.path.join(d, "seq_ops.npz")})
        return {"scenarios": scenarios, "timeout": 120}
    return build


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    dirs = run_ranks(shared_root(tmp_path_factory),
                     [(f"mp_w{w}", w, _plan(w)) for w in (4, 2)])
    return {w: dirs[f"mp_w{w}"] for w in (4, 2)}


_JAX = {}


def jax_run(name):
    """The JAX engine's run of a scenario: (engine, losses, grad norms)."""
    if name not in _JAX:
        world, model, cfg = SCENARIOS[name]
        topo = _topology_from_config(j_load_config(cfg),
                                     devices=jax.devices()[:world])
        je, *_ = dst.initialize(model=jax_model(model), config=cfg,
                                topology=topo)
        b = batches(topo.batch_shard_size)
        losses, norms = [], []
        for s in range(STEPS):
            losses.append(float(je.train_batch(
                {k: v[s] for k, v in b.items()})))
            norms.append(float(je.get_global_grad_norm()))
        _JAX.clear()                    # one engine at a time
        _JAX[name] = (je, losses, norms)
    return _JAX[name]


def _close(got, ref, key, rtol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.linalg.norm(ref), 1e-30)
    rel = np.linalg.norm(got - ref) / scale
    MEASURED.append((name, key, rel, float(np.abs(got - ref).max())))
    assert rel <= rtol, (key, rel)
    if key.startswith("params/") and rtol <= STATE_RTOL:
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# over ranks, against the JAX engine on the same mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_losses_norms_and_shards_match_jax(ranks, name):
    world, _, _ = SCENARIOS[name]
    je, ref, ref_norms = jax_run(name)
    quant = name in QUANTIZED
    state = _jax_state(je)
    for r in range(world):
        res = result(ranks[world], name, r)
        assert res["mesh"] == dict(zip(je.topology.mesh.axis_names,
                                       je.topology.mesh.devices.shape))
        np.testing.assert_allclose(
            res["losses"], ref, rtol=QUANT_LOSS_RTOL if quant else LOSS_RTOL)
        np.testing.assert_allclose(
            res["grad_norms"], ref_norms,
            rtol=QUANT_LOSS_RTOL if quant else LOSS_RTOL)
        assert set(res["pieces"]) == set(state), name
        for key, piece in res["pieces"].items():
            jshard = np.asarray(state[key].addressable_shards[r].data)
            assert tuple(piece.shape) == jshard.shape, (key, r)
            if key.endswith("/attn/bk"):
                # the key bias's gradient is zero (softmax is
                # shift-invariant along a query row): rounding noise in
                # both packages, which Adam turns into steps of lr
                continue
            _close(piece.numpy(), jshard, key,
                   QUANT_STATE_RTOL if quant else
                   NU_RTOL if key.startswith("exp_avg_sq/") else STATE_RTOL,
                   name)


def test_the_scheduler_follows_jax_plan_leaf_by_leaf(ranks):
    """Per-layer leaves on tensor=2 x data=2: the tensor shards take the
    direct sums and the rest the int8 buckets, JAX's wire accounting to
    the byte; stacked layers: no scheduler, as JAX's gate."""
    je, _, _ = jax_run("tp2_data2_comm")
    stats = je.comm_stats()
    assert stats["comm_quantized_fraction"] < 1.0
    for r in range(4):
        res = result(ranks[4], "tp2_data2_comm", r)
        assert res["stats"] == {**stats, "reduce_axes": list(
            stats["reduce_axes"])}
    je, _, _ = jax_run("tp2_data2_comm_stacked")
    assert je.comm_scheduler is None
    assert "stats" not in result(ranks[4], "tp2_data2_comm_stacked", 0)


def test_stage3_describe_and_pieces_follow_jax(ranks):
    """tensor=2 x fsdp=2 at stage 3: the ranks describe JAX's compute
    specs line for line and hand the model pieces of JAX's shard
    shapes."""
    world, model, cfg = SCENARIOS["tp2_fsdp2_stage3"]
    topo = _topology_from_config(j_load_config(cfg),
                                 devices=jax.devices()[:world])
    part = JPartitioner(topo, 3, persistence_threshold=64)
    abstract = jax.eval_shape(jax_model(model).init_params,
                              jax.random.key(0))
    specs = part.tree_param_specs(abstract)
    unboxed = meta.unbox(abstract)
    want = {path: NamedSharding(topo.mesh, spec).shard_shape(leaf.shape)
            for path, leaf, spec in zip(
                leaf_paths(unboxed), jax.tree.leaves(unboxed),
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P)))}
    for r in range(world):
        res = result(ranks[world], "tp2_fsdp2_stage3", r)
        assert res["compute_shapes"] == want, r
        assert res["describe"] == part.describe(abstract)


def test_a_tp_sp_checkpoint_loads_into_one_rank(ranks, tmp_path):
    """Rank 0 wrote one-rank files from the tensor and ZeRO pieces: a
    one-rank engine loads them and holds the ranks' gathered masters
    and moments bit for bit; from_shards of the ranks' pieces gives the
    same leaves; the offline tools read the save."""
    d = ranks[4]
    engine = one_rank_engine(config(1))
    engine.load_checkpoint(os.path.join(d, "ckpt_mp"), tag="ranks")
    whole = result(d, "tp2_sp2", 0)["whole"]
    flat = dict(zip(leaf_paths(whole), tree_leaves(whole)))
    for path, m in zip(engine.param_paths, engine.masters):
        np.testing.assert_array_equal(m.numpy(), flat[path])
    _, _, cfg = SCENARIOS["tp2_sp2"]
    topo = topology_from_config(load_config(cfg), world_size=4, rank=0,
                                groups=False)
    part = ZeroPartitioner(topo, 1, names=leaf_names_of(port_model("llama")))
    specs = part.tree_master_specs(nest(init_params("llama")))
    pieces = [result(d, "tp2_sp2", r)["pieces"] for r in range(4)]
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        by_rank = [nest({k.split("/", 1)[1]: v.numpy()
                         for k, v in p.items() if k.startswith(kind + "/")})
                   for p in pieces]
        tree = from_shards(by_rank, specs, topo)
        got = dict(zip(leaf_paths(tree), tree_leaves(tree)))
        for path, m in zip(engine.param_paths, engine.masters):
            ref = (m if kind == "params"
                   else engine.optimizer.state[m][kind]).numpy()
            np.testing.assert_array_equal(got[path], ref)
    assert engine.global_steps == STEPS
    fp32 = get_fp32_state_dict_from_zero_checkpoint(
        os.path.join(d, "ckpt_mp"), tag="ranks")
    for path, arr in zip(leaf_paths(fp32), tree_leaves(fp32)):
        np.testing.assert_array_equal(np.asarray(arr), flat[path])
    udir = ds_to_universal(os.path.join(d, "ckpt_mp"), tag="ranks",
                           out_dir=str(tmp_path / "u"))
    engine = one_rank_engine(dict(config(1), checkpoint={
        "async_save": False, "load_universal": True}))
    engine.load_checkpoint(udir)
    for path, m in zip(engine.param_paths, engine.masters):
        np.testing.assert_array_equal(m.numpy(), flat[path])


def test_a_one_rank_checkpoint_loads_into_tp_sp_ranks(ranks):
    """Every rank keeps its tensor shard's ZeRO piece of what one rank
    saved (to_shards of the one-rank engine's leaves)."""
    d = ranks[4]
    engine = one_rank_engine(config(1))
    engine.load_checkpoint(os.path.join(d, "ckpt_1"))
    _, _, cfg = SCENARIOS["tp2_sp2"]
    names = leaf_names_of(port_model("llama"))
    for r in range(4):
        topo = topology_from_config(load_config(cfg), world_size=4, rank=r,
                                    groups=False)
        part = ZeroPartitioner(topo, 1, names=names)
        res = result(d, "load_one", r)
        want = to_shards(engine.params, part)
        for path, piece in zip(leaf_paths(want), tree_leaves(want)):
            np.testing.assert_array_equal(
                res["pieces"][f"params/{path}"].numpy(), piece.numpy())
        for path, m in zip(engine.param_paths, engine.masters):
            spec = part.master_spec(m, path)
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    res["pieces"][f"{k}/{path}"].numpy(),
                    cut(engine.optimizer.state[m][k], spec, topo).numpy())


# ---------------------------------------------------------------------------
# the direct op tests
# ---------------------------------------------------------------------------

def _stack_blocks(ranks, key, dim):
    return np.concatenate([result(ranks[4], "seq_ops", r)[key].numpy()
                           for r in range(4)], axis=dim)


@pytest.mark.parametrize("case", ["causal", "full", "window"])
def test_ring_attention_forward_and_backward_match_jax(ranks, case):
    x = seq_op_inputs()
    topo = JMesh(JTopo(data=1, seq=4), devices=jax.devices()[:4])
    causal = case != "full"
    window = int(x["window"]) if case == "window" else None
    q, k, v, ct = (jnp.asarray(x[n]) for n in ("q", "k", "v", "ct"))

    def loss(q, k, v):
        out = ring_attention_sharded(q, k, v, topo.mesh, causal=causal,
                                     window=window)
        return (out * ct).sum(), out
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(q, k, v)
    np.testing.assert_allclose(_stack_blocks(ranks, f"{case}_out", 2),
                               np.asarray(out), atol=OP_TOL, rtol=OP_TOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(
            _stack_blocks(ranks, f"{case}_{name}", 2), np.asarray(g),
            atol=OP_TOL, rtol=OP_TOL, err_msg=f"{case} {name}")
    # two calls sum in the same order: bit-equal
    assert all(result(ranks[4], "seq_ops", r)[f"{case}_bit_equal"]
               for r in range(4))
    if case == "causal":
        # the convenience entry gives every rank the whole output
        for r in range(4):
            np.testing.assert_allclose(
                result(ranks[4], "seq_ops", r)["sharded_out"].numpy(),
                np.asarray(out), atol=OP_TOL, rtol=OP_TOL)


def test_distributed_attention_matches_jax(ranks):
    x = seq_op_inputs()
    topo = JMesh(JTopo(data=1, seq=4), devices=jax.devices()[:4])

    def local(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        n = s.shape[-1]
        s = jnp.where(jnp.tril(jnp.ones((n, n), bool)), s, -jnp.inf)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)
    spec = P(None, "seq", None, None)
    fn = shard_map(JDistributedAttention(local, axis_name="seq"),
                   mesh=topo.mesh, in_specs=(spec, spec, spec),
                   out_specs=spec, check_vma=False)
    q, k, v, ct = (jnp.asarray(x[n]) for n in ("uq", "uk", "uv", "uct"))
    out, vjp = jax.vjp(fn, q, k, v)
    grads = vjp(ct)
    np.testing.assert_allclose(_stack_blocks(ranks, "ulysses_out", 1),
                               np.asarray(out), atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(local(q, k, v)), atol=OP_TOL)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(
            _stack_blocks(ranks, f"ulysses_{name}", 1), np.asarray(g),
            atol=OP_TOL, rtol=OP_TOL, err_msg=name)


def test_vocab_parallel_cross_entropy_matches_jax(ranks):
    """Four vocab shards: the loss over the whole vocabulary with labels
    < 0 and a mask, and each rank's columns of its gradient."""
    x = seq_op_inputs()
    logits = jnp.asarray(x["logits"])
    labels, mask = jnp.asarray(x["labels"]), jnp.asarray(x["mask"])
    assert (x["labels"] < 0).any() and (x["mask"] == 0).any()
    loss, g = jax.value_and_grad(j_ce)(logits, labels, mask)
    for r in range(4):
        res = result(ranks[4], "seq_ops", r)
        np.testing.assert_allclose(float(res["ce_loss"]), float(loss),
                                   rtol=CE_TOL)
    np.testing.assert_allclose(_stack_blocks(ranks, "ce_grad", 2),
                               np.asarray(g), atol=CE_TOL)


# ---------------------------------------------------------------------------
# without ranks: the partitioner, the pieces, the config and the mesh
# ---------------------------------------------------------------------------

def _abstract(name):
    jm, tm = jax_model(name), port_model(name)
    return jax.eval_shape(jm.init_params, jax.random.key(0)), tm


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pl for k in tree
                for pl in _leaves_with_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


MESHES = [(2, 1), (2, 2), (4, 1), (4, 2), (8, 1)]


@pytest.mark.parametrize("model", ["llama", "bloom", "gpt"])
@pytest.mark.parametrize("tensor,fsdp", MESHES)
def test_every_leaf_spec_equals_jax_under_tensor(model, tensor, fsdp):
    """Stages 0-3: the divisibility drop (H=4 under tensor=8, the 2 kv
    heads replicated), the vocab and mlp shards, and ``add_fsdp_axis``
    on another dimension of a tensor-sharded leaf."""
    abstract, tm = _abstract(model)
    world = tensor * fsdp
    for stage in range(4):
        cfg = config(stage, {"tensor": tensor, "fsdp": fsdp})
        jt = _topology_from_config(j_load_config(cfg),
                                   devices=jax.devices()[:world])
        tt = topology_from_config(load_config(cfg), world_size=world, rank=0,
                                  groups=False)
        jp = JPartitioner(jt, stage, persistence_threshold=64)
        tp = ZeroPartitioner(tt, stage, persistence_threshold=64,
                             blocked=blocked_dims_of(tm),
                             names=leaf_names_of(tm))
        for path, leaf in _leaves_with_paths(abstract):
            shape = np.shape(getattr(leaf, "value", leaf))
            meta_leaf = torch.empty(shape, device="meta")
            for kind in ("param_spec", "master_spec", "grad_spec"):
                want = tuple(getattr(jp, kind)(leaf))
                got = getattr(tp, kind)(meta_leaf, path)
                assert got == want, (model, tensor, fsdp, stage, path, kind)


def test_each_rank_piece_of_a_two_axis_leaf_is_the_jax_shard():
    """A leaf sharded over tensor on one dim and fsdp on another: rank
    r's piece (its tensor shard's ZeRO chunk) is device r's shard."""
    cfg = config(1, {"tensor": 2, "fsdp": 2})
    jt = _topology_from_config(j_load_config(cfg), devices=jax.devices()[:4])
    spec = ("fsdp", None, "tensor")
    x = np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)
    arr = jax.device_put(x, NamedSharding(jt.mesh, P(*spec)))
    for shard in arr.addressable_shards:
        topo = topology_from_config(load_config(cfg), world_size=4,
                                    rank=shard.device.id, groups=False)
        np.testing.assert_array_equal(
            cut(torch.from_numpy(x), spec, topo).numpy(),
            np.asarray(shard.data))


CONFIGS = {
    "mesh": config(1, {"tensor": 2, "seq": 2}),
    "sections": config(0, tensor_parallel={"enabled": True, "tp_size": 2},
                       sequence_parallel={"enabled": True, "sp_size": 2}),
    "sections_stage1": config(1, tensor_parallel={"enabled": True,
                                                  "tp_size": 2}),
    "mics": dict(config(3, tensor_parallel={"enabled": True, "tp_size": 2}),
                 zero_optimization={"stage": 3, "mics_shard_size": 2}),
    "mesh_wins": config(0, {"tensor": 4},
                        tensor_parallel={"enabled": True, "tp_size": 2}),
    "disabled_sections": config(
        1, tensor_parallel={"enabled": False, "tp_size": 2},
        sequence_parallel={"enabled": False, "sp_size": 2}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_topology_from_config_equals_jax(name):
    cfg = CONFIGS[name]
    for world in (4, 8):
        jt = _topology_from_config(j_load_config(cfg),
                                   devices=jax.devices()[:world])
        tt = topology_from_config(load_config(cfg), world_size=world,
                                  rank=0, groups=False)
        assert tt.shape == tuple(jt.mesh.devices.shape), (name, world)


@pytest.mark.parametrize("cfg", [
    config(0, tensor_parallel={"enabled": True, "tp_size": 3}),
    config(0, sequence_parallel={"enabled": True, "sp_size": 8}),
    config(0, {"tensor": 3, "fsdp": 1}),
])
def test_axes_that_do_not_divide_raise_as_jax(cfg):
    with pytest.raises(ValueError) as jerr:
        _topology_from_config(j_load_config(cfg), devices=jax.devices()[:4])
    with pytest.raises(ValueError) as terr:
        topology_from_config(load_config(cfg), world_size=4, rank=0,
                             groups=False)
    assert str(terr.value) == str(jerr.value)


def test_config_sections_parse_and_a_bad_mode_raises():
    cfg = load_config(config(0, sequence_parallel=_ring(2),
                             tensor_parallel={"enabled": True,
                                              "tp_size": 2}))
    assert (cfg.sequence_parallel.mode, cfg.sequence_parallel.sp_size,
            cfg.tensor_parallel.tp_size) == ("ring", 2, 2)
    with pytest.raises(ValueError, match="sequence_parallel.mode"):
        load_config({"sequence_parallel": {"enabled": True,
                                           "mode": "spiral"}})
    with pytest.raises(NotImplementedError, match="tp_degree"):
        load_config({"tensor_parallel": {"tp_degree": 2}})


@pytest.mark.parametrize("mesh", [{"tensor": 2, "seq": 2},
                                  {"seq": 2, "tensor": 2, "data": 2},
                                  {"tensor": 4, "fsdp": 2}])
def test_mesh_groups_rows_and_tokens_equal_jax(mesh):
    """Each rank sits where JAX's mesh puts device r, its tensor, seq and
    model-parallel groups are JAX's, and its rows and tokens of a
    [B, S] batch are the block JAX's batch sharding places there."""
    world = int(np.prod(list(mesh.values())))
    cfg = config(1, mesh)
    jt = _topology_from_config(j_load_config(cfg),
                               devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jt.mesh.devices)
    sharding = NamedSharding(jt.mesh, jt.batch_spec())
    placed = sharding.devices_indices_map((8, 16))
    for dev, idx in placed.items():
        r = dev.id
        tt = topology_from_config(load_config(cfg), world_size=world,
                                  rank=r, groups=False)
        pos = tuple(int(i[0]) for i in np.nonzero(ids == r))
        for axes in (("tensor",), ("seq",), ("seq", "tensor")):
            sl = tuple(slice(None) if a in axes else p
                       for a, p in zip(MESH_AXES, pos))
            assert tt.members(axes) == tuple(
                int(i) for i in ids[sl].reshape(-1)), (mesh, r, axes)
        rows, toks = tt.batch_slice(8), tt.seq_slice(16)
        assert (rows.start, rows.stop) == (idx[0].start or 0,
                                           idx[0].stop or 8)
        assert (toks.start, toks.stop) == (idx[1].start or 0,
                                           idx[1].stop or 16)


def test_seq_on_a_model_without_tokens_raises():
    topo = MeshTopology(TopologyConfig(data=1, seq=2), world_size=2,
                        rank=0, groups=False)
    with pytest.raises(NotImplementedError, match="seq axis"):
        dtt.initialize(model=SimpleModel(8), topology=topo, device="cpu",
                       config={"train_micro_batch_size_per_gpu": 1})
