"""Training across ranks: the port's gloo rank processes held against the
JAX engine on the same number of virtual devices, and against the port
at one rank.

The ranks (``tests/torch_rank_worker.py``) are launched once per session
through ``deepspeed_tpu_torch.launcher.launch`` (``tests/
torch_rank_launch.py``): four ranks for ZeRO stages 0-3, hpZ (fsdp 2 x
hpz 2), MiCS (data 2 x fsdp 2), Lion and LAMB at stage 2 and the
checkpoints, two ranks for stages 1 and 3 again.  Both engines start
from the JAX engine's initial weights (equal on every mesh) and train
in fp32 on the same seeded batches (3 steps, gas 2, one row a rank a
micro-batch): the debug llama at stage 3 (its layers gathered one by
one), hpZ and MiCS, the 64-wide MLP elsewhere.  The JAX engine runs in this process
over ``jax.devices()[:W]``; rank r's pieces compare with the JAX
arrays' ``addressable_shards[r]``.

Tolerances (fp32, lr 1e-3; the ranks sum in gloo's order, XLA in its
own): losses rtol 1e-5 (measured <= 2e-7); every master and moment
piece within 1e-5 of its leaf's norm of the port's own one-rank stage-0
run on the same global batch, and within 2e-5 of the JAX shard's norm
(measured: masters <= 9e-7, moments <= 1.4e-5, the worst the embedding's
second moment, whose gap to JAX is the one-rank port's own: 1.38e-5 on
the same run), masters also within 1e-4 absolute.  At lr 1e-2 Adam
moves every weight by half its scale in three steps and turns
summation-order rounding into 2.5e-5 of the embedding's norm, at one
rank as at four.  Checkpoints move between rank counts bit for bit.
"""

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
from deepspeed_tpu_torch.checkpoint.from_jax import from_shards, to_shards
from deepspeed_tpu_torch.checkpoint.universal import (ds_to_universal,
                                                      leaf_paths)
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import \
    get_fp32_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.parallel import MeshTopology, TopologyConfig
from deepspeed_tpu_torch.runtime.zero.partitioner import ZeroPartitioner
from deepspeed_tpu_torch.tree import tree_leaves
from torch_rank_launch import result, run_ranks, shared_root

LOSS_RTOL = 1e-5
STATE_RTOL = 1e-5
STATE_RTOL_JAX = 2e-5
PARAM_ATOL = 1e-4
#: (key, norm-relative error, max abs error) of every comparison made
MEASURED = []
STEPS = 3
GAS = 2
SEQ = 32


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def config(stage, optimizer="adamw", **zero):
    return {"train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": GAS,
            "bf16": {"enabled": False}, "gradient_clipping": 1.0,
            "optimizer": {"type": optimizer,
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": 64,
                                  **zero},
            "checkpoint": {"async_save": False}}


#: scenario -> (ranks, model, config).  Stage 3's layer-by-layer gathers
#: run on the debug llama (scan-stacked layers); the stages below it,
#: the optimizers and two ranks on the MLP, whose stage 3 gathers the
#: whole tree before the loss
SCENARIOS = {
    "stage0": (4, "simple64", config(0)),
    "stage1": (4, "simple64", config(1)),
    "stage2": (4, "simple64", config(2)),
    "stage3": (4, "llama", config(3)),
    "hpz": (4, "llama", config(3, zero_hpz_partition_size=2)),
    "mics": (4, "llama", config(3, mics_shard_size=2)),
    # JAX's gates turn the collective scheduler off on an hpz mesh: the
    # qgZ flag then changes nothing, and stage 3 keeps its pieces
    "hpz_qgz": (4, "llama", config(3, zero_hpz_partition_size=2,
                                   zero_quantized_gradients=True)),
    "lion_stage2": (4, "simple64", config(2, "lion")),
    "lamb_stage2": (4, "simple64", config(2, "lamb")),
    # qwZ with Lion (JAX's qwZ parity holds under Lion: under AdamW a
    # rounding-noise gradient moves a weight a whole int8 step); the
    # llama's leaves snap piece by piece where the pieces are whole
    # blocks (wq, embed) and gathered elsewhere (mlp, 44 columns a rank)
    "qwz_lion": (4, "llama", config(3, "lion", zero_quantized_weights=True)),
    "stage1_w2": (2, "simple64", config(1)),
    "stage3_w2": (2, "simple64", config(3)),
}
HIDDEN = 64


def jax_model(name):
    if name == "llama":
        return JLlama("debug", dtype=jnp.float32)
    return JSimple(HIDDEN)


def port_model(name):
    if name == "llama":
        return LlamaForCausalLM("debug", dtype=torch.float32)
    return SimpleModel(HIDDEN)


def batches(model, world, seed=0):
    rng = np.random.default_rng(seed)
    rows = GAS * world
    if model == "llama":
        return {"input_ids": rng.integers(0, 128, (STEPS, rows, SEQ)
                                          ).astype(np.int32)}
    return {k: rng.standard_normal((STEPS, rows, HIDDEN)).astype(np.float32)
            for k in ("x", "y")}


_INIT = {}


def init_params(model):
    """The JAX engine's initial weights of ``model``, numpy by ``/``
    path."""
    if model not in _INIT:
        cfg = config(0)
        topo = _topology_from_config(j_load_config(cfg),
                                     devices=jax.devices()[:1])
        je, *_ = dst.initialize(model=jax_model(model), config=cfg,
                                topology=topo)
        tree = jax.tree.map(np.asarray, meta.unbox(je.state.params))
        _INIT[model] = dict(zip(leaf_paths(tree), jax.tree.leaves(tree)))
    return dict(_INIT[model])


def nest(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *head, last = key.split("/")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = torch.from_numpy(np.array(arr))
    return tree


def one_rank_engine(cfg, world, model="simple64"):
    cfg = dict(cfg, train_micro_batch_size_per_gpu=world)
    engine, *_ = dtt.initialize(
        model=port_model(model), config=cfg,
        model_parameters=nest(init_params(model)), device="cpu")
    return engine


def _plan(world):
    def build(d):
        scenarios = []
        for model in ("llama", "simple64"):
            np.savez(os.path.join(d, f"params_{model}.npz"),
                     **init_params(model))
            np.savez(os.path.join(d, f"batches_{model}.npz"),
                     **batches(model, world))
        for name, (w, model, cfg) in SCENARIOS.items():
            if w != world:
                continue
            sc = {"name": name, "kind": "train", "model": model,
                  "params": os.path.join(d, f"params_{model}.npz"),
                  "batches": os.path.join(d, f"batches_{model}.npz"),
                  "steps": STEPS, "config": cfg}
            if name == "stage2":
                sc["save"] = os.path.join(d, "ckpt_w4")
            scenarios.append(sc)
        if world == 4:
            # a one-rank checkpoint of the stage-2 run's first two steps,
            # loaded by four ranks
            engine = one_rank_engine(config(2), 4)
            b = batches("simple64", 4)
            for s in range(2):
                engine.train_batch({k: v[s] for k, v in b.items()})
            engine.save_checkpoint(os.path.join(d, "ckpt_1"), tag="one")
            scenarios.append({
                "name": "load_one", "kind": "train", "model": "simple64",
                "params": os.path.join(d, "params_simple64.npz"),
                "batches": os.path.join(d, "batches_simple64.npz"),
                "steps": 0, "config": config(2),
                "load": os.path.join(d, "ckpt_1")})
        return {"scenarios": scenarios, "timeout": 120}
    return build


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    dirs = run_ranks(shared_root(tmp_path_factory),
                     [(f"zero_w{w}", w, _plan(w)) for w in (4, 2)])
    return {w: dirs[f"zero_w{w}"] for w in (4, 2)}


_JAX = {}


def jax_run(name):
    """The JAX engine's run of a scenario: (engine, losses)."""
    if name not in _JAX:
        world, model, cfg = SCENARIOS[name]
        topo = _topology_from_config(j_load_config(cfg),
                                     devices=jax.devices()[:world])
        je, *_ = dst.initialize(model=jax_model(model), config=cfg,
                                topology=topo)
        b = batches(model, world)
        losses = [float(je.train_batch({k: v[s] for k, v in b.items()}))
                  for s in range(STEPS)]
        _JAX.clear()                    # one engine at a time
        _JAX[name] = (je, losses)
    return _JAX[name]


def _jax_state(je):
    """path -> the JAX arrays of the masters and the moments, under the
    port's names (optax mu -> exp_avg, nu -> exp_avg_sq)."""
    out = {}

    def add(prefix, tree):
        tree = meta.unbox(tree)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/" + "/".join(str(k.key) for k in path)] = leaf
    add("params", je.state.params)
    for st in jax.tree_util.tree_leaves(
            je.state.opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(st, "mu"):
            add("exp_avg", st.mu)
            if getattr(st, "nu", None) is not None:
                add("exp_avg_sq", st.nu)
    return out


def _close(got, ref, key, rtol=STATE_RTOL):
    """Within ``rtol`` of ``ref``'s norm (the leaf's scale), and for
    the parameters within PARAM_ATOL everywhere."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.linalg.norm(ref), 1e-30)
    rel = np.linalg.norm(got - ref) / scale
    MEASURED.append((key, rel, float(np.abs(got - ref).max())))
    assert rel <= rtol, (key, rel)
    if key.startswith("params/"):
        np.testing.assert_allclose(got, ref, rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_losses_and_shards_match_jax(ranks, name):
    world, _, _ = SCENARIOS[name]
    je, ref = jax_run(name)
    state = _jax_state(je)
    for r in range(world):
        res = result(ranks[world], name, r)
        np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL)
        assert set(res["pieces"]) == set(state), name
        for key, piece in res["pieces"].items():
            jshard = np.asarray(state[key].addressable_shards[r].data)
            assert tuple(piece.shape) == jshard.shape, (key, r)
            _close(piece.numpy(), jshard, key, STATE_RTOL_JAX)
    assert res["mesh"] == dict(zip(je.topology.mesh.axis_names,
                                   je.topology.mesh.devices.shape))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_matches_stage0_at_one_rank(ranks, name):
    """The one-rank run of the same global batch: stage 0, or under qwZ
    stage 3 (at one rank the partition is the identity, and qwZ acts at
    stage 3 only)."""
    world, model, cfg = SCENARIOS[name]
    zero = {"stage": 0}
    if cfg["zero_optimization"].get("zero_quantized_weights"):
        zero = {"stage": 3, "zero_quantized_weights": True}
    engine = one_rank_engine(dict(cfg, zero_optimization=zero), world,
                             model)
    b = batches(model, world)
    ref = [engine.train_batch({k: v[s] for k, v in b.items()})
           for s in range(STEPS)]
    res = result(ranks[world], name, 0)
    np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL)
    whole = dict(zip(leaf_paths(res["whole"]), tree_leaves(res["whole"])))
    for path, m in zip(engine.param_paths, engine.masters):
        _close(whole[path], m.numpy(), f"params/{path}")


def _partitioner(world, rank, cfg):
    """Rank ``rank``'s partitioner of a stage-2 run (every rank on
    fsdp), without process groups."""
    zcfg = cfg["zero_optimization"]
    topo = MeshTopology(TopologyConfig(data=1, fsdp=world),
                        world_size=world, rank=rank, groups=False)
    return topo, ZeroPartitioner(
        topo, zcfg["stage"],
        persistence_threshold=zcfg["stage3_param_persistence_threshold"])


def test_a_four_rank_checkpoint_loads_into_one_rank(ranks):
    """Rank 0 wrote the one-rank files: a one-rank engine loads them and
    holds the four ranks' gathered masters and moments bit for bit, and
    to_shards of what it loaded gives every rank's pieces back."""
    d = ranks[4]
    engine = one_rank_engine(config(2), 4)
    engine.load_checkpoint(os.path.join(d, "ckpt_w4"), tag="ranks")
    whole = result(d, "stage2", 0)["whole"]
    flat = dict(zip(leaf_paths(whole), tree_leaves(whole)))
    for path, m in zip(engine.param_paths, engine.masters):
        np.testing.assert_array_equal(m.numpy(), flat[path])
    pieces = [result(d, "stage2", r)["pieces"] for r in range(4)]
    topo, part = _partitioner(4, 0, config(2))
    specs = part.tree_master_specs(engine.params)
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


def test_a_one_rank_checkpoint_loads_into_four_ranks(ranks):
    d = ranks[4]
    engine = one_rank_engine(config(2), 4)
    engine.load_checkpoint(os.path.join(d, "ckpt_1"))
    for r in range(4):
        _, part = _partitioner(4, r, config(2))
        res = result(d, "load_one", r)
        want = to_shards(engine.params, part)
        for path, piece in zip(leaf_paths(want), tree_leaves(want)):
            np.testing.assert_array_equal(
                res["pieces"][f"params/{path}"].numpy(), piece.numpy())
        for path, m in zip(engine.param_paths, engine.masters):
            lay = part.master_layout(m, path)
            for k in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    res["pieces"][f"{k}/{path}"].numpy(),
                    lay.shard(engine.optimizer.state[m][k]).numpy())


def test_offline_tools_read_a_four_rank_checkpoint(ranks, tmp_path):
    """zero_to_fp32 and ds_to_universal read what the four ranks wrote:
    the whole masters, and a one-rank engine loading the universal atoms
    holds them bit for bit."""
    d = os.path.join(ranks[4], "ckpt_w4")
    whole = result(ranks[4], "stage2", 0)["whole"]
    flat = dict(zip(leaf_paths(whole), tree_leaves(whole)))
    fp32 = get_fp32_state_dict_from_zero_checkpoint(d, tag="ranks")
    for path, arr in zip(leaf_paths(fp32), tree_leaves(fp32)):
        np.testing.assert_array_equal(np.asarray(arr), flat[path])
    udir = ds_to_universal(d, tag="ranks", out_dir=str(tmp_path / "u"))
    engine = one_rank_engine(dict(config(2), checkpoint={
        "async_save": False, "load_universal": True}), 4)
    engine.load_checkpoint(udir)
    for path, m in zip(engine.param_paths, engine.masters):
        np.testing.assert_array_equal(m.numpy(), flat[path])


def test_stage3_describe_follows_jax_specs(ranks):
    """The stage-3 ranks describe the same compute specs as JAX's
    partitioner over the same mesh, line for line."""
    from deepspeed_tpu.parallel.topology import MeshTopology as JMesh
    from deepspeed_tpu.parallel.topology import TopologyConfig as JTopo
    from deepspeed_tpu.runtime.zero.partitioner import \
        ZeroPartitioner as JPartitioner
    model = jax_model("llama")
    abstract = jax.eval_shape(model.init_params, jax.random.key(0))
    part = JPartitioner(JMesh(JTopo(data=1, fsdp=4),
                              devices=jax.devices()[:4]), 3,
                        persistence_threshold=64)
    text = result(ranks[4], "stage3", 0)["describe"]
    assert text == part.describe(abstract)


@pytest.mark.parametrize("name", sorted(
    n for n, (w, _, cfg) in SCENARIOS.items()
    if w == 4 and cfg["zero_optimization"]["stage"] == 3))
def test_stage3_compute_pieces_follow_jax_param_specs(ranks, name):
    """Every rank hands the model the compute pieces of JAX's
    ``param_spec`` over the same mesh (the shard shapes of its
    ``NamedSharding``), smaller than the whole leaf where JAX shards."""
    from jax.sharding import NamedSharding
    from deepspeed_tpu.runtime.zero.partitioner import \
        ZeroPartitioner as JPartitioner
    world, model, cfg = SCENARIOS[name]
    topo = _topology_from_config(j_load_config(cfg),
                                 devices=jax.devices()[:world])
    part = JPartitioner(topo, 3, persistence_threshold=cfg[
        "zero_optimization"]["stage3_param_persistence_threshold"])
    abstract = jax.eval_shape(jax_model(model).init_params,
                              jax.random.key(0))
    specs = part.tree_param_specs(abstract)
    want = {
        path: NamedSharding(topo.mesh, spec).shard_shape(leaf.shape)
        for path, leaf, spec in zip(
            leaf_paths(meta.unbox(abstract)),
            jax.tree.leaves(meta.unbox(abstract)),
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))}
    for r in range(world):
        got = result(ranks[world], name, r)["compute_shapes"]
        assert got == want, (name, r)
    whole = {p: l.shape for p, l in zip(
        leaf_paths(meta.unbox(abstract)),
        jax.tree.leaves(meta.unbox(abstract)))}
    assert any(want[p] != whole[p] for p in want), name
