"""The process mesh and the ZeRO partition of the port against the JAX
package's, on the CPU and without processes.

``MeshTopology`` is built with ``groups=False`` (the arithmetic of any
rank of any world, no ``torch.distributed``); JAX's over the same number
of the eight virtual devices.  For every ZeRO stage and the hpZ and
MiCS meshes at four and eight ranks: the axis sizes, each rank's
position and the members of its groups equal JAX's mesh, each rank's
rows of a global batch equal the rows JAX places on that device, and
every leaf's param, master and grad spec equals JAX's ``PartitionSpec``
for the 64-wide MLP and the debug llama (stacked and per-layer
layers).  Exact: the rules are integer arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deepspeed_tpu.models.base import SimpleModel as JSimple
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.parallel.topology import BATCH_AXES as J_BATCH_AXES
from deepspeed_tpu.parallel.topology import MESH_AXES as J_MESH_AXES
from deepspeed_tpu.runtime.config import load_config as j_load_config
from deepspeed_tpu.runtime.engine import _topology_from_config
from deepspeed_tpu.runtime.zero.partitioner import \
    ZeroPartitioner as JPartitioner
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.parallel import (BATCH_AXES, MESH_AXES,
                                          MeshTopology, TopologyConfig)
from deepspeed_tpu_torch.parallel.topology import (GRAD_REDUCE_AXES,
                                                   check_ported_axes)
from deepspeed_tpu_torch.runtime.config import load_config
from deepspeed_tpu_torch.runtime.engine import topology_from_config
from deepspeed_tpu_torch.runtime.zero.partitioner import (ZeroPartitioner,
                                                          blocked_dims_of,
                                                          layout_of,
                                                          leaf_names_of)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


#: mesh case -> its zero_optimization section
MESHES = {
    "stage0": {"stage": 0}, "stage1": {"stage": 1}, "stage2": {"stage": 2},
    "stage3": {"stage": 3},
    "hpz": {"stage": 3, "zero_hpz_partition_size": 2},
    "mics": {"stage": 3, "mics_shard_size": 2},
}


def _cfg(zero):
    return {"train_micro_batch_size_per_gpu": 1,
            "zero_optimization": {**zero,
                                  "stage3_param_persistence_threshold": 64}}


def _topologies(zero, world):
    cfg = _cfg(zero)
    jt = _topology_from_config(j_load_config(cfg),
                               devices=jax.devices()[:world])
    tts = [topology_from_config(load_config(cfg), world_size=world, rank=r,
                                groups=False) for r in range(world)]
    return jt, tts


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("case", sorted(MESHES))
def test_mesh_and_groups_equal_jax(case, world):
    jt, tts = _topologies(MESHES[case], world)
    assert MESH_AXES == J_MESH_AXES and BATCH_AXES == J_BATCH_AXES
    mesh = jt.mesh
    assert tts[0].shape == tuple(mesh.devices.shape)
    assert tts[0].batch_shard_size == jt.batch_shard_size
    assert tts[0].dp_world_size == jt.dp_world_size
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r, t in enumerate(tts):
        pos = tuple(int(i[0]) for i in np.nonzero(ids == r))
        assert tuple(t.coords[a] for a in MESH_AXES) == pos
        for axes in (("data",), ("fsdp",), ("hpz",), ("fsdp", "hpz"),
                     GRAD_REDUCE_AXES):
            # the devices that differ from r only along axes, row-major
            sl = tuple(slice(None) if a in axes else p
                       for a, p in zip(MESH_AXES, pos))
            want = tuple(int(i) for i in ids[sl].reshape(-1))
            assert t.members(axes) == want, (case, r, axes)


@pytest.mark.parametrize("case", sorted(MESHES))
def test_batch_rows_equal_jax_placement(case):
    world, rows = 4, 16
    jt, tts = _topologies(MESHES[case], world)
    sharding = NamedSharding(jt.mesh, P(J_BATCH_AXES))
    placed = sharding.devices_indices_map((rows, 32))
    for dev, idx in placed.items():
        got = tts[dev.id].batch_slice(rows)
        assert (got.start, got.stop) == (idx[0].start or 0,
                                         idx[0].stop or rows), case


def _trees(name, **kw):
    if name == "simple":
        jm, tm = JSimple(64), SimpleModel(64)
    else:
        jm = JLlama("debug", dtype=jnp.float32, **kw)
        tm = LlamaForCausalLM("debug", dtype=torch.float32, **kw)
    abstract = jax.eval_shape(jm.init_params, jax.random.key(0))
    return abstract, tm


def _leaves_with_paths(tree, prefix=""):
    """(path, leaf) of a JAX tree; a boxed leaf stays boxed."""
    if isinstance(tree, dict):
        return [pl for k in tree
                for pl in _leaves_with_paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("model,kw", [("simple", {}),
                                      ("llama", {}),
                                      ("llama", {"scan_layers": False})])
@pytest.mark.parametrize("case", sorted(MESHES))
def test_every_leaf_spec_equals_jax(case, model, kw):
    zero = MESHES[case]
    jt, tts = _topologies(zero, 4)
    abstract, tm = _trees(model, **kw)
    jp = JPartitioner(jt, zero["stage"], persistence_threshold=64)
    tp = ZeroPartitioner(tts[0], zero["stage"], persistence_threshold=64,
                         blocked=blocked_dims_of(tm),
                         names=leaf_names_of(tm))
    for path, leaf in _leaves_with_paths(abstract):
        shape = np.shape(getattr(leaf, "value", leaf))
        meta_leaf = torch.empty(shape, device="meta")
        for kind in ("param_spec", "master_spec", "grad_spec"):
            want = tuple(getattr(jp, kind)(leaf))
            got = getattr(tp, kind)(meta_leaf, path)
            assert got == want, (case, model, path, kind)


def test_each_rank_piece_is_the_jax_shard():
    """The layout a spec gives rank r cuts the leaf where JAX places
    device r's shard (hpZ: a leaf sharded over fsdp x hpz)."""
    jt, tts = _topologies(MESHES["hpz"], 4)
    spec = (("fsdp", "hpz"), None)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = jax.device_put(x, NamedSharding(jt.mesh, P(*spec)))
    for shard in arr.addressable_shards:
        lay = layout_of(spec, tts[shard.device.id])
        np.testing.assert_array_equal(
            lay.shard(torch.from_numpy(x)).numpy(), np.asarray(shard.data))


@pytest.mark.parametrize("beside", [{}, {"tensor": 2, "seq": 2}])
@pytest.mark.parametrize("axis,item", [("pipe", "11h"), ("expert", "11h")])
def test_axes_outside_the_port_raise_naming_their_item(axis, item, beside):
    """pipe and expert wait for item 11h, alone and beside the tensor and
    seq axes the port runs."""
    world = 2 * int(np.prod(list(beside.values()) or [1]))
    with pytest.raises(NotImplementedError, match=item):
        check_ported_axes(TopologyConfig(data=1, **beside, **{axis: 2}))
    with pytest.raises(NotImplementedError, match=item):
        MeshTopology(TopologyConfig(data=1, **beside, **{axis: 2}),
                     world_size=world, rank=0, groups=False)


def test_mesh_config_sizes_that_do_not_divide_raise_as_jax():
    for zero, world in (({"stage": 3, "mics_shard_size": 3}, 4),
                        ({"stage": 1, "zero_hpz_partition_size": 3}, 4)):
        with pytest.raises(ValueError) as jerr:
            _topology_from_config(j_load_config(_cfg(zero)),
                                  devices=jax.devices()[:world])
        with pytest.raises(ValueError) as terr:
            topology_from_config(load_config(_cfg(zero)), world_size=world,
                                 rank=0, groups=False)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("over,match", [
    ({"zero_optimization": {"stage": 1,
                            "offload_optimizer": {"device": "cpu"}}},
     "ZeRO-Offload across ranks"),
    ({"flops_profiler": {"enabled": True}}, "flops_profiler across ranks"),
    ({"optimizer": {"type": "adafactor"},
      "zero_optimization": {"stage": 1}}, "ZeRO shards"),
    ({"hybrid_engine": {"enabled": True}}, "hybrid engine across ranks"),
])
def test_what_waits_at_more_than_one_rank_raises_naming_item_4(over, match):
    """Built over a mesh of two ranks (no process group is needed to
    refuse): each names ROADMAP Queue 1 item 4."""
    import deepspeed_tpu_torch as dtt
    topo = MeshTopology(TopologyConfig(data=2), world_size=2, rank=0,
                        groups=False)
    model = (LlamaForCausalLM("debug", dtype=torch.float32)
             if "hybrid_engine" in over else SimpleModel(8))
    with pytest.raises(NotImplementedError, match=match) as err:
        dtt.initialize(model=model, topology=topo, device="cpu",
                       config={"train_micro_batch_size_per_gpu": 1, **over})
    assert "item 4" in str(err.value)
