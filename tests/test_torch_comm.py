"""The port's ``comm`` facade, accelerator and trace regions at one
process, held against the JAX package's.

Each collective of JAX ``comm/__init__.py`` runs in both packages on the
same seeded numpy input: JAX inside ``shard_map`` over a one-device mesh
axis, the port over the default group of one.  The outputs are equal,
and with the comms logger on the two summaries list the same rows.
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu.comm as jcomm
import deepspeed_tpu_torch.comm as tcomm
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.accelerator import (get_accelerator,
                                             real_accelerator,
                                             set_accelerator)
from deepspeed_tpu_torch.accelerator.cpu_accelerator import CPU_Accelerator
from deepspeed_tpu_torch.utils import nvtx

AXIS = "data"

#: op name -> (JAX call over the axis, port call over the default group)
OPS = {
    "all_reduce": (lambda x: jcomm.all_reduce(x, AXIS, "max"),
                   lambda x: tcomm.all_reduce(x, None, "max")),
    "all_gather": (lambda x: jcomm.all_gather(x, AXIS, axis=1, tiled=False),
                   lambda x: tcomm.all_gather(x, None, axis=1, tiled=False)),
    "reduce_scatter": (lambda x: jcomm.reduce_scatter(x, AXIS),
                       lambda x: tcomm.reduce_scatter(x, None)),
    "all_to_all": (lambda x: jcomm.all_to_all(x, AXIS, 0, 1),
                   lambda x: tcomm.all_to_all(x, None, 0, 1)),
    "permute": (lambda x: jcomm.permute(x, AXIS, [(0, 0)]),
                lambda x: tcomm.permute(x, None, [(0, 0)])),
    "broadcast": (lambda x: jcomm.broadcast(x, AXIS, 0),
                  lambda x: tcomm.broadcast(x, None, 0)),
    "reduce": (lambda x: jcomm.reduce(x, AXIS, 0),
               lambda x: tcomm.reduce(x, None, 0)),
    "gather": (lambda x: jcomm.gather(x, AXIS, 0),
               lambda x: tcomm.gather(x, None, 0)),
    "scatter": (lambda x: jcomm.scatter(x, AXIS, 0),
                lambda x: tcomm.scatter(x, None, 0)),
    "inference_all_reduce": (lambda x: jcomm.inference_all_reduce(x, AXIS),
                             lambda x: tcomm.inference_all_reduce(x)),
    "all_gather_into_tensor": (
        lambda x: jcomm.all_gather_into_tensor(x, AXIS),
        lambda x: tcomm.all_gather_into_tensor(x)),
    "reduce_scatter_tensor": (lambda x: jcomm.reduce_scatter_tensor(x, AXIS),
                              lambda x: tcomm.reduce_scatter_tensor(x)),
    "all_to_all_single": (lambda x: jcomm.all_to_all_single(x, AXIS),
                          lambda x: tcomm.all_to_all_single(x)),
    "send_recv_next": (lambda x: jcomm.send_recv_next(x, AXIS, 1),
                       lambda x: tcomm.send_recv_next(x, None, 1)),
    "send_recv_prev": (lambda x: jcomm.send_recv_prev(x, AXIS, 1),
                       lambda x: tcomm.send_recv_prev(x, None, 1)),
}


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    yield
    jcomm.comm._comms_logger = None
    tcomm.comm._comms_logger = None


def _x():
    return np.random.default_rng(3).standard_normal((4, 6)).astype(
        np.float32)


def _jax_run(fn, x):
    mesh = Mesh(np.array(jax.devices()[:1]), (AXIS,))
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=P(),
                                out_specs=P(), check_vma=False)(x))


@pytest.mark.parametrize("name", sorted(OPS))
def test_each_collective_equals_jax_over_one_member(name):
    jfn, tfn = OPS[name]
    x = _x()
    got = tfn(torch.from_numpy(x))
    ref = _jax_run(jfn, x)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_the_coalesced_ops_and_the_rooted_zeros_equal_jax():
    x = _x()
    ref = _jax_run(lambda v: jcomm.broadcast(v, AXIS, src=1), x)
    np.testing.assert_array_equal(tcomm.broadcast(torch.from_numpy(x),
                                                  src=1).numpy(), ref)
    ref = _jax_run(lambda v: jcomm.permute(v, AXIS, []), x)
    np.testing.assert_array_equal(
        tcomm.permute(torch.from_numpy(x), None, []).numpy(), ref)
    for jfn, tfn in ((jcomm.all_reduce_coalesced, tcomm.all_reduce_coalesced),
                     (jcomm.all_gather_coalesced, tcomm.all_gather_coalesced),
                     (jcomm.reduce_scatter_coalesced,
                      tcomm.reduce_scatter_coalesced)):
        got = tfn([torch.from_numpy(x), torch.from_numpy(2 * x)])
        ref = _jax_run(lambda v: jfn([v, 2 * v], AXIS)[1], x)
        np.testing.assert_array_equal(got[1].numpy(), ref)
    with pytest.raises(ValueError, match="unsupported reduce op"):
        tcomm.all_reduce(torch.ones(2), op="prod")


def test_the_comms_logger_summary_rows_equal_jax():
    """The same ops, each once, on the same shapes: the summary tables
    are equal row for row (JAX counts each at trace time, the port at
    each call)."""
    jlog = jcomm.configure_comms_logger()
    tlog = tcomm.configure_comms_logger()
    x = _x()
    for name in sorted(OPS):
        jfn, tfn = OPS[name]
        tfn(torch.from_numpy(x))
        _jax_run(jfn, x)
    jtext, ttext = jcomm.log_summary(), tcomm.log_summary()
    assert ttext == jtext
    assert {"all_reduce", "broadcast", "gather"} <= set(tlog.comms_dict)
    plan = {"bucket_count": 2, "comm_bytes_per_step": 1024,
            "comm_fp32_equiv_bytes_per_step": 4096,
            "comm_quantized_fraction": 0.5, "reduce_axes": ("data",),
            "reduce_world": 1,
            "per_bucket": [{"index": 0, "elems": 256, "wire_bytes": 512,
                            "fp32_bytes": 1024, "quantized": True}]}
    jcomm.record_bucket_plan(plan)
    tcomm.record_bucket_plan(plan)
    assert tcomm.log_summary() == jcomm.log_summary()
    assert jlog.comms_dict.keys() == tlog.comms_dict.keys()


def test_the_control_plane_at_one_process():
    assert tcomm.get_world_group() is None
    assert tcomm.new_group([0]) is None
    with pytest.raises(ValueError, match="init_distributed"):
        tcomm.new_group([0, 1])
    assert (tcomm.get_rank(), tcomm.get_world_size(), tcomm.get_local_rank(),
            tcomm.axis_index(), tcomm.axis_size()) == (0, 1, 0, 0, 1)
    assert tcomm.get_device_count() >= 1
    tcomm.barrier()
    assert 0 <= tcomm.monitored_barrier(timeout=1.0) < 1.0
    assert tcomm.log_summary() == jcomm.log_summary() == ""
    tcomm.destroy_process_group()
    assert not tcomm.is_initialized()


def test_a_group_of_more_than_one_raises_naming_item_4(monkeypatch):
    """Collectives and sparse_allreduce run over several ranks since the
    ranks slice (tests/test_torch_zero_ranks.py); what still raises at
    more than one rank, naming item 4, is ZeRO-Offload (a host optimizer
    per rank)."""
    import deepspeed_tpu_torch as dtt
    from deepspeed_tpu_torch.models.base import SimpleModel
    from deepspeed_tpu_torch.parallel import MeshTopology, TopologyConfig
    topo = MeshTopology(TopologyConfig(data=2), world_size=2, rank=0,
                        groups=False)
    with pytest.raises(NotImplementedError, match="item 4"):
        dtt.initialize(model=SimpleModel(8), topology=topo, device="cpu",
                       config={"zero_optimization": {
                           "stage": 1,
                           "offload_optimizer": {"device": "cpu"}}})


def test_the_cpu_accelerator_only_when_asked(monkeypatch):
    monkeypatch.setattr(real_accelerator, "_accelerator", None)
    monkeypatch.delenv("DS_ACCELERATOR", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="DS_ACCELERATOR=cpu"):
            get_accelerator()
    monkeypatch.setenv("DS_ACCELERATOR", "tpu")
    with pytest.raises(ValueError, match="DS_ACCELERATOR"):
        get_accelerator()
    set_accelerator(CPU_Accelerator())
    acc = get_accelerator()
    stats = acc.memory_stats()
    assert stats["peak_bytes_in_use"] == acc.max_memory_allocated() > 0
    assert acc.device_name(0) == "cpu:0" and acc.current_device().type \
        == "cpu"
    assert acc.op_builder_dir() == "deepspeed_tpu_torch.ops.op_builder"
    g = acc.manual_seed(5)
    assert torch.rand(2, generator=g).tolist() == \
        torch.rand(2, generator=torch.Generator().manual_seed(5)).tolist()
    with pytest.raises(NotImplementedError):
        acc.create_graph()
    set_accelerator(None)


def test_trace_regions_reach_the_profiler(tmp_path):
    @nvtx.instrument_w_nvtx
    def work():
        return torch.ones(8).sum()

    seen = {}

    def other_thread():
        nvtx.range_push("other")
        seen["depth"] = len(nvtx._ranges())
        nvtx.range_pop()

    with torch.profiler.profile() as prof:
        with nvtx.nvtx_range("outer"):
            work()
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    keys = {e.key for e in prof.key_averages()}
    assert {"outer",
            "test_trace_regions_reach_the_profiler.<locals>.work"} <= keys
    assert seen["depth"] == 1 and nvtx._ranges() == []
    with nvtx.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(p.name.endswith(".pt.trace.json") for p in tmp_path.iterdir())
