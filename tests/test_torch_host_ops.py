"""The port's host ops held against the JAX package's, on the CPU.

The port builds its own copies of the host sources
(``deepspeed_tpu_torch/csrc/host``) with its own builder, the JAX
package the root ``csrc/``; the sources are the same, so the optimizers
are held bit for bit over three steps of seeded inputs, and the async
I/O handles are driven through the same calls.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import adam as J
from deepspeed_tpu.ops.aio import AsyncIOError as JAsyncIOError
from deepspeed_tpu.ops.aio import AsyncIOHandle as JAsyncIOHandle
from deepspeed_tpu_torch.ops import adam as T
from deepspeed_tpu_torch.ops.aio import AsyncIOError, AsyncIOHandle
from deepspeed_tpu_torch.ops.op_builder import (ALL_OPS, OpBuilderError,
                                                create_op_builder,
                                                get_op_builder)

ROOT = Path(__file__).resolve().parents[1]
N = 4099      # odd: the SIMD bodies and the scalar tail both run


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


OPTIMIZERS = {
    "adamw": lambda M: M.DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.1),
    "adam_l2": lambda M: M.DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.1,
                                            adamw_mode=False),
    "adamw_no_bias_correction": lambda M: M.DeepSpeedCPUAdam(
        lr=1e-2, weight_decay=0.1, bias_correction=False),
    "adam_l2_no_bias_correction": lambda M: M.DeepSpeedCPUAdam(
        lr=1e-2, adamw_mode=False, bias_correction=False),
    "adagrad": lambda M: M.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.1),
    "lion": lambda M: M.DeepSpeedCPULion(lr=1e-3, weight_decay=0.1),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_host_optimizer_is_bit_equal_to_jax(name):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=N).astype(np.float32)
    grads = [rng.normal(size=N).astype(np.float32) for _ in range(3)]
    port, ref = OPTIMIZERS[name](T), OPTIMIZERS[name](J)
    assert port.SLOTS == ref.SLOTS
    pp, pr = p0.copy(), p0.copy()
    for g in grads:
        port.step(0, pp, g.copy())
        ref.step(0, pr, g.copy())
    np.testing.assert_array_equal(pp, pr)
    sp, sr = port.state_dict(), ref.state_dict()
    assert sp["steps"] == sr["steps"] == {0: 3}
    for slot in port.SLOTS:
        np.testing.assert_array_equal(sp["state"][0][slot],
                                      sr["state"][0][slot])


def test_host_optimizer_takes_a_pinned_tensor_view_and_a_state_round_trip():
    """A numpy view of a CPU tensor steps in place; state_dict and
    load_state_dict restore the trajectory."""
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    g = rng.normal(size=N).astype(np.float32)
    a = T.DeepSpeedCPUAdam(lr=1e-2)
    ref = t.numpy().copy()
    a.step(0, t.numpy(), g)
    b = T.DeepSpeedCPUAdam(lr=1e-2)
    b.step(0, ref, g)
    np.testing.assert_array_equal(t.numpy(), ref)
    c = T.DeepSpeedCPUAdam(lr=1e-2)
    c.load_state_dict(a.state_dict())
    x, y = t.numpy().copy(), t.numpy().copy()
    c.step(0, x, g)
    a.step(0, y, g)
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bad", ["float64", "strided", "shape"])
def test_host_optimizer_refuses_what_jax_refuses(bad):
    p = np.zeros(64, np.float32)
    g = np.zeros(64, np.float32)
    if bad == "float64":
        p = p.astype(np.float64)
    elif bad == "strided":
        p = np.zeros(128, np.float32)[::2]
    else:
        g = np.zeros(63, np.float32)
    for M in (T, J):
        with pytest.raises(ValueError):
            M.DeepSpeedCPUAdam().step(0, p, g)


def test_builder_registry_and_cache_as_jax():
    assert set(ALL_OPS) == set(
        __import__("deepspeed_tpu.ops.op_builder",
                   fromlist=["ALL_OPS"]).ALL_OPS)
    with pytest.raises(OpBuilderError):
        get_op_builder("bogus_op")
    b = create_op_builder("cpu_adam")
    assert b.is_compatible()
    assert b.build() == b.build() and b.build().is_file()
    for name in ("evoformer_attn", "sparse_attn", "spatial_inference"):
        with pytest.raises(OpBuilderError, match=name):
            create_op_builder(name).load()


def test_a_failed_build_raises_with_the_compilers_output(tmp_path,
                                                         monkeypatch):
    from deepspeed_tpu_torch.ops import kernel_loader
    from deepspeed_tpu_torch.ops.op_builder import builder as B
    src = tmp_path / "host" / "bad"
    src.mkdir(parents=True)
    (src / "bad.cpp").write_text("this is not C++\n")
    (tmp_path / "host" / "includes").mkdir()
    monkeypatch.setattr(B, "HOST_SRC_DIR", tmp_path / "host")
    kernel_loader.set_library_dir(tmp_path / "lib")
    try:
        class Bad(B.OpBuilder):
            NAME = "bad_op"
            SOURCES = ["bad/bad.cpp"]
        with pytest.raises(OpBuilderError, match="bad.cpp"):
            Bad().load()
        assert not list((tmp_path / "lib").glob("*.so"))
    finally:
        kernel_loader.set_library_dir(None)


def test_two_processes_building_one_library_both_load_it(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "from deepspeed_tpu_torch.ops import kernel_loader\n"
        f"kernel_loader.set_library_dir({str(tmp_path)!r})\n"
        "from deepspeed_tpu_torch.ops.adam import DeepSpeedCPULion\n"
        "p = np.ones(8, np.float32)\n"
        "DeepSpeedCPULion(lr=0.5).step(0, p, np.ones(8, np.float32))\n"
        "assert (p == 0.5).all(), p\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for proc in procs:
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-2000:]
    libs = sorted(p.name for p in tmp_path.iterdir())
    assert len(libs) == 1 and libs[0].startswith("cpu_lion_") \
        and libs[0].endswith(".so") and ".tmp" not in libs[0], libs


# ----------------------------------------------------------------- aio

def _both(num_threads=2, **kw):
    return [AsyncIOHandle(num_threads=num_threads, **kw),
            JAsyncIOHandle(num_threads=num_threads, **kw)]


def test_aio_round_trips_as_jax(tmp_path):
    buf = np.arange(1 << 18, dtype=np.float32)
    for i, h in enumerate(_both()):
        out = np.zeros_like(buf)
        path = str(tmp_path / f"shard{i}.bin")
        assert h.sync_pwrite(buf, path) == buf.nbytes
        assert h.sync_pread(out, path) == buf.nbytes
        np.testing.assert_array_equal(buf, out)
        # a second write at an offset, read back whole
        tail = np.arange(100, dtype=np.float32)
        h.sync_pwrite(tail, path, offset=buf.nbytes)
        whole = np.zeros(buf.size + 100, np.float32)
        h.sync_pread(whole, path)
        np.testing.assert_array_equal(whole, np.concatenate([buf, tail]))
        h.close()
    assert (tmp_path / "shard0.bin").read_bytes() == \
        (tmp_path / "shard1.bin").read_bytes()


def test_aio_prefetch_and_wait_all_as_jax(tmp_path):
    """Writes in flight together, then reads submitted ahead and drained
    by one ``wait_all``, striped over a small queue."""
    for i, h in enumerate(_both(num_threads=4, block_size=1 << 12,
                                queue_depth=4)):
        bufs = [np.full(1 << 14, k, np.float32) for k in range(6)]
        reqs = [h.pwrite(b, str(tmp_path / f"{i}_s{k}.bin"))
                for k, b in enumerate(bufs)]
        assert len(set(reqs)) == len(reqs)
        h.wait_all()
        outs = [np.zeros(1 << 14, np.float32) for _ in range(6)]
        for k, o in enumerate(outs):
            h.pread(o, str(tmp_path / f"{i}_s{k}.bin"))
        h.wait_all()
        for o, b in zip(outs, bufs):
            np.testing.assert_array_equal(o, b)
        h.close()


def test_aio_errors_as_jax(tmp_path):
    """A missing file and a short read raise the package's AsyncIOError
    in both packages."""
    for h, err in zip(_both(num_threads=1), (AsyncIOError, JAsyncIOError)):
        out = np.zeros(16, np.float32)
        with pytest.raises(err):
            h.sync_pread(out, str(tmp_path / "missing.bin"))
        path = str(tmp_path / f"trunc_{err.__module__}.bin")
        h.sync_pwrite(np.arange(8, dtype=np.float32), path)
        with pytest.raises(err, match="short read"):
            h.sync_pread(np.zeros(64, np.float32), path)
        with pytest.raises(ValueError):
            h.pwrite(np.zeros((4, 4), np.float32)[:, ::2], path)
        h.close()
