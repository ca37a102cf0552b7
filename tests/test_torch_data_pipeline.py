"""The port's data pipeline held against the JAX package's, on the CPU.

Host-only numpy on both sides, so the bar is exact: the same
difficulty at every step, the same index order for one seed and config
(also after a ``state_dict`` round trip, in the same package, across
them and through a checkpoint's ``client_state``), the same Megatron
``.bin`` / ``.idx`` bytes from either builder, and the same map-reduce
difficulty index.
"""

import os

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.runtime import data_pipeline as J
from deepspeed_tpu_torch.models.base import SimpleModel
from deepspeed_tpu_torch.runtime import data_pipeline as T

SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 64,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 20,
                                         "difficulty_step": 8}},
    "fixed_root": {"min_difficulty": 2, "max_difficulty": 100,
                   "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 17,
                                       "difficulty_step": 3,
                                       "root_degree": 3}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 9,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 4, 9],
                                           "max_step": [5, 11]}},
    "custom": {"min_difficulty": 0, "max_difficulty": 50,
               "schedule_type": "custom"},
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _scheduler(pkg, name):
    s = pkg.CurriculumScheduler(SCHEDULES[name])
    if name == "custom":
        s.set_custom_get_difficulty(lambda step: (step * 7) % 50)
    return s


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_curriculum_gives_the_same_difficulty_at_every_step(name):
    j, t = _scheduler(J, name), _scheduler(T, name)
    for step in range(30):
        assert t.update_difficulty(step) == j.update_difficulty(step)
    assert t.state_dict() == j.state_dict()


def test_curriculum_refuses_what_jax_refuses():
    for cfg, match in (({"schedule_type": "fixed_linear"},
                        "total_curriculum_step"),
                       ({"schedule_type": "bogus"}, "unknown schedule"),
                       ({"schedule_type": "fixed_discrete",
                         "schedule_config": {"difficulty": [1, 2],
                                             "max_step": [1, 2]}},
                        "max_step")):
        for pkg in (J, T):
            with pytest.raises(ValueError, match=match):
                pkg.CurriculumScheduler(cfg)


def _sampler(pkg, rank=0, size=1, seed=1234):
    diffs = np.random.default_rng(7).integers(1, 100, 300)
    return pkg.DeepSpeedDataSampler(
        diffs, _scheduler(pkg, "fixed_linear"), global_batch_size=8,
        data_parallel_rank=rank, data_parallel_size=size, seed=seed)


@pytest.mark.parametrize("rank,size", [(0, 1), (1, 2)])
def test_sampler_gives_the_same_index_order(rank, size):
    j, t = _sampler(J, rank, size), _sampler(T, rank, size)
    for _ in range(25):
        assert next(t) == next(j)
    assert t.state_dict() == j.state_dict()


def test_a_state_dict_resumes_the_order_in_either_package():
    ref = _sampler(T)
    order = [next(ref) for _ in range(12)]
    for src, dst in ((T, T), (J, T), (T, J)):
        a = _sampler(src)
        head = [next(a) for _ in range(5)]
        b = _sampler(dst, seed=99)
        b.load_state_dict(a.state_dict())
        assert head + [next(b) for _ in range(7)] == order


def test_the_order_resumes_through_a_checkpoint(tmp_path):
    """The sampler's state rides in ``client_state``; a fresh engine and
    sampler continue where the saved run was."""
    model = SimpleModel(8)
    cfg = {"train_micro_batch_size_per_gpu": 8, "bf16": {"enabled": False},
           "checkpoint": {"async_save": False}}
    engine, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                                model_parameters=model.init_params(0, "cpu"))
    data = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    ref = _sampler(T)
    order = [next(ref) for _ in range(6)]
    sampler = _sampler(T)
    for _ in range(3):
        idx = next(sampler)
        engine.train_batch({"x": data[idx], "y": data[idx]})
    engine.save_checkpoint(str(tmp_path),
                           client_state={"data_sampler": sampler.state_dict()})
    fresh, *_ = dtt.initialize(model=model, config=cfg, device="cpu",
                               model_parameters=model.init_params(1, "cpu"))
    _, client = fresh.load_checkpoint(str(tmp_path))
    resumed = _sampler(T, seed=5)
    resumed.load_state_dict(client["data_sampler"])
    assert [next(resumed) for _ in range(3)] == order[3:]


def _build(pkg, prefix, docs, dtype):
    b = pkg.MMapIndexedDatasetBuilder(prefix, dtype=dtype)
    for doc in docs:
        for item in doc:
            b.add_item(item)
        b.end_document()
    b.finalize()


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_indexed_dataset_files_cross_between_the_packages(dtype, tmp_path):
    rng = np.random.default_rng(3)
    docs = [[rng.integers(0, 5000, rng.integers(1, 40)) for _ in range(k)]
            for k in (1, 3, 2)]
    prefixes = {}
    for pkg in (J, T):
        prefixes[pkg] = str(tmp_path / pkg.__name__.split(".")[0])
        _build(pkg, prefixes[pkg], docs, dtype)
    for ext in (".bin", ".idx"):
        with open(prefixes[J] + ext, "rb") as a, \
                open(prefixes[T] + ext, "rb") as b:
            assert a.read() == b.read()
    items = [item for doc in docs for item in doc]
    for reader in (J, T):
        for prefix in prefixes.values():
            ds = reader.MMapIndexedDataset(prefix)
            assert len(ds) == len(items) and ds.dtype == np.dtype(dtype)
            for got, want in zip(ds[:], items):
                np.testing.assert_array_equal(got, want.astype(dtype))
            np.testing.assert_array_equal(ds.get(1, 1, 2), items[1][1:3])
            np.testing.assert_array_equal(ds.doc_idx, [0, 1, 4, 6])
    merged = str(tmp_path / "merged")
    b = T.MMapIndexedDatasetBuilder(merged, dtype=dtype)
    b.merge_file(prefixes[J])
    b.merge_file(prefixes[T])
    b.finalize()
    assert len(J.MMapIndexedDataset(merged)) == 2 * len(items)


def test_indexed_dataset_refuses_a_wrong_dtype_code(tmp_path):
    prefix = str(tmp_path / "d")
    _build(T, prefix, [[np.arange(8)]], np.uint16)
    with open(prefix + ".idx", "r+b") as f:
        f.seek(17)
        f.write(bytes([8]))              # uint64: four times too few items
    for pkg in (J, T):
        with pytest.raises(ValueError, match="dtype code"):
            pkg.MMapIndexedDataset(prefix)


def test_data_analyzer_map_reduce_matches_jax(tmp_path):
    """Two workers map their shards, the second reduces; the metric
    values and the difficulty-sorted index are the JAX files' bytes."""
    data = list(np.random.default_rng(4).integers(0, 1000, 37))
    fns = {"len": lambda x: float(x % 97)}
    out = {}
    for pkg in (J, T):
        path = str(tmp_path / pkg.__name__.split(".")[0])
        for w in range(2):
            pkg.DataAnalyzer(data, fns, path, num_workers=2,
                             worker_id=w).run_map_reduce()
        out[pkg] = pkg.DataAnalyzer.load(path, "len")
        assert sorted(f for f in os.listdir(path) if ".tmp" in f) == []
    for a, b in zip(out[T], out[J]):
        np.testing.assert_array_equal(a, b)
