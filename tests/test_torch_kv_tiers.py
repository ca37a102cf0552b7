"""The port's host/disk prefix tier and compile cache held against JAX.

On the CPU: ``TieredPageStore`` runs the same operation sequences as the
JAX class and holds the same state after every operation (tier of each
digest, page and byte counts, the demoted / promoted / spilled / I/O
error counters) and the same blobs; on the debug llama over fp32 and
int8 pages, two waves of requests with distinct multi-page prefixes on an
8-page pool deliver the JAX scheduler's tokens at every step, with its
tier hits by tier, its demoted / promoted / spilled counts and its free
pages, the page and tier audit clean after every step (``DS_KV_DEBUG``);
a disk write or read made to raise ``OSError`` (patched in both packages:
the fault injector is ROADMAP item 11i) is a clean miss in both; and the
compile cache namespaces the kernel libraries by its digest, with
``DS_COMPILE_CACHE`` winning over the config.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2.ragged import kv_cache as jkv
from deepspeed_tpu.inference.v2.ragged import kv_tiers as jtiers
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import compile_cache
from deepspeed_tpu_torch.inference.v2.ragged import kv_cache as tkv
from deepspeed_tpu_torch.inference.v2.ragged import kv_tiers as ttiers
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.ops import kernel_loader

PAGE, PAGES = 16, 8


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the store alone
# ---------------------------------------------------------------------------

def _blob(seed, quant=False):
    """(JAX blob, port blob) of one page, the same values."""
    rng = np.random.default_rng(seed)
    arr = rng.normal(size=(2, 1, 4, 2, 2, 3)).astype(np.float32)
    if not quant:
        return arr, torch.from_numpy(arr.copy())
    codes = rng.integers(-127, 128, arr.shape).astype(np.int8)
    scale = rng.normal(size=arr.shape[:-1]).astype(np.float32)
    return (jkv.PageBlob(codes, scale),
            tkv.PageBlob(torch.from_numpy(codes.copy()),
                         torch.from_numpy(scale.copy())))


def _d(i):
    return bytes([i]) * 16


def _arrays(blob):
    if isinstance(blob, (jkv.PageBlob, tkv.PageBlob)):
        return [np.asarray(blob.payload), np.asarray(blob.scale)]
    return [np.asarray(blob)]


# op sequences: ("put", i) / ("take", [i...]) / ("discard", i) / ("clear",)
# / ("tear", i) (truncate digest i's disk file)
SEQUENCES = {
    "host_ring": dict(host=3, disk=0, ops=[
        ("put", 1), ("put", 2), ("put", 1), ("put", 3), ("put", 4),
        ("take", [2, 3, 5, 4]), ("discard", 4), ("put", 5), ("clear",)]),
    "disk_spill": dict(host=1, disk=8, ops=[
        ("put", 0), ("put", 1), ("put", 2), ("put", 3),
        ("take", [0, 1, 2]), ("put", 4), ("discard", 3),
        ("take", [4]), ("clear",)]),
    "disk_cap": dict(host=1, disk=2, ops=[
        ("put", i) for i in range(6)] + [("take", [3, 4, 5])]),
    "byte_bound": dict(host=1, disk=3, bytes_per_page=200, ops=[
        ("put", i) for i in range(5)] + [("take", [1, 2, 3, 4])]),
    "torn_file": dict(host=1, disk=4, ops=[
        ("put", 1), ("put", 2), ("put", 3), ("tear", 2),
        ("take", [1, 2, 3]), ("take", [3])]),
}


def _state(st):
    """The store's state in JAX's terms: its ``stats()`` keys (the port's
    ``plain_io`` count is its own), residency, indexed pages."""
    stats = st.stats()
    stats.pop("plain_io", None)
    return (stats, {i: st.contains(_d(i)) for i in range(8)},
            st.indexed_pages)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_store_runs_the_jax_sequences_to_the_same_state(name, quant,
                                                        tmp_path):
    """Both stores over their async I/O handles (the extension builds
    with g++ here): the port's disk files never take the plain path."""
    ts = _run_sequence(name, quant, tmp_path)
    assert ts.plain_io == 0
    assert not ts._aio_failed


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(n for n in SEQUENCES
                                        if SEQUENCES[n]["disk"]))
def test_without_the_extension_the_plain_path_keeps_the_jax_state(
        name, quant, tmp_path, monkeypatch, caplog):
    """The async I/O extension made unavailable: the port's store falls
    back to plain files, logs it once, reaches JAX's state at every op and
    counts each plain file operation in ``stats()``."""
    from deepspeed_tpu_torch.ops import aio

    def unbuildable(*a, **k):
        raise OSError("extension unavailable")
    monkeypatch.setattr(aio.AsyncIOHandle, "__init__", unbuildable)
    ts = _run_sequence(name, quant, tmp_path)
    assert ts._aio is None and ts._aio_failed
    assert ts.plain_io == ts.stats()["plain_io"] > 0
    assert ts.stats()["plain_io"] >= ts.spilled_pages


def test_a_chains_disk_reads_are_submitted_before_the_first_wait(tmp_path):
    """A promotion of three disk pages of int8 blobs (payload and scales:
    six reads) submits every read to the handle before it waits on one,
    as JAX ``take_many`` does."""
    st = ttiers.TieredPageStore(1, disk_pages=8, disk_dir=str(tmp_path))
    blobs = {i: _blob(i, True)[1] for i in range(4)}
    for i in range(4):
        st.put(_d(i), blobs[i])
    assert [st.contains(_d(i)) for i in range(4)] == ["disk"] * 3 + ["host"]
    calls = []
    aio = st._get_aio()
    for name in ("pread", "wait"):
        orig = getattr(aio, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        setattr(aio, name, spy)
    got, tiers = st.take_many([_d(i) for i in range(4)])
    assert tiers == ["disk", "disk", "disk", "host"]
    assert calls == ["pread"] * 6 + ["wait"] * 6
    for i, blob in enumerate(got):
        for g, w in zip(_arrays(blob), _arrays(blobs[i])):
            np.testing.assert_array_equal(g, w)
    st.landed(4)
    st.check_invariants()
    assert st.stats()["plain_io"] == 0
    st.close()


def _run_sequence(name, quant, tmp_path):
    """One op sequence through a JAX and a port store, the states held
    equal after every op.  Returns the port's store (closed)."""
    spec = SEQUENCES[name]
    stores = []
    for pkg, mod in (("jax", jtiers), ("port", ttiers)):
        d = tmp_path / pkg
        stores.append(mod.TieredPageStore(
            spec["host"], disk_pages=spec["disk"], disk_dir=str(d),
            bytes_per_page=spec.get("bytes_per_page", 0)))
    js, ts = stores
    blobs = {i: _blob(i, quant) for i in range(8)}
    for op in spec["ops"]:
        if op[0] == "put":
            assert ts.put(_d(op[1]), blobs[op[1]][1]) == \
                js.put(_d(op[1]), blobs[op[1]][0])
        elif op[0] == "take":
            digests = [_d(i) for i in op[1]]
            (jb, jt), (tb, tt) = js.take_many(digests), ts.take_many(digests)
            assert tt == jt
            for got, want in zip(tb, jb):
                for g, w in zip(_arrays(got), _arrays(want)):
                    np.testing.assert_array_equal(g, w)
            js.landed(len(jb))
            ts.landed(len(tb))
        elif op[0] == "discard":
            js.discard(_d(op[1]))
            ts.discard(_d(op[1]))
        elif op[0] == "tear":
            for st, pkg in ((js, "jax"), (ts, "port")):
                path = tmp_path / pkg / (_d(op[1]).hex() + ".kvp")
                path.write_bytes(path.read_bytes()[:-8])
        else:
            js.clear()
            ts.clear()
        assert _state(ts) == _state(js), op
        ts.check_invariants()
        js.check_invariants()
    for st in stores:
        st.close()
    assert not list((tmp_path / "port").glob("*.kvp"))
    return ts


def test_a_bf16_page_round_trips_through_the_disk_bit_for_bit(tmp_path):
    """bf16 has no numpy dtype: the file holds raw bytes and the store's
    index the dtype."""
    st = ttiers.TieredPageStore(1, disk_pages=2, disk_dir=str(tmp_path))
    g = torch.Generator().manual_seed(0)
    pages = [torch.randn((2, 1, 4, 2, 2, 128), generator=g).to(
        torch.bfloat16) for _ in range(2)]
    st.put(_d(1), pages[0])
    st.put(_d(2), pages[1])            # the first spills to disk
    assert st.contains(_d(1)) == "disk"
    blobs, tiers = st.take_many([_d(1), _d(2)])
    assert tiers == ["disk", "host"]
    assert blobs[0].dtype == torch.bfloat16
    assert torch.equal(blobs[0].view(torch.int16),
                       pages[0].view(torch.int16))
    st.landed(2)
    st.check_invariants()
    st.close()


# ---------------------------------------------------------------------------
# the tier under the schedulers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return model_def.cfg, params, tcfg, tparams


def _engines(weights, quant, host, disk, tier_dir):
    jcfg, jparams, tcfg, tparams = weights
    kv = dict(page_size=PAGE, num_pages=PAGES)
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=256)
    sv = dict(kv_quantization=quant, kv_tier_host_pages=host,
              kv_tier_disk_pages=disk)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams, kv_config=J.KVCacheConfig(
            num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
            head_dim=jcfg.dims_per_head, dtype=jnp.float32, **kv)),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            serving=J.ServingOptimizationConfig(
                kv_tier_dir=str(tier_dir / "jax"), **sv)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, dtype=torch.float32, **kv),
            device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(
                kv_tier_dir=str(tier_dir / "port"), **sv)))
    return jeng, teng


def _distinct_prompts(n=4, prefix_tokens=48, tail=7):
    """Distinct 3-page prefixes: a shared prefix would keep one chain
    parked and the tier would never engage."""
    rng = np.random.default_rng(1)
    return [np.concatenate([rng.integers(0, 128, prefix_tokens),
                            rng.integers(0, 128, tail + i)])
            for i in range(n)]


def _watch_tier_hits(eng, log):
    orig = eng.tier_hits

    def recorded(uid):
        log[uid] = orig(uid)
        return log[uid]
    eng.tier_hits = recorded


def _tier_counts(eng):
    st = eng.state_manager.tiers.stats()
    return {k: st[k] for k in ("demoted_pages", "promoted_pages",
                               "spilled_pages", "io_errors", "host_pages",
                               "disk_pages")}


def _two_waves(jeng, teng, prompts, max_new=8):
    """Serve ``prompts`` twice on one scheduler of each package, stepped
    together: the same tokens, tier counts and free pages after every
    step.  Returns (tokens by uid, tier hits by uid) of the port."""
    hits = {"jax": {}, "port": {}}
    _watch_tier_hits(jeng, hits["jax"])
    _watch_tier_hits(teng, hits["port"])
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    tokens = {}
    for wave in (0, 10):
        for i, p in enumerate(prompts):
            jsched.submit(wave + i, p, J.SamplingParams(
                max_new_tokens=max_new))
            tsched.submit(wave + i, p, T.SamplingParams(
                max_new_tokens=max_new))
        steps = 0
        while jsched.has_work or tsched.has_work:
            jout, tout = jsched.step(), tsched.step()
            assert tout == {u: int(t) for u, t in jout.items()}, steps
            assert _tier_counts(teng) == _tier_counts(jeng), steps
            assert teng.free_blocks == jeng.free_blocks, steps
            for u, t in tout.items():
                tokens.setdefault(u, []).append(t)
            steps += 1
    assert hits["port"] == hits["jax"]
    return tokens, hits["port"]


@pytest.mark.parametrize("quant,host,disk", [
    ("none", 64, 0), ("none", 2, 64), ("int8", 2, 64)],
    ids=["fp32-host", "fp32-host-disk", "int8-host-disk"])
def test_two_waves_match_the_jax_scheduler_step_by_step(
        weights, quant, host, disk, tmp_path, monkeypatch):
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    jeng, teng = _engines(weights, quant, host, disk, tmp_path)
    prompts = _distinct_prompts()
    tokens, hits = _two_waves(jeng, teng, prompts)
    assert all(tokens[i] == tokens[10 + i] for i in range(len(prompts)))
    counts = _tier_counts(teng)
    assert counts["demoted_pages"] > 0 and counts["promoted_pages"] > 0
    wave2 = [hits.get(10 + i) or {} for i in range(len(prompts))]
    for tier in ("host", "disk") if disk else ("host",):
        assert sum(h.get(tier, 0) for h in wave2) > 0, (tier, wave2)
    teng.state_manager.check_invariants()
    teng.reset_prefix_cache()
    assert teng.state_manager.tiers.indexed_pages == 0
    teng.state_manager.close()


@pytest.mark.parametrize("where", ["write", "read"])
def test_an_io_error_is_a_clean_miss_in_both(weights, where, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("DS_KV_DEBUG", "1")

    def fail(*a, **k):
        raise OSError("injected tier I/O error")
    if where == "write":
        monkeypatch.setattr(jtiers.TieredPageStore, "_write_file", fail)
        monkeypatch.setattr(ttiers.TieredPageStore, "_write_file", fail)
    else:
        # both stores read through their async I/O handles when those
        # are built: take the plain path in both, and fail its reads
        for mod in (jtiers, ttiers):
            monkeypatch.setattr(mod.TieredPageStore, "_get_aio",
                                lambda self: None)
            monkeypatch.setattr(mod.TieredPageStore, "_read_file_plain",
                                fail)
    jeng, teng = _engines(weights, "none", 1, 64, tmp_path)
    with pytest.warns(UserWarning, match="kv tier"):
        tokens, hits = _two_waves(jeng, teng, _distinct_prompts())
    assert all(tokens[i] == tokens[10 + i] for i in range(4))
    counts = _tier_counts(teng)
    assert counts["io_errors"] > 0
    assert not any((hits.get(10 + i) or {}).get("disk")
                   for i in range(4))


def test_tier_needs_the_prefix_cache(weights, tmp_path):
    """As in JAX: without prefix caching no tier is built."""
    _, _, tcfg, tparams = weights
    eng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, device="cpu"),
        T.RaggedInferenceEngineConfig(serving=T.ServingOptimizationConfig(
            prefix_caching=False, kv_tier_host_pages=4)))
    assert eng.state_manager.tiers is None


# ---------------------------------------------------------------------------
# the compile cache
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_cache():
    yield
    compile_cache.disable_compile_cache()


def test_compile_cache_digest_namespaces_the_libraries(tmp_path,
                                                       clean_cache):
    a = compile_cache.compile_config_digest(nvcc_version="release 12.8")
    assert a == compile_cache.compile_config_digest(
        nvcc_version="release 12.8")
    assert a != compile_cache.compile_config_digest(
        nvcc_version="release 12.9")
    path = compile_cache.enable_compile_cache(str(tmp_path), a)
    assert path == os.path.join(str(tmp_path), a) and os.path.isdir(path)
    assert compile_cache.active_cache_dir() == path
    assert str(kernel_loader.library_dir()) == path
    from deepspeed_tpu_torch.ops import normalization
    assert str(normalization.KERNEL.library_path.parent) == path
    assert compile_cache.counters_available()
    compile_cache.disable_compile_cache()
    assert kernel_loader.library_dir() == kernel_loader.BUILD_DIR


def test_an_unwritable_cache_dir_warns_and_keeps_the_default(
        tmp_path, clean_cache):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.warns(UserWarning, match="compile cache disabled"):
        assert compile_cache.enable_compile_cache(str(blocker), "d") is None
    assert kernel_loader.library_dir() == kernel_loader.BUILD_DIR


def test_ds_compile_cache_wins_over_the_config(weights, tmp_path,
                                               monkeypatch, clean_cache):
    env, cfg_dir = str(tmp_path / "env"), str(tmp_path / "config")
    assert compile_cache.cache_dir_from_env_or_config(cfg_dir) == cfg_dir
    monkeypatch.setenv("DS_COMPILE_CACHE", env)
    assert compile_cache.cache_dir_from_env_or_config(cfg_dir) == env
    _, _, tcfg, tparams = weights
    eng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, device="cpu"),
        T.RaggedInferenceEngineConfig(serving=T.ServingOptimizationConfig(
            compile_cache_dir=cfg_dir)))
    assert os.path.dirname(eng._compile_cache_dir) == env
    assert str(kernel_loader.library_dir()).startswith(env)
    assert not os.path.exists(cfg_dir)
