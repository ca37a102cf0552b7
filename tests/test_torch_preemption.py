"""Preemption, KV offload and the OOM ladder in the port, held against the
JAX package.

Both packages run the same operations on the debug llama in fp32 over
the same weights (bridged through ``checkpoint/from_jax.py``): an
offload/restore round trip through the engine against an uninterrupted
run; page blobs of both caches filled with the same numbers, bit for
bit, over fp and int8 pages; the manager's shared-page rule; the
scheduler under KV pressure step by step (synchronous and under the
async chain with prefix caching), where it must preempt, offload,
restore and complete every request; the degradation ladder with page
allocations failing at the same calls on both sides; ``shed_unservable``
and the deadlock it replaces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import ragged as JR
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu.ops.paged_attention import KVPages as JKVPages
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import ragged as TR
from deepspeed_tpu_torch.models.llama import llama_config

PAGE = 16
SYNC = dict(async_scheduling=False, prefix_caching=False)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return model_def.cfg, params, tcfg, tparams


def _engines(weights, num_pages=64, max_batch=256, max_seqs=8,
             **serving):
    """The JAX engine and the port's, same geometry and serving flags."""
    jcfg, jparams, tcfg, tparams = weights
    sm = dict(max_tracked_sequences=max_seqs,
              max_ragged_sequence_count=max_seqs,
              max_ragged_batch_size=max_batch)
    geo = dict(num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
               head_dim=jcfg.dims_per_head, page_size=PAGE,
               num_pages=num_pages)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams, kv_config=J.KVCacheConfig(
            dtype=jnp.float32, **geo)),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            serving=J.ServingOptimizationConfig(**serving)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            dtype=torch.float32, **geo), device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(**serving)))
    return jeng, teng


def lockstep(jsched, tsched, jeng, teng, limit=500):
    """Step both schedulers together: after every step the same {uid:
    token}, rows scheduled, free pages, preempted set and verdicts, and
    a clean page audit.  Returns (the port's tokens per uid, the steps
    at which a request sat preempted)."""
    tokens, preempted_steps, step = {}, [], 0
    while jsched.has_work or tsched.has_work:
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}, step
        assert tsched.last_step_scheduled == jsched.last_step_scheduled, step
        assert teng.free_blocks == jeng.free_blocks, step
        assert set(tsched._preempted) == set(jsched._preempted), step
        assert ({u: e.code for u, e in tsched.errors.items()}
                == {u: e.code for u, e in jsched.errors.items()}), step
        teng.state_manager.check_invariants()
        if tsched._preempted:
            preempted_steps.append(step)
        for u, t in tout.items():
            tokens.setdefault(u, []).append(t)
        step += 1
        assert step < limit, "no progress"
    return tokens, preempted_steps


def _submit_both(jsched, tsched, prompts, new):
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))


# ---------------------------------------------------------------------------
# the engine: an offload/restore round trip (JAX test_inference_v2.py:728)
# ---------------------------------------------------------------------------

def _round_trip(eng, prompt, other, interrupt):
    """Prefill, 4 greedy decodes, (offload, serve another sequence in the
    freed pages, flush it, restore), 4 more decodes."""
    def pick(logits):
        return int(np.argmax(np.asarray(logits)[0]))

    toks, logits, free = [], eng.put([1], [prompt]), []
    for i in range(8):
        if i == 4 and interrupt:
            before = eng.free_blocks
            eng.offload_sequence(1)
            free.append(eng.free_blocks - before)
            eng.put([2], [other])
            eng.flush(2)
            eng.restore_sequence(1)
        toks.append(pick(logits))
        logits = eng.put([1], [np.array([toks[-1]], np.int32)])
    return toks, free


def test_offload_restore_round_trip_matches_uninterrupted(weights):
    rng = np.random.default_rng(0)
    prompt, other = rng.integers(0, 100, 20), rng.integers(0, 100, 12)
    runs = {}
    for name, interrupt in (("plain", False), ("preempted", True)):
        jeng, teng = _engines(weights)
        runs[name] = (_round_trip(jeng, prompt, other, interrupt),
                      _round_trip(teng, prompt, other, interrupt))
        teng.state_manager.check_invariants()
        assert teng.state_manager.offloaded_blobs == 0
    (jref, _), (tref, _) = runs["plain"]
    (jtoks, jfree), (ttoks, tfree) = runs["preempted"]
    assert ttoks == tref == jtoks == jref
    assert tfree == jfree == [2]          # 21..24 tokens: two pages


# ---------------------------------------------------------------------------
# page blobs, bit for bit
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    """A blob or cache array as raw integers (bf16 has no numpy type on
    the port's side)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy().view(np.dtype(f"i{a.element_size()}"))
    a = np.asarray(a)
    return a.view(np.dtype(f"i{a.dtype.itemsize}"))


def _parts(blob):
    if isinstance(blob, (TR.kv_cache.PageBlob, JR.kv_cache.PageBlob)):
        return [blob.payload, blob.scale]
    return [blob]


def _caches(quant, dtype_name):
    """A JAX and a port BlockedKVCache over the same random contents."""
    shape = (2, 9, 4, 2, 2, 8)                 # L, pages + 1, page, 2, K, D
    rng = np.random.default_rng(5)
    geo = dict(num_layers=2, kv_heads=2, head_dim=8, page_size=4,
               num_pages=8, quantization=quant)
    jc = JR.BlockedKVCache(JR.KVCacheConfig(
        dtype=getattr(jnp, dtype_name), **geo))
    tc = TR.BlockedKVCache(TR.KVCacheConfig(
        dtype=getattr(torch, dtype_name), **geo), torch.device("cpu"))
    if quant == "int8":
        codes = rng.integers(-127, 128, shape).astype(np.int8)
        scales = rng.random(shape[:-1]).astype(np.float32)
        jc.data = JKVPages(jnp.asarray(codes), jnp.asarray(scales))
        tc.data.payload.copy_(torch.from_numpy(codes))
        tc.data.scale.copy_(torch.from_numpy(scales))
    else:
        vals = rng.standard_normal(shape).astype(np.float32)
        jc.data = jnp.asarray(vals, getattr(jnp, dtype_name))
        tc.data.copy_(torch.from_numpy(vals).to(getattr(torch, dtype_name)))
    return jc, tc


def _cache_parts(c):
    return ([c.data.payload, c.data.scale] if c.cfg.quantized
            else [c.data])


@pytest.mark.parametrize("quant,dtype_name", [("none", "float32"),
                                              ("none", "bfloat16"),
                                              ("int8", "float32")])
def test_blobs_are_bit_equal_to_jax_blobs(quant, dtype_name):
    jc, tc = _caches(quant, dtype_name)
    obs = {}
    for name, c in (("jax", jc), ("port", tc)):
        pages = [int(p) for p in c.reserve(5)]
        blob = c.offload_pages([pages[1], pages[3], pages[4]])
        kept = c.read_pages([pages[0]])
        new = [int(p) for p in c.restore_pages(blob)]
        obs[name] = dict(pages=pages, new=new, free=c.free_pages,
                         blob=[_bits(p) for p in _parts(blob)],
                         kept=[_bits(p) for p in _parts(kept)],
                         nbytes=int(blob.nbytes),
                         data=[_bits(d)[:, 1:] for d in _cache_parts(c)])
    j, t = obs["jax"], obs["port"]
    assert (t["pages"], t["new"], t["free"], t["nbytes"]) == (
        j["pages"], j["new"], j["free"], j["nbytes"])
    for key in ("blob", "kept", "data"):   # page 0 is garbage by contract
        for a, b in zip(t[key], j[key]):
            np.testing.assert_array_equal(a, b)
    # the restored pages read back as the blob, in the same cache tensor
    for blob_part, part in zip(t["blob"], _cache_parts(tc)):
        np.testing.assert_array_equal(_bits(part)[:, t["new"]], blob_part)


def test_restore_writes_into_the_same_cache_tensor():
    _, tc = _caches("int8", "float32")
    ptrs = [p.data_ptr() for p in _cache_parts(tc)]
    pages = tc.reserve(3)
    blob = tc.offload_pages(pages)
    tc.restore_pages(blob)
    assert [p.data_ptr() for p in _cache_parts(tc)] == ptrs
    with pytest.raises(TypeError, match="encoding"):
        _caches("none", "float32")[1].restore_pages(blob)


# ---------------------------------------------------------------------------
# the manager (JAX test_prefix_cache.py:329)
# ---------------------------------------------------------------------------

def _manager(R):
    if R is TR:
        return TR.StateManager(TR.KVCacheConfig(
            num_layers=1, kv_heads=1, head_dim=4, page_size=4,
            num_pages=16, dtype=torch.float32), torch.device("cpu"))
    return JR.StateManager(JR.KVCacheConfig(
        num_layers=1, kv_heads=1, head_dim=4, page_size=4, num_pages=16,
        dtype=jnp.float32))


def _offload_shared(R):
    """Only the private page moves; shared pages stay resident; the
    offloaded sequence stops indexing; a flush while preempted releases
    the blob."""
    sm = _manager(R)
    a = sm.get_or_create_sequence(0)
    prompt = np.arange(14, dtype=np.int32)
    sm.match_prefix(a, prompt)
    sm.allocate_for(a, 14)
    a.pre_forward(14)
    a.post_forward()
    sm.index_prefix(a)
    b = sm.get_or_create_sequence(1)
    obs = [sm.match_prefix(b, prompt), list(map(int, b.pages)),
           sm.offloadable_slots(a)]
    sm.offload_sequence(0)
    obs += [list(map(int, a.pages)), a.host_blob.shape[1],
            a.prompt_tokens is None, sm.offloaded_blobs,
            sm.offloaded_blob_bytes, sm.kv_cache.allocator.free_pages]
    sm.check_invariants()
    sm.restore_sequence(0)
    obs += [list(map(int, a.pages)), sm.offloaded_blobs]
    sm.offload_sequence(0)
    sm.flush_sequence(0)
    obs += [sm.offloaded_blobs, sm.offloaded_blob_bytes,
            sm.kv_cache.allocator.free_pages]
    sm.check_invariants()
    return obs


def test_offload_keeps_shared_pages_resident_as_jax_does():
    port, ref = _offload_shared(TR), _offload_shared(JR)
    assert port == ref
    assert port[0] == 12 and port[2] == [3]
    assert port[3][:3] == port[1] and port[3][3] == 0 and port[4] == 1


# ---------------------------------------------------------------------------
# the scheduler under KV pressure (JAX test_inference_v2.py:760,
# test_fused_serving.py:335)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serving", [SYNC, {}], ids=["sync", "default"])
def test_scheduler_preempts_and_resumes_step_by_step_as_jax(weights,
                                                            serving,
                                                            monkeypatch):
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    jeng, teng = _engines(weights, num_pages=12, max_seqs=4, **serving)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 100, n) for n in (100, 60, 40)]
    _submit_both(jsched, tsched, prompts, [24] * 3)
    tokens, preempted = lockstep(jsched, tsched, jeng, teng)
    assert preempted, "the pool never ran short"
    assert sorted(tokens) == [0, 1, 2]
    assert all(len(v) == 24 for v in tokens.values())
    assert not tsched._preempted and tsched._inflight is None
    assert teng.state_manager.offloaded_blobs == 0


def test_chain_never_holds_a_preempted_row(weights):
    """Under the async chain a preempted request is in no chained step:
    while one waits, no chain is planned at all."""
    _, teng = _engines(weights, num_pages=12, max_seqs=4)
    sched = T.FastGenScheduler(teng)
    rng = np.random.default_rng(0)
    for uid, n in enumerate((100, 60, 40)):
        sched.submit(uid, rng.integers(0, 100, n),
                     T.SamplingParams(max_new_tokens=24))
    plans = []
    plan = sched._plan_chain

    def watched():
        rows = plan()
        plans.append((set(sched._preempted), rows))
        return rows
    sched._plan_chain = watched
    out = sched.run_to_completion()
    assert all(len(v) == 24 for v in out.values())
    assert any(p for p, _ in plans)                 # preemption happened
    assert all(rows is None for p, rows in plans if p)
    assert any(rows for _, rows in plans)           # and chains ran


# ---------------------------------------------------------------------------
# the OOM ladder (JAX test_chaos.py:505)
# ---------------------------------------------------------------------------

def _fail_allocations(monkeypatch, fail_at):
    """Make the n-th page allocation of each package's StateManager
    (counting calls that need pages, where JAX's ``kv.alloc_oom`` fault
    fires) raise its KVAllocationError for n in ``fail_at``."""
    for R in (JR, TR):
        cls = R.StateManager
        original = cls.allocate_for
        calls = [0]

        def allocate_for(self, sd, n, _orig=original, _calls=calls, _R=R):
            if self.pages_needed(sd, n):
                _calls[0] += 1
                if _calls[0] in fail_at:
                    raise _R.blocked_allocator.KVAllocationError(
                        "planted allocation failure")
            return _orig(self, sd, n)
        monkeypatch.setattr(cls, "allocate_for", allocate_for)


@pytest.mark.parametrize("serving", [SYNC, {}], ids=["sync", "default"])
def test_oom_ladder_climbs_as_jax(weights, serving, monkeypatch):
    """Six allocations in a row fail: the ladder reclaims parked pages,
    preempts from the second failure and sheds an "oom" verdict from the
    fourth on; every other request completes, step by step as in JAX."""
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    _fail_allocations(monkeypatch, fail_at=set(range(4, 10)))
    jeng, teng = _engines(weights, num_pages=24, max_batch=64, max_seqs=4,
                          **serving)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 100, 32)
    prompts = [np.concatenate([shared, rng.integers(0, 100, n)])
               for n in (30, 12, 50, 20)]
    streaks = []
    degrade = tsched._degrade_oom

    def watched(*a):
        degrade(*a)
        streaks.append(tsched._oom_streak)
    tsched._degrade_oom = watched
    _submit_both(jsched, tsched, prompts, [10] * 4)
    tokens, preempted = lockstep(jsched, tsched, jeng, teng)
    assert max(streaks) >= 4
    codes = [e.code for e in tsched.errors.values()]
    assert codes and set(codes) == {"oom"}
    for uid in range(4):
        assert len(tokens.get(uid, [])) == 10 or uid in tsched.errors
    assert tsched._oom_streak == 0


# ---------------------------------------------------------------------------
# unservable requests (JAX test_chaos.py:522, :541)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shed", [False, True])
def test_unservable_request_sheds_or_raises_as_jax(weights, shed):
    """Two pages of 16 tokens and a 100-token prompt: JAX and the port
    preempt it, then raise the deadlock, or with ``shed_unservable``
    end it with an "oom" verdict."""
    results = []
    for eng in _engines(weights, num_pages=2, max_batch=128, max_seqs=8):
        pkg = J if isinstance(eng, J.InferenceEngineV2) else T
        sched = pkg.FastGenScheduler(
            eng, serving=pkg.ServingOptimizationConfig(shed_unservable=shed))
        sched.submit(0, list(range(1, 101)),
                     pkg.SamplingParams(max_new_tokens=2))
        if not shed:
            with pytest.raises(RuntimeError, match="deadlock"):
                sched.run_to_completion()
            results.append(eng.free_blocks)
            continue
        out = sched.run_to_completion()
        results.append((out, sched.errors[0].code,
                        "unservable" in sched.errors[0].message,
                        eng.free_blocks,
                        eng.state_manager.offloaded_blobs))
    assert results[0] == results[1]
    if shed:
        assert results[1] == ({0: []}, "oom", True, 2, 0)
