"""Sliding-window page eviction in the port, held against the JAX package.

After every forward the JAX engine releases the pages that lie wholly
below ``seen_tokens - window + 1`` (``InferenceEngineV2._commit_batch``
calling ``StateManager.evict_window``), so a windowed model's live KV is
O(window).  Here both schedulers serve the debug llama with
``sliding_window=24`` in fp32 over the same weights from a 14-page pool
of 16-token pages: three 60-token prompts asking for 40 greedy tokens
each need 21 pages at full context but at most 9 inside the window.  The
port must keep JAX's free page count and deliver JAX's ``{uid: token}``
at every step, and complete; then the same under the default serving
configuration (async chain, prefix caching) over a shared prefix, where
a released page the cache indexes is parked, not freed.  The manager
cases run the same operation sequences on both ``StateManager`` classes.
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
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import ragged as TR
from deepspeed_tpu_torch.models.llama import llama_config

WINDOW, PAGE, PAGES, BUDGET = 24, 16, 14, 64


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32,
                                 sliding_window=WINDOW)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32,
                        sliding_window=WINDOW)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return model_def.cfg, params, tcfg, tparams


def _engines(weights, **serving):
    jcfg, jparams, tcfg, tparams = weights
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=BUDGET)
    geo = dict(num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
               head_dim=jcfg.dims_per_head, page_size=PAGE, num_pages=PAGES)
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


def _lockstep(jeng, teng, prompts, new):
    """Submit to both schedulers and step them together: the same free
    pages and the same {uid: token} after every step.  Returns the free
    page counts and the port's tokens per uid."""
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n))
    free, tokens, step = [], {}, 0
    while jsched.has_work or tsched.has_work:
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}, step
        assert teng.free_blocks == jeng.free_blocks, step
        teng.state_manager.check_invariants()
        free.append(teng.free_blocks)
        for u, t in tout.items():
            tokens.setdefault(u, []).append(t)
        step += 1
        assert step < 400, "no progress"
    return free, tokens


def test_window_eviction_keeps_the_pool_free_as_jax_does(weights):
    """The witness of the fault: without eviction the port's pool ran
    dry at step 6 (free 9, 5, 2, 2, 2, 1, 0 against JAX's 11, 9, 8, 8,
    8, 7, 6), its tokens parted at step 7 and it raised a deadlock."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, 60) for _ in range(3)]
    jeng, teng = _engines(weights, async_scheduling=False,
                          prefix_caching=False)
    free, tokens = _lockstep(jeng, teng, prompts, [40] * 3)
    assert free[:7] == [11, 9, 8, 8, 8, 7, 6]
    assert all(len(tokens[u]) == 40 for u in range(3))
    assert teng.free_blocks == PAGES


def test_window_eviction_under_the_default_config_parks_cached_pages(
        weights):
    """Async chain and prefix caching on, three requests behind a
    two-page shared prefix: the same free pages and tokens at every
    step; the prefix's pages that fall out of the window stay indexed
    and parked, so the last request still hits them."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 128, 40)
    prompts = [np.concatenate([shared, rng.integers(0, 128, n)])
               for n in (20, 9, 14)]
    jeng, teng = _engines(weights)
    hits = []
    match = teng.match_prefix
    teng.match_prefix = lambda uid, p: hits.append(match(uid, p)) or hits[-1]
    _, tokens = _lockstep(jeng, teng, prompts, [30, 12, 20])
    assert all(len(tokens[u]) == n for u, n in enumerate([30, 12, 20]))
    assert hits[0] == 0 and max(hits) == 32
    alloc = teng.state_manager.kv_cache.allocator
    assert alloc.parked_pages > 0 and teng.free_blocks == PAGES


# ---------------------------------------------------------------------------
# the manager: the same operation sequences on both classes
# ---------------------------------------------------------------------------

def _manager(R, page=4, num_pages=16):
    if R is TR:
        return TR.StateManager(TR.KVCacheConfig(
            num_layers=1, kv_heads=1, head_dim=4, page_size=page,
            num_pages=num_pages, dtype=torch.float32), torch.device("cpu"))
    return JR.StateManager(JR.KVCacheConfig(
        num_layers=1, kv_heads=1, head_dim=4, page_size=page,
        num_pages=num_pages, dtype=jnp.float32))


def _commit(sm, sd, n):
    sm.allocate_for(sd, n)
    sd.pre_forward(n)
    sd.post_forward()
    sm.index_prefix(sd)


def _observe(sm):
    alloc = sm.kv_cache.allocator
    return ({u: list(map(int, sd.pages)) for u, sd in sm._seqs.items()},
            alloc.free_pages, alloc.live_pages, alloc.parked_pages,
            sorted(int(p) for p in sm.prefix_cache.pages()))


def _evict_indexed(R):
    """A sequence's indexed prompt pages leave its window: parked in
    the cache, not freed; a later request still matches them."""
    sm = _manager(R)
    a = sm.get_or_create_sequence(0)
    prompt = np.arange(12, dtype=np.int32)
    sm.match_prefix(a, prompt)
    _commit(sm, a, 12)
    obs = [_observe(sm), sm.evict_window(a, window=4), _observe(sm)]
    _commit(sm, a, 5)                      # decode on; one more page out
    obs += [sm.evict_window(a, window=4), _observe(sm)]
    b = sm.get_or_create_sequence(1)
    obs += [sm.match_prefix(b, prompt), _observe(sm)]
    sm.check_invariants()
    return obs


def _evict_shared(R):
    """JAX ``test_window_eviction_releases_reference_not_page``: a
    sequence's eviction of a shared page drops its reference only."""
    sm = _manager(R)
    a = sm.get_or_create_sequence(0)
    prompt = np.arange(12, dtype=np.int32)
    sm.match_prefix(a, prompt)
    _commit(sm, a, 12)
    b = sm.get_or_create_sequence(1)
    sm.match_prefix(b, prompt)
    _commit(sm, b, 4)
    obs = [sm.evict_window(b, window=4), _observe(sm),
           sm.kv_cache.allocator.ref_count(a.pages[0])]
    sm.flush_sequence(1)
    sm.flush_sequence(0)
    obs.append(_observe(sm))
    sm.check_invariants()
    return obs


@pytest.mark.parametrize("scenario", [_evict_indexed, _evict_shared])
def test_manager_window_eviction_matches_jax(scenario):
    port, ref = scenario(TR), scenario(JR)
    assert port == ref
    if scenario is _evict_indexed:
        assert port[1] == 2 and port[2][3] == 2     # two pages parked
        assert port[5] == 8                         # still matched
    else:
        assert port[0] == 2 and port[2] == 1


def test_index_prefix_skips_evicted_slots():
    """A prompt longer than the window, committed in one chunk, then
    evicted before its last pages are indexed: indexing walks past the
    null slots without indexing the null page."""
    for R in (TR, JR):
        sm = _manager(R)
        sd = sm.get_or_create_sequence(0)
        sm.match_prefix(sd, np.arange(16, dtype=np.int32))
        sm.allocate_for(sd, 16)
        sd.pre_forward(16)
        sd.post_forward()
        sm.evict_window(sd, window=4)
        sm.index_prefix(sd)
        assert 0 not in sm.prefix_cache.pages()
        assert len(sm.prefix_cache) == 1 and sd.indexed_pages == 4
