"""The port's prefix cache held against the JAX package's.

The refcounted ``BlockedAllocator``, the chained-hash ``PrefixCache`` and
the prefix-aware ``StateManager`` of ``deepspeed_tpu_torch`` run the same
operation sequences as the JAX classes (``tests/test_prefix_cache.py``'s
allocator, index, invariant-stress and sharing cases, without offload,
sliding-window eviction and the host/disk tier, which the port does not
have): the same digests bit for bit, the same pages matched, the same
eviction order, the same page accounting after every operation, and a
planted double use caught by ``check_invariants``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import ragged as JR
from deepspeed_tpu_torch.inference.v2 import ragged as TR


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _outcome(fn):
    """fn()'s result, or the exception's type name and message."""
    try:
        return fn()
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _both(scenario):
    """Run ``scenario(ragged module)`` on the port and on JAX; they must
    observe the same; returns the port's observations."""
    port, ref = scenario(TR), scenario(JR)
    assert port == ref
    return port


def _ints(a):
    return [int(x) for x in a]


# ---------------------------------------------------------------------------
# the refcounted allocator
# ---------------------------------------------------------------------------

def _double_free(R):
    a = R.BlockedAllocator(8)
    p = a.allocate(2)
    a.free(p)
    return [_outcome(lambda: a.free([int(p[0])])),
            _outcome(lambda: R.BlockedAllocator(8).free([3]))]


def _share_then_free(R):
    a = R.BlockedAllocator(4)
    p = int(a.allocate(1)[0])
    a.add_ref([p])
    obs = [a.ref_count(p)]
    a.free([p])
    obs += [a.free_pages, a.ref_count(p)]
    a.free([p])
    obs += [a.free_pages, _outcome(lambda: a.free([p])),
            _outcome(lambda: a.add_ref([2]))]
    return obs


def _park_reclaim(R):
    a = R.BlockedAllocator(4)
    p = int(a.allocate(1)[0])
    obs = [_ints(a.decref([p])), a.free_pages, a.parked_pages,
           a.is_parked(p), _outcome(lambda: a.decref([p]))]
    a.add_ref([p])
    obs.append(_outcome(lambda: a.reclaim([p])))
    a.free([p])
    obs.append(sorted(_ints(a.allocate(4))))
    pages = R.BlockedAllocator(6)
    got = pages.allocate(4)
    pages.decref(got[:2])
    obs.append((pages.free_pages, pages.live_pages, pages.parked_pages))
    return obs


@pytest.mark.parametrize("scenario", [_double_free, _share_then_free,
                                      _park_reclaim])
def test_refcounted_allocator_matches_jax(scenario):
    obs = _both(scenario)
    if scenario is _share_then_free:
        assert obs[:5] == [2, 3, 1, 4, obs[4]] and "double free" in obs[4][1]
    if scenario is _park_reclaim:
        assert obs[-1] == (2, 2, 2)


# ---------------------------------------------------------------------------
# the chained-hash index
# ---------------------------------------------------------------------------

def _chain_walk(R):
    pc = R.PrefixCache(page_size=4)
    toks = np.arange(12, dtype=np.int32)
    d0 = pc.chain(b"", toks[:4])
    d1 = pc.chain(d0, toks[4:8])
    pc.insert(d0, 5)
    pc.insert(d1, 9)
    other = np.concatenate([toks[4:8], toks[4:8]])
    return [d0, d1, pc.match(toks, max_pages=3), pc.match(other, 2),
            pc.lookup(d1), pc.lookup(b"x" * 16)]


def _first_writer(R):
    pc = R.PrefixCache(page_size=2)
    d = pc.chain(b"", np.array([1, 2]))
    return [pc.insert(d, 3), pc.insert(d, 7), pc.insert(b"y" * 16, 3),
            pc.match(np.array([1, 2]), 1)]


def _lru(R):
    pc = R.PrefixCache(page_size=2)
    for i, page in enumerate((4, 5, 6, 7)):
        pc.insert(pc.chain(bytes([i]), np.array([i, i])), page)
    obs = [pc.evict(2, reclaimable=lambda p: p != 5), len(pc)]
    pc.touch_page(7)
    pc.drop_pages([7])
    obs.append(pc.pages())
    a, b = np.array([1, 1]), np.array([2, 2])
    pc.insert(pc.chain(b"", a), 8)
    pc.insert(pc.chain(b"", b), 9)
    pc.match(a, 1)                       # page 8 becomes most recent
    obs += [pc.evict_entries(2, lambda p: True), sorted(pc.clear())]
    return obs


@pytest.mark.parametrize("scenario", [_chain_walk, _first_writer, _lru])
def test_prefix_index_matches_jax(scenario):
    obs = _both(scenario)
    if scenario is _chain_walk:
        assert obs[2] == ([5, 9], obs[1]) and obs[3][0] == []
    if scenario is _lru:
        assert obs[0] == [4, 6] and obs[3][0][1] == 5    # live 5 rotated


def test_digest_chain_is_bit_equal_to_jax_on_random_prompts():
    rng = np.random.default_rng(0)
    for _ in range(20):
        toks = rng.integers(0, 50000, 64 * 3).astype(np.int32)
        dt = dj = b""
        for i in range(3):
            page = toks[i * 64:(i + 1) * 64]
            dt, dj = TR.PrefixCache.chain(dt, page), \
                JR.PrefixCache.chain(dj, page)
            assert dt == dj and len(dt) == 16


# ---------------------------------------------------------------------------
# the manager: randomized schedules and sharing
# ---------------------------------------------------------------------------

def _manager(R, prefix, num_pages=32, page=4):
    if R is TR:
        cfg = TR.KVCacheConfig(num_layers=1, kv_heads=1, head_dim=4,
                               page_size=page, num_pages=num_pages,
                               dtype=torch.float32)
        return TR.StateManager(cfg, torch.device("cpu"),
                               max_tracked_sequences=64,
                               prefix_caching=prefix)
    cfg = JR.KVCacheConfig(num_layers=1, kv_heads=1, head_dim=4,
                           page_size=page, num_pages=num_pages,
                           dtype=jnp.float32)
    return JR.StateManager(cfg, max_tracked_sequences=64,
                           prefix_caching=prefix)


def _state(sm):
    alloc = sm.kv_cache.allocator
    seqs = {uid: (sd.seen_tokens, list(sd.pages), sd.indexed_pages,
                  sd.last_digest) for uid, sd in sm._seqs.items()}
    cache = (list(sm.prefix_cache._entries.items())
             if sm.prefix_cache is not None else None)
    return (alloc.free_pages, alloc.live_pages, alloc.parked_pages,
            sm.free_pages, seqs, cache)


def _commit(sm, sd, n):
    sd.pre_forward(n)
    sd.post_forward()
    sm.index_prefix(sd)


@pytest.mark.parametrize("prefix", [True, False])
def test_randomized_schedule_matches_jax_after_every_op(prefix):
    """admit (prefix match) / decode / flush / cache reset, the same
    seeded schedule on both managers: equal state after every operation,
    and the page identity free + live + parked == total."""
    rng = np.random.default_rng(7 if prefix else 8)
    managers = [_manager(TR, prefix), _manager(JR, prefix)]
    total = managers[0].kv_cache.allocator.total_pages
    templates = [rng.integers(0, 50, 12), rng.integers(0, 50, 8)]
    live, next_uid, hits = [], 0, 0
    for _ in range(250):
        op = rng.random()
        if op < 0.4 or not live:                        # admit
            uid, next_uid = next_uid, next_uid + 1
            t = templates[int(rng.integers(len(templates)))]
            prompt = np.concatenate(
                [t, rng.integers(0, 50, int(rng.integers(1, 9)))])
            admitted = []
            for sm in managers:
                sd = sm.get_or_create_sequence(uid)
                hit = sm.match_prefix(sd, prompt)
                hits += hit
                n_new = len(prompt) - hit
                if sm.pages_needed(sd, n_new) <= sm.free_pages:
                    sm.allocate_for(sd, n_new)
                    _commit(sm, sd, n_new)
                    admitted.append(True)
                else:
                    sm.flush_sequence(uid)
                    admitted.append(False)
            assert admitted[0] == admitted[1]
            if admitted[0]:
                live.append(uid)
        elif op < 0.75:                                 # decode a token
            uid = live[int(rng.integers(len(live)))]
            for sm in managers:
                sd = sm.get_sequence(uid)
                if sm.pages_needed(sd, 1) <= sm.free_pages:
                    sm.allocate_for(sd, 1)
                    _commit(sm, sd, 1)
        elif op < 0.97:                                 # finish
            uid = live.pop(int(rng.integers(len(live))))
            for sm in managers:
                sm.flush_sequence(uid)
        else:                                           # cold start
            for sm in managers:
                sm.reset_prefix_cache()
        for sm in managers:
            sm.check_invariants()
        assert _state(managers[0]) == _state(managers[1])
        alloc = managers[0].kv_cache.allocator
        assert alloc.free_pages + alloc.live_pages + alloc.parked_pages \
            == total
    assert (hits > 0) == prefix
    for uid in live:
        for sm in managers:
            sm.flush_sequence(uid)
    for sm in managers:
        sm.reset_prefix_cache()
        assert sm.kv_cache.free_pages == total


def test_invariant_check_catches_planted_double_use():
    sm = _manager(TR, prefix=True)
    sd = sm.get_or_create_sequence(0)
    sm.allocate_for(sd, 4)
    _commit(sm, sd, 4)
    sm.check_invariants()
    other = sm.get_or_create_sequence(1)
    other.pages = [sd.pages[0]]        # a stolen page, no refcount
    with pytest.raises(RuntimeError, match="refcount|block tables"):
        sm.check_invariants()


def _match_full_pages(R):
    sm = _manager(R, prefix=True, page=4)
    sd = sm.get_or_create_sequence(0)
    prompt = np.arange(8, dtype=np.int32)       # exactly 2 full pages
    obs = [sm.match_prefix(sd, prompt)]
    sm.allocate_for(sd, 8)
    _commit(sm, sd, 8)
    obs.append(len(sm.prefix_cache))
    # the same prompt attaches ONE page: the step needs a token to prefill
    sd2 = sm.get_or_create_sequence(1)
    obs += [sm.match_prefix(sd2, prompt), list(sd2.pages),
            sm.kv_cache.allocator.ref_count(sd.pages[0])]
    sd3 = sm.get_or_create_sequence(2)
    obs += [sm.match_prefix(sd3, np.arange(10, dtype=np.int32)),
            list(sd3.pages), list(sd.pages)]
    _commit(sm, sd3, 0)
    obs.append(sm.match_prefix(sd3, prompt))    # started: no second match
    return obs


def _flush_parks(R):
    sm = _manager(R, prefix=True, page=4, num_pages=8)
    sd = sm.get_or_create_sequence(0)
    sm.match_prefix(sd, np.arange(9, dtype=np.int32))
    sm.allocate_for(sd, 9)
    _commit(sm, sd, 9)
    obs = [sm.kv_cache.free_pages]
    sm.flush_sequence(0)
    alloc = sm.kv_cache.allocator
    obs += [alloc.parked_pages, sm.free_pages]
    # pressure: allocating the whole pool evicts the parked pages, LRU
    sd2 = sm.get_or_create_sequence(1)
    sm.allocate_for(sd2, 32)
    obs += [alloc.parked_pages, len(sm.prefix_cache), list(sd2.pages)]
    return obs


@pytest.mark.parametrize("scenario", [_match_full_pages, _flush_parks])
def test_manager_sharing_matches_jax(scenario):
    obs = _both(scenario)
    if scenario is _match_full_pages:
        assert obs[:3] == [0, 2, 4] and obs[4] == 2 and obs[5] == 8
        assert obs[-1] == 0
    else:
        assert obs[:5] == [5, 2, 8, 0, 0]


def test_int8_pages_are_shared_by_index_codes_and_scales_alike():
    """Two sequences sharing a prefix page read the same codes and
    scales: the block table holds the page index, nothing is copied."""
    cfg = TR.KVCacheConfig(num_layers=1, kv_heads=1, head_dim=4,
                           page_size=4, num_pages=8, dtype=torch.float32,
                           quantization="int8")
    sm = TR.StateManager(cfg, torch.device("cpu"))
    sd = sm.get_or_create_sequence(0)
    sm.match_prefix(sd, np.arange(9, dtype=np.int32))
    sm.allocate_for(sd, 9)
    layer = sm.kv_cache.data[0]          # views into the cache
    layer.payload[sd.pages[0]] = 3
    layer.scale[sd.pages[0]] = 0.5
    _commit(sm, sd, 9)
    sd2 = sm.get_or_create_sequence(1)
    assert sm.match_prefix(sd2, np.arange(10, dtype=np.int32)) == 8
    assert sd2.pages == sd.pages[:2]
    layer = sm.kv_cache.data[0]
    assert torch.equal(layer.payload[sd2.pages[0]],
                       torch.full((4, 2, 1, 4), 3, dtype=torch.int8))
    assert torch.equal(layer.scale[sd2.pages[0]],
                       torch.full((4, 2, 1), 0.5))
    sm.check_invariants()
