"""The replica pool in the port, held against the JAX package.

Both packages run ``serving.ReplicaPool`` over debug-llama replicas in
fp32 with the same bridged weights (engines built once per module and
reset to a cold cache between tests).  Held on the same traffic: the
placement of every uid (replica, matched pages), the greedy tokens, the
``ds_pool_*`` counter deltas; scale-down drain-and-migrate and kill
absorption (the committed prefix kept verbatim, the tokens the
uninterrupted run's), a death through the ``serving.preempt`` fault site
with a fixed seed; the cross-replica page fetch (fetched pages the
holder's bit for bit and JAX's within the forward's fp32 tolerance, the
request's tokens the cold reference's, its hit counted "remote"); SLO advice and rebalance under the duck-typed
evaluator; the threaded serve loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu import serving as JS
from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu.runtime import fault_injection as jfi
from deepspeed_tpu.telemetry import metrics as jtm
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu_torch import serving as TS
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.runtime import fault_injection as tfi
from deepspeed_tpu_torch.telemetry import metrics as ttm
from deepspeed_tpu_torch.telemetry import tracer as ttracer

PAGE = 16
POOL_COUNTERS = ("POOL_ROUTED", "POOL_AFFINITY_ROUTED", "POOL_MIGRATED",
                 "POOL_SCALE_UP", "POOL_SCALE_DOWN", "POOL_REBALANCE",
                 "POOL_REPLICA_DEATHS", "POOL_PAGE_FETCHES",
                 "POOL_PAGE_FETCH_PAGES")


@pytest.fixture(autouse=True)
def _torch_threads(monkeypatch):
    """One torch thread, the page audit after every step, and this
    thread's component label (the pools' step loops set it) put back."""
    torch.set_num_threads(1)
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    labels = (ttracer.current_component(), jtracer.current_component())
    yield
    ttracer.set_component(labels[0])
    jtracer.set_component(labels[1])


@pytest.fixture(scope="module")
def fleet():
    """Engines per (package, label), built at first use and kept for the
    module: the JAX ones compile once."""
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    weights = {J: (model_def.cfg, params), T: (tcfg, tparams)}
    engines = {}

    def engine(pkg, label):
        key = (pkg.__name__, label)
        if key not in engines:
            cfg, p = weights[pkg]
            kv = dict(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                      head_dim=cfg.dims_per_head, page_size=PAGE,
                      num_pages=64)
            econf = pkg.RaggedInferenceEngineConfig(
                state_manager=pkg.StateManagerConfig(
                    max_tracked_sequences=8, max_ragged_sequence_count=8,
                    max_ragged_batch_size=256))
            if pkg is J:
                model = J.RaggedInferenceModel(
                    cfg, p, kv_config=J.KVCacheConfig(dtype=jnp.float32,
                                                      **kv))
            else:
                model = T.RaggedInferenceModel(
                    cfg, p, kv_config=T.KVCacheConfig(dtype=torch.float32,
                                                      **kv), device="cpu")
            engines[key] = pkg.InferenceEngineV2(model, econf)
        return engines[key]

    return engine, engines


def _reset(fleet):
    for eng in fleet[1].values():
        for uid in list(eng.state_manager._seqs):
            eng.flush(uid)
        eng.reset_prefix_cache()


def _pool(pkg, fleet, replicas=2, **kw):
    _reset(fleet)
    serving = JS if pkg is J else TS
    return serving.ReplicaPool(
        lambda label: pkg.FastGenScheduler(fleet[0](pkg, label)),
        replicas=replicas, **kw)


def _prompt(seed, n=40):
    return ((np.arange(n) * 7 + seed * 131 + 3) % 97).astype(np.int32)


def _greedy(pkg, n=8):
    return pkg.SamplingParams(max_new_tokens=n, temperature=0.0)


def _counters(pkg):
    tm = jtm if pkg is J else ttm
    return {n: getattr(tm, n).value for n in POOL_COUNTERS}


def _delta(pkg, before):
    now = _counters(pkg)
    return {n: now[n] - before[n] for n in POOL_COUNTERS}


def _ints(res):
    return {u: [int(t) for t in v] for u, v in res.items()}


def _both(fleet, drive):
    """``drive(pkg, fleet)`` in each package: (results, counter deltas)
    per package."""
    out = {}
    for pkg in (T, J):
        before = _counters(pkg)
        res = drive(pkg, fleet)
        out[pkg] = (res, _delta(pkg, before))
    return out


def test_placements_tokens_and_counters_equal_jax(fleet):
    """A warm prefix, its hint published, then same-prefix and cold
    requests: every uid lands where JAX puts it, with JAX's tokens."""
    def drive(pkg, fleet):
        pool = _pool(pkg, fleet)
        warm = _prompt(1, 48)
        pool.submit(0, warm, _greedy(pkg))
        pool.run_to_completion()
        pool.publish_hints()
        for uid in range(1, 8):
            prompt = (np.concatenate([warm[:32], _prompt(uid, 5 + uid)])
                      if uid % 2 else _prompt(uid, 20 + 4 * uid))
            assert pool.submit(uid, prompt, _greedy(pkg)) is None
        res = pool.run_to_completion()
        assert not pool.errors
        places = {u: (pool.request(u).replica, pool.request(u).matched_pages)
                  for u in range(8)}
        return _ints(res), places
    runs = _both(fleet, drive)
    assert runs[T] == runs[J]
    (res, places), delta = runs[T]
    # the same-prefix requests went to the digest holder, matching 2 pages
    assert {places[u] for u in (1, 3, 5, 7)} == {(places[0][0], 2)}
    assert delta["POOL_ROUTED"] == 8 and delta["POOL_AFFINITY_ROUTED"] == 4


def _uninterrupted(pkg, fleet, uids):
    pool = _pool(pkg, fleet, replicas=1)
    for uid in uids:
        pool.submit(uid, _prompt(uid), _greedy(pkg))
    return _ints(pool.run_to_completion())


def test_scale_down_migration_equals_jax(fleet):
    want = _uninterrupted(T, fleet, range(4))

    def drive(pkg, fleet):
        pool = _pool(pkg, fleet)
        for uid in range(4):
            pool.submit(uid, _prompt(uid), _greedy(pkg))
        for _ in range(3):
            pool.step()
        committed = {u: list(map(int, pool.request(u).tokens))
                     for u in range(4)}
        gone = pool.scale_down()
        assert gone is not None and len(pool.labels) == 1
        got = _ints(pool.run_to_completion())
        assert not pool.errors
        for u in range(4):
            assert got[u][:len(committed[u])] == committed[u]
        return got, committed, gone
    runs = _both(fleet, drive)
    assert runs[T] == runs[J]
    (got, committed, _), delta = runs[T]
    assert got == want and any(committed.values())
    assert delta["POOL_MIGRATED"] > 0 and delta["POOL_SCALE_DOWN"] == 1


def test_kill_absorption_equals_jax(fleet):
    want = _uninterrupted(T, fleet, range(4))

    def drive(pkg, fleet):
        pool = _pool(pkg, fleet)
        for uid in range(4):
            pool.submit(uid, _prompt(uid), _greedy(pkg))
        for _ in range(2):
            pool.step()
        pool.kill(pool.labels[0])
        got = _ints(pool.run_to_completion())
        assert not pool.errors
        return got, pool.labels
    runs = _both(fleet, drive)
    assert runs[T] == runs[J]
    assert runs[T][0][0] == want
    assert runs[T][1]["POOL_REPLICA_DEATHS"] == 1


def test_a_preempt_fault_kills_a_replica_as_in_jax(fleet):
    """The ``serving.preempt`` site armed with one fixed call ordinal:
    the same replica dies at the same step in both packages, and its
    requests finish on the survivor with the uninterrupted tokens."""
    want = _uninterrupted(T, fleet, range(4))

    def drive(pkg, fleet):
        inj = (jfi if pkg is J else tfi).get_fault_injector()
        pool = _pool(pkg, fleet)
        for uid in range(4):
            pool.submit(uid, _prompt(uid), _greedy(pkg))
        inj.configure({"serving.preempt": {"at": "3", "max": "1"}}, seed=5)
        try:
            got = _ints(pool.run_to_completion())
            stats = inj.stats()["serving.preempt"]
        finally:
            inj.disarm()
        assert not pool.errors
        return got, pool.labels, stats["fires"]
    runs = _both(fleet, drive)
    assert runs[T] == runs[J]
    (got, labels, fires), delta = runs[T]
    assert got == want and fires == 1 and len(labels) == 1
    assert delta["POOL_REPLICA_DEATHS"] == 1


def test_kill_of_the_last_replica_orphans_until_a_scale_up(fleet):
    want = _uninterrupted(T, fleet, [0, 1])
    pool = _pool(T, fleet, replicas=1)
    for uid in (0, 1):
        pool.submit(uid, _prompt(uid), _greedy(T))
    pool.step()
    pool.kill(pool.labels[0])
    assert pool.stats()["orphans"] == 2
    assert pool.scale_up() is not None
    assert _ints(pool.run_to_completion()) == want


def _pages(engine, digests):
    """The pages an engine's prefix cache holds for ``digests``, as fp32
    numpy."""
    sm = engine.state_manager
    blob = sm.kv_cache.read_pages(
        [sm.prefix_cache.lookup(bytes.fromhex(d)) for d in digests])
    return np.asarray(blob.numpy() if isinstance(blob, torch.Tensor)
                      else blob, np.float32)


def test_page_fetch_streams_jax_equal_pages(fleet):
    """An affinity match that loses to least-backlog (margin 0) streams
    the matched pages from the digest holder: the chosen replica's pages
    are the holder's bit for bit, and JAX's to the forward's fp32
    tolerance (5e-6: each package computed the KV with its own fp32
    kernels, 3.1e-6 apart at most); the request's tokens are the cold
    reference's."""
    warm = _prompt(0, 48)
    full = np.concatenate([warm, _prompt(42, 9)])
    pool = _pool(T, fleet, replicas=1)      # the cold reference
    pool.submit(1, full, _greedy(T))
    ref = _ints(pool.run_to_completion())[1]

    def drive(pkg, fleet):
        pool = _pool(pkg, fleet, page_fetch_margin=0)
        pool.submit(1, warm, _greedy(pkg))
        pool.run_to_completion()
        pool.publish_hints()
        for uid, seed in ((2, 7), (3, 8), (4, 9)):
            pool.submit(uid, _prompt(seed), _greedy(pkg))
        pool.submit(100, full, _greedy(pkg))
        req = pool.request(100)
        digests = pool.router.prompt_digests(full)[:3]
        fetched = _pages(pool._replicas[req.replica].engine, digests)
        source = _pages(pool._replicas["r0"].engine, digests)
        np.testing.assert_array_equal(fetched, source)
        got = _ints(pool.run_to_completion())
        return got[100], req.replica, fetched
    runs = {}
    for pkg in (T, J):
        before = _counters(pkg)
        runs[pkg] = drive(pkg, fleet) + (_delta(pkg, before),)
    ttok, trep, tblob, tdelta = runs[T]
    jtok, jrep, jblob, jdelta = runs[J]
    assert ttok == jtok == ref and trep == jrep == "r1"
    np.testing.assert_allclose(tblob, jblob, rtol=5e-6, atol=5e-6)
    assert tdelta == jdelta and tdelta["POOL_PAGE_FETCHES"] == 1
    assert tdelta["POOL_PAGE_FETCH_PAGES"] == 3


def test_a_fetched_prefix_counts_as_a_remote_hit(fleet):
    """The engine-level fetch: ``export_prefix`` on the holder,
    ``import_prefix`` on a peer (parked, indexed), then the peer's match
    attaches the pages, the first time as "remote"."""
    eng = fleet[0]
    _reset(fleet)
    src, dst = eng(T, "r0"), eng(T, "r1")
    sched = T.FastGenScheduler(src)
    warm = _prompt(3, 48)
    sched.submit(1, warm, _greedy(T, 2))
    sched.run_to_completion()
    digests = TS.PrefixAffinityRouter(PAGE).prompt_digests(warm)
    meta_, arrays = src.export_prefix(digests)
    assert meta_["digests"] == digests
    stats = dst.import_prefix(meta_, arrays)
    assert stats == {"pages_imported": 3, "pages_skipped": 0}
    assert dst.import_prefix(meta_, arrays) == {"pages_imported": 0,
                                                "pages_skipped": 3}
    assert dst.match_prefix(9, warm) == 32      # leaves a suffix token
    assert dst.tier_hits(9)["remote"] == 32
    dst.flush(9)
    assert dst.match_prefix(10, warm) == 32
    assert dst.tier_hits(10) == {"device": 32, "host": 0, "disk": 0,
                                 "remote": 0}
    dst.flush(10)
    dst.state_manager.check_invariants()


class _Evaluator:
    """The duck-typed stand-in for the SLO evaluator's ``current()``."""

    def __init__(self, advice=None):
        self.advice = advice

    def current(self):
        if self.advice is None:
            return {"configured": False, "status": "ok", "objectives": {}}
        return {"configured": True, "status": "page", "objectives": {
            "obj": {"status": "page", "advice": self.advice}}}


def test_advice_and_rebalance_equal_jax(fleet):
    def drive(pkg, fleet):
        out = []
        pool = _pool(pkg, fleet, replicas=1, max_replicas=2)
        pool.attach_slo(_Evaluator("scale_up"), cooldown_s=60.0)
        pool.step()
        pool.step()                       # the cooldown holds
        out.append(pool.labels)
        pool.attach_slo(_Evaluator(None), cooldown_s=0.0)
        pool.step()
        out.append(pool.labels)
        assert pool.scale_up() is None    # max_replicas
        for uid in range(3):
            pool.submit(uid, _prompt(uid), _greedy(pkg))
        pool.step()
        out.append(pool.handle_advice("scale_down"))
        out.append(_ints(pool.run_to_completion()))
        pool = _pool(pkg, fleet)
        p = _prompt(1)
        pool.submit(0, p, _greedy(pkg))
        pool.run_to_completion()
        pool.publish_hints()
        for uid in (1, 2):
            pool.submit(uid, p, _greedy(pkg))
        hot = pool.request(1).replica
        out.append((hot, pool.request(2).replica))
        out.append(pool.rebalance())
        pool.run_to_completion()
        pool.submit(3, p, _greedy(pkg))
        out.append(pool.request(3).replica)
        assert pool.request(3).replica != hot
        pool.run_to_completion()
        return out
    runs = _both(fleet, drive)
    assert runs[T] == runs[J]
    out, delta = runs[T]
    assert out[0] == ["r0", "r1"] and out[2] is not None
    assert delta["POOL_SCALE_UP"] == 1 and delta["POOL_REBALANCE"] == 1


def test_threaded_serve_matches_the_step_loop(fleet):
    want = _uninterrupted(T, fleet, range(4))
    pool = _pool(T, fleet)
    pool.start()
    try:
        for uid in range(4):
            pool.submit(uid, _prompt(uid), _greedy(T))
        assert pool.serve_until_idle(timeout_s=60.0)
    finally:
        pool.stop()
    assert _ints(pool.results()) == want and not pool.errors
    assert all(not t.is_alive() for t in pool._threads.values())

