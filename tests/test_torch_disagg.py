"""Disaggregated prefill/decode serving in the port, held against the JAX
package.

Both packages run ``serving.DisaggPool`` (a ``role="prefill"`` and a
``role="decode"`` engine in one process, committed pages streamed across
through the selective export and the merge import) over the debug llama
in fp32 with the same bridged weights.  Held: the two-engine tokens equal
the port's fused engine's and the JAX pool's, greedy and keyed-sampled
(one base key); the pages streamed and shared, the handoffs and the
retries equal JAX's; the ``"misrouted"`` verdict; backpressure (a refused
import changes nothing, a request no decode pool can hold ends ``"oom"``
with its first token); a handoff of a preempted sequence (its host blob
travels); the ``kinds=`` key sets; handoff bundles written by one package
and imported by the other, both ways; a snapshot holding handoff-ready
requests restored in the port.  ``DS_KV_DEBUG=1`` audits both engines'
pages after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu import serving as JS
from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import engine as jengine
from deepspeed_tpu.inference.v2 import snapshot as jsnapshot
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu.telemetry import metrics as jtm
from deepspeed_tpu.telemetry import tracer as jtracer
from deepspeed_tpu_torch import serving as TS
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import engine as tengine
from deepspeed_tpu_torch.inference.v2 import snapshot as tsnapshot
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.telemetry import metrics as ttm
from deepspeed_tpu_torch.telemetry import tracer as ttracer

PAGE, SEED = 16, 7
DISAGG_COUNTERS = ("DISAGG_HANDOFFS", "DISAGG_PAGES_STREAMED",
                   "DISAGG_PAGES_SHARED", "DISAGG_HANDOFF_RETRY",
                   "DISAGG_MISROUTED")


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
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return {J: (model_def.cfg, params), T: (tcfg, tparams)}


def _engine(pkg, weights, role="both", keyed=True, num_pages=96,
            max_seqs=8, max_batch=256):
    cfg, params = weights[pkg]
    kv = dict(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
              head_dim=cfg.dims_per_head, page_size=PAGE,
              num_pages=num_pages)
    econf = pkg.RaggedInferenceEngineConfig(
        state_manager=pkg.StateManagerConfig(
            max_tracked_sequences=max_seqs,
            max_ragged_sequence_count=max_seqs,
            max_ragged_batch_size=max_batch),
        serving=pkg.ServingOptimizationConfig(role=role,
                                              keyed_sampling=keyed))
    if pkg is J:
        model = J.RaggedInferenceModel(cfg, params, kv_config=J.KVCacheConfig(
            dtype=jnp.float32, **kv))
    else:
        model = T.RaggedInferenceModel(cfg, params, kv_config=T.KVCacheConfig(
            dtype=torch.float32, **kv), device="cpu")
    return pkg.InferenceEngineV2(model, econf)


def _sched(pkg, eng):
    if pkg is J:
        return J.FastGenScheduler(eng, rng=jax.random.key(SEED))
    return T.FastGenScheduler(eng, seed=SEED)


def _pool(pkg, weights, keyed=True, decode_pages=96, handoff_every=4,
          on_token=None):
    serving = JS if pkg is J else TS
    return serving.DisaggPool(
        lambda: _sched(pkg, _engine(pkg, weights, "prefill", keyed)),
        lambda: _sched(pkg, _engine(pkg, weights, "decode", keyed,
                                    num_pages=decode_pages)),
        on_token=on_token, handoff_every=handoff_every)


def _workload(pkg, seed=1, greedy=False):
    """Greedy, sampled and stop-token requests; three of four share a
    two-page prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 128, 32)
    prompts = [np.concatenate([shared, rng.integers(0, 128, 9)]),
               np.concatenate([shared, rng.integers(0, 128, 21)]),
               rng.integers(0, 128, 18),
               np.concatenate([shared, rng.integers(0, 128, 5)])]
    params = [dict(temperature=0.0, max_new_tokens=10),
              dict(temperature=0.9, top_k=30, max_new_tokens=8),
              dict(temperature=0.0, max_new_tokens=12, stop_token=5),
              dict(temperature=0.7, top_p=0.9, max_new_tokens=6)]
    if greedy:
        params = [dict(p, temperature=0.0) for p in params]
    return prompts, [pkg.SamplingParams(**p) for p in params]


def _counters(tm):
    return {n: getattr(tm, n).value for n in DISAGG_COUNTERS}


def _delta(tm, before):
    return {n: getattr(tm, n).value - before[n] for n in DISAGG_COUNTERS}


def _serve_pool(pkg, weights, workload, staggered=0, **kw):
    tm = jtm if pkg is J else ttm
    before = _counters(tm)
    pool = _pool(pkg, weights, **kw)
    prompts, params = workload
    for i, p in enumerate(prompts):
        pool.submit(i, p, params[i])
        for _ in range(staggered):
            pool.step()
    res = pool.run_to_completion(max_stalls=2048)
    return res, pool, _delta(tm, before)


def _fused(pkg, weights, workload, keyed=True, staggered=0):
    sched = _sched(pkg, _engine(pkg, weights, keyed=keyed))
    got = {}
    prompts, params = workload
    for i, p in enumerate(prompts):
        sched.submit(i, p, params[i])
        for _ in range(staggered):
            sched.step(on_token=lambda u, t: got.setdefault(u, []).append(t))
    while sched.has_work:
        sched.step(on_token=lambda u, t: got.setdefault(u, []).append(t))
    return got


@pytest.fixture(scope="module")
def keyed_runs(weights):
    """The keyed workload, staggered arrivals and one handoff a pump (so
    the second same-prefix request's pages are shared on the decode
    side): the port's pool, the port's fused engine and the JAX pool."""
    out = {}
    for pkg in (T, J):
        out[pkg] = _serve_pool(pkg, weights, _workload(pkg, seed=7),
                               staggered=4, handoff_every=1)
    out["fused"] = _fused(T, weights, _workload(T, seed=7), staggered=4)
    return out


def test_keyed_two_engine_tokens_equal_fused_and_jax(keyed_runs):
    tres, tpool, tdelta = keyed_runs[T]
    jres, jpool, jdelta = keyed_runs[J]
    assert not tpool.errors and not jpool.errors
    assert tres == keyed_runs["fused"]
    assert tres == {u: [int(t) for t in v] for u, v in jres.items()}
    # the sampled requests drew (greedy would repeat across seeds)
    assert len(set(tres[1])) > 2
    assert tdelta == jdelta
    assert tdelta["DISAGG_PAGES_SHARED"] > 0
    assert tdelta["DISAGG_HANDOFFS"] == 4
    assert tpool.stats()["handed_off"] == 4


def test_greedy_two_engine_tokens_equal_fused_and_jax(weights):
    runs = {}
    for pkg in (T, J):
        runs[pkg] = _serve_pool(pkg, weights, _workload(pkg, greedy=True),
                                keyed=False)
    tres, tpool, tdelta = runs[T]
    jres, jpool, jdelta = runs[J]
    assert not tpool.errors and not jpool.errors
    assert tres == _fused(T, weights, _workload(T, greedy=True), keyed=False)
    assert tres == {u: [int(t) for t in v] for u, v in jres.items()}
    assert tdelta == jdelta


def test_first_token_comes_from_the_prefill_engine(weights):
    first_on_prefill = {}
    ref = []

    def spy(uid, tok):
        if uid not in first_on_prefill:
            first_on_prefill[uid] = ref[0].request(uid).replica == "prefill"

    pool = _pool(T, weights, on_token=spy)
    ref.append(pool)
    prompts, params = _workload(T)
    for i, p in enumerate(prompts):
        pool.submit(i, p, params[i])
    pool.run_to_completion()
    assert first_on_prefill == {i: True for i in range(len(prompts))}
    # the roles' key kinds: the decode engine dispatched no Q>1 key, the
    # prefill engine no chain or spec key
    dec = {tengine.lattice_kind_of(k)
           for k in pool.decode._engine.compiled_keys()}
    pre = {tengine.lattice_kind_of(k)
           for k in pool.prefill._engine.compiled_keys()}
    assert "prefill" not in dec and not pre & {"chain", "spec"}


def test_misrouted_verdicts_equal_jax(weights):
    deltas = {}
    for pkg in (T, J):
        tm = jtm if pkg is J else ttm
        before = _counters(tm)
        dec = _sched(pkg, _engine(pkg, weights, "decode"))
        v = dec.submit(1, list(range(20)), pkg.SamplingParams())
        assert v.code == "misrouted" and dec.errors[1].code == "misrouted"
        pre = _sched(pkg, _engine(pkg, weights, "prefill"))
        v = pre.submit(2, list(range(20)),
                       pkg.SamplingParams(max_new_tokens=4))
        assert v.code == "misrouted" and "sink" in v.message
        # one token is all a prefill engine produces: served without a
        # sink
        assert pre.submit(3, list(range(20)),
                          pkg.SamplingParams(max_new_tokens=1)) is None
        deltas[pkg] = _delta(tm, before)
        with pytest.raises(ValueError, match="role"):
            pkg.FastGenScheduler(_engine(pkg, weights), role="router")
    assert deltas[T] == deltas[J] and deltas[T]["DISAGG_MISROUTED"] == 2


def test_backpressure_retry_and_oom_verdict_equal_jax(weights):
    outcomes = {}
    for pkg in (T, J):
        tm = jtm if pkg is J else ttm
        before = _counters(tm)
        pool = _pool(pkg, weights, decode_pages=2)
        pool.submit(1, list(range(70)), pkg.SamplingParams(max_new_tokens=6))
        assert pool.run_to_completion(max_stalls=64) == {}
        err = pool.errors[1]
        assert err.code == "oom" and len(err.tokens) == 1 and pool.idle
        pool.decode._engine.state_manager.check_invariants()
        outcomes[pkg] = ([int(t) for t in err.tokens], _delta(tm, before))
    assert outcomes[T] == outcomes[J]
    assert outcomes[T][1]["DISAGG_HANDOFF_RETRY"] > 0


def test_a_refused_import_changes_nothing(weights):
    sched = _sched(T, _engine(T, weights, "prefill"))
    sched.enable_handoff_sink()
    sched.submit(1, list(range(70)), T.SamplingParams(max_new_tokens=6))
    while not sched.handoff_backlog:
        sched.step()
    bundle = sched.export_handoff([1])
    dec = _sched(T, _engine(T, weights, "decode", num_pages=2))
    sm = dec._engine.state_manager
    with pytest.raises(T.KVAllocationError):
        dec.import_handoff(bundle)
    assert sm.n_tracked_sequences == 0 and not dec.has_work
    assert sm.kv_cache.allocator.live_pages == 0
    sm.check_invariants()


def test_run_completes_under_decode_pressure(weights):
    workload = _workload(T, seed=13)
    res, pool, delta = _serve_pool(T, weights, workload, decode_pages=16)
    assert res == _fused(T, weights, workload) and not pool.errors


def test_a_preempted_handoff_carries_its_host_blob(weights):
    """KV pressure offloads a handoff-ready victim to the host: the bundle
    carries the blob, the decode engine takes the request into its
    preempted set and restores it, and the tokens are the fused
    engine's."""
    workload = _workload(T, seed=11)
    pool = _pool(T, weights, handoff_every=64)
    prompts, params = workload
    for i, p in enumerate(prompts):
        pool.submit(i, p, params[i])
    while not pool.prefill.handoff_backlog:
        pool.step()
    sm = pool.prefill._engine.state_manager
    assert pool.prefill._preempt_largest()
    # the victim is a handoff-ready request, parked still
    blobbed = [u for u in pool.prefill.handoff_ready_uids()
               if sm.get_sequence(u).host_blob is not None]
    assert len(blobbed) == 1 and not pool.prefill._preempted
    uid = blobbed[0]
    bundle = pool.prefill.export_handoff([uid])
    assert f"hostblob_{uid}" in bundle["arrays"]
    assert pool.run_to_completion() == _fused(T, weights, workload)
    assert not pool.errors and pool.stats()["handed_off"] == len(prompts)


@pytest.mark.parametrize("kinds", [("prefill", "decode"),
                                   ("decode", "chain", "spec"),
                                   ("decode",)])
def test_precompile_kinds_key_sets_equal_jax(weights, kinds):
    geo = dict(max_prompt=128, max_new_tokens=64, max_concurrency=8,
               page_size=PAGE, max_ragged_batch_size=256, has_fresh=True,
               sampling=True, spec_max_draft=3)
    want = jengine.lattice_keys(kinds=kinds, **geo)
    assert tengine.lattice_keys(kinds=kinds, **geo) == want
    eng = _engine(T, weights, "decode" if "chain" in kinds else "prefill")
    got = eng.precompile(128, max_concurrency=8, max_new_tokens=64,
                         sampling=True, spec_max_draft=3, kinds=kinds)
    assert got == want
    assert set(eng.model._step_cache) == set(want)
    with pytest.raises(ValueError, match="did not shrink"):
        eng.precompile(128, max_concurrency=8, max_new_tokens=64,
                       sampling=True, spec_max_draft=3,
                       kinds=tengine.LATTICE_KINDS)
    with pytest.raises(ValueError, match="unknown lattice kinds"):
        tengine.lattice_keys(kinds=("warp",), **geo)


def _parked(pkg, weights, uids_prompts):
    """A prefill scheduler holding the given requests handoff-ready."""
    sched = _sched(pkg, _engine(pkg, weights, "prefill"))
    sched.enable_handoff_sink()
    for uid, prompt, params in uids_prompts:
        sched.submit(uid, prompt, params)
    while len(sched.handoff_ready_uids()) < len(uids_prompts):
        sched.step()
    return sched


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_handoff_bundles_cross_between_the_packages(weights, tmp_path,
                                                    direction):
    """A handoff bundle written by one package's prefill engine (through
    the bundle file format) is imported by the other's decode engine,
    which finishes the requests with the fused engine's tokens; the
    imported pages are bit-equal to the exported ones."""
    src, dst = (T, J) if direction == "port_to_jax" else (J, T)
    prompts, params = _workload(src)
    reqs = [(i, p, params[i]) for i, p in enumerate(prompts)]
    pre = _parked(src, weights, reqs)
    bundle = pre.export_handoff(pre.handoff_ready_uids())
    path = str(tmp_path / "handoff.snap")
    (tsnapshot if src is T else jsnapshot).write_bundle(
        path, bundle["meta"], bundle["arrays"])
    meta_, arrays = (jsnapshot if dst is J else tsnapshot).read_bundle(path)
    dec = _sched(dst, _engine(dst, weights, "decode"))
    stats = dec.import_handoff({"meta": meta_, "arrays": arrays})
    assert sorted(stats["uids"]) == list(range(len(prompts)))
    assert stats["pages_shared"] == 0
    assert stats["pages_streamed"] == len(meta_["engine"]["page_ids"])
    # the imported pages, read back from the decode engine, are the blob
    sm = dec._engine.state_manager
    sent = np.asarray(arrays["page_blob"], np.float32)
    col = {p: i for i, p in enumerate(meta_["engine"]["page_ids"])}
    for m in meta_["engine"]["sequences"]:
        sd = sm.get_sequence(int(m["uid"]))
        here = [p for p in sd.pages if p]
        back = sm.kv_cache.read_pages(here)
        back = np.asarray(back.numpy() if isinstance(back, torch.Tensor)
                          else back, np.float32)
        want = sent[:, [col[p] for p in m["pages"] if p]]
        np.testing.assert_array_equal(back, want)
    pre.complete_handoff(stats["uids"])
    got = {u: list(map(int, pre_r.generated))
           for u, pre_r in [(u, dec._running.get(u) or dec._preempted[u])
                            for u in stats["uids"]]}
    while dec.has_work:
        dec.step(on_token=lambda u, t: got[u].append(int(t)))
    assert got == _fused(T, weights, _workload(T))


def test_a_snapshot_holding_handoff_ready_requests_restores(weights):
    """A JAX prefill engine's snapshot with parked handoffs restores in
    the port, whose decode engine then finishes them with JAX's tokens;
    the port's own snapshot round-trips its parked requests."""
    prompts, params = _workload(J)
    jpre = _parked(J, weights, [(i, p, params[i])
                                for i, p in enumerate(prompts)])
    bundle = jpre.snapshot()
    tpre = _sched(T, _engine(T, weights, "prefill"))
    tpre.enable_handoff_sink()
    tpre.restore(bundle)
    assert tpre.handoff_ready_uids() == jpre.handoff_ready_uids()
    assert {u: r.generated for u, r in tpre._handoff_ready.items()} == {
        u: [int(t) for t in r.generated]
        for u, r in jpre._handoff_ready.items()}
    again = _sched(T, _engine(T, weights, "prefill"))
    again.enable_handoff_sink()
    again.restore(tpre.snapshot())
    assert again.handoff_ready_uids() == tpre.handoff_ready_uids()
    dec = _sched(T, _engine(T, weights, "decode"))
    uids = again.handoff_ready_uids()
    stats = dec.import_handoff(again.export_handoff(uids))
    again.complete_handoff(uids)
    got = {u: list((dec._running.get(u) or dec._preempted[u]).generated)
           for u in stats["uids"]}
    while dec.has_work:
        dec.step(on_token=lambda u, t: got[u].append(int(t)))
    assert got == _fused(T, weights, _workload(T))
    assert not again.has_work and again.handoff_backlog == 0


def test_step_cost_counts_the_live_rows_not_the_padding(weights):
    """The port's rate gauges count each dispatch's live rows and their
    context (its own analytic cost: the JAX package reads XLA's cost
    analysis), never the padding of the key's S, Q and P buckets."""
    model = _engine(T, weights).model
    cfg, kv = model.cfg, model.kv_config
    key = (4, 8, 4, False)
    inputs = (np.zeros((4, 8), np.int32), np.array([8, 1, 0, 0], np.int32),
              np.array([0, 20, 0, 0], np.int32), np.zeros((4, 4), np.int32))
    flops, nbytes = model._dispatched_cost(key, inputs)
    hd = cfg.num_heads * cfg.dims_per_head
    # row 0: 8 fresh tokens attend 1..8 keys; row 1: one token over 21
    assert flops == (2.0 * model._weight_numel * 9
                     + 4.0 * cfg.num_layers * hd * (36 + 21))
    assert nbytes == (model._weight_bytes
                      + (8 + 21) * kv.bytes_per_page / kv.page_size)
    padded = model._program_cost(key)
    assert padded["flops"] > flops and padded["bytes"] > nbytes
    chain = (4, 1, 4, False, "chain", 4, True)
    assert model._dispatched_cost(
        chain, (None, None, np.array([1, 1, 0, 0], np.int32),
                np.array([5, 20, 0, 0], np.int32))) == (
        2.0 * model._weight_numel * 2 + 4.0 * cfg.num_layers * hd * 27,
        model._weight_bytes + 27 * kv.bytes_per_page / kv.page_size)


def test_pool_rates_count_only_the_pools_own_dispatches(weights):
    """Two pools built in turn over the same two engines serve the same
    traffic: the second pool's rates divide its own engines' work, not
    what the engines dispatched for the first pool as well."""
    pre = _engine(T, weights, "prefill", keyed=False)
    dec = _engine(T, weights, "decode", keyed=False)
    work = []
    for _ in range(2):
        pool = TS.DisaggPool(lambda: _sched(T, pre), lambda: _sched(T, dec))
        prompts, params = _workload(T, greedy=True)
        for i, p in enumerate(prompts):
            pool.submit(i, p, params[i])
        pool.run_to_completion(max_stalls=2048)
        assert not pool.errors
        rates = pool.refresh_cost_gauges()
        work.append((rates["prefill_mfu"] * pool.prefill_busy_s,
                     rates["decode_hbm_gb_s"] * pool.decode_busy_s))
        pre.reset_prefix_cache()
        dec.reset_prefix_cache()
    assert work[0][0] > 0 and work[0][1] > 0
    assert work[1] == pytest.approx(work[0], rel=1e-9)
