"""The port's mined bucket lattices held against the JAX package's.

On the CPU: ``fit_buckets`` and ``mine_lattice`` on the checked-in
``tools/traces/sample_200.jsonl`` give the JAX artifact, digests
included; the workload trace the port writes of a debug-llama run mines
to the artifact JAX's trace of the same run mines to (records equal but
for their clock fields); every ``LatticeError`` probe raises in both
packages; under one artifact both schedulers deliver the same
``{uid: token}`` at every step (greedy, keyed-sampled and n-gram
speculation) and dispatch the same keys, and a strict precompiled port
engine captures nothing on the request path; a snapshot carries the
lattice digest, and a restore onto an engine of another lattice skips the
warm precompile in both packages.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import lattice as jlattice
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu.telemetry import workload_trace as jtrace
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import lattice as tlattice
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.telemetry import workload_trace as ttrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_TRACE = os.path.join(REPO, "tools", "traces", "sample_200.jsonl")
PAGE, PAGES, BUDGET, SEED = 16, 96, 64, 7
# two modes of prompt length, as the traffic a mined lattice is for
PROMPT_LENS = [5, 40, 7, 44, 6, 41]
NEW_TOKENS = [6, 8, 5, 7, 9, 4]
#: the fields of a trace record that read a clock
CLOCK_FIELDS = {"arrival_s", "ttft_ms", "itl_ms", "queue_wait_ms",
                "time_unix", "t_s"}


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


def _engines(weights, batch=BUDGET, **serving):
    jcfg, jparams, tcfg, tparams = weights
    kv = dict(page_size=PAGE, num_pages=PAGES)
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=batch)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams, kv_config=J.KVCacheConfig(
            num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
            head_dim=jcfg.dims_per_head, dtype=jnp.float32, **kv)),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            serving=J.ServingOptimizationConfig(**serving)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, dtype=torch.float32, **kv),
            device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(**serving)))
    return jeng, teng


def _prompts(seed=1, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n) for n in lens]


def _lockstep(jsched, tsched):
    """Step both schedulers together: the same {uid: token} at every
    step.  Returns the steps taken."""
    steps = 0
    while jsched.has_work or tsched.has_work:
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}, steps
        steps += 1
    return steps


def _submit(jsched, tsched, prompts, params):
    for uid, (p, (temp, n)) in enumerate(zip(prompts, params)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n,
                                               temperature=temp))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n,
                                               temperature=temp))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _clockless(rec):
    return {k: v for k, v in rec.items() if k not in CLOCK_FIELDS}


# ---------------------------------------------------------------------------
# mining: the checked-in trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio,max_buckets", [(1.3, 12), (1.05, 4),
                                               (2.0, 12), (0.5, 3)])
def test_fit_buckets_equal_jax_on_the_sample_trace(ratio, max_buckets):
    lens = [r["prompt_len"]
            for r in jlattice.load_trace_facts(SAMPLE_TRACE)["requests"]]
    assert len(lens) == 200
    got = tlattice.fit_buckets(lens, ratio=ratio, max_buckets=max_buckets)
    assert got == jlattice.fit_buckets(lens, ratio=ratio,
                                       max_buckets=max_buckets)
    assert 0 < len(got) <= max_buckets


@pytest.mark.parametrize("batch", [64, 128, 768])
def test_mined_artifact_equals_jax_on_the_sample_trace(batch):
    """The whole artifact, digests included, from each package's own
    parser and miner."""
    tfacts = tlattice.load_trace_facts(SAMPLE_TRACE)
    jfacts = jlattice.load_trace_facts(SAMPLE_TRACE)
    assert tfacts == jfacts
    art = tlattice.mine_lattice(tfacts, max_ragged_batch_size=batch,
                                source=SAMPLE_TRACE)
    assert art == jlattice.mine_lattice(jfacts, max_ragged_batch_size=batch,
                                        source=SAMPLE_TRACE)
    assert tlattice.lattice_content_digest(art) == \
        jlattice.lattice_content_digest(art)
    # non-power Q tops fitted to the traffic
    assert any(q & (q - 1) for q in art["q_buckets"])
    lat = tlattice.resolve_lattice(
        f"auto:{SAMPLE_TRACE}", page_size=art["page_size"],
        vocab_size=art["vocab_size"], max_ragged_batch_size=batch)
    jlat = jlattice.resolve_lattice(
        f"auto:{SAMPLE_TRACE}", page_size=art["page_size"],
        vocab_size=art["vocab_size"], max_ragged_batch_size=batch)
    assert (lat.s_tops, lat.q_tops, lat.p_tops, lat.keys, lat.digest) == \
        (jlat.s_tops, jlat.q_tops, jlat.p_tops, jlat.keys, jlat.digest)
    for n in (1, 3, 17, 75, 300, 5000):
        assert (lat.bucket_s(n), lat.bucket_q(n), lat.bucket_p(n)) == \
            (jlat.bucket_s(n), jlat.bucket_q(n), jlat.bucket_p(n))


# ---------------------------------------------------------------------------
# mining: a trace each package writes of the same run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_run(weights, tmp_path_factory):
    """One greedy run of both schedulers in the default serving
    configuration, each package writing its own workload trace; returns
    the two trace paths and the artifact each mines."""
    tmp = tmp_path_factory.mktemp("trace")
    paths = {"jax": str(tmp / "jax.jsonl"), "port": str(tmp / "port.jsonl")}
    jt, tt = jtrace.get_workload_trace(), ttrace.get_workload_trace()
    jt.configure(paths["jax"])
    tt.configure(paths["port"])
    try:
        jeng, teng = _engines(weights)
        jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
        _submit(jsched, tsched, _prompts(),
                [(0.0, n) for n in NEW_TOKENS])
        _lockstep(jsched, tsched)
    finally:
        jt.close()
        tt.close()
    arts = {"jax": jlattice.mine_lattice(
                jlattice.load_trace_facts(paths["jax"]),
                max_ragged_batch_size=BUDGET),
            "port": tlattice.mine_lattice(
                tlattice.load_trace_facts(paths["port"]),
                max_ragged_batch_size=BUDGET)}
    for name, art in arts.items():
        tlattice.write_artifact(art, str(tmp / f"{name}.lattice.json"))
    return paths, arts, {n: str(tmp / f"{n}.lattice.json") for n in arts}


def test_port_trace_records_equal_jax_but_for_the_clock(traced_run):
    paths, _, _ = traced_run
    trecs, jrecs = _records(paths["port"]), _records(paths["jax"])
    assert [_clockless(r) for r in trecs] == [_clockless(r) for r in jrecs]
    kinds = [r["kind"] for r in trecs]
    assert kinds[0] == "compile" and "meta" in kinds and "keys" in kinds
    reqs = [r for r in trecs if r["kind"] == "request"]
    assert sorted(r["uid"] for r in reqs) == list(range(len(PROMPT_LENS)))
    # content-free: lengths and digests, never a token id
    assert all(isinstance(r["prompt_len"], int)
               and all(isinstance(d, str) and len(d) == 32
                       for d in r["digests"]) for r in reqs)
    assert all(r["ttft_ms"] is not None and r["queue_wait_ms"] is not None
               for r in reqs)


def test_port_trace_mines_to_the_jax_artifact(traced_run):
    _, arts, _ = traced_run
    assert arts["port"] == arts["jax"]
    assert any(q & (q - 1) for q in arts["port"]["q_buckets"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _probe(case, tmp_path, art_path):
    """(spec, page_size, batch) of one LatticeError probe."""
    if case == "missing_path":
        return f"auto:{tmp_path / 'nope.json'}", PAGE, BUDGET
    if case == "bogus_spec":
        return "bogus", PAGE, BUDGET
    if case == "other_page_size":
        return f"auto:{art_path}", 32, BUDGET
    if case == "larger_batch_budget":
        return f"auto:{art_path}", PAGE, 2 * BUDGET
    doc = json.load(open(art_path))
    doc["keys"].append([1, 1, 8, False, "chain", 1])    # a key too short
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    return f"auto:{bad}", PAGE, BUDGET


@pytest.mark.parametrize("case", ["missing_path", "bogus_spec",
                                  "other_page_size", "larger_batch_budget",
                                  "malformed_key"])
def test_every_lattice_refusal_raises_in_both(case, traced_run, tmp_path):
    _, _, art_paths = traced_run
    spec, page, batch = _probe(case, tmp_path, art_paths["port"])
    for mod in (jlattice, tlattice):
        with pytest.raises(mod.LatticeError):
            mod.resolve_lattice(spec, page_size=page, vocab_size=128,
                                max_ragged_batch_size=batch)


def test_engine_build_refuses_a_lattice_of_another_page_size(weights,
                                                             traced_run):
    _, _, art_paths = traced_run
    _, _, tcfg, tparams = weights
    model = T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
        num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
        head_dim=tcfg.dims_per_head, page_size=32, num_pages=PAGES,
        dtype=torch.float32), device="cpu")
    with pytest.raises(tlattice.LatticeError, match="config digest"):
        T.InferenceEngineV2(model, T.RaggedInferenceEngineConfig(
            serving=T.ServingOptimizationConfig(
                lattice=f"auto:{art_paths['port']}")))


# ---------------------------------------------------------------------------
# serving under one artifact
# ---------------------------------------------------------------------------

TRAFFIC = {
    "greedy": (dict(), [(0.0, n) for n in NEW_TOKENS]),
    "keyed_sampled": (dict(keyed_sampling=True),
                      [(0.0 if i % 2 else 0.9, n)
                       for i, n in enumerate(NEW_TOKENS)]),
    "ngram_spec": (dict(speculative=True, spec_max_draft=3,
                        prefix_caching=False),
                   [(0.0, n + 6) for n in NEW_TOKENS]),
}


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_one_artifact_serves_the_jax_tokens_at_every_step(
        traffic, weights, traced_run, monkeypatch):
    """Both engines bucket under the mined artifact; every step delivers
    the same tokens, and both dispatch the same keys (non-power Q tops
    among them)."""
    monkeypatch.setenv("DS_KV_DEBUG", "1")
    _, _, art_paths = traced_run
    serving, params = TRAFFIC[traffic]
    jeng, teng = _engines(weights, lattice=f"auto:{art_paths['jax']}",
                          **serving)
    assert teng.lattice_digest == jeng._lattice.digest != ""
    prompts = _prompts(2)
    if traffic == "ngram_spec":      # loopy prompts: the drafter drafts
        prompts = [np.tile(p[:4], 12)[:n] for p, n in
                   zip(prompts, PROMPT_LENS)]
    jsched = J.FastGenScheduler(jeng, rng=jax.random.key(SEED))
    tsched = T.FastGenScheduler(teng, seed=SEED)
    _submit(jsched, tsched, prompts, params)
    _lockstep(jsched, tsched)
    assert teng.compiled_keys() == jeng.compiled_keys()
    q_tops = {k[1] for k in teng.compiled_keys()} | {
        k[6] for k in teng.compiled_keys() if len(k) > 4 and k[4] == "mixed"}
    assert any(q & (q - 1) for q in q_tops)
    if traffic == "ngram_spec":
        assert tsched._spec_drafted_cum > 0
        assert any(k[4] == "spec" for k in teng.compiled_keys()
                   if len(k) > 4)


def test_strict_mined_engine_captures_nothing_on_the_path(weights,
                                                          traced_run):
    """precompile(strict=True) under the artifact captures its keys up
    front; serving the traffic (in waves of two requests: a strict
    scheduler serves mixed steps split, one forward a power-of-two Q
    group, and three chunks in one group would form an S * Q past the
    budget that no lattice holds) then adds none, and gives the tokens
    of the power-lattice engine."""
    _, _, art_paths = traced_run
    _, teng = _engines(weights, lattice=f"auto:{art_paths['port']}")
    keys = teng.precompile(max_prompt=64, sampling=True, strict=True)
    model = teng.model
    assert model.precompile_captures == len(set(keys)) > 0
    assert all(len(k) < 5 or k[4] != "mixed" for k in keys)
    _, power = _engines(weights)
    prompts = _prompts(3)
    for wave in range(0, len(prompts), 2):
        outs = []
        for eng in (teng, power):
            sched = T.FastGenScheduler(eng)
            for uid in range(wave, wave + 2):
                sched.submit(uid, prompts[uid], T.SamplingParams(
                    max_new_tokens=NEW_TOKENS[uid]))
            outs.append(sched.run_to_completion())
        assert outs[0] == outs[1]
    assert model.path_captures == 0
    assert set(teng.compiled_keys()) <= set(keys)
    assert power.model.path_captures == len(power.compiled_keys())


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def _restore_skips(pkg, eng, bundle, monkeypatch):
    """Restore ``bundle`` with ``precompile_keys`` watched; returns the
    manifests it was called with."""
    calls = []
    orig = eng.precompile_keys
    monkeypatch.setattr(eng, "precompile_keys",
                        lambda keys: calls.append(list(keys)) or orig(keys))
    sched = (J.FastGenScheduler(eng) if pkg == "jax"
             else T.FastGenScheduler(eng))
    sched.restore(bundle)
    return calls, sched


def test_snapshot_carries_the_lattice_digest_and_restore_compares_it(
        weights, traced_run, monkeypatch):
    _, _, art_paths = traced_run
    spec = f"auto:{art_paths['port']}"
    jeng, teng = _engines(weights, lattice=spec)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _prompts(4), [(0.0, n) for n in NEW_TOKENS])
    for _ in range(3):
        jsched.step()
        tsched.step()
    bundles = {"jax": jsched.snapshot(), "port": tsched.snapshot()}
    for b in bundles.values():
        assert b["meta"]["compiled"]["lattice_digest"] == teng.lattice_digest
        assert b["meta"]["compiled"]["keys"]
    # the same lattice: the manifest is captured up front
    jsame, tsame = _engines(weights, lattice=spec)
    assert _restore_skips("jax", jsame, bundles["jax"], monkeypatch)[0]
    assert _restore_skips("port", tsame, bundles["port"], monkeypatch)[0]
    # the power lattice: skipped with a warning, the restore still exact
    jpow, tpow = _engines(weights)
    calls, jres = _restore_skips("jax", jpow, bundles["jax"], monkeypatch)
    assert calls == []
    with pytest.warns(UserWarning, match="lattice digest"):
        calls, tres = _restore_skips("port", tpow, bundles["port"],
                                     monkeypatch)
    assert calls == []
    assert tres.run_to_completion() == {
        u: [int(t) for t in toks]
        for u, toks in jres.run_to_completion().items()}


def test_the_first_step_after_a_restore_captures_the_same_key_in_both(
        weights):
    """A restore captures the bundle's dispatched keys up front; its first
    step runs on the host path (nothing is in flight to chain from), and
    the decode key it forms was never dispatched before the snapshot,
    where every decode after a prefill chained.  The JAX scheduler
    compiles the same key on its path at that step: shared behaviour."""
    jeng, teng = _engines(weights)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _prompts(5, [9, 12]), [(0.0, 12), (0.0, 12)])
    for _ in range(4):
        jsched.step()
        tsched.step()
    bundles = {"jax": jsched.snapshot(), "port": tsched.snapshot()}
    manifest = [tuple(k) for k in bundles["port"]["meta"]["compiled"]["keys"]]
    assert manifest == [tuple(k) for k in
                        bundles["jax"]["meta"]["compiled"]["keys"]]
    jeng2, teng2 = _engines(weights)
    jres = J.FastGenScheduler(jeng2).restore(bundles["jax"])
    tres = T.FastGenScheduler(teng2).restore(bundles["port"])
    assert teng2.model.precompile_captures == len(manifest)
    jout, tout = jres.step(), tres.step()
    assert tout == {u: int(t) for u, t in jout.items()}
    new = set(teng2.compiled_keys()) - set(manifest)
    assert new == set(jeng2.compiled_keys()) - set(manifest)
    assert teng2.model.path_captures == len(new) == 1
    (key,) = new
    assert key[1] == 1 and key[4] == "sample"
