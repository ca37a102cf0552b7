"""Speculative decoding with the n-gram drafter in the port, held against
the JAX package.

The port's ``NgramDrafter`` proposes what JAX's does, on seeded random
and periodic histories and in the JAX suite's own drafter cases; the
spec step keys are JAX's; the verify step returns JAX's [S, 2] verdict
and writes JAX's KV (fp32, within 1e-5).  Then both schedulers serve
the debug llama in fp32 over the same weights (page 16) with
``speculative=True`` and are stepped together: after every step the
same ``{uid: token}``, the same ``on_token`` stream, the same rows
scheduled, the same cumulative drafted and accepted counts and the same
free pages, over the cases of ``tests/test_spec_decoding.py`` (a mixed
workload, a stop token inside an accepted block, variable-advance
accounting, preemption on a 12-page pool, prefix-cache sharing under
rollback, a sliding window, a zero-accept drafter, ``max_new_tokens``).
``DS_KV_DEBUG=1`` audits the pages after every step.  In the port
itself greedy tokens with speculation equal those without, and sampled
rows keep their lengths, their seed and the greedy rows beside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import engine as jengine
from deepspeed_tpu.inference.v2 import lattice as jlattice
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import engine as tengine
from deepspeed_tpu_torch.inference.v2 import lattice as tlattice
from deepspeed_tpu_torch.models.llama import llama_config

PAGE = 16
ECFG = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=256)
SPEC = dict(speculative=True, prefix_caching=False)
OFF = dict(prefix_caching=False)
SPLIT = dict(fused_step=False, on_device_sampling=False,
             async_scheduling=False, prefix_caching=False)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DS_KV_DEBUG", "1")


_WEIGHTS = {}


def _weights(window=None):
    """(JAX cfg, JAX params, port cfg, port params) of the debug llama,
    made once per window."""
    if window not in _WEIGHTS:
        kw = {"sliding_window": window} if window else {}
        model_def = LlamaForCausalLM("debug", max_seq_len=256,
                                     dtype=jnp.float32, **kw)
        params = meta.unbox(model_def.init_params(jax.random.key(0)))
        tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32,
                            **kw)
        tparams = from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
        _WEIGHTS[window] = (model_def.cfg, params, tcfg, tparams)
    return _WEIGHTS[window]


_JAX_MODELS = {}


def _jax_model(pages, window=None):
    """One JAX model per geometry for the whole module: its compiled
    steps carry over from engine to engine."""
    if (pages, window) not in _JAX_MODELS:
        jcfg, jparams, _, _ = _weights(window)
        _JAX_MODELS[pages, window] = J.RaggedInferenceModel(
            jcfg, jparams, kv_config=J.KVCacheConfig(
                num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
                head_dim=jcfg.dims_per_head, page_size=PAGE,
                num_pages=pages, dtype=jnp.float32))
    return _JAX_MODELS[pages, window]


def _engines(pages=64, window=None, sm=None, **serving):
    """The JAX engine and the port's over the same weights, geometry and
    serving configuration."""
    sm = dict(ECFG, **(sm or {}))
    _, _, tcfg, tparams = _weights(window)
    jeng = J.InferenceEngineV2(
        _jax_model(pages, window), J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            serving=J.ServingOptimizationConfig(**serving)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, page_size=PAGE, num_pages=pages,
            dtype=torch.float32), device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(**serving)))
    return jeng, teng


def _submit(jsched, tsched, prompts, new, uid0=0, stop=None):
    for i, p in enumerate(prompts):
        n = new[i] if isinstance(new, list) else new
        jsched.submit(uid0 + i, p, J.SamplingParams(max_new_tokens=n,
                                                    stop_token=stop))
        tsched.submit(uid0 + i, p, T.SamplingParams(max_new_tokens=n,
                                                    stop_token=stop))


def lockstep(jsched, tsched, jeng, teng, stagger=None, after=None,
             limit=400):
    """Step both schedulers together.  After every step: the same {uid:
    token}, the same rows scheduled, the same cumulative drafted and
    accepted counts, the same free pages and preempted set; the
    ``on_token`` streams must be equal.  ``stagger`` = (prompts, new, k)
    submits one request every k steps; ``after(step)`` runs after each
    step.  Returns the port's tokens per uid."""
    streams = {"jax": [], "port": []}
    pending = list(enumerate(stagger[0])) if stagger else []
    step = 0
    while pending or jsched.has_work or tsched.has_work:
        if pending and step % stagger[2] == 0:
            i, p = pending.pop(0)
            _submit(jsched, tsched, [p], stagger[1], uid0=i)
        jout = jsched.step(on_token=lambda u, t: streams["jax"].append(
            (u, int(t))))
        tout = tsched.step(on_token=lambda u, t: streams["port"].append(
            (u, t)))
        assert tout == {u: int(t) for u, t in jout.items()}, step
        assert tsched.last_step_scheduled == jsched.last_step_scheduled, step
        assert (tsched._spec_drafted_cum, tsched._spec_accepted_cum) == (
            jsched._spec_drafted_cum, jsched._spec_accepted_cum), step
        assert teng.free_blocks == jeng.free_blocks, step
        assert set(tsched._preempted) == set(jsched._preempted), step
        if after is not None:
            after(step)
        step += 1
        assert step < limit, "no progress"
    assert streams["port"] == streams["jax"]
    tokens = {}
    for u, t in streams["port"]:
        tokens.setdefault(u, []).append(t)
    return tokens


def _loopy(n=3):
    """Constant prompts: the debug model's greedy output falls into
    loops the prompt-lookup drafter predicts."""
    return [[7] * 12 for _ in range(n)]


def _oracle(ref, salt=None):
    """Drafts the true greedy continuation (every draft accepted); with
    ``salt`` the last draft of each block is garbage (every block ends in
    a verified rejection)."""
    def propose(uid, prompt, generated, cap):
        k = len(generated)
        draft = list(ref[uid][k:k + cap])
        if salt is not None and draft:
            draft[-1] = salt
        return np.asarray(draft, np.int32)
    return propose


def _serve_port(prompts, new, serving, seed=0, params=None, pages=64):
    _, teng = _engines(pages=pages, **serving)
    sched = T.FastGenScheduler(teng, seed=seed)
    for i, p in enumerate(prompts):
        sched.submit(i, p, params[i] if params else
                     T.SamplingParams(max_new_tokens=new))
    return sched.run_to_completion(), sched


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

def _histories():
    rng = np.random.default_rng(5)
    out = [("random", rng.integers(0, 12, 64).tolist()),
           ("random wide", rng.integers(0, 128, 96).tolist()),
           ("periodic 2", [3, 9] * 20),
           ("periodic 5", list(range(5)) * 9 + [1, 2]),
           ("motif", np.resize(rng.integers(0, 50, 7), 40).tolist())]
    return out


@pytest.mark.parametrize("ngram_min", [1, 2, 3, 6])
@pytest.mark.parametrize("case", [h[0] for h in _histories()])
def test_ngram_drafter_proposes_what_jax_proposes(case, ngram_min):
    """The history grows one committed token at a time (the prompt is
    the first quarter); every step both drafters propose from it at
    every cap."""
    hist = dict(_histories())[case]
    cut = len(hist) // 4
    prompt = np.asarray(hist[:cut], np.int32)
    jd, td = J.NgramDrafter(ngram_min), T.NgramDrafter(ngram_min)
    for n in range(cut, len(hist) + 1):
        gen = hist[cut:n]
        for cap in (0, 1, 3, 5):
            a = jd.propose(1, prompt, gen, cap)
            b = td.propose(1, prompt, gen, cap)
            assert b.dtype == np.int32 and b.tolist() == a.tolist(), (n, cap)
    assert len(td) == len(jd) == 1
    td.drop(1)
    assert len(td) == 0


# the JAX suite's drafter cases (tests/test_spec_decoding.py:130-200):
# (ngram_min, [(uid, prompt, generated, cap), ...])
_JAX_CASES = {
    "prompt lookup": (2, [(1, [1, 2, 3, 4, 5, 1, 2, 3], [], 3)]),
    "periodic tail": (2, [(1, [9, 8, 5, 4, 5, 4, 5, 4], [], 4)]),
    "no hit": (2, [(1, list(range(16)), [], 3)]),
    "incremental": (2, [(1, [3, 1, 4, 1, 5], [], 3),
                        (1, [3, 1, 4, 1, 5], [9, 3, 1], 3)]),
    "min gates bigram": (2, [(1, [5, 1, 9, 2, 7, 1], [], 3)]),
    "min gates unigram": (1, [(2, [5, 1, 9, 2, 7, 1], [], 2)]),
    "zero budget": (2, [(1, [1, 2, 1, 2], [], 0)]),
    "uid reuse": (2, [(2, [1, 2, 3, 4, 1, 2], [], 4),
                      (2, [9, 8, 7, 6, 9, 8], [], 4)]),
    "min above max": (6, [(1, [1, 2, 3, 4, 5, 6, 9, 1, 2, 3, 4, 5, 6],
                           [], 2)]),
}


@pytest.mark.parametrize("case", sorted(_JAX_CASES))
def test_ngram_drafter_jax_suite_cases(case):
    ngram_min, calls = _JAX_CASES[case]
    jd, td = J.NgramDrafter(ngram_min), T.NgramDrafter(ngram_min)
    for uid, prompt, gen, cap in calls:
        prompt = np.asarray(prompt, np.int32)
        assert td.propose(uid, prompt, gen, cap).tolist() == \
            jd.propose(uid, prompt, gen, cap).tolist()


def test_model_drafter_proposes_placeholders():
    jd, td = J.spec.ModelDrafter(), T.ModelDrafter()
    for cap in (0, 3):
        a = jd.propose(4, np.asarray([1, 2], np.int32), [3], cap)
        b = td.propose(4, np.asarray([1, 2], np.int32), [3], cap)
        assert b.tolist() == a.tolist() and b.dtype == np.int32
    assert len(td) == 1
    td.drop(4)
    assert len(td) == 0


# ---------------------------------------------------------------------------
# the step keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("spec_max_draft", [1, 3, 5])
@pytest.mark.parametrize("kinds", [None, ("decode", "chain", "spec"),
                                   ("spec",)])
def test_spec_lattice_keys_equal_jax(spec_max_draft, draft, kinds):
    kw = dict(max_prompt=40, max_new_tokens=24, max_concurrency=6,
              page_size=16, max_ragged_batch_size=64, has_fresh=True,
              sampling=True, spec_max_draft=spec_max_draft, kinds=kinds,
              draft=draft)
    keys = tengine.lattice_keys(**kw)
    assert keys == jengine.lattice_keys(**kw)
    spec = [k for k in keys if len(k) > 4 and k[4] == "spec"]
    # one Q bucket, the power of two at or above 1 + spec_max_draft
    assert spec and {k[1] for k in spec} == {
        {1: 2, 3: 4, 5: 8}[spec_max_draft]}
    assert any(len(k) > 4 and k[4] == "draft_fill" for k in keys) == draft


@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("spec_q", [2, 4, 8])
def test_enumerate_spec_families_equal_jax_over_arbitrary_tops(spec_q,
                                                               draft):
    kw = dict(page_size=16, max_ragged_batch_size=96, has_fresh=True,
              sampling=True, spec_q=spec_q, draft=draft)
    tops = ([1, 3, 6], [1, 5, 24, 40], [2, 7, 9])
    assert tlattice.enumerate_lattice_keys(*tops, **kw) == \
        jlattice.enumerate_lattice_keys(*tops, **kw)


def test_spec_keys_only_with_sampling_and_a_draft():
    kw = dict(max_prompt=8, max_new_tokens=16, max_concurrency=4,
              page_size=16, max_ragged_batch_size=64, has_fresh=True)
    assert not [k for k in tengine.lattice_keys(sampling=False,
                                                spec_max_draft=3, **kw)
                if len(k) > 4 and k[4] == "spec"]
    assert not [k for k in tengine.lattice_keys(sampling=True,
                                                spec_max_draft=0, **kw)
                if len(k) > 4 and k[4] == "spec"]


# ---------------------------------------------------------------------------
# the verify step against JAX's
# ---------------------------------------------------------------------------

def test_spec_step_verdict_and_kv_equal_jax():
    """Prefill three prompts on both engines, then one verify step whose
    rows draft 3, 2 and 0 tokens: the first row's drafts are the true
    greedy continuation (accepted), the second's part after one token.
    The [S, 2] verdicts are equal and so is every written KV row."""
    jeng, teng = _engines(**SPEC)
    prompts = [[7] * 12, list(range(20, 45)), [3, 1, 4, 1, 5, 9, 2, 6]]
    uids = [0, 1, 2]
    jl = np.asarray(jeng.put(uids, [np.asarray(p, np.int32)
                                    for p in prompts]))
    tl = teng.put(uids, [np.asarray(p, np.int32) for p in prompts]).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    first = jl.argmax(-1)
    # the true continuation of row 0, from a spec-off JAX run
    ref, _ = _serve_jax_greedy([prompts[0]], 5)
    rows = [np.asarray([first[0]] + ref[0][1:4], np.int32),
            np.asarray([first[1], 77, 78], np.int32),
            np.asarray([first[2]], np.int32)]
    sp = [J.SamplingParams()] * 3
    jv = np.asarray(jeng.step_spec(uids, rows, sp, jax.random.key(0),
                                   min_q=4))
    tv = teng.step_spec(uids, rows, [T.SamplingParams()] * 3,
                        torch.Generator(), min_q=4).numpy()
    assert tv.dtype == np.int32 and tv.shape == jv.shape == (4, 2)
    assert tv[:3].tolist() == jv[:3].tolist()
    assert tv[0, 0] == 3 and tv[2, 0] == 0
    jkv = np.asarray(jeng.state_manager.kv_cache.data)
    tkv = teng.state_manager.kv_cache.data.numpy()
    np.testing.assert_allclose(tkv[:, 1:], jkv[:, 1:], rtol=1e-5, atol=1e-5)
    # the variable-advance commit: 1 + accepted for each row
    committed = [1 + int(a) for a in tv[:3, 0]]
    jeng.commit_spec(uids, committed)
    teng.commit_spec(uids, committed)
    assert [teng.seen_tokens(u) for u in uids] == \
        [jeng.seen_tokens(u) for u in uids] == \
        [len(p) + c for p, c in zip(prompts, committed)]
    teng.state_manager.check_invariants()


def _serve_jax_greedy(prompts, new, serving=OFF, pages=64, window=None):
    jeng, _ = _engines(pages=pages, window=window, **serving)
    sched = J.FastGenScheduler(jeng)
    for i, p in enumerate(prompts):
        sched.submit(i, p, J.SamplingParams(max_new_tokens=new))
    out = sched.run_to_completion()
    return {u: [int(t) for t in v] for u, v in out.items()}, sched


# ---------------------------------------------------------------------------
# the scheduler, step by step against JAX's
# ---------------------------------------------------------------------------

def test_mixed_workload_step_by_step():
    """Staggered arrivals: prefill chunks next to running decodes, and
    speculation on the pure-decode stretches."""
    rng = np.random.default_rng(0)
    prompts = _loopy(2) + [rng.integers(0, 128, n).tolist()
                           for n in (19, 7)]
    jeng, teng = _engines(**SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    got = lockstep(jsched, tsched, jeng, teng, stagger=(prompts, 12, 2))
    assert tsched._spec_drafted_cum > 0
    assert {"spec", "chain", "mixed"} <= {k[4] for k in teng.compiled_keys()
                                          if len(k) > 4}
    assert all(len(v) == 12 for v in got.values())
    assert teng.free_blocks == 64


def test_stop_token_inside_an_accepted_block():
    """Oracle drafts (always accepted) and a stop token whose first
    occurrence is at a non-final position of a block: the commit stops
    there, the tokens past it are never delivered, and they are not
    counted as accepted."""
    prompts = _loopy(2)
    ref, _ = _serve_jax_greedy(prompts, 24)
    stop_i = next(i for i in range(2, 20)
                  if ref[0][i] not in ref[0][:i] and i % 4 != 0)
    jeng, teng = _engines(**SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    jsched._drafter.propose = tsched._drafter.propose = _oracle(ref)
    _submit(jsched, tsched, prompts, 24, stop=ref[0][stop_i])
    got = lockstep(jsched, tsched, jeng, teng)
    assert got[0][-1] == ref[0][stop_i] and len(got[0]) == stop_i + 1
    assert 0 < tsched._spec_accepted_cum <= sum(len(v) - 1
                                                for v in got.values())


def test_variable_advance_commit_accounting():
    """Every block ends in a verified rejection (salted oracle drafts):
    mid-run each drained decode row's seen tokens are prompt + generated
    - 1 (+ 1 with a token in flight), and the stream is the spec-off
    one."""
    prompts = _loopy(2)
    ref, _ = _serve_jax_greedy(prompts, 32)
    jeng, teng = _engines(**SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    jsched._drafter.propose = tsched._drafter.propose = _oracle(ref, 127)
    _submit(jsched, tsched, prompts, 32)
    reqs = list(tsched._pending)
    for _ in range(10):
        assert tsched.step() == {u: int(t) for u, t in jsched.step().items()}
    infl = ({u for u, _, _ in tsched._inflight.rows}
            if tsched._inflight else set())
    checked = 0
    for uid, req in tsched._running.items():
        if req.prefill_remaining or not req.generated:
            continue
        assert teng.seen_tokens(uid) == jeng.seen_tokens(uid) == (
            len(req.prompt) + len(req.generated) - 1 + (uid in infl))
        checked += 1
    assert checked
    assert tsched._spec_drafted_cum > tsched._spec_accepted_cum > 0
    lockstep(jsched, tsched, jeng, teng)
    assert {r.uid: r.generated for r in reqs} == ref


def test_preemption_mid_spec_on_a_12_page_pool():
    rng = np.random.default_rng(1)
    prompts = [[7] * 100, rng.integers(0, 100, 60).tolist(), [7] * 40]
    jeng, teng = _engines(pages=12, sm=dict(max_tracked_sequences=4,
                                            max_ragged_sequence_count=4),
                          **SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, prompts, 24)
    preempted = []
    got = lockstep(jsched, tsched, jeng, teng,
                   after=lambda step: preempted.extend(tsched._preempted))
    assert all(len(v) == 24 for v in got.values())
    assert preempted and not tsched._preempted and tsched._inflight is None
    assert tsched._spec_drafted_cum == jsched._spec_drafted_cum > 0


def test_prefix_cache_sharing_under_rollback():
    """Shared two-page prefix, prefix caching and the async chain on:
    wave A fills the cache, wave B hits it while speculating; a rolled
    back draft never reaches a shared page."""
    rng = np.random.default_rng(2)
    shared = [7] * (2 * PAGE)
    prompts = [shared + rng.integers(0, 128, 5 + i).tolist()
               for i in range(3)]
    jeng, teng = _engines(speculative=True)
    hits = {"jax": {}, "port": {}}
    for name, eng in (("jax", jeng), ("port", teng)):
        match = eng.match_prefix

        def recorded(uid, prompt, _m=match, _h=hits[name]):
            _h[uid] = _m(uid, prompt)
            return _h[uid]
        eng.match_prefix = recorded
    for wave in range(2):
        jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
        _submit(jsched, tsched, prompts, 16, uid0=100 * wave)
        got = lockstep(jsched, tsched, jeng, teng)
        assert all(len(v) == 16 for v in got.values())
        assert tsched._spec_drafted_cum > 0
    assert hits["port"] == hits["jax"]
    assert all(hits["port"][100 + i] == 2 * PAGE for i in range(3))
    assert teng.state_manager.kv_cache.allocator.parked_pages > 0
    teng.state_manager.check_invariants()


def test_sliding_window_model():
    """Window eviction runs inside the variable-advance commit."""
    jeng, teng = _engines(window=32, **SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _loopy(2), 48)
    got = lockstep(jsched, tsched, jeng, teng)
    assert all(len(v) == 48 for v in got.values())
    assert tsched._spec_accepted_cum > 0


def test_zero_accept_adversarial_drafter():
    """Garbage drafts: one token a verify (plus the backoff), every
    request completes with the spec-off tokens."""
    prompts = _loopy(2)
    ref, _ = _serve_jax_greedy(prompts, 12)
    assert all(127 not in v for v in ref.values())
    jeng, teng = _engines(**SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)

    def bad(uid, prompt, gen, cap):
        return np.full(cap, 127, np.int32)

    jsched._drafter.propose = tsched._drafter.propose = bad
    _submit(jsched, tsched, prompts, 12)
    got = lockstep(jsched, tsched, jeng, teng)
    assert got == ref
    assert tsched._spec_drafted_cum > 0 and tsched._spec_accepted_cum == 0


@pytest.mark.parametrize("new", [5, 6, 7])
def test_max_new_tokens_never_overshot(new):
    jeng, teng = _engines(**SPEC)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _loopy(3), new)
    got = lockstep(jsched, tsched, jeng, teng)
    assert all(len(v) == new for v in got.values())


# ---------------------------------------------------------------------------
# strict shapes
# ---------------------------------------------------------------------------

def _strict_engine(spec):
    _, _, tcfg, tparams = _weights()
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, page_size=PAGE, num_pages=64,
            dtype=torch.float32), device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(
                max_tracked_sequences=2, max_ragged_sequence_count=2,
                max_ragged_batch_size=64),
            serving=T.ServingOptimizationConfig(speculative=spec,
                                                prefix_caching=False)))
    keys = teng.precompile(max_prompt=8, max_new_tokens=24, strict=True,
                           sampling=True)
    return teng, keys


def test_strict_shapes_with_spec_buckets():
    """The precompiled lattice covers speculation: the traffic serves
    with spec dispatches and never leaves the lattice (a key outside it
    would raise), with the tokens of the JAX scheduler."""
    teng, keys = _strict_engine(spec=True)
    assert keys == jengine.lattice_keys(
        max_prompt=8, max_new_tokens=24, max_concurrency=2, page_size=PAGE,
        max_ragged_batch_size=64, has_fresh=True, sampling=True,
        spec_max_draft=3)
    assert any(len(k) > 4 and k[4] == "spec" for k in keys)
    prompts = [[7] * 8, [9] * 5]
    jeng, _ = _engines(sm=dict(max_tracked_sequences=2,
                               max_ragged_sequence_count=2,
                               max_ragged_batch_size=64), **SPEC)
    jsched = J.FastGenScheduler(jeng)
    tsched = T.FastGenScheduler(teng)
    _submit(jsched, tsched, prompts, 20)
    want = {u: [int(t) for t in v]
            for u, v in jsched.run_to_completion().items()}
    assert tsched.run_to_completion() == want
    assert tsched._spec_drafted_cum > 0
    assert set(teng.compiled_keys()) <= set(keys)


def test_strict_shapes_without_spec_buckets_latches_off():
    teng, keys = _strict_engine(spec=False)
    assert not any(len(k) > 4 and k[4] == "spec" for k in keys)
    tsched = T.FastGenScheduler(teng, serving=T.ServingOptimizationConfig(
        speculative=True, prefix_caching=False))
    tsched.submit(0, [7] * 8, T.SamplingParams(max_new_tokens=20))
    with pytest.warns(UserWarning, match="speculation is off"):
        out = tsched.run_to_completion()
    assert len(out[0]) == 20
    assert tsched._warned_strict_spec and tsched._spec_drafted_cum == 0


# ---------------------------------------------------------------------------
# the port on its own: greedy parity and the sampled rows
# ---------------------------------------------------------------------------

def test_spec_greedy_equals_spec_off_and_split_in_the_port():
    rng = np.random.default_rng(0)
    prompts = _loopy(2) + [rng.integers(0, 128, n).tolist()
                           for n in (19, 7)]
    got, sched = _serve_port(prompts, 40, SPEC)
    off, _ = _serve_port(prompts, 40, OFF)
    split, ssched = _serve_port(prompts, 40, SPLIT | dict(speculative=True))
    assert got == off == split
    assert sched._spec_accepted_cum > 0
    assert ssched._spec_drafted_cum == 0       # the split step never drafts


def test_sampled_rows_full_length_and_seed_deterministic():
    sp = T.SamplingParams(max_new_tokens=10, temperature=0.9, top_k=8)
    prompts = _loopy(2)
    a, s1 = _serve_port(prompts, 10, SPEC, seed=11, params=[sp, sp])
    b, _ = _serve_port(prompts, 10, SPEC, seed=11, params=[sp, sp])
    c, _ = _serve_port(prompts, 10, SPEC, seed=12, params=[sp, sp])
    assert a == b
    assert all(len(v) == 10 for v in a.values())
    assert a != c or s1._spec_drafted_cum == 0


def test_greedy_rows_in_a_stochastic_batch_stay_greedy():
    params = [T.SamplingParams(max_new_tokens=10),
              T.SamplingParams(max_new_tokens=10, temperature=1.0, top_k=8)]
    got, sched = _serve_port(_loopy(2), 10, SPEC, seed=13, params=params)
    ref, _ = _serve_port(_loopy(1), 10, SPEC, seed=13, params=params[:1])
    assert got[0] == ref[0]
    assert any(len(k) > 4 and k[4] == "spec" and k[5] is False
               for k in sched._engine.compiled_keys())
