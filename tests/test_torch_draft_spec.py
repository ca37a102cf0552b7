"""Model-drafted speculation ("model" and "auto" drafters) in the port,
held against the JAX package.

A draft trunk (the first ``spec_draft_layers`` target layers; 0 = all of
them, the self-draft) drafts inside the verify step over a KV pool of its
own.  On the debug llama in fp32 (page 16) over the same weights: the
draft_spec step's [S, 2+k] verdict and the target and draft pools it
writes equal JAX's (1e-5), as does the draft_fill catch-up; both
schedulers stepped together deliver the same tokens, the same
``on_token`` stream, the same cumulative drafted and accepted counts and
the same free pages at every step, over the cases of
``tests/test_model_draft_spec.py`` (greedy parity of "model" and "auto",
the fill before model drafting, "auto" switching on a dry spell, the
per-request backoff, strict shapes) and debug OPT over int8 pages.  The
draft pool is sized with the target's as JAX sizes it.  Last, a fault of
the reference that the port keeps: after an offload/restore cycle the
draft mark says the draft pool covers the sequence, though the restored
pages' draft KV was never moved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import engine as jengine
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.models import transformer as TT
from deepspeed_tpu_torch.models.llama import llama_config
from deepspeed_tpu_torch.ops.paged_attention import KVPages

PAGE, VOCAB = 16, 128
ECFG = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=256)
OFF = dict(prefix_caching=False)
MODEL = dict(speculative=True, prefix_caching=False, spec_drafter="model")
AUTO = dict(speculative=True, prefix_caching=False, spec_drafter="auto")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DS_KV_DEBUG", "1")


_TREES = {}


def _weights(family="llama"):
    """(JAX cfg, JAX params, port cfg, port params): the debug llama, or
    a debug OPT (LayerNorm, learned positions, biases)."""
    if family not in _TREES:
        if family == "llama":
            model_def = LlamaForCausalLM("debug", max_seq_len=256,
                                         dtype=jnp.float32)
            jcfg = model_def.cfg
            params = meta.unbox(model_def.init_params(jax.random.key(0)))
            tcfg = llama_config("debug", max_seq_len=256,
                                dtype=torch.float32)
        else:
            fields = dict(vocab_size=VOCAB, hidden_size=64,
                          intermediate_size=256, num_layers=2, num_heads=4,
                          max_seq_len=256, norm="layernorm", norm_eps=1e-5,
                          activation="relu", pos_emb="learned",
                          tie_embeddings=True, use_bias=True)
            jcfg = JT.TransformerConfig(dtype=jnp.float32, **fields)
            tcfg = TT.TransformerConfig(dtype=torch.float32, **fields)
            params = meta.unbox(JT.init_params(jcfg, jax.random.key(0)))
        tparams = from_jax(jax.tree.map(np.asarray, params), tcfg,
                           device="cpu")
        _TREES[family] = (jcfg, params, tcfg, tparams)
    return _TREES[family]


_JAX_MODELS = {}


def _jax_model(name, family="llama", pages=64, quant="none"):
    """One JAX model per name for the module: engine build sets the draft
    trunk on the model, so a draft configuration gets a model of its
    own, whose compiled steps carry over from engine to engine."""
    if name not in _JAX_MODELS:
        jcfg, jparams, _, _ = _weights(family)
        _JAX_MODELS[name] = J.RaggedInferenceModel(
            jcfg, jparams, kv_config=J.KVCacheConfig(
                num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
                head_dim=jcfg.dims_per_head, page_size=PAGE,
                num_pages=pages, dtype=jnp.float32, quantization=quant))
    return _JAX_MODELS[name]


def _engines(serving, family="llama", pages=64, sm=None, quant="none"):
    sm = dict(ECFG, **(sm or {}))
    _, _, tcfg, tparams = _weights(family)
    name = (family, pages, quant,
            serving.get("spec_drafter", "ngram")
            if serving.get("speculative") else "off",
            serving.get("spec_draft_layers", 0))
    jeng = J.InferenceEngineV2(
        _jax_model(name, family, pages, quant),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            serving=J.ServingOptimizationConfig(kv_quantization=quant,
                                                **serving)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, page_size=PAGE, num_pages=pages,
            dtype=torch.float32), device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(kv_quantization=quant,
                                                **serving)))
    return jeng, teng


def _submit(jsched, tsched, prompts, new, uid0=0):
    for i, p in enumerate(prompts):
        jsched.submit(uid0 + i, p, J.SamplingParams(max_new_tokens=new))
        tsched.submit(uid0 + i, p, T.SamplingParams(max_new_tokens=new))


def lockstep(jsched, tsched, jeng, teng, stagger=None, after=None,
             limit=400):
    """Step both schedulers together: after every step the same {uid:
    token}, rows scheduled, cumulative drafted / accepted counts (all
    drafters and the draft trunk's), free pages, draft lag per running
    request; equal ``on_token`` streams.  ``stagger`` = (prompts, new,
    k) submits one request every k steps; ``after(step)`` runs after
    each step.  Returns the port's tokens per uid."""
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
        assert (tsched._spec_drafted_cum, tsched._spec_accepted_cum,
                tsched._spec_draft_drafted_cum,
                tsched._spec_draft_accepted_cum) == (
            jsched._spec_drafted_cum, jsched._spec_accepted_cum,
            jsched._spec_draft_drafted_cum,
            jsched._spec_draft_accepted_cum), step
        assert teng.free_blocks == jeng.free_blocks, step
        assert {u: teng.draft_lag(u) for u in tsched._running} == {
            u: jeng.draft_lag(u) for u in jsched._running}, step
        assert {u: r.spec_drafter for u, r in tsched._running.items()} == {
            u: r.spec_drafter for u, r in jsched._running.items()}, step
        if after is not None:
            after(step)
        step += 1
        assert step < limit, "no progress"
    assert streams["port"] == streams["jax"]
    tokens = {}
    for u, t in streams["port"]:
        tokens.setdefault(u, []).append(t)
    return tokens


def _low_rep(n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, length).tolist() for _ in range(n)]


def _mixed_prompts():
    """A low-repetition prompt (the n-gram drafter is dry on it) and a
    loopy one."""
    return _low_rep(1, 19, 11) + [[7] * 12]


def _serve_port(prompts, new, serving, seed=0):
    _, teng = _engines(serving)
    sched = T.FastGenScheduler(teng, seed=seed)
    for i, p in enumerate(prompts):
        sched.submit(i, p, T.SamplingParams(max_new_tokens=new))
    return sched.run_to_completion(), sched


# ---------------------------------------------------------------------------
# the step bodies against JAX's
# ---------------------------------------------------------------------------

def _draft_pool(eng):
    pool = eng._draft_kv if isinstance(eng, J.InferenceEngineV2) \
        else eng.draft_kv
    return np.asarray(pool)


@pytest.mark.parametrize("layers", [0, 1])
def test_draft_fill_and_draft_spec_steps_equal_jax(layers):
    """Prefill three prompts, catch the draft pool up over them
    (draft_fill), then one draft_spec step whose rows may commit 3, 1
    and 0 drafts: the draft pools after the fill, the [S, 2+k] verdicts
    and both pools after the step equal JAX's."""
    jeng, teng = _engines(dict(MODEL, spec_draft_layers=layers))
    prompts = [[7] * 12, list(range(20, 45)), [3, 1, 4, 1, 5, 9, 2, 6]]
    uids = [0, 1, 2]
    toks = [np.asarray(p, np.int32) for p in prompts]
    jl = np.asarray(jeng.put(uids, toks))
    tl = teng.put(uids, toks).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert [teng.draft_lag(u) for u in uids] == \
        [jeng.draft_lag(u) for u in uids] == [len(p) for p in prompts]
    jeng.step_draft_fill(uids, toks)
    teng.step_draft_fill(uids, toks)
    assert [teng.draft_lag(u) for u in uids] == [0, 0, 0]
    assert _draft_pool(teng).shape == _draft_pool(jeng).shape == (
        layers or 2, 65, PAGE, 2, 2, 16)
    np.testing.assert_allclose(_draft_pool(teng)[:, 1:],
                               _draft_pool(jeng)[:, 1:], rtol=1e-5,
                               atol=1e-5)
    first = jl.argmax(-1)
    rows = [np.asarray([first[0], 0, 0, 0], np.int32),
            np.asarray([first[1], 0], np.int32),
            np.asarray([first[2]], np.int32)]
    jv = np.asarray(jeng.step_draft_spec(
        uids, rows, [J.SamplingParams()] * 3, jax.random.key(0), min_q=4))
    tv = teng.step_draft_spec(uids, rows, [T.SamplingParams()] * 3,
                              torch.Generator(), min_q=4).numpy()
    assert tv.dtype == np.int32 and tv.shape == jv.shape == (4, 5)
    assert tv[:3].tolist() == jv[:3].tolist()
    if layers == 0:
        # the self-draft drafts the target's own picks: every room fills
        assert tv[:3, 0].tolist() == [3, 1, 0]
    np.testing.assert_allclose(
        teng.state_manager.kv_cache.data.numpy()[:, 1:],
        np.asarray(jeng.state_manager.kv_cache.data)[:, 1:], rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(_draft_pool(teng)[:, 1:],
                               _draft_pool(jeng)[:, 1:], rtol=1e-5,
                               atol=1e-5)
    committed = [1 + int(a) for a in tv[:3, 0]]
    for eng in (jeng, teng):
        eng.commit_spec(uids, committed)
        eng.mark_draft_seen(uids)
    assert [teng.draft_lag(u) for u in uids] == [0, 0, 0]
    teng.state_manager.check_invariants()


# ---------------------------------------------------------------------------
# the scheduler, step by step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("serving", [MODEL, AUTO], ids=["model", "auto"])
def test_greedy_parity_step_by_step(serving):
    """Staggered arrivals put prefill chunks beside speculating steps;
    both drafter configurations deliver JAX's tokens at every step, and
    the spec-off tokens."""
    prompts = _mixed_prompts()
    want, _ = _serve_port(prompts, 24, OFF)
    jeng, teng = _engines(serving)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    got = lockstep(jsched, tsched, jeng, teng, stagger=(prompts, 24, 2))
    assert got == want
    assert tsched._spec_draft_drafted_cum > 0
    kinds = {k[4] for k in teng.compiled_keys() if len(k) > 4}
    assert {"draft_spec", "draft_fill"} <= kinds


def test_model_drafter_engages_on_low_repetition():
    """Where the n-gram drafter never drafts, the self-draft commits
    multi-token blocks (accept rate > 0.5)."""
    prompts = _low_rep(2, 17, 3)
    want, _ = _serve_port(prompts, 16, OFF)
    jeng, teng = _engines(MODEL)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, prompts, 16)
    got = lockstep(jsched, tsched, jeng, teng)
    assert got == want
    drafted = tsched._spec_draft_drafted_cum
    assert drafted > 0 and tsched._spec_draft_accepted_cum / drafted > 0.5
    assert tsched._spec_drafted_cum == drafted


def test_fill_precedes_model_drafting():
    """After the prefill the draft pool covers nothing; fill steps run
    the prompt through the draft trunk before the first draft_spec
    dispatch, after which the lag is 0."""
    jeng, teng = _engines(MODEL)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    filled = []
    fill = teng.step_draft_fill

    def counted(uids, toks):
        filled.append(sum(len(t) for t in toks))
        return fill(uids, toks)

    teng.step_draft_fill = counted
    _submit(jsched, tsched, _low_rep(1, 21, 9), 12)
    assert tsched.step() == {u: int(t) for u, t in jsched.step().items()}
    assert teng.draft_lag(0) == jeng.draft_lag(0) > 0

    def after(step):
        if tsched._spec_draft_drafted_cum:
            assert teng.draft_lag(0) == 0 or 0 not in tsched._running

    lockstep(jsched, tsched, jeng, teng, after=after)
    assert sum(filled) >= 21
    assert tsched._spec_draft_drafted_cum > 0


def test_auto_switches_ngram_to_model_on_a_dry_spell():
    jeng, teng = _engines(AUTO)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _low_rep(1, 19, 13), 40)
    seen = set()

    def after(step):
        seen.update(r.spec_drafter for r in tsched._running.values())

    lockstep(jsched, tsched, jeng, teng, after=after)
    assert "model" in seen
    assert tsched.spec_switches[("ngram", "model")] >= 1
    assert tsched._spec_draft_drafted_cum > 0


def test_auto_over_a_one_layer_draft_trunk():
    """A truncated trunk drafts worse than the target: the "auto" state
    machine moves requests between drafters, as JAX's does."""
    serving = dict(AUTO, spec_draft_layers=1)
    jeng, teng = _engines(serving)
    assert teng.draft_kv.shape[0] == jeng._draft_kv.shape[0] == 1
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    prompts = _mixed_prompts() + _low_rep(1, 30, 21)
    _submit(jsched, tsched, prompts, 32)
    got = lockstep(jsched, tsched, jeng, teng)
    want, _ = _serve_port(prompts, 32, OFF)
    assert got == want
    assert sum(tsched.spec_switches.values()) > 0


def test_backoff_is_per_request():
    """A dry request backs off while its neighbour keeps landing n-gram
    drafts (an engine with the draft trunk, a scheduler that drafts with
    n-grams only)."""
    jeng, teng = _engines(MODEL)
    ngram = dict(speculative=True, prefix_caching=False)
    jsched = J.FastGenScheduler(jeng, serving=J.ServingOptimizationConfig(
        **ngram))
    tsched = T.FastGenScheduler(teng, serving=T.ServingOptimizationConfig(
        **ngram))
    _submit(jsched, tsched, [[7] * 12] + _low_rep(1, 19, 17), 24)
    overlap = []

    def after(step):
        reqs = list(tsched._running.values())
        if len(reqs) == 2:
            a, b = reqs
            overlap.append((a.spec_dry >= 2 and b.spec_accepted_ngram > 0)
                           or (b.spec_dry >= 2
                               and a.spec_accepted_ngram > 0))

    lockstep(jsched, tsched, jeng, teng, after=after)
    assert any(overlap)
    assert tsched._spec_draft_drafted_cum == 0


def test_strict_shapes_cover_draft_spec_and_draft_fill():
    sm = dict(max_tracked_sequences=2, max_ragged_sequence_count=2,
              max_ragged_batch_size=64)
    _, _, tcfg, tparams = _weights()
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
            head_dim=tcfg.dims_per_head, page_size=PAGE, num_pages=64,
            dtype=torch.float32), device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            serving=T.ServingOptimizationConfig(**MODEL)))
    keys = teng.precompile(max_prompt=8, max_new_tokens=24, strict=True,
                           sampling=True)
    assert keys == jengine.lattice_keys(
        max_prompt=8, max_new_tokens=24, max_concurrency=2, page_size=PAGE,
        max_ragged_batch_size=64, has_fresh=True, sampling=True,
        spec_max_draft=3, draft=True)
    assert {"draft_spec", "draft_fill"} <= {k[4] for k in keys
                                            if len(k) > 4}
    prompts = [_low_rep(1, 8, 23)[0], [9] * 5]
    jeng, _ = _engines(MODEL, sm=sm)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, prompts, 20)
    want = {u: [int(t) for t in v]
            for u, v in jsched.run_to_completion().items()}
    assert tsched.run_to_completion() == want
    assert tsched._spec_draft_drafted_cum > 0
    assert set(teng.compiled_keys()) <= set(keys)


def test_debug_opt_over_int8_pages_step_by_step():
    """The target pool is int8 pages, the draft pool is not: the OPT
    family's self-draft serves JAX's tokens at every step."""
    jeng, teng = _engines(MODEL, family="opt", quant="int8")
    assert isinstance(teng.state_manager.kv_cache.data, KVPages)
    assert teng.draft_kv.dtype == torch.float32
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _low_rep(2, 20, 31) + [[5] * 9], 16)
    got = lockstep(jsched, tsched, jeng, teng)
    assert all(len(v) == 16 for v in got.values())
    assert tsched._spec_draft_drafted_cum > 0


def test_unknown_drafter_raises_at_engine_build():
    for pkg in (J, T):
        cfg = pkg.RaggedInferenceEngineConfig(
            serving=pkg.ServingOptimizationConfig(speculative=True,
                                                  spec_drafter="oracle"))
        jcfg, jparams, tcfg, tparams = _weights()
        model = (pkg.RaggedInferenceModel(jcfg, jparams) if pkg is J else
                 pkg.RaggedInferenceModel(tcfg, tparams, device="cpu"))
        with pytest.raises(ValueError, match="ngram"):
            pkg.InferenceEngineV2(model, cfg)


# ---------------------------------------------------------------------------
# the draft pool's size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [0, 1])
@pytest.mark.parametrize("free", [3_000_000, 40_000_000])
def test_draft_pool_sized_with_the_target_as_jax(free, layers,
                                                 monkeypatch):
    """No kv_config and ``num_pages=None``: the target's share of
    ``memory_fraction`` x free is L / (L + L_draft), both pools on the
    same pages."""
    jcfg, jparams, tcfg, tparams = _weights()
    for cls in (J.InferenceEngineV2, T.InferenceEngineV2):
        monkeypatch.setattr(cls, "_free_device_memory",
                            staticmethod(lambda *a: free))
    sm = dict(ECFG, memory_fraction=0.5)
    serving = dict(MODEL, spec_draft_layers=layers)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            kv_cache=J.KVCacheUserConfig(page_size=PAGE,
                                         dtype=jnp.float32),
            serving=J.ServingOptimizationConfig(**serving)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            kv_cache=T.KVCacheUserConfig(page_size=PAGE,
                                         dtype=torch.float32),
            serving=T.ServingOptimizationConfig(**serving)))
    kv = teng.model.kv_config
    assert kv.num_pages == jeng.model.kv_config.num_pages
    assert tuple(teng.draft_kv.shape) == tuple(jeng._draft_kv.shape)
    draft_bpp = teng.draft_kv[:, 0].numel() * 4
    assert kv.num_pages * (kv.bytes_per_page + draft_bpp) <= 0.5 * free
    # without the draft trunk the target takes the whole budget
    monkeypatch.setattr(T.InferenceEngineV2, "_free_device_memory",
                        staticmethod(lambda *a: free))
    alone = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            kv_cache=T.KVCacheUserConfig(page_size=PAGE,
                                         dtype=torch.float32)))
    assert alone.draft_kv is None
    assert alone.model.kv_config.num_pages > kv.num_pages


# ---------------------------------------------------------------------------
# a fault of the reference, kept by the port
# ---------------------------------------------------------------------------

def _kv_at(pool, pages, seen):
    """[L, seen, 2, K, D] KV rows of a sequence's first ``seen``
    positions."""
    pos = np.arange(seen)
    return np.asarray(pool)[:, np.asarray(pages)[pos // PAGE], pos % PAGE]


def test_draft_mark_survives_an_offload_restore_cycle_in_both_packages():
    """JAX ``InferenceEngineV2.offload_sequence`` / ``restore_sequence``
    leave the draft mark as it was, so after the cycle ``draft_lag``
    reads 0 though the sequence's pages are new and the draft pool holds
    nothing of it there.  Before the cycle the self-draft's pool equals
    the target's at every committed position (1e-4); after it the two
    differ, in both packages alike."""
    jeng, teng = _engines(MODEL)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    _submit(jsched, tsched, _low_rep(1, 40, 41), 40)
    while not (tsched._spec_draft_drafted_cum and teng.draft_lag(0) == 0):
        assert tsched.step() == {u: int(t) for u, t in jsched.step().items()}
    assert jsched._spec_draft_drafted_cum and jeng.draft_lag(0) == 0
    diffs = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        state = eng.state_manager
        sd = state.get_sequence(0)
        seen, old = sd.seen_tokens, list(sd.pages)
        target = eng.state_manager.kv_cache.data
        before = np.abs(_kv_at(_draft_pool(eng), old, seen)
                        - _kv_at(target, old, seen)).max()
        eng.offload_sequence(0)
        # another sequence takes the released pages, so the restore
        # lands elsewhere
        eng.put([99], [np.asarray(_low_rep(1, 3 * PAGE, 5)[0], np.int32)])
        eng.restore_sequence(0)
        new = list(state.get_sequence(0).pages)
        target = eng.state_manager.kv_cache.data
        after = np.abs(_kv_at(_draft_pool(eng), new, seen)
                       - _kv_at(target, new, seen)).max()
        diffs[name] = (before, after, eng.draft_lag(0), new != old)
    for name, (before, after, lag, moved) in diffs.items():
        assert moved and lag == 0, name
        assert before < 1e-4 < 1e-1 < after, (name, before, after)
    assert teng.state_manager.get_sequence(0).pages == \
        jeng.state_manager.get_sequence(0).pages
