"""The split escape hatch in the port, held against the JAX package.

With ``fused_step=False`` (one logits forward per Q bucket) or
``on_device_sampling=False`` (one superbucket forward), the step returns
its [n, V] logits and they are sampled outside it, one call per group
of rows that share (temperature, top_k, top_p), on the logits' device.
Both schedulers serve the same greedy requests on the debug llama in
fp32 over the same weights: the same ``{uid: token}`` at every step and
the same dispatched step keys (JAX ``compiled_keys()``).  Under strict
shapes a step whose fused key was not precompiled serves split in both
packages (JAX ``tests/test_fused_serving.py`` ``TestSamplingLattice``).
Sampled draws come from another generator than ``jax.random``, so
``sample`` is held to the JAX ``sample``'s filtered logits (exact
support) and to its distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import sampling as jsampling
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import sampling as tsampling
from deepspeed_tpu_torch.inference.v2 import scheduler as tscheduler
from deepspeed_tpu_torch.models.llama import llama_config

PAGE, PAGES, BUDGET = 16, 96, 64
PROMPT_LENS = [3, 61, 30, 150, 20, 9]
NEW_TOKENS = [8, 24, 12, 16, 10, 20]
SPLIT_FLAGS = [dict(fused_step=False), dict(on_device_sampling=False)]


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


def _engines(weights, num_pages=PAGES, max_batch=BUDGET, max_seqs=8,
             **serving):
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


def _prompts(lens=PROMPT_LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, n) for n in lens]


def lockstep(jsched, tsched):
    tokens, step = {}, 0
    while jsched.has_work or tsched.has_work:
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}, step
        assert tsched.last_step_scheduled == jsched.last_step_scheduled, step
        for u, t in tout.items():
            tokens.setdefault(u, []).append(t)
        step += 1
        assert step < 500
    return tokens


def _serve_both(jeng, teng, prompts, new, **sp):
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    for uid, (p, n) in enumerate(zip(prompts, new)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n, **sp))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=n, **sp))
    return jsched, tsched, lockstep(jsched, tsched)


# ---------------------------------------------------------------------------
# the split step against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", SPLIT_FLAGS, ids=["fused_step=False",
                                                    "on_device_sampling=False"])
def test_split_greedy_tokens_and_keys_match_jax(weights, flags):
    jeng, teng = _engines(weights, **flags)
    jsched, tsched, tokens = _serve_both(jeng, teng, _prompts(), NEW_TOKENS)
    assert not tsched._fused and not tsched._async
    assert all(len(tokens[u]) == n for u, n in enumerate(NEW_TOKENS))
    keys = teng.compiled_keys()
    assert keys == jeng.compiled_keys()
    assert all(len(k) == 4 for k in keys)          # logits keys only
    if flags.get("fused_step") is False:
        # a mixed step runs one forward per Q bucket: decode keys beside
        # the prefill keys
        assert {k[1] for k in keys} >= {1, 64}
    teng.state_manager.check_invariants()


def test_scheduler_split_override_reaches_per_bucket_put(weights):
    """A ``serving=`` override on the scheduler takes the split path on
    an engine built fused (JAX test_fused_serving.py:263): a mixed step
    is two forwards, and its tokens reach the host in the same step."""
    _, teng = _engines(weights)
    sched = T.FastGenScheduler(teng, serving=T.ServingOptimizationConfig(
        fused_step=False, on_device_sampling=False, async_scheduling=False))
    rng = np.random.default_rng(0)
    sp = T.SamplingParams(max_new_tokens=4)
    sched.submit(0, rng.integers(0, 128, 20), sp)
    sched.step()
    sched.submit(1, rng.integers(0, 128, 9), sp)
    before = sum(teng.model.dispatch_counts.values())
    out = sched.step()
    assert sum(teng.model.dispatch_counts.values()) - before == 2
    assert set(out) == {0, 1}


@pytest.mark.parametrize("flags", SPLIT_FLAGS, ids=["fused_step=False",
                                                    "on_device_sampling=False"])
def test_split_samples_one_call_per_group(weights, flags, monkeypatch):
    """Rows sharing (temperature, top_k, top_p) are sampled by one call,
    greedy rows whatever their top_k / top_p in one: at top_k=1 a
    sampled row is the greedy token, so the tokens stay JAX's.  Each
    call samples the logits where the step left them, with the
    scheduler's own generator."""
    calls, gens = [], []
    real = tscheduler.sample

    def counted(logits, generator, **kw):
        calls.append((logits.shape[0], kw["temperature"], kw["top_k"]))
        gens.append((logits.device, generator))
        return real(logits, generator, **kw)

    monkeypatch.setattr(tscheduler, "sample", counted)
    jeng, teng = _engines(weights, **flags)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    params = [dict(), dict(temperature=0.0, top_k=5, top_p=0.5),
              dict(temperature=0.7, top_k=1), dict(temperature=1.3, top_k=1)]
    for uid, (p, kw) in enumerate(zip(_prompts([5, 7, 6, 9]), params)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=6, **kw))
        tsched.submit(uid, p, T.SamplingParams(max_new_tokens=6, **kw))
    lockstep(jsched, tsched)
    # every step that sampled all four rows: one greedy call of 2 rows,
    # one call each for the two stochastic groups
    full = [c for c in calls if c[1] == 0.0 and c[0] == 2]
    assert full
    temps = sorted({c[1] for c in calls})
    assert temps == [0.0, 0.7, 1.3]
    assert all(c[0] == 1 for c in calls if c[1] > 0.0)
    assert all(d == teng.model.device and g is tsched._generator
               for d, g in gens)


# ---------------------------------------------------------------------------
# strict shapes: the fallbacks (JAX test_fused_serving.py:509, :529)
# ---------------------------------------------------------------------------

def _strict(engines, slots_and_q, **lattice):
    """Capture, on both engines, the keys of the sampling lattice
    (``precompile(sampling=True)``'s) whose (S, Q) is in
    ``slots_and_q``, then make them strict.  JAX compiles each key ahead
    of time, so the tests take the part of the lattice their traffic
    can reach."""
    keys = [k for k in T.engine.lattice_keys(
        page_size=PAGE, has_fresh=True, sampling=True, **lattice)
        if tuple(k[:2]) in slots_and_q]
    for e in engines:
        assert e.precompile_keys(keys) == len(keys)
        e.model.strict_shapes = True
    return keys


def test_strict_mixed_step_serves_split_as_jax(weights):
    jeng, teng = _engines(weights, num_pages=64, max_batch=64, max_seqs=2)
    _strict((jeng, teng), {(1, 8), (1, 1), (2, 1)}, max_prompt=8,
            max_new_tokens=8, max_concurrency=2, max_ragged_batch_size=64)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (8, 5)]
    jsched.submit(0, prompts[0], J.SamplingParams(max_new_tokens=6))
    tsched.submit(0, prompts[0], T.SamplingParams(max_new_tokens=6))
    assert tsched.step() == {u: int(t) for u, t in jsched.step().items()}
    # a mid-decode arrival forms a mixed step, which no lattice holds
    jsched.submit(1, prompts[1], J.SamplingParams(max_new_tokens=6))
    tsched.submit(1, prompts[1], T.SamplingParams(max_new_tokens=6))
    lockstep(jsched, tsched)
    assert teng.compiled_keys() == jeng.compiled_keys()
    assert not any(k[4] == "mixed" for k in teng.compiled_keys()
                   if len(k) > 4)


def test_strict_superbucket_outside_the_lattice_serves_split(weights):
    """24 + 24 + 10 tokens fit the 64-token budget, but the fused
    superbucket (4, 32, ...) has S * Q = 128 > 64: the lattice skips it,
    so the step serves one forward per Q bucket."""
    jeng, teng = _engines(weights, num_pages=64, max_batch=64, max_seqs=4)
    keys = _strict((jeng, teng), {(2, 32), (1, 16), (4, 1)}, max_prompt=32,
                   max_new_tokens=8, max_concurrency=4,
                   max_ragged_batch_size=64)
    assert not any(k[:2] == (4, 32) for k in keys)
    _, _, tokens = _serve_both(jeng, teng, _prompts([24, 24, 10], seed=0),
                               [2] * 3)
    assert all(len(v) == 2 for v in tokens.values())
    assert teng.compiled_keys() == jeng.compiled_keys()


def test_strict_lattice_without_sampling_serves_split_for_life(weights):
    jeng, teng = _engines(weights, num_pages=64, max_batch=64, max_seqs=2)
    for e in (jeng, teng):
        e.precompile(max_prompt=8, max_new_tokens=8, strict=True)
    jsched, tsched = J.FastGenScheduler(jeng), T.FastGenScheduler(teng)
    with pytest.warns(UserWarning, match="split path"):
        assert not tsched._fused and not tsched._async
    assert not tsched._fused                    # latched, no second warning
    p = np.random.default_rng(0).integers(0, 128, 8)
    jsched.submit(0, p, J.SamplingParams(max_new_tokens=4))
    tsched.submit(0, p, T.SamplingParams(max_new_tokens=4))
    assert len(lockstep(jsched, tsched)[0]) == 4
    assert teng.compiled_keys() == jeng.compiled_keys()


# ---------------------------------------------------------------------------
# sample() against the JAX sample()
# ---------------------------------------------------------------------------

def _jax_filtered(logits, temperature, top_k, top_p):
    """The logits JAX's ``sample`` hands to its categorical draw."""
    seen = []

    def categorical(key, l, axis=-1):
        seen.append(np.asarray(l))
        return jnp.zeros(l.shape[0], jnp.int32)

    real = jax.random.categorical
    jax.random.categorical = categorical
    try:
        jsampling.sample.__wrapped__(
            jnp.asarray(logits), jax.random.key(0), temperature=temperature,
            top_k=top_k, top_p=top_p)
    finally:
        jax.random.categorical = real
    return seen[0]


CASES = [(0.7, 0, 1.0), (1.0, 5, 1.0), (0.8, 0, 0.9), (1.3, 12, 0.6),
         (0.5, 1, 1.0)]


@pytest.mark.parametrize("temperature,top_k,top_p", CASES)
def test_sample_filter_and_support_match_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    ref = _jax_filtered(logits, temperature, top_k, top_p)
    S = logits.shape[0]
    got, _, _ = tsampling._filter_rows(
        torch.from_numpy(logits), torch.full((S,), temperature),
        torch.full((S,), top_k, dtype=torch.int32), torch.full((S,), top_p))
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)],
                               rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    draws = np.stack([tsampling.sample(
        torch.from_numpy(logits), gen, temperature=temperature, top_k=top_k,
        top_p=top_p).numpy() for _ in range(400)])
    assert np.isfinite(ref[np.arange(S)[None, :], draws]).all()
    # each row's draw frequencies against the filtered softmax
    probs = torch.softmax(torch.from_numpy(got), -1).numpy()
    for r in range(S):
        freq = np.bincount(draws[:, r], minlength=64) / len(draws)
        assert np.abs(freq - probs[r]).max() < 0.1


def test_sample_at_temperature_zero_is_the_argmax():
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 32)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    out = tsampling.sample(logits, gen, temperature=0.0, top_k=3, top_p=0.2)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jsampling.sample(
            jnp.asarray(logits.numpy()), jax.random.key(0))))
    assert torch.equal(gen.get_state(), state)      # nothing drawn
