"""The port's FastGen serving path held against the JAX package's.

Both schedulers serve the same requests on the ``debug`` llama in fp32
with the same weights (the JAX tree bridged through
``checkpoint/from_jax.py``) and the slice's serving knobs (fused step,
on-device sampling, synchronous, no prefix caching).  The bar for greedy
requests is identical tokens per uid.  Sampled draws come from different
generators (``jax.random`` vs ``torch.Generator``), so sampling is held
to the deterministic filter (exact) and to its support / distribution.
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
from deepspeed_tpu_torch.models.llama import llama_config

PAGE, PAGES, BUDGET = 16, 96, 64
# the first step fills the 64-token budget exactly with fresh prompts
# (3 + 61); the second admits new requests next to decodes, so the port
# runs fresh single-geometry, fresh-prefill mixed and paged mixed steps
PROMPT_LENS = [3, 61, 30, 150, 20, 9]
NEW_TOKENS = [8, 24, 12, 16, 10, 20]


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


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 128, n) for n in PROMPT_LENS]


def _jax_engine(cfg, params):
    kv = J.KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                         head_dim=cfg.dims_per_head, page_size=PAGE,
                         num_pages=PAGES, dtype=jnp.float32)
    econf = J.RaggedInferenceEngineConfig(
        state_manager=J.StateManagerConfig(
            max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=BUDGET),
        serving=J.ServingOptimizationConfig(
            fused_step=True, on_device_sampling=True,
            async_scheduling=False, prefix_caching=False))
    return J.InferenceEngineV2(
        J.RaggedInferenceModel(cfg, params, kv_config=kv), econf)


def _port_engine(cfg, params):
    kv = T.KVCacheConfig(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
                         head_dim=cfg.dims_per_head, page_size=PAGE,
                         num_pages=PAGES, dtype=torch.float32)
    econf = T.RaggedInferenceEngineConfig(
        state_manager=T.StateManagerConfig(
            max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=BUDGET))
    return T.InferenceEngineV2(
        T.RaggedInferenceModel(cfg, params, kv_config=kv, device="cpu"),
        econf)


def test_greedy_tokens_identical_to_jax_scheduler(weights):
    jcfg, jparams, tcfg, tparams = weights
    prompts = _prompts()
    jsched = J.FastGenScheduler(_jax_engine(jcfg, jparams))
    for uid, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        jsched.submit(uid, p, J.SamplingParams(max_new_tokens=n))
    ref = jsched.run_to_completion()

    engine = _port_engine(tcfg, tparams)
    model = engine.model
    steps = []                                  # (Q of each segment, fresh)
    mixed = []                                  # fresh_p of mixed steps
    step_impl, mixed_impl = model._step_impl, model._mixed_sample_step_impl

    def count_step(params, kv, tok, *a, fresh=False):
        steps.append((tok.shape[1], fresh))
        return step_impl(params, kv, tok, *a, fresh=fresh)

    def count_mixed(*a, fresh_p=False, **k):
        mixed.append(fresh_p)
        return mixed_impl(*a, fresh_p=fresh_p, **k)

    model._step_impl, model._mixed_sample_step_impl = count_step, count_mixed
    sched = T.FastGenScheduler(engine)
    for uid, (p, n) in enumerate(zip(prompts, NEW_TOKENS)):
        sched.submit(uid, p, T.SamplingParams(max_new_tokens=n))
    out = sched.run_to_completion()

    assert out == {uid: list(map(int, toks)) for uid, toks in ref.items()}
    assert all(len(out[u]) == n for u, n in enumerate(NEW_TOKENS))
    assert steps[0] == (64, True)                  # fresh prefill step
    assert True in mixed and False in mixed        # both mixed kinds
    engine.state_manager.check_invariants()
    assert engine.free_blocks == PAGES             # every page came back


def _filter_inputs():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 128)) * 3).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3, 0.8, 1.0], np.float32)
    top_ks = np.array([0, 0, 5, 40, 0, 1], np.int32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.5, 0.3, 0.95], np.float32)
    return logits, temps, top_ks, top_ps


def test_filter_rows_matches_jax_exactly():
    logits, temps, top_ks, top_ps = _filter_inputs()
    jl, jg, jgreedy = jsampling._filter_rows(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps))
    tl, tg, tgreedy = tsampling._filter_rows(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))


def test_sampled_tokens_follow_the_filtered_distribution():
    """Draws stay inside the top-k/top-p support, and their frequencies
    match both the filtered softmax and JAX's own sampler (total
    variation < 0.05 over 20000 draws per row)."""
    logits, temps, top_ks, top_ps = _filter_inputs()
    n = 20000
    rows = np.repeat(np.arange(1, 6), n)          # the stochastic rows
    args = (logits[rows], temps[rows], top_ks[rows], top_ps[rows])
    gen = torch.Generator().manual_seed(0)
    t = tsampling.sample_dynamic(
        torch.from_numpy(args[0]), gen, torch.from_numpy(args[1]),
        torch.from_numpy(args[2]), torch.from_numpy(args[3])).numpy()
    j = np.asarray(jsampling.sample_dynamic(
        jnp.asarray(args[0]), jax.random.key(0), jnp.asarray(args[1]),
        jnp.asarray(args[2]), jnp.asarray(args[3])))
    filt = tsampling._filter_rows(*(torch.from_numpy(a) for a in
                                    (logits, temps, top_ks, top_ps)))[0]
    for i, r in enumerate(range(1, 6)):
        probs = torch.softmax(filt[r], -1).numpy()
        tr = t[i * n:(i + 1) * n]
        jr = j[i * n:(i + 1) * n]
        assert np.all(np.isfinite(filt[r].numpy()[tr]))   # in the support
        ft = np.bincount(tr, minlength=128) / n
        fj = np.bincount(jr, minlength=128) / n
        assert 0.5 * np.abs(ft - probs).sum() < 0.05
        assert 0.5 * np.abs(ft - fj).sum() < 0.05


def test_sampled_requests_complete_in_vocab(weights):
    _, _, tcfg, tparams = weights
    sched = T.FastGenScheduler(_port_engine(tcfg, tparams), seed=3)
    prompts = _prompts()
    for uid in range(3):
        sched.submit(uid, prompts[uid], T.SamplingParams(
            max_new_tokens=12, temperature=0.8, top_p=0.9))
    out = sched.run_to_completion()
    for toks in out.values():
        assert len(toks) == 12 and all(0 <= t < 128 for t in toks)


def test_mixed_step_pads_tokens_to_the_slot_bucket(weights):
    """A two-segment step returns S_d + S_p tokens padded to the next
    power of two (JAX model.py:1117-1124), rows mapped in segment order."""
    _, _, tcfg, tparams = weights
    engine = _port_engine(tcfg, tparams)
    gen = torch.Generator().manual_seed(0)
    sp = [T.SamplingParams()] * 3
    engine.step_sample([0, 1, 2], [[5, 6, 7], [8, 9], [1, 2, 3, 4]], sp, gen)
    # decode rows for 0 and 1 (S_d = 2), a prefill chunk for 3 (S_p = 1)
    toks, rows = engine.step_sample([0, 3, 1], [[4], [9, 9, 9], [3]], sp,
                                    gen)
    assert toks.shape == (4,) and toks.dtype == torch.int32
    assert rows == [0, 2, 1]
    assert int(toks[3]) == 0                       # the pad row
