"""Deadlines, admission limits and structured errors in the port, held
against the JAX package.

Both schedulers serve the same requests on the debug llama in fp32 over
the same weights, with the clock of both scheduler modules patched to
one fake monotonic clock: a request's TTL expires while it is pending,
running or preempted (its host blob released), ``max_queue_depth`` and
the queue-wait SLO shed submits (the SLO as JAX runs it with telemetry
off: the oldest pending request's wait decides), ``close`` and
``reopen`` gate admission, a rejected duplicate uid never evicts the
live request, and ``errors`` keeps at most its bound.  The bar is the
same verdicts and the same tokens at every step.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.inference.v2 import scheduler as jscheduler
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.inference.v2 import scheduler as tscheduler
from deepspeed_tpu_torch.models.llama import llama_config

PAGE = 16


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


class Clock:
    """``time`` with a monotonic clock the test moves."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(jscheduler, "time", c)
    monkeypatch.setattr(tscheduler, "time", c)
    return c


def _engines(weights, num_pages=64, max_seqs=8, max_batch=128):
    jcfg, jparams, tcfg, tparams = weights
    sm = dict(max_tracked_sequences=16, max_ragged_sequence_count=max_seqs,
              max_ragged_batch_size=max_batch)
    geo = dict(num_layers=jcfg.num_layers, kv_heads=jcfg.kv_heads,
               head_dim=jcfg.dims_per_head, page_size=PAGE,
               num_pages=num_pages)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams, kv_config=J.KVCacheConfig(
            dtype=jnp.float32, **geo)),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=T.KVCacheConfig(
            dtype=torch.float32, **geo), device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm)))
    return jeng, teng


def _pair(weights, num_pages=64, **serving):
    """Schedulers of both packages over engines of the same geometry."""
    jeng, teng = _engines(weights, num_pages=num_pages)
    return (J.FastGenScheduler(jeng, serving=J.ServingOptimizationConfig(
                **serving)),
            T.FastGenScheduler(teng, serving=T.ServingOptimizationConfig(
                **serving)))


def _prompts(n, lo=6, hi=14, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 120, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _submit(scheds, uid, prompt, n, **kw):
    """Submit to (JAX, port); both verdicts must agree.  Returns the
    port's."""
    jsched, tsched = scheds
    jerr = jsched.submit(uid, prompt, J.SamplingParams(max_new_tokens=n),
                         **kw)
    terr = tsched.submit(uid, prompt, T.SamplingParams(max_new_tokens=n),
                         **kw)
    assert (terr is None) == (jerr is None)
    if terr is not None:
        assert (terr.uid, terr.code, terr.tokens) == (
            jerr.uid, jerr.code, jerr.tokens)
    return terr


def _verdicts(sched):
    return {u: (e.code, list(map(int, e.tokens)))
            for u, e in sched.errors.items()}


def _step_both(scheds, n=None, tokens=None):
    """Step both until done (or ``n`` steps): the same tokens and
    verdicts at every step.  Returns the port's tokens per uid, added to
    ``tokens`` when given."""
    jsched, tsched = scheds
    tokens, step = ({} if tokens is None else tokens), 0
    while (jsched.has_work or tsched.has_work) and (n is None or step < n):
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}, step
        assert _verdicts(tsched) == _verdicts(jsched), step
        assert tsched.backlog == jsched.backlog, step
        for u, t in tout.items():
            tokens.setdefault(u, []).append(t)
        step += 1
        assert step < 500
    return tokens


# ---------------------------------------------------------------------------
# deadlines (JAX test_chaos.py:411)
# ---------------------------------------------------------------------------

def test_ttl_expires_a_pending_request_as_jax(weights, clock):
    scheds = _pair(weights)
    prompts = _prompts(2, seed=1)
    _submit(scheds, 0, prompts[0], 4, ttl_s=0.5)
    _submit(scheds, 1, prompts[1], 4)
    clock.now += 1.0
    tokens = _step_both(scheds)
    tsched = scheds[1]
    assert tsched.errors[0].code == "expired"
    assert "deadline" in tsched.errors[0].message
    assert 0 not in tokens and len(tokens[1]) == 4 and 1 not in tsched.errors


def test_default_ttl_expires_a_running_request_with_its_tokens(weights,
                                                               clock):
    """``default_ttl_s`` from the config: a request past its deadline
    mid-decode ends with the tokens it had, under the async chain (its
    in-flight row is dropped at the drain)."""
    scheds = _pair(weights, default_ttl_s=2.0)
    for uid, p in enumerate(_prompts(3, seed=2)):
        _submit(scheds, uid, p, 12, ttl_s=(None if uid else 30.0))
    _step_both(scheds, n=5)
    clock.now += 3.0
    tokens = _step_both(scheds)
    tsched = scheds[1]
    assert {u: e.code for u, e in tsched.errors.items()} == {
        1: "expired", 2: "expired"}
    assert all(tsched.errors[u].tokens for u in (1, 2))
    assert len(scheds[1].errors[1].tokens) < 12
    assert 0 not in tsched.errors
    tsched._engine.state_manager.check_invariants()


def test_ttl_expires_a_preempted_request_and_releases_its_blob(weights,
                                                               clock):
    scheds = _pair(weights, num_pages=12)
    rng = np.random.default_rng(0)
    for uid, n in enumerate((100, 60, 40)):
        _submit(scheds, uid, rng.integers(0, 100, n), 24, ttl_s=60.0)
    jsched, tsched = scheds
    tokens = {}
    for _ in range(200):
        _step_both(scheds, n=1, tokens=tokens)
        if tsched._preempted:
            break
    assert set(tsched._preempted) == set(jsched._preempted) != set()
    victim = next(iter(tsched._preempted))
    state = tsched._engine.state_manager
    assert state.offloaded_blobs == 1
    for r in (jsched._preempted[victim], tsched._preempted[victim]):
        r.deadline = clock.now + 0.5
    clock.now += 1.0
    _step_both(scheds, tokens=tokens)
    assert tsched.errors[victim].code == "expired"
    assert state.offloaded_blobs == 0 and state.offloaded_blob_bytes == 0
    state.check_invariants()
    assert all(len(tokens[u]) == 24 for u in range(3) if u != victim)


# ---------------------------------------------------------------------------
# admission limits (JAX test_chaos.py:429, :462)
# ---------------------------------------------------------------------------

def test_bounded_queue_sheds_overflow_as_jax(weights):
    scheds = _pair(weights, max_queue_depth=2)
    for i, prompt in enumerate(_prompts(4, seed=2)):
        err = _submit(scheds, i, prompt, 3)
        assert (err is None) == (i < 2)
    tsched = scheds[1]
    assert sorted(tsched.errors) == [2, 3]
    assert all(tsched.errors[u].code == "shed" for u in (2, 3))
    assert "max_queue_depth" in tsched.errors[2].message
    tokens = _step_both(scheds)
    assert len(tokens[0]) == 3 and len(tokens[1]) == 3


def test_queue_wait_slo_sheds_a_stale_backlog_only(weights, clock):
    """Telemetry off, as JAX runs it: an empty queue never sheds, a fresh
    backlog is admitted, a backlog older than the SLO sheds."""
    scheds = _pair(weights, shed_queue_wait_ms=50.0)
    prompts = _prompts(3, seed=7)
    assert _submit(scheds, 0, prompts[0], 2) is None
    clock.now += 0.01
    assert _submit(scheds, 1, prompts[1], 2) is None
    clock.now += 1.0
    err = _submit(scheds, 2, prompts[2], 2)
    assert err.code == "shed" and "SLO" in err.message
    assert sorted(scheds[1].errors) == [2]
    tokens = _step_both(scheds)
    assert len(tokens[0]) == 2 and len(tokens[1]) == 2


# ---------------------------------------------------------------------------
# close / reopen, duplicates, the bound on errors
# ---------------------------------------------------------------------------

def test_close_and_reopen_gate_admission(weights):
    scheds = _pair(weights)
    prompts = _prompts(3, seed=4)
    _submit(scheds, 0, prompts[0], 5)
    tokens = _step_both(scheds, n=2)
    for s in scheds:
        s.close()
        assert s.closed
    err = _submit(scheds, 1, prompts[1], 5)
    assert err.code == "closing" and scheds[1].errors[1].code == "closing"
    assert scheds[1].backlog == 1               # the live request stays
    for s in scheds:
        s.reopen()
        assert not s.closed
    assert _submit(scheds, 2, prompts[2], 5) is None
    _step_both(scheds, tokens=tokens)
    assert len(tokens[0]) == 5 and len(tokens[2]) == 5 and 1 not in tokens


def test_rejected_duplicate_never_evicts_the_live_request(weights):
    scheds = _pair(weights, max_queue_depth=1)
    prompts = _prompts(2, seed=5)
    _submit(scheds, 0, prompts[0], 4)
    err = _submit(scheds, 0, prompts[1], 4)     # queue full, same uid
    assert err.code == "shed"
    for s in scheds:
        s.close()
    err = _submit(scheds, 0, prompts[1], 4)     # closed, same uid
    assert err.code == "closing"
    assert scheds[1].errors == {} and scheds[1].backlog == 1
    tokens = _step_both(scheds)
    assert len(tokens[0]) == 4 and scheds[1].errors == {}


def test_errors_keep_at_most_their_bound(weights, monkeypatch):
    monkeypatch.setattr(jscheduler, "_MAX_ERROR_RECORDS", 3)
    monkeypatch.setattr(tscheduler, "_MAX_ERROR_RECORDS", 3)
    scheds = _pair(weights)
    for s in scheds:
        s.close()
    for uid in range(7):
        _submit(scheds, uid, [1, 2, 3], 2)
    assert list(scheds[1].errors) == list(scheds[0].errors) == [4, 5, 6]


def test_generate_matches_jax(weights):
    jeng, teng = _engines(weights)
    prompts = [p.tolist() for p in _prompts(3, seed=9)]
    jp = [J.SamplingParams(max_new_tokens=n) for n in (3, 6, 4)]
    tp = [T.SamplingParams(max_new_tokens=n) for n in (3, 6, 4)]
    ref = J.generate(jeng, prompts, jp)
    out = T.generate(teng, prompts, tp)
    assert out == [list(map(int, r)) for r in ref]
    assert T.generate(teng, prompts[:1],
                      T.SamplingParams(max_new_tokens=2)) == [out[0][:2]]
    with pytest.raises(ValueError, match="params for"):
        T.generate(teng, prompts, tp[:2])
