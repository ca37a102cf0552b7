"""Keyed (schedule-invariant) sampling in the port, held against the JAX
package.

Keyed sampling draws every sampled token from ``fold_in(fold_in(key(seed),
uid), position)``, so the port's copy of ``jax.random`` (``threefry.py``)
must produce JAX's bits: the keys, the random bits and the uniforms are
held bit-equal to ``jax.random``'s, and the gumbel noise to within 2 ulp
of max(|g|, 1) (each ``log`` within 1 ulp of XLA's on the same input;
near g = 0 the outer log's input error sets the absolute error).  Seeds
0, 2^31 - 1 and 2^32 + 5, uids at and past 2^31 and negative after the
int32 cast, positions 0..4095.  ``sample_keyed`` then draws JAX's tokens
on the same logits with greedy, temperature, top-k and top-p rows mixed.

Served: both schedulers run the debug llama in fp32 over the same
weights with ``keyed_sampling=True`` and the same seed, stepped together
(the same ``{uid: token}`` at every step); the port alone then serves the
same requests with staggered submits, with speculation (the n-gram
drafter and the self-draft) and on the split step, and each must deliver
the JAX run's tokens: a keyed token does not depend on the batch, the
step kind or the drafter.
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
from deepspeed_tpu_torch.inference.v2 import threefry
from deepspeed_tpu_torch.models.llama import llama_config

PAGE, PAGES, BUDGET, SEED = 16, 96, 64, 7
KEYED = dict(keyed_sampling=True)
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the port's jax.random against jax.random
# ---------------------------------------------------------------------------

def _row_keys(seed):
    """(JAX row keys, port row keys) for uids past 2^31 and negative after
    the int32 cast (as the engines cast them) at positions 0..4095."""
    rng = np.random.default_rng(seed % 1000)
    uids = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, -1,
                            -2 ** 31], rng.integers(0, 2 ** 32, 9)])
    uids32 = uids.astype(np.int64).astype(np.int32)
    pos = np.concatenate([[0, 4095], rng.integers(0, 4096, len(uids) - 2)]
                         ).astype(np.int32)
    base = jax.random.key(seed)
    jkeys = jax.vmap(lambda u, p: jax.random.fold_in(
        jax.random.fold_in(base, u), p))(jnp.asarray(uids32),
                                         jnp.asarray(pos))
    tkeys = threefry.fold_in(threefry.fold_in(
        threefry.key_from_seed(seed), torch.from_numpy(uids32)),
        torch.from_numpy(pos))
    return jkeys, tkeys


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, 2 ** 32 + 5])
def test_threefry_keys_bits_and_uniforms_are_jax_bit_for_bit(seed):
    np.testing.assert_array_equal(
        threefry.key_from_seed(seed).numpy(),
        np.asarray(jax.random.key_data(jax.random.key(seed))))
    jkeys, tkeys = _row_keys(seed)
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jax.random.key_data(jkeys)))
    n = 4099                               # odd, past a power of two
    jbits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jkeys)
    np.testing.assert_array_equal(threefry.random_bits(tkeys, n).numpy(),
                                  np.asarray(jbits).astype(np.int64))
    for lo in (0.0, TINY):
        ju = jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=lo))(jkeys)
        np.testing.assert_array_equal(threefry.uniform(tkeys, n, lo).numpy(),
                                      np.asarray(ju))


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, 2 ** 32 + 5])
def test_gumbel_noise_within_two_ulp_of_jax(seed):
    jkeys, tkeys = _row_keys(seed)
    n = 32000
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jkeys))
    tg = threefry.gumbel(tkeys, n).numpy()
    spacing = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(jg - tg) / spacing).max() <= 2.0
    # each log alone: within 1 ulp of XLA's on the same input
    u = threefry.uniform(tkeys, n, TINY)
    inner = -torch.log(u)
    assert _ulps(inner.numpy(), np.asarray(-jnp.log(u.numpy()))).max() <= 1
    assert _ulps(tg, np.asarray(-jnp.log(inner.numpy()))).max() <= 1


def _near_ties(logits, temps, top_ks, top_ps, keys, rows):
    """For each row where the draws part: the gap between the two best
    perturbed scores (a tie within the noise's last-place error)."""
    l = tsampling._filter_rows(*(torch.from_numpy(a) for a in
                                 (logits, temps, top_ks, top_ps)))[0]
    scores = threefry.gumbel(keys, logits.shape[1]) + l
    top2 = torch.topk(scores, 2, dim=-1).values
    return {int(r): float(top2[r, 0] - top2[r, 1]) for r in rows}


def test_sample_keyed_draws_jax_tokens_on_the_same_logits():
    rng = np.random.default_rng(3)
    S, V = 64, 512
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    temps = np.tile(np.array([0.0, 0.7, 1.0, 1.3], np.float32), S // 4)
    top_ks = np.tile(np.array([0, 0, 5, 40], np.int32), S // 4)
    top_ps = np.tile(np.array([1.0, 0.9, 1.0, 0.5], np.float32), S // 4)
    uids = rng.integers(-2 ** 31, 2 ** 31, S).astype(np.int32)
    pos = rng.integers(0, 4096, S).astype(np.int32)
    base = jax.random.key(SEED)
    jtok = np.asarray(jsampling.sample_keyed(
        jnp.asarray(logits),
        jsampling.derive_row_keys(base, jnp.asarray(uids), jnp.asarray(pos)),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    keys = tsampling.derive_row_keys(threefry.key_from_seed(SEED),
                                     torch.from_numpy(uids),
                                     torch.from_numpy(pos))
    ttok = tsampling.sample_keyed(
        torch.from_numpy(logits), keys, torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps)).numpy()
    parted = np.flatnonzero(ttok != jtok)
    assert not len(parted), (
        f"keyed draws part from JAX's at rows {parted.tolist()}; gaps of "
        "the two best perturbed scores: "
        f"{_near_ties(logits, temps, top_ks, top_ps, keys, parted)}")
    assert len(set(ttok[temps > 0].tolist())) > S // 2   # really sampled


# ---------------------------------------------------------------------------
# served: the port's keyed scheduler against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    model_def = LlamaForCausalLM("debug", max_seq_len=256, dtype=jnp.float32)
    params = meta.unbox(model_def.init_params(jax.random.key(0)))
    tcfg = llama_config("debug", max_seq_len=256, dtype=torch.float32)
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return model_def.cfg, params, tcfg, tparams


def _engine(pkg, cfg, params, **serving):
    kv = dict(num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
              head_dim=cfg.dims_per_head, page_size=PAGE, num_pages=PAGES)
    econf = pkg.RaggedInferenceEngineConfig(
        state_manager=pkg.StateManagerConfig(
            max_tracked_sequences=8, max_ragged_sequence_count=8,
            max_ragged_batch_size=BUDGET),
        serving=pkg.ServingOptimizationConfig(**serving))
    if pkg is J:
        model = J.RaggedInferenceModel(cfg, params, kv_config=J.KVCacheConfig(
            dtype=jnp.float32, **kv))
    else:
        model = T.RaggedInferenceModel(cfg, params, kv_config=T.KVCacheConfig(
            dtype=torch.float32, **kv), device="cpu")
    return pkg.InferenceEngineV2(model, econf)


#: (prompt length, new tokens, temperature, top_k, top_p); uids 1 and 4
#: get a periodic prompt, so the n-gram drafter drafts
TRAFFIC = [(3, 8, 0.0, 0, 1.0), (40, 20, 0.8, 0, 1.0), (30, 12, 1.0, 20, 1.0),
           (70, 16, 0.7, 0, 0.9), (24, 18, 0.0, 0, 1.0), (9, 14, 1.2, 5, 0.95)]


def _requests(pkg):
    rng = np.random.default_rng(11)
    reqs = []
    for uid, (n, new, t, k, p) in enumerate(TRAFFIC):
        prompt = (np.tile(rng.integers(0, 128, 6), n // 6 + 1)[:n]
                  if uid in (1, 4) else rng.integers(0, 128, n))
        reqs.append((uid, prompt, pkg.SamplingParams(
            max_new_tokens=new, temperature=t, top_k=k, top_p=p)))
    return reqs


def _port_serve(tcfg, tparams, stagger=False, **serving):
    """The port's keyed tokens per uid; ``stagger`` submits one request
    every other step, last uid first, so each request is drawn in other
    batches, steps and slots than in the first run."""
    sched = T.FastGenScheduler(_engine(T, tcfg, tparams, **KEYED, **serving),
                               seed=SEED)
    queue = list(reversed(_requests(T))) if stagger else _requests(T)
    out, step = {}, 0
    while queue or sched.has_work:
        if queue and step % 2 == 0:
            for _ in range(1 if stagger else len(queue)):
                sched.submit(*queue.pop(0))
        sched.step(on_token=lambda u, t: out.setdefault(u, []).append(t))
        step += 1
    return out, sched


@pytest.fixture(scope="module")
def jax_keyed(weights):
    """The JAX scheduler and the port's stepped together under the
    default serving configuration with keyed sampling: the same
    {uid: token} at every step.  Returns the tokens per uid and the step
    kinds the port dispatched."""
    jcfg, jparams, tcfg, tparams = weights
    jsched = J.FastGenScheduler(_engine(J, jcfg, jparams, **KEYED),
                                rng=jax.random.key(SEED))
    teng = _engine(T, tcfg, tparams, **KEYED)
    tsched = T.FastGenScheduler(teng, seed=SEED)
    for j, t in zip(_requests(J), _requests(T)):
        jsched.submit(*j)
        tsched.submit(*t)
    tokens, steps = {}, 0
    while jsched.has_work or tsched.has_work:
        jout, tout = jsched.step(), tsched.step()
        assert tout == {u: int(t) for u, t in jout.items()}, steps
        for u, t in tout.items():
            tokens.setdefault(u, []).append(t)
        steps += 1
    kinds = {k[4] for k in teng.compiled_keys() if len(k) > 4}
    return tokens, kinds


def test_keyed_serving_matches_jax_at_every_step(jax_keyed):
    tokens, kinds = jax_keyed
    assert {"sample", "chain", "mixed"} <= kinds
    assert [len(tokens[u]) for u in range(len(TRAFFIC))] == [
        new for _, new, *_ in TRAFFIC]
    # the sampled requests really drew (a greedy run would be the same
    # for every seed): another seed gives other sampled tokens
    assert any(len(set(tokens[u])) > 3 for u in (1, 2, 3, 5))


def test_a_keyed_engine_draws_nothing_from_the_generator(weights):
    _, _, tcfg, tparams = weights
    eng = _engine(T, tcfg, tparams, **KEYED)
    sched = T.FastGenScheduler(eng, seed=SEED)
    state = sched._generator.get_state()
    for r in _requests(T)[:3]:
        sched.submit(*r)
    out = sched.run_to_completion()
    assert torch.equal(sched._generator.get_state(), state)
    assert eng.model.keyed_sampling and sched._keyed
    other = T.FastGenScheduler(_engine(T, tcfg, tparams, **KEYED), seed=8)
    for r in _requests(T)[:3]:
        other.submit(*r)
    assert other.run_to_completion()[1] != out[1]


def test_staggered_submits_draw_the_same_keyed_tokens(weights, jax_keyed):
    _, _, tcfg, tparams = weights
    out, _ = _port_serve(tcfg, tparams, stagger=True)
    assert out == jax_keyed[0]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculation_commits_the_keyed_tokens(weights, jax_keyed, drafter):
    """A committed block is the tokens drawn one step at a time: spec on
    delivers spec-off's keyed tokens, which are JAX's."""
    _, _, tcfg, tparams = weights
    out, sched = _port_serve(tcfg, tparams, speculative=True,
                             spec_drafter=drafter, prefix_caching=False)
    assert out == jax_keyed[0]
    assert sched._spec_steps > 0 and sched._spec_accepted_cum > 0
    if drafter == "model":
        assert sched._spec_draft_drafted_cum > 0


def test_split_step_draws_the_fused_keyed_tokens(weights, jax_keyed):
    _, _, tcfg, tparams = weights
    out, sched = _port_serve(tcfg, tparams, fused_step=False)
    assert out == jax_keyed[0]
    assert not any(len(k) > 4 for k in sched._engine.compiled_keys())
