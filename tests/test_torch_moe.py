"""The port's MoE layer (``deepspeed_tpu_torch/moe``) held against the
JAX package's on the CPU.

Gating: the same fp32 logits (seeded numpy) through JAX ``topk_gating``
and the port's give identical dispatch masks and expert counts, and
combine weights and the aux loss within 1e-6 (fp32 sums of the same
terms in another order), for k = 1 and 2, with tokens dropped at the
capacity and without, and through capacity bins.

The layer: ``moe_forward`` on the same params and tokens (JAX's
one-hot einsums against the port's scatter, batched products and
gather) within 1e-5 of max|ref| in fp32, and within 1e-2 of max|ref| in
bf16 (one bf16 ulp of the output at max|ref| ~ 1 is 7.8e-3; the two
packages round the expert products' sums in another order), with and
without the PR-MoE residual branch, over several groups.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.moe import gating as jgating
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe.capacity_bins import build_capacity_bins as jbins
from deepspeed_tpu_torch.moe import gating as tgating
from deepspeed_tpu_torch.moe import layer as tlayer
from deepspeed_tpu_torch.moe.capacity_bins import build_capacity_bins as tbins

GATE_TOL = 1e-6
FP32_TOL = 1e-5
BF16_TOL = 1e-2


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _logits(t=24, e=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(t, e)).astype(np.float32)


@pytest.mark.parametrize("bins", [False, True])
@pytest.mark.parametrize("drop_tokens", [True, False])
@pytest.mark.parametrize("k", [1, 2])
def test_topk_gating_matches_jax(k, drop_tokens, bins):
    logits = _logits()
    # capacity 0.5 drops tokens when drop_tokens is on
    kw = dict(k=k, capacity_factor=0.5, min_capacity=2,
              drop_tokens=drop_tokens,
              capacity_bins=[3, 5, 9] if bins else None)
    ref = jgating.topk_gating(jnp.asarray(logits), **kw)
    got = tgating.topk_gating(torch.from_numpy(logits), **kw)
    assert got.dispatch_mask.shape == ref.dispatch_mask.shape
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(ref.dispatch_mask))
    np.testing.assert_array_equal(got.exp_counts.numpy(),
                                  np.asarray(ref.exp_counts))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(ref.combine_weights), atol=GATE_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(got.l_aux), float(ref.l_aux),
                               atol=GATE_TOL, rtol=0)
    if drop_tokens:      # the case drops some choices
        assert int(got.dispatch_mask.sum()) < k * logits.shape[0]
    else:
        assert int(got.dispatch_mask.sum()) == k * logits.shape[0]


def test_gating_takes_leading_group_dims():
    """The port routes [G, T, E] at once where JAX vmaps per group."""
    logits = np.stack([_logits(seed=s) for s in range(3)])
    ref = jax.vmap(lambda lg: jgating.topk_gating(lg, k=2))(
        jnp.asarray(logits))
    got = tgating.topk_gating(torch.from_numpy(logits), k=2)
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(ref.dispatch_mask))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(ref.combine_weights), atol=GATE_TOL)
    np.testing.assert_allclose(got.l_aux.numpy(), np.asarray(ref.l_aux),
                               atol=GATE_TOL)


def test_capacity_and_bins_match_jax():
    for n, e, f, m, k in [(16, 8, 1.0, 4, 2), (3, 8, 1.0, 4, 1),
                          (1024, 8, 1.25, 4, 2), (7, 4, 2.0, 1, 2)]:
        assert tgating.compute_capacity(n, e, f, m, k) == \
            jgating.compute_capacity(n, e, f, m, k)
        assert tgating.compute_capacity(n, e, f, m, k, [4, 64]) == \
            jgating.compute_capacity(n, e, f, m, k, [4, 64])
    for nb in (1, 3, 6):
        jc = jlayer.MoEConfig(num_capacity_bins=nb)
        tc = tlayer.MoEConfig(num_capacity_bins=nb)
        for n in (1, 5, 100, 4096):
            assert tbins(tc, n) == jbins(jc, n)


def test_moe_config_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(tlayer.MoEConfig)] == \
        [f.name for f in dataclasses.fields(jlayer.MoEConfig)]
    assert dataclasses.asdict(tlayer.MoEConfig()) == \
        dataclasses.asdict(jlayer.MoEConfig())


def test_gate_noise_raises_naming_the_item():
    with pytest.raises(NotImplementedError, match="11h"):
        tgating.topk_gating(torch.zeros(4, 8), k=2,
                            noisy_gate_policy="RSample",
                            rng=torch.Generator())
    # without a generator the policy draws nothing, as in JAX
    tgating.topk_gating(torch.zeros(4, 8), k=2, noisy_gate_policy="Jitter")


def _params(cfg, hidden=32, ffn=48, seed=0):
    tree = jax.tree.map(np.asarray, meta.unbox(jlayer.init_moe_params(
        cfg, hidden, ffn, jax.random.key(seed))))
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_residual", [False, True])
def test_moe_forward_matches_jax(dtype, use_residual):
    cfg_kw = dict(num_experts=4, top_k=2, use_residual=use_residual,
                  drop_tokens=True, capacity_factor=1.0)
    jcfg, tcfg = jlayer.MoEConfig(**cfg_kw), tlayer.MoEConfig(**cfg_kw)
    tree = _params(jcfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 32)).astype(np.float32)     # G = 3 groups
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref, ref_aux = jlayer.moe_forward(
        jcfg, jax.tree.map(lambda a: jnp.asarray(a, jdt), tree),
        jnp.asarray(x, jdt), is_training=True)
    tparams = {k: torch.tensor(v).to(tdt) for k, v in tree.items()}
    got, aux = tlayer.moe_forward(tcfg, tparams, torch.from_numpy(x).to(tdt),
                                  is_training=True)
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == tdt and got.shape == x.shape
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    scale = np.abs(ref).max()
    assert np.abs(got.float().numpy() - ref).max() <= tol * scale
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5,
                               atol=1e-7)


def test_dropless_serving_layer_matches_jax_and_drops_nothing():
    """The serving wiring: drop_tokens off, eval capacity, 2-D input as
    one group, and a token's output is its top-2 experts' outputs under
    the renormalised gate (checked against an explicit loop)."""
    cfg_kw = dict(num_experts=4, top_k=2, drop_tokens=False)
    jcfg, tcfg = jlayer.MoEConfig(**cfg_kw), tlayer.MoEConfig(**cfg_kw)
    tree = _params(jcfg, seed=3)
    x = np.random.default_rng(2).normal(size=(20, 32)).astype(np.float32)
    ref, _ = jlayer.moe_forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x), is_training=False)
    tp = {k: torch.tensor(v) for k, v in tree.items()}
    got, _ = tlayer.moe_forward(tcfg, tp, torch.from_numpy(x),
                                is_training=False)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= FP32_TOL * np.abs(ref).max()
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ tp["gate"], -1)
    w, idx = probs.topk(2, -1)
    w = w / w.sum(-1, keepdim=True)
    loop = torch.zeros_like(xt)
    for t in range(x.shape[0]):
        for j in range(2):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(xt[t] @ tp["wg"][e]) * (
                xt[t] @ tp["wi"][e])
            loop[t] += w[t, j] * (h @ tp["wo"][e])
    assert torch.allclose(got, loop, atol=1e-5 * float(loop.abs().max()))


def test_moe_module_init_has_the_jax_leaves():
    for use_residual in (False, True):
        cfg_kw = dict(num_experts=3, use_residual=use_residual)
        jtree = _params(jlayer.MoEConfig(**cfg_kw), hidden=16, ffn=24)
        ttree = tlayer.MoE(16, 24, tlayer.MoEConfig(**cfg_kw)).init_params(
            seed=0, device="cpu")
        assert {k: tuple(v.shape) for k, v in ttree.items()} == \
            {k: v.shape for k, v in jtree.items()}


def test_route_logits_choose_the_experts_and_the_gate_weighs_them():
    """``route_logits`` (JAX's internal ``route_logits``, which its noise
    policies perturb) pick the experts; the weights stay the softmax of
    ``logits`` at those experts, renormalised."""
    logits = torch.from_numpy(_logits(t=16, e=6, seed=7))
    natural = tgating.topk_routing(logits, 2, drop_tokens=False)
    same = tgating.topk_routing(logits, 2, drop_tokens=False,
                                route_logits=logits.clone())
    for a, b in zip(natural, same):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    want = torch.stack([torch.randperm(6, generator=torch.Generator()
                                       .manual_seed(t))[:2]
                        for t in range(16)], dim=1)        # [2, T]
    rank = torch.zeros(16, 6)
    for i in range(2):
        rank.scatter_(-1, want[i][:, None], float(2 - i))
    forced = tgating.topk_routing(logits, 2, drop_tokens=False,
                                  route_logits=rank)
    assert torch.equal(forced.experts, want)
    gates = torch.softmax(logits, -1).gather(-1, want.T)   # [T, 2]
    np.testing.assert_allclose(forced.weights.T.numpy(),
                               (gates / gates.sum(-1, keepdim=True)).numpy(),
                               rtol=1e-6)
