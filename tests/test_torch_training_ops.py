"""The port's training ops held against the JAX package's, in fp32 on the
CPU: the flash backward, AdamW and the LR schedules.

Seeded numpy inputs go through the JAX function (Pallas kernels in
interpret mode, as tests/test_ops.py runs them) and the port's plain
version.  Tolerances: flash gradients 2e-5 absolute and relative (fp32
softmax and S x S sums taken in another order; the JAX kernel tests
allow 5e-3), and in bf16 the kernel limits, rms 1e-2 and max 2.5e-2 of
the reference (both sides round P and dS to bf16); AdamW 1e-6 absolute, 1e-5 relative (the same fp32
expressions; sqrt and division may differ by an ulp); LR schedules
1e-7 (the same Python floats).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.ops.fused_optimizer import fused_adamw_flat as j_adamw
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import fused_optimizer as tfo
from deepspeed_tpu_torch.runtime import lr_schedules as tlr

jfa = importlib.import_module("deepspeed_tpu.ops.flash_attention")

FLASH_TOL = 2e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# flash backward
# ---------------------------------------------------------------------------

# (S, D, H, K, window, JAX block_q, block_k): tests/test_ops.py's causal
# case, its uneven S = 96, its sliding-window backward, and GQA (JAX
# repeats K and V, so its dK/dV sum over each kv head's query heads).
# S = 96 is not a multiple of the CUDA kernels' 64-row blocks.  The JAX
# backward kernels are right only when their blocks divide S: with the
# forward test's 64/32 its dK and dV differ from its own mha_reference
# gradient by up to 1.7 (ROADMAP Queue 3), so the case runs JAX at 32/32.
FLASH_CASES = {
    "causal": (128, 32, 1, 1, None, 64, 64),
    "uneven": (96, 32, 1, 1, None, 32, 32),
    "window24": (64, 32, 2, 2, 24, 32, 32),
    "gqa": (128, 32, 4, 2, None, 64, 64),
}


def _flash_inputs(s, d, h, kh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, h, s, d)).astype(np.float32)
    k = rng.standard_normal((2, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((2, kh, s, d)).astype(np.float32)
    do = rng.standard_normal((2, h, s, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_plain_matches_jax_kernel(case):
    s, d, h, kh, window, bq, bk = FLASH_CASES[case]
    q, k, v, do = _flash_inputs(s, d, h, kh)
    g = h // kh

    def jax_attn(q, k, v):
        k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
        return jfa._flash_attention(q, k, v, d ** -0.5, True, bq, bk, True,
                                    window)

    def jax_reference(q, k, v):
        k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
        return jfa.mha_reference(q, k, v, causal=True, window=window)

    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), causal=True, window=window)
    got = tfa.flash_bwd(_t(q), _t(k), _t(v), out, lse, _t(do), causal=True,
                        window=window)
    # the Pallas backward, and autodiff through mha_reference: what the
    # JAX training forward runs off the TPU
    for fn in (jax_attn, jax_reference):
        _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        ref = vjp(jnp.asarray(do))
        for name, a, b in zip("qkv", got, ref):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=FLASH_TOL, rtol=FLASH_TOL,
                                       err_msg=f"d{name} vs {fn.__name__}")


# (S, H, K, window) at D = 128 in bf16, JAX blocks of 64 (they divide
# S): causal, GQA and a sliding window
BF16_FLASH_CASES = {"causal": (128, 2, 2, None), "gqa": (128, 4, 2, None),
                    "window40": (128, 2, 2, 40)}
# the kernel limits (tests/test_torch_kernels.py, chip_smoke.py): rms and
# max error relative to the reference's; both sides round P and dS to
# bf16, at other places and in another summation order
BF16_RMS_REL_TOL = 1e-2
BF16_MAX_REL_TOL = 2.5e-2


@pytest.mark.parametrize("case", sorted(BF16_FLASH_CASES))
def test_flash_backward_plain_matches_jax_kernel_in_bf16(case):
    """The plain backward in bf16 (what the CPU path runs, and what the
    kernels are held to on the card) against the Pallas backward in bf16
    in interpret mode."""
    s, h, kh, window = BF16_FLASH_CASES[case]
    d, g = 128, h // kh
    arrays = _flash_inputs(s, d, h, kh, seed=2)

    def jax_attn(q, k, v):
        k, v = jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1)
        return jfa._flash_attention(q, k, v, d ** -0.5, True, 64, 64, True,
                                    window)

    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    _, vjp = jax.vjp(jax_attn, jq, jk, jv)
    ref = vjp(jdo)
    q, k, v, do = (_t(a).bfloat16() for a in arrays)
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    got = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    for name, a, b in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        a = a.float()
        b = torch.from_numpy(np.array(b.astype(jnp.float32)))
        diff = a - b
        rms_rel = float(diff.pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
        max_rel = float(diff.abs().max() / b.abs().max())
        print(f"d{name}: rms {rms_rel:.2e}, max {max_rel:.2e}")
        assert rms_rel <= BF16_RMS_REL_TOL and max_rel <= BF16_MAX_REL_TOL, \
            (name, rms_rel, max_rel)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_plain_matches_autograd(case):
    """The same formulas against torch autograd through the plain
    attention: GQA indexing and the band agree with the dense softmax."""
    s, d, h, kh, window, _, _ = FLASH_CASES[case]
    q, k, v, do = (_t(a) for a in _flash_inputs(s, d, h, kh, seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tfa.mha_reference(*leaves, causal=True, window=window).backward(do)
    out, lse = tfa.flash_fwd(q, k, v, causal=True, window=window)
    got = tfa.flash_bwd(q, k, v, out, lse, do, causal=True, window=window)
    for name, a, leaf in zip("qkv", got, leaves):
        torch.testing.assert_close(a, leaf.grad, atol=FLASH_TOL,
                                   rtol=FLASH_TOL, msg=f"d{name}")


@pytest.mark.parametrize("window", [None, 3])
def test_flash_attention_autograd_node_gradcheck(window):
    """``FlashAttention`` as an autograd node, in fp64, GQA (2 query
    heads on 1 kv head), against numerical differences."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 6, 4, generator=g, dtype=torch.float64)
    k = torch.randn(1, 1, 6, 4, generator=g, dtype=torch.float64)
    v = torch.randn(1, 1, 6, 4, generator=g, dtype=torch.float64)
    args = [x.requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.FlashAttention.apply(q, k, v, True, None, window),
        args)


def test_flash_attention_is_differentiable_and_counts_no_launch_on_cpu():
    q, k, v, do = (_t(a).requires_grad_() for a in _flash_inputs(16, 8, 2, 1))
    before = (tfa.KERNEL.launches, tfa.BWD_KERNEL.launches)
    tfa.flash_attention(q, k, v).backward(do.detach())
    assert all(x.grad is not None for x in (q, k, v))
    assert k.grad.shape == k.shape
    assert (tfa.KERNEL.launches, tfa.BWD_KERNEL.launches) == before


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

ADAM = dict(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, wd=0.01)


def _flat(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def test_adamw_reference_matches_jax_kernel_over_steps():
    """n = 3000 is not a multiple of the TPU kernel's 1024 lanes (its
    padding path); three steps exercise the bias corrections."""
    p, g = _flat()
    jp, jm, jv = jnp.asarray(p), jnp.zeros(3000), jnp.zeros(3000)
    tp, tm, tv = _t(p), torch.zeros(3000), torch.zeros(3000)
    for step in (1, 2, 3):
        gs = g * step
        jp, jm, jv = j_adamw(jp, jnp.asarray(gs), jm, jv, ADAM["lr"],
                             ADAM["b1"], ADAM["b2"], ADAM["eps"], ADAM["wd"],
                             float(step), interpret=True)
        tfo.fused_adamw_flat(tp, _t(gs), tm, tv, **ADAM, step=step)
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-5)


def test_fused_adamw_optimizer_matches_optax_adamw():
    p, _ = _flat(seed=1)
    params = {"a": p.reshape(60, 50), "b": p[:100]}
    rng = np.random.default_rng(2)
    grads = [{k: rng.standard_normal(x.shape).astype(np.float32)
              for k, x in params.items()} for _ in range(3)]
    tx = optax.adamw(ADAM["lr"], b1=ADAM["b1"], b2=ADAM["b2"],
                     eps=ADAM["eps"], weight_decay=ADAM["wd"])
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    tparams = {k: _t(x) for k, x in params.items()}
    opt = tfo.FusedAdamW(tparams.values(), lr=ADAM["lr"],
                         betas=(ADAM["b1"], ADAM["b2"]), eps=ADAM["eps"],
                         weight_decay=ADAM["wd"])
    for gr in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, gr), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, t in tparams.items():
            t.grad = _t(gr[k])
        opt.step()
    for k, t in tparams.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=1e-5)
    assert opt.state[tparams["a"]]["step"] == 3


def test_adamw_wrapper_rejects_step_zero_and_runs_no_kernel_on_cpu():
    p, g = (_t(a) for a in _flat(16))
    before = tfo.KERNEL.launches
    with pytest.raises(ValueError, match="1-based"):
        tfo.fused_adamw_flat(p, g, torch.zeros(16), torch.zeros(16), **ADAM,
                             step=0)
    tfo.fused_adamw_flat(p, g, torch.zeros(16), torch.zeros(16), **ADAM,
                         step=1)
    assert tfo.KERNEL.launches == before


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "LRRangeTest": dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=7,
                        lr_range_test_step_rate=2.0,
                        lr_range_test_staircase=True),
    "OneCycle": dict(cycle_min_lr=1e-5, cycle_max_lr=1e-3,
                     cycle_first_step_size=10, cycle_second_step_size=15,
                     decay_step_size=5, decay_lr_rate=0.5),
    "WarmupLR": dict(warmup_min_lr=0.0, warmup_num_steps=20),
    "WarmupDecayLR": dict(total_num_steps=40, warmup_min_lr=3e-5,
                          warmup_num_steps=10, warmup_type="linear"),
    "WarmupCosineLR": dict(total_num_steps=45, warmup_min_ratio=0.1,
                           warmup_num_steps=8, cos_min_ratio=0.01),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    ref = jlr.get_lr_schedule(name, SCHEDULES[name], 3e-4)
    got = tlr.get_lr_schedule(name, SCHEDULES[name], 3e-4)
    steps = range(51)
    np.testing.assert_allclose([got(s) for s in steps],
                               [ref(s) for s in steps], rtol=0, atol=1e-7)


def test_warmup_lr_applies_lr_zero_on_the_first_update():
    sched = tlr.get_lr_schedule("WarmupLR", {"warmup_min_lr": 0.0}, 1e-3)
    assert sched(0) == 0.0 and sched(1) > 0.0
    wrapper = tlr.LRScheduler(sched)
    wrapper.step()
    assert wrapper.get_last_lr() == [sched(1)]
    with pytest.raises(ValueError, match="unknown scheduler"):
        tlr.get_lr_schedule("Cyclic", {}, 1e-3)


# ---------------------------------------------------------------------------
# chip_smoke.py's full-width training limits, on a CPU stand-in
# ---------------------------------------------------------------------------

# chip_smoke.py holds the training path with the flash kernels against
# the plain einsum path: |delta loss| / loss <= 1e-3 and, per leaf,
# rms(grad delta) / rms(grad) <= 5e-2
LOSS_REL_TOL = 1e-3
GRAD_RMS_REL_TOL = 5e-2


def _bf16_loss_and_grads(model, params, ids):
    from deepspeed_tpu_torch.tree import tree_leaves, tree_map
    params_c = tree_map(
        lambda t: t.detach().to(torch.bfloat16).requires_grad_(), params)
    loss = model.loss(params_c, {"input_ids": ids})
    loss.backward()
    return float(loss.detach()), [c.grad.float()
                                  for c in tree_leaves(params_c)]


def _path_errors(a, b):
    (la, ga), (lb, gb) = a, b
    rms = [float((x - y).pow(2).mean().sqrt() / y.pow(2).mean().sqrt())
           for x, y in zip(ga, gb)]
    return abs(la - lb) / abs(lb), max(rms)


@pytest.mark.parametrize("layers,seq", [(2, 128), (8, 64)])
def test_training_parity_limits_pass_rounding_and_fail_an_extra_key(
        monkeypatch, layers, seq):
    """A bf16 llama's flash path (plain versions, which round like the
    kernels do, only at other places) against its einsum path: one
    micro-batch's loss and gradients pass the limits, while the einsum
    path with one key past the causal limit fails the gradient limit."""
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    model = LlamaForCausalLM("tiny", num_layers=layers)
    params = model.init_params(seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, seq)))
    flash = _bf16_loss_and_grads(model, params, ids)
    einsum_model = LlamaForCausalLM("tiny", num_layers=layers,
                                    attention_impl="einsum")
    einsum = _bf16_loss_and_grads(einsum_model, params, ids)
    loss_rel, grad_rms = _path_errors(flash, einsum)
    print(f"flash vs einsum: loss {loss_rel:.2e}, gradients {grad_rms:.2e}")
    assert loss_rel <= LOSS_REL_TOL and grad_rms <= GRAD_RMS_REL_TOL, \
        (loss_rel, grad_rms)

    dense = T.dot_product_attention

    def one_key_past_causal(cfg, q, k, v, mask):
        s = mask.shape[-1]
        return dense(cfg, q, k, v, mask | torch.ones(s, s).bool().triu(1)
                     .tril(1))
    monkeypatch.setattr(T, "dot_product_attention", one_key_past_causal)
    leaky = _bf16_loss_and_grads(einsum_model, params, ids)
    loss_rel, grad_rms = _path_errors(leaky, einsum)
    print(f"one key past causal: loss {loss_rel:.2e}, gradients "
          f"{grad_rms:.2e}")
    assert grad_rms > GRAD_RMS_REL_TOL, (loss_rel, grad_rms)
