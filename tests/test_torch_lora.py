"""``linear/optimized_linear.py`` held against the JAX package's on the
CPU.

The same seeded fp32 base weight goes into both packages' ``init``: the
int8 base's codes and scales equal JAX's (its Pallas quantise kernel in
interpret mode, as the JAX package's own tests run it); with the same
adapters (JAX's ``lora_a``, a seeded nonzero ``lora_b`` in both) the
forward equals JAX's within 1e-5 and the merged weight within 1e-6; the
trainable masks are JAX's; only the adapters get gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import linear as J
from deepspeed_tpu_torch import linear as T

IN, OUT, R = 96, 64, 8


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _lins(quant, bias=False, q_dtype="int8"):
    kw = dict(lora_config=None, quantization_config=None, bias=bias)
    jkw, tkw = dict(kw), dict(kw)
    jkw["lora_config"] = J.LoRAConfig(lora_r=R, lora_alpha=4.0)
    tkw["lora_config"] = T.LoRAConfig(lora_r=R, lora_alpha=4.0)
    if quant:
        jkw["quantization_config"] = J.QuantizationConfig(q_dtype=q_dtype)
        tkw["quantization_config"] = T.QuantizationConfig(q_dtype=q_dtype)
    return (J.OptimizedLinear(IN, OUT, dtype=jnp.float32, **jkw),
            T.OptimizedLinear(IN, OUT, dtype=torch.float32, **tkw))


def _params(quant, bias=False, q_dtype="int8"):
    jl, tl = _lins(quant, bias, q_dtype)
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.1, 0.1, (IN, OUT)).astype(np.float32)
    jp = jl.init(jax.random.key(0), base_weight=jnp.asarray(base))
    tp = tl.init(0, base_weight=torch.from_numpy(base), device="cpu")
    b = rng.standard_normal((R, OUT)).astype(np.float32) * 0.1
    jp = dict(jp, lora_b=jnp.asarray(b))
    with torch.no_grad():
        tp["lora_a"].copy_(torch.from_numpy(np.array(jp["lora_a"])))
        tp["lora_b"].copy_(torch.from_numpy(b))
        if bias:
            jp["bias"] = jnp.full((OUT,), 0.5, jnp.float32)
            tp["bias"].fill_(0.5)
    return jl, tl, jp, tp


@pytest.mark.parametrize("quant,bias", [(True, False), (False, True)])
def test_init_forward_merge_and_mask_equal_jax(quant, bias):
    jl, tl, jp, tp = _params(quant, bias)
    assert set(tp) == set(jp)
    for k in ("base_q", "base_scale", "base"):
        if k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # a fresh init: the adapter is a no-op (B = 0), A ~ N(0, 1/in)
    fresh = tl.init(1, base_weight=torch.zeros(IN, OUT), device="cpu")
    assert not fresh["lora_b"].any()
    assert 0.5 < float(fresh["lora_a"].detach().std() * np.sqrt(IN)) < 1.5
    x = np.random.default_rng(2).standard_normal((5, IN)).astype(np.float32)
    np.testing.assert_allclose(tl.apply(tp, torch.from_numpy(x)).detach()
                               .numpy(), np.asarray(jl.apply(jp, x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.merge(tp).detach().numpy(),
                               np.asarray(jl.merge(jp)), rtol=1e-6,
                               atol=1e-6)
    assert tl.trainable_mask(tp) == jl.trainable_mask(jp)


def test_fp8_base_equals_jax():
    jl, tl, jp, tp = _params(True, q_dtype="fp8_e4m3")
    assert tp["base_q"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tp["base_q"].float().numpy(),
                                  np.asarray(jp["base_q"], np.float32))
    x = np.random.default_rng(3).standard_normal((4, IN)).astype(np.float32)
    np.testing.assert_allclose(tl.apply(tp, torch.from_numpy(x)).detach()
                               .numpy(), np.asarray(jl.apply(jp, x)),
                               rtol=1e-5, atol=1e-5)


def test_only_the_adapters_get_gradients():
    jl, tl, jp, tp = _params(True, bias=True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, IN)).astype(np.float32))
    tl.apply(tp, x).square().sum().backward()
    for k, t in tp.items():
        assert (t.grad is not None) == (k in ("lora_a", "lora_b", "bias")), k
    # the adapters' gradients are JAX's (the base masked out there)
    train = {k: jp[k] for k in ("lora_a", "lora_b", "bias")}
    frozen = {k: v for k, v in jp.items() if k not in train}
    jg = jax.grad(lambda p: jnp.sum(
        jl.apply({**frozen, **p}, np.asarray(x)) ** 2))(train)
    for k in ("lora_a", "lora_b", "bias"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-5)


def test_the_tree_mask_and_the_rank_guard_equal_jax():
    tree = {"layers": [{"attn": {"lora_a": 0, "lora_b": 0, "base_q": 0}},
                       {"bias": 1, "w": 2}], "embed": 3}
    assert T.lora_trainable_mask(tree) == J.lora_trainable_mask(tree)
    for mod in (J, T):
        with pytest.raises(ValueError, match="lora_r"):
            mod.OptimizedLinear(8, 4, lora_config=mod.LoRAConfig(lora_r=5))
    assert T.QuantizationConfig(q_bits=6).resolved_dtype() == \
        J.QuantizationConfig(q_bits=6).resolved_dtype()
