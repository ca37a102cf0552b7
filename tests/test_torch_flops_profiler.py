"""The port's flops profiler, held against the JAX package's on the CPU.

The JAX profiler reads XLA's cost analysis; the port counts dispatched
operators (``torch.utils.flop_counter``).  What both see exactly is the
model's matrix products: the port's count of one forward of the debug
llama (dense einsum attention, unscanned layers) equals ``2 M N K``
summed over the ``dot_general`` equations of JAX's jaxpr of the same
forward.  The flash operators carry their own formulas (4 B H D per
attended pair forward, twice that backward), and the engine's hook
counts one step at ``flops_profiler.profile_step`` without changing the
training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.profiling import flops_profiler as JP
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.ops.flash_attention import (attended_pairs,
                                                     flash_attention)
from deepspeed_tpu_torch.profiling import (FlopsProfiler, count_params,
                                           get_model_profile)
from test_torch_training import llama_config, token_batches


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _dot_general_flops(jaxpr) -> int:
    """2 M N K over every dot_general of a jaxpr, nested ones included."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            k = int(np.prod([lhs[d] for d in lc]))
            total += 2 * k * int(np.prod(eqn.outvars[0].aval.shape))
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                total += _dot_general_flops(getattr(sub, "jaxpr", sub))
    return total


def test_matmul_flops_and_params_match_the_jax_forward():
    kw = dict(dtype=jnp.float32, scan_layers=False, attention_impl="einsum",
              remat=False)
    jmodel = JLlama("debug", **kw)
    jparams = jmodel.init_params(jax.random.key(0))
    batch = token_batches(1, shape=(2, 32))[0]
    jaxpr = jax.make_jaxpr(lambda p: jmodel.loss(p, batch,
                                                 jax.random.key(1)))(jparams)
    want = _dot_general_flops(jaxpr.jaxpr)

    model = LlamaForCausalLM("debug", dtype=torch.float32, scan_layers=False,
                             attention_impl="einsum", remat=False)
    from flax.core import meta
    host = jax.tree.map(np.asarray, meta.unbox(jparams))
    params = from_jax(host, model.cfg, device="cpu")
    assert count_params(params) == JP.count_params(host)
    flops, macs, n = get_model_profile(
        lambda: model.loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}),
        params=params, print_profile=False)
    assert flops == want > 0 and macs == flops / 2
    assert n == JP.count_params(host)


@pytest.mark.parametrize("window", [None, 5])
def test_the_flash_operators_carry_their_formulas(window):
    q = torch.randn(2, 4, 12, 16, requires_grad=True)
    k = torch.randn(2, 2, 12, 16, requires_grad=True)
    prof = FlopsProfiler()
    prof.start_profile()
    flash_attention(q, k, k, True, None, window).sum().backward()
    prof.stop_profile()
    pairs = attended_pairs(12, 12, True, window)
    assert pairs == sum(min(i + 1, window or 12) for i in range(12))
    fwd = 4 * 2 * 4 * 16 * pairs
    assert prof.get_total_flops() == 3 * fwd
    ops = dict(prof.summary()["top_ops"])
    assert ops == {"deepspeed_tpu_torch.flash_fwd": fwd,
                   "deepspeed_tpu_torch.flash_bwd": 2 * fwd}


def test_the_engine_hook_profiles_one_step_and_changes_nothing(tmp_path):
    out = tmp_path / "profile.txt"
    cfg = llama_config(flops_profiler={"enabled": True, "profile_step": 1,
                                       "output_file": str(out)})
    model = LlamaForCausalLM("debug", dtype=torch.float32)
    params = model.init_params(0, device="cpu")
    te = dtt.initialize(model=model, config=cfg, model_parameters=params,
                        device="cpu")[0]
    ref = dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                         config=llama_config(), model_parameters=params,
                         device="cpu")[0]
    for batch in token_batches(3):
        assert te.train_batch(batch) == ref.train_batch(batch)
    assert all(torch.equal(a, b) for a, b in zip(te.masters, ref.masters))
    prof = te.flops_profile
    assert prof.get_total_params() == count_params(params)
    # the duration is the timer's mean step so far, as in JAX (0 before
    # its first counted step)
    assert prof.get_total_flops() > 0 and prof.get_total_duration() >= 0
    assert "Flops Profiler (step 1)" in out.read_text()
    assert te.flops_profiler_enabled() and \
        te.flops_profiler_profile_step() == 1
