"""Sparse embedding gradients (``runtime/sparse_tensor.py``) held against
the JAX package's on the CPU.

``SparseTensor``'s API on the same seeded inputs; the table gradient of
``embedding_lookup`` (duplicate ids included) against JAX's
``custom_vjp`` backward within 1e-5; and 3 training steps of the debug
llama (fp32) with ``sparse_gradients`` against the JAX engine: losses
within 1e-5 relative, the embedding's update as ``tests/test_torch_
training.py`` holds the masters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.runtime import sparse_tensor as jst
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime import sparse_tensor as tst
from test_torch_training import (PARAM_ATOL, assert_params_close, jax_engine,
                                 jax_params, llama_config, token_batches)

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _pair(idx, vals, shape):
    return (jst.SparseTensor(jnp.asarray(idx), jnp.asarray(vals), shape),
            tst.SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                             shape))


def test_the_sparse_tensor_api_equals_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 6, 9).astype(np.int32)
    idx[:3] = 3                                    # duplicates add
    vals = rng.standard_normal((9, 4)).astype(np.float32)
    j, t = _pair(idx, vals, (6, 4))
    np.testing.assert_allclose(t.to_dense().numpy(), np.asarray(j.to_dense()),
                               rtol=1e-6, atol=1e-6)
    assert t.sparse_size() == j.sparse_size() and repr(t) == repr(j)
    dense = rng.standard_normal((6, 4)).astype(np.float32)
    sel = np.asarray([0, 2, 2], np.int32)
    jd = jst.SparseTensor.from_dense(jnp.asarray(dense), jnp.asarray(sel))
    td = tst.SparseTensor.from_dense(torch.from_numpy(dense),
                                     torch.from_numpy(sel))
    jsum, tsum = jd.add(j), td.add(t)
    np.testing.assert_allclose(tsum.to_dense().numpy(),
                               np.asarray(jsum.to_dense()), rtol=1e-6,
                               atol=1e-6)
    assert tsum.dense_shape == jsum.dense_shape
    # one rank: the all-gather over the default group is the identity
    out = tst.sparse_allreduce(t)
    np.testing.assert_array_equal(out.to_dense().numpy(),
                                  t.to_dense().numpy())


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_the_embedding_gradient_equals_jax(table_dtype):
    """A [V, E] table, ids with duplicates (a quarter of the batch hits
    id 7): the sparse backward's gradient equals JAX's within 1e-5 (fp32)
    or one bf16 rounding of it, and the dense backward's in fp32."""
    V, E, B, S = 1000, 16, 2, 64
    rng = np.random.default_rng(1)
    table = rng.standard_normal((V, E)).astype(np.float32)
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    ids[:, ::4] = 7
    w = rng.standard_normal((E,)).astype(np.float32)
    jdt = jnp.dtype(table_dtype)
    jt = jnp.asarray(table).astype(jdt)
    jg = jax.grad(lambda t: jnp.sum(jst.embedding_lookup(t, jnp.asarray(ids))
                                    .astype(jnp.float32) @ w))(jt)
    tdt = getattr(torch, table_dtype)
    tt = torch.from_numpy(table).to(tdt).requires_grad_()
    out = tst.embedding_lookup(tt, torch.from_numpy(ids))
    (out.float() @ torch.from_numpy(w)).sum().backward()
    assert tt.grad.dtype == tdt
    got = tt.grad.float().numpy()
    ref = np.asarray(jg.astype(jnp.float32))
    if table_dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        dense = torch.from_numpy(table).requires_grad_()
        (dense[torch.from_numpy(ids).long()] @ torch.from_numpy(w)) \
            .sum().backward()
        np.testing.assert_allclose(got, dense.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)
    else:
        # both sum in fp32 and round once: equal or one bf16 ulp apart
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(got[7], ref[7], rtol=2 ** -7)


@pytest.fixture(scope="module")
def sparse_runs():
    """3 steps of the JAX engine and of the port's with
    ``sparse_gradients``, then 3 of the port's without it."""
    cfg = llama_config(sparse_gradients=True)
    je = jax_engine(JLlama("debug", dtype=jnp.float32), cfg)
    init = jax_params(je)
    batches = token_batches(3)
    out = {"jax": [je.train_batch(b) for b in batches],
           "jax_params": jax_params(je), "init": init}
    for sparse in (True, False):
        model = LlamaForCausalLM("debug", dtype=torch.float32)
        te, *_ = dtt.initialize(
            model=model, config=llama_config(sparse_gradients=sparse),
            model_parameters=from_jax(init, model.cfg, device="cpu"),
            device="cpu")
        assert te.module.cfg.sparse_gradients is sparse
        out[sparse] = ([te.train_batch(b) for b in batches],
                       to_numpy(te.params))
    return out


def test_three_sparse_steps_equal_the_jax_engine(sparse_runs):
    losses, params = sparse_runs[True]
    np.testing.assert_allclose(losses, sparse_runs["jax"], rtol=LOSS_RTOL)
    assert_params_close(params, sparse_runs["jax_params"])
    # the embedding's update itself, not only where it lands
    upd = params["embed"]["tokens"] - sparse_runs["init"]["embed"]["tokens"]
    ref = sparse_runs["jax_params"]["embed"]["tokens"] \
        - sparse_runs["init"]["embed"]["tokens"]
    np.testing.assert_allclose(upd, ref, rtol=0, atol=PARAM_ATOL)
    assert np.abs(ref).max() > 10 * PARAM_ATOL


def test_sparse_steps_equal_the_dense_path(sparse_runs):
    (ls, ps), (ld, pd) = sparse_runs[True], sparse_runs[False]
    np.testing.assert_allclose(ls, ld, rtol=LOSS_RTOL)
    assert_params_close(ps, pd)
