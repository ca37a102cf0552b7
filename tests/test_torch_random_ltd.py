"""Random-LTD and progressive layer drop in the port, held against the
JAX package's ``runtime/data_pipeline/data_routing.py`` on the CPU.

The kept indices come from ``jax.random.uniform(key, (batch, seq))``:
the port draws through ``inference/v2/threefry.py`` over the 2-D
shape's flat index (JAX's partitionable iota counters), so a key gives
JAX's uniforms and indices exactly; gather, scatter and the Random-LTD
forward are then exact too (fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.runtime.data_pipeline import data_routing as J
from deepspeed_tpu_torch.inference.v2 import threefry
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.runtime.data_pipeline import data_routing as T
from test_torch_training import llama_config


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed,batch,seq,keep", [
    (0, 2, 64, 24), (7, 3, 130, 65), (2 ** 33 + 5, 1, 2048, 1024)])
def test_a_key_gives_jaxs_indices(seed, batch, seq, keep):
    """Also the counters: a 2-D shape's uniforms equal the flat draw's
    reshaped, as JAX's partitionable iota gives them."""
    jkey = jax.random.key(seed)
    tkey = threefry.key_from_seed(seed)
    ju = np.asarray(jax.random.uniform(jkey, (batch, seq)))
    tu = threefry.uniform(tkey.reshape(1, 2), batch * seq).reshape(batch,
                                                                   seq)
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(
        ju.reshape(-1), np.asarray(jax.random.uniform(jkey, (batch * seq,))))
    jk, jd = J.token_sort_indices(jkey, batch, seq, keep)
    tk, td = T.token_sort_indices(tkey, batch, seq, keep)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_gather_scatter_and_the_forward_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 8)).astype(np.float32)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    jkey, tkey = jax.random.key(3), threefry.key_from_seed(3)
    idx, _ = J.token_sort_indices(jkey, 2, 40, 16)
    tidx = torch.from_numpy(np.asarray(idx))
    sub = J.gather_tokens(jnp.asarray(x), idx)
    tsub = T.gather_tokens(torch.from_numpy(x), tidx)
    np.testing.assert_array_equal(tsub.numpy(), np.asarray(sub))
    full = J.scatter_tokens(jnp.asarray(x), sub * 2, idx)
    tfull = T.scatter_tokens(torch.from_numpy(x), tsub * 2, tidx)
    np.testing.assert_array_equal(tfull.numpy(), np.asarray(full))
    out = J.apply_random_ltd(lambda h: jnp.tanh(h @ jnp.asarray(w)),
                             jnp.asarray(x), 16, jkey)
    tout = T.apply_random_ltd(lambda h: torch.tanh(h @ torch.from_numpy(w)),
                              torch.from_numpy(x), 16, tkey)
    np.testing.assert_allclose(tout.numpy(), np.asarray(out), rtol=1e-6,
                               atol=1e-6)
    # keep >= seq runs the layer on every token
    np.testing.assert_array_equal(
        T.apply_random_ltd(lambda h: h + 1, torch.from_numpy(x), 40,
                           tkey).numpy(), x + 1)


def test_schedule_and_layer_drop_match_jax():
    cfg = {"min_value": 64, "max_value": 512,
           "schedule_config": {"total_steps": 100, "seq_per_step": 32}}
    js, ts = J.RandomLTDScheduler(cfg), T.RandomLTDScheduler(cfg)
    assert [ts.get_value(s) for s in range(0, 130, 7)] == \
        [js.get_value(s) for s in range(0, 130, 7)]
    jp, tp = J.ProgressiveLayerDrop(0.4, 0.01), T.ProgressiveLayerDrop(0.4,
                                                                     0.01)
    for step in (0, 10, 250):
        assert tp.update_state(step) == pytest.approx(jp.update_state(step))
        assert [tp.layer_keep_prob(i, 6) for i in range(6)] == \
            pytest.approx([jp.layer_keep_prob(i, 6) for i in range(6)])
    tp.load_state_dict(jp.state_dict())
    assert tp.get_theta() == jp.get_theta()


def test_the_engine_exposes_the_random_ltd_config():
    routing = {"random_ltd": {"enabled": True, "min_value": 16,
                              "max_value": 32}}
    te = dtt.initialize(model=LlamaForCausalLM("debug", dtype=torch.float32),
                        config=llama_config(data_efficiency={
                            "data_routing": routing}), device="cpu")[0]
    assert te.random_ltd_enabled()
    assert te.random_ltd_config() == routing["random_ltd"]
