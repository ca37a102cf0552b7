"""KV pool sizing from free device memory, held against the JAX package.

A model built without ``kv_config`` takes its cache geometry from the
engine's ``kv_cache`` config, and ``num_pages=None`` sizes the pool as
``memory_fraction`` of the free device memory over the bytes a page
takes.  ``_free_device_memory`` is patched to the same byte count on
both engines (the CPU reports none): both build the same number of
pages, over fp and int8 pages, and then serve the same tokens from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax
from deepspeed_tpu_torch.inference import v2 as T
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


def _engines(weights, free, fraction=0.5, num_pages=None, quant="none",
             monkeypatch=None, default_dtype=False):
    """Both engines over models with no kv_config, each reading ``free``
    bytes of free device memory.  ``default_dtype`` leaves the pages'
    dtype at each package's default (else fp32 on both)."""
    jcfg, jparams, tcfg, tparams = weights
    for cls in (J.InferenceEngineV2, T.InferenceEngineV2):
        monkeypatch.setattr(cls, "_free_device_memory",
                            staticmethod(lambda *a: free))
    sm = dict(max_tracked_sequences=8, max_ragged_sequence_count=8,
              max_ragged_batch_size=64, memory_fraction=fraction)
    jeng = J.InferenceEngineV2(
        J.RaggedInferenceModel(jcfg, jparams),
        J.RaggedInferenceEngineConfig(
            state_manager=J.StateManagerConfig(**sm),
            kv_cache=J.KVCacheUserConfig(
                page_size=PAGE, num_pages=num_pages,
                **({} if default_dtype else dict(dtype=jnp.float32))),
            serving=J.ServingOptimizationConfig(kv_quantization=quant)))
    teng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, device="cpu"),
        T.RaggedInferenceEngineConfig(
            state_manager=T.StateManagerConfig(**sm),
            kv_cache=T.KVCacheUserConfig(
                page_size=PAGE, num_pages=num_pages,
                **({} if default_dtype else dict(dtype=torch.float32))),
            serving=T.ServingOptimizationConfig(kv_quantization=quant)))
    return jeng, teng


def _geometry(eng):
    kv = eng.model.kv_config
    return (kv.num_layers, kv.kv_heads, kv.head_dim, kv.page_size,
            kv.num_pages, kv.quantization, kv.bytes_per_page)


@pytest.mark.parametrize("default_dtype", [False, True],
                         ids=["fp32", "default_dtype"])
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("free,fraction", [(3_000_000, 0.5),
                                           (10_000_000, 0.8), (1, 0.8)])
def test_pool_sized_from_free_memory_as_jax(weights, monkeypatch, quant,
                                            free, fraction, default_dtype):
    """``default_dtype``: the pages' dtype left at each package's default
    gives an fp32 model bf16 pages in both, and so the same count."""
    jeng, teng = _engines(weights, free, fraction, quant=quant,
                          monkeypatch=monkeypatch, default_dtype=default_dtype)
    assert _geometry(teng) == _geometry(jeng)
    kv = teng.model.kv_config
    assert kv.dtype == (torch.bfloat16 if default_dtype else torch.float32)
    assert jeng.model.kv_config.dtype == (jnp.bfloat16 if default_dtype
                                          else jnp.float32)
    assert kv.num_pages == max(1, int(free * fraction) // kv.bytes_per_page)
    assert kv.num_pages * kv.bytes_per_page <= max(free * fraction,
                                                   kv.bytes_per_page)
    assert teng.free_blocks == jeng.free_blocks == kv.num_pages
    assert not teng.model.kv_config_explicit


def test_sized_pool_serves_jax_tokens(weights, monkeypatch):
    """A pool sized to 40 pages from 'free memory' serves the same
    greedy tokens as JAX's."""
    jeng, teng = _engines(weights, free=0, monkeypatch=monkeypatch)
    bpp = teng.model.kv_config.bytes_per_page
    jeng, teng = _engines(weights, free=80 * bpp, fraction=0.5,
                          monkeypatch=monkeypatch)
    assert teng.model.kv_config.num_pages == 40
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (50, 23, 70)]
    ref = J.generate(jeng, prompts, J.SamplingParams(max_new_tokens=6))
    out = T.generate(teng, prompts, T.SamplingParams(max_new_tokens=6))
    assert out == [list(map(int, r)) for r in ref]


def test_explicit_pages_and_the_cpu_keep_their_count(weights, monkeypatch):
    """``kv_cache.num_pages`` given: used as is.  No free-memory reading
    (the CPU): the model's default count, as in JAX."""
    jeng, teng = _engines(weights, free=10**9, num_pages=33,
                          monkeypatch=monkeypatch)
    assert _geometry(teng) == _geometry(jeng)
    assert teng.model.kv_config.num_pages == 33
    jeng, teng = _engines(weights, free=None, monkeypatch=monkeypatch)
    assert _geometry(teng) == _geometry(jeng)
    assert teng.model.kv_config.num_pages == 1024


def test_an_explicit_model_kv_config_is_not_resized(weights, monkeypatch):
    _, _, tcfg, tparams = weights
    monkeypatch.setattr(T.InferenceEngineV2, "_free_device_memory",
                        staticmethod(lambda *a: 10**9))
    kv = T.KVCacheConfig(num_layers=tcfg.num_layers, kv_heads=tcfg.kv_heads,
                         head_dim=tcfg.dims_per_head, page_size=PAGE,
                         num_pages=7, dtype=torch.float32)
    eng = T.InferenceEngineV2(
        T.RaggedInferenceModel(tcfg, tparams, kv_config=kv, device="cpu"))
    assert eng.model.kv_config == kv and eng.free_blocks == 7


def test_free_device_memory_is_none_on_the_cpu():
    assert T.InferenceEngineV2._free_device_memory(torch.device("cpu")) is None
