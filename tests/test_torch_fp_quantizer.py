"""Weight-only quantisation of the port (``ops/fp_quantizer.py`` and
``RaggedInferenceModel.quantize_weights``) held against the JAX
package's on the CPU.

Every comparison here is bit for bit: codes (as the values they stand
for: the JAX package stores fp4 in a native 4-bit type where its JAX has
one, the port in ``float8_e4m3fn``), scales, dequantised values, the
blockwise round trip, and the quantised trees of a debug Mixtral.  The
dequantise kernel's plain version is JAX's expression, and the
wrapper's index arithmetic (what each element's scale is) is checked
against the broadcast on stand-in launches, since the kernel itself runs
only on the card (``tests/test_torch_kernels.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from deepspeed_tpu.inference import v2 as J
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JMixtral
from deepspeed_tpu.ops import fp_quantizer as jfq
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.inference import v2 as T
from deepspeed_tpu_torch.models.mixtral import mixtral_config
from deepspeed_tpu_torch.ops import fp_quantizer as tfq


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _values(a) -> np.ndarray:
    """Codes of either package as fp32 values."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _w(shape=(4, 6, 3, 32), seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    w[1] *= 40.0                      # one outlier slice
    return w


def test_the_formats_are_jax_s():
    assert tfq.SUPPORTED_FORMATS == jfq.SUPPORTED_FORMATS
    for fmt, (_, mag, bits) in jfq._FORMATS.items():
        assert tfq._FORMATS[fmt][1:] == (mag, bits)
        if fmt in jfq._SNAP_FORMATS or fmt == "fp4_e2m1":
            np.testing.assert_array_equal(tfq._fp6_grid(fmt),
                                          jfq._fp6_grid(fmt))
    assert tfq._BITS_TO_FORMAT == jfq._BITS_TO_FORMAT


#: formats both packages store in one dtype: (torch's, ml_dtypes' name)
SAME_STORAGE = {"fp8_e4m3": (torch.float8_e4m3fn, "float8_e4m3fn"),
                "fp8_e5m2": (torch.float8_e5m2, "float8_e5m2"),
                "int8": (torch.int8, "int8")}


@pytest.mark.parametrize("batch_dims", [0, 1, 2])
@pytest.mark.parametrize("fmt", jfq.SUPPORTED_FORMATS)
def test_quantize_channelwise_is_bit_equal_to_jax(fmt, batch_dims):
    w = _w()
    ref = jfq.quantize_channelwise(jnp.asarray(w), fmt, batch_dims)
    got = tfq.quantize_channelwise(torch.from_numpy(w), fmt, batch_dims)
    assert got["q"].shape == ref["q"].shape
    assert got["scale"].shape == ref["scale"].shape
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    np.testing.assert_array_equal(_values(got["q"]), _values(ref["q"]))
    if fmt in SAME_STORAGE:                           # the same bits too
        tdt, name = SAME_STORAGE[fmt]
        assert got["q"].dtype == tdt
        assert np.asarray(ref["q"]).dtype.name == name
        np.testing.assert_array_equal(
            got["q"].view(torch.uint8).numpy(),
            np.asarray(ref["q"]).view(np.uint8))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        back = tfq.dequantize_channelwise(got, dt)
        jback = jfq.dequantize_channelwise(ref, jdt)
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jback.astype(jnp.float32)))


def test_snaps_round_ties_as_jax_does():
    """fp4 ties go to even (the JAX package's native 4-bit conversion),
    fp6 ties to the smaller magnitude (its ``_snap_to_grid``), and both
    saturate at the grid's top."""
    scale = np.float32(1.0)
    for fmt, vals in (("fp4_e2m1", [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0,
                                    -0.75, 6.2, 7.0]),
                      ("fp6_e3m2", [0.3125, 0.4375, 3.5, 5.5, 29.0, -13.0]),
                      ("fp6_e2m3", [0.0625, 1.0625, 7.75, -3.875])):
        y = np.asarray(vals, np.float32) / scale
        got = tfq._encode(torch.from_numpy(y), fmt).float().numpy()
        if fmt == "fp4_e2m1" and "fp4_e2m1" not in jfq._SNAP_FORMATS:
            ref = _values(jnp.asarray(y).astype(jfq._FORMATS[fmt][0]))
        else:
            ref = np.asarray(jfq._snap_to_grid(jnp.asarray(y),
                                               jfq._fp6_grid_cached(fmt)))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2", "fp6_e3m2",
                                 "fp6_e2m3", "fp4_e2m1"])
def test_blockwise_quantize_and_dequantize_match_jax(fmt):
    x = _w((7, 45), seed=1)                         # 315: a padded tail
    q, s, pad = tfq.quantize(torch.from_numpy(x), group_size=64, fmt=fmt)
    jq, js, jpad = jfq.quantize(jnp.asarray(x), group_size=64, fmt=fmt)
    assert pad == jpad == 5 and q.shape == jq.shape == (5, 64)
    np.testing.assert_array_equal(_values(q), _values(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tfq.dequantize(q, s, pad, x.shape, dt)
        ref = jfq.dequantize(jq, js, jpad, x.shape, jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    rows = np.array([4, 0, 2])
    np.testing.assert_array_equal(
        tfq.selective_dequantize(q, s, torch.from_numpy(rows),
                                 torch.float32).numpy(),
        np.asarray(jfq.selective_dequantize(jq, js, jnp.asarray(rows),
                                            jnp.float32)))


def test_q_bits_object_api_and_straight_through_match_jax():
    x = _w((3, 200), seed=2)
    for bits in (8, 6, 4):
        got = tfq.quantize_dequantize(torch.from_numpy(x), 128, q_bits=bits)
        ref = jfq.quantize_dequantize(jnp.asarray(x), 128, q_bits=bits)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    tq_, jq_ = tfq.FP_Quantize(128), jfq.FP_Quantize(128)
    packed = tq_.quantize(torch.from_numpy(x))
    assert isinstance(packed, tfq.QuantizedTensor) and packed.pad == 40
    np.testing.assert_array_equal(
        tq_.dequantize(packed).numpy(),
        np.asarray(jq_.dequantize(jq_.quantize(jnp.asarray(x)))))
    q, s = tq_.quantize(torch.from_numpy(x), return_meta_tensor=True)
    assert tq_.dequantize(q, s, shape=x.shape, dtype=torch.float32).shape \
        == x.shape
    with pytest.raises(ValueError):
        tq_.dequantize(q)
    xt = torch.from_numpy(x).requires_grad_()
    tfq.quantize_dequantize_st(xt, 128).sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))
    w = torch.from_numpy(_w((16, 8), seed=3))
    a = torch.from_numpy(_w((5, 16), seed=4))
    q, s, pad = tfq.quantize(w, 32)
    jq, js, jpad = jfq.quantize(jnp.asarray(w.numpy()), 32)
    np.testing.assert_allclose(
        tfq.fp8_einsum("ab,bc->ac", a, q, s, pad, w.shape,
                       torch.float32).numpy(),
        np.asarray(jfq.fp8_einsum("ab,bc->ac", jnp.asarray(a.numpy()), jq,
                                  js, jpad, w.shape, jnp.float32)),
        rtol=1e-6, atol=1e-6)


class StandIn:
    """Records the dequantise kernel's launches and computes what the
    kernel computes, element by element, from its arguments."""

    def __init__(self):
        self.calls = []
        self.outputs = {}

    def launch(self, fn, q_ptr, s_ptr, out_ptr, n, ch, inner, stream):
        self.calls.append((fn, n, ch, inner))


@pytest.mark.parametrize("shape,batch_dims", [
    ((8, 64, 112), 1),            # an expert leaf [X, E, F]: per expert
    ((2, 8, 64, 112), 2),         # stacked over layers
    ((64, 4, 16), 0),             # an attention wq [E, H, D]
    ((2, 4, 16, 64), 1),          # a stacked wo [L, H, D, E]
    ((48, 32), 1),                # no reduced dim
])
def test_the_kernel_s_scale_index_is_the_broadcast(shape, batch_dims,
                                                   monkeypatch):
    """``meta`` tensors take the kernel's branch; the stand-in records
    (n, C, inner), and element i's scale ``(i // inner) * C + i % C``
    equals the broadcast the plain version multiplies by."""
    w = torch.from_numpy(_w(shape, seed=5))
    packed = tfq.quantize_channelwise(w, "fp8_e4m3", batch_dims)
    stand_in = StandIn()
    monkeypatch.setattr(tfq.KERNEL, "launch", stand_in.launch)
    monkeypatch.setattr(tfq, "stream_of", lambda t: 0)
    meta_leaf = {k: v.to("meta") for k, v in packed.items()}
    out = tfq.dequantize_channelwise(meta_leaf)
    assert out.dtype == torch.bfloat16 and out.shape == w.shape
    [(fn, n, ch, inner)] = stand_in.calls
    assert fn == "fp_dequant_e4m3_bf16" and n == w.numel()
    i = np.arange(n)
    flat_scale = packed["scale"].reshape(-1).numpy()
    by_index = flat_scale[(i // inner) * ch + i % ch]
    broadcast = torch.broadcast_to(packed["scale"], w.shape).reshape(-1)
    np.testing.assert_array_equal(by_index, broadcast.numpy())
    # the plain version is JAX's expression, bit for bit
    ref = jfq.dequantize_channelwise(
        {"q": jnp.asarray(packed["q"].float().numpy()).astype(
            jnp.float8_e4m3fn), "scale": jnp.asarray(packed["scale"])})
    np.testing.assert_array_equal(
        tfq.dequantize_channelwise_reference(packed).float().numpy(),
        np.asarray(ref.astype(jnp.float32)))


def test_the_kernel_wrapper_refuses_what_it_does_not_take(monkeypatch):
    monkeypatch.setattr(tfq.KERNEL, "launch", StandIn().launch)
    monkeypatch.setattr(tfq, "stream_of", lambda t: 0)
    w = torch.from_numpy(_w((8, 64, 32), seed=6))
    leaf = {k: v.to("meta") for k, v in
            tfq.quantize_channelwise(w, "fp8_e4m3", 1).items()}
    with pytest.raises(TypeError, match="bfloat16"):
        tfq.dequantize_channelwise(leaf, torch.float32)
    with pytest.raises(TypeError, match="codes"):
        tfq.dequantize_channelwise(dict(leaf, q=leaf["q"].float()))
    with pytest.raises(ValueError, match="channelwise"):
        tfq.dequantize_channelwise(dict(leaf, scale=leaf["scale"][..., :1]))
    odd = {k: v.to("meta") for k, v in tfq.quantize_channelwise(
        torch.from_numpy(_w((8, 64, 24), seed=7)), "int8", 1).items()}
    with pytest.raises(ValueError, match="multiple of 16"):
        tfq.dequantize_channelwise(odd)
    assert tfq.KERNEL.launches == 0


def test_cpu_leaves_take_the_plain_version_and_launch_nothing():
    w = torch.from_numpy(_w((8, 64, 32), seed=8))
    before = tfq.KERNEL.launches
    for fmt in tfq.SUPPORTED_FORMATS:
        leaf = tfq.quantize_channelwise(w, fmt, 1)
        assert torch.equal(tfq.dequantize_channelwise(leaf),
                           tfq.dequantize_channelwise_reference(leaf))
    assert tfq.KERNEL.launches == before


# ---------------------------------------------------------------------------
# quantize_weights (JAX tests/test_inference_v2.py:480-575)
# ---------------------------------------------------------------------------

def _mixtral(num_experts=2, top_k=1, scan_layers=True):
    model = JMixtral("debug", num_experts=num_experts, top_k=top_k,
                     dtype=jnp.float32, scan_layers=scan_layers)
    jcfg = dataclasses.replace(model.cfg, moe_num_experts=num_experts,
                               moe_top_k=top_k)
    tree = jax.tree.map(np.asarray,
                        meta.unbox(model.init_params(jax.random.key(0))))
    tcfg = mixtral_config("debug", dtype=torch.float32,
                          scan_layers=scan_layers,
                          moe_num_experts=num_experts, moe_top_k=top_k)
    return jcfg, tree, tcfg


def _engines(quant=None, **kw):
    jcfg, tree, tcfg = _mixtral(**kw)
    d = {"quantization": quant} if quant else {}
    jconf = J.RaggedInferenceEngineConfig.from_dict(d)
    jconf.kv_cache.num_pages = 64
    tconf = T.RaggedInferenceEngineConfig.from_dict(d)
    tconf.kv_cache.num_pages = 64
    jeng = J.InferenceEngineV2(J.RaggedInferenceModel(
        jcfg, jax.tree.map(jnp.asarray, tree)), jconf)
    teng = T.InferenceEngineV2(T.RaggedInferenceModel(
        tcfg, from_jax(tree, tcfg, device="cpu"), device="cpu"), tconf)
    return jeng, teng


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("fmt", ["fp8_e4m3", "int8", "fp4_e2m1"])
def test_quantize_weights_gives_jax_s_tree(fmt, scan_layers):
    """The engine's pass quantises the same leaves as JAX's, with the
    same codes and scales: per-layer attention scales, per-expert mlp
    scales, the router gate, norms, embeddings and lm head untouched."""
    jeng, teng = _engines({"enabled": True, "fmt": fmt},
                          scan_layers=scan_layers)
    jt = jax.tree.map(_values, jeng._model.params)
    tt = {k: v for k, v in teng.model.params.items()}
    jflat = dict(jax.tree_util.tree_flatten_with_path(jt)[0])
    tflat = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(_values, tt, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))[0])
    assert jflat.keys() == tflat.keys()
    for path, ref in jflat.items():
        np.testing.assert_array_equal(tflat[path], ref,
                                      err_msg=jax.tree_util.keystr(path))
    layers = teng.model.params["layers"]
    lay = layers if scan_layers else layers["layer_0"]
    lead = (2,) if scan_layers else ()
    assert set(lay["attn"]["wq"]) == {"q", "scale"}
    assert lay["mlp"]["wi"]["scale"].shape == lead + (2, 1, 128)
    assert lay["attn"]["wq"]["scale"].shape == lead + (1, 1, 16)
    for kept in (lay["mlp"]["gate"], lay["norm1"]["scale"],
                 teng.model.params["embed"]["tokens"],
                 teng.model.params["lm_head"]):
        assert isinstance(kept, torch.Tensor) and kept.dtype == torch.float32
    if fmt != "int8":
        assert lay["attn"]["wq"]["q"].dtype == torch.float8_e4m3fn
    assert teng.model.quantized_fmt == fmt


def test_quantize_weights_rules_match_jax():
    """A format change is refused, the same format is a no-op, a typo
    raises before anything changes and the corrected call succeeds (the
    JAX regressions, in both packages)."""
    jeng, teng = _engines({"enabled": True, "fmt": "fp8_e4m3"})
    for eng in (jeng._model, teng.model):
        with pytest.raises(ValueError):
            eng.quantize_weights("int8")
        before = eng.params
        eng.quantize_weights("fp8_e4m3")
        assert eng.params is before
    jeng, teng = _engines()
    for eng in (jeng._model, teng.model):
        with pytest.raises(ValueError, match="fp8"):
            eng.quantize_weights("fp8")
        assert not isinstance(eng.params["layers"]["attn"]["wq"], dict)
        eng.quantize_weights("fp8_e4m3")
        assert isinstance(eng.params["layers"]["attn"]["wq"], dict)


def test_quantizing_drops_the_step_cache_and_leaves_quantised_leaves():
    """A quantised tree handed to a quantising engine passes through
    untouched (the smoke builds Mixtral that way), and quantising drops
    every step the model had cached."""
    _, _, tcfg = _mixtral()
    _, tree, _ = _mixtral()
    model = T.RaggedInferenceModel(tcfg, from_jax(tree, tcfg, device="cpu"),
                                   device="cpu")
    model._step_cache[(1, 1, 1, False)] = None
    model._program_costs[(1, 1, 1, False)] = {"flops": 1.0, "bytes": 1.0}
    bytes_before = model._weight_bytes
    model.quantize_weights("fp8_e4m3")
    assert not model._step_cache and not model._program_costs
    assert model._weight_bytes < bytes_before
    quantised = model.params
    again = T.RaggedInferenceModel(tcfg, quantised, device="cpu")
    again.quantize_weights("fp8_e4m3")
    wi = again.params["layers"]["mlp"]["wi"]
    assert torch.equal(wi["q"].float(),
                       quantised["layers"]["mlp"]["wi"]["q"].float())
    # the bridge carries quantised leaves both ways, codes unchanged
    back = to_numpy(quantised)
    assert back["layers"]["mlp"]["wi"]["q"].dtype.name == "float8_e4m3fn"
    round_trip = from_jax(back, tcfg, device="cpu")
    assert round_trip["layers"]["mlp"]["wi"]["q"].dtype == torch.float8_e4m3fn
    assert torch.equal(round_trip["layers"]["mlp"]["wi"]["q"].float(),
                       wi["q"].float())


def test_engine_config_reads_the_quantization_block():
    cfg = T.RaggedInferenceEngineConfig.from_dict(
        {"quantization": {"enabled": True, "fmt": "int8", "other": 1},
         "kv_cache": {"num_pages": 12},
         "serving_optimization": {"enabled": False}})
    jcfg = J.RaggedInferenceEngineConfig.from_dict(
        {"quantization": {"enabled": True, "fmt": "int8", "other": 1},
         "kv_cache": {"num_pages": 12},
         "serving_optimization": {"enabled": False}})
    assert dataclasses.asdict(cfg.quantization) == \
        dataclasses.asdict(jcfg.quantization)
    assert cfg.kv_cache.num_pages == 12
    for flag in ("fused_step", "on_device_sampling", "async_scheduling",
                 "prefix_caching"):
        assert getattr(cfg.serving, flag) is False
        assert getattr(jcfg.serving, flag) is False
    assert T.RaggedInferenceEngineConfig().quantization.fmt == \
        J.RaggedInferenceEngineConfig().quantization.fmt
    with pytest.raises(NotImplementedError, match="13"):
        T.RaggedInferenceEngineConfig.from_dict(
            {"serving_optimization": {"tp_degree": 2}})
    with pytest.raises(NotImplementedError, match="13"):
        T.RaggedInferenceEngineConfig.from_dict(
            {"tensor_parallel": {"tp_size": 2}})
