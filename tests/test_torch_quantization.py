"""The port's blockwise int8 quantisation and ZeRO++ quantised weights
(qwZ) held against the JAX package's, on the CPU.

Seeded numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, as tests/test_ops.py runs them) and the port's plain
versions.  Codes, scales, pads and dequantised values are required
bit-equal.  Engine parity follows tests/test_torch_training.py (the
debug llama in fp32 against the one-device JAX engine, 5 train_batch
calls, its tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dtt
from deepspeed_tpu.models.llama import LlamaForCausalLM as JLlama
from deepspeed_tpu.ops import quantization as jq
from deepspeed_tpu_torch.checkpoint.from_jax import from_jax, to_numpy
from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops import quantization as tq
from deepspeed_tpu_torch.tree import tree_leaves, tree_map
from test_torch_training import (LOSS_RTOL, assert_params_close, jax_engine,
                                 jax_params, llama_config, token_batches)

# chip_smoke.py holds one micro-batch's loss on the qwZ compute tree
# against the loss on the plain bf16 cast of the same masters:
# 0 < |delta loss| / loss <= QWZ_LOSS_REL_TOL
QWZ_LOSS_REL_TOL = 1e-2


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


def _blocks(*rows):
    return np.concatenate(rows).astype(np.float32)


def _case(name):
    """(flat fp32 input, block) for each case."""
    rng = np.random.default_rng(CASES.index(name))
    normal = rng.standard_normal
    if name == "n1000_pad24":
        return normal(1000).astype(np.float32), 512
    if name == "n10000":
        return normal(10000).astype(np.float32), 512
    if name == "n4x512":
        return normal(4 * 512).astype(np.float32), 512
    if name == "block64":
        return normal(4 * 512).astype(np.float32), 64
    if name == "zero_block":
        return _blocks(normal(512), np.zeros(512), normal(300)), 512
    if name == "sub_1e-12":
        # absmax below the floor: scale = 1e-12 / 127, codes up to ~13
        return _blocks(1e-13 * normal(512), normal(512)), 512
    if name == "ties":
        # absmax 127 gives scale 1.0 exactly, so k + 0.5 are exact ties:
        # half to even sends 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -2.5 -> -2
        ties = np.tile([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                       64)
        ties[0] = 127.0
        return ties.astype(np.float32), 512
    if name == "absmax":
        # +-absmax -> +-127
        x = normal(1024)
        x[7], x[600] = 40.0, -40.0
        return x.astype(np.float32), 512
    raise KeyError(name)


CASES = ["n1000_pad24", "n10000", "n4x512", "block64", "zero_block",
         "sub_1e-12", "ties", "absmax"]


@pytest.mark.parametrize("case", CASES)
def test_quantize_blockwise_is_bit_equal_to_jax(case):
    x, block = _case(case)
    qj, sj, pj = jq.quantize_blockwise(jnp.asarray(x), block)
    qt, st, pt = tq.quantize_blockwise(torch.from_numpy(x), block)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert pt == pj == (-x.size) % block
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if case == "ties":
        assert qt.numpy()[0, :9].tolist() == [127, 2, 2, 0, -2, -2, 126,
                                              -126, 0]
    if case == "absmax":
        assert qt.numpy()[0, 7] == 127 and qt.numpy()[1, 600 - 512] == -127
    if case == "zero_block":
        assert not qt.numpy()[1].any()
        assert st.numpy()[1] == np.float32(1e-12) * tq.INV_127
    if pt:
        assert not qt.numpy()[-1, block - pt:].any()   # padding codes 0
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = jq.dequantize_blockwise(qj, sj, pj, x.shape, jdt)
        got = tq.dequantize_blockwise(qt, st, pt, x.shape, tdt)
        assert got.dtype == tdt and tuple(got.shape) == x.shape
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_is_bit_equal_to_jax(dtype):
    """The fake-quant round trip over a 3-D leaf, in the input's dtype,
    and (what qwZ asks for) fp32 straight into bf16."""
    x = np.random.default_rng(3).standard_normal((3, 40, 50)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jq.quantize_dequantize(jx)
    got = tq.quantize_dequantize(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    direct = tq.quantize_dequantize(torch.from_numpy(x), dtype=torch.bfloat16)
    via = jq.quantize_dequantize(jnp.asarray(x)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(direct.float().numpy(),
                                  np.asarray(via.astype(jnp.float32)))


def test_roundtrip_error_is_within_one_step():
    """tests/test_ops.py:140: every element within the global step
    max|x| / 127 of its input."""
    x = np.random.default_rng(1).standard_normal(10000).astype(np.float32)
    y = tq.quantize_dequantize(torch.from_numpy(x)).numpy()
    assert np.abs(x - y).max() <= np.abs(x).max() / 127 * 1.01


def test_the_scale_is_the_product_with_fp32_one_over_127():
    """XLA computes ``absmax / 127.0`` as ``absmax * fp32(1/127)``; the
    true quotient differs from it by an ulp in some blocks, so the plain
    version takes the product (as the kernel does)."""
    x = np.random.default_rng(4).standard_normal((400, 512)).astype(
        np.float32)
    _, s, _ = tq.quantize_blockwise(torch.from_numpy(x))
    amax = np.abs(x).max(axis=1)
    product = amax * np.float32(tq.INV_127)
    quotient = amax / np.float32(127.0)
    np.testing.assert_array_equal(s.numpy(), product)
    assert (product != quotient).any()


def test_wrappers_run_no_kernel_on_cpu():
    x = torch.randn(3000)
    before = dict(tq.KERNEL.launches_by_fn)
    q, s, pad = tq.quantize_blockwise(x)
    assert q.shape == (6, 512) and s.shape == (6,) and pad == 72
    assert tq.dequantize_blockwise(q, s, pad, (3000,)).shape == (3000,)
    assert tq.KERNEL.launches_by_fn == before


# ---------------------------------------------------------------------------
# ZeRO stages and qwZ in the engine, against the one-device JAX engine
# ---------------------------------------------------------------------------

LION = {"type": "lion", "params": {"lr": 1e-3, "weight_decay": 0.01}}
QWZ = {"stage": 3, "zero_quantized_weights": True}


def _engines(scan_layers=True, **over):
    cfg = llama_config(**over)
    je = jax_engine(JLlama("debug", dtype=jnp.float32,
                           scan_layers=scan_layers), cfg)
    model = LlamaForCausalLM("debug", dtype=torch.float32,
                             scan_layers=scan_layers)
    te, *_ = dtt.initialize(
        model=model, config=cfg, device="cpu",
        model_parameters=from_jax(jax_params(je), model.cfg, device="cpu"))
    return je, te


def _losses(engine, n=5):
    return np.array([engine.train_batch(b) for b in token_batches(n)])


@pytest.mark.parametrize("scan_layers", [True, False])
def test_qwz_training_matches_jax_engine(scan_layers):
    """Lion at stage 3 with quantised weights (the card's qwZ path), both
    layer layouts.  The codes are bit-equal, so the engines stay as close
    as without qwZ.  (Under AdamW they drift apart: Adam moves a weight
    whose gradient is rounding noise by +-lr with the noise's sign, and
    the int8 grid turns such a difference into a whole step.)"""
    je, te = _engines(scan_layers, optimizer=LION, zero_optimization=QWZ)
    assert te.config.quantized_weights
    for batch in token_batches(5):
        np.testing.assert_allclose(te.train_batch(batch),
                                   je.train_batch(batch), rtol=LOSS_RTOL)
    assert_params_close(to_numpy(te.params), jax_params(je))


def test_qwz_compute_tree_is_the_jax_grid_and_never_the_masters():
    """Step 0's compute tree: every leaf of two or more dimensions equals
    JAX's quantize_dequantize of its master bit for bit, stacked norm
    scales [L, E] included, and is a new tensor even in fp32; 1-D leaves
    are the masters' storage, as without qwZ."""
    je, te = _engines(optimizer=LION, zero_optimization=QWZ)
    params_c = te._compute_params()
    masters = tree_leaves(te.params)
    quantised = 0
    for p, c in zip(masters, tree_leaves(params_c)):
        if p.dim() >= 2:
            ref = jq.quantize_dequantize(jnp.asarray(p.numpy()))
            np.testing.assert_array_equal(c.detach().numpy(),
                                          np.asarray(ref))
            assert c.data_ptr() != p.data_ptr()
            quantised += 1
        else:
            assert c.data_ptr() == p.data_ptr()
    assert quantised == len(masters) - 1      # all but final_norm.scale
    # the stacked norm scale went through the grid (its ones stay ones)
    scale_c = params_c["layers"]["norm1"]["scale"]
    assert scale_c.dim() == 2 and scale_c.data_ptr() != \
        te.params["layers"]["norm1"]["scale"].data_ptr()


def test_per_layer_norm_scales_are_not_quantised():
    _, te = _engines(False, optimizer=LION, zero_optimization=QWZ)
    params_c = te._compute_params()
    layer = params_c["layers"]["layer_0"]
    assert layer["norm1"]["scale"].data_ptr() == \
        te.params["layers"]["layer_0"]["norm1"]["scale"].data_ptr()
    assert not torch.equal(layer["attn"]["wq"],
                           te.params["layers"]["layer_0"]["attn"]["wq"])


@pytest.fixture(scope="module")
def stage0_losses():
    je, te = _engines()
    return _losses(je, 3), _losses(te, 3)


@pytest.mark.parametrize("zero", [{"stage": 1}, {"stage": 2}, {"stage": 3},
                                  {"stage": 2, "zero_quantized_weights": True,
                                   "overlap_comm": True}])
def test_zero_stages_on_one_device_give_stage_0_numbers(stage0_losses, zero):
    """On one rank ZeRO's partition is the identity: stages 1-3, and qwZ
    below stage 3, give stage 0's losses in both engines."""
    je, te = _engines(zero_optimization=zero)
    assert te.config.zero_stage == zero["stage"]
    assert not te.config.quantized_weights
    np.testing.assert_array_equal(_losses(je, 3), stage0_losses[0])
    np.testing.assert_array_equal(_losses(te, 3), stage0_losses[1])


def test_qwz_changes_the_losses_in_both_engines(stage0_losses):
    """tests/test_zeropp.py:88-97: close to the unquantised trajectory,
    not identical (AdamW, the first 3 steps)."""
    je, te = _engines(zero_optimization=QWZ)
    for engine, ref in zip((je, te), stage0_losses):
        got = _losses(engine, 3)
        np.testing.assert_allclose(got, ref, rtol=0.05)
        assert not np.allclose(got, ref, rtol=1e-7)


# ---------------------------------------------------------------------------
# chip_smoke.py's qwZ loss limit, on a CPU stand-in
# ---------------------------------------------------------------------------

def _loss(model, tree, ids):
    with torch.no_grad():
        return float(model.loss(tree, {"input_ids": ids}))


@pytest.mark.parametrize("layers,seq", [(2, 128), (8, 64)])
def test_qwz_loss_limit_passes_rounding_and_fails_faults(layers, seq):
    """A bf16 llama's loss on the qwZ compute tree against the plain bf16
    cast of the same fp32 masters: the int8 grid moves it by more than 0
    and less than the limit; a skipped quantisation moves it by exactly
    0, and scales twice too large move it past the limit."""
    model = LlamaForCausalLM("tiny", num_layers=layers)
    masters = init_params(model.cfg, seed=0, device="cpu",
                          dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, seq)))

    def tree(cast):
        return tree_map(lambda p: cast(p) if p.dim() >= 2
                        else p.to(torch.bfloat16), masters)

    plain = _loss(model, tree(lambda p: p.to(torch.bfloat16)), ids)

    def rel(cast):
        return abs(_loss(model, tree(cast), ids) - plain) / abs(plain)

    def doubled(p):
        q, s, pad = tq.quantize_blockwise(p)
        return tq.dequantize_blockwise(q, 2 * s, pad, p.shape, torch.bfloat16)

    qwz = rel(lambda p: tq.quantize_dequantize(p, dtype=torch.bfloat16))
    skipped = rel(lambda p: p.to(torch.bfloat16))
    wrong_scale = rel(doubled)
    print(f"qwZ {qwz:.2e}, skipped {skipped:.2e}, doubled scales "
          f"{wrong_scale:.2e}")
    assert 0 < qwz <= QWZ_LOSS_REL_TOL
    assert not 0 < skipped
    assert wrong_scale > QWZ_LOSS_REL_TOL
