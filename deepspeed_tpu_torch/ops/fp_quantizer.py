"""Floating-point (FP8 / FP6 / FP4) and int8 weight quantisation, and
the CUDA kernel that dequantises a channelwise leaf.

Counterpart of ``deepspeed_tpu/ops/fp_quantizer.py`` (the whole file):
the format table, ``quantize_channelwise`` / ``dequantize_channelwise``
(weight-only quantised serving, ``RaggedInferenceModel.
quantize_weights``), the blockwise ``quantize`` / ``dequantize``,
``selective_dequantize``, ``fp8_einsum``, ``QuantizedTensor`` and
``FP_Quantize``.

Storage, per format:

* ``fp8_e4m3`` / ``fp8_e5m2``: torch's native ``float8_e4m3fn`` /
  ``float8_e5m2`` (the same round-to-nearest-even conversion as
  ``jnp.astype``, bit for bit on the CPU);
* ``fp6_e3m2`` / ``fp6_e2m3``: snapped to the exact fp6 grid and stored
  as ``float8_e4m3fn``, as in the JAX package (ties go to the smaller
  magnitude, as JAX's ``_snap_to_grid`` does);
* ``fp4_e2m1``: torch has only the packed ``float4_e2m1fn_x2``, so the
  values snap to the e2m1 grid and store as ``float8_e4m3fn`` (the JAX
  package's own fallback).  The JAX package stores a native 4-bit type
  where its JAX has one, which rounds ties to even and saturates at 6:
  the snap here does the same, so the dequantised values are equal
  whichever storage the JAX side took.
* ``int8``: ``clip(round_half_even(w / scale), -127, 127)``.

Scales are fp32, ``max(absmax, 1e-12) / max_mag`` (a true division, as
JAX computes it outside a kernel).

``dequantize_channelwise`` on a CUDA leaf launches
``csrc/fp_dequant.cu``: one elementwise pass, ``bf16(float(q) * scale)``,
bit-equal to the plain version ``(q.float() * scale).to(bf16)``.  It
replaces no TPU kernel: in the JAX package XLA fuses the cast and the
scale into the consuming einsum, while the plain torch expression would
write an fp32 temporary of every expert weight at every decode step
(about 19 bytes an element moved against the kernel's 3).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, P, stream_of

# format -> (storage dtype, max normal magnitude, (exp_bits, man_bits))
_FORMATS = {
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0, (4, 3)),
    "fp8_e5m2": (torch.float8_e5m2, 57344.0, (5, 2)),
    "fp6_e3m2": (torch.float8_e4m3fn, 28.0, (3, 2)),
    "fp6_e2m3": (torch.float8_e4m3fn, 7.5, (2, 3)),
    "fp4_e2m1": (torch.float8_e4m3fn, 6.0, (2, 1)),
}

#: formats whose values are snapped to their grid before the store
_SNAP_FORMATS = ("fp6_e3m2", "fp6_e2m3", "fp4_e2m1")
#: snapped formats whose ties round to even (the JAX package's native
#: 4-bit conversion); the fp6 formats keep ``_snap_to_grid``'s lower tie
_TIES_EVEN = ("fp4_e2m1",)

#: formats quantize_channelwise/quantize accept (int8 is handled inline)
SUPPORTED_FORMATS = ("int8",) + tuple(_FORMATS)

# reference FP_Quantize keys formats by q_bits (quantize.py:46)
_BITS_TO_FORMAT = {8: "fp8_e4m3", 6: "fp6_e3m2", 12: "fp8_e4m3",
                   4: "fp4_e2m1"}

KERNEL = CudaKernel("fp_dequant.cu", {
    "fp_dequant_e4m3_bf16": [P, P, P, LL, LL, LL, P],
    "fp_dequant_e5m2_bf16": [P, P, P, LL, LL, LL, P],
    "fp_dequant_int8_bf16": [P, P, P, LL, LL, LL, P]})

_DEQUANT_FN = {torch.float8_e4m3fn: "fp_dequant_e4m3_bf16",
               torch.float8_e5m2: "fp_dequant_e5m2_bf16",
               torch.int8: "fp_dequant_int8_bf16"}
#: codes one thread of the kernel reads at once (one 16-byte load)
_VEC = 16


def _fp6_grid(fmt: str) -> np.ndarray:
    """All non-negative representable values of a snapped format, in
    order (index ``i`` has mantissa ``i % 2**man_bits``)."""
    exp_bits, man_bits = _FORMATS[fmt][2]
    bias = 2 ** (exp_bits - 1) - 1
    vals = [0.0]
    for e in range(2 ** exp_bits):
        for m in range(2 ** man_bits):
            if e == 0:  # subnormals
                v = (m / 2 ** man_bits) * 2.0 ** (1 - bias)
            else:
                v = (1 + m / 2 ** man_bits) * 2.0 ** (e - bias)
            vals.append(v)
    return np.unique(np.asarray(vals, np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fp6_grid_cached(fmt: str) -> np.ndarray:
    return _fp6_grid(fmt)


def _snap_to_grid(x: torch.Tensor, grid: np.ndarray,
                  ties_even: bool = False) -> torch.Tensor:
    """Round-to-nearest onto a symmetric grid (sign handled separately).
    A magnitude exactly between two grid values takes the smaller one,
    or with ``ties_even`` the one of even mantissa (even index)."""
    mags = torch.from_numpy(grid).to(x.device)
    mids = torch.from_numpy((grid[1:] + grid[:-1]) / 2.0).to(x.device)
    a = x.abs()
    idx = torch.searchsorted(mids, a)
    if ties_even:
        at = torch.clamp(idx, max=mids.numel() - 1)
        tie = (mids[at] == a) & (idx % 2 == 1)
        idx = idx + tie.to(idx.dtype)
    return torch.sign(x) * mags[idx]


def _encode(y: torch.Tensor, fmt: str) -> torch.Tensor:
    """Scaled fp32 values -> the format's storage."""
    if fmt in _SNAP_FORMATS:
        y = _snap_to_grid(y, _fp6_grid_cached(fmt), fmt in _TIES_EVEN)
    return y.to(_FORMATS[fmt][0])


def quantize(x: torch.Tensor, group_size: int = 512,
             q_bits: Optional[int] = None,
             fmt: str = "fp8_e4m3") -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise FP quantization.

    Returns ``(q, scales, pad)``: q is ``[rows, group_size]`` in the
    format's storage dtype, scales are fp32 ``[rows]`` such that
    ``q * scales`` reconstructs, pad is trailing elements added."""
    if q_bits is not None:
        fmt = _BITS_TO_FORMAT[q_bits]
    max_mag = _FORMATS[fmt][1]
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % group_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    x2 = flat.reshape(-1, group_size)
    absmax = x2.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / max_mag
    return _encode(x2 / scale, fmt), scale[:, 0], pad


def dequantize(q: torch.Tensor, scales: torch.Tensor, pad: int, shape,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    out = (q.float() * scales[:, None]).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(tuple(shape)).to(dtype)


def selective_dequantize(q: torch.Tensor, scales: torch.Tensor,
                         rows: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dequantize only the requested block rows (reference
    ``selective_dequantize``, fp_quantizer/quantize.py:98)."""
    rows = rows.long()
    return (q[rows].float() * scales[rows][:, None]).to(dtype)


def quantize_dequantize(x: torch.Tensor, group_size: int = 512,
                        q_bits: Optional[int] = None,
                        fmt: str = "fp8_e4m3") -> torch.Tensor:
    q, s, pad = quantize(x, group_size, q_bits, fmt)
    return dequantize(q, s, pad, x.shape, x.dtype)


class _QuantizeDequantizeST(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_size, fmt):
        return quantize_dequantize(x, group_size, fmt=fmt)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def quantize_dequantize_st(x: torch.Tensor, group_size: int = 512,
                           fmt: str = "fp8_e4m3") -> torch.Tensor:
    """Straight-through FP fake-quant: forward snaps to the fp grid,
    gradient passes through (JAX's ``custom_vjp``)."""
    return _QuantizeDequantizeST.apply(x, group_size, fmt)


def fp8_einsum(spec: str, x: torch.Tensor, q: torch.Tensor,
               scales: torch.Tensor, pad: int, w_shape,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Matmul against a blockwise-quantized weight: dequantize, then the
    einsum (weight-only W8A16)."""
    return torch.einsum(spec, x, dequantize(q, scales, pad, w_shape, dtype))


def quantize_channelwise(w: torch.Tensor, fmt: str = "fp8_e4m3",
                         batch_dims: int = 0) -> Dict[str, torch.Tensor]:
    """Weight-only quantization preserving shape: values stored in the
    low-precision dtype, one fp32 scale per last-axis channel (kept with
    singleton reduced dims so ``q * scale`` broadcasts for any rank).
    ``batch_dims`` leading dims (a scan-stacked layers dim, experts) each
    get their own scales rather than sharing one."""
    axes = tuple(range(batch_dims, w.dim() - 1))
    w32 = w.float()
    absmax = (w32.abs().amax(dim=axes, keepdim=True) if axes
              else w32.abs())
    if fmt == "int8":
        scale = torch.clamp(absmax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale}
    scale = torch.clamp(absmax, min=1e-12) / _FORMATS[fmt][1]
    return {"q": _encode(w32 / scale, fmt), "scale": scale}


def dequantize_channelwise_reference(packed: Dict[str, torch.Tensor],
                                     dtype: torch.dtype = torch.bfloat16
                                     ) -> torch.Tensor:
    """Plain version of the dequantise kernel: JAX's expression."""
    return (packed["q"].float() * packed["scale"]).to(dtype)


def _channel_layout(q: torch.Tensor, scale: torch.Tensor
                    ) -> Tuple[int, int]:
    """(C, inner) of a channelwise leaf for the kernel: ``scale`` is
    q's shape with a run of middle dims reduced to 1 and the last kept,
    so element ``i`` of the flat codes takes scale ``(i // inner) * C +
    i % C``; raises on any other layout."""
    if scale.dim() != q.dim() or q.dim() == 0:
        raise ValueError(f"scale {tuple(scale.shape)} does not broadcast "
                         f"over codes {tuple(q.shape)} channelwise")
    C = q.shape[-1]
    lead = 0
    while lead < q.dim() - 1 and scale.shape[lead] == q.shape[lead] \
            and scale.shape[lead] != 1:
        lead += 1
    reduced = scale.shape[lead:-1]
    if scale.shape[-1] != C or any(d != 1 for d in reduced):
        raise ValueError(f"scale {tuple(scale.shape)} is not a channelwise "
                         f"scale of codes {tuple(q.shape)}")
    return C, math.prod(q.shape[lead:])


def dequantize_channelwise(packed: Dict[str, torch.Tensor],
                           dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """``{"q", "scale"}`` -> ``(q * scale)`` in ``dtype``.  CPU leaves
    take :func:`dequantize_channelwise_reference`; a CUDA leaf (fp8 e4m3
    or e5m2 or int8 codes, contiguous, 16-byte aligned, the last dim a
    multiple of 16; fp32 scales) launches the kernel into bf16 or
    raises."""
    q, scale = packed["q"], packed["scale"]
    if q.device.type == "cpu":
        return dequantize_channelwise_reference(packed, dtype)
    fn = _DEQUANT_FN.get(q.dtype)
    if fn is None or dtype != torch.bfloat16:
        raise TypeError(f"the dequantise kernel takes fp8 e4m3/e5m2 or int8 "
                        f"codes into torch.bfloat16, got {q.dtype} into "
                        f"{dtype}")
    if scale.dtype != torch.float32 or scale.device != q.device:
        raise TypeError(f"the dequantise kernel takes fp32 scales on "
                        f"{q.device}, got {scale.dtype} on {scale.device}")
    C, inner = _channel_layout(q, scale)
    if C % _VEC or not (q.is_contiguous() and scale.is_contiguous()) or any(
            t.data_ptr() % 16 for t in (q, scale)):
        raise ValueError(f"the dequantise kernel takes contiguous 16-byte "
                         f"aligned codes and scales with a last dim that is "
                         f"a multiple of {_VEC}, got {tuple(q.shape)} "
                         f"strides {q.stride()}")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    n = q.numel()
    if n:
        KERNEL.launch(fn, q.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
                      C, inner, stream_of(q))
    return out


class QuantizedTensor:
    """Self-describing quantized buffer: values + scales + original
    shape/dtype (the reference packs scales into the buffer's tail)."""

    __slots__ = ("q", "scales", "pad", "shape", "dtype")

    def __init__(self, q, scales, pad, shape, dtype):
        self.q, self.scales, self.pad = q, scales, pad
        self.shape, self.dtype = shape, dtype


class FP_Quantize:
    """Object API mirroring reference ``deepspeed.ops.fp_quantizer
    .FP_Quantize`` (quantize.py:32)."""

    def __init__(self, group_size: int = 512):
        self.group_size = group_size

    def quantize(self, x, q_bits: int = 8, return_meta_tensor: bool = False):
        q, s, pad = quantize(x, self.group_size, q_bits=q_bits)
        if return_meta_tensor:
            return q, s
        return QuantizedTensor(q, s, pad, x.shape, x.dtype)

    def dequantize(self, q, scale=None, q_bits: int = 8, shape=None,
                   dtype: torch.dtype = torch.bfloat16):
        if isinstance(q, QuantizedTensor):
            return dequantize(q.q, q.scales, q.pad, q.shape, q.dtype)
        if scale is None:
            raise ValueError(
                "dequantize needs either a QuantizedTensor (from "
                "quantize(return_meta_tensor=False)) or explicit scale")
        return dequantize(q, scale, 0 if shape is None else
                          q.numel() - math.prod(shape),
                          shape if shape is not None else q.shape, dtype)
