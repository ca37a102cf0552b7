"""Blockwise symmetric int8 quantisation: the CUDA kernel wrappers and
their plain versions.

Counterpart of ``deepspeed_tpu/ops/quantization.py:28-86`` (``BLOCK``,
``quantize_blockwise``, ``dequantize_blockwise``,
``quantize_dequantize``); the kernels (``csrc/quantization.cu``) replace
``_quant_kernel`` and ``_dequant_kernel``.  The training engine runs
them for ZeRO++ quantised weights (``zero_quantized_weights``).  The
quantised collectives that also use them in the JAX package do nothing
on one rank and are not ported yet (ROADMAP Queue 1 items 11b, 11e).

Per block of ``block`` consecutive elements of the flat leaf (zeros past
its end): ``scale = max(max|x|, 1e-12) / 127`` in fp32, the max taken
before the division (not ``quantize_kv_blocks``'s ``amax / 127``), and
``q = clip(round_half_even(x / scale), -127, 127)`` on a true division.
XLA turns the division by the constant 127 into a product with its fp32
reciprocal, so the scale is ``max(max|x|, 1e-12) * fp32(1 / 127)`` here
too (it differs from the quotient by an ulp in about one block in 20);
codes and scales are bit-equal to JAX's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .kernel_loader import LL, CudaKernel, P, stream_of

BLOCK = 512  # quantisation group size (the reference's default)
#: fp32(1 / 127): the scale's factor, as XLA computes ``absmax / 127``
INV_127 = float(np.float32(1.0) / np.float32(127.0))

KERNEL = CudaKernel("quantization.cu", {
    "quantize_blockwise_f32": [P, P, P, LL, P],
    "dequantize_blockwise_f32": [P, P, P, LL, P],
    "dequantize_blockwise_bf16": [P, P, P, LL, P]})

_DEQUANT_FN = {torch.float32: "dequantize_blockwise_f32",
               torch.bfloat16: "dequantize_blockwise_bf16"}


def quantize_blockwise_reference(x: torch.Tensor, block: int = BLOCK
                                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Plain version of the quantise kernel: the TPU kernel's
    expressions over the zero-padded flat tensor."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    x2 = flat.reshape(-1, block)
    absmax = x2.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) * INV_127
    q = torch.clamp(torch.round(x2 / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], pad


def dequantize_blockwise_reference(q: torch.Tensor, s: torch.Tensor, pad: int,
                                   shape: Sequence[int],
                                   dtype: torch.dtype = torch.float32
                                   ) -> torch.Tensor:
    """Plain version of the dequantise kernel: ``q * s`` in fp32, cast
    to ``dtype``, the padding cut off."""
    flat = (q.float() * s[:, None]).to(dtype).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(tuple(shape))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, numel: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.device != device:
        raise TypeError(f"quantization kernel takes {dtype} {name} on "
                        f"{device}, got {t.dtype} on {t.device}")
    if t.numel() != numel or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"quantization kernel takes a contiguous 16-byte "
                         f"aligned {name} of {numel} elements, got "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _check_block(block: int) -> None:
    if block != BLOCK:
        raise ValueError(f"the quantization kernel's block is {BLOCK}, got "
                         f"{block}")


def quantize_blockwise(x: torch.Tensor, block: int = BLOCK
                       ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Flat fp tensor -> (int8 codes [rows, block], fp32 scales [rows],
    pad), ``rows = ceil(x.numel() / block)``.  CPU tensors take
    :func:`quantize_blockwise_reference`; a CUDA tensor must be
    contiguous, 16-byte aligned fp32 at ``block`` 512, and launches
    ``quantize_blockwise_f32`` or raises."""
    if x.device.type == "cpu":
        return quantize_blockwise_reference(x, block)
    _check_block(block)
    n = x.numel()
    _check("x", x, torch.float32, n, x.device)
    rows = -(-n // block)
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    s = torch.empty((rows,), dtype=torch.float32, device=x.device)
    if n:
        KERNEL.launch("quantize_blockwise_f32", x.data_ptr(), q.data_ptr(),
                      s.data_ptr(), n, stream_of(x))
    return q, s, rows * block - n


def dequantize_blockwise(q: torch.Tensor, s: torch.Tensor, pad: int,
                         shape: Sequence[int],
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Codes and scales -> a tensor of ``shape`` in ``dtype`` (fp32 or
    bf16 on the card), the padding cut off.  CPU tensors take
    :func:`dequantize_blockwise_reference`; CUDA tensors launch the
    dequantise kernel or raise."""
    if q.device.type == "cpu":
        return dequantize_blockwise_reference(q, s, pad, shape, dtype)
    if q.dim() != 2:
        raise ValueError(f"codes are [rows, block], got {tuple(q.shape)}")
    rows, block = q.shape
    _check_block(block)
    n = rows * block - pad
    if not 0 <= pad < block or n != math.prod(shape):
        raise ValueError(f"{rows} blocks less pad {pad} do not hold shape "
                         f"{tuple(shape)}")
    if dtype not in _DEQUANT_FN:
        raise TypeError(f"dequantize kernel writes fp32 or bf16, got {dtype}")
    _check("codes", q, torch.int8, rows * block, q.device)
    _check("scales", s, torch.float32, rows, q.device)
    out = torch.empty(tuple(shape), dtype=dtype, device=q.device)
    if n:
        KERNEL.launch(_DEQUANT_FN[dtype], q.data_ptr(), s.data_ptr(),
                      out.data_ptr(), n, stream_of(q))
    return out


def quantize_dequantize(x: torch.Tensor, block: int = BLOCK,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fake-quant round trip: ``x`` snapped to the blockwise int8 grid,
    in ``dtype`` (default ``x.dtype``), always a new tensor.  ZeRO++ qwZ
    in the engine asks for the compute dtype directly: a bf16 store of
    the fp32 product equals JAX's fp32 round trip cast to bf16."""
    q, s, pad = quantize_blockwise(x, block)
    return dequantize_blockwise(q, s, pad, x.shape, dtype or x.dtype)
