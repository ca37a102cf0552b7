"""RMSNorm (plain and fused with a residual add) and LayerNorm: the CUDA
kernel wrappers and their plain PyTorch versions.

Counterpart of ``deepspeed_tpu/ops/normalization.py``.  The kernels
replace ``_rmsnorm_kernel`` and ``_rmsnorm_res_kernel``
(``csrc/rmsnorm.cu``) and ``_layernorm_kernel`` (``csrc/layernorm.cu``).
As in the JAX package, no model path calls the residual variant: it is
an op entry point (``rmsnorm(x, w, eps, residual=r)``).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .kernel_loader import CudaKernel, F, I, P, stream_of

KERNEL = CudaKernel("rmsnorm.cu", {
    "rmsnorm_bf16": [P, P, P, I, I, F, P],
    "rmsnorm_res_bf16": [P, P, P, P, P, I, I, F, P]})
LN_KERNEL = CudaKernel("layernorm.cu", {
    "layernorm_bf16": [P, P, P, P, I, I, F, P]})

#: widest row the kernels keep in registers (4 x 16-byte chunks x 256)
MAX_WIDTH = 8192
_BF16, _F32 = torch.bfloat16, torch.float32


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Plain version: fp32 mean of squares, rsqrt(var + eps), times the
    fp32 scale, cast back to ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm_res_reference(x: torch.Tensor, residual: torch.Tensor,
                          weight: torch.Tensor, eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused residual add: ``s = x + residual`` in
    fp32; returns ``(rmsnorm(s), s)``, both cast to ``x.dtype``.  The
    moment and the normalised output use the unrounded fp32 ``s``."""
    s = x.float() + residual.float()
    var = torch.mean(s * s, dim=-1, keepdim=True)
    out = (s * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
    return out, s.to(x.dtype)


def layernorm_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-5
                        ) -> torch.Tensor:
    """Plain version: fp32 mean, two-pass variance ``mean((x - mean)^2)``,
    scale and bias in fp32, cast back to ``x.dtype``."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mean
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * weight.float()
            + bias.float()).to(x.dtype)


def _takes(x: torch.Tensor, e: int, vectors, like=()) -> bool:
    """What the row kernels take, in one pass of cheap reads: bf16
    contiguous activations (``like``: further activations of x's shape),
    fp32 contiguous ``[E]`` vectors on x's device, ``E % 8 == 0`` and
    ``0 < E <= MAX_WIDTH``."""
    if not (x.dtype is _BF16 and x.is_contiguous() and not e % 8
            and 0 < e <= MAX_WIDTH):
        return False
    dev = x.device
    for t in like:
        if not (t.dtype is _BF16 and t.shape == x.shape and t.device == dev
                and t.is_contiguous()):
            return False
    for v in vectors:
        if not (v.dtype is _F32 and v.shape == (e,) and v.device == dev
                and v.is_contiguous()):
            return False
    return True


def _refusal(name: str, x: torch.Tensor, vectors, like=()) -> Exception:
    """The error for operands :func:`_takes` refused, naming the first
    requirement they miss."""
    e = x.shape[-1] if x.dim() else 0
    for t in (x, *like):
        if t.dtype != torch.bfloat16:
            return TypeError(f"{name} kernel takes bf16 activations, got "
                             f"{t.dtype}")
        if t.shape != x.shape or t.device != x.device:
            return ValueError(f"{name} kernel takes activations of one "
                              f"shape on one device, got {tuple(t.shape)} "
                              f"on {t.device} beside {tuple(x.shape)} on "
                              f"{x.device}")
        if not t.is_contiguous():
            return ValueError(f"{name} kernel takes contiguous activations")
    for v in vectors:
        if v.dtype != torch.float32 or v.shape != (e,) \
                or v.device != x.device or not v.is_contiguous():
            return ValueError(f"{name} kernel takes contiguous fp32 [E] "
                              f"vectors on {x.device}, got {v.dtype} "
                              f"{tuple(v.shape)} on {v.device}")
    return ValueError(f"{name} kernel needs E % 8 == 0 and 0 < E <= "
                      f"{MAX_WIDTH}, got E={e}")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            residual: Optional[torch.Tensor] = None
            ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x: [..., E].  With ``residual`` computes the fused (residual add ->
    norm) and returns ``(normed, new_residual)``, two new tensors.  CPU
    tensors take the plain versions; CUDA tensors launch ``rmsnorm_bf16``
    / ``rmsnorm_res_bf16`` (bf16 activations, fp32 weight) or raise."""
    if x.device.type == "cpu":
        if residual is None:
            return rmsnorm_reference(x, weight, eps)
        return rmsnorm_res_reference(x, residual, weight, eps)
    e = x.shape[-1] if x.dim() else 0
    if residual is None:
        if not _takes(x, e, (weight,)):
            raise _refusal("rmsnorm", x, (weight,))
        out = torch.empty_like(x)
        n = x.numel() // e
        if n:
            KERNEL.launch("rmsnorm_bf16", x.data_ptr(), weight.data_ptr(),
                          out.data_ptr(), n, e, eps, stream_of(x))
        return out
    if not _takes(x, e, (weight,), like=(residual,)):
        raise _refusal("rmsnorm", x, (weight,), like=(residual,))
    out, res_out = torch.empty_like(x), torch.empty_like(x)
    n = x.numel() // e
    if n:
        KERNEL.launch("rmsnorm_res_bf16", x.data_ptr(), residual.data_ptr(),
                      weight.data_ptr(), out.data_ptr(), res_out.data_ptr(),
                      n, e, eps, stream_of(x))
    return out, res_out


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [..., E].  CPU tensors take the plain version; CUDA tensors
    launch ``layernorm_bf16`` (bf16 x, fp32 weight and bias) or raise."""
    if x.device.type == "cpu":
        return layernorm_reference(x, weight, bias, eps)
    e = x.shape[-1] if x.dim() else 0
    if not _takes(x, e, (weight, bias)):
        raise _refusal("layernorm", x, (weight, bias))
    out = torch.empty_like(x)
    n = x.numel() // e
    if n:
        LN_KERNEL.launch("layernorm_bf16", x.data_ptr(), weight.data_ptr(),
                         bias.data_ptr(), out.data_ptr(), n, e, eps,
                         stream_of(x))
    return out
