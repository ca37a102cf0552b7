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


def _rows(name: str, x: torch.Tensor, vectors, like=()) -> torch.Tensor:
    """Check what the row kernels take and return ``x`` as ``[N, E]``:
    bf16 contiguous activations (``like``: further activations of x's
    shape), fp32 contiguous ``[E]`` vectors on x's device, ``E % 8 == 0``
    and ``E <= MAX_WIDTH``."""
    e = x.shape[-1]
    for t in (x, *like):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16 activations, got "
                            f"{t.dtype}")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} kernel takes activations of one shape "
                             f"on one device, got {tuple(t.shape)} on "
                             f"{t.device} beside {tuple(x.shape)} on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous activations")
    for v in vectors:
        if v.dtype != torch.float32 or v.shape != (e,) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous fp32 [E] "
                             f"vectors on {x.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    if e % 8 or e > MAX_WIDTH:
        raise ValueError(f"{name} kernel needs E % 8 == 0 and E <= "
                         f"{MAX_WIDTH}, got E={e}")
    return x.reshape(-1, e)


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
    if residual is None:
        x2 = _rows("rmsnorm", x, (weight,))
        out = torch.empty_like(x2)
        if x2.shape[0]:
            KERNEL.launch("rmsnorm_bf16", x2.data_ptr(), weight.data_ptr(),
                          out.data_ptr(), x2.shape[0], x2.shape[1],
                          float(eps), stream_of(x2))
        return out.reshape(x.shape)
    x2 = _rows("rmsnorm", x, (weight,), like=(residual,))
    r2 = residual.reshape(x2.shape)
    out, res_out = torch.empty_like(x2), torch.empty_like(x2)
    if x2.shape[0]:
        KERNEL.launch("rmsnorm_res_bf16", x2.data_ptr(), r2.data_ptr(),
                      weight.data_ptr(), out.data_ptr(), res_out.data_ptr(),
                      x2.shape[0], x2.shape[1], float(eps), stream_of(x2))
    return out.reshape(x.shape), res_out.reshape(x.shape)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x: [..., E].  CPU tensors take the plain version; CUDA tensors
    launch ``layernorm_bf16`` (bf16 x, fp32 weight and bias) or raise."""
    if x.device.type == "cpu":
        return layernorm_reference(x, weight, bias, eps)
    x2 = _rows("layernorm", x, (weight, bias))
    out = torch.empty_like(x2)
    if x2.shape[0]:
        LN_KERNEL.launch("layernorm_bf16", x2.data_ptr(), weight.data_ptr(),
                         bias.data_ptr(), out.data_ptr(), x2.shape[0],
                         x2.shape[1], float(eps), stream_of(x2))
    return out.reshape(x.shape)
