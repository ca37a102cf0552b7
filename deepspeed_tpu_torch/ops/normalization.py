"""RMSNorm: the CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``deepspeed_tpu/ops/normalization.py``; the kernel
(``csrc/rmsnorm.cu``) replaces ``_rmsnorm_kernel``.  The residual and
LayerNorm variants are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch

from .kernel_loader import CudaKernel, F, I, P, stream_of

KERNEL = CudaKernel("rmsnorm.cu", {"rmsnorm_bf16": [P, P, P, I, I, F, P]})

#: widest row the kernel keeps in registers (4 x 16-byte chunks x 256)
MAX_WIDTH = 8192


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Plain version: fp32 mean of squares, rsqrt(var + eps), times the
    fp32 scale, cast back to ``x.dtype``."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., E].  CPU tensors take the plain version; CUDA tensors
    launch ``rmsnorm_bf16`` (bf16 x, fp32 weight) or raise."""
    if x.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    e = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"rmsnorm kernel takes bf16 x, got {x.dtype}")
    if weight.dtype != torch.float32 or weight.shape != (e,) \
            or weight.device != x.device or not weight.is_contiguous():
        raise ValueError("rmsnorm kernel takes a contiguous fp32 [E] weight "
                         f"on {x.device}, got {weight.dtype} "
                         f"{tuple(weight.shape)} on {weight.device}")
    if e % 8 or e > MAX_WIDTH:
        raise ValueError(f"rmsnorm kernel needs E % 8 == 0 and E <= "
                         f"{MAX_WIDTH}, got E={e}")
    x2 = x.reshape(-1, e)
    if not x2.is_contiguous():
        raise ValueError("rmsnorm kernel takes a contiguous x")
    out = torch.empty_like(x2)
    if x2.shape[0]:
        KERNEL.launch("rmsnorm_bf16", x2.data_ptr(), weight.data_ptr(),
                      out.data_ptr(), x2.shape[0], e, float(eps),
                      stream_of(x2))
    return out.reshape(x.shape)
