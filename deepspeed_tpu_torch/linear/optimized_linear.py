"""OptimizedLinear: LoRA adapters over a frozen, optionally quantised base.

Counterpart of ``deepspeed_tpu/linear/optimized_linear.py`` (``LoRAConfig``
:29, ``QuantizationConfig`` :37, ``OptimizedLinear`` :60,
``lora_trainable_mask`` :173), with the same functional API: ``init``
builds the parameter dict, ``apply`` is the forward, ``merge`` folds the
adapter into a dense weight.  The frozen base is stored whole, or
blockwise int8 (``ops/quantization.py`` ``quantize_blockwise`` /
``dequantize_blockwise``: on the card the quantise and dequantise
kernels of ``csrc/quantization.cu``, the twins of the Pallas
``_quant_kernel`` / ``_dequant_kernel``), or in a low-precision float
format (``ops/fp_quantizer.py``); every forward dequantises it.  Only
the adapters (and the bias) train: ``init`` leaves ``requires_grad``
off on the base, as the reference does, where JAX masks the base out of
the optimizer (``trainable_mask``, which the port keeps).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..accelerator import DeviceLike, resolve_device
from ..ops.quantization import dequantize_blockwise, quantize_blockwise

#: the leaves that train
TRAINABLE = ("lora_a", "lora_b", "bias")


@dataclasses.dataclass
class LoRAConfig:
    lora_r: int = 64
    lora_alpha: float = 16.0
    #: shard the base over this many ranks (one rank: the whole base)
    base_weight_sharding: int = 1


@dataclasses.dataclass
class QuantizationConfig:
    """``q_dtype`` "int8" is the blockwise int8 path (the quantisation
    kernels); "fp8_e4m3", "fp8_e5m2", "fp6_e3m2" and "fp4_e2m1" store the
    base in that float format (``ops/fp_quantizer.py``)."""
    q_bits: int = 8
    mantissa_bits: int = 3   # accepted for config parity
    group_size: int = 512
    q_dtype: str = "int8"

    def resolved_dtype(self) -> str:
        """int8 covers q_bits 8 only; q_bits 6 or 4 resolve to the float
        format of that width, as in JAX."""
        if self.q_dtype == "int8" and self.q_bits != 8:
            from ..ops.fp_quantizer import _BITS_TO_FORMAT
            return _BITS_TO_FORMAT[self.q_bits]
        return self.q_dtype


class OptimizedLinear:
    """One linear layer's parameters and forward.

    >>> lin = OptimizedLinear(256, 512, lora_config=LoRAConfig(lora_r=8))
    >>> params = lin.init(0, device="cpu")
    >>> y = lin.apply(params, x)
    """

    def __init__(self, input_dim: int, output_dim: int,
                 lora_config: Optional[LoRAConfig] = None,
                 quantization_config: Optional[QuantizationConfig] = None,
                 bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.lora = lora_config
        self.quant = quantization_config
        self.bias = bias
        self.dtype = dtype
        if self.lora is not None and self.lora.lora_r > min(
                input_dim, output_dim):
            raise ValueError(
                f"lora_r {self.lora.lora_r} exceeds min(in,out)="
                f"{min(input_dim, output_dim)}")

    # ----------------------------------------------------------- params
    def init(self, seed: int = 0, base_weight: Optional[torch.Tensor] = None,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """The parameter dict: ``base`` (or ``base_q`` / ``base_scale``),
        ``lora_a`` ~ N(0, 1/in), ``lora_b`` = 0 (the adapter starts as a
        no-op) and ``bias`` = 0.  Without ``base_weight`` the base is
        uniform in ±1/sqrt(in), fp32, drawn from ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        scale = 1.0 / math.sqrt(self.input_dim)
        if base_weight is None:
            base_weight = torch.empty(
                (self.input_dim, self.output_dim), dtype=torch.float32
            ).uniform_(-scale, scale, generator=gen)
        base_weight = torch.as_tensor(base_weight).to(dev)
        params: Dict[str, torch.Tensor] = {}
        if self.quant is not None:
            fmt = self.quant.resolved_dtype()
            if fmt != "int8":
                from ..ops import fp_quantizer
                q, s, pad = fp_quantizer.quantize(
                    base_weight, group_size=self.quant.group_size, fmt=fmt)
            else:
                q, s, pad = quantize_blockwise(
                    base_weight.float().contiguous(),
                    block=self.quant.group_size)
            # pad follows from the shape: kept out of the tree
            assert pad == self._static_pad(), (pad, self._static_pad())
            params["base_q"] = q
            params["base_scale"] = s
        else:
            params["base"] = base_weight.to(self.dtype)
        if self.lora is not None:
            a = torch.randn((self.input_dim, self.lora.lora_r),
                            generator=gen) * scale
            params["lora_a"] = a.to(dev, self.dtype)
            params["lora_b"] = torch.zeros(
                (self.lora.lora_r, self.output_dim), dtype=self.dtype,
                device=dev)
        if self.bias:
            params["bias"] = torch.zeros((self.output_dim,),
                                         dtype=self.dtype, device=dev)
        for name, t in params.items():
            t.requires_grad_(name in TRAINABLE)
        return params

    # ---------------------------------------------------------- forward
    def _static_pad(self) -> int:
        n = self.input_dim * self.output_dim
        block = self.quant.group_size
        return (block - n % block) % block

    def _base_weight(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "base_q" in params:
            shape = (self.input_dim, self.output_dim)
            fmt = self.quant.resolved_dtype()
            if fmt != "int8":
                from ..ops import fp_quantizer
                return fp_quantizer.dequantize(
                    params["base_q"], params["base_scale"],
                    self._static_pad(), shape, dtype=self.dtype)
            return dequantize_blockwise(params["base_q"],
                                        params["base_scale"],
                                        self._static_pad(), shape,
                                        dtype=self.dtype)
        return params["base"]

    def apply(self, params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
        w = self._base_weight(params).to(self.dtype)
        xc = x.to(self.dtype)
        y = xc @ w
        if self.lora is not None:
            scaling = self.lora.lora_alpha / self.lora.lora_r
            y = y + (xc @ params["lora_a"]) @ params["lora_b"] * scaling
        if self.bias:
            y = y + params["bias"]
        return y

    __call__ = apply

    # -------------------------------------------------------- train mask
    def trainable_mask(self, params: Dict[str, Any]) -> Dict[str, bool]:
        """True for the adapter and bias leaves only: the base is
        frozen."""
        return {k: k in TRAINABLE for k in params}

    def merge(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The adapter folded into a dense fp32 weight (export and
        inference)."""
        w = self._base_weight(params).float()
        if self.lora is not None:
            scaling = self.lora.lora_alpha / self.lora.lora_r
            w = w + params["lora_a"].float() @ params["lora_b"].float() \
                * scaling
        return w


def lora_trainable_mask(params: Any, _name: str = "") -> Any:
    """Tree-wide mask over nested dicts and lists: only ``lora_a`` /
    ``lora_b`` / ``bias`` leaves train."""
    if isinstance(params, dict):
        return {k: lora_trainable_mask(v, str(k)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(lora_trainable_mask(v) for v in params)
    return _name in TRAINABLE
