"""The flops profiler.

Counterpart of ``deepspeed_tpu/profiling/flops_profiler.py``
(``FlopsProfiler`` :98, ``get_model_profile`` :203, ``count_params``
:57).  The JAX profiler reads the compiled program's ``cost_analysis()``
and breaks it down by jaxpr equation; eager PyTorch has no compiled
program, so this one counts the operators a step dispatches with
``torch.utils.flop_counter.FlopCounterMode`` and breaks the total down by
operator.  The counter knows the matrix products and convolutions (and
what decomposes into them); the flash kernels are ``ctypes`` launches
the dispatcher never sees, so their operators (``flash_fwd_op`` and
``flash_bwd_op``) carry the formulas of ``ops/flash_attention.py``
(:data:`~..ops.flash_attention.FLOP_FORMULAS`: the attended pairs'
products, the backward at twice the forward).  What the counter leaves
out is elementwise work (norms, activations, the optimizer), which
XLA's total includes; so the two agree on the matrix products, not on
the total.

``summary()`` gives flops, the step's duration, flops/s and the model
flops utilisation against the H100's dense bf16 peak (989 TFLOP/s) on
the card, and None elsewhere.  Counting draws nothing random.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..tree import tree_leaves
from ..utils.logging import logger

#: dense bf16 peak flop/s by device name (public specs)
PEAK_FLOPS = {"H100": 989e12}


def _device_peak_flops(device=None) -> Optional[float]:
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_FLOPS.items():
        if key.lower() in name.lower():
            return peak
    return None


def _format_count(n: Optional[float], unit: str = "") -> str:
    if n is None:
        return "n/a"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= scale:
            return f"{n / scale:.2f} {suffix}{unit}"
    return f"{n:.2f} {unit}"


def count_params(params: Any) -> int:
    """The elements of every leaf of a tree of tensors or arrays."""
    return sum(int(np.prod(tuple(t.shape))) for t in tree_leaves(params))


def _counter() -> FlopCounterMode:
    from ..ops.flash_attention import FLOP_FORMULAS
    return FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class FlopsProfiler:
    """Count a step's flops, its parameters and its duration (JAX's
    ``start_profile`` / ``stop_profile`` / ``end_profile``,
    ``get_total_flops`` / ``get_total_params`` / ``get_total_duration``,
    ``summary`` and ``print_model_profile``).  Between
    :meth:`start_profile` and :meth:`stop_profile` every operator the
    process dispatches is counted."""

    def __init__(self, fn: Optional[Callable] = None, params: Any = None):
        self.fn = fn
        self.params = params
        self._flops = 0.0
        self._ops: Dict[str, float] = {}
        self._duration = 0.0
        self._mode: Optional[FlopCounterMode] = None

    def start_profile(self) -> None:
        if self._mode is None:
            self._mode = _counter()
            self._mode.__enter__()

    def stop_profile(self) -> None:
        if self._mode is None:
            return
        mode, self._mode = self._mode, None
        mode.__exit__(None, None, None)
        counts = mode.get_flop_counts().get("Global", {})
        self._ops = {str(op): float(n) for op, n in counts.items()}
        self._flops = float(sum(self._ops.values()))

    def profile(self, fn: Callable, *args, repeats: int = 3,
                **kwargs) -> Dict[str, Any]:
        """Count one call of ``fn``, then time ``repeats`` more."""
        self.start_profile()
        try:
            out = fn(*args, **kwargs)
        finally:
            self.stop_profile()
        del out
        _sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn(*args, **kwargs)
        _sync()
        self._duration = (time.perf_counter() - t0) / repeats
        return self.summary()

    def end_profile(self) -> None:
        self.stop_profile()
        self._flops, self._ops, self._duration = 0.0, {}, 0.0

    def get_total_flops(self, as_string: bool = False):
        return _format_count(self._flops, "FLOPs") if as_string \
            else self._flops

    def get_total_params(self, as_string: bool = False):
        n = count_params(self.params) if self.params is not None else 0
        return _format_count(n) if as_string else n

    def get_total_duration(self, as_string: bool = False):
        return (f"{self._duration * 1e3:.2f} ms" if as_string
                else self._duration)

    def summary(self) -> Dict[str, Any]:
        peak = _device_peak_flops()
        rate = self._flops / self._duration if self._duration else 0.0
        return {
            "flops": self._flops,
            "duration_s": self._duration,
            "flops_per_s": rate,
            "mfu": rate / peak if peak and self._duration else None,
            "params": self.get_total_params(),
            "top_ops": sorted(self._ops.items(), key=lambda kv: -kv[1])[:10],
        }

    def print_model_profile(self, profile_step: int = 0,
                            module_depth: int = -1, top_modules: int = 1,
                            detailed: bool = True,
                            output_file: Optional[str] = None) -> str:
        s = self.summary()
        lines = [
            "-" * 60,
            f"DeepSpeed-TPU-torch Flops Profiler (step {profile_step})",
            "-" * 60,
            f"params:               {_format_count(s['params'])}",
            f"fwd+bwd flops:        {_format_count(s['flops'], 'FLOPs')}",
            f"step latency:         {s['duration_s'] * 1e3:.2f} ms",
            f"achieved throughput:  {_format_count(s['flops_per_s'], 'FLOPS')}",
        ]
        if s["mfu"] is not None:
            lines.append(f"model flops util:     {s['mfu']:.1%}")
        if detailed and s["top_ops"]:
            lines.append("top operators (counted flops):")
            for name, n in s["top_ops"]:
                lines.append(f"  {name:<40} {_format_count(n, 'FLOPs')}")
        lines.append("-" * 60)
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w", encoding="utf-8") as fh:
                fh.write(report + "\n")
        else:
            logger.info("\n%s", report)
        return report


def get_model_profile(fn: Callable, args: Tuple = (),
                      kwargs: Optional[dict] = None, params: Any = None,
                      print_profile: bool = True, as_string: bool = False):
    """One profile of ``fn(*args, **kwargs)``: (flops, macs = flops / 2,
    params)."""
    prof = FlopsProfiler(params=params)
    prof.profile(fn, *args, **(kwargs or {}))
    if print_profile:
        prof.print_model_profile()
    flops = prof.get_total_flops(as_string)
    macs = (_format_count(prof.get_total_flops() / 2, "MACs") if as_string
            else prof.get_total_flops() / 2)
    return flops, macs, prof.get_total_params(as_string)
