"""Host Adam(W), Adagrad and Lion over fp32 buffers in host memory.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py``: the optimizer step
of offloaded leaves runs on the host CPU, in the SIMD C++ kernels of
``csrc/host/{adam,adagrad,lion}`` (built by ``ops/op_builder``), while the
card computes.  Buffers are flat C-contiguous fp32 numpy arrays, or
numpy views of CPU tensors (pinned ones included); each optimizer keeps
a per-key dict of fp32 slots and a step count, so the NVMe swapper and
the checkpoints treat every host optimizer alike.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from ..op_builder import CPUAdamBuilder


def _f32ptr(a: np.ndarray):
    # hard checks (not assert): a wrong-dtype buffer reinterpreted as fp32
    # by the C kernel corrupts training state silently
    if a.dtype != np.float32 or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"host optimizer buffers must be C-contiguous float32, got "
            f"{a.dtype} contiguous={a.flags['C_CONTIGUOUS']}")
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class _HostOptimizer:
    """Per-key dict-of-slots fp32 state and 1-based step counts.
    Subclasses define ``SLOTS`` and ``_apply``."""

    SLOTS: tuple = ()

    def __init__(self):
        self._steps: Dict[int, int] = {}
        self._state: Dict[int, Dict[str, np.ndarray]] = {}

    def state_for(self, key: int, n: int) -> Dict[str, np.ndarray]:
        if key not in self._state:
            self._state[key] = {slot: np.zeros(n, np.float32)
                                for slot in self.SLOTS}
            self._steps.setdefault(key, 0)
        return self._state[key]

    def step(self, key: int, params: np.ndarray, grads: np.ndarray,
             lr: Optional[float] = None) -> None:
        """In-place update of ``params`` (flat fp32) given flat fp32 grads."""
        if params.shape != grads.shape or params.ndim != 1:
            raise ValueError(
                f"expected matching flat shards, got params {params.shape} "
                f"grads {grads.shape}")
        state = self.state_for(key, params.size)
        self._steps[key] = self._steps.get(key, 0) + 1
        self._apply(state, params, grads,
                    lr if lr is not None else self.lr, self._steps[key])

    def _apply(self, state, params, grads, lr, step_count) -> None:
        raise NotImplementedError

    def state_dict(self):
        return {"steps": dict(self._steps),
                "state": {k: {n: v.copy() for n, v in s.items()}
                          for k, s in self._state.items()}}

    def load_state_dict(self, sd):
        self._steps = {int(k): int(v)
                       for k, v in sd.get("steps", {}).items()}
        self._state = {int(k): {n: np.asarray(v, np.float32)
                                for n, v in s.items()}
                       for k, s in sd["state"].items()}


class DeepSpeedCPUAdam(_HostOptimizer):
    """Multi-threaded SIMD Adam(W) over flat fp32 buffers."""

    SLOTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True):
        super().__init__()
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.adamw_mode = bool(adamw_mode)
        self.bias_correction = bool(bias_correction)
        self._lib = CPUAdamBuilder().load()

    def _apply(self, state, params, grads, lr, step_count):
        self._lib.ds_cpu_adam_step(
            _f32ptr(params), _f32ptr(grads), _f32ptr(state["exp_avg"]),
            _f32ptr(state["exp_avg_sq"]), params.size, step_count,
            lr, self.betas[0], self.betas[1], self.eps, self.weight_decay,
            int(self.adamw_mode), int(self.bias_correction))


class DeepSpeedCPUAdagrad(_HostOptimizer):
    """Host Adagrad."""

    SLOTS = ("exp_avg_sq",)

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0):
        from ..op_builder import CPUAdagradBuilder
        super().__init__()
        self.lr, self.eps, self.weight_decay = \
            float(lr), float(eps), float(weight_decay)
        self._lib = CPUAdagradBuilder().load()

    def _apply(self, state, params, grads, lr, step_count):
        self._lib.ds_cpu_adagrad_step(
            _f32ptr(params), _f32ptr(grads), _f32ptr(state["exp_avg_sq"]),
            params.size, lr, self.eps, self.weight_decay)


class DeepSpeedCPULion(_HostOptimizer):
    """Host Lion."""

    SLOTS = ("exp_avg",)

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        from ..op_builder import CPULionBuilder
        super().__init__()
        self.lr = float(lr)
        self.betas = (float(betas[0]), float(betas[1]))
        self.weight_decay = float(weight_decay)
        self._lib = CPULionBuilder().load()

    def _apply(self, state, params, grads, lr, step_count):
        self._lib.ds_cpu_lion_step(
            _f32ptr(params), _f32ptr(grads), _f32ptr(state["exp_avg"]),
            params.size, lr, self.betas[0], self.betas[1], self.weight_decay)
