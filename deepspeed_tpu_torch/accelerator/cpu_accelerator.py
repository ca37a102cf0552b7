"""CPU accelerator (counterpart of
``deepspeed_tpu/accelerator/cpu_accelerator.py``): the host, where the
port's tests run the kernels' plain versions.  Memory statistics are the
process's peak resident set, as in JAX."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CPU_Accelerator(DeepSpeedAccelerator):
    _name = "cpu"
    _communication_backend_name = "gloo"

    def is_synchronized_device(self) -> bool:
        return True

    def device_count(self) -> int:
        return 1

    def current_device(self) -> Any:
        return torch.device("cpu")

    def memory_stats(self, device_index: int | None = None) -> Dict[str, int]:
        try:
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            return {"bytes_in_use": peak, "peak_bytes_in_use": peak}
        except Exception:
            return {}
