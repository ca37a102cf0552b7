"""Accelerator abstraction (counterpart of
``deepspeed_tpu/accelerator/abstract_accelerator.py``).

The JAX package's interface: identity, device counts, memory statistics
(``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``), dtype
support, RNG, synchronisation, backend naming, trace regions and the four
behaviour flags the reference runtime consults.  The CUDA accelerator
adds the streams, events and graphs that the JAX package leaves to XLA.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List


class DeepSpeedAccelerator(abc.ABC):
    _name: str = "abstract"
    _communication_backend_name: str = "gloo"

    # -- behaviour flags (reference abstract_accelerator.py:17-31) --------
    def is_synchronized_device(self) -> bool:
        return False

    def use_host_timers(self) -> bool:
        return self.is_synchronized_device()

    def resolves_data_dependency(self) -> bool:
        return self.is_synchronized_device()

    def handles_memory_backpressure(self) -> bool:
        return self.is_synchronized_device()

    # -- identity ---------------------------------------------------------
    def device_name(self, device_index: int | None = None) -> str:
        if device_index is None:
            return self._name
        return f"{self._name}:{device_index}"

    def communication_backend_name(self) -> str:
        return self._communication_backend_name

    @abc.abstractmethod
    def device_count(self) -> int:
        ...

    @abc.abstractmethod
    def current_device(self) -> Any:
        ...

    # -- synchronisation --------------------------------------------------
    def synchronize(self, tree: Any = None) -> None:
        """Wait for the device's queued work (``tree`` is accepted for
        the JAX signature: eager tensors need no per-value wait)."""

    # -- RNG --------------------------------------------------------------
    def default_generator(self, seed: int = 0):
        import torch
        return torch.Generator(device=self.current_device()).manual_seed(
            int(seed))

    def manual_seed(self, seed: int):
        return self.default_generator(seed)

    # -- memory -----------------------------------------------------------
    @abc.abstractmethod
    def memory_stats(self, device_index: int | None = None) -> Dict[str, int]:
        ...

    def available_memory(self, device_index: int | None = None) -> int:
        stats = self.memory_stats(device_index)
        return stats.get("bytes_limit", 0) - stats.get("bytes_in_use", 0)

    def total_memory(self, device_index: int | None = None) -> int:
        return self.memory_stats(device_index).get("bytes_limit", 0)

    def memory_allocated(self, device_index: int | None = None) -> int:
        return self.memory_stats(device_index).get("bytes_in_use", 0)

    def max_memory_allocated(self, device_index: int | None = None) -> int:
        return self.memory_stats(device_index).get("peak_bytes_in_use", 0)

    def empty_cache(self) -> None:
        pass

    # -- dtype support ----------------------------------------------------
    def is_bf16_supported(self) -> bool:
        return True

    def is_fp16_supported(self) -> bool:
        return True

    def is_triton_supported(self) -> bool:
        return False

    def supported_dtypes(self) -> List[str]:
        return ["float32", "bfloat16", "float16", "int8", "float8_e4m3fn",
                "float8_e5m2"]

    # -- trace regions (reference range_push/pop, :190-194) ---------------
    def range_push(self, name: str) -> None:
        from ..utils.nvtx import range_push
        range_push(name)

    def range_pop(self) -> None:
        from ..utils.nvtx import range_pop
        range_pop()

    # -- graphs -----------------------------------------------------------
    def create_graph(self):
        raise NotImplementedError(f"the {self._name} accelerator captures "
                                  "no graphs")

    # -- op builder dispatch ---------------------------------------------
    def op_builder_dir(self) -> str:
        return "deepspeed_tpu_torch.ops.op_builder"
