"""CUDA accelerator: the counterpart of
``deepspeed_tpu/accelerator/tpu_accelerator.py`` over ``torch.cuda``
(memory statistics from the caching allocator and ``mem_get_info``,
streams, events, graphs, synchronisation)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CUDA_Accelerator(DeepSpeedAccelerator):
    _name = "cuda"
    _communication_backend_name = "nccl"

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def current_device(self) -> Any:
        return torch.device("cuda", torch.cuda.current_device())

    def synchronize(self, tree: Any = None) -> None:
        torch.cuda.synchronize()

    def memory_stats(self, device_index: int | None = None) -> Dict[str, int]:
        """The JAX keys (``bytes_in_use``, ``peak_bytes_in_use``,
        ``bytes_limit``) beside the caching allocator's
        ``bytes_reserved`` and ``mem_get_info``'s ``bytes_free``."""
        dev = torch.device("cuda", device_index or 0)
        free, total = torch.cuda.mem_get_info(dev)
        return {"bytes_in_use": torch.cuda.memory_allocated(dev),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
                "bytes_limit": total,
                "bytes_reserved": torch.cuda.memory_reserved(dev),
                "bytes_free": free}

    def empty_cache(self) -> None:
        torch.cuda.empty_cache()

    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_bf16_supported()

    def is_triton_supported(self) -> bool:
        return torch.cuda.get_device_capability()[0] >= 8

    # -- streams, events and graphs --------------------------------------
    Stream = torch.cuda.Stream
    Event = torch.cuda.Event

    def stream(self, stream):
        return torch.cuda.stream(stream)

    def current_stream(self, device_index: int | None = None):
        return torch.cuda.current_stream(device_index)

    def default_stream(self, device_index: int | None = None):
        return torch.cuda.default_stream(device_index)

    def create_graph(self):
        return torch.cuda.CUDAGraph()
