"""Memory introspection: the card's allocator statistics and the host's
peak RSS.

Counterpart of ``deepspeed_tpu/utils/memory.py``.  ``device_memory_report``
reads ``torch.cuda.memory_stats`` (bytes in use, the peak, and the card's
total as the limit); on the CPU it reports the host's peak RSS as
``bytes_in_use`` and no limit, as the JAX accelerator does.
``see_memory_usage`` logs both sides and returns the numbers in GB.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..accelerator import DeviceLike, resolve_device
from .logging import logger

_GB = 1024 ** 3


def host_peak_rss_bytes() -> int:
    """The process's PEAK resident set size (``ru_maxrss``): a high-water
    mark, not current usage; it never decreases."""
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # pragma: no cover - non-POSIX
        return 0


def device_memory_report(device: DeviceLike = None) -> Dict[str, int]:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` of the
    card (``device`` None: the current one); on the CPU the host's peak
    RSS stands for both in-use numbers and there is no limit."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        peak = host_peak_rss_bytes()
        return {"bytes_in_use": peak, "peak_bytes_in_use": peak}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev).total_memory)}


def see_memory_usage(message: str, force: bool = False,
                     device: DeviceLike = None) -> Dict[str, float]:
    """Log the card's and the host's memory around ``message``; returns
    the numbers (GB) it printed."""
    del force  # parity argument: the reference gates on a global
    dev = device_memory_report(device)
    out = {
        "device_in_use_gb": dev.get("bytes_in_use", 0) / _GB,
        "device_peak_gb": dev.get("peak_bytes_in_use", 0) / _GB,
        "device_limit_gb": dev.get("bytes_limit", 0) / _GB,
        "host_peak_rss_gb": host_peak_rss_bytes() / _GB,
    }
    logger.info(
        f"{message} | device in use {out['device_in_use_gb']:.2f}GB "
        f"(peak {out['device_peak_gb']:.2f}GB / "
        f"limit {out['device_limit_gb']:.2f}GB) | "
        f"host peak RSS {out['host_peak_rss_gb']:.2f}GB")
    return out
