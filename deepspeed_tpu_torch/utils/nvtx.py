"""Trace regions (counterpart of ``deepspeed_tpu/utils/nvtx.py``).

The JAX package labels host spans with XProf trace-me regions; here a
region is a ``torch.profiler.record_function`` (seen by
``torch.profiler``) and, on a machine with a card, an NVTX range
(``torch.cuda.nvtx``, seen by NVIDIA's tools).  :func:`start_trace` /
:func:`stop_trace` / :func:`trace` capture a ``torch.profiler`` trace of
the host and the card into ``log_dir`` (TensorBoard's trace format).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch


def _nvtx() -> bool:
    return torch.cuda.is_available()


def instrument_w_nvtx(fn):
    """Decorator: run ``fn`` inside a region named after it."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with nvtx_range(fn.__qualname__):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def nvtx_range(name: str):
    """Context-manager form of a :func:`range_push` / :func:`range_pop`
    pair."""
    range_push(name)
    try:
        yield
    finally:
        range_pop()


_tls = threading.local()


def _ranges() -> list:
    # per thread, like NVTX ranges
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def range_push(name: str):
    """Open a region (prefer :func:`nvtx_range`)."""
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    _ranges().append(rf)
    if _nvtx():
        torch.cuda.nvtx.range_push(name)


def range_pop():
    stack = _ranges()
    if stack:
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        stack.pop().__exit__(None, None, None)


_profiler = None


def start_trace(log_dir: str) -> None:
    """Begin a ``torch.profiler`` capture of the host (and the card, when
    there is one) that :func:`stop_trace` writes under ``log_dir``."""
    global _profiler
    acts = [torch.profiler.ProfilerActivity.CPU]
    if _nvtx():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _profiler = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    _profiler.start()


def stop_trace() -> None:
    global _profiler
    if _profiler is not None:
        _profiler.stop()
        _profiler = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed region into ``log_dir``."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()
