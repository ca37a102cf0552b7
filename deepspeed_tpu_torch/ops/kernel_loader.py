"""Build-at-first-use loader for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``build/kernels/``
at the repository root, named by a hash of the source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one
loads.  Every C entry point returns ``cudaGetLastError()``; the wrapper
raises on anything but 0.

A launch is on the host's critical path (a serving decode step makes
~130 of them), so the library's functions are bound once, when it
loads, and the stream handle is read raw from PyTorch's current stream,
never cached.

Nothing is compiled or loaded when a module is imported: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One ``.cu`` source -> one ``.so``.  ``functions`` maps each C
    entry point to its ctypes argument types (pointers and the stream as
    ``c_void_p``).  ``launches_by_fn`` counts the launches of each entry
    point that succeeded, and ``launches`` is their sum; only
    :meth:`launch` increments them.  ``copies`` counts operands the
    wrapper had to copy into a layout the kernel reads."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self.launches_by_fn: Dict[str, int] = dict.fromkeys(functions, 0)
        self.copies = 0
        self._lib: Optional[ctypes.CDLL] = None
        #: entry point -> its ctypes function, bound once from ``_lib``
        self._bound: Dict[str, Callable[..., int]] = {}
        #: compiler output of the last build in this process
        self.build_log = ""

    @property
    def launches(self) -> int:
        return sum(self.launches_by_fn.values())

    @property
    def name(self) -> str:
        return self.source.stem

    def _digest(self) -> str:
        h = hashlib.sha256()
        h.update(self.source.read_bytes())
        for hdr in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(hdr.name.encode())
            h.update(hdr.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    @property
    def library_path(self) -> Path:
        return BUILD_DIR / f"{self.name}-{self._digest()}.so"

    def _start_build(self):
        """Start ``nvcc`` for a missing library; returns (process, the
        temporary output path) or None when the library exists."""
        out = self.library_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n"
                               f"{self.build_log}")
        # atomic: a concurrent builder of the same hash never sees a
        # partial library
        os.replace(tmp, self.library_path)

    def build(self) -> None:
        self._finish_build(self._start_build())

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if missing), its entry points
        bound."""
        if self._lib is None:
            self.build()
            self._lib = ctypes.CDLL(str(self.library_path))
        if not self._bound:
            self._bind()
        return self._lib

    def _bind(self) -> None:
        lib, bound = self._lib, {}
        for fn, argtypes in self.functions.items():
            f = bound[fn] = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.ds_error_string.argtypes = [ctypes.c_int]
        lib.ds_error_string.restype = ctypes.c_char_p
        self._bound = bound

    def launch(self, fn: str, *args) -> None:
        """Call entry point ``fn`` and raise on a non-zero CUDA error
        (a refused launch never runs and a later synchronize would not
        report it); count it only once it succeeded."""
        f = self._bound.get(fn)
        if f is None:
            self.lib()
            f = self._bound[fn]
        err = f(*args)
        if err:
            msg = self._lib.ds_error_string(err).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {err}: {msg}")
        self.launches_by_fn[fn] += 1

    def reset_counts(self) -> None:
        self.launches_by_fn = dict.fromkeys(self.functions, 0)
        self.copies = 0


def build_all(kernels: Iterable[CudaKernel]) -> List[str]:
    """Build every missing library with one ``nvcc`` per source, all
    started together; returns the build logs (``-Xptxas -v`` register
    and shared-memory reports)."""
    kernels = list(kernels)
    procs = [k._start_build() for k in kernels]
    errors = []
    for k, p in zip(kernels, procs):
        try:
            k._finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [k.build_log for k in kernels]


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device, read at
    every launch: it follows ``torch.cuda.stream(...)`` and a graph
    capture's stream.  (``torch.cuda.current_stream`` would build a
    ``Stream`` object per launch.)"""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
