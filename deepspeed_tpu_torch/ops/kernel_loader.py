"""Build-at-first-use loader for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``build/kernels/``
at the repository root (or the serving compile cache's directory,
``set_library_dir``), named by a hash of the source, the shared headers
and the flags, so an edited source rebuilds and an unchanged one loads;
``library_counts`` counts the libraries loaded from disk (hits) and
built (misses).  Every C entry point returns ``cudaGetLastError()``; the
wrapper raises on anything but 0.

A launch is on the host's critical path (a serving decode step makes
~130 of them), so the library's functions are bound once, when it
loads, and the stream handle is read raw from PyTorch's current stream,
never cached.

Launch counts count kernels that ran.  A CUDA graph's capture enqueues
each kernel once and runs none, and its replays run them all without
calling a wrapper: :class:`CountedGraph` takes back what its capture
counted and adds it again at every replay.

Nothing is compiled or loaded when a module is imported: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: ``-split-compile=0``: nvcc optimises a source's device functions on
#: every core (``paged_attention.cu``'s 160 instances: about 45 s instead
#: of 105 on an 8-core H100 host, with the same ptxas reports)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")

#: where libraries are built and loaded (None: BUILD_DIR)
_library_dir: Optional[Path] = None
#: libraries loaded that this process did not build, and built
library_counts = {"hits": 0, "misses": 0}
_built_here: set = set()


def set_library_dir(path) -> None:
    """Build and load libraries under ``path`` from now on (None: the
    default ``BUILD_DIR``).  A library already loaded stays loaded."""
    global _library_dir
    _library_dir = Path(path) if path is not None else None


def library_dir() -> Path:
    return _library_dir if _library_dir is not None else BUILD_DIR


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
        _KERNELS.add(self)

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
        return library_dir() / f"{self.name}-{self._digest()}.so"

    def _start_build(self):
        """Start ``nvcc`` for a missing library; returns (process, the
        temporary output path) or None when the library exists."""
        out = self.library_path
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
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
        _built_here.add(str(self.library_path))
        library_counts["misses"] += 1

    def build(self) -> None:
        self._finish_build(self._start_build())

    def lib(self) -> ctypes.CDLL:
        """The loaded library (built first if missing), its entry points
        bound."""
        if self._lib is None:
            self.build()
            path = str(self.library_path)
            self._lib = ctypes.CDLL(path)
            if path not in _built_here:
                library_counts["hits"] += 1
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
        with COUNT_LOCK:
            self.launches_by_fn[fn] += 1

    def reset_counts(self) -> None:
        self.launches_by_fn = dict.fromkeys(self.functions, 0)
        self.copies = 0


#: every CudaKernel of the process, for :class:`CountedGraph`
_KERNELS: "weakref.WeakSet[CudaKernel]" = weakref.WeakSet()

#: guards every launch count: replicas step from threads of their own
#: (``serving.ReplicaPool.start``), and a capture takes back the counts it
#: made, so no other thread's count may land between its snapshot and
#: its restore
COUNT_LOCK = threading.RLock()

#: launch counts of every kernel: (kernel, {entry point: launches})
Launches = List[Tuple[CudaKernel, Dict[str, int]]]


def snapshot_launches() -> Launches:
    return [(k, dict(k.launches_by_fn)) for k in _KERNELS]


def launches_since(before: Launches) -> Launches:
    """The launches counted since ``before`` (its kernels only)."""
    out = []
    for k, counts in before:
        delta = {fn: k.launches_by_fn[fn] - n for fn, n in counts.items()
                 if k.launches_by_fn[fn] != n}
        if delta:
            out.append((k, delta))
    return out


def restore_launches(before: Launches) -> None:
    for k, counts in before:
        k.launches_by_fn.update(counts)


def add_launches(delta: Launches) -> None:
    with COUNT_LOCK:
        for k, counts in delta:
            for fn, n in counts.items():
                k.launches_by_fn[fn] += n


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count kernel launches.

    :meth:`capture` runs ``fn(*args)`` once eagerly on the capture
    stream (``stream``, else a new one) first (cuBLAS workspaces, kernel modules and function
    attributes are set up there, never inside a capture; those launches
    ran and stay counted), then captures it into the graph, over
    ``pool`` when given (a ``torch.cuda.graph_pool_handle()`` that
    graphs share).  The launches the capture counted are taken back and
    kept in :attr:`launches`; :meth:`replay` adds them every time it
    runs the graph.  ``generator``, a CUDA ``torch.Generator``, is
    registered with the graph: each replay draws new numbers from it and
    advances its offset.  The cyclic garbage collector is off during the
    capture.  The capture's error mode is ``thread_local``: another
    thread's CUDA work (a replica stepping its own engine) neither fails
    nor joins it, and ``COUNT_LOCK`` keeps that thread's launch counts
    out of it.  A failed capture raises; nothing falls back to eager."""

    def __init__(self, pool=None, generator=None, stream=None):
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.generator = generator
        self.stream = stream
        #: the launches one replay runs
        self.launches: Launches = []
        #: what ``fn`` returned inside the capture; every replay rewrites
        #: it in place
        self.output = None

    def capture(self, fn, *args):
        stream = self.stream if self.stream is not None \
            else torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*args)
        torch.cuda.current_stream().wait_stream(stream)
        if self.generator is not None:
            self.graph.register_generator_state(self.generator)
        # no cyclic collection inside the capture: a dead cycle holding a
        # CUDA graph, an event or a pinned block (a model of an earlier
        # engine, say) would be freed mid-capture, and that call would
        # invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        with COUNT_LOCK:
            before = snapshot_launches()
            try:
                with torch.cuda.graph(self.graph, pool=self.pool,
                                      stream=stream,
                                      capture_error_mode="thread_local"):
                    self.output = fn(*args)
                self.launches = launches_since(before)
            finally:
                restore_launches(before)
                if collecting:
                    gc.enable()
        return self.output

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


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
