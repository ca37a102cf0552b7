"""Build-at-first-use for the host (CPU) ops: the offload optimizers and
the async file I/O.

Counterpart of the JAX package's ``ops/op_builder/builder.py``.  The sources
are the port's own copies under ``deepspeed_tpu_torch/csrc/host/``
(``adam/``, ``adagrad/``, ``lion/``, ``aio/`` and ``includes/``).  Each
op compiles with ``g++ -O3 -std=c++17 -shared -fPIC -pthread
-march=native`` into one shared library with a plain C interface, loaded
with ``ctypes`` under explicit prototypes.  Libraries land beside the
CUDA kernels' (``ops/kernel_loader.library_dir()``: ``build/kernels/``
at the repository root unless a compile cache moved it), named by a hash
of the sources, the headers, the flags, the compiler's version and the
host CPU, and renamed into place atomically, so processes that build one
library at once all load a whole file.  A failed build raises
:class:`OpBuilderError` with the compiler's output: nothing falls back to
a Python optimizer.

Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Dict, List, Type

from ...utils.logging import logger
from .. import kernel_loader

HOST_SRC_DIR = Path(__file__).resolve().parents[2] / "csrc" / "host"


class OpBuilderError(RuntimeError):
    pass


class OpBuilder:
    """Compile and load one named host op."""

    NAME: str = "base"
    #: sources relative to ``csrc/host/``
    SOURCES: List[str] = []

    _loaded: Dict[str, ctypes.CDLL] = {}
    _compiler_id_cache: Dict[str, str] = {}

    def absolute_sources(self) -> List[Path]:
        return [HOST_SRC_DIR / s for s in self.SOURCES]

    def include_dirs(self) -> List[Path]:
        return [HOST_SRC_DIR / "includes"]

    def cxx_args(self) -> List[str]:
        args = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
        if not os.environ.get("DS_TPU_DISABLE_NATIVE_SIMD"):
            args.append("-march=native")
        return args

    def compiler(self) -> str:
        return os.environ.get("CXX", "g++")

    def is_compatible(self) -> bool:
        from shutil import which
        return which(self.compiler()) is not None and \
            all(p.is_file() for p in self.absolute_sources())

    def _compiler_id(self) -> str:
        """The compiler's version and the host CPU: a ``-march=native``
        library runs only on the CPU it was built for."""
        cxx = self.compiler()
        cached = OpBuilder._compiler_id_cache.get(cxx)
        if cached is None:
            try:
                ver = subprocess.run([cxx, "--version"], capture_output=True,
                                     text=True).stdout.splitlines()[0]
            except Exception:
                ver = "unknown"
            cached = ver + "|" + platform.processor() + platform.machine()
            OpBuilder._compiler_id_cache[cxx] = cached
        return cached

    def _hash(self) -> str:
        h = hashlib.sha256()
        for src in self.absolute_sources():
            h.update(src.read_bytes())
        for inc_dir in self.include_dirs():
            for header in sorted(inc_dir.glob("*.h")):
                h.update(header.read_bytes())
        h.update(" ".join(self.cxx_args()).encode())
        h.update(self._compiler_id().encode())
        return h.hexdigest()[:16]

    def so_path(self) -> Path:
        return kernel_loader.library_dir() / f"{self.NAME}_{self._hash()}.so"

    def build(self) -> Path:
        out = self.so_path()
        if out.is_file():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp_out = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [self.compiler(), *self.cxx_args(),
               *(f"-I{inc}" for inc in self.include_dirs()),
               *(str(s) for s in self.absolute_sources()),
               "-o", str(tmp_out)]
        logger.info("building host op %s: %s", self.NAME, " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp_out.unlink(missing_ok=True)
            raise OpBuilderError(
                f"host build of {self.NAME} failed:\n{proc.stderr}")
        os.replace(tmp_out, out)        # atomic under concurrent builders
        return out

    def load(self) -> ctypes.CDLL:
        if self.NAME in OpBuilder._loaded:
            return OpBuilder._loaded[self.NAME]
        if not self.is_compatible():
            raise OpBuilderError(
                f"op {self.NAME} is not buildable here (missing compiler "
                f"or sources)")
        lib = ctypes.CDLL(str(self.build()))
        self._annotate(lib)
        OpBuilder._loaded[self.NAME] = lib
        return lib

    def _annotate(self, lib: ctypes.CDLL) -> None:
        """Attach argtypes/restype prototypes.  Subclasses override."""


_f32p = ctypes.POINTER(ctypes.c_float)


class CPUAdamBuilder(OpBuilder):
    NAME = "cpu_adam"
    SOURCES = ["adam/cpu_adam.cpp"]

    def _annotate(self, lib):
        lib.ds_cpu_adam_step.argtypes = [
            _f32p, _f32p, _f32p, _f32p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ]
        lib.ds_cpu_adam_step.restype = None
        lib.ds_simd_width.restype = ctypes.c_int


class CPUAdagradBuilder(OpBuilder):
    NAME = "cpu_adagrad"
    SOURCES = ["adagrad/cpu_adagrad.cpp"]

    def _annotate(self, lib):
        lib.ds_cpu_adagrad_step.argtypes = [
            _f32p, _f32p, _f32p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.ds_cpu_adagrad_step.restype = None


class CPULionBuilder(OpBuilder):
    NAME = "cpu_lion"
    SOURCES = ["lion/cpu_lion.cpp"]

    def _annotate(self, lib):
        lib.ds_cpu_lion_step.argtypes = [
            _f32p, _f32p, _f32p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.ds_cpu_lion_step.restype = None


class AsyncIOBuilder(OpBuilder):
    NAME = "async_io"
    SOURCES = ["aio/ds_aio.cpp"]

    def _annotate(self, lib):
        lib.ds_aio_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ds_aio_create.restype = ctypes.c_void_p
        lib.ds_aio_create2.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
        lib.ds_aio_create2.restype = ctypes.c_void_p
        lib.ds_aio_destroy.argtypes = [ctypes.c_void_p]
        lib.ds_aio_destroy.restype = None
        for fn in (lib.ds_aio_pread, lib.ds_aio_pwrite):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_int64, ctypes.c_int64]
            fn.restype = ctypes.c_int64
        lib.ds_aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ds_aio_wait.restype = ctypes.c_int64
        lib.ds_aio_wait_all.argtypes = [ctypes.c_void_p]
        lib.ds_aio_wait_all.restype = ctypes.c_int64


class NotImplementedBuilder(OpBuilder):
    """An op the JAX package leaves out, named so the registry says why
    instead of failing with a missing name."""
    NAME = "no_impl"
    SOURCES: List[str] = []
    REASON = "not implemented"

    def is_compatible(self) -> bool:
        return False

    def build(self):
        raise OpBuilderError(f"op {self.NAME!r}: {self.REASON}")

    def load(self):
        raise OpBuilderError(f"op {self.NAME!r}: {self.REASON}")


class EvoformerAttnBuilder(NotImplementedBuilder):
    NAME = "evoformer_attn"
    REASON = ("the DS4Science evoformer kernels are not ported (the JAX "
              "package has none); use ops.flash_attention over pair "
              "activations")


class SparseAttnBuilder(NotImplementedBuilder):
    NAME = "sparse_attn"
    REASON = ("legacy triton sparse attention is not ported (the JAX "
              "package has none); sliding-window attention covers the "
              "use cases")


class SpatialInferenceBuilder(NotImplementedBuilder):
    NAME = "spatial_inference"
    REASON = ("the diffusers spatial kernels are not ported (the JAX "
              "package has none)")


ALL_OPS: Dict[str, Type[OpBuilder]] = {
    cls.NAME: cls
    for cls in (CPUAdamBuilder, CPUAdagradBuilder, CPULionBuilder,
                AsyncIOBuilder, EvoformerAttnBuilder, SparseAttnBuilder,
                SpatialInferenceBuilder)
}


def get_op_builder(name: str) -> Type[OpBuilder]:
    try:
        return ALL_OPS[name]
    except KeyError:
        raise OpBuilderError(
            f"unknown op builder {name!r}; available: {sorted(ALL_OPS)}")


def create_op_builder(name: str) -> OpBuilder:
    return get_op_builder(name)()
