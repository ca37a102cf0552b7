"""Persistent kernel-library cache for serving: graph warmth across
processes.

Counterpart of ``deepspeed_tpu/inference/v2/compile_cache.py``, with its
API.  The JAX package points XLA's persistent compilation cache at
``serving.compile_cache_dir`` / ``DS_COMPILE_CACHE``, so a second process
loads its step programs from disk.  What the port can carry from one
process to the next is different: a CUDA graph lives and dies with its
process, so every step key is captured again; what a process can load
instead of building is its kernel libraries (``ops/kernel_loader.py``,
one ``nvcc`` build per ``csrc`` source).  So the cache directory is where
the loader builds and loads them.

The directory is namespaced by a digest over what a library depends on:
the ``csrc`` sources and headers, the ``nvcc`` flags (the target arch),
the ``nvcc`` version and the torch and CUDA versions.  The JAX digest
instead hashes the engine's configuration (model, KV geometry, lattice,
keyed sampling), because an XLA program depends on it; a kernel library
does not, so engines of any configuration share one namespace here.

Counted: a library loaded from the directory is a hit, one built a miss
(``kernel_loader.library_counts``); graph captures are counted apart by
the model, ``precompile_captures`` and ``path_captures`` (on the request
path, which the workload trace records).  An uncreatable or unwritable
directory warns and leaves the loader at its default ``build/kernels/``:
the kernels are still built and launched.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import warnings
from typing import Optional

from ...ops import kernel_loader

#: the active cache path (None: the loader's default directory)
_active_dir: Optional[str] = None


def _nvcc_version() -> str:
    """``nvcc --version``, or "" where there is no nvcc (nothing is
    built there)."""
    try:
        return subprocess.run([kernel_loader._nvcc(), "--version"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return ""


def compile_config_digest(nvcc_version: Optional[str] = None) -> str:
    """The digest that namespaces the kernel libraries: the sources and
    headers, the nvcc flags, the nvcc version (``nvcc_version``, default:
    the one on this machine) and the torch and CUDA versions."""
    import torch
    h = hashlib.sha256()
    for path in sorted(kernel_loader.CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    facts = {
        "sources": h.hexdigest(),
        "flags": list(kernel_loader.NVCC_FLAGS),
        "nvcc": (_nvcc_version() if nvcc_version is None
                 else nvcc_version),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
    }
    return hashlib.blake2b(json.dumps(facts, sort_keys=True).encode("utf-8"),
                           digest_size=10).hexdigest()


def enable_compile_cache(cache_dir: str,
                         digest: Optional[str] = None) -> Optional[str]:
    """Build and load the kernel libraries under ``<cache_dir>/<digest>``
    (created if missing; ``digest`` defaults to
    :func:`compile_config_digest`).  Returns that path, or None with a
    warning when it cannot be created or written: the loader then keeps
    its default directory."""
    global _active_dir
    path = os.path.join(cache_dir, digest or compile_config_digest())
    if _active_dir is not None and _active_dir != path:
        # the loader's directory is per process: the last engine built
        # decides where later builds land
        warnings.warn(f"compile cache retargeted {_active_dir} -> {path}: "
                      "the library directory is process-wide")
    try:
        os.makedirs(path, exist_ok=True)
        probe = os.path.join(path, ".ds_probe")
        with open(probe, "w") as f:
            f.write("ok")
        os.unlink(probe)
    except OSError as e:
        warnings.warn(f"compile cache disabled: {path} is not a writable "
                      f"directory ({type(e).__name__}: {e}); kernel "
                      "libraries build into the default directory")
        return None
    kernel_loader.set_library_dir(path)
    _active_dir = path
    return path


def disable_compile_cache() -> None:
    """Back to the loader's default directory."""
    global _active_dir
    kernel_loader.set_library_dir(None)
    _active_dir = None


def active_cache_dir() -> Optional[str]:
    return _active_dir


def counters_available() -> bool:
    """Whether the hit and miss counts are fed: the loader counts every
    library it loads or builds, so always."""
    return True


def cache_dir_from_env_or_config(config_dir: str) -> str:
    """``DS_COMPILE_CACHE`` in the environment wins over the config."""
    return os.environ.get("DS_COMPILE_CACHE", "") or (config_dir or "")
