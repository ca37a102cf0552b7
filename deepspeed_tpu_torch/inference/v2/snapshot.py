"""Serving snapshot bundles and the SIGTERM drain trigger.

Counterpart of ``deepspeed_tpu/inference/v2/snapshot.py``, and its
bundles are the same bytes: a bundle written by either package reads in
the other.  A bundle holds everything ``FastGenScheduler.snapshot()``
serializes (requests, the base key, KV page contents, the prefix-cache
index, counters, errors) as one atomic, versioned, checksummed file::

    MAGIC "DSSNAP01" | blake2b-16(body) | body
    body = u64 meta_len | u64 payload_len | meta JSON | npz payload

The checksum covers meta and payload, so a truncated or corrupted file
fails :func:`read_bundle` with :class:`SnapshotError`.  Arrays numpy
cannot hold (bf16 KV pages) travel as raw bytes behind a (dtype, shape)
manifest, as in the JAX package; this module reads them back as torch
tensors, so neither side needs the other's dtype library.  The write is
atomic (a tmp file in the same directory, fsync, rename, retried on
``OSError``), so a failure midway leaves the previous bundle readable.
``install_drain_handler`` wires SIGTERM (with ``DS_DRAIN_ON_SIGTERM=1``:
``maybe_install_drain_handler``) to ``drain_and_snapshot`` on the newest
scheduler and then chains to the handler it replaced.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import signal
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

MAGIC = b"DSSNAP01"
SNAPSHOT_VERSION = 1
_DIGEST_SIZE = 16
_HEADER = struct.Struct("<QQ")


class SnapshotError(RuntimeError):
    """A bundle could not be written, read or applied: a corrupt or
    truncated file, another version, a KV geometry or draft-trunk
    mismatch, or a restore target that is not fresh.  A restore never
    resumes from partial state."""


#: manifest key of the arrays numpy cannot hold natively
_SPECIAL_DTYPES = "__special_dtypes__"
#: dtype name in the manifest -> the torch dtype this package reads it as
_TORCH_SPECIAL = {"bfloat16": torch.bfloat16,
                  "float8_e4m3fn": torch.float8_e4m3fn,
                  "float8_e5m2": torch.float8_e5m2}
_TORCH_NAMES = {v: k for k, v in _TORCH_SPECIAL.items()}

Array = Any         # a numpy array or a torch tensor


def _encode_arrays(arrays: Dict[str, Array]) -> Dict[str, np.ndarray]:
    """The npz-safe projection: numpy dtypes pass through (a torch tensor
    as its host numpy view), the others travel as flat uint8 bytes plus
    a (dtype, shape) manifest entry, byte for byte as the JAX package
    writes them."""
    enc, special = {}, {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().contiguous()
            name = _TORCH_NAMES.get(v.dtype)
            if name is not None:
                special[k] = {"dtype": name, "shape": list(v.shape)}
                enc[k] = v.reshape(-1).view(torch.uint8).numpy()
                continue
            v = v.numpy()
        v = np.asarray(v)
        if v.dtype.type.__module__ == "numpy":
            enc[k] = v
        else:
            special[k] = {"dtype": v.dtype.name, "shape": list(v.shape)}
            enc[k] = np.frombuffer(v.tobytes(), dtype=np.uint8)
    if special:
        enc[_SPECIAL_DTYPES] = np.frombuffer(
            json.dumps(special).encode("utf-8"), dtype=np.uint8)
    return enc


def _decode_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, Array]:
    manifest = arrays.pop(_SPECIAL_DTYPES, None)
    if manifest is None:
        return arrays
    try:
        special = json.loads(manifest.tobytes().decode("utf-8"))
        for k, spec in special.items():
            dtype = _TORCH_SPECIAL[spec["dtype"]]
            raw = torch.from_numpy(np.ascontiguousarray(arrays[k]))
            arrays[k] = raw.view(dtype).reshape(spec["shape"])
    except Exception as e:
        raise SnapshotError(f"bundle dtype manifest undecodable: {e!r}")
    return arrays


def _bundle_segments(meta: dict, arrays: Dict[str, Array]) -> list:
    """The bundle as its buffers in order (magic, digest, header, meta,
    payload): written one after another, never concatenated (a bundle is
    the size of the KV pages it carries)."""
    buf = io.BytesIO()
    np.savez(buf, **_encode_arrays(arrays))
    payload = buf.getbuffer()
    meta_b = json.dumps(meta).encode("utf-8")
    header = _HEADER.pack(len(meta_b), len(payload))
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    for seg in (header, meta_b, payload):
        h.update(seg)
    return [MAGIC, h.digest(), header, meta_b, payload]


def pack_bundle(meta: dict, arrays: Dict[str, Array]) -> bytes:
    """(meta, arrays) in the checksummed wire format, as one bytes
    object."""
    return b"".join(_bundle_segments(meta, arrays))


def unpack_bundle(data) -> Tuple[dict, Dict[str, Array]]:
    """Validate and decode the wire format; :class:`SnapshotError` on
    any inconsistency."""
    if len(data) < len(MAGIC) + _DIGEST_SIZE + _HEADER.size:
        raise SnapshotError(
            f"bundle too short ({len(data)} bytes): truncated?")
    mv = memoryview(data)
    if bytes(mv[:len(MAGIC)]) != MAGIC:
        raise SnapshotError("not a serving snapshot bundle (bad magic)")
    digest = bytes(mv[len(MAGIC):len(MAGIC) + _DIGEST_SIZE])
    body = mv[len(MAGIC) + _DIGEST_SIZE:]
    if hashlib.blake2b(body, digest_size=_DIGEST_SIZE).digest() != digest:
        raise SnapshotError("bundle checksum mismatch: truncated or "
                            "corrupted")
    meta_len, payload_len = _HEADER.unpack_from(body)
    if len(body) != _HEADER.size + meta_len + payload_len:
        raise SnapshotError(
            f"bundle length inconsistent (header says {meta_len}+"
            f"{payload_len}, body has {len(body) - _HEADER.size})")
    try:
        meta = json.loads(bytes(body[_HEADER.size:_HEADER.size + meta_len]))
    except ValueError as e:
        raise SnapshotError(f"bundle meta is not valid JSON: {e}")
    version = meta.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"unsupported snapshot version {version!r} (this build reads "
            f"{SNAPSHOT_VERSION})")
    payload = body[_HEADER.size + meta_len:]
    try:
        with np.load(io.BytesIO(payload), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:
        raise SnapshotError(f"bundle payload undecodable: {e!r}")
    return meta, _decode_arrays(arrays)


def write_bundle(path: str, meta: dict, arrays: Dict[str, Array],
                 retries: int = 3, backoff_s: float = 0.05) -> str:
    """Write a bundle atomically (tmp file, fsync, rename; the tmp file
    removed on failure), retried on ``OSError`` with doubling backoff:
    the checkpoint engine's helpers.  The ``ckpt.io_error`` fault site
    fires inside the write, so a failure midway leaves the previous
    bundle at ``path`` readable."""
    from ...checkpoint.engine import _atomic_write_bytes, with_retries
    from ...runtime.fault_injection import (InjectedCheckpointFault,
                                            get_fault_injector)
    segments = _bundle_segments(meta, arrays)

    def _write():
        get_fault_injector().maybe_raise(
            "ckpt.io_error", InjectedCheckpointFault,
            "injected I/O error writing serving snapshot")
        _atomic_write_bytes(path, segments)

    with_retries("snapshot", _write, retries, backoff_s)
    return path


def read_bundle(path: str) -> Tuple[dict, Dict[str, Array]]:
    """Read and validate a bundle; :class:`SnapshotError` on anything
    less than a complete, checksummed file of this version."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotError(f"cannot read bundle {path}: {e}")
    return unpack_bundle(data)


# -- the trigger: SIGTERM drain and snapshot ---------------------------------

_drain_installed = False
#: (weak reference to the newest scheduler, bundle path, grace): read
#: when the signal arrives, so a scheduler built later (a restore in the
#: same process) takes over the handler, and a dropped one is not kept
#: alive by it
_drain_target: Optional[tuple] = None


def install_drain_handler(scheduler, path: str,
                          grace_s: Optional[float] = None) -> bool:
    """Install (once a process) a SIGTERM handler that runs
    ``drain_and_snapshot(path, grace_s)`` on the most recently registered
    scheduler, then calls the handler it replaced (or, where that was the
    default, re-delivers the signal so the process still dies by it).
    A later call retargets the handler.  Returns False where no handler
    can be installed (off the main thread)."""
    global _drain_installed, _drain_target
    import weakref
    _drain_target = (weakref.ref(scheduler), path, grace_s)
    if _drain_installed:
        return True
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            target = _drain_target
            sched = target[0]() if target is not None else None
            if sched is not None:
                try:
                    sched.drain_and_snapshot(target[1], target[2])
                except Exception as e:   # the process is ending anyway
                    warnings.warn(f"SIGTERM drain failed: {e!r}")
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        return False
    _drain_installed = True
    return True


def maybe_install_drain_handler(scheduler, path: str,
                                grace_s: Optional[float] = None) -> bool:
    """``install_drain_handler`` when ``DS_DRAIN_ON_SIGTERM=1`` is set
    and a bundle path is configured; otherwise nothing."""
    if os.environ.get("DS_DRAIN_ON_SIGTERM", "") in ("", "0") or not path:
        return False
    return install_drain_handler(scheduler, path, grace_s)
