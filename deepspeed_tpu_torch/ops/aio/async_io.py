"""``ctypes`` wrapper over the native async file-I/O thread pool.

Counterpart of ``deepspeed_tpu/ops/aio/async_io.py`` over the port's copy
of ``csrc/host/aio/ds_aio.cpp``: submit reads and writes of host buffers
(numpy arrays, or numpy views of CPU tensors) against files, overlap
them with other work, wait on completion.  The NVMe optimizer-state tier
(``runtime/zero/offload.py``) is built on it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from ..op_builder import AsyncIOBuilder


class AsyncIOError(OSError):
    pass


class AsyncIOHandle:
    """A pool of I/O threads servicing async reads and writes.

    The caller keeps a submitted buffer alive until its request is waited
    on; the handle holds a reference to it until then.
    """

    def __init__(self, num_threads: int = 4, block_size: int = 1 << 20,
                 queue_depth: int = 128, use_direct: bool = False):
        """The ``aio`` section's surface: a request larger than
        ``block_size`` is striped into parts serviced by all threads at
        once; ``queue_depth`` bounds the parts outstanding (a submit
        blocks when it is full); ``use_direct`` asks for O_DIRECT where
        the alignment allows it."""
        self._lib = AsyncIOBuilder().load()
        self._handle = self._lib.ds_aio_create2(
            int(num_threads), int(block_size), int(queue_depth),
            1 if use_direct else 0)
        if not self._handle:
            raise AsyncIOError("failed to create aio handle")
        # request id -> (buffer kept alive, expected bytes, is_read)
        self._inflight: Dict[int, tuple] = {}

    def _buf_ptr(self, arr: np.ndarray):
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("aio buffers must be C-contiguous")
        return ctypes.cast(arr.ctypes.data, ctypes.c_char_p)

    def pwrite(self, arr: np.ndarray, path: str, offset: int = 0) -> int:
        """Async write of the whole buffer; returns a request id."""
        req = self._lib.ds_aio_pwrite(self._handle, path.encode(),
                                      self._buf_ptr(arr), arr.nbytes, offset)
        if req < 0:  # a submit-time failure (open): req is -errno
            raise AsyncIOError(-req, f"aio submit failed for {path!r}")
        self._inflight[req] = (arr, arr.nbytes, False)
        return req

    def pread(self, arr: np.ndarray, path: str, offset: int = 0) -> int:
        """Async read filling the whole buffer; returns a request id."""
        req = self._lib.ds_aio_pread(self._handle, path.encode(),
                                     self._buf_ptr(arr), arr.nbytes, offset)
        if req < 0:  # a submit-time failure (open): req is -errno
            raise AsyncIOError(-req, f"aio submit failed for {path!r}")
        self._inflight[req] = (arr, arr.nbytes, True)
        return req

    def wait(self, request_id: int) -> int:
        """Block until one request completes; returns the bytes moved."""
        rc = self._lib.ds_aio_wait(self._handle, request_id)
        _, expected, is_read = self._inflight.pop(
            request_id, (None, None, False))
        if rc < 0:
            raise AsyncIOError(-rc, f"aio request {request_id} failed")
        if is_read and expected is not None and rc < expected:
            # a short read would leave the buffer's tail uninitialised
            raise AsyncIOError(
                f"short read: got {rc} of {expected} bytes "
                f"(request {request_id}; truncated or missing file?)")
        return rc

    def wait_all(self) -> None:
        """Drain every request in flight (each checked for a short read);
        raises the first error after all are drained."""
        first_err: Optional[AsyncIOError] = None
        for req in list(self._inflight):
            try:
                self.wait(req)
            except AsyncIOError as e:
                first_err = first_err or e
        if first_err is not None:
            raise first_err

    def sync_pwrite(self, arr: np.ndarray, path: str, offset: int = 0) -> int:
        return self.wait(self.pwrite(arr, path, offset))

    def sync_pread(self, arr: np.ndarray, path: str, offset: int = 0) -> int:
        return self.wait(self.pread(arr, path, offset))

    def close(self) -> None:
        if self._handle:
            self._lib.ds_aio_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
