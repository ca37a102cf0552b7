"""Memory-mapped indexed dataset (Megatron ``.bin``/``.idx`` format).

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/indexed_dataset.py``
(reference ``data_sampling/indexed_dataset.py``, the Megatron mmap
format): token documents stored back to back in a flat binary file with
an index of sizes and offsets, read zero-copy through ``np.memmap``.  The
files are the reference's (same magic, version and dtype codes), so a
corpus written by either package's builder, by Megatron-LM or by the
reference loads unchanged.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

_INDEX_MAGIC = b"MMIDIDX\x00\x00"
_VERSION = 1

# dtype codes from the Megatron format (reference
# data_sampling/indexed_dataset.py:102 — 6/7/8 are the unsigned widths;
# uint16 corpora are the common vocab<=65536 case)
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32,
           5: np.int64, 6: np.uint16, 7: np.uint32, 8: np.uint64}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDataset:
    """Read-only mmap view: ``ds[i]`` -> np array of document *i*'s tokens."""

    def __init__(self, path_prefix: str):
        with open(index_file_path(path_prefix), "rb") as f:
            magic = f.read(9)
            if magic != _INDEX_MAGIC:
                raise ValueError(
                    f"{index_file_path(path_prefix)} is not an MMIDIDX file")
            version, = struct.unpack("<Q", f.read(8))
            if version != _VERSION:
                raise ValueError(f"unsupported index version {version}")
            code, = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_DTYPES[code])
            self._len, = struct.unpack("<Q", f.read(8))
            doc_count, = struct.unpack("<Q", f.read(8))
            offset = f.tell()
        idx_buf = np.memmap(index_file_path(path_prefix), mode="r",
                            order="C")
        self.sizes = np.frombuffer(idx_buf, dtype=np.int32,
                                   count=self._len, offset=offset)
        pointers_off = offset + self.sizes.nbytes
        self.pointers = np.frombuffer(idx_buf, dtype=np.int64,
                                      count=self._len, offset=pointers_off)
        doc_off = pointers_off + self.pointers.nbytes
        self.doc_idx = np.frombuffer(idx_buf, dtype=np.int64,
                                     count=doc_count, offset=doc_off)
        self._data = np.memmap(data_file_path(path_prefix), mode="r",
                               dtype=self.dtype, order="C")
        # Integrity check: the .bin must hold exactly the tokens the index
        # promises.  Catches an index written with a wrong dtype code (a
        # uint16 corpus misread as uint64 fails here 4x over) instead of
        # silently decoding garbage.
        expected = int(self.pointers[-1]) // self.dtype.itemsize \
            + int(self.sizes[-1]) if self._len else 0
        if self._data.size != expected:
            raise ValueError(
                f"{data_file_path(path_prefix)}: {self._data.size} items of "
                f"{self.dtype} but index promises {expected} — dtype code "
                "mismatch (index written by an incompatible builder?)")

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        ptr = self.pointers[i] // self.dtype.itemsize
        return np.asarray(self._data[ptr:ptr + self.sizes[i]])

    def get(self, i: int, offset: int = 0,
            length: Optional[int] = None) -> np.ndarray:
        """Partial document read (reference ``get``)."""
        size = int(self.sizes[i])
        length = size - offset if length is None else length
        ptr = self.pointers[i] // self.dtype.itemsize + offset
        return np.asarray(self._data[ptr:ptr + length])

    @staticmethod
    def exists(path_prefix: str) -> bool:
        return (os.path.exists(index_file_path(path_prefix)) and
                os.path.exists(data_file_path(path_prefix)))


class MMapIndexedDatasetBuilder:
    """Streaming writer (reference ``MMapIndexedDatasetBuilder``)."""

    def __init__(self, out_prefix: str, dtype=np.int32):
        self.prefix = out_prefix
        self.dtype = np.dtype(dtype)
        self._data_f = open(data_file_path(out_prefix), "wb")
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self.dtype)
        self._data_f.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def merge_file(self, other_prefix: str) -> None:
        other = MMapIndexedDataset(other_prefix)
        base = len(self._sizes)
        for i in range(len(other)):
            self.add_item(other[i])
        for d in other.doc_idx[1:]:
            self._doc_idx.append(base + int(d))

    def finalize(self) -> None:
        self._data_f.close()
        sizes = np.asarray(self._sizes, np.int32)
        itemsize = self.dtype.itemsize
        pointers = np.zeros(len(sizes), np.int64)
        np.cumsum(sizes[:-1] * itemsize, out=pointers[1:])
        with open(index_file_path(self.prefix), "wb") as f:
            f.write(_INDEX_MAGIC)
            f.write(struct.pack("<Q", _VERSION))
            f.write(struct.pack("<B", _DTYPE_CODES[self.dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(self._doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(self._doc_idx, np.int64).tobytes(order="C"))
