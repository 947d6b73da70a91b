"""The native mmap-indexed pickle shard format (counterpart of
``unicore_tpu/data/indexed_dataset.py``; the same files, read and written
by either package).  Layout::

    <path>.bin   concatenated pickled records
    <path>.idx   magic | uint64 count | uint64 offsets[count + 1]

Reads are mmap slices.  The JAX package's optional C++ reader is not
ported; the numpy mmap path reads the same bytes.
"""

import os
import pickle
import struct
from typing import Any, List

import numpy as np

from .unicore_dataset import UnicoreDataset

_MAGIC = b"UCTPIDX1"


class IndexedPickleDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self._data_f = open(path + ".bin", "wb")
        self._offsets: List[int] = [0]

    def add_item(self, obj: Any):
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self._data_f.write(payload)
        self._offsets.append(self._offsets[-1] + len(payload))

    def finalize(self):
        self._data_f.close()
        with open(self.path + ".idx", "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", len(self._offsets) - 1))
            f.write(np.asarray(self._offsets, dtype=np.uint64).tobytes())


def make_builder(path: str) -> IndexedPickleDatasetBuilder:
    return IndexedPickleDatasetBuilder(path)


class IndexedPickleDataset(UnicoreDataset):
    """Random-access reader over the shard format."""

    def __init__(self, path: str):
        idx_path, bin_path = path + ".idx", path + ".bin"
        for p in (idx_path, bin_path):
            if not os.path.isfile(p):
                raise FileNotFoundError(f"{p} not found")
        with open(idx_path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"bad index file magic in {idx_path}")
            (n,) = struct.unpack("<Q", f.read(8))
            self._offsets = np.frombuffer(f.read(8 * (n + 1)), dtype=np.uint64)
        self._path = bin_path
        self._mmap = None
        self._n = int(n)

    def __len__(self):
        return self._n

    def __getitem__(self, idx):
        if self._mmap is None:  # opened lazily, per process
            self._mmap = np.memmap(self._path, dtype=np.uint8, mode="r")
        lo, hi = int(self._offsets[idx]), int(self._offsets[idx + 1])
        return pickle.loads(self._mmap[lo:hi].tobytes())
