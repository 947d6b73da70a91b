"""LRU-cached dataset view (counterpart of
``unicore_tpu/data/lru_cache_dataset.py``).  The cache drops on
``set_epoch`` so epoch-seeded upstream datasets (masking) are drawn anew."""

import threading
from collections import OrderedDict

from .base_wrapper_dataset import BaseWrapperDataset


class LRUCacheDataset(BaseWrapperDataset):
    def __init__(self, dataset, maxsize=16):
        super().__init__(dataset)
        self._maxsize = maxsize
        self._cache = OrderedDict()
        self._lock = threading.Lock()

    def __getitem__(self, index):
        with self._lock:
            if index in self._cache:
                self._cache.move_to_end(index)
                return self._cache[index]
        value = self.dataset[index]
        with self._lock:
            self._cache[index] = value
            if len(self._cache) > self._maxsize:
                self._cache.popitem(last=False)
        return value

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        with self._lock:
            self._cache.clear()
