"""Per-epoch shuffled batching order (counterpart of
``unicore_tpu/data/sort_dataset.py`` ``EpochShuffleDataset``)."""

import numpy as np

from . import data_utils
from .base_wrapper_dataset import BaseWrapperDataset


class EpochShuffleDataset(BaseWrapperDataset):
    """Reshuffles the batching order every epoch, deterministically in
    (seed, epoch)."""

    def __init__(self, dataset, size, seed):
        super().__init__(dataset)
        self.size = size
        self.seed = seed
        self._order = None
        self.set_epoch(1)

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        with data_utils.numpy_seed(self.seed + epoch - 1):
            self._order = np.random.permutation(self.size)

    def ordered_indices(self):
        return self._order

    # a fresh permutation is drawn each epoch, so the batch iterator must
    # be rebuilt rather than reused
    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return False
