"""Dataset protocol (counterpart of ``unicore_tpu/data/unicore_dataset.py``).

Map-style datasets with collation, epoch awareness and batching.  Samples
are numpy; the trainer moves a collated batch onto the device.
"""

import numpy as np


class EpochListening:
    """Mixin: receive the epoch number as epochs begin."""

    def set_epoch(self, epoch):
        """Called with the new (1-based) epoch before iteration starts."""
        pass

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        """True when epoch numbers don't change what the dataset yields
        (no epoch-seeded masking/shuffling), letting the batch iterator be
        reused instead of rebuilt."""
        return True


class UnicoreDataset(EpochListening):
    """Map-style dataset with batching helpers.

    Required: ``__getitem__``, ``__len__``, ``collater``;
    ``ordered_indices`` defaults to natural order."""

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def collater(self, samples):
        """Merge a list of samples into a numpy mini-batch."""
        raise NotImplementedError

    def ordered_indices(self):
        """Index order batches are built from (natural order by default)."""
        return np.arange(len(self), dtype=np.int64)

    def batch_by_size(self, indices, batch_size=None,
                      required_batch_size_multiple=1):
        """Chunk ``indices`` into batches of ``batch_size``
        (:func:`data_utils.batch_by_size`)."""
        from . import data_utils

        return data_utils.batch_by_size(
            indices,
            batch_size=batch_size,
            required_batch_size_multiple=required_batch_size_multiple,
        )
