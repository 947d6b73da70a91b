"""Right-padding collators (counterpart of ``unicore_tpu/data/pad_dataset.py``):
pad each batch to its longest sample, rounded up to ``pad_to_multiple`` and,
with ``pad_to_buckets`` (the ``--length-bucket`` edges of
``data_utils.compute_length_buckets``), snapped up to the smallest covering
bucket, so the batch lengths stay in a fixed set;
:class:`RightPadDataset2D` pads (L, L) pair features on both axes."""

from . import data_utils
from .base_wrapper_dataset import BaseWrapperDataset


class PadDataset(BaseWrapperDataset):
    def __init__(self, dataset, pad_idx, left_pad, pad_to_multiple=8,
                 pad_to_buckets=None):
        super().__init__(dataset)
        self.pad_idx = pad_idx
        self.left_pad = left_pad
        self.pad_to_multiple = pad_to_multiple
        self.pad_to_buckets = pad_to_buckets

    def collater(self, samples):
        return data_utils.collate_tokens(
            samples, self.pad_idx, left_pad=self.left_pad,
            pad_to_multiple=self.pad_to_multiple,
            pad_to_buckets=self.pad_to_buckets,
        )


class RightPadDataset(PadDataset):
    def __init__(self, dataset, pad_idx, pad_to_multiple=8, pad_to_buckets=None):
        super().__init__(dataset, pad_idx, left_pad=False,
                         pad_to_multiple=pad_to_multiple,
                         pad_to_buckets=pad_to_buckets)


class RightPadDataset2D(BaseWrapperDataset):
    def __init__(self, dataset, pad_idx, left_pad=False, pad_to_multiple=8,
                 pad_to_buckets=None):
        super().__init__(dataset)
        self.pad_idx = pad_idx
        self.left_pad = left_pad
        self.pad_to_multiple = pad_to_multiple
        self.pad_to_buckets = pad_to_buckets

    def collater(self, samples):
        return data_utils.collate_tokens_2d(
            samples, self.pad_idx, left_pad=self.left_pad,
            pad_to_multiple=self.pad_to_multiple,
            pad_to_buckets=self.pad_to_buckets,
        )
