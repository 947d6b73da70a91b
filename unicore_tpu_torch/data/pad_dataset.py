"""Right-padding collator (counterpart of ``unicore_tpu/data/pad_dataset.py``):
pads each batch to its longest sample, rounded up to ``pad_to_multiple``."""

from . import data_utils
from .base_wrapper_dataset import BaseWrapperDataset


class PadDataset(BaseWrapperDataset):
    def __init__(self, dataset, pad_idx, left_pad, pad_to_multiple=8):
        super().__init__(dataset)
        self.pad_idx = pad_idx
        self.left_pad = left_pad
        self.pad_to_multiple = pad_to_multiple

    def collater(self, samples):
        return data_utils.collate_tokens(
            samples, self.pad_idx, left_pad=self.left_pad,
            pad_to_multiple=self.pad_to_multiple,
        )


class RightPadDataset(PadDataset):
    def __init__(self, dataset, pad_idx, pad_to_multiple=8):
        super().__init__(dataset, pad_idx, left_pad=False,
                         pad_to_multiple=pad_to_multiple)
