"""Delegating base for dataset views (counterpart of
``unicore_tpu/data/base_wrapper_dataset.py``): forwards the
:class:`UnicoreDataset` protocol to ``self.dataset``, so views override
only what they change."""

from .unicore_dataset import UnicoreDataset


class BaseWrapperDataset(UnicoreDataset):
    def __init__(self, dataset):
        super().__init__()
        self.dataset = dataset

    def __getitem__(self, index):
        return self.dataset[index]

    def __len__(self):
        return len(self.dataset)

    def collater(self, samples):
        return self.dataset.collater(samples)

    def ordered_indices(self):
        return self.dataset.ordered_indices()

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return self.dataset.can_reuse_epoch_itr_across_epochs

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
