"""Small dataset views (counterpart of ``unicore_tpu/data/misc_datasets.py``):
``NumelDataset``, ``NumSamplesDataset``, the ``Raw*Dataset``s,
``FromNumpyDataset``, ``AppendTokenDataset``, ``PrependTokenDataset`` and
``TokenizeDataset``, and :func:`default_collate`, which stacks samples into
torch tensors.  The views hold numpy samples as the JAX ones do, except
``FromNumpyDataset``, which hands out torch tensors (the reference's
conversion).  The JAX views memoize ``__getitem__`` with ``lru_cache``;
these recompute (each is a cheap view, and a per-method cache would keep
the dataset alive)."""

import numpy as np
import torch

from .base_wrapper_dataset import BaseWrapperDataset
from .dictionary import Dictionary
from .unicore_dataset import UnicoreDataset


def default_collate(samples):
    """Stack a list of samples into torch tensors, through dicts, lists and
    tuples (the reference's torch ``default_collate``)."""
    first = samples[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(samples)
    if isinstance(first, np.ndarray):
        return torch.as_tensor(np.stack(samples))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate(list(col)) for col in zip(*samples))
    return torch.as_tensor(np.asarray(samples))


class NumelDataset(BaseWrapperDataset):
    """Per-sample element count."""

    def __init__(self, dataset, reduce=False):
        super().__init__(dataset)
        self.reduce = reduce

    def __getitem__(self, index):
        return np.size(self.dataset[index])

    def __len__(self):
        return len(self.dataset)

    def collater(self, samples):
        return sum(samples) if self.reduce else np.asarray(samples)


class NumSamplesDataset(UnicoreDataset):
    """Constant-1 view whose collater counts samples."""

    def __getitem__(self, index):
        return 1

    def __len__(self):
        return 0

    def collater(self, samples):
        return sum(samples)


class RawLabelDataset(UnicoreDataset):
    def __init__(self, labels):
        super().__init__()
        self.labels = labels

    def __getitem__(self, index):
        return self.labels[index]

    def __len__(self):
        return len(self.labels)

    def collater(self, samples):
        return np.asarray(samples)


class RawArrayDataset(UnicoreDataset):
    def __init__(self, dataset):
        super().__init__()
        self.dataset = dataset

    def __getitem__(self, index):
        return self.dataset[index]

    def __len__(self):
        return len(self.dataset)

    def collater(self, samples):
        if hasattr(self.dataset, "collater"):
            return self.dataset.collater(samples)
        return default_collate(samples)


class RawNumpyDataset(RawArrayDataset):
    def __getitem__(self, index):
        return np.asarray(self.dataset[index])


class FromNumpyDataset(BaseWrapperDataset):
    """numpy samples as torch tensors (the reference's conversion)."""

    def __getitem__(self, idx):
        return torch.from_numpy(np.asarray(self.dataset[idx]))


class AppendTokenDataset(BaseWrapperDataset):
    def __init__(self, dataset, token=None):
        super().__init__(dataset)
        self.token = token

    def __getitem__(self, idx):
        item = np.asarray(self.dataset[idx])
        if self.token is not None:
            item = np.concatenate([item, np.full_like(item[:1], self.token)], axis=0)
        return item


class PrependTokenDataset(BaseWrapperDataset):
    def __init__(self, dataset, token=None):
        super().__init__(dataset)
        self.token = token

    def __getitem__(self, idx):
        item = np.asarray(self.dataset[idx])
        if self.token is not None:
            item = np.concatenate([np.full_like(item[:1], self.token), item], axis=0)
        return item


class TokenizeDataset(BaseWrapperDataset):
    """Symbol -> id through a Dictionary."""

    def __init__(self, dataset, dictionary: Dictionary, max_seq_len: int = 512):
        super().__init__(dataset)
        self.dictionary = dictionary
        self.max_seq_len = max_seq_len

    def __getitem__(self, index: int):
        raw_data = self.dataset[index]
        if not 0 < len(raw_data) < self.max_seq_len:
            raise ValueError(f"TokenizeDataset: sample {index} has {len(raw_data)} symbols, "
                             f"want 1..{self.max_seq_len - 1}")
        return self.dictionary.vec_index(raw_data).astype(np.int64)
