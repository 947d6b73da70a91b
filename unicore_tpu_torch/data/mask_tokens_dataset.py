"""BERT-style token corruption for masked-LM training (counterpart of
``unicore_tpu/data/mask_tokens_dataset.py``, whose draws it repeats
exactly, so both packages mask the same tokens from the same seed).

Per-(seed, epoch, index) deterministic masking with probabilistic rounding
of the mask count, first/last positions never touched, the
mask/keep/random-replace split as one categorical draw, and a paired
target view that is pad everywhere except the masked positions.  The
source and target views share the leading rng draws, so they agree on the
mask.
"""

from functools import lru_cache

import numpy as np

from . import data_utils
from .base_wrapper_dataset import BaseWrapperDataset
from .dictionary import Dictionary
from .lru_cache_dataset import LRUCacheDataset

# fates for a chosen position
_MASK, _KEEP, _RANDOM = 0, 1, 2


class MaskTokensDataset(BaseWrapperDataset):
    @classmethod
    def apply_mask(cls, dataset, *args, **kwargs):
        """(source, target) views over the same underlying items, each
        LRU-cached so repeated reads don't redraw the noise."""
        dataset = LRUCacheDataset(dataset)
        src = cls(dataset, *args, **kwargs, return_masked_tokens=False)
        tgt = cls(dataset, *args, **kwargs, return_masked_tokens=True)
        return LRUCacheDataset(src), LRUCacheDataset(tgt)

    def __init__(
        self,
        dataset,
        vocab: Dictionary,
        pad_idx: int,
        mask_idx: int,
        return_masked_tokens: bool = False,
        seed: int = 1,
        mask_prob: float = 0.15,
        leave_unmasked_prob: float = 0.1,
        random_token_prob: float = 0.1,
    ):
        assert 0.0 < mask_prob < 1.0
        assert 0.0 <= random_token_prob <= 1.0
        assert 0.0 <= leave_unmasked_prob <= 1.0
        assert random_token_prob + leave_unmasked_prob <= 1.0

        self.dataset = dataset
        self.vocab = vocab
        self.pad_idx = pad_idx
        self.mask_idx = mask_idx
        self.return_masked_tokens = return_masked_tokens
        self.seed = seed
        self.mask_prob = mask_prob
        self.leave_unmasked_prob = leave_unmasked_prob
        self.random_token_prob = random_token_prob
        self.epoch = None

        if random_token_prob > 0.0:
            # replacement tokens are drawn uniformly over the non-special
            # vocabulary
            w = np.ones(len(vocab))
            w[vocab.special_index()] = 0
            self.weights = w / w.sum()

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return True  # item sizes are epoch-independent; only the noise moves

    def set_epoch(self, epoch, **unused):
        super().set_epoch(epoch)
        self.epoch = epoch

    def __getitem__(self, index: int):
        return self.__getitem_cached__(self.epoch, index)

    @lru_cache(maxsize=16)
    def __getitem_cached__(self, epoch: int, index: int):
        with data_utils.numpy_seed(self.seed, epoch, index):
            tokens = np.asarray(self.dataset[index])
            n = len(tokens)
            assert n > 2, "cannot mask an empty sequence"
            assert self.mask_idx not in tokens, (
                f"Dataset contains mask_idx (={self.mask_idx}), "
                "this is not expected!"
            )

            # interior positions only; floor(p*(n-2) + U) has expectation
            # exactly p*(n-2).  These two draws are the prefix shared by
            # the source and target views.
            count = int(self.mask_prob * (n - 2) + np.random.rand())
            chosen = 1 + np.random.choice(n - 2, count, replace=False)

            if self.return_masked_tokens:
                target = np.full_like(tokens, self.pad_idx)
                target[chosen] = tokens[chosen]
                return target

            corrupted = tokens.copy()
            p_keep = self.leave_unmasked_prob
            p_rand = self.random_token_prob
            if p_keep + p_rand > 0.0:
                fate = np.random.choice(
                    3, size=count, p=[1.0 - p_keep - p_rand, p_keep, p_rand]
                )
            else:
                fate = np.zeros(count, dtype=np.int64)
            corrupted[chosen[fate == _MASK]] = self.mask_idx
            rand_positions = chosen[fate == _RANDOM]
            if rand_positions.size:
                corrupted[rand_positions] = np.random.choice(
                    len(self.vocab), rand_positions.size, p=self.weights
                )
            return corrupted
