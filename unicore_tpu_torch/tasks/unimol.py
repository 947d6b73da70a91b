"""Uni-Mol molecular pretraining task (counterpart of
``unicore_tpu/tasks/unimol.py``, whose numpy draws it repeats exactly, so
both packages build the same batches from the same seed).

Data: pickled conformer records ``{"atoms": [symbols], "coordinates":
(L, 3) float}`` in the native indexed shard format (LMDB input is not
ported).  Pipeline: tokenize atom symbols with BOS/EOS slots at the
conformer's centre -> BERT-style atom masking with Gaussian noise on the
masked atoms' coordinates, keyed on (seed, epoch, index) -> pairwise
distances and edge types -> right-pad the 1D tokens, the (L, 3)
coordinates and the (L, L) pair features to a multiple of 8.
"""

import logging
import os
from functools import lru_cache

import numpy as np

from unicore_tpu_torch.data import (
    BaseWrapperDataset,
    Dictionary,
    EpochShuffleDataset,
    LRUCacheDataset,
    NestedDictionaryDataset,
    RightPadDataset,
    RightPadDataset2D,
    data_utils,
)
from unicore_tpu_torch.tasks import register_task
from unicore_tpu_torch.tasks.bert import open_text_dataset
from unicore_tpu_torch.tasks.unicore_task import UnicoreTask

logger = logging.getLogger(__name__)


class ConformerSampleDataset(BaseWrapperDataset):
    """Tokenize atoms and attach coordinates, the special tokens at the
    centre of the conformer."""

    def __init__(self, dataset, dictionary, max_seq_len=512):
        super().__init__(dataset)
        self.dictionary = dictionary
        self.max_seq_len = max_seq_len

    @lru_cache(maxsize=16)
    def __getitem__(self, idx):
        item = self.dataset[idx]
        atoms = item["atoms"][: self.max_seq_len - 2]
        coords = np.asarray(item["coordinates"], dtype=np.float32)[
            : self.max_seq_len - 2
        ]
        tokens = np.asarray(
            [self.dictionary.bos()]
            + [self.dictionary.index(a) for a in atoms]
            + [self.dictionary.eos()],
            dtype=np.int64,
        )
        center = coords.mean(axis=0) if len(coords) else np.zeros(3, np.float32)
        coords = np.concatenate([center[None], coords, center[None]], axis=0)
        return {"tokens": tokens, "coords": coords.astype(np.float32)}


class MaskPointsDataset(BaseWrapperDataset):
    """Joint atom-token and coordinate corruption: chosen atoms get [MASK]
    (or a random atom, or stay), and Gaussian noise on their coordinates;
    the targets keep the clean values.  Deterministic in (seed, epoch,
    index), cached per (epoch, index)."""

    def __init__(self, dataset, vocab, pad_idx, mask_idx, seed=1, mask_prob=0.15,
                 leave_unmasked_prob=0.05, random_token_prob=0.05, noise=1.0):
        super().__init__(dataset)
        self.vocab = vocab
        self.pad_idx = pad_idx
        self.mask_idx = mask_idx
        self.seed = seed
        self.mask_prob = mask_prob
        self.leave_unmasked_prob = leave_unmasked_prob
        self.random_token_prob = random_token_prob
        self.noise = noise
        weights = np.ones(len(vocab))
        weights[vocab.special_index()] = 0
        self.weights = weights / weights.sum()
        self.epoch = None

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return True

    def set_epoch(self, epoch, **unused):
        super().set_epoch(epoch)
        self.epoch = epoch

    def __getitem__(self, idx):
        # keyed by (epoch, idx): one epoch's corruption must not leak into
        # the next
        return self.__getitem_cached__(self.epoch, idx)

    @lru_cache(maxsize=16)
    def __getitem_cached__(self, epoch, idx):
        with data_utils.numpy_seed(self.seed, epoch, idx):
            item = self.dataset[idx]
            tokens, coords = item["tokens"], item["coords"]
            sz = len(tokens)
            if sz <= 2:
                raise ValueError(f"conformer {idx} has no atoms")

            mask = np.full(sz, False)
            num_mask = int(self.mask_prob * (sz - 2) + np.random.rand())
            mask_idc = np.random.choice(sz - 2, num_mask, replace=False) + 1
            mask[mask_idc] = True

            target_tokens = np.full(sz, self.pad_idx, dtype=tokens.dtype)
            target_tokens[mask] = tokens[mask]

            rand_or_unmask_prob = self.random_token_prob + self.leave_unmasked_prob
            unmask = rand_mask = None
            if rand_or_unmask_prob > 0:
                rand_or_unmask = mask & (np.random.rand(sz) < rand_or_unmask_prob)
                if self.random_token_prob == 0:
                    unmask = rand_or_unmask
                elif self.leave_unmasked_prob == 0:
                    rand_mask = rand_or_unmask
                else:
                    unmask_prob = self.leave_unmasked_prob / rand_or_unmask_prob
                    decision = np.random.rand(sz) < unmask_prob
                    unmask = rand_or_unmask & decision
                    rand_mask = rand_or_unmask & (~decision)
            token_mask = mask if unmask is None else (mask ^ unmask)

            new_tokens = np.copy(tokens)
            new_tokens[token_mask] = self.mask_idx
            if rand_mask is not None and rand_mask.sum() > 0:
                new_tokens[rand_mask] = np.random.choice(
                    len(self.vocab), rand_mask.sum(), p=self.weights
                )

            new_coords = np.copy(coords)
            new_coords[mask] += (
                np.random.randn(int(mask.sum()), 3).astype(np.float32) * self.noise
            )
            return {
                "src_tokens": new_tokens,
                "src_coord": new_coords.astype(np.float32),
                "target_tokens": target_tokens,
                "target_coord": coords.astype(np.float32),
                "token_mask": mask.astype(np.int64),
            }


class DistanceDataset(BaseWrapperDataset):
    """Pairwise distances (L, L) of one record's coordinates."""

    def __init__(self, dataset, key):
        super().__init__(dataset)
        self.key = key

    def __getitem__(self, idx):
        coords = self.dataset[idx][self.key]
        diff = coords[:, None, :] - coords[None, :, :]
        return np.sqrt((diff ** 2).sum(-1) + 1e-12).astype(np.float32)


class EdgeTypeDataset(BaseWrapperDataset):
    """Edge types (L, L): ``token_i * vocab_size + token_j``."""

    def __init__(self, dataset, key, vocab_size):
        super().__init__(dataset)
        self.key = key
        self.vocab_size = vocab_size

    def __getitem__(self, idx):
        tokens = self.dataset[idx][self.key]
        return (tokens[:, None] * self.vocab_size + tokens[None, :]).astype(np.int64)


class SubKeyDataset(BaseWrapperDataset):
    def __init__(self, dataset, key):
        super().__init__(dataset)
        self.key = key

    def __getitem__(self, idx):
        return self.dataset[idx][self.key]


class RightPadDatasetCoord(BaseWrapperDataset):
    """(L, 3) coordinate padding to a multiple of 8."""

    def __init__(self, dataset, pad_idx=0.0):
        super().__init__(dataset)
        self.pad_idx = pad_idx

    def collater(self, samples):
        size = max(s.shape[0] for s in samples)
        size = int(((size - 0.1) // 8 + 1) * 8)
        out = np.full((len(samples), size, 3), self.pad_idx, dtype=np.float32)
        for i, s in enumerate(samples):
            out[i, : s.shape[0]] = s
        return out


@register_task("unimol")
class UniMolTask(UnicoreTask):
    """3D molecular pretraining with masked atoms and noised coordinates."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="path to data directory")
        parser.add_argument("--mask-prob", default=0.15, type=float)
        parser.add_argument("--leave-unmasked-prob", default=0.05, type=float)
        parser.add_argument("--random-token-prob", default=0.05, type=float)
        parser.add_argument("--noise", default=1.0, type=float,
                            help="std of coordinate noise on masked atoms")

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = args.seed
        self.mask_idx = dictionary.add_symbol("[MASK]", is_special=True)

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info(f"dictionary: {len(dictionary)} types")
        return cls(args, dictionary)

    def load_dataset(self, split, **kwargs):
        raw = open_text_dataset(os.path.join(self.args.data, split))
        conf = ConformerSampleDataset(raw, self.dictionary,
                                      max_seq_len=self.args.max_seq_len)
        masked = LRUCacheDataset(
            MaskPointsDataset(
                LRUCacheDataset(conf),
                self.dictionary,
                pad_idx=self.dictionary.pad(),
                mask_idx=self.mask_idx,
                seed=self.seed,
                mask_prob=self.args.mask_prob,
                leave_unmasked_prob=self.args.leave_unmasked_prob,
                random_token_prob=self.args.random_token_prob,
                noise=self.args.noise,
            )
        )
        pad = self.dictionary.pad()
        dataset = NestedDictionaryDataset(
            {
                "net_input": {
                    "src_tokens": RightPadDataset(
                        SubKeyDataset(masked, "src_tokens"), pad_idx=pad
                    ),
                    "src_coord": RightPadDatasetCoord(SubKeyDataset(masked, "src_coord")),
                    "src_distance": RightPadDataset2D(
                        DistanceDataset(masked, "src_coord"), pad_idx=0
                    ),
                    "src_edge_type": RightPadDataset2D(
                        EdgeTypeDataset(masked, "src_tokens", len(self.dictionary)),
                        pad_idx=0,
                    ),
                },
                "target": {
                    "tokens_target": RightPadDataset(
                        SubKeyDataset(masked, "target_tokens"), pad_idx=pad
                    ),
                    "coord_target": RightPadDatasetCoord(
                        SubKeyDataset(masked, "target_coord")
                    ),
                    "distance_target": RightPadDataset2D(
                        DistanceDataset(masked, "target_coord"), pad_idx=0
                    ),
                },
            }
        )
        self.datasets[split] = EpochShuffleDataset(dataset, len(dataset), self.seed)
