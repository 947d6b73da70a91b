"""Masked-MSA pretraining task (counterpart of
``unicore_tpu/tasks/msa_pretrain.py``, whose numpy draws it repeats exactly,
so both packages build the same batches from the same seed).

Data: pickled records ``{"msa": (R, L) residue ids}`` or ``{"sequences":
[str, ...]}`` in the native indexed shard format (LMDB input is not
ported).  Pipeline: subsample the MSA rows (always keeping the target row
0) and mask 15% of all tokens BERT-style, under ``numpy_seed(seed, epoch,
index)``, then pad to a fixed ``--max-msa-rows`` rows and the batch's
length rounded up to a multiple of 8.
"""

import logging
import os
from functools import lru_cache

import numpy as np

from unicore_tpu_torch.data import (
    BaseWrapperDataset,
    Dictionary,
    EpochShuffleDataset,
    NestedDictionaryDataset,
    data_utils,
)
from unicore_tpu_torch.tasks import register_task
from unicore_tpu_torch.tasks.bert import open_text_dataset
from unicore_tpu_torch.tasks.unicore_task import UnicoreTask

logger = logging.getLogger(__name__)

# standard amino-acid alphabet + gap
AA = list("ACDEFGHIKLMNPQRSTVWY") + ["-"]


class MSASampleDataset(BaseWrapperDataset):
    """Tokenize + subsample MSA rows (epoch-seeded), mask tokens."""

    def __init__(self, dataset, dictionary, mask_idx, max_rows=32,
                 max_seq_len=256, seed=1, mask_prob=0.15):
        super().__init__(dataset)
        self.dictionary = dictionary
        self.mask_idx = mask_idx
        self.max_rows = max_rows
        self.max_seq_len = max_seq_len
        self.seed = seed
        self.mask_prob = mask_prob
        self.epoch = 1

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return True

    def set_epoch(self, epoch, **unused):
        super().set_epoch(epoch)
        self.epoch = epoch

    def __getitem__(self, idx):
        return self.__getitem_cached__(self.epoch, idx)

    @lru_cache(maxsize=8)
    def __getitem_cached__(self, epoch, idx):
        with data_utils.numpy_seed(self.seed, epoch, idx):
            item = self.dataset[idx]
            if "msa" in item:
                msa = np.asarray(item["msa"])
            else:
                msa = np.asarray(
                    [[self.dictionary.index(c) for c in seq] for seq in item["sequences"]],
                    dtype=np.int64,
                )
            msa = msa[:, : self.max_seq_len]
            R = msa.shape[0]
            if R > self.max_rows:
                # always keep the target row; subsample the rest
                keep = np.concatenate(
                    [[0], 1 + np.random.permutation(R - 1)[: self.max_rows - 1]]
                )
                msa = msa[np.sort(keep)]
            msa = msa.astype(np.int64)

            mask = np.random.rand(*msa.shape) < self.mask_prob
            target = np.where(mask, msa, self.dictionary.pad())
            src = np.where(mask, self.mask_idx, msa)
            return {"src": src, "tgt": target}


class PadMSADataset(BaseWrapperDataset):
    """One key of the samples, padded to (max_rows, L rounded up to
    ``pad_to_multiple``)."""

    def __init__(self, dataset, key, pad_idx, max_rows, pad_to_multiple=8):
        super().__init__(dataset)
        self.key = key
        self.pad_idx = pad_idx
        self.max_rows = max_rows
        self.pad_to_multiple = pad_to_multiple

    def __getitem__(self, idx):
        return self.dataset[idx][self.key]

    def collater(self, samples):
        R = self.max_rows
        L = data_utils.pad_to_multiple_size(
            max(s.shape[1] for s in samples), self.pad_to_multiple
        )
        out = np.full((len(samples), R, L), self.pad_idx, dtype=np.int64)
        for i, s in enumerate(samples):
            out[i, : s.shape[0], : s.shape[1]] = s
        return out


@register_task("msa_pretrain")
class MSAPretrainTask(UnicoreTask):
    """Masked-MSA modeling with an Evoformer backbone."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="path to data directory")
        parser.add_argument("--mask-prob", default=0.15, type=float)
        parser.add_argument("--max-msa-rows", default=32, type=int)

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = args.seed
        self.mask_idx = dictionary.add_symbol("[MASK]", is_special=True)

    @classmethod
    def setup_task(cls, args, **kwargs):
        dict_path = os.path.join(args.data, "dict.txt")
        if os.path.exists(dict_path):
            dictionary = Dictionary.load(dict_path)
        else:
            dictionary = Dictionary()
            for s in ["[CLS]", "[PAD]", "[SEP]", "[UNK]"]:
                dictionary.add_symbol(s, is_special=True)
            for a in AA:
                dictionary.add_symbol(a)
        logger.info(f"dictionary: {len(dictionary)} types")
        return cls(args, dictionary)

    def token_array(self, sample):
        return sample["net_input"]["src_msa"]  # (B, R, L)

    def load_dataset(self, split, **kwargs):
        raw = open_text_dataset(os.path.join(self.args.data, split))
        masked = MSASampleDataset(
            raw,
            self.dictionary,
            mask_idx=self.mask_idx,
            max_rows=self.args.max_msa_rows,
            max_seq_len=self.args.max_seq_len,
            seed=self.seed,
            mask_prob=self.args.mask_prob,
        )
        pad = self.dictionary.pad()
        dataset = NestedDictionaryDataset(
            {
                "net_input": {
                    "src_msa": PadMSADataset(masked, "src", pad, self.args.max_msa_rows),
                },
                "target": PadMSADataset(masked, "tgt", pad, self.args.max_msa_rows),
            }
        )
        self.datasets[split] = EpochShuffleDataset(dataset, len(dataset), self.seed)
