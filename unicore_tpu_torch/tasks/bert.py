"""BERT masked-LM task (counterpart of ``unicore_tpu/tasks/bert.py``).

Pipeline: raw text in the native indexed shards -> WordPiece tokenize ->
BERT masking -> right-pad to ``--seq-pad-multiple`` -> nested-dict
batches; the train split reshuffles every epoch, deterministically in
(seed, epoch).  The JAX package's LMDB input and length buckets are not
ported."""

import logging
import os

from unicore_tpu_torch.data import (
    BertTokenizeDataset,
    Dictionary,
    EpochShuffleDataset,
    IndexedPickleDataset,
    MaskTokensDataset,
    NestedDictionaryDataset,
    RightPadDataset,
)
from unicore_tpu_torch.tasks import register_task
from unicore_tpu_torch.tasks.unicore_task import UnicoreTask

logger = logging.getLogger(__name__)


@register_task("bert")
class BertTask(UnicoreTask):
    """Task for masked language models (e.g., BERT)."""

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "data",
            help="colon separated path to data directories list, "
                 "iterated upon during epochs in round-robin manner",
        )
        parser.add_argument(
            "--mask-prob", default=0.15, type=float,
            help="probability of replacing a token with mask",
        )
        parser.add_argument(
            "--leave-unmasked-prob", default=0.1, type=float,
            help="probability that a masked token is unmasked",
        )
        parser.add_argument(
            "--random-token-prob", default=0.1, type=float,
            help="probability of replacing a token with a random token",
        )
        parser.add_argument(
            "--seq-pad-multiple", default=8, type=int,
            help="pad batch sequence lengths to this multiple; 128 aligns "
                 "batches with the attention kernel's block size",
        )

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = getattr(args, "seed", 1)
        self.dictionary_path = os.path.join(args.data, "dict.txt")
        self.mask_idx = dictionary.add_symbol("[MASK]", is_special=True)

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info(f"dictionary: {len(dictionary)} types")
        return cls(args, dictionary)

    def load_dataset(self, split, **kwargs):
        a = self.args
        tokens = BertTokenizeDataset(
            IndexedPickleDataset(os.path.join(a.data, split)),
            self.dictionary_path,
            max_seq_len=a.max_seq_len,
        )
        masked, labels = MaskTokensDataset.apply_mask(
            tokens,
            self.dictionary,
            pad_idx=self.dictionary.pad(),
            mask_idx=self.mask_idx,
            seed=a.seed,
            mask_prob=a.mask_prob,
            leave_unmasked_prob=a.leave_unmasked_prob,
            random_token_prob=a.random_token_prob,
        )

        def padded(ds):
            return RightPadDataset(ds, pad_idx=self.dictionary.pad(),
                                   pad_to_multiple=a.seq_pad_multiple)

        batches = NestedDictionaryDataset(
            {"net_input": {"src_tokens": padded(masked)}, "target": padded(labels)}
        )
        if split == "train":
            # (seed, epoch)-keyed reshuffle each epoch
            batches = EpochShuffleDataset(batches, len(batches), self.seed)
        self.datasets[split] = batches
