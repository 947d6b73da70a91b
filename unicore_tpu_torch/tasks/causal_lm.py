"""Causal-LM task (counterpart of ``unicore_tpu/tasks/causal_lm.py``): the
BERT data pipeline minus the masking stage.

Same shards, WordPiece tokenizer and padding as ``tasks/bert.py`` (to
``--seq-pad-multiple``, and into the ``--length-bucket`` edges);
``target`` is the input token stream itself, which the ``lm_cross_entropy``
loss shifts by one.  ``unicore-tpu-torch-train`` trains a decoder-only
``transformer_lm`` on it, and the incremental-decode serving plane serves
that checkpoint with this task's dictionary.
"""

import logging
import os

from unicore_tpu_torch.data import (
    BertTokenizeDataset,
    Dictionary,
    EpochShuffleDataset,
    NestedDictionaryDataset,
    RightPadDataset,
)
from unicore_tpu_torch.tasks import register_task
from unicore_tpu_torch.tasks.bert import open_text_dataset
from unicore_tpu_torch.tasks.unicore_task import UnicoreTask

logger = logging.getLogger(__name__)


@register_task("causal_lm")
class CausalLMTask(UnicoreTask):
    """Next-token prediction over the same corpora the BERT task reads."""

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "data",
            help="colon separated path to data directories list, "
                 "iterated upon during epochs in round-robin manner",
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

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info(f"dictionary: {len(dictionary)} types")
        return cls(args, dictionary)

    def load_dataset(self, split, **kwargs):
        a = self.args
        tokens = BertTokenizeDataset(
            open_text_dataset(os.path.join(a.data, split)),
            os.path.join(a.data, "dict.txt"),
            max_seq_len=a.max_seq_len,
        )

        def padded(ds):
            return RightPadDataset(ds, pad_idx=self.dictionary.pad(),
                                   pad_to_multiple=a.seq_pad_multiple,
                                   pad_to_buckets=self.length_bucket_edges())

        batches = NestedDictionaryDataset(
            {"net_input": {"src_tokens": padded(tokens)}, "target": padded(tokens)}
        )
        if split == "train":
            # (seed, epoch)-keyed reshuffle each epoch
            batches = EpochShuffleDataset(batches, len(batches), self.seed)
        self.datasets[split] = batches
