"""BERT masked-LM task (counterpart of ``unicore_tpu/tasks/bert.py``; this
slice ports what serving needs: the dictionary, ``dict.txt`` plus the
``[MASK]`` symbol.  The text datasets and masking wait for the training
slice)."""

import logging
import os

from unicore_tpu_torch.data import Dictionary
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
            help="pad batch sequence lengths to this multiple",
        )

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = getattr(args, "seed", 1)
        self.mask_idx = dictionary.add_symbol("[MASK]", is_special=True)

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info(f"dictionary: {len(dictionary)} types")
        return cls(args, dictionary)
