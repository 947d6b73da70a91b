"""Masked-LM loss (counterpart of ``unicore_tpu/losses/masked_lm.py``).

The loss is the NLL summed over the masked tokens, and ``sample_size`` is
their count.  As the JAX loss does for the BERT model, the model projects
only a fixed-size set of positions per row: the masked positions first
(lowest index first), padded with unmasked ones that the loss ignores.
"""

import math

import torch
import torch.nn.functional as F

from unicore_tpu_torch.logging import metrics
from . import register_loss
from .unicore_loss import UnicoreLoss


@register_loss("masked_lm")
class MaskedLMLoss(UnicoreLoss):
    def __init__(self, task):
        super().__init__(task)
        self.padding_idx = task.dictionary.pad()
        # static bound on masked positions per row: the masking dataset
        # draws int(mask_prob * (sz - 2) + u) <= int(mask_prob * L) + 1
        self.mask_prob = getattr(task.args, "mask_prob", 0.15) if task.args else 0.15

    def forward(self, model, sample, rng=None):
        target = sample["target"]
        masked_tokens = target != self.padding_idx
        sample_size = masked_tokens.sum()
        bsz, seq_len = target.shape
        n_masked = min(seq_len, int(self.mask_prob * seq_len) + 2)
        # the JAX loss's top_k on the 0/1 mask: masked positions first,
        # ties in index order
        vals, positions = torch.sort(masked_tokens.to(torch.int32), dim=1,
                                     descending=True, stable=True)
        valid, positions = vals[:, :n_masked] > 0, positions[:, :n_masked]
        logits = model(**sample["net_input"], masked_positions=positions, rng=rng)
        lprobs = F.log_softmax(logits.float(), dim=-1)
        gathered = torch.gather(target, 1, positions)
        safe_target = torch.where(valid, gathered, 0)
        nll = -torch.gather(lprobs, -1, safe_target[..., None])[..., 0]
        loss = torch.where(valid, nll, 0.0).sum()
        logging_output = {
            "loss": loss.detach(),
            "bsz": bsz,
            "sample_size": sample_size,
            "seq_len": bsz * seq_len,
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="train") -> None:
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        bsz = sum(float(log.get("bsz", 0)) for log in logging_outputs)
        sample_size = sum(float(log.get("sample_size", 0)) for log in logging_outputs)
        seq_len = sum(float(log.get("seq_len", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / sample_size / math.log(2),
                           sample_size, round=3)
        metrics.log_scalar("seq_len", seq_len / bsz, 1, round=3)
