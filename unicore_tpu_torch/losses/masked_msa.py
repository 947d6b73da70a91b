"""Masked-MSA cross-entropy loss for Evoformer pretraining (counterpart of
``unicore_tpu/losses/masked_msa.py``): the NLL summed over the masked MSA
tokens; ``sample_size`` is their count (at least 1)."""

import math

import torch
import torch.nn.functional as F

from unicore_tpu_torch.logging import metrics
from . import register_loss
from .unicore_loss import UnicoreLoss


@register_loss("masked_msa")
class MaskedMSALoss(UnicoreLoss):
    def __init__(self, task):
        super().__init__(task)
        self.padding_idx = task.dictionary.pad()

    def forward(self, model, sample, rng=None):
        target = sample["target"]  # (B, R, L)
        masked = target != self.padding_idx
        sample_size = torch.clamp(masked.sum().float(), min=1.0)
        logits = model(**sample["net_input"], rng=rng)[0]
        lprobs = F.log_softmax(logits.float(), dim=-1)
        safe_t = torch.where(masked, target, 0)
        nll = -torch.gather(lprobs, -1, safe_t[..., None])[..., 0]
        loss = torch.where(masked, nll, 0.0).sum()
        logging_output = {
            "loss": loss.detach(),
            "bsz": target.shape[0],
            "sample_size": sample_size,
            "seq_len": target.shape[0] * target.shape[2],
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="train") -> None:
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        sample_size = sum(float(log.get("sample_size", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / sample_size / math.log(2), sample_size,
                           round=3)
