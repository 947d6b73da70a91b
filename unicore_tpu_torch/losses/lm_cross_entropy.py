"""Shifted (next-token) cross-entropy for causal LMs (counterpart of
``unicore_tpu/losses/lm_cross_entropy.py``).

The model predicts position t+1 from positions <= t, so the loss pairs
``logits[:, :-1]`` with ``target[:, 1:]``: the NLL summed in fp32 over the
targets that are not pad, and ``sample_size`` is their count.  The
causal-LM task's target is its input token stream.
"""

import math

import torch
import torch.nn.functional as F

from unicore_tpu_torch.logging import metrics
from . import register_loss
from .unicore_loss import UnicoreLoss


@register_loss("lm_cross_entropy")
class LMCrossEntropyLoss(UnicoreLoss):
    def __init__(self, task):
        super().__init__(task)
        self.padding_idx = task.dictionary.pad()

    def forward(self, model, sample, rng=None):
        logits = model(**sample["net_input"], rng=rng)
        target = sample["target"][:, 1:]
        valid = target != self.padding_idx
        lprobs = F.log_softmax(logits[:, :-1].float(), dim=-1)
        safe_target = torch.where(valid, target, 0)
        nll = -torch.gather(lprobs, -1, safe_target[..., None].long())[..., 0]
        loss = torch.where(valid, nll, 0.0).sum()
        sample_size = valid.sum()
        logging_output = {
            "loss": loss.detach(),
            "sample_size": sample_size,
            "bsz": target.shape[0],
        }
        return loss, sample_size, logging_output

    @staticmethod
    def reduce_metrics(logging_outputs, split="train") -> None:
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        sample_size = sum(float(log.get("sample_size", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / sample_size / math.log(2),
                           sample_size, round=3)
