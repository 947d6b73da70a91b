"""Uni-Mol pretraining loss (counterpart of ``unicore_tpu/losses/unimol.py``):
masked-atom cross-entropy, masked-coordinate and masked-distance smooth-L1,
and the two representation-norm regularisers, each weighted and scaled by
the masked-atom count ``sample_size`` (the trainer divides the summed
gradient by it)."""

import torch
import torch.nn.functional as F

from unicore_tpu_torch.logging import metrics
from . import register_loss
from .unicore_loss import UnicoreLoss


def smooth_l1(pred, target, beta=1.0):
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


@register_loss("unimol")
class UniMolLoss(UnicoreLoss):
    def __init__(self, task):
        super().__init__(task)
        self.padding_idx = task.dictionary.pad()
        args = task.args
        self.masked_token_loss = getattr(args, "masked_token_loss", 1.0)
        self.masked_coord_loss = getattr(args, "masked_coord_loss", 5.0)
        self.masked_dist_loss = getattr(args, "masked_dist_loss", 10.0)
        self.x_norm_loss = getattr(args, "x_norm_loss", 0.01)
        self.delta_pair_repr_norm_loss = getattr(args, "delta_pair_repr_norm_loss", 0.01)

    def forward(self, model, sample, rng=None):
        target = sample["target"]["tokens_target"]
        masked = target != self.padding_idx  # (B, L)
        sample_size = torch.clamp(masked.sum().float(), min=1.0)

        logits, dist_pred, coord_pred, x_norm, delta_norm = model(
            **sample["net_input"], rng=rng
        )
        logging = {}
        loss = torch.zeros((), dtype=torch.float32, device=target.device)

        if logits is not None:
            lprobs = F.log_softmax(logits.float(), dim=-1)
            safe_t = torch.where(masked, target, 0)
            nll = -torch.gather(lprobs, -1, safe_t[..., None])[..., 0]
            token_loss = torch.where(masked, nll, 0.0).sum() / sample_size
            loss = loss + self.masked_token_loss * token_loss * sample_size
            logging["masked_token_loss"] = token_loss * sample_size

        if coord_pred is not None:
            coord_t = sample["target"]["coord_target"]
            cdiff = smooth_l1(coord_pred.float(), coord_t.float()).sum(-1)
            coord_loss = torch.where(masked, cdiff, 0.0).sum() / sample_size
            loss = loss + self.masked_coord_loss * coord_loss * sample_size
            logging["masked_coord_loss"] = coord_loss * sample_size

        if dist_pred is not None:
            dist_t = sample["target"]["distance_target"]
            # rows of masked atoms against non-padded columns
            col_ok = sample["net_input"]["src_tokens"] != self.padding_idx
            pair_mask = masked[:, :, None] & col_ok[:, None, :]
            ddiff = smooth_l1(dist_pred.float(), dist_t.float())
            npairs = torch.clamp(pair_mask.sum().float(), min=1.0)
            dist_loss = torch.where(pair_mask, ddiff, 0.0).sum() / npairs
            loss = loss + self.masked_dist_loss * dist_loss * sample_size
            logging["masked_dist_loss"] = dist_loss * sample_size

        if self.x_norm_loss > 0 and x_norm is not None:
            loss = loss + self.x_norm_loss * x_norm * sample_size
            logging["x_norm_loss"] = x_norm * sample_size
        if self.delta_pair_repr_norm_loss > 0 and delta_norm is not None:
            loss = loss + self.delta_pair_repr_norm_loss * delta_norm * sample_size
            logging["delta_pair_repr_norm_loss"] = delta_norm * sample_size

        logging = {k: v.detach() for k, v in logging.items()}
        logging.update(
            loss=loss.detach(),
            bsz=target.shape[0],
            sample_size=sample_size.detach(),
            seq_len=target.shape[0] * target.shape[1],
        )
        return loss, sample_size, logging

    @staticmethod
    def reduce_metrics(logging_outputs, split="train") -> None:
        loss_sum = sum(float(log.get("loss", 0)) for log in logging_outputs)
        sample_size = sum(float(log.get("sample_size", 0)) for log in logging_outputs)
        metrics.log_scalar("loss", loss_sum / sample_size, sample_size, round=3)
        for key in (
            "masked_token_loss",
            "masked_coord_loss",
            "masked_dist_loss",
            "x_norm_loss",
            "delta_pair_repr_norm_loss",
        ):
            if any(key in log for log in logging_outputs):
                v = sum(float(log.get(key, 0)) for log in logging_outputs)
                metrics.log_scalar(key, v / sample_size, sample_size, round=3)
