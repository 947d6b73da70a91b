"""The training loop's update (counterpart of ``unicore_tpu/trainer.py``,
lean): ``train_step`` over the ``--update-freq`` micro-batches of one
update, the update itself, the lr schedule and the checkpoint.

One update, as the JAX ``train_step`` / ``_forward_backward`` /
``_apply_update``:

1. for each micro-batch ``i``: forward and loss in training mode, with
   dropout from a :class:`DropoutRng` keyed on (``--seed``, update, i), and
   ``loss.backward()``, which adds the micro-batch's gradient into the fp32
   ``.grad`` of each parameter (the fp32 accumulation of the JAX trainer);
2. every gradient is divided by the summed ``sample_size``;
3. clipped to ``--clip-norm`` by the global norm;
4. a non-finite norm skips the optimizer step (the update still counts);
5. Adam with the lr the scheduler gave for this update; then the update
   count moves on and the scheduler sets the next lr.

The JAX trainer's parallel, health, chaos, telemetry, EMA and orbax
machinery is not ported, nor bf16 and its stochastic rounding.
"""

import logging
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from unicore_tpu_torch import checkpoint_utils, optim
from unicore_tpu_torch.logging import metrics
from unicore_tpu_torch.modules import DropoutRng
from unicore_tpu_torch.optim import lr_scheduler as lr_sched_mod
from unicore_tpu_torch.optim.unicore_optimizer import clip_grad_norm

logger = logging.getLogger(__name__)


def _to_device(sample, device):
    if isinstance(sample, dict):
        return {k: _to_device(v, device) for k, v in sample.items()}
    return torch.as_tensor(np.asarray(sample)).to(device, non_blocking=True)


class Trainer(object):
    def __init__(self, args, task, model, loss, device):
        self.args = args
        self.task = task
        self.loss = loss
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.params: Dict[str, torch.Tensor] = OrderedDict(
            (n, p) for n, p in self.model.named_parameters() if p.requires_grad
        )
        self._optimizer = optim.build_optimizer(args)
        self._optimizer.init_state(
            self.params, checkpoint_utils.jax_param_names(self.model)
        )
        total_train_steps = args.max_update if args.max_update > 0 else None
        self._lr_scheduler = lr_sched_mod.build_lr_scheduler(
            args, self._optimizer, total_train_steps
        )
        self._num_updates = 0
        self.micro_batches = 0
        self.tokens = 0
        self.samples = 0
        self.micro_batch_lengths: List[int] = []
        self.step_ms: List[float] = []
        self.update_losses: List[float] = []

    # -- data ----------------------------------------------------------------

    def get_train_iterator(self, epoch):
        return self.task.get_batch_iterator(
            dataset=self.task.dataset(self.args.train_subset),
            batch_size=self.args.batch_size,
            seed=self.args.seed,
            epoch=epoch,
        )

    # -- lr schedule ----------------------------------------------------------

    def begin_epoch(self, epoch):
        logger.info(f"begin training epoch {epoch}")
        self._lr_scheduler.step_begin_epoch(epoch)
        self.lr_step_update()
        self.task.begin_epoch(epoch, self.model)

    def lr_step(self, epoch, val_loss=None):
        self._lr_scheduler.step(epoch, val_loss)
        return self.lr_step_update()

    def lr_step_update(self):
        return self._lr_scheduler.step_update(self.get_num_updates())

    def get_lr(self):
        return self._lr_scheduler.get_lr()

    def get_num_updates(self):
        return self._num_updates

    def set_num_updates(self, num_updates):
        self._num_updates = num_updates
        self.lr_step_update()

    # -- the update ------------------------------------------------------------

    def _forward_backward(self, sample, micro_i):
        rng = DropoutRng(self.args.seed, self.device, self.get_num_updates(), micro_i)
        loss, sample_size, logging_output = self.loss(self.model, sample, rng=rng)
        loss.backward()
        return sample_size, logging_output

    def train_step(self, samples):
        """One update from a list of micro-batches (a GroupedIterator
        chunk); returns the update's gradient norm (a float)."""
        t0 = time.perf_counter()
        self.model.train()
        for p in self.params.values():
            p.grad = None
        pad = self.task.dictionary.pad()
        sample_size = torch.zeros((), dtype=torch.float32, device=self.device)
        logging_outputs = []
        for i, sample in enumerate(samples):
            src = np.asarray(self.task.token_array(sample))
            self.tokens += int((src != pad).sum())
            self.samples += int(src.shape[0])
            self.micro_batch_lengths.append(int(src.shape[-1]))
            ss, log = self._forward_backward(_to_device(sample, self.device), i)
            sample_size = sample_size + ss
            logging_outputs.append(log)
            self.micro_batches += 1

        grads = OrderedDict(
            (n, p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in self.params.items()
        )
        lr = self.get_lr()
        torch._foreach_div_(list(grads.values()), torch.clamp(sample_size, min=1e-8))
        gnorm = float(clip_grad_norm(grads, getattr(self.args, "clip_norm", 0.0) or 0.0))
        if np.isfinite(gnorm):
            self._optimizer.step(self.params, grads, lr)
        else:
            logger.warning(f"non-finite gradient norm {gnorm}: update skipped")
        self.set_num_updates(self.get_num_updates() + 1)

        with metrics.aggregate("train"), metrics.aggregate("train_inner"):
            self.task.reduce_metrics(logging_outputs, self.loss)
            metrics.log_scalar("gnorm", gnorm, priority=400, round=3)
        loss_sum = sum(float(log["loss"]) for log in logging_outputs)
        self.update_losses.append(loss_sum / max(float(sample_size), 1e-8) / np.log(2))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        return gnorm

    # -- checkpoint ----------------------------------------------------------

    def state_dict(self, epoch_itr):
        """Everything a checkpoint holds beside ``args`` and ``model``."""
        return {
            "optimizer": self._optimizer.state_dict(),
            "lr_scheduler": self._lr_scheduler.state_dict(),
            "num_updates": self.get_num_updates(),
            "epoch_itr": epoch_itr.state_dict(),
        }

    def save_checkpoint(self, path, epoch_itr):
        """``{"args", "model", "optimizer", "lr_scheduler", "num_updates",
        "epoch_itr"}``; ``unicore-tpu-torch-serve`` reads args and model."""
        checkpoint_utils.save_checkpoint(
            path, self.args, self.model.state_dict(), **self.state_dict(epoch_itr)
        )
        logger.info(f"saved checkpoint {path} (update {self.get_num_updates()})")
