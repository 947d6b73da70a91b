"""The training loop's update (counterpart of ``unicore_tpu/trainer.py``,
lean): ``train_step`` over the ``--update-freq`` micro-batches of one
update, ``valid_step``, the EMA, the lr schedule and the checkpoint.

One update, as the JAX ``train_step`` / ``_forward_backward`` /
``_apply_update``:

1. for each micro-batch ``i``: forward and loss in training mode, with
   dropout from a :class:`DropoutRng` keyed on (``--seed``, update, i), and
   ``loss.backward()``, which adds the micro-batch's gradient into the fp32
   ``.grad`` of each parameter (the fp32 accumulation of the JAX trainer);
2. every gradient is divided by the summed ``sample_size``;
3. clipped to ``--clip-norm`` by the global norm;
4. a non-finite norm skips the optimizer step and the EMA (the update still
   counts);
5. Adam with the lr the scheduler gave for this update, then the EMA
   (``--ema-decay``); the update count moves on and the scheduler sets the
   next lr.

The dropout key depends on the update count and nothing drawn before it,
so a run resumed from a checkpoint draws the stream an uninterrupted run
draws.  ``valid_step`` runs the forward in eval mode under
``torch.no_grad()``, on the EMA's weights with ``--validate-with-ema``.
``state_dict`` / ``load_checkpoint`` carry the JAX checkpoint's groups:
weights, optimizer state, lr-scheduler state and update count, the EMA,
the meters and the training time.

The JAX trainer's parallel, health, chaos, telemetry and orbax machinery
is not ported, nor bf16 and its stochastic rounding.
"""

import contextlib
import logging
import os
import time
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from unicore_tpu_torch import checkpoint_utils, optim
from unicore_tpu_torch.ema import EMA
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
        ema_decay = getattr(args, "ema_decay", -1.0)
        self.ema = EMA(self.params, ema_decay) if ema_decay > 0 else None
        self._num_updates = 0
        self._start_time = time.time()
        self._previous_training_time = 0.0
        self.resumed_from_update = None
        self.micro_batches = 0
        self.tokens = 0
        self.samples = 0
        self.micro_batch_lengths: List[int] = []
        self.step_ms: List[float] = []
        self.update_losses: List[float] = []
        self.update_lrs: List[float] = []

    # -- data ----------------------------------------------------------------

    def get_train_iterator(self, epoch):
        return self.task.get_batch_iterator(
            dataset=self.task.dataset(self.args.train_subset),
            batch_size=self.args.batch_size,
            seed=self.args.seed,
            epoch=epoch,
        )

    def get_valid_iterator(self, subset):
        """Every batch of ``subset`` in corpus order (call
        ``next_epoch_itr(shuffle=False)``)."""
        return self.task.get_batch_iterator(
            dataset=self.task.dataset(subset),
            batch_size=getattr(self.args, "batch_size_valid", None) or self.args.batch_size,
            seed=self.args.seed,
            epoch=1,
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

    def cumulative_training_time(self):
        """Seconds trained, this process's and every run it resumed."""
        return time.time() - self._start_time + self._previous_training_time

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
            if self.ema is not None:
                self.ema.update(self.params)
        else:
            logger.warning(f"non-finite gradient norm {gnorm}: update skipped")
        self.set_num_updates(self.get_num_updates() + 1)

        with metrics.aggregate("train"), metrics.aggregate("train_inner"):
            self.task.reduce_metrics(logging_outputs, self.loss)
            metrics.log_scalar("gnorm", gnorm, priority=400, round=3)
        loss_sum = sum(float(log["loss"]) for log in logging_outputs)
        self.update_losses.append(loss_sum / max(float(sample_size), 1e-8) / np.log(2))
        self.update_lrs.append(lr)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        return gnorm

    # -- validation ----------------------------------------------------------

    @torch.no_grad()
    def valid_step(self, sample):
        """The loss's logging output of one batch in eval mode (no dropout),
        None for an empty batch."""
        if not sample:
            return None
        self.model.eval()
        _, _, logging_output = self.loss(self.model, _to_device(sample, self.device))
        return logging_output

    @contextlib.contextmanager
    def eval_weights(self):
        """With ``--validate-with-ema`` the EMA's weights stand in the model's
        parameters for the block (cast to their type), and the trained
        weights come back bit for bit after it."""
        if self.ema is None or not getattr(self.args, "validate_with_ema", False):
            yield
            return
        params = list(self.params.values())
        saved = [p.detach().clone() for p in params]
        with torch.no_grad():
            for p, e in zip(params, self.ema.shadow.values()):
                p.copy_(e)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)

    # -- checkpoint ----------------------------------------------------------

    def state_dict(self):
        """The checkpoint, in the JAX package's layout: ``args``, ``model``,
        ``optimizer_state``, ``optimizer_history`` (the lr scheduler and the
        update count), ``extra_state`` (meters, training time) and, with
        ``--ema-decay``, ``ema``.  ``unicore-tpu-torch-serve`` reads ``args``
        and ``model``."""
        save_opt = not getattr(self.args, "no_save_optimizer_state", False)
        state = {
            "args": self.args,
            "model": self.model.state_dict(),
            "optimizer_state": self._optimizer.state_dict() if save_opt else None,
            "optimizer_history": [{
                "optimizer_name": type(self._optimizer).__name__,
                "lr_scheduler_state": self._lr_scheduler.state_dict(),
                "num_updates": self.get_num_updates(),
            }],
            "extra_state": {
                "metrics": metrics.state_dict(),
                "previous_training_time": self.cumulative_training_time(),
            },
        }
        if self.ema is not None:
            state["ema"] = self.ema.state_dict()
        return state

    def save_checkpoint(self, filename, extra_state):
        """Write :meth:`state_dict` with ``extra_state`` (the iterator
        position, the validation loss, the best score) merged in."""
        state = self.state_dict()
        state["extra_state"].update(extra_state)
        checkpoint_utils.write_checkpoint(filename, state.pop("args"), state.pop("model"),
                                          **state)
        logger.info(f"saved checkpoint {filename} (update {self.get_num_updates()})")

    def load_checkpoint(self, filename, reset_optimizer=False, reset_lr_scheduler=False,
                        reset_dataloader=False, optimizer_overrides=None,
                        reset_meters=False):
        """Restore from ``filename`` what the resets leave: the weights
        always (the EMA's with ``--load-from-ema``), the EMA when the run
        keeps one, the optimizer state and update count unless
        ``reset_optimizer``, the lr scheduler unless ``reset_lr_scheduler``,
        the meters unless ``reset_meters``.  Returns the checkpoint's
        ``extra_state`` (None when there is no file); ``reset_dataloader``
        is the caller's to apply to its ``train_iterator``.  A checkpoint
        that lacks a group resumes without it, with a warning naming it."""
        if not os.path.exists(filename):
            logger.info(f"No existing checkpoint found {filename}")
            return None
        logger.info(f"Preparing to load checkpoint {filename}")
        state = checkpoint_utils.upgrade_state(checkpoint_utils.load_checkpoint_to_cpu(filename))
        extra_state = state.get("extra_state")
        lacking = [k for k in ("optimizer_state", "optimizer_history", "extra_state")
                   if state.get(k) is None]
        lacking += [f"extra_state.{k}" for k in ("metrics", "previous_training_time",
                                                 "train_iterator")
                    if extra_state is not None and k not in extra_state]
        if self.ema is not None and state.get("ema") is None:
            lacking.append("ema")
        if lacking:
            logger.warning(f"checkpoint {filename} has no {', '.join(lacking)}: "
                           "resuming without them")

        self.model.load_state_dict(state["model"])
        if getattr(self.args, "load_from_ema", False) and state.get("ema") is not None:
            with torch.no_grad():
                for n, p in self.params.items():
                    p.copy_(state["ema"][n])
        if self.ema is not None:
            if state.get("ema") is not None:
                self.ema.load_state_dict(state["ema"])
            else:  # start the average at the loaded weights
                self.ema = EMA(self.params, self.ema.decay)
        if not reset_optimizer and state.get("optimizer_state") is not None:
            if not self._optimizer.load_state_dict(state["optimizer_state"],
                                                   optimizer_overrides):
                logger.warning(
                    "optimizer state in checkpoint does not match the current "
                    "parameters; resetting optimizer state (Adam moments restart "
                    "from zero)")
        if state.get("optimizer_history"):
            last = state["optimizer_history"][-1]
            if not reset_lr_scheduler:
                self._lr_scheduler.load_state_dict(last["lr_scheduler_state"])
            if not reset_optimizer:
                self.set_num_updates(last["num_updates"])
                self.resumed_from_update = last["num_updates"]
        if extra_state is not None:
            if not reset_meters and "metrics" in extra_state:
                metrics.load_state_dict(extra_state["metrics"])
            self._previous_training_time = extra_state.get("previous_training_time", 0.0)
            self._start_time = time.time()
        logger.info(f"Loaded checkpoint {filename} (@ {self.get_num_updates()} updates)")
        return extra_state
