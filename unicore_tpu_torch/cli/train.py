#!/usr/bin/env python3
"""``unicore-tpu-torch-train``: the training entry point of the PyTorch/CUDA
port (counterpart of ``unicore_tpu_cli/train.py``).

``main`` builds the task, the model (weights from ``--seed``), the loss and
the :class:`Trainer`, loads the train split, restores the run from its
checkpoint (``restore_session``: ``--save-dir``'s ``checkpoint_last.pt``,
an explicit ``--restore-file``, or ``--finetune-from-model``, with the
``--reset-*`` flags), and trains epoch after epoch.  After every update a
:class:`TrainSession` decides, as the JAX CLI does, whether to stop
(``--max-update``, ``--stop-time-hours``, ``--stop-min-lr``, ``--patience``
validations without a better score), validate (every
``--validate-interval`` epochs and ``--validate-interval-updates``
updates, beside every mid-epoch save, and when stopping) and save (every
``--save-interval`` epochs and ``--save-interval-updates`` updates, and
when stopping) under the JAX save-name matrix: ``checkpoint{epoch}.pt``,
``checkpoint_{epoch}_{update}.pt``, ``checkpoint_best.pt``,
``checkpoint_last.pt``, pruned by the ``--keep-*`` flags.  Each epoch ends
with the epoch-level ``lr_step`` on the first subset's validation loss,
taken before the end-of-epoch checkpoint is written (the JAX CLI steps
after it), so a run resumed from an epoch boundary has the step too.  A
validation subset with no data on disk is skipped with a warning.

The last line it prints is ``TRAIN stats {json}``: updates (the run's
count, resumed ones included), ``resumed_from_update``, micro-batches and
the padded length of each, this process's per-update losses (the summed
loss over the summed sample size, in bits) and lrs, every validation's
loss (``valid_losses``: the best-checkpoint metric as the JAX CLI rounds
it; ``validations``: each with its update and unrounded loss), the best
score, step times (``step_ms``: inside ``train_step``; ``update_wall_ms``:
from one update's end to the next's, the batches' loading included), the
consumed iterator position after each update, real (non-pad) tokens/s (MSA tokens for the
Evoformer), samples/s, peak device memory, the launch count of every
kernel, the compute ``dtype``, ``bf16_sr``, the loss scale of each update
(``loss_scale``; 1.0 outside ``--fp16``), each update's gradient norm
(non-finite where it overflowed) and the overflowed updates.

``--device cuda`` (the default) needs a visible CUDA card and exits 76
naming the missing card; ``--device cpu`` is the explicit CPU run (the
kernels' plain versions).  Precision is fp32 with TF32 off, as the
server, unless ``--bf16`` / ``--fp16`` (``Trainer``); then cuBLAS is told
to keep its reductions of bf16 and fp16 products in fp32, as the TPU's
matrix unit accumulates.
Batches load on ``--num-workers`` threads behind a ``--data-buffer-size``
read-ahead; ``--prefetch-to-device`` adds the device prefetcher
(``data/prefetch.py``), which the trainer's ``maybe_prefetch`` /
``finish_prefetch`` start and stop around each epoch.

The robustness plane, as the JAX CLI's: SIGTERM and SIGINT
(``distributed/guard.py``) stop the run after the update in flight with a
checkpoint (through the minimal emergency path under
``--preemption-save-deadline``; no validation) and exit 0, a second SIGINT
aborts; after each update ``trainer.health_check`` runs the health
sentinel (``--sentinel-interval``), whose ``TrainingHealthError`` ends the
run with a nonzero exit; ``--emergency-save-on-error`` writes
``checkpoint_emergency.pt`` before a fatal error unwinds; checkpoints are
published on a copy thread under ``--async-checkpoint``.  The stats line
adds the update counter after each update (``update_ids``: a rewind steps
it back), the sentinel's ``sentinel_events``, each snapshot's bytes and
times (``snapshots``), the checkpoint write and publish seconds and the
stop signal.

Data parallelism, as the JAX CLI's: ``--distributed-world-size N`` spawns N
ranks (``distributed/utils.py`` ``call_main``; or one rank each under
``torchrun`` / ``--distributed-no-spawn``), NCCL on the card and gloo on the
CPU (``--distributed-backend``; two ranks on one card need gloo), each
with ``--batch-size`` rows a micro-batch on its shard of the batches
(``Trainer``).  Every rank runs the same cadence: the stop flag is agreed
after each update, validation is sharded and its sums reduced, rank 0
writes the checkpoints and every rank loads them.  Only rank 0 logs the
progress lines and prints ``TRAIN stats``, its values the reduced ones;
the line adds ``distributed`` (world size, backend, plan and the gradient
reduction's milliseconds and bytes) and ``ranks``: each rank's launches,
micro-batches, tokens, memory (``memory``: the ``--zero-stage``, the
optimizer-state bytes the rank holds, its peak allocated bytes on a card)
and a sha256 of its parameters after the run.  The JAX CLI's elastic
restarts are not ported.

Logging and telemetry, as the JAX CLI's: progress goes through the JAX
progress bars (``--log-format json|simple|tqdm|none``; tqdm, the default
unless ``--no-progress-bar``, turns into simple lines off a TTY): a
``train_inner`` line of the JAX stat set every ``--log-interval`` updates,
a ``train`` line at each epoch's end and a line for each validation subset,
mirrored to TensorBoard under ``--tensorboard-logdir`` on rank 0.  The
event journal (``--telemetry-dir``, default ``<save-dir>/telemetry``)
gets the run's events with the JAX package's fields (``comm-plan``,
``checkpoint-*``, ``sentinel-*``, ``agreed-stop`` at every stop, sampled
``span`` records under ``--telemetry-sample-interval``, ``profile-start`` /
``profile-stop`` around a ``--profile-steps`` window); rank 0 serves the
trainer's ``/metrics`` on ``--metrics-port``; ``--profile`` traces the
whole run into ``<save-dir>/torch_trace/``.  ``unicore-tpu-torch-trace``
merges the journals.
"""

import json
import logging
import math
import sys
import time
from typing import List, Optional

_LOG_FIELDS = ("asctime", "levelname", "name", "message")
logger = logging.getLogger("unicore_tpu_torch.cli.train")

EXIT_NO_DEVICE = 76


class EarlyStopMonitor:
    """Trips once the tracked validation metric fails to improve ``patience``
    validations in a row.  A non-positive patience disables the monitor;
    validations that produced no metric are ignored."""

    def __init__(self, patience: int, maximize: bool):
        self.patience = patience
        self.maximize = maximize
        self.best: Optional[float] = None
        self.strikes = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        return value > self.best if self.maximize else value < self.best

    def should_stop(self, value: Optional[float]) -> bool:
        if value is None or self.patience <= 0:
            return False
        if self._improved(value):
            self.best = value
            self.strikes = 0
            return False
        self.strikes += 1
        if self.strikes < self.patience:
            return False
        logger.info(f"early stop: validation metric stagnant for {self.strikes} "
                    f"consecutive validations (patience {self.patience})")
        return True


class TrainSession:
    """One training run: the trainer, the early-stop monitor and the
    save / validate / stop cadence."""

    def __init__(self, args, trainer, task):
        from unicore_tpu_torch import checkpoint_utils

        self.args = args
        self.trainer = trainer
        self.task = task
        self.early_stop = EarlyStopMonitor(args.patience,
                                           args.maximize_best_checkpoint_metric)
        self.valid_subsets = args.valid_subset.split(",")
        self.validations: List[dict] = []
        #: the publish thread of --async-checkpoint (rank 0 publishes)
        from unicore_tpu_torch.distributed import utils as distributed_utils

        self.copy_pool = (checkpoint_utils.make_copy_pool()
                          if getattr(args, "async_checkpoint", False)
                          and distributed_utils.is_master() else None)
        self.stop_signal: Optional[str] = None

    def hard_stop_reason(self, preempt_sig: Optional[str] = None) -> Optional[str]:
        """The stop conditions checked after every update: a graceful-stop
        signal (``preempt_sig``, the decision every rank shares), the update
        budget and the wall-clock budget."""
        if preempt_sig:
            return (f"received {preempt_sig}: graceful stop — the in-flight update "
                    "finished; saving a checkpoint and exiting 0")
        n = self.trainer.get_num_updates()
        if self.args.max_update and n >= self.args.max_update:
            return f"num_updates: {n} hit --max-update ({self.args.max_update})"
        if self.args.stop_time_hours > 0:
            trained_h = self.trainer.cumulative_training_time() / 3600.0
            if trained_h > self.args.stop_time_hours:
                return (f"exceeded --stop-time-hours ({trained_h:.2f}h > "
                        f"{self.args.stop_time_hours}h)")
        return None

    def lr_floor_reached(self) -> bool:
        if self.args.stop_min_lr <= -1:
            return False
        return self.trainer.get_lr() <= self.args.stop_min_lr

    @staticmethod
    def _on_interval(count: int, every: int) -> bool:
        return every > 0 and count > 0 and count % every == 0

    def cadence(self, epoch: int, end_of_epoch: bool, stopping: bool):
        """(save?, validate?) at the current position of the run: saves at
        --save-interval epoch boundaries, every --save-interval-updates once
        past --validate-after-updates, and when stopping; validation beside
        every mid-epoch save, at --validate-interval epoch boundaries, every
        --validate-interval-updates, and when stopping, unless disabled."""
        n = self.trainer.get_num_updates()
        a = self.args
        save = (
            stopping
            or (end_of_epoch and self._on_interval(epoch, a.save_interval))
            or (self._on_interval(n, a.save_interval_updates)
                and n >= a.validate_after_updates)
        )
        validate = not a.disable_validation and (
            stopping
            or (save and not end_of_epoch)
            or (end_of_epoch and self._on_interval(epoch, a.validate_interval))
            or self._on_interval(n, a.validate_interval_updates)
        )
        return save, validate

    def checkpoint_and_validate(self, epoch_itr, end_of_epoch: bool):
        """After an update: the stop conditions, validation, at the end of
        an epoch the epoch-level lr step, and the checkpoint by the
        cadence; returns (validation losses, stop?).  A stop signal skips
        validation (the grace period is short) and saves through the
        minimal emergency path under ``--preemption-save-deadline``."""
        from unicore_tpu_torch import checkpoint_utils
        from unicore_tpu_torch.distributed import guard

        from unicore_tpu_torch import telemetry

        preempt_sig = guard.stop_requested_global()
        reason = self.hard_stop_reason(preempt_sig)
        if reason:
            logger.info(f"stopping training: {reason}")
            # the agreed stop point: every rank journals the SAME update
            telemetry.emit("agreed-stop", update=self.trainer.get_num_updates(),
                           reason=reason, signal=str(preempt_sig) if preempt_sig else None)
        stopping = reason is not None
        do_save, do_validate = self.cadence(epoch_itr.epoch, end_of_epoch, stopping)
        if preempt_sig:
            self.stop_signal = preempt_sig
            do_validate = False
        valid_losses: List[Optional[float]] = [None]
        if do_validate:
            self.trainer.flush_metrics()
            valid_losses = validate(self.args, self.trainer, self.task,
                                    self.valid_subsets, self.validations,
                                    epoch=epoch_itr.epoch)
        if self.early_stop.should_stop(valid_losses[0]):
            stopping = True
        if self.lr_floor_reached():
            logger.info(f"stopping training: lr {self.trainer.get_lr()} fell to "
                        f"--stop-min-lr ({self.args.stop_min_lr})")
            stopping = True
        if end_of_epoch:  # epoch-level schedules key off the first subset
            self.trainer.lr_step(epoch_itr.epoch, valid_losses[0])
        if do_save or stopping:
            emergency = ("preempt" if preempt_sig
                         and getattr(self.args, "preemption_save_deadline", 0) > 0 else None)
            checkpoint_utils.save_checkpoint(self.args, self.trainer, epoch_itr,
                                             valid_losses[0], self.copy_pool,
                                             emergency=emergency)
            if emergency is not None:
                # the emergency path drained and closed the pool
                self.copy_pool = None
        return valid_losses, stopping

    def close(self):
        """Let the publish thread finish what it holds."""
        if self.copy_pool is not None:
            self.copy_pool.close()
            self.copy_pool.join()
            self.copy_pool = None


def _maybe_emergency_save_on_error(args, trainer, epoch_itr, err) -> None:
    """``--emergency-save-on-error``: before a fatal error unwinds the
    process, one minimal save to ``checkpoint_emergency.pt``, a name apart
    (the crashing state may be the problem: it must neither clobber
    ``checkpoint_last`` nor be resumed).  Best effort: a second failure
    here must not mask the first."""
    if not getattr(args, "emergency_save_on_error", False):
        return
    from unicore_tpu_torch import checkpoint_utils

    logger.error(f"fatal trainer exception ({type(err).__name__}: {err}); attempting an "
                 "emergency checkpoint before aborting (--emergency-save-on-error)")
    try:
        checkpoint_utils.save_checkpoint(args, trainer, epoch_itr, None, None,
                                         emergency="error")
    except Exception:
        logger.exception("emergency save failed; aborting without it")


def restore_session(args, trainer):
    """Load the run's checkpoint, if any, and return the epoch iterator
    positioned where the saved run left off (the epoch's start with
    ``--reset-dataloader``)."""
    from unicore_tpu_torch import checkpoint_utils

    extra_state = checkpoint_utils.load_checkpoint(args, trainer)
    saved_itr = ((extra_state or {}).get("train_iterator")
                 if not args.reset_dataloader else None)
    if saved_itr is not None:
        epoch_itr = trainer.get_train_iterator(epoch=saved_itr["epoch"])
        epoch_itr.load_state_dict(saved_itr)
    else:
        epoch_itr = trainer.get_train_iterator(epoch=1)
    return epoch_itr


_EPOCH_DONE = object()


def train_epoch(args, session, epoch_itr):
    """One epoch of updates (the rest of it, when resumed mid-epoch), as
    the JAX CLI's loop: the update's wait on the iterator is the next
    update's ``data_wait`` span, each update runs in the ``train_inner``
    aggregator, and every ``--log-interval`` updates the trainer's sums are
    flushed and logged; returns True when training should stop."""
    from unicore_tpu_torch import telemetry
    from unicore_tpu_torch.data import iterators
    from unicore_tpu_torch.distributed import utils as distributed_utils
    from unicore_tpu_torch.logging import metrics

    trainer = session.trainer
    with metrics.aggregate(name="train"):
        epoch = epoch_itr.next_epoch_idx
        itr = epoch_itr.next_epoch_itr(shuffle=epoch > args.curriculum)
        update_freq = args.update_freq[min(epoch, len(args.update_freq)) - 1]
        itr = iterators.GroupedIterator(itr, update_freq)
        trainer.begin_epoch(epoch)
        itr = trainer.maybe_prefetch(itr, epoch_itr)
        progress = _make_progress(
            args, itr, epoch,
            wandb_project=args.wandb_project if distributed_utils.is_master() else None,
            wandb_name=args.wandb_name)
        # the run identity into the external sinks, so a TensorBoard run is
        # joinable with its journals
        progress.log_config(telemetry.log_config_payload(args))
        stop = False
        num_updates = trainer.get_num_updates()
        try:
            progress_iter = iter(progress)
            while True:
                # how long the training thread waits on the iterator, the
                # NEXT update's data_wait; entering it also collects a
                # pending lag-1 device probe
                with telemetry.spans.recorder().between_span("data_wait"):
                    samples = next(progress_iter, _EPOCH_DONE)
                if samples is _EPOCH_DONE:
                    break
                with metrics.aggregate("train_inner"):
                    trainer.train_step(samples)
                    # the sentinel's tick: before the flush, so the sums
                    # hold this update; a rewind skips `itr` ahead
                    trainer.health_check(epoch_itr, itr)
                    trainer.update_done.append(time.perf_counter())
                    num_updates = trainer.get_num_updates()
                    at_log_point = num_updates % args.log_interval == 0
                    if at_log_point:
                        trainer.flush_metrics()
                if at_log_point:
                    progress.log(_with_wall(metrics.get_smoothed_values("train_inner")),
                                 tag="train_inner", step=num_updates)
                    metrics.reset_meters("train_inner")
                trainer.iterations_per_update.append(epoch_itr.iterations_in_epoch)
                _, stop = session.checkpoint_and_validate(epoch_itr,
                                                          end_of_epoch=not itr.has_next())
                if stop:
                    break
        finally:
            trainer.finish_prefetch(itr)
    logger.info(f"end of epoch {epoch} (average epoch stats below)")
    trainer.flush_metrics()
    progress.print(_with_wall(metrics.get_smoothed_values("train")), tag="train",
                   step=num_updates)
    metrics.reset_meters("train")
    return stop


def _make_progress(args, itr, epoch, **extra):
    """The progress bar around a batch iterator; TensorBoard from rank 0
    only."""
    from unicore_tpu_torch.distributed import utils as distributed_utils
    from unicore_tpu_torch.logging import progress_bar

    tb_dir = (getattr(args, "tensorboard_logdir", "") or None
              if distributed_utils.is_master() else None)
    fmt = "simple" if getattr(args, "no_progress_bar", False) else "tqdm"
    return progress_bar.progress_bar(
        itr, log_format=getattr(args, "log_format", None),
        log_interval=getattr(args, "log_interval", 100), epoch=epoch,
        tensorboard_logdir=tb_dir, default_log_format=fmt, **extra)


def _with_wall(stats):
    from unicore_tpu_torch.logging import metrics

    stats["wall"] = round(metrics.get_meter("default", "wall").elapsed_time, 0)
    return stats


def validate(args, trainer, task, subsets, records, epoch=None):
    """Every batch of each validation subset in corpus order, in eval mode
    (on the EMA's weights with ``--validate-with-ema``), each rank its shard;
    the logging outputs are summed over the batches and the ranks before
    the loss reduces them, and the subset's stats (the JAX CLI's: the
    loss's, ``num_updates`` and ``best_<metric>``) are printed through a
    progress bar tagged with the subset's name.
    Returns the ``--best-checkpoint-metric`` of each subset (None for a
    subset with no data on disk) and appends a record of each to
    ``records`` (its update, unrounded loss and metric)."""
    from unicore_tpu_torch import checkpoint_utils
    from unicore_tpu_torch.distributed import utils as distributed_utils
    from unicore_tpu_torch.logging import metrics

    results = []
    with trainer.eval_weights():
        for subset in subsets:
            if subset not in task.datasets:
                try:
                    task.load_dataset(subset)
                except FileNotFoundError as err:
                    logger.warning(f'no "{subset}" subset to validate on ({err})')
                    results.append(None)
                    continue
            logger.info(f'begin validation on "{subset}" subset')
            itr = trainer.get_valid_iterator(subset).next_epoch_itr(shuffle=False)
            progress = _make_progress(args, itr, epoch, prefix=f"valid on '{subset}' subset")
            totals = {}
            for i, sample in enumerate(progress):
                if args.max_valid_steps is not None and i > args.max_valid_steps:
                    break
                out = trainer.valid_step(sample)
                for k, v in (out or {}).items():
                    totals[k] = totals.get(k, 0) + v
            if distributed_utils.get_world_size() > 1:
                shards = distributed_utils.all_gather_list(
                    {k: float(v) for k, v in totals.items()})
                totals = {}
                for shard in shards:
                    for k, v in shard.items():
                        totals[k] = totals.get(k, 0.0) + v
            if not totals:
                results.append(None)
                continue
            with metrics.aggregate(new_root=True) as agg:
                task.reduce_metrics([totals], trainer.loss, subset)
            stats = agg.get_smoothed_values()
            stats["num_updates"] = trainer.get_num_updates()
            metric = args.best_checkpoint_metric
            best = checkpoint_utils.best_score()
            if best is not None and metric in stats:
                pick = max if args.maximize_best_checkpoint_metric else min
                stats[f"best_{metric}"] = pick(best, stats[metric])
            progress.print(stats, tag=subset, step=trainer.get_num_updates())
            results.append(stats.get(metric))
            records.append({"update": trainer.get_num_updates(), "subset": subset,
                            "loss": agg["loss"].val if "loss" in agg else None,
                            "metric": stats.get(metric)})
    return results


def main(args, device) -> dict:
    from unicore_tpu_torch.distributed import guard
    from unicore_tpu_torch.distributed import utils as distributed_utils

    # SIGTERM/SIGINT: finish the update in flight, save, exit 0 (a second
    # SIGINT aborts); the caller's handlers come back when the run ends
    guard.install_signal_handlers()
    # only rank 0 logs below warnings
    root = logging.getLogger()
    level = root.level
    if not distributed_utils.is_master():
        root.setLevel(logging.WARNING)
    try:
        return _train(args, device)
    finally:
        root.setLevel(level)
        guard.restore_signal_handlers()


def _train(args, device) -> dict:
    import numpy as np
    import torch

    import os

    from unicore_tpu_torch import checkpoint_utils, tasks, telemetry
    from unicore_tpu_torch.distributed import utils as distributed_utils
    from unicore_tpu_torch.logging import metrics
    from unicore_tpu_torch.ops import _kernels
    from unicore_tpu_torch.trainer import Trainer

    assert args.batch_size is not None, "Must specify --batch-size"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.bf16 or args.fp16:
        # bf16/fp16 products summed in fp32, as the TPU's matrix unit does
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    np.random.seed(args.seed)
    metrics.reset()
    checkpoint_utils.set_best_score(None)
    checkpoint_utils.reset_save_seconds()
    logger.info(args)
    # a flag error fails the launch, not update START
    telemetry.profiler.parse_profile_steps(getattr(args, "profile_steps", None))
    telemetry.reset()

    task = tasks.setup_task(args)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    model = task.build_model(args, device=device, generator=generator)
    loss = task.build_loss(args)
    trainer = Trainer(args, task, model, loss, device)
    logger.info(
        f"task {type(task).__name__}, model {type(model).__name__} "
        f"({sum(p.numel() for p in model.parameters())} parameters), loss "
        f"{type(loss).__name__}, device {device}"
    )

    # the telemetry plane: the event journal, the step spans and the
    # --profile-steps window (a collective: every rank adopts rank 0's run
    # id), and rank 0's /metrics port
    telemetry.configure(args, rank=distributed_utils.get_global_rank(),
                        step_provider=trainer.get_num_updates, role="trainer")
    metrics_server = (telemetry.prometheus.start_metrics_server(args.metrics_port)
                      if distributed_utils.is_master() else None)
    if args.tensorboard_logdir and distributed_utils.is_master():
        os.makedirs(args.tensorboard_logdir, exist_ok=True)

    task.load_dataset(args.train_subset)
    session = None
    whole_run = None
    try:
        epoch_itr = restore_session(args, trainer)
        session = TrainSession(args, trainer, task)
        _kernels.reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if args.profile:
            whole_run = telemetry.profiler.start_profiler(device.type == "cuda")
        started = time.time()
        last_epoch = args.max_epoch or math.inf
        try:
            while epoch_itr.next_epoch_idx <= last_epoch:
                if train_epoch(args, session, epoch_itr):
                    break
                epoch_itr = trainer.get_train_iterator(epoch_itr.next_epoch_idx)
        except Exception as err:
            _maybe_emergency_save_on_error(args, trainer, epoch_itr, err)
            raise
        wall = time.time() - started
    finally:
        if whole_run is not None:
            telemetry.profiler.stop_profiler(whole_run, os.path.join(
                args.save_dir, "torch_trace",
                f"rank{distributed_utils.get_global_rank()}.pt.trace.json"))
        # a --profile-steps window still open at run end (or at an error
        # unwind) closes cleanly, not as a torn trace
        telemetry.profiler.close(trainer.get_num_updates())
        if session is not None:
            session.close()
        if metrics_server is not None:
            metrics_server.shutdown()
            metrics_server.server_close()
        # the journal closes with the run (an in-process caller's next run
        # configures its own)
        telemetry.reset()

    steady = trainer.step_ms[1:] or trainer.step_ms or [float("nan")]
    # between the ends of consecutive updates: the step, the batches'
    # loading on the training thread (or what the loader threads take of
    # it) and the cadence's work
    update_wall_ms = [(b - a) * 1e3 for a, b in zip(trainer.update_done,
                                                   trainer.update_done[1:])]
    train_s = sum(trainer.step_ms) / 1e3
    stats = {
        "updates": trainer.get_num_updates(),
        "resumed_from_update": trainer.resumed_from_update,
        "micro_batches": trainer.micro_batches,
        "micro_batch_lengths": trainer.micro_batch_lengths,
        "loss_per_update": trainer.update_losses,
        "lr_per_update": trainer.update_lrs,
        "valid_losses": [v["metric"] for v in session.validations],
        "validations": session.validations,
        "best": checkpoint_utils.best_score(),
        "step_ms": trainer.step_ms,
        "median_step_ms": float(np.median(steady)),
        "update_wall_ms": update_wall_ms,
        "median_update_wall_ms": float(np.median(update_wall_ms or [float("nan")])),
        "tokens": trainer.tokens,
        "tokens_per_s": trainer.tokens / train_s if train_s else None,
        "samples": trainer.samples,
        "samples_per_s": trainer.samples / train_s if train_s else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "memory": trainer.memory_stats(),
        "kernel_launches": _kernels.launch_counts(),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "dtype": str(trainer.compute_dtype).replace("torch.", ""),
        "bf16_sr": bool(args.bf16_sr) and trainer.compute_dtype == torch.bfloat16,
        "loss_scale": trainer.update_loss_scales,
        "gnorm_per_update": trainer.update_gnorms,
        "overflows": trainer.overflows,
        "iterations_in_epoch": trainer.iterations_per_update,
        "update_ids": trainer.update_ids,
        "sentinel_events": (trainer.sentinel.events if trainer.sentinel is not None
                            else []),
        "snapshots": trainer.snapshot_timings(),
        "checkpoint_seconds": checkpoint_utils.save_seconds(),
        "stop_signal": session.stop_signal,
        "wall_s": wall,
    }
    reduction = trainer.reduction_stats()
    if reduction is not None:
        stats["distributed"] = {"world_size": distributed_utils.get_world_size(),
                                "dp_world_size": trainer.dp_world_size, **reduction}
        stats["ranks"] = distributed_utils.all_gather_list({
            "rank": trainer.dp_rank, "kernel_launches": stats["kernel_launches"],
            "micro_batches": trainer.micro_batches, "tokens": trainer.tokens,
            "samples": trainer.samples, "median_step_ms": stats["median_step_ms"],
            "param_sha256": param_digest(trainer.model), "memory": stats["memory"],
        })
    logger.info(f"done training in {wall:.1f} seconds")
    if distributed_utils.is_master():
        print("TRAIN stats " + json.dumps(stats), flush=True)
    return stats


def param_digest(model) -> str:
    """sha256 over the model's parameters' raw bytes in order: equal on two
    ranks exactly when their parameters are the same bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for p in model.parameters():
        t = p.detach().contiguous().cpu()
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def configure_logging() -> None:
    logging.basicConfig(
        format=" | ".join(f"%({f})s" for f in _LOG_FIELDS),
        datefmt="%Y-%m-%d %H:%M:%S",
        level=logging.INFO,
        stream=sys.stdout,
    )


def _rank_main(args) -> dict:
    """One rank's run, inside its process group (the device is the one
    ``distributed_init`` set)."""
    from unicore_tpu_torch.cli.serve import resolve_device

    return main(args, resolve_device(args.device))


def cli_main(argv=None) -> int:
    from unicore_tpu_torch import options
    from unicore_tpu_torch.cli.serve import resolve_device
    from unicore_tpu_torch.distributed import utils as distributed_utils

    configure_logging()
    parser = options.get_training_parser()
    args = options.parse_args_and_arch(parser, argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        # asked without a CUDA context: the spawned ranks make their own
        try:
            resolve_device(args.device)
        except RuntimeError as err:
            logger.error(str(err))
            return EXIT_NO_DEVICE
    distributed_utils.call_main(args, _rank_main, setup=configure_logging)
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
