"""The training loop's update (counterpart of ``unicore_tpu/trainer.py``,
lean): ``train_step`` over the ``--update-freq`` micro-batches of one
update, ``valid_step``, the EMA, the lr schedule and the checkpoint.

Precision, as the JAX trainer's policy: the model's floating parameters
are cast to the compute dtype (bf16 under ``--bf16``, else fp16 under
``--fp16``, else fp32; integer buffers stay as they are), so activations
run in it too; the optimizer keeps an fp32 master of low-precision
parameters; ``--fp16`` scales the loss by the dynamic loss scale
(``optim/dynamic_loss_scaler.py``).

One update, as the JAX ``train_step`` / ``_forward_backward`` /
``_apply_update``:

1. for each micro-batch ``i``: forward and loss in training mode, with
   dropout from a :class:`DropoutRng` keyed on (``--seed``, update, i), and
   the backward of the fp32 loss times the loss scale; the micro-batch's
   gradient is added into fp32 accumulators and ``.grad`` cleared (autograd
   would sum ``.grad`` in the parameter's type: bf16 under ``--bf16``);
2. every gradient is divided by the summed ``sample_size`` times the loss
   scale;
3. clipped to ``--clip-norm`` by the global norm;
4. a non-finite norm is an overflow: it skips the optimizer step and the
   EMA (the update still counts); under ``--fp16`` every update steps the
   loss-scale schedule, and a scale pinned at ``--min-loss-scale`` raises
   ``FloatingPointError`` at the next :meth:`flush_metrics`;
5. Adam with the lr the scheduler gave for this update on the fp32 master
   (copied back to the parameters, stochastically rounded under
   ``--bf16-sr`` with noise keyed on (``--seed``, update)), then the EMA
   (``--ema-decay``) of the master; the update count moves on and the
   scheduler sets the next lr.

Variants, as the JAX trainer's: under ``--fused-adam`` the gradients
accumulate in the optimizer's flat buffers, and steps 2-5 are the
``multi_tensor_l2norm`` kernel (the norm of the gradients divided by the
device scalar, nothing rewritten) and the ``fused_adam`` kernel per dtype
group (clip, decay, moments, update, copy-back), which reads the norm on the
device and skips itself on an overflow; under ``--grad-accum adama`` each
micro-batch's gradient folds into the moment accumulators and the
normalisation and clip are deferred into the moment recovery;
``--per-sample-clip-norm`` runs each row of a micro-batch as its own
batch-1 backward, clipped before the sum; ``--nan-rerun`` re-runs the first
micro-batch of an update whose norm is non-finite under
:class:`~unicore_tpu_torch.nan_detector.NanDetector` and raises
``FloatingPointError`` naming what it found.  ``train_step`` also takes a
:class:`~unicore_tpu_torch.data.prefetch.PreparedUpdate` from the device
prefetcher (``maybe_prefetch`` / ``finish_prefetch``).

The dropout key depends on the update count and nothing drawn before it,
so a run resumed from a checkpoint draws the stream an uninterrupted run
draws.  ``valid_step`` runs the forward in eval mode under
``torch.no_grad()`` in the compute dtype, on the EMA's weights (cast to the
parameters' type) with ``--validate-with-ema``.
``state_dict`` / ``load_checkpoint`` carry the JAX checkpoint's groups:
weights (in the compute dtype), optimizer state (with the master), lr-
scheduler state and update count, the EMA, the meters, the training time
and the loss scale -- here with the schedule's counters too, which the JAX
package's pickled checkpoint drops, so an fp16 run resumes as it would
have gone on.

The robustness plane, as the JAX trainer's: ``--fault-inject``
(``distributed/chaos.py``) raises at an update or folds a loss spike or a
gradient explosion into the update's denominator (so under
``--fused-adam`` through the two kernels), the durable-write policy
(``checkpoint/durable.py``) is configured here, and with
``--sentinel-interval`` > 0 the health sentinel (``health/``) judges the
running metric sums (``_macc``, host floats under the JAX keys, reset only
by :meth:`flush_metric_sums`) after each update (:meth:`health_check`),
snapshots the training state into pinned host buffers on a side stream
(:meth:`capture_health_snapshot`), rewinds in place
(:meth:`restore_health_snapshot`) and scales the lr during a cooldown;
its history rides the checkpoint's ``extra_state["sentinel"]``.

Data parallelism, as the JAX trainer's (one process a rank,
``parallel/``): with a process group (``distributed/utils.py``) rank 0's
weights are broadcast at initialisation, each rank runs its own shard of the
batches (``--batch-size`` per rank) with dropout keyed on (``--seed``,
update, micro-batch, rank) -- the rank folded in only at world size above 1,
so a run of one rank draws the stream it draws without a group -- and after
the last micro-batch the gradients are reduced once over the ranks
(``parallel/hierarchy.py``: flat, or two-level under ``--num-pods``; under
``--grad-accum adama`` each micro-batch's, before its fold), and the sample
size and the logging outputs are summed over the ranks before the
normalisation.  So the clip, K-a's norm, the update, the overflow decision
and the sentinel's sums are the same bits on every rank.  A rank whose shard
ran out (the epoch's tail) runs the cached first batch with weight 0, so
every rank takes part in every reduction.

Logging and telemetry, as the JAX trainer's: each update folds its
logging outputs, gradient norm, clip and overflow into running sums
(``_macc``: the floats the sentinel reads are host floats, the loss's other
outputs stay device scalars), and :meth:`flush_metrics` (the CLI's
``--log-interval``, before a validation, at an epoch's end) turns them into
the JAX stat set -- the loss's stats, ``ups``, ``gnorm``, ``clip``,
``loss_scale``, ``gb_free`` on a card, ``transfer_wall``,
``prefetch_wall``, ``host_blocked`` and ``device_busy`` -- beside ``lr``
and ``num_updates`` (logged as the update count moves), ``train_wall``
(the seconds inside :meth:`train_step`) and ``wall`` (since the trainer
was built), and refreshes the Prometheus registry.  Each update opens and
closes a step-span bracket (``telemetry/spans.py``): ``h2d`` is the
training thread's host-to-device copies, ``dispatch`` the rest of the
update's wall (its host syncs included), and a sampled update hands the
lag-1 probe a CUDA event recorded after its last kernel.  The
``--profile-steps`` window ticks before and after each update.  The journal
gets ``checkpoint-load``, and ``fused-norm-path`` and ``comm-plan`` at the
first update (where the JAX trainer initialises its state).

ZeRO, as the JAX trainer's ``--zero-stage`` (``parallel/zero.py``): from
stage 1 each rank keeps and updates only its share of the optimizer state
(the moments, the fp32 master) and of the EMA -- its segment of the flat
buffers under ``--fused-adam``, else each tensor's slice -- and the
updated shares are all-gathered into every rank's parameters; stages 2/3
reduce-scatter the flat gradient buffers into the segments instead of
all-reducing them.  The norm is stage 0's bits at every stage.  Every
collective stays on the device: the ZeRO path adds no host read.  A
checkpoint holds the state whole (:meth:`consolidate_state`, which every
rank runs before rank 0 writes), and a load keeps each rank's share, so a
run resumes at another world size and stage.

The JAX trainer's tensor, pipeline and sequence parallelism and orbax
machinery are not ported; nor is its ``recompiles`` stat (eager PyTorch
compiles no step programs).
"""

import contextlib
import copy
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from unicore_tpu_torch import checkpoint_utils, health, optim, telemetry
from unicore_tpu_torch.checkpoint import durable
from unicore_tpu_torch.data.prefetch import DevicePrefetcher, PreparedUpdate
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.ema import EMA
from unicore_tpu_torch.logging import metrics
from unicore_tpu_torch.modules import DropoutRng
from unicore_tpu_torch.modules.dropout import fold_key
from unicore_tpu_torch.modules.layer_norm import LayerNorm, RMSNorm, journal_choice, norm_path
from unicore_tpu_torch.optim import lr_scheduler as lr_sched_mod
from unicore_tpu_torch.nan_detector import NanDetector
from unicore_tpu_torch.optim.dynamic_loss_scaler import init_scale_state, scale_schedule
from unicore_tpu_torch.optim.multi_tensor import clip_coef
from unicore_tpu_torch.optim.unicore_optimizer import clip_grad_norm
from unicore_tpu_torch.parallel import groups, hierarchy
from unicore_tpu_torch.parallel import plan as plan_mod
from unicore_tpu_torch.parallel import zero as zero_mod

#: folded into the SR noise's key, apart from the dropout's (the JAX
#: trainer's ``fold_in(rng, 1337)``)
_SR_FOLD = 1337

logger = logging.getLogger(__name__)


def _to_device(sample, device):
    if isinstance(sample, dict):
        return {k: _to_device(v, device) for k, v in sample.items()}
    if isinstance(sample, torch.Tensor):
        return sample.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(sample)).to(device, non_blocking=True)


def _rows(sample, a, b):
    """Rows a..b-1 of every batched tensor of a micro-batch."""
    if isinstance(sample, dict):
        return {k: _rows(v, a, b) for k, v in sample.items()}
    return sample[a:b] if getattr(sample, "ndim", 0) > 0 else sample


class Trainer(object):
    def __init__(self, args, task, model, loss, device):
        self.args = args
        self.task = task
        self.loss = loss
        self.device = torch.device(device)
        self.model = model.to(self.device)
        if getattr(args, "bf16", False):
            self.compute_dtype = torch.bfloat16
        elif getattr(args, "fp16", False):
            self.compute_dtype = torch.float16
        else:
            self.compute_dtype = torch.float32
        self.use_loss_scale = bool(getattr(args, "fp16", False))
        plan_mod.refuse_unported(args)
        with torch.no_grad():
            for p in self.model.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(self.compute_dtype)
        #: the data-parallel tier (one rank without a process group) and its
        #: gradient reduction (None without a group)
        self.dp_world_size = groups.dp_world_size()
        self.dp_rank = groups.dp_rank()
        self._reducer = hierarchy.GradReducer(groups.plan()) if groups.active() else None
        if self._reducer is not None:
            # every rank starts from rank 0's weights
            from unicore_tpu_torch.distributed import utils as distributed_utils

            distributed_utils.broadcast_tensors(list(self.model.state_dict().values()))
        #: a rank whose shard ran out runs this (its first batch, and its
        #: padded length) with weight 0
        self._dummy_batch = None
        self.params: Dict[str, torch.Tensor] = OrderedDict(
            (n, p) for n, p in self.model.named_parameters() if p.requires_grad
        )
        self.grad_accum = getattr(args, "grad_accum", "buffer") or "buffer"
        self._optimizer = optim.build_optimizer(args)
        if self.grad_accum == "adama" and not self._optimizer.supports_accum:
            raise ValueError(
                f"--grad-accum adama folds micro-batch gradients into the "
                f"optimizer's moment accumulators, which "
                f"{type(self._optimizer).__name__} does not support — use "
                "--optimizer adam or --grad-accum buffer")
        self._jax_names = checkpoint_utils.jax_param_names(self.model)
        #: ZeRO: the resolved stage and this rank's spec (None: every rank
        #: keeps the whole state)
        self.zero_stage = zero_mod.resolve_zero_stage(args)
        zero_mod.log_preset(args, self.dp_world_size)
        self.zero = zero_mod.spec_for(
            self.zero_stage, self.dp_world_size, self.dp_rank,
            two_level=bool(self._reducer is not None and self._reducer.two_level))
        self._optimizer.configure_zero(self.zero)
        self._optimizer.init_state(self.params, self._jax_names)
        #: the whole optimizer state and EMA that consolidate_state gathered
        #: for the next state_dict (rank 0 under ZeRO)
        self._consolidated = None
        #: --fused-adam (not under adama, whose accumulators stay per
        #: tensor): gradients accumulate in the flat buffers
        self._fused = (getattr(self._optimizer, "use_fused", False)
                       and self.grad_accum != "adama")
        self._grad_views = self._optimizer.grad_buffers() if self._fused else None
        total_train_steps = args.max_update if args.max_update > 0 else None
        self._lr_scheduler = lr_sched_mod.build_lr_scheduler(
            args, self._optimizer, total_train_steps
        )
        self.scale_state = init_scale_state(
            float(args.fp16_init_scale) if self.use_loss_scale else 1.0)
        self._pinned = 0
        self._nan_updates = 0
        self.overflows = 0
        ema_decay = getattr(args, "ema_decay", -1.0)
        self.ema = EMA(self._ema_source(), ema_decay) if ema_decay > 0 else None
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
        self.update_loss_scales: List[float] = []
        self.update_gnorms: List[float] = []
        #: the epoch iterator's consumed position after each update, and the
        #: host clock at each update's end (the CLI's)
        self.iterations_per_update: List[int] = []
        self.update_done: List[float] = []
        #: the update counter after each update (a rewind steps it back)
        self.update_ids: List[int] = []
        #: the running metric sums since the last flush (the JAX trainer's
        #: device-side ``_macc``, here host floats): a new dict each update
        self._macc: Optional[Dict[str, float]] = None
        # the robustness plane: the fault plan, the durable-write policy and
        # the health sentinel (None unless --sentinel-interval > 0)
        chaos.configure(args)
        durable.configure(args)
        self.sentinel = health.build_sentinel(args)
        #: host buffers of the snapshot ring's slots (allocated once each),
        #: the side stream the captures run on, and the last capture's
        #: event, which the next write of the state waits for
        self._snap_slots: List[Dict[str, torch.Tensor]] = []
        self._snap_stream = None
        self._snap_pending = None
        #: (update, bytes, host enqueue ms, start event, end event) per capture
        self._snap_records: List[tuple] = []
        #: host-to-device copy seconds (the training thread's and the
        #: prefetcher's) and the prefetcher's preparation seconds since the
        #: last flush: the transfer_wall and prefetch_wall stats
        self._wall_lock = threading.Lock()
        self._transfer_wall = 0.0
        self._prefetch_wall = 0.0
        #: fused-norm-path and comm-plan journaled (at the first update)
        self._state_noted = False
        metrics.log_start_time("wall", priority=790, round=2)

    def _ema_source(self) -> Dict[str, torch.Tensor]:
        """The fp32 weights the optimizer updates and the EMA averages: the
        optimizer's master, or the parameters in an fp32 run; under ZeRO
        this rank's share of them (the EMA follows the master's layout)."""
        return self._optimizer.local_weights(self.params)

    def _ema_whole(self, dst: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """The EMA by parameter name, whole (a collective under ZeRO; with
        ``dst``, on rank ``dst``'s host alone, None on the others)."""
        return self._optimizer.gather_local(self.ema.shadow, dst)

    def get_loss_scale(self) -> float:
        return float(self.scale_state["scale"])

    # -- data ----------------------------------------------------------------

    def _loader_args(self):
        a = self.args
        return dict(num_workers=getattr(a, "num_workers", 0),
                    data_buffer_size=getattr(a, "data_buffer_size", 0),
                    data_stall_timeout=getattr(a, "data_stall_timeout", 0.0))

    def get_train_iterator(self, epoch):
        """This rank's shard of the epoch's batches (round-robin over the
        data-parallel ranks, the JAX trainer's sharding by process; a shard
        that runs out first is padded with empty batches)."""
        return self.task.get_batch_iterator(
            dataset=self.task.dataset(self.args.train_subset),
            batch_size=self.args.batch_size,
            seed=self.args.seed,
            epoch=epoch,
            num_shards=self.dp_world_size,
            shard_id=self.dp_rank,
            **self._loader_args(),
        )

    def get_valid_iterator(self, subset):
        """This rank's shard of the batches of ``subset`` in corpus order
        (call ``next_epoch_itr(shuffle=False)``)."""
        return self.task.get_batch_iterator(
            dataset=self.task.dataset(subset),
            batch_size=getattr(self.args, "batch_size_valid", None) or self.args.batch_size,
            seed=self.args.seed,
            epoch=1,
            num_shards=self.dp_world_size,
            shard_id=self.dp_rank,
            **self._loader_args(),
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
        new_lr = self._lr_scheduler.step_update(self.get_num_updates())
        metrics.log_scalar("lr", new_lr, weight=0, priority=300, round=9)
        return new_lr

    def get_lr(self):
        return self._lr_scheduler.get_lr()

    def get_num_updates(self):
        return self._num_updates

    def set_num_updates(self, num_updates):
        self._num_updates = num_updates
        self.lr_step_update()
        metrics.log_scalar("num_updates", self._num_updates, weight=0, priority=200)

    def cumulative_training_time(self):
        """Seconds trained, this process's and every run it resumed."""
        return time.time() - self._start_time + self._previous_training_time

    # -- the update ------------------------------------------------------------

    def host_counts(self, sample):
        """(non-pad tokens, rows, padded length) of a host micro-batch;
        zeros for the empty batch of a shard that ran out."""
        if not sample:
            return 0, 0, 0
        src = np.asarray(self.task.token_array(sample))
        pad = self.task.dictionary.pad()
        return int((src != pad).sum()), int(src.shape[0]), int(src.shape[-1])

    def _take_grads(self, fp32: bool = True) -> Dict[str, torch.Tensor]:
        """Each parameter's gradient of the last backward, with ``.grad``
        cleared: in fp32, or with ``fp32=False`` in the parameter's type
        (autograd sums ``.grad`` in it: bf16 under ``--bf16``)."""
        grads = OrderedDict()
        for n, p in self.params.items():
            g, p.grad = p.grad, None
            if g is not None:
                grads[n] = g.float() if fp32 else g
        return grads

    def _fold(self, acc, grads: Dict[str, torch.Tensor]) -> None:
        """Add one backward's gradients into the update's fp32 accumulator:
        the moment accumulators (``--grad-accum adama``), the flat buffers'
        views (``--fused-adam``) or per-name tensors (an fp32 add of a bf16
        gradient widens it exactly)."""
        if self.grad_accum == "adama":
            self._optimizer.accum_fold(acc, grads)
            return
        for n, g in grads.items():
            if n in acc:
                acc[n].add_(g)
            else:
                acc[n] = g.float()

    def _rng(self, micro_i, *fold):
        """The dropout stream of micro-batch ``micro_i`` of this update (and
        ``fold``: a row), with the rank folded in last at world size above 1
        (the JAX ``fold_in(seed, update, micro, shard)``)."""
        if self.dp_world_size > 1:
            fold = fold + (self.dp_rank,)
        return DropoutRng(self.args.seed, self.device, self.get_num_updates(), micro_i, *fold)

    def _forward_backward(self, sample, micro_i, acc, weight=1.0):
        """One micro-batch: forward, the backward of the fp32 loss times
        the loss scale (and ``weight``: 0 for a shard's dummy batch), and
        its gradient folded into ``acc``; under ``--per-sample-clip-norm``
        row by row (:meth:`_per_sample`).  Under ``--grad-accum adama``
        with a process group each micro-batch's gradient is reduced over
        the ranks before its fold (the moments are not linear in it)."""
        if getattr(self.args, "per_sample_clip_norm", 0.0) > 0:
            return self._per_sample(sample, micro_i, acc, weight)
        sample_size, logging_output = self._backward(sample, self._rng(micro_i), weight)
        grads = self._take_grads(fp32=self.grad_accum == "adama")
        if self.grad_accum == "adama" and self._reducer is not None:
            grads = self._reducer.reduce_grads(grads)
        self._fold(acc, grads)
        return sample_size, logging_output

    def _backward(self, sample, rng, weight=1.0):
        loss, sample_size, logging_output = self.loss(self.model, sample, rng=rng)
        loss = loss.float()
        if weight != 1.0:
            loss = loss * weight
            sample_size = sample_size * weight
            logging_output = {k: v * weight for k, v in logging_output.items()}
        if self.use_loss_scale:
            loss = loss * torch.tensor(self.get_loss_scale(), dtype=torch.float32,
                                       device=loss.device)
        loss.backward()
        return sample_size, logging_output

    def _per_sample(self, sample, micro_i, acc, weight=1.0):
        """Per-sample gradient clipping (the JAX
        ``_forward_backward_per_sample``; the reference loops row by row, as
        here): one batch-1 forward and backward per row of the micro-batch,
        each row with its own dropout stream (seed, update, micro-batch,
        row), its gradient clipped to ``--per-sample-clip-norm`` times the
        loss scale, then summed into ``acc``."""
        max_norm = self.args.per_sample_clip_norm * self.get_loss_scale()
        rows = len(self.task.token_array(sample))
        sample_size, logs = 0.0, []
        for r in range(rows):
            row = _rows(sample, r, r + 1)
            ss, log = self._backward(row, self._rng(micro_i, r), weight)
            grads = self._take_grads()
            clip_grad_norm(grads, max_norm)
            self._fold(acc, grads)
            sample_size = sample_size + ss
            logs.append(log)
        return sample_size, {k: sum(log[k] for log in logs) for k in logs[0]}

    def _sr_key(self) -> Optional[Tuple[int, int]]:
        """The copy-back's noise key under ``--bf16-sr``, as two 32-bit
        words: keyed on (``--seed``, update), so a resumed run rounds as an
        uninterrupted one."""
        if not getattr(self.args, "bf16_sr", False) or self._optimizer.master is None:
            return None
        key = fold_key(self.args.seed, self.get_num_updates(), _SR_FOLD)
        return key & 0xFFFFFFFF, key >> 32

    def _sr_generator(self):
        """The per-tensor copy-back's noise generator, from :meth:`_sr_key`."""
        key = self._sr_key()
        if key is None:
            return None
        return torch.Generator(device=self.device).manual_seed(key[0] | key[1] << 32)

    @contextlib.contextmanager
    def transfer_timer(self):
        """Add the block's wall to ``transfer_wall`` (the training thread's
        copies and the device prefetcher's both count) and, on the training
        thread, to the open update's ``h2d`` span (the prefetcher's copies
        are the host work the hot loop no longer pays)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._wall_lock:
                self._transfer_wall += dt
            if threading.current_thread().name != "device-prefetcher":
                telemetry.spans.add("h2d", dt)

    def _note_state_init(self) -> None:
        """Journal what the JAX trainer journals when it initialises its
        state: each norm module's path (``fused-norm-path``) and the
        parallel plan (``comm-plan``); once, at the first update."""
        if self._state_noted:
            return
        self._state_noted = True
        for m in self.model.modules():
            if isinstance(m, (LayerNorm, RMSNorm)):
                journal_choice(type(m).__name__, m.normalized_shape, norm_path(m.weight))
        plan = groups.plan() or plan_mod.ParallelPlan().validate(1)
        telemetry.emit("comm-plan", **plan.to_json(),
                       two_level=bool(self._reducer is not None and self._reducer.two_level))

    def _probe_handle(self):
        """The lag-1 device probe's handle: a CUDA event recorded on the
        compute stream after the update's last kernel (a no-op on the
        CPU)."""
        if self.device.type != "cuda":
            return telemetry.spans.HostProbe()
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def train_step(self, samples):
        """One update from a list of micro-batches (a GroupedIterator
        chunk) or a :class:`~unicore_tpu_torch.data.prefetch.PreparedUpdate`
        (already on the device, counted on the host); returns the update's
        gradient norm (a float).  The update is one step-span bracket and
        its wall the ``train_wall`` stat."""
        t0 = time.perf_counter()
        self._note_state_init()
        chaos.maybe_raise(self.get_num_updates())
        metrics.log_start_time("train_wall", priority=800, round=2)
        try:
            # begin_update collects a pending lag-1 probe (the ONLY sync in
            # the spans path, sampled updates only); the pre-update tick
            # opens a --profile-steps window whose START is this update
            spans = telemetry.spans.recorder()
            spans.begin_update(self.get_num_updates())
            telemetry.profiler.tick(self.get_num_updates())
            hot_t0 = time.perf_counter()
            gnorm = self._train_step(samples, t0, spans)
            finished = self.get_num_updates() - 1
            # dispatch = the update's wall past its h2d: the enqueues and the
            # host syncs the update makes
            spans.add_dispatch_residual(time.perf_counter() - hot_t0)
            spans.end_update(finished)
            # the post-update tick closes the window at END promptly
            telemetry.profiler.tick(finished + 1)
        finally:
            metrics.log_stop_time("train_wall")
        return gnorm

    def _train_step(self, samples, t0, spans):
        self.model.train()
        for p in self.params.values():
            p.grad = None
        if isinstance(samples, PreparedUpdate):
            batches, counts = samples.samples, samples.counts
            self._prefetch_wall += samples.prefetch_wall
        else:
            with self.transfer_timer():
                batches = [_to_device(s, self.device) for s in samples]
            counts = [self.host_counts(s) for s in samples]
        opt = self._optimizer
        if self.grad_accum == "adama":
            acc = opt.accum_init()
        elif self._fused:
            opt.zero_grad_buffers()
            acc = dict(self._grad_views)
        else:
            acc = {}
        sample_size = torch.zeros((), dtype=torch.float32, device=self.device)
        logging_outputs = []
        loss_scale = self.get_loss_scale()
        for i, (sample, (tokens, rows, length)) in enumerate(zip(batches, counts)):
            weight = 1.0
            if not sample:
                # this rank's shard ran out: its first batch at weight 0
                if self._dummy_batch is None:
                    raise RuntimeError(
                        f"rank {self.dp_rank}: an empty batch before any real one; "
                        "the epoch has fewer batches than data-parallel ranks")
                (sample, length), weight = self._dummy_batch, 0.0
            elif self._dummy_batch is None:
                self._dummy_batch = sample, length
            self.tokens += tokens
            self.samples += rows
            self.micro_batch_lengths.append(length)
            ss, log = self._forward_backward(sample, i, acc, weight)
            sample_size = sample_size + ss
            logging_outputs.append(log)
            self.micro_batches += 1

        step = self.get_num_updates()
        lr = self.get_lr()
        if self.sentinel is not None:
            # the post-rewind cooldown (ladder level 2); 1.0 outside it
            lr = lr * self.sentinel.lr_scale(step)
        clip = getattr(self.args, "clip_norm", 0.0) or 0.0
        # --fault-inject loss-spike / grad-explosion: folded into the
        # denominator (no work when healthy); a loss spike scales the logged
        # loss too (before the sum over the ranks), so the sentinel sees what
        # a real divergence shows
        loss_mul, grad_mul = chaos.fault_multipliers(step)
        if loss_mul != 1.0:
            for log in logging_outputs:
                log["loss"] = log["loss"] * loss_mul
        if self._reducer is not None:
            # the ranks' sums: every rank normalises, clips and steps alike
            sample_size, logging_outputs = self._reduce_stats(sample_size, logging_outputs)
            if self.grad_accum != "adama":
                self._reduce_grads(acc)
        denom = torch.clamp(sample_size, min=1e-8)
        if self.use_loss_scale:
            denom = denom * loss_scale
        if loss_mul * grad_mul != 1.0:
            denom = denom / (loss_mul * grad_mul)
        self._await_snapshot()  # the optimizer writes what a capture reads
        if self.grad_accum == "adama":
            gnorm_t = opt.accum_gnorm(acc) / denom
            gnorm = float(gnorm_t)
        elif self._fused:
            # K-a, then K-b reading the norm on the device; K-b skips the
            # update itself on a non-finite norm
            gnorm_t = opt.fused_grad_norm(denom)
            with torch.profiler.record_function("optimizer"):
                opt.fused_step(lr, denom, gnorm_t, clip, self._sr_key())
            gnorm = float(gnorm_t)
        else:
            grads = OrderedDict(
                (n, acc[n] if n in acc else torch.zeros_like(p, dtype=torch.float32))
                for n, p in self.params.items()
            )
            torch._foreach_div_(list(grads.values()), denom)
            gnorm = float(clip_grad_norm(grads, clip))
        overflow = not np.isfinite(gnorm)
        if self.use_loss_scale:
            self._step_loss_scale(overflow, gnorm)
        if not overflow:
            # the JAX trainer's named_scope("optimizer"): a profiler range
            with torch.profiler.record_function("optimizer"):
                if self.grad_accum == "adama":
                    coef = (clip_coef(gnorm_t, clip) if clip > 0
                            else torch.ones_like(gnorm_t))
                    opt.update_from_accum(acc, self.params, lr, denom, coef,
                                          self._sr_generator())
                elif not self._fused:
                    opt.step(self.params, grads, lr, self._sr_generator())
                if self.ema is not None:
                    self.ema.update(self._ema_source())
        else:
            if self._fused:
                opt.unstep()
            self.overflows += 1
            if not self.use_loss_scale:
                logger.warning(f"non-finite gradient norm {gnorm}: update skipped")
        if spans.enabled and spans.sampled(step):
            # sampled updates only: an unsampled update records nothing to
            # wait on, so it can never sync
            spans.note_dispatched(step, self._probe_handle())
        self.set_num_updates(self.get_num_updates() + 1)
        chaos.note_step(self.get_num_updates())
        self.update_ids.append(self.get_num_updates())

        loss_sum = sum(float(log["loss"]) for log in logging_outputs)
        self._accumulate_metrics(logging_outputs, loss_sum, float(sample_size), gnorm,
                                 loss_scale, overflow)
        self.update_losses.append(loss_sum / max(float(sample_size), 1e-8) / np.log(2))
        self.update_lrs.append(lr)
        self.update_loss_scales.append(loss_scale)
        self.update_gnorms.append(gnorm)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        if getattr(self.args, "nan_rerun", False) and (
                np.isnan(gnorm) if self.use_loss_scale else overflow):
            # under --fp16 an inf norm is a routine scale overflow; a NaN
            # survives every rescale (the JAX trainer keys on it too)
            detail = self._localize_nan(batches)
            raise FloatingPointError("non-finite gradients detected"
                                     + (f": {detail}" if detail else ""))
        return gnorm

    def _reduce_stats(self, sample_size, logging_outputs):
        """The update's sample size and logging outputs summed over the
        micro-batches and the ranks: one float64 all-reduce on the device,
        with no host sync (the values stay device scalars); the sample size
        comes back in fp32, the outputs as one dict."""
        from unicore_tpu_torch.distributed import utils as distributed_utils

        def f64(v):
            return torch.as_tensor(v, dtype=torch.float64, device=self.device)

        keys = sorted({k for log in logging_outputs for k in log})
        vec = torch.stack([sum(f64(log.get(k, 0.0)) for log in logging_outputs)
                           for k in keys] + [f64(sample_size)])
        distributed_utils.all_reduce_tensor(vec)
        return vec[-1].float(), [dict(zip(keys, vec[:-1].unbind()))]

    def _reduce_grads(self, acc) -> None:
        """Sum the update's gradients over the ranks in place: the flat
        gradient buffers of ``--fused-adam``, else every parameter's
        accumulator (zeros for one without a gradient, so every rank sends
        the same layout) through one flat buffer."""
        if self._fused and self.zero is not None and self.zero.scatter:
            self._reducer.reduce_scatter_(*self._optimizer.scatter_buffers())
            return
        if self._fused:
            self._reducer.reduce_([b["g"] for b in self._optimizer.flat])
            return
        full = OrderedDict(
            (n, acc[n] if n in acc else torch.zeros_like(p, dtype=torch.float32))
            for n, p in self.params.items())
        acc.clear()
        acc.update(self._reducer.reduce_grads(full))

    def reduction_stats(self) -> Optional[dict]:
        """The gradient reduction's record (None without a process group):
        flat or two-level, each update's milliseconds, each flat buffer's
        bytes and the bytes of it that crossed the pod tier."""
        r = self._reducer
        if r is None:
            return None
        return {"two_level": r.two_level, "plan": r.plan.describe(),
                "backend": groups.backend(), "ms_per_update": r.timings_ms(),
                "buffer_bytes": r.buffer_bytes, "dcn_bytes": r.dcn_bytes,
                "reduce_scatter": bool(self.zero is not None and self.zero.scatter)}

    def memory_stats(self) -> dict:
        """This rank's memory: the ZeRO stage, the optimizer state it holds
        (its share of the moments and the fp32 master) and the EMA's, and on
        a card ``torch.cuda.max_memory_allocated``."""
        ema = sum(t.numel() * t.element_size() for t in self.ema.shadow.values()) \
            if self.ema is not None else 0
        return {"zero_stage": self.zero_stage, "zero_sharded": self.zero is not None,
                "optimizer_state_bytes": self._optimizer.state_bytes(), "ema_bytes": ema,
                "peak_allocated_bytes": (torch.cuda.max_memory_allocated(self.device)
                                         if self.device.type == "cuda" else None)}

    def _localize_nan(self, batches):
        """Re-run the update's first micro-batch: a forward in eval mode
        under the NaN detector names the first module whose output is
        non-finite; a backward with the failed update's dropout names the
        first parameter, in the JAX package's (sorted Flax-name) order,
        whose gradient is.  Diagnostics never mask the original error."""
        sample = batches[0]
        det = NanDetector(self.model)
        msgs = []
        try:
            hit = det.check_forward(lambda: self.loss(self.model, sample))
            if hit:
                msgs.append(hit)
        except Exception as e:  # noqa: BLE001 -- a diagnostic, not the error
            logger.warning(f"NaN forward localization failed: {e}")
        try:
            self.model.train()
            rng = DropoutRng(self.args.seed, self.device,
                             max(self.get_num_updates() - 1, 0), 0)
            self._backward(sample, rng)
            grads = self._take_grads()
            order = sorted(grads, key=self._jax_names.__getitem__)
            grads = OrderedDict((n, grads[n]) for n in order)
            hit = det.check_grads(grads)
            if hit:
                msgs.append(hit)
                det.dump_grad_norms(grads)
        except Exception as e:  # noqa: BLE001
            logger.warning(f"NaN gradient localization failed: {e}")
        finally:
            for p in self.params.values():
                p.grad = None
        return "; ".join(msgs) if msgs else None

    # -- prefetch ------------------------------------------------------------

    def maybe_prefetch(self, itr, epoch_itr=None):
        """Wrap a grouped update iterator in the device prefetcher under
        ``--prefetch-to-device`` (else return it as it is): a producer
        thread collates, counts and copies update N+1 to the device while
        update N runs."""
        if not getattr(self.args, "prefetch_to_device", False):
            return itr
        pf = DevicePrefetcher(self, itr,
                              depth=max(1, getattr(self.args, "prefetch_depth", 2) or 2))
        if epoch_itr is not None:
            pf.attach_epoch_itr(epoch_itr)
        return pf.start()

    def finish_prefetch(self, itr):
        """Stop a prefetcher :meth:`maybe_prefetch` returned (no-op for a
        plain iterator)."""
        if isinstance(itr, DevicePrefetcher):
            itr.close()

    def _step_loss_scale(self, overflow: bool, gnorm: float) -> None:
        """The fp16 schedule's step (the JAX ``_sched_overflow``); a NaN norm
        is counted apart, since no rescaling cures it."""
        window = getattr(self.args, "fp16_scale_window", None) or 2 ** 14
        self.scale_state, pinned = scale_schedule(
            self.scale_state, overflow, scale_window=window,
            min_loss_scale=self.args.min_loss_scale,
            tolerance=getattr(self.args, "fp16_scale_tolerance", 0.0) or 0.0,
            threshold_loss_scale=getattr(self.args, "threshold_loss_scale", None),
        )
        self._pinned += int(pinned)
        self._nan_updates += int(np.isnan(gnorm))

    def flush_metrics(self) -> None:
        """The JAX trainer's flush (the CLI's ``--log-interval``, before a
        validation, at an epoch's end): the running sums since the last
        flush become the interval's stats in the aggregators active now --
        ``ups``, ``gnorm``, ``clip`` (with ``--clip-norm``), ``loss_scale``
        (under ``--fp16``), ``gb_free`` (on a card), ``transfer_wall``,
        ``prefetch_wall`` (with ``--prefetch-to-device``), ``host_blocked``
        and ``device_busy`` (once telemetry is configured) and the loss's
        stats -- and the Prometheus registry is refreshed.  Under
        ``--fp16`` a NaN gradient norm is reported apart from the scale's
        routine overflows, and a scale pinned at ``--min-loss-scale`` since
        the last flush raises ``FloatingPointError``."""
        macc, self._macc = self._macc, None
        nan, self._nan_updates = self._nan_updates, 0
        if nan and self.use_loss_scale:
            logger.warning(
                f"{nan} update(s) in the last interval had NaN gradients: NOT a "
                "loss-scale overflow (NaN survives rescaling)")
        if self._pinned:
            self._pinned = 0
            raise FloatingPointError(
                f"Minimum loss scale reached ({self.args.min_loss_scale}). "
                "Your loss is probably exploding. Try lowering the learning "
                "rate, using gradient clipping or increasing the batch size.")
        if macc is None:
            return
        delta = {k: float(v) for k, v in macc.items()}
        n = delta.pop("_n", 0.0)
        if n <= 0:
            return
        gnorm_sum = delta.pop("gnorm", None)
        loss_scale_sum = delta.pop("loss_scale", None)
        clip_cnt = delta.pop("clip", 0.0)
        delta.pop("overflow", None)
        metrics.log_speed("ups", n, priority=100, round=2)
        if gnorm_sum is not None:
            metrics.log_scalar("gnorm", gnorm_sum / n, n, priority=400, round=3)
            if (getattr(self.args, "clip_norm", 0.0) or 0.0) > 0:
                metrics.log_scalar("clip", 100.0 * clip_cnt / n, n, priority=500, round=1)
        if self.use_loss_scale and loss_scale_sum is not None:
            metrics.log_scalar("loss_scale", loss_scale_sum / n, n, priority=700, round=4)
        with self._wall_lock:
            transfer_wall, self._transfer_wall = self._transfer_wall, 0.0
        prefetch_wall, self._prefetch_wall = self._prefetch_wall, 0.0
        metrics.log_scalar("transfer_wall", transfer_wall, weight=0, priority=1610, round=3)
        if getattr(self.args, "prefetch_to_device", False):
            metrics.log_scalar("prefetch_wall", prefetch_wall, weight=0, priority=1620,
                               round=3)
        # the interval's step-span totals: how long the training thread was
        # blocked on host work, and the sampled device-busy seconds
        rec = telemetry.spans.recorder()
        span_totals = rec.drain()
        if rec.enabled:
            metrics.log_scalar("host_blocked", span_totals.get("host_blocked", 0.0),
                               weight=0, priority=1630, round=3)
            if span_totals.get("device_samples", 0.0) > 0:
                metrics.log_scalar("device_busy", span_totals.get("device_busy", 0.0),
                                   weight=0, priority=1640, round=3)
            telemetry.prometheus.export_trainer(self.get_num_updates(), n, span_totals,
                                                rec.avg_step_wall())
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            metrics.log_scalar("gb_free", free / 1024 ** 3, weight=0, priority=1500, round=1)
        self.task.reduce_metrics([delta], self.loss)

    def _accumulate_metrics(self, logging_outputs, loss: float, sample_size: float,
                            gnorm: float, loss_scale: float, overflow: bool) -> None:
        """Fold one update into the running sums (the JAX ``accumulate`` of
        ``_macc``): the update count, the loss's logging outputs summed over
        the micro-batches (device scalars stay on the device until a flush),
        and as host floats the ones the sentinel reads -- the loss in the
        loss's own units, the sample size, the norm, the loss scale, the
        overflow count -- and the clip count; a new dict each time, so a
        held one keeps its values."""
        upd = {"_n": 1.0}
        for log in logging_outputs:
            for k, v in log.items():
                upd[k] = upd.get(k, 0.0) + v
        clip = getattr(self.args, "clip_norm", 0.0) or 0.0
        upd.update(loss=loss, sample_size=sample_size, gnorm=gnorm, loss_scale=loss_scale,
                   overflow=float(overflow), clip=float(clip > 0 and gnorm > clip))
        old = self._macc
        self._macc = upd if old is None else {k: old.get(k, 0.0) + v for k, v in upd.items()}

    def flush_metric_sums(self) -> None:
        """Restart the running sums, where the JAX CLI flushes its ``_macc``:
        at ``--log-interval``, before a validation and at the end of an
        epoch."""
        self._macc = None

    # -- the health sentinel ----------------------------------------------------

    def health_check(self, epoch_itr=None, update_itr=None):
        """The sentinel's tick, called by the CLI right after ``train_step``
        (before the log-interval flush, so the sums hold this update):
        judge the held sums, rewind ``self`` and skip ``update_itr`` ahead
        on a confirmed anomaly, and capture snapshots on the
        ``--snapshot-interval`` cadence."""
        if self.sentinel is None:
            return
        self.sentinel.after_update(self, epoch_itr, update_itr)

    def _live_state(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the training state a rewind restores, by a
        stable name: under ``--fused-adam`` the flat buffers (the whole
        parameter buffer, the moments and a low-precision master; the
        parameters and slots are views into them), else each parameter,
        slot and master tensor; and the EMA's shadow.  Under ZeRO the
        state is this rank's share: each rank captures and restores its
        own."""
        live: Dict[str, torch.Tensor] = OrderedDict()
        opt = self._optimizer
        if self._fused:
            live.update(opt.live_buffers())
        else:
            for n, p in self.params.items():
                live[f"param.{n}"] = p.data
            for n, slots in opt.state.items():
                for k, v in slots.items():
                    live[f"slot.{n}.{k}"] = v
            for n, m in (opt.master or {}).items():
                live[f"master.{n}"] = m
        if self.ema is not None:
            for n, e in self.ema.shadow.items():
                live[f"ema.{n}"] = e
        return live

    def _await_snapshot(self) -> None:
        """Make the current stream wait for the last capture's copies
        before anything writes the state they read (no host wait)."""
        if self._snap_pending is not None:
            torch.cuda.current_stream(self.device).wait_event(self._snap_pending)
            self._snap_pending = None

    def capture_health_snapshot(self, epoch_itr=None):
        """A host-RAM rewind point: the training state copied into a ring
        slot's pinned buffers (a slot no snapshot of the ring holds, else
        the oldest's, which the ring evicts next), enqueued on a side stream
        so it overlaps the next update; the lr scheduler, the optimizer's
        step count, the loss-scale state and the iterator position
        (recorded: recovery skips forward) beside it."""
        ring = self.sentinel.ring
        held = {id(snap.state) for snap in ring}
        slot = next((sl for sl in self._snap_slots if id(sl) not in held), None)
        if slot is None and len(self._snap_slots) >= ring.keep:
            slot = next(iter(ring)).state
        start = None
        if self.device.type == "cuda":
            if self._snap_stream is None:
                self._snap_stream = torch.cuda.Stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        host, done = health.host_copy_tree(self._live_state(), slot, self._snap_stream, start)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        if all(host is not sl for sl in self._snap_slots):
            self._snap_slots.append(host)
        self._snap_pending = done
        snap = health.HealthSnapshot(
            step=self.get_num_updates(), state=host,
            lr_sched_state=copy.deepcopy(self._lr_scheduler.state_dict()),
            iterator_state=epoch_itr.state_dict() if epoch_itr is not None else None,
            extra={"num_steps": self._optimizer.num_steps,
                   "scale_state": dict(self.scale_state), "event": done})
        self._snap_records.append((snap.step, snap.nbytes, enqueue_ms, start, done))
        return snap

    def restore_health_snapshot(self, snap):
        """Put the run back at ``snap.step`` in memory: the state copied
        back IN PLACE (the ``--fused-adam`` views keep aliasing their flat
        buffers), the optimizer's step count, the loss-scale state, the lr
        scheduler and the update counter (the dropout and SR streams are
        keyed on it, so they replay).  The running sums are dropped: they
        describe the abandoned trajectory."""
        self._await_snapshot()
        event = snap.extra.get("event")
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        health.device_restore_tree(snap.state, self._live_state())
        self._optimizer.num_steps = snap.extra["num_steps"]
        self.scale_state = dict(snap.extra["scale_state"])
        self._macc = None
        if snap.lr_sched_state is not None:
            self._lr_scheduler.load_state_dict(copy.deepcopy(snap.lr_sched_state))
        self.set_num_updates(snap.step)

    def snapshot_timings(self) -> List[dict]:
        """Each capture's update, bytes, host ms (the first capture of a
        slot allocates its pinned buffers) and, on the card, the copies'
        device ms on the side stream (waits for them)."""
        out = []
        for step, nbytes, enqueue_ms, start, done in self._snap_records:
            copy_ms = None
            if start is not None:
                done.synchronize()
                copy_ms = start.elapsed_time(done)
            out.append({"update": step, "bytes": nbytes, "enqueue_ms": enqueue_ms,
                        "copy_ms": copy_ms})
        return out

    # -- validation ----------------------------------------------------------

    @torch.no_grad()
    def valid_step(self, sample):
        """The loss's logging output of one batch in eval mode (no dropout),
        None for an empty batch."""
        if not sample:
            return None
        self.model.eval()
        with self.transfer_timer():
            sample = _to_device(sample, self.device)
        _, _, logging_output = self.loss(self.model, sample)
        return logging_output

    @contextlib.contextmanager
    def eval_weights(self):
        """With ``--validate-with-ema`` the EMA's weights stand in the model's
        parameters for the block (cast to their type: rounded to bf16 under
        ``--bf16``), and the trained weights come back bit for bit after
        it."""
        if self.ema is None or not getattr(self.args, "validate_with_ema", False):
            yield
            return
        self._await_snapshot()
        params = list(self.params.values())
        saved = [p.detach().clone() for p in params]
        ema = self._ema_whole()
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)

    # -- checkpoint ----------------------------------------------------------

    def consolidate_state(self) -> None:
        """Under ZeRO, gather the optimizer state and the EMA whole to rank
        0's host for the next :meth:`state_dict`, one flat group (or one
        dtype's slices) at a time: a collective, which every rank runs
        before rank 0 writes a checkpoint (``checkpoint_utils.
        save_checkpoint``).  No other rank holds the state whole.  A no-op
        without ZeRO."""
        if self.zero is None:
            return
        save_opt = not getattr(self.args, "no_save_optimizer_state", False)
        opt_state = self._optimizer.state_dict(dst=0) if save_opt else None
        ema = self._ema_whole(dst=0) if self.ema is not None else None
        self._consolidated = (opt_state, ema) if self.dp_rank == 0 else None

    def release_consolidated(self) -> None:
        """Drop what :meth:`consolidate_state` gathered and no save used."""
        self._consolidated = None

    def _whole_state(self):
        """(optimizer state, EMA) whole for a checkpoint: gathered by
        :meth:`consolidate_state` under ZeRO (neither when it did not run:
        the on-error emergency save, which a rank may make alone), else the
        rank's own."""
        save_opt = not getattr(self.args, "no_save_optimizer_state", False)
        if self.zero is None:
            return (self._optimizer.state_dict() if save_opt else None,
                    self.ema.state_dict() if self.ema is not None else None)
        got, self._consolidated = self._consolidated, None
        if got is None:
            logger.warning("ZeRO: the optimizer state and the EMA were not gathered for "
                           "this checkpoint (no consolidate_state on every rank); it "
                           "holds the weights without them")
            return None, None
        return got

    def state_dict(self):
        """The checkpoint, in the JAX package's layout: ``args``, ``model``,
        ``optimizer_state``, ``optimizer_history`` (the lr scheduler and the
        update count), ``extra_state`` (meters, training time) and, with
        ``--ema-decay``, ``ema``; the optimizer state and the EMA whole at
        every ZeRO stage.  ``unicore-tpu-torch-serve`` reads ``args`` and
        ``model``."""
        opt_state, ema = self._whole_state()
        state = {
            "args": self.args,
            "model": self.model.state_dict(),
            "optimizer_state": opt_state,
            "optimizer_history": [{
                "optimizer_name": type(self._optimizer).__name__,
                "lr_scheduler_state": self._lr_scheduler.state_dict(),
                "num_updates": self.get_num_updates(),
            }],
            "extra_state": {
                "metrics": metrics.state_dict(),
                "previous_training_time": self.cumulative_training_time(),
                "loss_scale": self.get_loss_scale(),
                "loss_scale_state": {k: (float(v) if k == "scale" else v)
                                     for k, v in self.scale_state.items()},
                # the sentinel's recovery history: which detectors fired,
                # when, and what the ladder did
                "sentinel": (self.sentinel.state_dict() if self.sentinel is not None
                             else None),
            },
        }
        if ema is not None:
            state["ema"] = ema
        return state

    def save_checkpoint(self, filename, extra_state):
        """Write :meth:`state_dict` with ``extra_state`` (the iterator
        position, the validation loss, the best score) merged in; returns
        :func:`~unicore_tpu_torch.checkpoint_utils.persistent_save`'s result
        (False: the write did not land, under ``--on-save-failure warn``)."""
        state = self.state_dict()
        state["extra_state"].update(extra_state)
        saved = checkpoint_utils.write_checkpoint(filename, state.pop("args"),
                                                  state.pop("model"), **state)
        if saved:
            logger.info(f"saved checkpoint {filename} (update {self.get_num_updates()})")
        return saved

    def _log_reshard(self, saved_args) -> None:
        """Name the reshard when the checkpoint was saved at another world
        size or ZeRO stage (its state is whole: each rank keeps its share)."""
        if saved_args is None:
            return
        saved_stage = zero_mod.resolve_zero_stage(saved_args)
        saved_world = int(getattr(saved_args, "distributed_world_size", 1) or 1)
        if (saved_world, saved_stage) != (self.dp_world_size, self.zero_stage):
            logger.info(f"checkpoint saved by {saved_world} rank(s) at --zero-stage "
                        f"{saved_stage}, loaded by {self.dp_world_size} at --zero-stage "
                        f"{self.zero_stage}: the optimizer state and EMA resharded (rank "
                        f"{self.dp_rank} keeps its share)")

    def load_checkpoint(self, filename, reset_optimizer=False, reset_lr_scheduler=False,
                        reset_dataloader=False, optimizer_overrides=None,
                        reset_meters=False):
        """Restore from ``filename`` what the resets leave: the weights
        always (the EMA's with ``--load-from-ema``), cast to the parameters'
        type, with the fp32 master refreshed from them; the EMA when the run
        keeps one; the optimizer state (its master among it), the update
        count and the fp16 loss scale unless ``reset_optimizer``; the lr
        scheduler unless ``reset_lr_scheduler``; the meters unless
        ``reset_meters``.  (The JAX trainer leaves the master as it was
        under ``reset_optimizer``; here it is refreshed then too, so a
        fine-tune starts from the loaded weights.)  Returns the checkpoint's
        ``extra_state`` (None when there is no file); ``reset_dataloader``
        is the caller's to apply to its ``train_iterator``.  A checkpoint
        that lacks a group resumes without it, with a warning naming it."""
        if not os.path.exists(filename):
            logger.info(f"No existing checkpoint found {filename}")
            return None
        logger.info(f"Preparing to load checkpoint {filename}")
        state = checkpoint_utils.upgrade_state(checkpoint_utils.load_checkpoint_to_cpu(filename))
        self._await_snapshot()
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
        self._optimizer.refresh_master(self.params)
        self._log_reshard(state.get("args"))
        if not reset_optimizer and state.get("optimizer_state") is not None:
            if not self._optimizer.load_state_dict(state["optimizer_state"],
                                                   optimizer_overrides):
                logger.warning(
                    "optimizer state in checkpoint does not match the current "
                    "parameters; resetting optimizer state (Adam moments restart "
                    "from zero)")
        if self.ema is not None:
            if state.get("ema") is not None:
                self.ema.load_state_dict(self._optimizer.local_copy(
                    {n: state["ema"][n] for n in self.params}))
            else:  # start the average at the loaded weights
                self.ema = EMA(self._ema_source(), self.ema.decay)
        if (not reset_optimizer and self.use_loss_scale and extra_state is not None
                and extra_state.get("loss_scale") is not None):
            saved = extra_state.get("loss_scale_state") or {}
            self.scale_state = init_scale_state(extra_state["loss_scale"])
            self.scale_state.update({k: int(v) for k, v in saved.items() if k != "scale"})
        if state.get("optimizer_history"):
            last = state["optimizer_history"][-1]
            if not reset_lr_scheduler:
                self._lr_scheduler.load_state_dict(last["lr_scheduler_state"])
            if not reset_optimizer:
                self.set_num_updates(last["num_updates"])
                self.resumed_from_update = last["num_updates"]
        if extra_state is not None:
            if self.sentinel is not None:
                self.sentinel.load_state_dict(extra_state.get("sentinel"))
            if not reset_meters and "metrics" in extra_state:
                metrics.load_state_dict(extra_state["metrics"])
            self._previous_training_time = extra_state.get("previous_training_time", 0.0)
            self._start_time = time.time()
        logger.info(f"Loaded checkpoint {filename} (@ {self.get_num_updates()} updates)")
        telemetry.emit("checkpoint-load", path=filename, loaded_updates=self.get_num_updates())
        return extra_state
