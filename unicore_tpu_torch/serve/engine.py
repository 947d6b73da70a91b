"""Continuous micro-batching inference engine (counterpart of
``unicore_tpu/serve/engine.py``).

One loop, four stages: **admit** (the bounded :class:`AdmissionQueue`
sheds overload at the door) → **batch** (bucket-affine formation, expired
requests dropped un-computed) → **dispatch** (one eager forward at one of a
fixed set of shape buckets) → **respond** (deadline checked one last time).

* **Warm-up**: every bucket runs before the first real request
  (``warmup()``; the kernels build and load there); readiness flips true
  only after.  The JAX engine also watches for jit recompiles after
  warm-up; eager PyTorch compiles nothing per shape, so that watchdog has
  no counterpart here.
* **Bounded waits**: every blocking wait is sliced and deadline-bounded.
* **Swap on a batch boundary**: hot reload (``serve/reload.py``) hands a
  verified and probed candidate MODEL to :meth:`request_swap`; the loop
  applies it between batches, so no batch ever computes against half-swapped
  weights.  The candidate is a second model instance on the device, holding
  the checkpoint's tensors in their own types (a swap may change the served
  dtype, as the JAX engine serves whatever tree it is handed); the old
  instance is dropped at the swap and its device memory returns.
* **Drain, don't drop**: SIGTERM stops admission and flushes in-flight
  work under a deadline (:meth:`drain`).

The decode plane (``serve/decode.py``) subclasses this engine: it injects
its own admission queue and passes no ``infer_fn``.

Quantized serving (``--serve-quantize``): ``precision`` names the mode,
``quant_info`` (the calibration summary) and the sampled per-request drift
(``drift_probe`` every ``drift_sample_every``-th batch: the max |logit
drift| of each real request row against the fp32 model) show in /stats
under ``quant``, with the JAX field names.  The probe's own kernel launches
are counted apart (``probe_kernel_launches``), so the serving path's
launches per batch stay readable; so are the reload thread's
(``reload_kernel_launches``: the candidate's probe and calibration).  The
drift samples, swaps and drains are journalled (``quant-path``,
``serve-reload``, ``serve-drain``) through ``unicore_tpu_torch.telemetry``,
as the JAX engine journals them.
"""

import contextlib
import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.serve import request as rq
from unicore_tpu_torch.serve.admission import AdmissionQueue
from unicore_tpu_torch.utils import retry

logger = logging.getLogger(__name__)

#: engine phases surfaced by the readiness probe
PHASE_WARMING = "warming-up"
PHASE_SERVING = "serving"
PHASE_RELOADING = "reloading"
PHASE_DRAINING = "draining"
PHASE_STOPPED = "stopped"

#: served latencies kept for the /stats percentiles
_LATENCY_WINDOW = 2048


def build_infer_fn(device) -> Callable:
    """The serving step for a ``src_tokens``-shaped model (the bert family):
    ``(model, tokens[B, L] int32 numpy) -> (ids[B, L] int32, score[B]
    float32)`` as numpy arrays.

    ``score`` is the max logit per position averaged over ALL padded
    positions of the row, as the JAX engine computes it.  The forward runs
    under ``torch.inference_mode()`` entered inside the call, so it holds
    in whichever thread calls (grad mode is per thread)."""
    device = torch.device(device)

    def _infer(model, src_tokens):
        with torch.inference_mode():
            tokens = torch.as_tensor(np.asarray(src_tokens), dtype=torch.long)
            logits = model(tokens.to(device))
            ids = logits.argmax(dim=-1).to(torch.int32)
            score = logits.float().amax(dim=-1).mean(dim=-1)
            return ids.cpu().numpy(), score.cpu().numpy()

    return _infer


class ServeEngine:
    """Owns the serving model and the admit→batch→dispatch→respond loop."""

    def __init__(
        self,
        model,
        infer_fn: Optional[Callable],
        *,
        bucket_edges: Sequence[int],
        batch_size: int,
        pad_idx: int = 0,
        vocab_size: Optional[int] = None,
        queue: Optional[AdmissionQueue] = None,
        admission_capacity: int = 256,
        precision: str = "",
        device: str = "",
        quant_info: Optional[dict] = None,
        drift_probe: Optional[Callable] = None,
        drift_sample_every: int = 64,
        swap_hook: Optional[Callable] = None,
    ):
        if not bucket_edges:
            raise ValueError("bucket_edges must name at least one length")
        self.model = model
        self.infer_fn = infer_fn
        self.bucket_edges = tuple(sorted(int(e) for e in bucket_edges))
        self.batch_size = max(1, int(batch_size))
        self.pad_idx = int(pad_idx)
        #: token ids must lie in [0, vocab_size): an embedding lookup out of
        #: range faults on the card, so submit() rejects it up front
        self.vocab_size = vocab_size
        #: the card's name (or "cpu"), surfaced in /stats
        self.device = str(device)
        #: precision label keying the admission queue's per-(bucket,
        #: precision) service EMAs ('' = the checkpoint's precision)
        self.precision = str(precision)
        self.queue = queue or AdmissionQueue(
            admission_capacity,
            batch_capacity=self.batch_size,
            max_len=self.bucket_edges[-1],
            bucket_edges=self.bucket_edges,
            precision=self.precision,
        )
        #: calibration summary from quant.calibrate (mode, scale source,
        #: site count, calibration drift) -- surfaced in /stats
        self.quant_info = quant_info
        #: optional sampled per-request logit-drift probe: ``tokens[B, L] ->
        #: per-row max |logit drift|``, every ``drift_sample_every``-th batch
        self._drift_probe = drift_probe
        self._drift_every = max(0, int(drift_sample_every))
        self._drift = {"samples": 0, "max_abs": 0.0, "mean_abs": 0.0,
                       "last_abs": 0.0}
        self._drift_probe_dead = False
        #: kernel launches made by the drift probe (not the serving path)
        self._probe_launches = {}
        #: called with (model, tag) right after a hot swap applies: the
        #: quantized CLI re-pairs its drift probe here
        self._swap_hook = swap_hook
        #: kernel launches of the reload thread (candidates' probes and
        #: calibration), counted apart from the serving path's
        self.reload_launches = {}
        #: calls another thread hands to the loop (:meth:`_call_on_loop`)
        self._loop_calls: List[dict] = []
        self._phase = PHASE_WARMING
        self._ready = False
        self._stop = threading.Event()
        self._batch_seq = 0
        self.served = 0
        self.expired_at_response = 0
        self._latencies_ms: List[float] = []
        self._lock = threading.Lock()
        # hot-reload handoff: (model, tag) applied on a batch boundary
        self._pending_swap = None
        self._swap_tag = None
        self.reloads_applied = 0
        self._thread: Optional[threading.Thread] = None
        #: the exception that killed the loop thread, if any — the CLI
        #: polls this and exits rather than linger with liveness green
        self.fatal_error: Optional[BaseException] = None

    # -- probes ----------------------------------------------------------

    @property
    def phase(self) -> str:
        return self._phase

    def ready(self) -> bool:
        return self._ready

    def set_ready(self, ready: bool, phase: Optional[str] = None) -> bool:
        """Readiness/phase transition; False when refused because the
        engine is already terminal (draining/stopped never resurrect)."""
        with self._lock:
            if self._phase in (PHASE_DRAINING, PHASE_STOPPED):
                return False
            self._ready = bool(ready)
            if phase is not None:
                self._phase = phase
            return True

    # -- warm-up ---------------------------------------------------------

    def warmup(self) -> int:
        """Run every bucket once before the first real request (building
        and loading the kernels on the first), then once more to seed the
        admission queue's service estimate; flips readiness true.
        Returns the number of buckets warmed."""
        if not self.set_ready(False, PHASE_WARMING):
            return 0
        t0 = time.monotonic()
        for edge in self.bucket_edges:
            dummy = np.full(
                (self.batch_size, edge), self.pad_idx, dtype=np.int32
            )
            self.infer_fn(self.model, dummy)
            # time a SECOND, warm dispatch: the first pays one-time costs
            # that would make the first real requests look unmeetable
            tb0 = time.monotonic()
            self.infer_fn(self.model, dummy)
            self.queue.note_batch_service(time.monotonic() - tb0,
                                          bucket=edge)
        logger.info(
            f"serve warm-up complete: {len(self.bucket_edges)} bucket(s) "
            f"{list(self.bucket_edges)} x batch {self.batch_size} in "
            f"{time.monotonic() - t0:.1f}s; readiness -> true"
        )
        if self.set_ready(True, PHASE_SERVING):
            self.queue.set_accepting(True)
        return len(self.bucket_edges)

    # -- submission ------------------------------------------------------

    def submit(self, tokens, deadline_s: float,
               request_id: Optional[str] = None) -> rq.ServeRequest:
        """Admit one request (or resolve it immediately with a named
        reason).  Raises ValueError for token ids outside the vocabulary."""
        req = self.make_request(tokens, deadline_s, request_id)
        self.queue.admit(req)
        return req

    def make_request(self, tokens, deadline_s: float,
                     request_id: Optional[str] = None) -> rq.ServeRequest:
        """A request for ``tokens``; ValueError for ids outside the
        vocabulary (an embedding lookup out of range faults on the card)."""
        req = rq.ServeRequest.make(tokens, deadline_s, request_id)
        if self.vocab_size is not None and len(req) and (
            int(req.tokens.min()) < 0
            or int(req.tokens.max()) >= self.vocab_size
        ):
            raise ValueError(
                f"token ids must lie in [0, {self.vocab_size}), got "
                f"[{int(req.tokens.min())}, {int(req.tokens.max())}]"
            )
        return req

    # -- hot reload ------------------------------------------------------

    def probe(self, model) -> None:
        """The candidate ``model``'s canary (:meth:`_probe_forward`); raises
        on an ill-shaped output or a non-finite score.

        Called from another thread while the loop runs (a hot reload), it
        runs on the loop thread between two batches, its launches counted
        where the caller's go: the forward then takes the serving thread's
        cuBLAS handle, where the reload thread's own would keep a second
        workspace allocated on the card for the life of the process."""
        if self._thread is None or threading.current_thread() is self._thread:
            self._probe_forward(model)
        else:
            self._call_on_loop(lambda: self._probe_forward(model))

    def _probe_forward(self, model) -> None:
        """One dummy batch at the first bucket through ``model``
        (:func:`probe_batch`)."""
        edge = self.bucket_edges[0]
        dummy = probe_batch(self.batch_size, edge, self.pad_idx)
        ids, score = self.infer_fn(model, dummy)
        ids, score = np.asarray(ids), np.asarray(score)
        if ids.shape != (self.batch_size, edge):
            raise ValueError(
                f"probe batch produced shape {ids.shape}, "
                f"expected {(self.batch_size, edge)}"
            )
        if not np.all(np.isfinite(score)):
            raise ValueError(
                "probe batch produced non-finite scores (poisoned weights?)"
            )

    def request_swap(self, model, tag: str) -> None:
        """Hand a verified and probed candidate model to the loop; it is
        applied on the next batch boundary (never mid-batch)."""
        with self._lock:
            self._pending_swap = model
            self._swap_tag = tag

    def _apply_pending_swap(self) -> None:
        with self._lock:
            pending, tag = self._pending_swap, self._swap_tag
            self._pending_swap = self._swap_tag = None
        if pending is None:
            return
        before = _memory_stats(pending)
        old, self.model = self.model, pending
        del old  # the old instance's memory returns
        if self._swap_hook is not None:
            try:
                self._swap_hook(pending, tag)
            except Exception:
                logger.exception("swap hook failed (swap stands)")
        memory = ""
        if before:
            torch.cuda.empty_cache()
            after = _memory_stats(pending)
            memory = (f"; device memory allocated {before['device_memory_mib']} -> "
                      f"{after['device_memory_mib']} MiB, peak "
                      f"{after['device_memory_peak_mib']} MiB")
        self.reloads_applied += 1
        logger.warning(
            f"RELOAD SWAPPED: serving snapshot replaced on batch boundary "
            f"{self._batch_seq} ({tag}){memory}"
        )
        telemetry.emit(
            "serve-reload", outcome="swapped-in",
            batch=int(self._batch_seq), tag=str(tag),
        )

    # -- the loop --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, name="serve-engine", daemon=True
        )
        self._thread.start()

    def run(self) -> None:
        try:
            while not self._stop.is_set():
                self._apply_pending_swap()
                self._run_loop_calls()
                self.step(timeout=0.05)
        except Exception as err:
            logger.exception("serve engine loop died")
            self.fatal_error = err
            with self._lock:
                self._ready = False
                self._phase = PHASE_STOPPED
            raise
        finally:
            self._run_loop_calls(RuntimeError("the serving loop stopped"))

    def _call_on_loop(self, fn, timeout: float = 600.0) -> None:
        """Run ``fn`` on the loop thread at its next batch boundary and wait
        for it; re-raises its error, or RuntimeError when the loop stops
        first."""
        call = {"fn": fn, "sink": _kernels.apart_sink(), "done": threading.Event(),
                "error": None}
        with self._lock:
            self._loop_calls.append(call)
        retry.bounded_wait(lambda: call["done"].is_set() or not self._thread.is_alive(),
                           timeout, poll_s=0.01, describe="a call on the serving loop")
        if not call["done"].is_set():
            raise RuntimeError("the serving loop stopped before it ran the call")
        if call["error"] is not None:
            raise call["error"]

    def _run_loop_calls(self, refuse: Optional[BaseException] = None) -> None:
        """Run the calls handed to the loop (or fail them with ``refuse``)."""
        with self._lock:
            calls, self._loop_calls = self._loop_calls, []
        for call in calls:
            if refuse is not None:
                call["error"] = refuse
            else:
                apart = (_kernels.counted_apart(call["sink"]) if call["sink"] is not None
                         else contextlib.nullcontext())
                try:
                    with apart:
                        call["fn"]()
                except Exception as err:
                    call["error"] = err
            call["done"].set()

    def healthy(self) -> bool:
        """False once the loop thread has died (or recorded a fatal)."""
        if self.fatal_error is not None:
            return False
        return self._thread is None or self._thread.is_alive()

    def step(self, timeout: float = 0.05) -> int:
        """One loop iteration: form and dispatch at most one batch.
        Returns the number of requests served."""
        batch = self.queue.take_batch(
            self.bucket_edges, timeout, max_len=self.bucket_edges[-1]
        )
        chaos.note_serve_batch(self._batch_seq)
        if batch is None:
            return 0
        reqs, padded = batch
        # the queue counted this batch in-flight at pop time (same lock);
        # batch_done closes it
        try:
            t0 = time.monotonic()
            arr = np.full(
                (self.batch_size, padded), self.pad_idx, dtype=np.int32
            )
            for i, r in enumerate(reqs):
                arr[i, : len(r)] = r.tokens
            ids, score = self.infer_fn(self.model, arr)
            service = time.monotonic() - t0
            self.queue.note_batch_service(service, bucket=padded)
            self._batch_seq += 1
            for i, r in enumerate(reqs):
                if r.deadline.exceeded():
                    # computed but useless: count it honestly
                    self.expired_at_response += 1
                    self.queue.note_terminal_reason(rq.EXPIRED_AT_RESPONSE)
                    r.expire(rq.EXPIRED_AT_RESPONSE)
                    continue
                latency_ms = (time.monotonic() - r.arrival) * 1000.0
                r.respond(
                    rq.ServeResponse(
                        r.request_id,
                        rq.STATUS_OK,
                        output=[int(t) for t in ids[i, : len(r)]],
                        score=float(score[i]),
                        latency_ms=latency_ms,
                        bucket=padded,
                    )
                )
                self.served += 1
                with self._lock:
                    self._latencies_ms.append(latency_ms)
                    if len(self._latencies_ms) > _LATENCY_WINDOW:
                        del self._latencies_ms[: _LATENCY_WINDOW // 4]
            self._maybe_sample_drift(arr, len(reqs))
            return len(reqs)
        finally:
            self.queue.batch_done()

    def _maybe_sample_drift(self, arr, n_real: int) -> None:
        """Sampled per-request logit-drift check (quantized serving): every
        ``drift_sample_every``-th batch re-runs through the probe, and the
        max |logit_q - logit_f32| of each REAL request row lands in /stats.
        A dying probe disables itself; it never takes the loop down."""
        if (
            self._drift_probe is None
            or self._drift_probe_dead
            or self._drift_every <= 0
            or self._batch_seq % self._drift_every != 0
        ):
            return
        launched = {}
        try:
            # the probe's launches count apart from the serving path's
            with _kernels.counted_apart(launched):
                per_row = np.asarray(self._drift_probe(arr), np.float32)
        except Exception:
            self._drift_probe_dead = True
            logger.exception("quant drift probe died; per-request drift sampling "
                             "disabled (serving continues)")
            return
        finally:
            with self._lock:
                for k, n in launched.items():
                    self._probe_launches[k] = self._probe_launches.get(k, 0) + n
        rows = per_row[:n_real] if per_row.ndim else per_row.reshape(1)
        if rows.size == 0:
            return
        batch_max = float(rows.max())
        with self._lock:
            d = self._drift
            d["samples"] += int(n_real)
            d["last_abs"] = batch_max
            d["max_abs"] = max(d["max_abs"], batch_max)
            # an EMA, so a long run's mean tracks the current snapshot
            mean = float(rows.mean())
            d["mean_abs"] = (mean if d["samples"] <= n_real
                             else 0.1 * mean + 0.9 * d["mean_abs"])
            running = d["max_abs"]
        telemetry.emit(
            "quant-path", event="drift-sample", batch=int(self._batch_seq),
            requests=int(n_real),
            max_abs_logit_drift=round(batch_max, 6),
            running_max=round(running, 6),
        )

    # -- drain / stop ----------------------------------------------------

    def drain(self, deadline: Deadline) -> bool:
        """Graceful shutdown: stop admitting, flush everything already
        queued (plus the in-flight batch) under ``deadline``.  Returns
        True when the queue emptied in time."""
        self.queue.begin_drain()
        self.set_ready(False, PHASE_DRAINING)
        depth = self.queue.depth()
        logger.info(
            f"DRAIN started: {depth} queued request(s), "
            f"budget {deadline.budget if deadline.budget is not None else 'inf'}s"
        )
        try:
            retry.bounded_wait(
                self.queue.idle,
                timeout=max(0.0, deadline.remaining()),
                poll_s=0.05,
                describe="serve drain",
            )
            drained = True
        except retry.WaitTimeoutError:
            drained = False
        self.stop()
        _report_drain(drained, deadline, depth, self._flush_undrained)
        return drained

    def _flush_undrained(self) -> int:
        n = 0
        while True:
            batch = self.queue.take_batch(
                self.bucket_edges, 0.0, max_len=self.bucket_edges[-1]
            )
            if batch is None:
                break
            for r in batch[0]:
                r.shed(rq.SHED_DRAINING)
                n += 1
            self.queue.batch_done()
        return n

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._phase = PHASE_STOPPED
            self._ready = False
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    # -- stats -----------------------------------------------------------

    def latency_percentiles(self) -> dict:
        with self._lock:
            lat = list(self._latencies_ms)
        if not lat:
            return {}
        arr = np.asarray(lat)
        return {
            f"p{p}_ms": round(float(np.percentile(arr, p)), 3)
            for p in (50, 90, 99)
        }

    def update_quant_info(self, info: dict) -> None:
        """A hot swap committed a re-calibrated snapshot: /stats must
        describe the snapshot actually serving, so the calibration block is
        replaced and the drift aggregate starts over."""
        with self._lock:
            self.quant_info = dict(info)
            self._drift = {"samples": 0, "max_abs": 0.0, "mean_abs": 0.0,
                           "last_abs": 0.0}

    def stats(self) -> dict:
        quant = probe = None
        if self.quant_info is not None:
            with self._lock:
                quant = {**self.quant_info, "request_drift": dict(self._drift)}
                probe = dict(self._probe_launches)
        return {
            "phase": self._phase,
            "ready": self._ready,
            "precision": self.precision or "training",
            **({"quant": quant} if quant is not None else {}),
            "device": self.device,
            "served": self.served,
            "admitted": self.queue.admitted,
            "shed": dict(self.queue.shed_counts),
            "depth": self.queue.depth(),
            "batches": self._batch_seq,
            "buckets": list(self.bucket_edges),
            "batch_size": self.batch_size,
            "estimated_delay_s": round(self.queue.estimated_delay(), 4),
            "reloads_applied": self.reloads_applied,
            #: per-kernel launch counts of this process's serving path
            #: (ops/_kernels.py); the reload thread's and the drift probe's
            #: are counted apart, below
            "kernel_launches": _kernels.launch_counts(),
            "reload_kernel_launches": dict(self.reload_launches),
            **_memory_stats(self.model),
            **({"probe_kernel_launches": probe} if probe is not None else {}),
            **self.latency_percentiles(),
        }


def probe_batch(batch: int, length: int, pad_idx: int) -> np.ndarray:
    """The reload probe's dummy batch: pads, but for one live token at the
    head of each row.  The JAX engine probes an all-pad batch, whose every
    key is masked: with the fp32 minimum cast to bf16 or fp16 (-inf) each
    row softmaxes to NaN, so its probe rejects every low-precision model.
    A live key per row keeps the canary's verdict (shape, finite scores)
    about the weights."""
    dummy = np.full((batch, length), pad_idx, dtype=np.int32)
    dummy[:, 0] = 0 if pad_idx != 0 else 1
    return dummy


def _report_drain(drained: bool, deadline: Deadline, depth: int, flush) -> None:
    """The drain's verdict, logged and journalled (``serve-drain``) as the
    JAX engine does; ``flush`` resolves the leftovers of a blown budget."""
    if drained:
        logger.info(
            f"DRAIN complete: in-flight work flushed in "
            f"{deadline.elapsed():.2f}s"
        )
        telemetry.emit(
            "serve-drain", outcome="complete",
            seconds=round(deadline.elapsed(), 3), queued=depth,
        )
        return
    leftovers = flush()
    logger.error(
        f"DRAIN deadline exceeded: {leftovers} request(s) abandoned "
        f"after {deadline.elapsed():.2f}s (each got a terminal "
        "'draining' response)"
    )
    telemetry.emit(
        "serve-drain", outcome="deadline-exceeded",
        seconds=round(deadline.elapsed(), 3), abandoned=int(leftovers),
    )


def _memory_stats(model) -> dict:
    """The device memory of the card a model lies on (MiB allocated, live
    and peak), for /stats and the swap's log line: what a hot swap
    releases.  Empty off the card."""
    p = next(iter(model.parameters()), None) if hasattr(model, "parameters") else None
    dev = p.device if p is not None and p.device.type == "cuda" else None
    if dev is None:
        return {}
    return {"device_memory_mib": round(torch.cuda.memory_allocated(dev) / 2**20, 1),
            "device_memory_peak_mib": round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)}
