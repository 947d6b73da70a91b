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
* **Drain, don't drop**: SIGTERM stops admission and flushes in-flight
  work under a deadline (:meth:`drain`).

Hot reload, quantized serving and the decode plane are not ported yet.
"""

import logging
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.serve import request as rq
from unicore_tpu_torch.serve.admission import AdmissionQueue
from unicore_tpu_torch.utils import retry

logger = logging.getLogger(__name__)

#: engine phases surfaced by the readiness probe
PHASE_WARMING = "warming-up"
PHASE_SERVING = "serving"
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
        infer_fn: Callable,
        *,
        bucket_edges: Sequence[int],
        batch_size: int,
        pad_idx: int = 0,
        vocab_size: Optional[int] = None,
        admission_capacity: int = 256,
        device: str = "",
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
        self.queue = AdmissionQueue(
            admission_capacity,
            batch_capacity=self.batch_size,
            max_len=self.bucket_edges[-1],
            bucket_edges=self.bucket_edges,
        )
        self._phase = PHASE_WARMING
        self._ready = False
        self._stop = threading.Event()
        self._batch_seq = 0
        self.served = 0
        self.expired_at_response = 0
        self._latencies_ms: List[float] = []
        self._lock = threading.Lock()
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
        req = rq.ServeRequest.make(tokens, deadline_s, request_id)
        if self.vocab_size is not None and len(req) and (
            int(req.tokens.min()) < 0
            or int(req.tokens.max()) >= self.vocab_size
        ):
            raise ValueError(
                f"token ids must lie in [0, {self.vocab_size}), got "
                f"[{int(req.tokens.min())}, {int(req.tokens.max())}]"
            )
        self.queue.admit(req)
        return req

    # -- the loop --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, name="serve-engine", daemon=True
        )
        self._thread.start()

    def run(self) -> None:
        try:
            while not self._stop.is_set():
                self.step(timeout=0.05)
        except Exception as err:
            logger.exception("serve engine loop died")
            self.fatal_error = err
            with self._lock:
                self._ready = False
                self._phase = PHASE_STOPPED
            raise

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
            return len(reqs)
        finally:
            self.queue.batch_done()

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
        if drained:
            logger.info(
                f"DRAIN complete: in-flight work flushed in "
                f"{deadline.elapsed():.2f}s"
            )
        else:
            leftovers = self._flush_undrained()
            logger.error(
                f"DRAIN deadline exceeded: {leftovers} request(s) abandoned "
                f"after {deadline.elapsed():.2f}s (each got a terminal "
                "'draining' response)"
            )
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

    def stats(self) -> dict:
        return {
            "phase": self._phase,
            "ready": self._ready,
            "device": self.device,
            "served": self.served,
            "admitted": self.queue.admitted,
            "shed": dict(self.queue.shed_counts),
            "depth": self.queue.depth(),
            "batches": self._batch_seq,
            "buckets": list(self.bucket_edges),
            "batch_size": self.batch_size,
            "estimated_delay_s": round(self.queue.estimated_delay(), 4),
            #: per-kernel launch counts of this process (ops/_kernels.py)
            "kernel_launches": _kernels.launch_counts(),
            **self.latency_percentiles(),
        }
