"""Bounded admission queue with explicit load shedding (counterpart of
``unicore_tpu/serve/admission.py``).

**Never buffer unboundedly**: overload has one sanctioned outcome, an
immediate rejection with a named reason.  Admission enforces, in order:

1. server state: a draining or not-yet-warm server sheds on sight
   (``draining`` / ``not-ready``), an over-long request sheds ``too-long``;
2. capacity: a full queue sheds ``queue-full``;
3. deadline feasibility: a request whose deadline cannot survive the
   ESTIMATED queue delay sheds ``deadline-unmeetable``.  The estimate is
   per bucket: queued work groups by shape bucket and each bucket's
   batches are costed at that (bucket, precision) service-time EMA; a
   bucket with no sample yet falls back to the global EMA.

Deadlines are enforced again at batch formation (:meth:`take_batch` drops
expired requests un-computed) and a third time at response (the engine
marks a late result ``expired-at-response``).  Batch formation is
bucket-affine: the head request picks the shape bucket and the queue is
scanned FIFO for more requests snapping to the same bucket.

Sheds are counted per reason (``/stats``, ``/metrics``); the first five of
each reason, then every hundredth, are logged and journalled
(``serve-shed``), as the JAX queue samples them.
"""

import logging
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.data.data_utils import bucket_for
from unicore_tpu_torch.serve import request as rq

logger = logging.getLogger(__name__)


class AdmissionQueue:
    """Bounded FIFO of admitted requests with shedding,
    deadline-feasibility estimation, and bucket-affine batch formation."""

    def __init__(self, capacity: int, *, batch_capacity: int = 8,
                 max_len: int = 0, service_ema_alpha: float = 0.2,
                 bucket_edges: Optional[Sequence[int]] = None,
                 precision: str = ""):
        self.capacity = int(capacity)
        self.batch_capacity = max(1, int(batch_capacity))
        #: longest admissible request (0 = unchecked)
        self.max_len = int(max_len)
        self._alpha = float(service_ema_alpha)
        #: bucket set for per-bucket service estimation (None = one
        #: global EMA)
        self.bucket_edges = (
            tuple(sorted(int(e) for e in bucket_edges))
            if bucket_edges else None
        )
        #: precision label keying the per-bucket EMAs
        self.precision = str(precision)
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        #: EMA of one batch's service time (seconds); None until the
        #: engine has dispatched a batch (warm-up seeds it)
        self._service_ema: Optional[float] = None
        #: (bucket, precision) -> EMA of that bucket's batch-service time
        self._service_ema_by_key = {}
        #: bucket -> queued-item count, maintained incrementally so the
        #: admission gate's delay estimate stays O(1) in queue depth
        self._bucket_counts: dict = {}
        self._accepting = False
        self._draining = False
        # batches popped but not yet fully responded (engine calls
        # batch_done); incremented under the SAME lock as the pop, so
        # "queue empty AND nothing in flight" is an atomic observation
        self._inflight = 0
        # shed/expiry accounting (per reason, for /stats)
        self.shed_counts = {}
        self.admitted = 0

    # -- state gates -----------------------------------------------------

    def set_accepting(self, accepting: bool) -> None:
        with self._lock:
            self._accepting = bool(accepting)

    def begin_drain(self) -> None:
        """Stop admitting; everything already queued still gets served
        (or expires).  Irreversible — drain is the path to exit."""
        with self._lock:
            self._draining = True
            self._cond.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def idle(self) -> bool:
        """Atomically: nothing queued AND nothing popped-but-unresponded.
        The drain-complete condition."""
        with self._lock:
            return not self._items and self._inflight == 0

    def batch_done(self) -> None:
        with self._lock:
            self._inflight -= 1

    # -- service-time feedback (engine) ----------------------------------

    def note_batch_service(self, seconds: float,
                           bucket: Optional[int] = None) -> None:
        """EMA update from the engine after each dispatched batch; also
        seeded once per bucket by warm-up."""
        seconds = float(seconds)

        def fold(prev):
            return (
                seconds if prev is None
                else self._alpha * seconds + (1 - self._alpha) * prev
            )

        with self._lock:
            self._service_ema = fold(self._service_ema)
            if bucket is not None:
                key = (int(bucket), self.precision)
                self._service_ema_by_key[key] = fold(
                    self._service_ema_by_key.get(key)
                )

    def _bucket_of(self, n: int) -> Optional[int]:
        """The padded length request-length ``n`` snaps to (take_batch's
        rule); None when the queue was built without a bucket set."""
        if self.bucket_edges is None:
            return None
        return bucket_for(n, self.bucket_edges) or min(
            max(n, 1), self.max_len or n
        )

    def _count_queued(self, req, delta: int) -> None:
        """Per-bucket bookkeeping (caller holds the lock): +1 on offer, -1
        when an item permanently leaves the deque."""
        if self.bucket_edges is None:
            return
        b = self._bucket_of(len(req))
        n = self._bucket_counts.get(b, 0) + delta
        if n > 0:
            self._bucket_counts[b] = n
        else:
            self._bucket_counts.pop(b, None)

    def _ema_for(self, bucket: Optional[int]) -> Optional[float]:
        if bucket is not None:
            ema = self._service_ema_by_key.get((bucket, self.precision))
            if ema is not None:
                return ema
        return self._service_ema

    def estimated_delay(self, length: Optional[int] = None) -> float:
        """Seconds a request admitted NOW is expected to wait before its
        batch completes.  0.0 until the engine has calibrated."""
        with self._lock:
            return self._estimated_delay_locked(extra_len=length)

    def _estimated_delay_locked(
        self, extra: int = 1, extra_len: Optional[int] = None
    ) -> float:
        if self._service_ema is None:
            return 0.0
        if self.bucket_edges is None:
            batches_ahead = (len(self._items) + extra
                             + self.batch_capacity - 1) \
                // self.batch_capacity
            return batches_ahead * self._service_ema
        # bucket-affine formation: the queue drains as ceil(count/capacity)
        # batches PER bucket, each at that bucket's own service time
        counts = dict(self._bucket_counts)
        if extra and extra_len is not None:
            b = self._bucket_of(extra_len)
            counts[b] = counts.get(b, 0) + extra
        total = 0.0
        for b, n in counts.items():
            batches = (n + self.batch_capacity - 1) // self.batch_capacity
            ema = self._ema_for(b)
            total += batches * (ema if ema is not None else 0.0)
        if extra and extra_len is None:
            # no length known (the /stats path): cost the hypothetical
            # request one batch at the blended global EMA
            total += self._service_ema
        return total

    # -- admission -------------------------------------------------------

    def _count_shed(self, reason: str) -> None:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    def note_terminal_reason(self, reason: str) -> None:
        """Shed/expiry accounting hook for the engine (e.g.
        ``expired-at-response`` is decided at dispatch, not here)."""
        with self._lock:
            self._count_shed(reason)

    def admit(self, req: "rq.ServeRequest") -> bool:
        """Admit or immediately resolve ``req`` with a named shed/expiry
        reason.  Returns True iff the request entered the queue."""
        with self._lock:
            if self._draining:
                reason = rq.SHED_DRAINING
            elif not self._accepting:
                reason = rq.SHED_NOT_READY
            elif self.max_len and len(req) > self.max_len:
                reason = rq.SHED_TOO_LONG
            elif req.deadline.exceeded():
                reason = rq.EXPIRED_AT_ADMISSION
            elif len(self._items) >= self.capacity:
                reason = rq.SHED_QUEUE_FULL
            elif req.deadline.remaining() < self._estimated_delay_locked(
                extra_len=len(req)
            ):
                reason = rq.SHED_DEADLINE_UNMEETABLE
            else:
                self._items.append(req)
                self._count_queued(req, +1)
                self.admitted += 1
                self._cond.notify()
                return True
            self._count_shed(reason)
            count = self.shed_counts[reason]
            depth, est = len(self._items), self._estimated_delay_locked(
                extra_len=len(req)
            )
        # resolve OUTSIDE the lock: respond() wakes transport waiters
        if reason == rq.EXPIRED_AT_ADMISSION:
            req.expire(reason)
        else:
            req.shed(reason)
        # a flood sheds thousands of times in seconds: log (and journal)
        # the first few per reason then sample; the per-reason counters
        # stay exact
        if count <= 5 or count % 100 == 0:
            logger.warning(
                f"SHED request {req.request_id}: {reason} #{count} "
                f"(depth {depth}/{self.capacity}, est-delay {est:.3f}s, "
                f"deadline-left {req.deadline.remaining():.3f}s)"
            )
            telemetry.emit(
                "serve-shed", reason=str(reason), count=int(count),
                request_id=req.request_id, depth=int(depth),
                estimated_delay_s=round(est, 4),
            )
        return False

    # -- batch formation -------------------------------------------------

    def take_batch(
        self,
        bucket_edges: Optional[Sequence[int]],
        timeout: float,
        *,
        max_len: int,
        clock=time.monotonic,
    ) -> Optional[Tuple[List["rq.ServeRequest"], int]]:
        """Form the next bucket-affine batch, waiting up to ``timeout``
        seconds for work.  Returns ``(requests, padded_len)`` or None.

        Expired requests encountered while forming are dropped and
        resolved ``expired-in-queue``.  The condition wait is sliced under
        ``timeout``, so the engine loop stays responsive to drain/stop.
        """
        deadline = clock() + max(0.0, float(timeout))
        expired: List[rq.ServeRequest] = []
        picked: List[rq.ServeRequest] = []
        padded = 0
        with self._lock:
            while True:
                # shed expired heads first so a queue full of corpses
                # doesn't stall live work behind them
                head = None
                while self._items:
                    cand = self._items.popleft()
                    self._count_queued(cand, -1)
                    if cand.deadline.exceeded():
                        expired.append(cand)
                        continue
                    head = cand
                    break
                if head is not None:
                    break
                left = deadline - clock()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(0.05, left))
            if head is not None:
                padded = bucket_for(len(head), bucket_edges) or min(
                    max(len(head), 1), max_len
                )
                picked.append(head)
                # FIFO scan for same-bucket peers; non-matching requests
                # keep their positions
                keep: List[rq.ServeRequest] = []
                while self._items and len(picked) < self.batch_capacity:
                    cand = self._items.popleft()
                    self._count_queued(cand, -1)
                    if cand.deadline.exceeded():
                        expired.append(cand)
                        continue
                    cand_bucket = bucket_for(len(cand), bucket_edges) or min(
                        max(len(cand), 1), max_len
                    )
                    if cand_bucket == padded:
                        picked.append(cand)
                    else:
                        keep.append(cand)
                for item in reversed(keep):
                    self._items.appendleft(item)
                    self._count_queued(item, +1)
            if picked:
                # same lock as the pop: an observer can never see the
                # queue empty while these requests are un-responded
                self._inflight += 1
            for corpse in expired:
                self._count_shed(rq.EXPIRED_IN_QUEUE)
        for corpse in expired:
            corpse.expire(rq.EXPIRED_IN_QUEUE)
            logger.warning(
                f"EXPIRED request {corpse.request_id} dropped while forming "
                "a batch (expired-in-queue): its deadline ran out waiting — "
                "not computed"
            )
        if not picked:
            return None
        return picked, int(padded)
