"""Step-time spans (counterpart of ``unicore_tpu/telemetry/spans.py``):
where does a train update spend its time?

The training thread's per-update work splits into host phases --

* ``data_wait``       waiting on the (possibly prefetched) iterator,
* ``plan_exchange``   the multi-host slot-plan exchange (not ported: the
                      port's prefetcher has no plan exchange, so this phase
                      stays empty),
* ``h2d``             host->device copies of the batch on the training
                      thread,
* ``dispatch``        the rest of the update's wall on the host: enqueueing
                      the forward, backward and optimizer kernels, and any
                      host sync the update makes,

-- plus the device phase, ``device_busy``, which the host cannot see without
a sync.  The host phases are ``perf_counter`` walls (always on once
telemetry is configured); the device phase is a **lag-1 sampled** probe: on
a sampled update N the trainer hands :meth:`SpanRecorder.note_dispatched` a
``torch.cuda.Event`` recorded on the compute stream after N's last kernel
was enqueued, and at the next idle host point (update N+1's ``data_wait``)
the recorder waits on it.  The module-level :func:`_device_sync`
(``event.synchronize()``) is the only sync in the spans path.  On the CPU
the handle is a :class:`HostProbe`, whose ``synchronize`` returns at once,
so every CPU sample is an upper bound, and the journal says so.

Sampling contract (``--telemetry-sample-interval N``): the probe runs on
every N-th update only; unsampled updates make ZERO sync calls (the tests
stub :func:`_device_sync` and count).  ``N=0`` disables the probe (the host
spans still feed the ``host_blocked`` metric).

When the sync returned at once, the device had gone idle inside the gap and
the measurement is only an upper bound: the journal record carries
``upper_bound: true`` and the ``device_busy`` metric leaves the sample out,
so an input-bound run never passes for device-bound.  A trainer that syncs
inside its own update (the port's ``train_step`` reads the gradient norm and
the loss on the host) leaves nothing for the probe to wait on: every sample
is then an upper bound and ``dispatch`` holds the device's time.

Sampled updates also write a ``kind="span"`` record per phase into the event
journal, the raw material ``unicore-tpu-torch-trace`` turns into Chrome-trace
slices.  The JAX package's cross-host straggler attribution (its heartbeat
leases) is not ported; :meth:`SpanRecorder.avg_step_wall` is, and the
trainer's ``/metrics`` exports it.
"""

import contextlib
import logging
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

#: host-side phases (order is display order in traces)
HOST_SPANS = ("data_wait", "plan_exchange", "h2d", "dispatch")
DEVICE_SPAN = "device_busy"

#: EMA horizon for the smoothed per-update step wall
_STEP_WALL_EMA = 0.2


class HostProbe:
    """The probe handle of an update that ran on the CPU: nothing is left
    to wait for when the update returns."""

    def synchronize(self) -> None:
        pass


def _device_sync(handle) -> None:
    """The ONE device sync in the spans path -- module-level so the
    overhead tests can stub it and count calls."""
    handle.synchronize()


class SpanRecorder:
    """Per-process span accumulator (driven by the trainer + CLI loop)."""

    def __init__(self, sample_interval: int = 0):
        self.sample_interval = max(0, int(sample_interval))
        self.enabled = False
        # True between begin_update and end_update: spans recorded
        # OUTSIDE an open update (validation's plan/h2d, checkpoint
        # writes) are dropped — they are not hot-loop blockage and must
        # not poison the dispatch residual or the host_blocked total
        self._open = False
        # per-update span durations (reset each update)
        self._current: Dict[str, float] = {}
        # between-update host work attributed to the NEXT update (the
        # CLI's data_wait — recorded via between_span before train_step
        # opens the bracket)
        self._between: Dict[str, float] = {}
        self._update_started: Optional[float] = None
        # interval totals drained by trainer.flush_metrics.  The busy
        # total counts MEASURED samples only (the sync had to wait, so
        # the gap is the device's real occupancy); upper-bound samples
        # (device already idle at first look) are journaled with the
        # flag but excluded here — else a checkpoint/validation wall on
        # a sampled update would masquerade as device time
        self._totals: Dict[str, float] = {}
        self._device_busy_total = 0.0
        self._device_samples = 0  # all collected probes, incl. bounded
        # lag-1 probe state: (update, handle, dispatch_end_mono)
        self._pending_probe: Optional[tuple] = None
        # smoothed per-update wall: data_wait + in-step wall, EXCLUDING
        # between-update bookkeeping (validation, a checkpoint save)
        self._step_wall_ema = -1.0

    # -- configuration ----------------------------------------------------

    def configure(self, sample_interval: int) -> None:
        self.sample_interval = max(0, int(sample_interval))
        self.enabled = True

    def sampled(self, update: int) -> bool:
        return (
            self.sample_interval > 0
            and update >= 0
            and update % self.sample_interval == 0
        )

    # -- host spans -------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str):
        """Accumulate one host phase of the OPEN update (no-op when
        disabled or when no update is open — a plan exchange or transfer
        issued by validation must not count as hot-loop blockage)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    @contextlib.contextmanager
    def between_span(self, name: str):
        """A between-updates phase (the CLI's data_wait), attributed to
        the NEXT update when it opens.  Entering it also collects any
        pending lag-1 device probe: the training thread is about to idle
        on the data iterator anyway (production happens on other
        threads), so blocking on the previous sampled update's output
        here costs nothing and reads the device-busy gap at the earliest
        possible host point."""
        if not self.enabled:
            yield
            return
        self.collect_probe()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if dt > 0:
                self._between[name] = self._between.get(name, 0.0) + dt

    def add(self, name: str, seconds: float) -> None:
        if not self.enabled or not self._open or seconds <= 0:
            return
        self._current[name] = self._current.get(name, 0.0) + seconds
        self._totals[name] = self._totals.get(name, 0.0) + seconds

    def add_dispatch_residual(self, hot_block_seconds: float) -> None:
        """``dispatch`` = the hot block's wall minus the plan_exchange
        and h2d pieces already recorded for this update (those run inside
        the same block)."""
        if not self.enabled:
            return
        residual = hot_block_seconds - self._current.get(
            "plan_exchange", 0.0
        ) - self._current.get("h2d", 0.0)
        self.add("dispatch", residual)

    # -- update lifecycle (called by the trainer) -------------------------

    def collect_probe(self) -> None:
        """Resolve a pending lag-1 device probe (the ONLY sync in the
        spans path; only sampled updates ever leave one pending).

        ``busy`` is dispatch-end -> sync-return.  When the sync had to
        WAIT (the device was still computing when the host looked), that
        is the device's real occupancy up to this moment.  When it
        returned instantly, the device finished somewhere inside the gap
        and ``busy`` is only an upper bound — the journal record says so
        (``upper_bound: true``) instead of letting an input-bound run
        masquerade as device-bound.  Called at the earliest idle host
        point (the data_wait between-span) and again from begin_update
        as a fallback."""
        pending = self._pending_probe
        if pending is None:
            return
        probe_update, handle, dispatched_at = pending
        self._pending_probe = None
        try:
            t0 = time.perf_counter()
            _device_sync(handle)
            sync_wait = time.perf_counter() - t0
            busy = max(0.0, time.monotonic() - dispatched_at)
            upper_bound = sync_wait < 1e-3
            self._device_samples += 1
            if not upper_bound:
                # the sync WAITED: the device was busy the whole gap —
                # only these samples feed the device_busy metric
                self._device_busy_total += busy
            from unicore_tpu_torch.telemetry import journal

            journal.emit(
                "span", update=probe_update, name=DEVICE_SPAN,
                dur=round(busy, 6),
                # True: the device was already idle when the host first
                # looked — the real busy time is <= dur (journal-only;
                # the metric excludes these samples)
                upper_bound=upper_bound,
            )
        except Exception as err:
            logger.debug(f"device-busy probe failed: {err}")

    def begin_update(self, update: int) -> None:
        """Collect any still-pending lag-1 probe, then open update
        ``update``, folding in the between-updates work (data_wait)
        recorded since the previous update closed."""
        if not self.enabled:
            return
        self.collect_probe()
        self._update_started = time.monotonic()
        self._open = True
        for name, dt in self._between.items():
            self._current[name] = self._current.get(name, 0.0) + dt
            self._totals[name] = self._totals.get(name, 0.0) + dt
        self._between = {}

    def note_dispatched(self, update: int, handle: Any) -> None:
        """Called once the update's kernels are enqueued.  On a sampled
        update, retain ``handle`` (a CUDA event recorded after the update's
        last kernel, or a :class:`HostProbe`) for the lag-1 probe;
        unsampled updates retain NOTHING and therefore can never sync."""
        if not self.enabled or not self.sampled(update):
            return
        self._pending_probe = (int(update), handle, time.monotonic())

    def end_update(self, update: int) -> None:
        """Close update ``update``: fold its wall into the step-wall EMA
        and journal the host spans when sampled."""
        if not self.enabled:
            return
        self._open = False
        now = time.monotonic()
        if self._update_started is not None:
            # per-update wall = iterator wait + the in-step wall; the
            # between-update tail (validation, a checkpoint save on the
            # writer rank) is deliberately EXCLUDED: the wall describes the
            # sustained step rate
            wall = (now - self._update_started) + self._current.get(
                "data_wait", 0.0
            )
            self._step_wall_ema = (
                wall
                if self._step_wall_ema < 0
                else (1 - _STEP_WALL_EMA) * self._step_wall_ema
                + _STEP_WALL_EMA * wall
            )
            self._update_started = None
        if self.sampled(update) and self._current:
            from unicore_tpu_torch.telemetry import journal

            for name in HOST_SPANS:
                dur = self._current.get(name)
                if dur:
                    journal.emit(
                        "span", update=int(update), name=name,
                        dur=round(dur, 6),
                    )
        self._current = {}

    # -- interval drain (trainer.flush_metrics) ---------------------------

    def drain(self) -> Dict[str, float]:
        """Interval totals since the last drain: per-host-span seconds,
        the summed ``host_blocked``, and the sampled ``device_busy``
        seconds (plus sample count)."""
        out = dict(self._totals)
        out["host_blocked"] = sum(
            self._totals.get(k, 0.0) for k in HOST_SPANS
        )
        out[DEVICE_SPAN] = self._device_busy_total
        out["device_samples"] = float(self._device_samples)
        self._totals = {}
        self._device_busy_total = 0.0
        self._device_samples = 0
        return out

    def avg_step_wall(self) -> float:
        """Smoothed seconds per update (-1 before the first completed
        update; data_wait + in-step wall, between-update bookkeeping
        excluded): the trainer's ``unicore_tpu_train_step_wall_seconds``."""
        return self._step_wall_ema


_recorder = SpanRecorder()


def recorder() -> SpanRecorder:
    return _recorder


def reset() -> None:
    """Fresh recorder (tests)."""
    global _recorder
    _recorder = SpanRecorder()


def configure(args) -> SpanRecorder:
    _recorder.configure(
        getattr(args, "telemetry_sample_interval", 0) or 0
    )
    return _recorder


def span(name: str):
    return _recorder.span(name)


def add(name: str, seconds: float) -> None:
    _recorder.add(name, seconds)


def avg_step_wall() -> float:
    return _recorder.avg_step_wall()
