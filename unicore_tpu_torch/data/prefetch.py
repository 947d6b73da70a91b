"""Device prefetcher for one process (counterpart of
``unicore_tpu/data/prefetch.py``'s ``DevicePrefetcher``).

While update N runs, a producer thread takes update N+1's micro-batches
from the grouped iterator (collating them), counts their real tokens,
rows and padded lengths on the host -- so the trainer needs no device sync
to count -- copies each array into pinned memory and issues
``.to(device, non_blocking=True)`` on a side CUDA stream, and records an
event.  The training thread (:meth:`DevicePrefetcher.__next__`) makes its
current stream wait on that event and calls ``record_stream`` on every
tensor it takes, so the caching allocator does not hand the memory out
again while the update still reads it.

The first update of each epoch is synchronous, as in the JAX package: it
is handed over as the raw micro-batches.  At most ``depth``
(``--prefetch-depth``) prepared updates wait in the queue.  The iterator
position a checkpoint records is what the training thread CONSUMED
(:meth:`attach_epoch_itr`), not what the producer read ahead, so a
mid-epoch resume does not skip the buffered updates; :meth:`skip` discards
updates as consumed (the health sentinel's skip-ahead).  :meth:`close` stops
the producer on every exit path; the trainer's ``finish_prefetch`` calls
it.

The producer's wall preparing each update is the trainer's
``prefetch_wall`` stat, its copies count in ``transfer_wall``, as in the
JAX trainer.  The multi-host slot-plan exchange of the JAX prefetcher is
not ported: at one process it skips it too.
"""

import contextlib
import itertools
import logging
import queue
import threading
import time
import traceback
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# queue sentinel: the producer finished the epoch
_DONE = object()


class PrefetchError(RuntimeError):
    """The producer thread died without delivering an item or an error."""


class PreparedUpdate(NamedTuple):
    """One update's micro-batches on the device and their host counts, and
    the producer's wall seconds preparing them (the ``prefetch_wall``
    stat)."""
    samples: List[dict]
    counts: List[Tuple[int, int, int]]  # (non-pad tokens, rows, padded length)
    n_batches: int
    prefetch_wall: float = 0.0


class _ProducerError(NamedTuple):
    exc: BaseException
    tb: str


def _pinned_to_device(sample, device):
    if isinstance(sample, dict):
        return {k: _pinned_to_device(v, device) for k, v in sample.items()}
    t = torch.as_tensor(np.asarray(sample))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _tensors(sample):
    if isinstance(sample, dict):
        for v in sample.values():
            yield from _tensors(v)
    else:
        yield sample


class DevicePrefetcher:
    """Wraps a :class:`~unicore_tpu_torch.data.iterators.GroupedIterator`
    of update chunks; yields a :class:`PreparedUpdate`, or for the epoch's
    first update the chunk itself, built ``depth`` updates ahead."""

    def __init__(self, trainer, grouped_itr, depth: int = 2):
        self.trainer = trainer
        self.device = torch.device(trainer.device)
        self._inner = grouped_itr
        self._queue: "queue.Queue" = queue.Queue(max(1, depth))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._first_seq = int(getattr(grouped_itr, "n", 0))
        self._expect = int(len(grouped_itr)) - self._first_seq
        self._consumed_items = 0
        self._consumed_batches = 0
        self._base_iterations = 0
        self._finished = False
        self._epoch_itr = None
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self.prefetched_updates = 0
        self.synchronous_updates = 0

    # -- lifecycle -------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._produce, name="device-prefetcher",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Stop the producer and detach; safe to call twice.  Items still
        queued are dropped (a resume re-reads them from the consumed
        position)."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            if self._thread.is_alive():
                logger.warning("device prefetcher did not stop within 30s")
        self._finished = True
        if self._epoch_itr is not None:
            if getattr(self._epoch_itr, "position_source", None) is self:
                self._epoch_itr.position_source = None
            self._epoch_itr = None

    # -- the epoch iterator's position -------------------------------------

    def attach_epoch_itr(self, epoch_itr):
        """Make ``epoch_itr.state_dict`` record the consumed position."""
        self._base_iterations = int(epoch_itr.iterations_in_epoch)
        self._epoch_itr = epoch_itr
        epoch_itr.position_source = self

    @property
    def iterations_in_epoch(self) -> int:
        return self._base_iterations + self._consumed_batches

    def end_of_epoch(self) -> bool:
        return not self.has_next()

    # -- iterator surface --------------------------------------------------

    @property
    def n(self) -> int:
        return self._first_seq + self._consumed_items

    def __len__(self):
        return self._first_seq + self._expect

    def __iter__(self):
        return self

    def has_next(self) -> bool:
        return not self._finished and self._consumed_items < self._expect

    def skip(self, num_to_skip):
        """Consume and discard ``num_to_skip`` update chunks (the health
        sentinel's post-rewind fast-forward).  They are pulled through the
        queue, so the producer's order holds, and counted as consumed;
        the data-stall budget is relaxed as in
        :meth:`~unicore_tpu_torch.data.iterators.CountingIterator.skip`."""
        from unicore_tpu_torch.data.iterators import relaxed_stall_watchdog

        with relaxed_stall_watchdog():
            for _ in itertools.islice(self, num_to_skip):
                pass
        return self

    def __next__(self):
        if self._finished or self._consumed_items >= self._expect:
            self._finished = True
            raise StopIteration()
        while True:
            try:
                item = self._queue.get(True, timeout=5.0)
                break
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive():
                    self._finished = True
                    raise PrefetchError("device prefetcher producer thread died without "
                                        "delivering an item or an error") from None
        if item is _DONE:
            self._finished = True
            raise StopIteration()
        if isinstance(item, _ProducerError):
            self._finished = True
            logger.error("device prefetcher producer thread failed:\n%s", item.tb)
            raise item.exc
        self._consumed_items += 1
        if isinstance(item, _Staged):
            self._consumed_batches += item.n_batches
            self.prefetched_updates += 1
            if item.event is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(item.event)
                for s in item.samples:
                    for t in _tensors(s):
                        t.record_stream(current)
            return PreparedUpdate(item.samples, item.counts, item.n_batches,
                                  item.prefetch_wall)
        self._consumed_batches += len(item)
        self.synchronous_updates += 1
        return item

    # -- producer ------------------------------------------------------------

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for seq in itertools.count(self._first_seq):
                if self._stop.is_set():
                    return
                samples = next(self._inner, None)
                if samples is None:
                    break
                item = self._build(list(samples), seq)
                if not self._put(item):
                    return
            self._put(_DONE)
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            self._put(_ProducerError(e, traceback.format_exc()))

    def _build(self, samples, seq: int):
        if seq == self._first_seq:
            return samples  # the epoch's first update runs synchronously
        t0 = time.perf_counter()
        counts = [self.trainer.host_counts(s) for s in samples]
        event = None
        # the copies count in the trainer's transfer_wall (not in its h2d
        # span: this is the host work the training thread no longer pays)
        timer = getattr(self.trainer, "transfer_timer", contextlib.nullcontext)
        with timer():
            if self._stream is None:
                prepared = [_pinned_to_device(s, self.device) for s in samples]
            else:
                with torch.cuda.stream(self._stream):
                    prepared = [_pinned_to_device(s, self.device) for s in samples]
                    event = torch.cuda.Event()
                    event.record(self._stream)
        return _Staged(prepared, counts, len(samples), event, time.perf_counter() - t0)


class _Staged(NamedTuple):
    """A PreparedUpdate in the queue, with the copy's event."""
    samples: List[dict]
    counts: List[Tuple[int, int, int]]
    n_batches: int
    event: Optional["torch.cuda.Event"]
    prefetch_wall: float
