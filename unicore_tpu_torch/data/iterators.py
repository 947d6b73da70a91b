"""Epoch batch iterators, in-process (counterpart of
``unicore_tpu/data/iterators.py``: ``EpochBatchIterator``,
``CountingIterator``, ``GroupedIterator`` and ``ShardedIterator``).

Epoch planning is the JAX package's: the frozen batch list is reshuffled
per epoch under ``numpy_seed(seed + epoch)`` and sharded round-robin, so
both packages visit the same batches in the same order.  Batches are
fetched and collated by ``--num-workers`` threads (:class:`_MapLoaderIterator`,
strictly in order; 0 = the calling thread) and, with ``--data-buffer-size``
> 0, read ahead by a producer thread into a bounded queue
(:class:`BufferedIterator`, whose ``--data-stall-timeout`` watchdog raises
:class:`DataStallError` when the producer delivers nothing for that long).
Mid-epoch resume: ``state_dict`` records the epoch and the batches the
CONSUMER took in it (the buffer sits inside the counting iterator, so
batches loaded ahead are not counted; a device prefetcher reports its own
consumed position through ``position_source``), and ``load_state_dict``
plans the same epoch and starts it past them.
"""

import contextlib
import itertools
import logging
import math
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import data_utils

logger = logging.getLogger(__name__)

# Depth of the consumer's skip() fast-forwards in progress.  While > 0 the
# BufferedIterator's --data-stall-timeout budget is relaxed (x10): in steady
# state the buffer hides a slow batch, but a tight skip loop drains it and
# exposes each batch's raw production time to the stall clock.  Relaxed,
# not suspended: a producer that wedges mid-skip still raises.  One
# consumer thread: a plain counter suffices.
_stall_relaxed = 0
_SKIP_STALL_BUDGET_MULTIPLIER = 10.0


@contextlib.contextmanager
def relaxed_stall_watchdog():
    """Relax the BufferedIterator stall budget (x10) for the enclosed
    fast-forward (re-entrant)."""
    global _stall_relaxed
    _stall_relaxed += 1
    try:
        yield
    finally:
        _stall_relaxed -= 1


class CountingIterator(object):
    """Pull-based wrapper that counts consumed items (``n``) against an
    expected ``total``."""

    def __init__(self, iterable, start=None, total=None):
        self.iterable = iterable
        self._itr = iter(iterable)
        self.n = getattr(iterable, "n", 0) if start is None else start
        self.total = self.n + len(iterable) if total is None else total

    def __len__(self):
        return self.total

    def __iter__(self):
        return self

    def __next__(self):
        x = next(self._itr)  # StopIteration ends the epoch
        if self.n >= self.total:
            raise RuntimeError(
                "Mismatch between actual and expected iterable length."
            )
        self.n += 1
        return x

    def has_next(self):
        return self.n < self.total

    def skip(self, num_to_skip):
        """Consume and discard ``num_to_skip`` items, with the data-stall
        budget relaxed (x10) meanwhile: a fast-forward (the health
        sentinel's post-rewind skip) waits on each batch's production with
        no buffer to hide it."""
        with relaxed_stall_watchdog():
            for _ in itertools.islice(self, num_to_skip):
                pass
        return self


class EpochBatchIterator(object):
    """Multi-epoch iterator over a dataset's batches, sharded over
    ``num_shards`` processes."""

    def __init__(self, dataset, collate_fn, batch_sampler, seed=1,
                 num_shards=1, shard_id=0, epoch=1, disable_shuffling=False,
                 num_workers=0, buffer_size=0, stall_timeout=0.0):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.frozen_batches = tuple(batch_sampler)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.num_workers = num_workers
        # capped: an oversized buffer only hoards host memory
        self.buffer_size = min(buffer_size, 20)
        self.stall_timeout = stall_timeout
        #: a device prefetcher reading ahead of the training thread reports
        #: the consumed position here (data/prefetch.py)
        self.position_source = None
        self.epoch = max(epoch, 1)  # epochs are 1-based
        self.disable_shuffling = disable_shuffling
        self.shuffle = not disable_shuffling
        self._cur_epoch_itr = None
        self._next_epoch_itr = None  # a resumed mid-epoch iterator

    def __len__(self):
        return int(math.ceil(len(self.frozen_batches) / float(self.num_shards)))

    @property
    def next_epoch_idx(self):
        """The epoch the next ``next_epoch_itr`` call will serve."""
        if self._next_epoch_itr is not None:
            return self.epoch  # a resumed mid-epoch iterator is pending
        if self._cur_epoch_itr is not None and self.end_of_epoch():
            return self.epoch + 1
        return self.epoch

    def next_epoch_itr(self, shuffle=True):
        if self.disable_shuffling:
            shuffle = False
        self.position_source = None  # a stale prefetcher of the last epoch
        self.epoch = self.next_epoch_idx
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        if self._next_epoch_itr is not None:
            # hand over the iterator load_state_dict prepared
            self._cur_epoch_itr, self._next_epoch_itr = self._next_epoch_itr, None
        else:
            self._cur_epoch_itr = self._get_iterator_for_epoch(self.epoch, shuffle)
        self.shuffle = shuffle
        return self._cur_epoch_itr

    def end_of_epoch(self) -> bool:
        if self.position_source is not None:
            return self.position_source.end_of_epoch()
        return not self._cur_epoch_itr.has_next()

    @property
    def iterations_in_epoch(self):
        if self.position_source is not None:
            return self.position_source.iterations_in_epoch
        for itr in (self._cur_epoch_itr, self._next_epoch_itr):
            if itr is not None:
                return itr.n
        return 0

    def state_dict(self):
        """Position snapshot; an exhausted epoch serializes as the start of
        the next one."""
        if self.end_of_epoch():
            return {"epoch": self.epoch + 1, "iterations_in_epoch": 0,
                    "shuffle": self.shuffle, "len": len(self)}
        return {"epoch": self.epoch,
                "iterations_in_epoch": self.iterations_in_epoch,
                "shuffle": self.shuffle, "len": len(self)}

    def load_state_dict(self, state_dict):
        """Position the iterator where :meth:`state_dict` left it: the next
        ``next_epoch_itr`` serves the saved epoch from its saved offset.
        When the epoch's length changed since (batch count, update-freq or
        shard count), the offset is rescaled to the same fraction."""
        self.epoch = state_dict["epoch"]
        offset = state_dict.get("iterations_in_epoch", 0)
        if offset == 0:
            self._next_epoch_itr = None
            return
        saved_len = state_dict.get("len")
        if saved_len is not None and saved_len != len(self):
            rescaled = int(offset * len(self) / saved_len)
            logger.info(f"iterator size changed ({saved_len} -> {len(self)} "
                        f"batches); rescaling itr_pos {offset} -> {rescaled}")
            offset = rescaled
        self._next_epoch_itr = self._get_iterator_for_epoch(
            self.epoch, shuffle=state_dict.get("shuffle", True), offset=offset)
        if self._next_epoch_itr is None:
            raise RuntimeError(
                "Cannot resume training due to dataloader mismatch. You can "
                "relaunch training with `--reset-dataloader` and it should "
                "work."
            )

    def _plan_shard(self, epoch, shuffle):
        """This process's padded batch list for ``epoch``, deterministic in
        (seed, epoch)."""
        batches = list(self.frozen_batches)
        if shuffle:
            with data_utils.numpy_seed(self.seed + epoch):
                np.random.shuffle(batches)
        return list(ShardedIterator(batches, self.num_shards, self.shard_id,
                                    fill_value=[]))

    def _get_iterator_for_epoch(self, epoch, shuffle, offset=0):
        shard = self._plan_shard(epoch, shuffle)
        if offset > 0 and offset >= len(shard):
            return None  # position beyond the epoch: the caller decides
        itr = _MapLoaderIterator(self.dataset, self.collate_fn, shard[offset:],
                                 num_workers=self.num_workers)
        if self.buffer_size > 0:
            itr = BufferedIterator(
                self.buffer_size, itr, stall_timeout=self.stall_timeout,
                context=(f"dataset {type(self.dataset).__name__}, epoch {epoch}, "
                         f"shard {self.shard_id}/{self.num_shards}"))
        return CountingIterator(itr, start=offset, total=len(shard))


class _MapLoaderIterator(object):
    """Fetch and collate: ``num_workers`` threads load upcoming batches
    concurrently (about two each in flight) and the batches are yielded
    strictly in order; 0 workers load on the calling thread."""

    def __init__(self, dataset, collate_fn, batch_sampler, num_workers=0):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers

    def __len__(self):
        return len(self.batch_sampler)

    def _load(self, batch):
        if len(batch) == 0:
            return {}
        return self.collate_fn([self.dataset[int(i)] for i in batch])

    def __iter__(self):
        if self.num_workers <= 0:
            for batch in self.batch_sampler:
                yield self._load(batch)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            source = iter(self.batch_sampler)
            pending = [pool.submit(self._load, b)
                       for b in itertools.islice(source, self.num_workers * 2)]
            try:
                while pending:
                    head = pending.pop(0)
                    nxt = next(source, None)
                    if nxt is not None:
                        pending.append(pool.submit(self._load, nxt))
                    yield head.result()
            finally:
                for f in pending:
                    f.cancel()


class DataStallError(RuntimeError):
    """The buffer's producer delivered nothing for ``--data-stall-timeout``
    seconds: the data pipeline is wedged, not merely slow."""


# queue sentinel: the producer finished cleanly
_DONE = object()


class BufferedIterator(object):
    """A producer thread loads up to ``size`` batches ahead into a bounded
    queue.  The consumer warns (after the run's first 5 minutes, at most
    every 15) when the buffer runs near empty -- the loader cannot keep up
    with the device -- and, with ``stall_timeout`` > 0, raises
    :class:`DataStallError` naming ``context`` and the position when the
    producer delivers nothing for that long.  A producer's exception is
    raised in the consumer."""

    _RUNTIME_BEFORE_WARN = 5 * 60
    _WARN_EVERY = 15 * 60

    def __init__(self, size, iterable, stall_timeout=0.0, context=None):
        self._queue = queue.Queue(size)
        self._iterable = iterable
        self._producer = None
        self._exhausted = False
        self._started = time.time()
        self._last_warn = None
        self._stall_timeout = float(stall_timeout or 0.0)
        self._context = context
        self._delivered = 0
        self.total = len(iterable)

    def _start_producer(self):
        def pump():
            try:
                for item in self._iterable:
                    self._queue.put(item)
                self._queue.put(_DONE)
            except Exception as e:  # noqa: BLE001 -- raised in the consumer
                self._queue.put(e)

        self._producer = threading.Thread(target=pump, name="buffered-iterator-producer",
                                          daemon=True)
        self._producer.start()

    def __len__(self):
        return self.total

    def __iter__(self):
        return self

    def _maybe_warn_starved(self):
        if self._queue.qsize() >= min(2, max(1, self._queue.maxsize // 2)):
            return
        now = time.time()
        if now - self._started <= self._RUNTIME_BEFORE_WARN:
            return
        if self._last_warn is not None and now - self._last_warn <= self._WARN_EVERY:
            return
        logger.debug("Data loading buffer is empty or nearly empty. This may indicate a "
                     "data loading bottleneck, and increasing the number of workers "
                     "(--num-workers) may help.")
        self._last_warn = now

    def _get_with_stall_watchdog(self, budget):
        deadline = time.time() + budget
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                where = f" of {self._context}" if self._context else ""
                alive = self._producer is not None and self._producer.is_alive()
                relaxed = (" (relaxed x10 budget: this happened DURING a skip "
                           "fast-forward)" if budget > self._stall_timeout else "")
                from unicore_tpu_torch import telemetry

                telemetry.emit(
                    "data-stall", budget=round(budget, 1),
                    position=self._delivered, total=self.total,
                    context=str(self._context) if self._context else None,
                    producer_alive=alive,
                )
                raise DataStallError(
                    f"data pipeline stalled: the prefetch producer delivered nothing for "
                    f"{budget:.0f}s (--data-stall-timeout){relaxed} at position "
                    f"{self._delivered}/{self.total}{where}; producer thread "
                    f"{'is still alive but wedged' if alive else 'has DIED'}.  Check the "
                    "dataset storage (mount, LMDB file, remote store) -- a merely-slow "
                    "pipeline logs the starvation warning instead of tripping this.")
            try:
                return self._queue.get(True, timeout=min(5.0, remaining))
            except queue.Empty:
                continue

    def __next__(self):
        # exhaustion is sticky: a grouped consumer pulls once more after the
        # last partial chunk, and the drained queue would block it forever
        if self._exhausted:
            raise StopIteration()
        if self._producer is None:
            self._start_producer()
        self._maybe_warn_starved()
        if self._stall_timeout > 0:
            budget = self._stall_timeout * (
                _SKIP_STALL_BUDGET_MULTIPLIER if _stall_relaxed else 1.0)
            item = self._get_with_stall_watchdog(budget)
        else:
            item = self._queue.get(True)
        if isinstance(item, Exception):
            raise item
        if item is _DONE:
            self._exhausted = True
            raise StopIteration()
        self._delivered += 1
        return item


class GroupedIterator(CountingIterator):
    """Chunks of ``chunk_size`` consecutive batches — the gradient-
    accumulation grouping."""

    def __init__(self, iterable, chunk_size):
        def chunks():
            src = iter(iterable)
            while True:
                block = list(itertools.islice(src, chunk_size))
                if not block:
                    return
                yield block

        super().__init__(
            chunks(),
            start=int(math.ceil(getattr(iterable, "n", 0) / float(chunk_size))),
            total=int(math.ceil(len(iterable) / float(chunk_size))),
        )
        self.chunk_size = chunk_size


class ShardedIterator(CountingIterator):
    """Round-robin shard of an iterable, padded with ``fill_value`` so every
    shard has the same length."""

    def __init__(self, iterable, num_shards, shard_id, fill_value=None):
        if not 0 <= shard_id < num_shards:
            raise ValueError("shard_id must be between 0 and num_shards")
        padded_len = int(math.ceil(len(iterable) / float(num_shards)))

        def sharded():
            count = 0
            for i, item in enumerate(iterable):
                if i % num_shards == shard_id:
                    count += 1
                    yield item
            while count < padded_len:
                count += 1
                yield fill_value

        super().__init__(sharded(), start=0, total=padded_len)
