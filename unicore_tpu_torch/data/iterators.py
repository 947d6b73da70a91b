"""Epoch batch iterators, in-process (counterpart of
``unicore_tpu/data/iterators.py``: ``EpochBatchIterator``,
``CountingIterator``, ``GroupedIterator`` and ``ShardedIterator``).

Epoch planning is the JAX package's: the frozen batch list is reshuffled
per epoch under ``numpy_seed(seed + epoch)`` and sharded round-robin, so
both packages visit the same batches in the same order.  Batches are
fetched and collated on the calling thread; the JAX package's loader
threads, prefetch buffer and stall watchdog are not ported.  Mid-epoch
resume is: ``state_dict`` records the epoch and the batches consumed in it,
``load_state_dict`` plans the same epoch and starts it past them.
"""

import logging

import itertools
import math

import numpy as np

from . import data_utils

logger = logging.getLogger(__name__)


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
        """Consume and discard ``num_to_skip`` items."""
        for _ in itertools.islice(self, num_to_skip):
            pass
        return self


class EpochBatchIterator(object):
    """Multi-epoch iterator over a dataset's batches, sharded over
    ``num_shards`` processes."""

    def __init__(self, dataset, collate_fn, batch_sampler, seed=1,
                 num_shards=1, shard_id=0, epoch=1, disable_shuffling=False):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.frozen_batches = tuple(batch_sampler)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
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
        return not self._cur_epoch_itr.has_next()

    @property
    def iterations_in_epoch(self):
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

        def load():
            for batch in shard[offset:]:
                if len(batch) == 0:
                    yield {}
                else:
                    yield self.collate_fn([self.dataset[int(i)] for i in batch])

        return CountingIterator(load(), start=offset, total=len(shard))


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
