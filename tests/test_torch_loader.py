"""The port's loader plane on the CPU: loader threads, the buffered
read-ahead and its stall watchdog, mid-epoch resume, the device
prefetcher (on the CPU device) and the small dataset views.

- ``--num-workers`` 0, 1 and 4 (behind a 3-batch buffer) give the BERT
  task's batches over two epochs identical to the JAX package's iterator
  (masking runs under the seeded numpy sections, which serialize), and 16
  threads under a 1-microsecond switch interval the single-thread batches;
- ``BufferedIterator`` delivers every item in order and raises a
  producer's exception in the consumer;
- a dataset that blocks trips ``DataStallError`` at
  ``--data-stall-timeout 0.2`` (within 10 s, not the 5-s poll);
- a mid-epoch resume with 4 workers and a buffer of 5 batches (loaded
  ahead of the consumer) continues bit for bit where one without them
  does: the position counts what the consumer took;
- ``DevicePrefetcher`` on the CPU device hands over the epoch's first
  update raw, then the same batches as tensors with their host counts,
  reports the consumed position, and stops its thread;
- the ``misc_datasets`` views against the JAX package's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from unicore_tpu.data import iterators as jax_iterators
from unicore_tpu.data import misc_datasets as jax_misc
from unicore_tpu.tasks.bert import BertTask as JaxBertTask

from unicore_tpu_torch.data import Dictionary, iterators, misc_datasets
from unicore_tpu_torch.data.prefetch import DevicePrefetcher, PreparedUpdate
from unicore_tpu_torch.tasks.bert import BertTask as PortBertTask

from test_torch_train_data import task_args, write_corpus


def _epochs(task, epochs, **loader):
    task.load_dataset("train")
    out = []
    for epoch in range(1, epochs + 1):
        itr = task.get_batch_iterator(task.dataset("train"), batch_size=3, seed=task.args.seed,
                                      epoch=epoch, **loader)
        out.extend(itr.next_epoch_itr(shuffle=True))
    return out


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("workers", [0, 1, 4])
def test_workers_give_the_jax_batches(tmp_path, workers):
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=20)
    ref = _epochs(JaxBertTask.setup_task(task_args(data)), 2)
    got = _epochs(PortBertTask.setup_task(task_args(data)), 2, num_workers=workers,
                  data_buffer_size=3)
    assert len(got) == len(ref) == 14
    for a, b in zip(got, ref):
        _assert_same(a, b)


def test_many_workers_under_fast_thread_switching(tmp_path):
    """More loader threads than cores, with the interpreter switching
    threads every microsecond: the masked batches (each drawn under the
    seeded, lock-serialized numpy section) equal the single-thread ones."""
    import sys

    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=20)
    ref = _epochs(PortBertTask.setup_task(task_args(data)), 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        got = _epochs(PortBertTask.setup_task(task_args(data)), 1, num_workers=16,
                      data_buffer_size=4)
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert len(got) == len(ref) == 7
    for a, b in zip(got, ref):
        _assert_same(a, b)


def test_buffered_iterator_delivers_all_and_passes_errors():
    itr = iterators.BufferedIterator(4, list(range(50)))
    assert list(itr) == list(range(50))

    class Failing:
        def __len__(self):
            return 10

        def __iter__(self):
            yield from range(3)
            raise ValueError("disk on fire")

    itr = iterators.BufferedIterator(2, Failing())
    assert [next(itr) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="disk on fire"):
        next(itr)


def test_data_stall_error():
    release = threading.Event()

    class Blocking:
        def __len__(self):
            return 2

        def __iter__(self):
            yield 0
            release.wait(timeout=30)
            yield 1

    itr = iterators.BufferedIterator(2, Blocking(), stall_timeout=0.2, context="test data")
    try:
        assert next(itr) == 0
        t0 = time.monotonic()
        with pytest.raises(iterators.DataStallError, match="test data"):
            next(itr)
        assert time.monotonic() - t0 < 10
    finally:
        release.set()


class _Slow(misc_datasets.RawArrayDataset):
    """Samples whose loading takes a varying time, so worker threads finish
    out of order."""

    def __getitem__(self, index):
        time.sleep(0.002 * (index % 3))
        return self.dataset[index]


def _epoch_itr(workers, buffer):
    data = [np.full(4, i, dtype=np.int64) for i in range(40)]
    return iterators.EpochBatchIterator(
        _Slow(data), _Slow(data).collater, [[i, i + 1] for i in range(0, 40, 2)], seed=5,
        num_workers=workers, buffer_size=buffer)


def test_mid_epoch_resume_with_workers_and_buffer():
    full = [b for b in _epoch_itr(0, 0).next_epoch_itr(shuffle=True)]
    loaded = _epoch_itr(4, 5)
    grouped = iterators.GroupedIterator(loaded.next_epoch_itr(shuffle=True), 2)
    first = [b for _, group in zip(range(3), grouped) for b in group]
    time.sleep(0.2)  # let the buffer fill past the consumer
    state = loaded.state_dict()
    assert state["iterations_in_epoch"] == 6
    resumed = _epoch_itr(0, 0)
    resumed.load_state_dict(state)
    rest = list(resumed.next_epoch_itr(shuffle=True))
    assert len(first) + len(rest) == len(full) == 20
    for a, b in zip(first + rest, full):
        assert torch.equal(a, b)


class _CountingTrainer:
    """What the prefetcher asks of the trainer: its device and host counts."""
    device = torch.device("cpu")

    def host_counts(self, sample):
        src = np.asarray(sample)
        return int((src != 0).sum()), int(src.shape[0]), int(src.shape[-1])


def test_device_prefetcher_on_cpu():
    epoch_itr = _epoch_itr(2, 3)
    ref = list(iterators.GroupedIterator(_epoch_itr(0, 0).next_epoch_itr(shuffle=True), 2))
    grouped = iterators.GroupedIterator(epoch_itr.next_epoch_itr(shuffle=True), 2)
    pf = DevicePrefetcher(_CountingTrainer(), grouped, depth=2)
    pf.attach_epoch_itr(epoch_itr)
    pf.start()
    try:
        items = []
        for i, item in enumerate(pf):
            items.append(item)
            assert epoch_itr.iterations_in_epoch == 2 * (i + 1)
            if i == 4:
                assert epoch_itr.state_dict()["iterations_in_epoch"] == 10
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert epoch_itr.position_source is None
    assert len(items) == len(ref) == 10
    assert isinstance(items[0], list) and not isinstance(items[0], PreparedUpdate)
    assert all(isinstance(it, PreparedUpdate) for it in items[1:])
    assert pf.prefetched_updates == 9 and pf.synchronous_updates == 1
    for item, group in zip(items, ref):
        batches = item if isinstance(item, list) else item.samples
        for a, b in zip(batches, group):
            assert torch.equal(torch.as_tensor(a), b)
        if isinstance(item, PreparedUpdate):
            assert item.counts == [_CountingTrainer().host_counts(b) for b in group]


def test_misc_datasets_match_jax():
    r = np.random.RandomState(0)
    seqs = [r.randint(5, 30, size=n).astype(np.int64) for n in (3, 7, 5)]
    labels = [0.5, 1.5, 2.5]
    pairs = [
        (misc_datasets.NumelDataset(seqs), jax_misc.NumelDataset(seqs)),
        (misc_datasets.NumelDataset(seqs, reduce=True),
         jax_misc.NumelDataset(seqs, reduce=True)),
        (misc_datasets.RawLabelDataset(labels), jax_misc.RawLabelDataset(labels)),
        (misc_datasets.RawNumpyDataset(seqs), jax_misc.RawNumpyDataset(seqs)),
        (misc_datasets.AppendTokenDataset(seqs, 2), jax_misc.AppendTokenDataset(seqs, 2)),
        (misc_datasets.PrependTokenDataset(seqs, 1), jax_misc.PrependTokenDataset(seqs, 1)),
        (misc_datasets.FromNumpyDataset(seqs), jax_misc.FromNumpyDataset(seqs)),
    ]
    for port, ref in pairs:
        assert len(port) == len(ref) == 3
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(port[i]), np.asarray(ref[i]))
        if isinstance(port, (misc_datasets.NumelDataset, misc_datasets.RawLabelDataset)):
            np.testing.assert_array_equal(np.asarray(port.collater([port[i] for i in range(3)])),
                                          np.asarray(ref.collater([ref[i] for i in range(3)])))
    assert isinstance(misc_datasets.FromNumpyDataset(seqs)[0], torch.Tensor)
    count = misc_datasets.NumSamplesDataset()
    assert count.collater([count[i] for i in range(4)]) == jax_misc.NumSamplesDataset().collater(
        [1] * 4) == 4
    same = [np.ones((2, 3), np.float32) * i for i in range(4)]
    got = misc_datasets.default_collate([{"x": s, "y": (s, i)} for i, s in enumerate(same)])
    ref = jax_misc.default_collate([{"x": s, "y": (s, i)} for i, s in enumerate(same)])
    assert isinstance(got["x"], torch.Tensor) and got["x"].shape == (4, 2, 3)
    _assert_same(got["x"], ref["x"])
    _assert_same(got["y"][0], ref["y"][0])
    _assert_same(got["y"][1], ref["y"][1])
    symbols = ["[PAD]", "C", "N", "O"]
    d = Dictionary()
    for s in symbols:
        d.add_symbol(s)
    from unicore_tpu.data import Dictionary as JaxDictionary

    jd = JaxDictionary()
    for s in symbols:
        jd.add_symbol(s)
    raw = [np.array(["C", "O", "N"]), np.array(["N", "N"])]
    tok, jtok = misc_datasets.TokenizeDataset(raw, d, 8), jax_misc.TokenizeDataset(raw, jd, 8)
    for i in range(2):
        np.testing.assert_array_equal(tok[i], jtok[i])
    assert jax_iterators.BufferedIterator is not iterators.BufferedIterator
