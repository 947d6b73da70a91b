"""Length bucketing, collation, seeding and batching (counterpart of
``unicore_tpu/data/data_utils.py``: what the serving plane buckets
requests with and what the training data pipeline collates, seeds and
batches with).  Pure numpy."""

import contextlib
import threading
from typing import List

import numpy as np

# numpy's global RNG is process-wide state: every numpy_seed section
# serializes on this lock so concurrent sections cannot interleave
_np_seed_lock = threading.RLock()


def pad_to_multiple_size(size: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= size."""
    if multiple == 1 or size % multiple == 0:
        return size
    return (size // multiple + 1) * multiple


def compute_length_buckets(num_buckets, max_len, multiple=1, sizes=None):
    """A small fixed set of padded sequence lengths covering ``max_len``.

    With per-sample ``sizes`` available, edges sit at quantiles of the
    length distribution; without them, edges are evenly spaced.  Every
    edge is rounded up to ``multiple`` and the last edge always covers
    ``max_len``; duplicates collapse, so the result may hold fewer than
    ``num_buckets`` entries.  Returns None when bucketing is off
    (``num_buckets <= 0``)."""
    num_buckets = int(num_buckets or 0)
    if num_buckets <= 0:
        return None
    top = pad_to_multiple_size(int(max_len), multiple)
    if num_buckets == 1:
        return (top,)
    if sizes is not None and len(sizes):
        qs = np.quantile(
            np.asarray(sizes, dtype=np.float64),
            np.linspace(1.0 / num_buckets, 1.0, num_buckets),
        )
        edges = [pad_to_multiple_size(int(np.ceil(q)), multiple) for q in qs]
    else:
        step = max_len / float(num_buckets)
        edges = [
            pad_to_multiple_size(int(np.ceil(step * (i + 1))), multiple)
            for i in range(num_buckets)
        ]
    edges = [min(max(e, multiple), top) for e in edges]
    edges[-1] = top
    return tuple(sorted(set(edges)))


def bucket_for(size: int, buckets) -> int:
    """Smallest bucket edge >= ``size``, or None when ``size`` overflows
    every bucket."""
    if buckets:
        for edge in buckets:
            if size <= edge:
                return edge
    return None


def collate_tokens(
    values: List[np.ndarray],
    pad_idx,
    left_pad=False,
    pad_to_length=None,
    pad_to_multiple=1,
    pad_to_buckets=None,
):
    """Convert a list of 1d arrays into a padded 2d array; the width rounds
    up to ``pad_to_multiple`` and then snaps up to the smallest covering
    edge of ``pad_to_buckets`` (a sorted tuple), if any."""
    values = [np.asarray(v) for v in values]
    size = max(v.shape[0] for v in values)
    size = size if pad_to_length is None else max(size, pad_to_length)
    size = pad_to_multiple_size(size, pad_to_multiple)
    if pad_to_buckets:
        size = bucket_for(size, pad_to_buckets) or size
    res = np.full((len(values), size), pad_idx, dtype=values[0].dtype)
    for i, v in enumerate(values):
        if left_pad:
            res[i, size - len(v):] = v
        else:
            res[i, : len(v)] = v
    return res


def default_collate(samples):
    """Stack/convert a list of samples (numpy arrays, dicts, lists, scalars)."""
    first = samples[0]
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate(list(col)) for col in zip(*samples))
    return np.asarray(samples)


@contextlib.contextmanager
def numpy_seed(seed, *addl_seeds):
    """Seed numpy's global PRNG for the block and restore its state after.
    Extra seeds mix in as ``hash((seed, *addl_seeds)) % 1e6``, exactly as
    the JAX package does, so both draw the same numbers."""
    if seed is None:
        yield
        return
    if len(addl_seeds) > 0:
        seed = int(hash((seed, *addl_seeds)) % 1e6)
    with _np_seed_lock:
        state = np.random.get_state()
        np.random.seed(seed)
        try:
            yield
        finally:
            np.random.set_state(state)


def batch_by_size(indices, batch_size=None, required_batch_size_multiple=1):
    """Chunk ordered indices into batches of ``batch_size`` (rounded up to
    ``required_batch_size_multiple``); only the last may be shorter."""
    batch_size = batch_size if batch_size is not None else 1
    bsz_mult = required_batch_size_multiple
    step = ((batch_size + bsz_mult - 1) // bsz_mult) * bsz_mult
    if not isinstance(indices, np.ndarray):
        indices = np.fromiter(indices, dtype=np.int64, count=-1)
    num_batches = (len(indices) + step - 1) // step
    return np.split(indices, np.arange(1, num_batches) * step)
