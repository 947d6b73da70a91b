"""Length bucketing (counterpart of ``unicore_tpu/data/data_utils.py``;
this slice ports what the serving plane buckets requests with).  Pure
numpy."""

import numpy as np


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
