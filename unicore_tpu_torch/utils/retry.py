"""Deadline-bounded local waits (counterpart of ``unicore_tpu/utils/retry.py``;
this slice ports :func:`bounded_wait` and :class:`WaitTimeoutError`, the
serving plane's waits).  The KV-store helpers wait for the distributed
slice."""

import time
from typing import Callable


class WaitTimeoutError(TimeoutError):
    """A deadline-bounded local wait (queue, event, socket drain) expired.
    Raised by :func:`bounded_wait`: a slow client or a wedged consumer
    surfaces as a diagnosable timeout, never an unbounded block."""


def bounded_wait(
    predicate: Callable[[], bool],
    timeout: float,
    *,
    poll_s: float = 0.05,
    describe: str = "",
) -> None:
    """Poll ``predicate`` in ``poll_s`` slices until it returns True,
    raising :class:`WaitTimeoutError` once ``timeout`` seconds have passed.

    The one shape for every blocking wait inside the serving plane: a
    request handler waiting on its response, the drain loop waiting for
    in-flight batches."""
    deadline = time.monotonic() + max(0.0, float(timeout))
    while True:
        if predicate():
            return
        left = deadline - time.monotonic()
        if left <= 0:
            raise WaitTimeoutError(
                f"condition not met after {timeout:.3f}s"
                + (f" ({describe})" if describe else "")
            )
        time.sleep(min(poll_s, left))
