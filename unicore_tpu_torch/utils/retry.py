"""Retries and deadline-bounded local waits (counterpart of
``unicore_tpu/utils/retry.py``): :class:`RetryPolicy` / :func:`retry_call`
(bounded attempts with exponential backoff, for the checkpoint writes), and
:func:`bounded_wait` / :class:`WaitTimeoutError` (the serving plane's
waits).  The KV-store helpers wait for the distributed slice."""

import dataclasses
import time
from typing import Any, Callable, Optional


class WaitTimeoutError(TimeoutError):
    """A deadline-bounded local wait (queue, event, socket drain) expired.
    Raised by :func:`bounded_wait`: a slow client or a wedged consumer
    surfaces as a diagnosable timeout, never an unbounded block."""


@dataclasses.dataclass
class RetryPolicy:
    """Bounded attempts with exponential backoff."""

    #: total tries (the first call counts as attempt 0)
    attempts: int = 3
    #: delay in seconds before the first retry
    backoff: float = 0.5
    #: per-retry growth factor
    multiplier: float = 2.0


def retry_call(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    *,
    giveup: Optional[Callable[[BaseException], bool]] = None,
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
):
    """Run ``fn`` under ``policy``; returns its result or re-raises its
    LAST error once the attempts are spent.  ``giveup(err)`` stops retrying
    errors that cannot clear (a full disk); ``on_retry(err, attempt,
    delay)`` runs before each sleep (``time.sleep``, looked up at call time
    so a test can patch it)."""
    attempts = max(1, int(policy.attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as err:
            if attempt == attempts - 1 or (giveup is not None and giveup(err)):
                raise
            delay = policy.backoff * policy.multiplier ** attempt
            if on_retry is not None:
                on_retry(err, attempt, delay)
            time.sleep(delay)


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
