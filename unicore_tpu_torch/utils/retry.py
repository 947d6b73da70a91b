"""Retries and deadline-bounded local waits (counterpart of
``unicore_tpu/utils/retry.py``): :class:`RetryPolicy` / :func:`retry_call`
(bounded attempts with exponential backoff, jitter and an overall deadline:
the checkpoint writes and the fleet router's re-routes),
:func:`bounded_wait` / :class:`WaitTimeoutError` (the serving plane's
waits), and :func:`kv_fetch`, the classified KV probe (value /
:data:`ABSENT` / :data:`UNREACHABLE`) the serving fleet's membership keys
on.  The blocking ``kv_wait`` and the coordination-service client wait for
the rest of the parallelism queue."""

import dataclasses
import random
import time
from typing import Any, Callable, Optional


class KVTimeoutError(TimeoutError):
    """A deadline-bounded KV wait expired (the peer never published, or
    the coordination service stayed unreachable past the budget)."""


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
    #: fraction of each delay randomized UP (0.25 -> delay * [1, 1.25)):
    #: spreads a fleet of callers retrying the same shared resource
    jitter: float = 0.0
    #: overall wall budget in seconds (None = bounded by attempts alone)
    deadline: Optional[float] = None


def retry_call(
    fn: Callable[[], Any],
    policy: RetryPolicy,
    *,
    giveup: Optional[Callable[[BaseException], bool]] = None,
    on_retry: Optional[Callable[[BaseException, int, float], None]] = None,
):
    """Run ``fn`` under ``policy``; returns its result or re-raises its
    LAST error once the attempts (or the deadline) are spent.
    ``giveup(err)`` stops retrying errors that cannot clear (a full disk);
    ``on_retry(err, attempt, delay)`` runs before each sleep (``time.sleep``,
    looked up at call time so a test can patch it); a retry whose delay
    would end past the policy's deadline is not made."""
    deadline = None if policy.deadline is None else time.monotonic() + policy.deadline
    attempts = max(1, int(policy.attempts))
    for attempt in range(attempts):
        try:
            return fn()
        except Exception as err:
            if attempt == attempts - 1 or (giveup is not None and giveup(err)):
                raise
            delay = policy.backoff * policy.multiplier ** attempt
            if policy.jitter > 0:
                delay *= 1.0 + policy.jitter * random.random()
            if deadline is not None and time.monotonic() + delay > deadline:
                raise
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


# ---------------------------------------------------------------------------
# KV helpers
# ---------------------------------------------------------------------------

#: the key holds no value yet (or the service answered "not found")
ABSENT = object()
#: the service did not answer (connection failure)
UNREACHABLE = object()


def _looks_like_kv_timeout(err: BaseException) -> bool:
    msg = str(err).lower()
    return "deadline" in msg or "timed out" in msg or "timeout" in msg


def kv_fetch(client, key: str, *, poll_ms: int = 100):
    """One bounded KV probe, classified instead of raised.

    Returns the string value, :data:`ABSENT` when the key holds nothing yet
    (the client reports this as its own deadline expiring), or
    :data:`UNREACHABLE` when the service did not answer at all.  Membership
    keys on the distinction: silence from a PEER is evidence, silence from
    the SERVICE is not.  The JAX package's helper also honours the
    ``kv-outage`` chaos kind here; that kind waits for the rest of the
    parallelism queue (ROADMAP queue A item 4), so this probe has no chaos
    hook yet."""
    try:
        return client.blocking_key_value_get(key, max(1, int(poll_ms)))
    except Exception as err:
        if _looks_like_kv_timeout(err):
            return ABSENT
        return UNREACHABLE
