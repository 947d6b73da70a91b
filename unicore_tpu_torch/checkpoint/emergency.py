"""Deadline-bounded emergency saves (counterpart of
``unicore_tpu/checkpoint/emergency.py``).

A preemption notice (SIGTERM) comes with a grace budget of seconds; a full
save (stage in ``--tmp-save-dir``, publish every name, prune, verify) can
blow it and leave no checkpoint at all.  ``--preemption-save-deadline
SECS`` arms the minimal path (``checkpoint_utils._emergency_save_checkpoint``):
one fsync'd ``checkpoint_last`` straight into ``--save-dir``.  The
:class:`Deadline` is published through a process-global scope that
``persistent_save`` reads to drop its retries and read-back verification:
retries eat a budget that exists once.  The deadline is advisory at the
write layer: a started write runs to its end (aborting it would leave no
checkpoint), and an over-budget finish logs a warning.  The serving plane
uses the same countdown for per-request and drain deadlines."""

import contextlib
import math
import time
from typing import Optional


class Deadline:
    """Monotonic countdown from construction.  ``budget=None`` never
    expires."""

    def __init__(self, budget: Optional[float] = None):
        # `is not None`, not truthiness: an explicit budget of 0 means
        # "already expired", not "never expires"
        self.budget = float(budget) if budget is not None else None
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> float:
        if self.budget is None:
            return math.inf
        return self.budget - self.elapsed()

    def exceeded(self) -> bool:
        return self.remaining() <= 0


_active: Optional[Deadline] = None


def active_deadline() -> Optional[Deadline]:
    """The emergency deadline currently in scope, else None: a write inside
    one makes one attempt, with no backoff and no read-back verification."""
    return _active


@contextlib.contextmanager
def deadline_scope(deadline: Deadline):
    global _active
    prev, _active = _active, deadline
    try:
        yield deadline
    finally:
        _active = prev
