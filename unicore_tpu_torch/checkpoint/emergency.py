"""Deadlines (counterpart of ``unicore_tpu/checkpoint/emergency.py``; this
slice ports the countdown the serving plane uses for per-request and drain
deadlines).  The emergency-save path waits for the trainer slice."""

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
    """The deadline currently in scope, else None."""
    return _active


@contextlib.contextmanager
def deadline_scope(deadline: Deadline):
    global _active
    prev, _active = _active, deadline
    try:
        yield deadline
    finally:
        _active = prev
