"""Metric meters (counterpart of ``unicore_tpu/logging/meters.py``): the
running average, events per second and stopwatch meters behind a
priority-ordered ``MetersDict``, with derived meters computed at read time.

Values may be 0-d tensors: they accumulate as they are and reach the host
only when a value is read or serialized (``to_py``).  The ``state_dict``
layout is the JAX package's, ``[(priority, key, meter class name, meter
state)]``, so each package loads the other's meters (and a checkpoint of
either resumes them).
"""

import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

_METER_CLASSES: Dict[str, type] = {}


def _register(cls):
    _METER_CLASSES[cls.__name__] = cls
    return cls


def safe_round(number, ndigits):
    """Round plain numbers and 0-d arrays; pass everything else through."""
    if hasattr(number, "item") and not isinstance(number, (int, float)):
        try:
            number = number.item()
        except Exception:
            return number
    try:
        return round(number, ndigits)
    except TypeError:
        return number


def to_py(value):
    """Host-side scalar for serialization (0-d tensors and arrays -> python)."""
    if hasattr(value, "item") and getattr(value, "ndim", 0) == 0:
        try:
            return value.item()
        except Exception:
            pass
    return value


class Meter:
    """Common meter protocol: reset / update-ish mutation / smoothed_value
    for display / state_dict round-trip."""

    def state_dict(self):
        return {}

    def load_state_dict(self, state_dict):
        pass

    def reset(self):
        raise NotImplementedError

    @property
    def smoothed_value(self) -> float:
        raise NotImplementedError

    def _display(self, raw, round_to):
        if round_to is not None and raw is not None:
            return safe_round(raw, round_to)
        return raw


@_register
class AverageMeter(Meter):
    """Weighted running mean; ``smoothed_value`` is sum/count (or the last
    value before any weighted update arrives)."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.val = None
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        if val is None:
            return
        self.val = val
        if n > 0:
            self.sum = self.sum + val * n
            self.count = self.count + n

    @property
    def avg(self):
        if self.count > 0:
            return self.sum / self.count
        return self.val

    @property
    def smoothed_value(self) -> float:
        return self._display(to_py(self.avg), self.round)

    def state_dict(self):
        return {
            "val": to_py(self.val),
            "sum": to_py(self.sum),
            "count": to_py(self.count),
            "round": self.round,
        }

    def load_state_dict(self, state_dict):
        self.val = state_dict["val"]
        self.sum = state_dict["sum"]
        self.count = state_dict["count"]
        self.round = state_dict.get("round")


@_register
class TimeMeter(Meter):
    """Events per second of wall time, resumable across restarts: elapsed
    time carried so far is folded into ``init`` at serialize time."""

    def __init__(self, init: int = 0, n: int = 0, round: Optional[int] = None):
        self.round = round
        self.reset(init, n)

    def reset(self, init=0, n=0):
        self.init = init
        self.n = n
        self.i = 0
        self._anchor = time.perf_counter()

    def update(self, val=1):
        self.n = self.n + val
        self.i += 1

    @property
    def elapsed_time(self):
        return self.init + (time.perf_counter() - self._anchor)

    @property
    def avg(self):
        return self.n / self.elapsed_time

    @property
    def smoothed_value(self) -> float:
        return self._display(self.avg, self.round)

    def state_dict(self):
        return {"init": self.elapsed_time, "n": self.n, "round": self.round}

    def load_state_dict(self, state_dict):
        if "start" in state_dict:
            # ancient serialized form carried a raw start timestamp; only
            # the accumulated offset is portable across processes
            self.reset(init=state_dict["init"])
        else:
            self.reset(init=state_dict["init"], n=state_dict["n"])
            self.round = state_dict.get("round")


@_register
class StopwatchMeter(Meter):
    """Accumulates durations between start()/stop() pairs; ``smoothed_value``
    is seconds-per-n once any interval completed, else the live elapsed
    time."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.sum = 0
        self.n = 0
        self.start_time = None

    def start(self):
        self.start_time = time.perf_counter()

    def stop(self, n=1, prehook=None):
        if self.start_time is None:
            return
        if prehook is not None:
            prehook()
        self.sum = self.sum + (time.perf_counter() - self.start_time)
        self.n = self.n + n

    def reset(self):
        self.sum = 0
        self.n = 0
        self.start()

    @property
    def avg(self):
        return self.sum / self.n if self.n > 0 else self.sum

    @property
    def elapsed_time(self):
        if self.start_time is None:
            return 0.0
        return time.perf_counter() - self.start_time

    @property
    def smoothed_value(self) -> float:
        raw = self.avg if self.sum > 0 else self.elapsed_time
        return self._display(raw, self.round)

    def state_dict(self):
        return {"sum": self.sum, "n": self.n, "round": self.round}

    def load_state_dict(self, state_dict):
        self.sum = state_dict["sum"]
        self.n = state_dict["n"]
        self.round = state_dict.get("round")
        self.start_time = None


class MetersDict(OrderedDict):
    """Meters keyed by name, iterated in (priority, insertion) order.

    Keys are write-once.  Ordering is kept by re-sorting a small key list on
    insert — meter counts are tiny (tens), so O(k log k) per insert is noise
    next to maintaining a parallel sorted structure.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rank: List[Tuple[int, int, str]] = []

    def __setitem__(self, key, priority_and_meter):
        if key in self:
            raise AssertionError(
                f"meter {key!r} already registered (keys are write-once)"
            )
        priority, meter = priority_and_meter
        self._rank.append((priority, len(self._rank), key))
        self._rank.sort()
        super().__setitem__(key, meter)
        for _, _, k in self._rank:
            self.move_to_end(k)

    def add_meter(self, key, meter, priority):
        self[key] = (priority, meter)

    def get_smoothed_value(self, key: str) -> float:
        meter = self[key]
        if isinstance(meter, MetersDict._DerivedMeter):
            return meter.fn(self)
        return meter.smoothed_value

    def get_smoothed_values(self) -> Dict[str, float]:
        return OrderedDict(
            (key, self.get_smoothed_value(key))
            for key in self
            if not key.startswith("_")
        )

    def reset(self):
        for meter in self.values():
            if not isinstance(meter, MetersDict._DerivedMeter):
                meter.reset()

    def state_dict(self):
        # derived meters hold closures — they are re-registered by the code
        # that defined them, not serialized
        return [
            (priority, key, type(self[key]).__name__, self[key].state_dict())
            for priority, _, key in self._rank
            if not isinstance(self[key], MetersDict._DerivedMeter)
        ]

    def load_state_dict(self, state_dict):
        self.clear()
        self._rank.clear()
        for priority, key, cls_name, meter_state in state_dict:
            meter = _METER_CLASSES[cls_name]()
            meter.load_state_dict(meter_state)
            self.add_meter(key, meter, priority)

    class _DerivedMeter(Meter):
        """Computed from the other meters at read time (e.g. wall clock)."""

        def __init__(self, fn: Callable[["MetersDict"], float]):
            self.fn = fn

        def reset(self):
            pass
