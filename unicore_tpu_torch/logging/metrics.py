"""Metrics aggregation with nested named contexts (counterpart of
``unicore_tpu/logging/metrics.py``): ``aggregate(name)`` (nestable;
``new_root`` isolates, as validation inside the train loop does), the
``log_*`` family (scalars, derived values, rates, stopwatches, custom
meters), per-aggregator reads, and a ``state_dict`` a checkpoint carries so
a resumed run's meters continue.

One module-level ``_State`` owns the aggregator tables.  The ``default``
aggregator is always active and sees every logged value (the trainer's
``wall`` stopwatch lives there); named aggregators are reference-counted,
so re-entering one nests cleanly.
"""

import contextlib
import uuid
from collections import defaultdict
from typing import Callable, List, Optional

from .meters import (
    AverageMeter,
    Meter,
    MetersDict,
    StopwatchMeter,
    TimeMeter,
)


class _State:
    """Aggregator tables: everything ever named, plus the currently-active
    set (with a refcount so re-entrant ``aggregate`` nests cleanly)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.by_name = {}
        self.active = {}
        self.active_refs = defaultdict(int)
        # the default aggregator observes every logged value
        default = MetersDict()
        self.by_name["default"] = default
        self.active["default"] = default
        self.active_refs["default"] = 1

    def enter(self, name, agg):
        self.active[name] = agg
        self.active_refs[name] += 1

    def leave(self, name):
        self.active_refs[name] -= 1
        if self.active_refs[name] == 0:
            self.active.pop(name, None)

    def snapshot(self):
        return dict(self.active), dict(self.active_refs)

    def restore(self, snap):
        active, refs = snap
        self.active = dict(active)
        self.active_refs = defaultdict(int, refs)


_state = _State()


def reset() -> None:
    """Drop every aggregator and start fresh."""
    _state.clear()


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Route logged values into the named aggregator for the duration of
    the block (in addition to any other active aggregators — unless
    ``new_root``, which suspends them)."""
    if name is None:
        name = str(uuid.uuid4())  # anonymous, garbage-collected with scope
        assert name not in _state.by_name
        agg = MetersDict()
    else:
        assert name != "default"
        agg = _state.by_name.setdefault(name, MetersDict())

    snap = _state.snapshot() if new_root else None
    if new_root:
        _state.active = {}
        _state.active_refs = defaultdict(int)
    _state.enter(name, agg)
    try:
        yield agg
    finally:
        _state.leave(name)
        if snap is not None:
            _state.restore(snap)


def get_active_aggregators() -> List[MetersDict]:
    return list(_state.active.values())


def _meter(key, priority, factory):
    """Yield (aggregator, meter) for every active aggregator, creating the
    meter on first sight."""
    for agg in get_active_aggregators():
        if key not in agg:
            agg.add_meter(key, factory(), priority)
        yield agg, agg[key]


def log_scalar(key: str, value: float, weight: float = 1, priority: int = 10,
               round: Optional[int] = None):
    """Weighted scalar.  A 0-d tensor accumulates as it is and reaches the
    host only at display/serialize time."""
    for _, meter in _meter(key, priority, lambda: AverageMeter(round=round)):
        meter.update(value, weight)


def log_derived(key: str, fn: Callable[[MetersDict], float], priority: int = 20):
    """A value computed from the other meters at read time."""
    for agg in get_active_aggregators():
        if key not in agg:
            agg.add_meter(key, MetersDict._DerivedMeter(fn), priority)


def log_speed(key: str, value: float, priority: int = 30,
              round: Optional[int] = None):
    """Rate of a quantity per second of wall time."""
    for agg in get_active_aggregators():
        if key not in agg:
            agg.add_meter(key, TimeMeter(round=round), priority)
            agg[key].reset()  # first sighting: anchor the clock, drop value
        else:
            agg[key].update(value)


def log_start_time(key: str, priority: int = 40, round: Optional[int] = None):
    """Open a stopwatch interval."""
    for _, meter in _meter(key, priority, lambda: StopwatchMeter(round=round)):
        meter.start()


def log_stop_time(key: str, weight: float = 0.0, prehook=None):
    """Close a stopwatch interval."""
    for agg in get_active_aggregators():
        if key in agg:
            agg[key].stop(weight, prehook)


def log_custom(new_meter_fn: Callable[[], Meter], key: str, *args,
               priority: int = 50, **kwargs):
    """Log through a caller-supplied meter type."""
    for _, meter in _meter(key, priority, new_meter_fn):
        meter.update(*args, **kwargs)


def reset_meter(name: str, key: str) -> None:
    meter = get_meter(name, key)
    if meter is not None:
        meter.reset()


def reset_meters(name: str) -> None:
    meters = get_meters(name)
    if meters is not None:
        meters.reset()


def get_meter(name: str, key: str) -> Meter:
    agg = _state.by_name.get(name)
    return agg.get(key, None) if agg is not None else None


def get_meters(name: str) -> MetersDict:
    return _state.by_name.get(name, None)


def get_smoothed_value(name: str, key: str) -> float:
    return _state.by_name[name].get_smoothed_value(key)


def get_smoothed_values(name: str):
    return _state.by_name[name].get_smoothed_values()


def state_dict():
    return {name: agg.state_dict() for name, agg in _state.by_name.items()}


def load_state_dict(state):
    for name, agg_state in state.items():
        agg = MetersDict()
        agg.load_state_dict(agg_state)
        _state.by_name[name] = agg
