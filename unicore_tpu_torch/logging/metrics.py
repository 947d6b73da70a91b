"""Metrics aggregation with named contexts (counterpart of
``unicore_tpu/logging/metrics.py``; ``aggregate``, ``log_scalar`` and the
per-aggregator reads, which is what the loss's ``reduce_metrics`` and the
training log need)."""

import contextlib
from typing import Dict, List, Optional

from .meters import AverageMeter, MetersDict

_by_name: Dict[str, MetersDict] = {}
_active: Dict[str, MetersDict] = {}


def reset() -> None:
    """Drop every aggregator and start fresh."""
    _by_name.clear()
    _active.clear()


@contextlib.contextmanager
def aggregate(name: str):
    """Route logged values into the named aggregator (as well as any other
    active one) for the duration of the block."""
    agg = _by_name.setdefault(name, MetersDict())
    outer = name in _active
    _active[name] = agg
    try:
        yield agg
    finally:
        if not outer:
            _active.pop(name, None)


def get_active_aggregators() -> List[MetersDict]:
    return list(_active.values())


def log_scalar(key: str, value: float, weight: float = 1, priority: int = 10,
               round: Optional[int] = None):
    """Weighted scalar into every active aggregator."""
    for agg in get_active_aggregators():
        if key not in agg:
            agg.add_meter(key, AverageMeter(round=round), priority)
        agg[key].update(value, weight)


def reset_meters(name: str) -> None:
    if name in _by_name:
        _by_name[name].reset()


def get_smoothed_values(name: str):
    return _by_name[name].get_smoothed_values()
