"""Metrics aggregation with named contexts (counterpart of
``unicore_tpu/logging/metrics.py``): ``aggregate`` (nestable; ``new_root``
isolates, as validation inside the train loop does), ``log_scalar``, the
per-aggregator reads, and a ``state_dict`` a checkpoint carries so a
resumed run's meters continue."""

import contextlib
import uuid
from typing import Dict, List, Optional

from .meters import AverageMeter, MetersDict

_by_name: Dict[str, MetersDict] = {}
_active: Dict[str, MetersDict] = {}


def reset() -> None:
    """Drop every aggregator and start fresh."""
    _by_name.clear()
    _active.clear()


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Route logged values into the named aggregator (as well as any other
    active one, unless ``new_root``, which suspends them) for the duration
    of the block.  Without a name the aggregator is anonymous and lives
    only as long as the block."""
    if name is None:
        name, agg = str(uuid.uuid4()), MetersDict()
    else:
        agg = _by_name.setdefault(name, MetersDict())
    saved = dict(_active) if new_root else None
    if new_root:
        _active.clear()
    outer = name in _active
    _active[name] = agg
    try:
        yield agg
    finally:
        if not outer:
            _active.pop(name, None)
        if saved is not None:
            _active.clear()
            _active.update(saved)


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


def state_dict():
    return {name: agg.state_dict() for name, agg in _by_name.items()}


def load_state_dict(state):
    for name, agg_state in state.items():
        agg = MetersDict()
        agg.load_state_dict(agg_state)
        _by_name[name] = agg
