"""Metric meters (counterpart of ``unicore_tpu/logging/meters.py``; the
weighted running average behind a priority-ordered dict, which is what the
loss's ``reduce_metrics`` and the training log need, and their
``state_dict`` round trip in the JAX package's layout, so a resumed run's
meters continue)."""

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


def safe_round(number, ndigits):
    """Round plain numbers and 0-d tensors/arrays; pass the rest through."""
    if hasattr(number, "item") and not isinstance(number, (int, float)):
        number = number.item()
    try:
        return round(number, ndigits)
    except TypeError:
        return number


class AverageMeter:
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

    def state_dict(self):
        return {"val": self.val, "sum": self.sum, "count": self.count,
                "round": self.round}

    def load_state_dict(self, state_dict):
        self.val = state_dict["val"]
        self.sum = state_dict["sum"]
        self.count = state_dict["count"]
        self.round = state_dict.get("round")

    @property
    def avg(self):
        return self.sum / self.count if self.count > 0 else self.val

    @property
    def smoothed_value(self) -> float:
        avg = self.avg
        return safe_round(avg, self.round) if self.round is not None and avg is not None else avg


class MetersDict(OrderedDict):
    """Meters keyed by name, iterated in (priority, insertion) order."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rank: List[Tuple[int, int, str]] = []

    def add_meter(self, key, meter, priority):
        if key in self:
            raise AssertionError(f"meter {key!r} already registered")
        self._rank.append((priority, len(self._rank), key))
        self._rank.sort()
        super().__setitem__(key, meter)
        for _, _, k in self._rank:
            self.move_to_end(k)

    def get_smoothed_values(self) -> Dict[str, float]:
        return OrderedDict(
            (key, meter.smoothed_value) for key, meter in self.items()
            if not key.startswith("_")
        )

    def reset(self):
        for meter in self.values():
            meter.reset()

    def state_dict(self):
        """``[(priority, key, meter class name, meter state)]`` in
        (priority, insertion) order, as the JAX package writes it."""
        return [(priority, key, type(self[key]).__name__, self[key].state_dict())
                for priority, _, key in self._rank]

    def load_state_dict(self, state_dict):
        self.clear()
        self._rank.clear()
        for priority, key, cls_name, meter_state in state_dict:
            if cls_name != "AverageMeter":
                raise ValueError(f"meter {key!r}: {cls_name} is not ported")
            meter = AverageMeter()
            meter.load_state_dict(meter_state)
            self.add_meter(key, meter, priority)
