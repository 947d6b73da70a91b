"""Streaming anomaly detectors over per-update training metrics
(counterpart of ``unicore_tpu/health/detectors.py``, the same arithmetic
to the float).

Pure Python: each detector takes one scalar a training update and answers
"is this update anomalous?" from streaming statistics, with no history
buffers.  The sentinel (:mod:`unicore_tpu_torch.health.sentinel`) feeds
them the per-update loss / grad norm / loss scale it derives from the
trainer's running metric sums.

Shared conventions:

- ``check(step, value) -> Optional[Anomaly]`` judges one observation
  WITHOUT folding it into the statistics; ``update(step, value)`` folds
  it; ``observe(step, value)`` checks, then updates only when clean.  The
  sentinel drives check and update apart so that a window one detector
  flags is folded into NO detector's band (a loss spike usually comes
  with an elevated but sub-threshold grad norm, which must not inflate
  the grad-norm EMA either).
- Warmup grace: nothing is flagged at ``step <= warmup``, and the
  spike-style detectors also wait for ``min_obs`` clean observations.
- Anomalous observations are NOT folded into the running statistics:
  one spike would widen the band and mask the next.
"""

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class Anomaly:
    """One confirmed detector hit, carried through the escalation ladder
    and into the sentinel event log / abort diagnosis."""

    detector: str  # which detector fired (its .name)
    step: int      # the update (window end) the observation covers
    stat: str      # the statistic that tripped, e.g. "loss"
    value: float   # observed value
    threshold: float  # the limit it crossed (z-score, ratio, or count)
    message: str   # human diagnosis fragment

    def describe(self) -> str:
        return (
            f"detector={self.detector} step={self.step} "
            f"{self.stat}={self.value:.6g} ({self.message})"
        )


class _EmaStats:
    """Exponentially-weighted mean/variance (West's EW update)."""

    def __init__(self, window: int):
        # alpha chosen so `window` observations carry ~86% of the weight
        self.alpha = 2.0 / (max(int(window), 2) + 1.0)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, value: float) -> None:
        if self.n == 0:
            self.mean = value
            self.var = 0.0
        else:
            delta = value - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1

    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))


class LossSpikeDetector:
    """EMA-band / z-score loss-spike detection.

    Flags an update whose loss sits more than ``zmax`` standard deviations
    ABOVE the exponentially-weighted mean (downward moves are progress,
    never an anomaly).  The std is floored at ``rel_floor * |mean|`` so a
    loss plateau with near-zero variance doesn't turn numerical noise
    into spikes.  A non-finite loss is always an anomaly once past
    warmup — no band needed to judge NaN.
    """

    name = "loss-spike"
    stat = "loss"

    def __init__(self, zmax: float = 6.0, window: int = 64, warmup: int = 50,
                 min_obs: Optional[int] = None, rel_floor: float = 1e-3):
        self.zmax = float(zmax)
        self.warmup = int(warmup)
        self.min_obs = (
            max(2, int(warmup) // 2) if min_obs is None else int(min_obs)
        )
        self.rel_floor = float(rel_floor)
        self._stats = _EmaStats(window)

    def check(self, step: int, value: float) -> Optional[Anomaly]:
        value = float(value)
        armed = step > self.warmup and self._stats.n >= self.min_obs
        if not math.isfinite(value):
            if armed:
                return Anomaly(
                    self.name, step, self.stat, value, self.zmax,
                    "non-finite training loss",
                )
            return None  # pre-warmup NaN is the overflow skip's problem
        if armed:
            floor = self.rel_floor * abs(self._stats.mean) + 1e-12
            std = max(self._stats.std(), floor)
            z = (value - self._stats.mean) / std
            if z > self.zmax:
                return Anomaly(
                    self.name, step, self.stat, value, self.zmax,
                    f"z-score {z:.1f} above EMA band (mean "
                    f"{self._stats.mean:.6g}, std {std:.3g}, zmax {self.zmax})",
                )
        return None

    def update(self, step: int, value: float) -> None:
        value = float(value)
        if math.isfinite(value):
            self._stats.update(value)

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        hit = self.check(step, value)
        if hit is None:
            self.update(step, value)
        return hit


class GradNormExplosionDetector:
    """Grad-norm explosion: the pre-clip global gradient norm exceeds
    ``factor`` times its exponentially-weighted mean.  Non-finite norms
    never reach this detector — the in-jit overflow skip (ladder level 0)
    already neutralized those updates and the sentinel filters them out.
    """

    name = "grad-explosion"
    stat = "gnorm"

    def __init__(self, factor: float = 10.0, window: int = 64,
                 warmup: int = 50, min_obs: Optional[int] = None):
        self.factor = float(factor)
        self.warmup = int(warmup)
        self.min_obs = (
            max(2, int(warmup) // 2) if min_obs is None else int(min_obs)
        )
        self._stats = _EmaStats(window)

    def check(self, step: int, value: float) -> Optional[Anomaly]:
        value = float(value)
        if not math.isfinite(value):
            return None  # handled by the overflow skip, not a spike
        if step > self.warmup and self._stats.n >= self.min_obs:
            baseline = max(self._stats.mean, 1e-12)
            ratio = value / baseline
            if ratio > self.factor:
                return Anomaly(
                    self.name, step, self.stat, value, self.factor,
                    f"{ratio:.1f}x the EMA grad norm ({baseline:.6g}, "
                    f"limit {self.factor}x)",
                )
        return None

    def update(self, step: int, value: float) -> None:
        value = float(value)
        if math.isfinite(value):
            self._stats.update(value)

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        hit = self.check(step, value)
        if hit is None:
            self.update(step, value)
        return hit


class LossScaleCollapseDetector:
    """fp16 loss-scale collapse: the dynamic scale keeps shrinking with no
    recovery in between.  One rescale after an overflow is routine; a run
    of ``halvings`` consecutive observations that each moved the scale
    DOWN means every re-try overflows again — the trajectory has diverged
    and shrinking the scale further only delays the min-scale abort.
    Any upward move (a clean ``scale_window``) resets the count.
    """

    name = "scale-collapse"
    stat = "loss_scale"

    def __init__(self, halvings: int = 8, warmup: int = 0):
        self.halvings = int(halvings)
        self.warmup = int(warmup)
        self._prev: Optional[float] = None
        self._drops = 0
        self._peak: Optional[float] = None

    def check(self, step: int, value: float) -> Optional[Anomaly]:
        value = float(value)
        if not math.isfinite(value):
            return None
        if self._prev is None or value >= self._prev:
            return None
        projected = self._drops + 1
        if projected >= self.halvings and step > self.warmup:
            # consume the run (re-arm) instead of refiring every update;
            # the sentinel deliberately skips update() on a flagged window
            self._drops = 0
            self._prev = value
            peak = self._peak if self._peak is not None else value
            return Anomaly(
                self.name, step, self.stat, value, float(self.halvings),
                f"{projected} consecutive downward rescales without "
                f"recovery (peak scale {peak:.6g})",
            )
        return None

    def update(self, step: int, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            return
        if self._prev is not None:
            if value < self._prev:
                self._drops += 1
            elif value > self._prev:
                self._drops = 0  # the scale recovered: healthy
        if self._peak is None or value > self._peak:
            self._peak = value
        self._prev = value

    def observe(self, step: int, value: float) -> Optional[Anomaly]:
        hit = self.check(step, value)
        if hit is None:
            self.update(step, value)
        return hit
