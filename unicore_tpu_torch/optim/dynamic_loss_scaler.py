"""Dynamic fp16 loss scaling (counterpart of
``unicore_tpu/optim/dynamic_loss_scaler.py``).

Grow the scale after a clean window, shrink it on an overflow once the
share of overflows since the last rescale reaches the tolerance, and
report a scale pinned at ``min_loss_scale``.  Two faces, as in the JAX
package:

- :func:`scale_schedule` / :func:`init_scale_state`: the schedule the
  trainer steps once an update.  The JAX trainer carries it inside its
  compiled step; the port's update already reads the gradient norm on the
  host, so the schedule runs on host scalars with the JAX arithmetic: the
  scale and the overflow share are fp32 (``numpy.float32``), the counters
  ints.  ``pinned`` is the trainer's to raise on at its next metrics flush.
- :class:`DynamicLossScaler`: the host-side class with the reference's
  exception-driven API (``check_overflow`` raises, ``update`` grows).
"""

import numpy as np

_F32 = np.float32


def init_scale_state(init_scale):
    """The schedule's carried scalars."""
    return {
        "scale": _F32(init_scale),
        "since_overflow": 0,
        "since_rescale": 0,
        "overflows_since_rescale": 0,
    }


def scale_schedule(state, overflow, scale_factor=2.0, scale_window=2000,
                   min_loss_scale=1e-4, tolerance=0.0, threshold_loss_scale=None):
    """One step of the schedule; returns ``(new_state, pinned)``.

    - clean step: ``since_overflow + 1`` reaching a multiple of
      ``scale_window`` grows the scale by ``scale_factor``;
    - overflow: shrink only when the overflow share since the last rescale
      reaches ``tolerance`` (0 shrinks on every overflow);
    - ``pinned``: a due shrink ran into ``min_loss_scale``;
    - ``threshold_loss_scale``: a floor the scale never shrinks below, and
      then it never pins."""
    overflow = bool(overflow)
    scale = _F32(state["scale"])
    since_overflow = int(state["since_overflow"])
    since_rescale = int(state["since_rescale"])
    new_overflows = int(state["overflows_since_rescale"]) + int(overflow)
    steps = _F32(max(since_rescale + 1, 1))
    pct = _F32(new_overflows) / steps
    shrink_due = overflow and bool(pct >= _F32(tolerance))
    grow_due = (not overflow) and (since_overflow + 1) % scale_window == 0

    down = _F32(scale / _F32(scale_factor))
    if threshold_loss_scale is not None:
        shrunk = max(down, _F32(max(threshold_loss_scale, min_loss_scale)))
        pinned = False
    else:
        shrunk = max(down, _F32(min_loss_scale))
        pinned = shrink_due and bool(down <= _F32(min_loss_scale))
    if shrink_due:
        new_scale = _F32(shrunk)
    elif grow_due:
        new_scale = _F32(scale * _F32(scale_factor))
    else:
        new_scale = scale
    rescaled = shrink_due or grow_due
    return {
        "scale": new_scale,
        "since_overflow": 0 if overflow else since_overflow + 1,
        "since_rescale": 0 if rescaled else since_rescale + 1,
        "overflows_since_rescale": 0 if rescaled else new_overflows,
    }, pinned


class DynamicLossScaler(object):
    """Host-side scaler with the reference's exception-driven API."""

    def __init__(self, init_scale=2.0 ** 15, scale_factor=2.0, scale_window=2000,
                 tolerance=0.0, threshold=None, min_loss_scale=1e-4):
        self.loss_scale = init_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.tolerance = tolerance
        self.threshold = threshold
        self.min_loss_scale = min_loss_scale
        # counters mirror the schedule's carried scalars
        self._since_overflow = 0
        self._since_rescale = 0
        self._overflows_since_rescale = 0

    def scale(self, outputs):
        return self.loss_scale * outputs

    def update(self):
        """Record a clean step; grows the scale when a full window of them
        has passed since the last overflow."""
        self._since_overflow += 1
        self._since_rescale += 1
        if self._since_overflow % self.scale_window == 0:
            self.loss_scale *= self.scale_factor
            self._since_rescale = 0
            self._overflows_since_rescale = 0

    def check_overflow(self, grad_norm):
        """No-op on finite norms.  On inf/nan: shrink the scale if the
        overflow share since the last rescale reaches the tolerance, then
        raise OverflowError so the caller skips the step -- or
        FloatingPointError when the shrink hit ``min_loss_scale``."""
        if not (grad_norm == float("inf") or grad_norm != grad_norm):
            return
        self._overflows_since_rescale += 1
        self._since_overflow = 0
        pct = self._overflows_since_rescale / float(max(self._since_rescale + 1, 1))
        self._since_rescale += 1
        if pct >= self.tolerance:
            shrunk = self.loss_scale / self.scale_factor
            if self.threshold is not None:
                shrunk = max(shrunk, self.threshold)
            if shrunk <= self.min_loss_scale:
                raise FloatingPointError(
                    f"Minimum loss scale reached ({self.min_loss_scale}). "
                    "Your loss is probably exploding. Try lowering the "
                    "learning rate, using gradient clipping or increasing "
                    "the batch size."
                )
            self.loss_scale = shrunk
            self._since_rescale = 0
            self._overflows_since_rescale = 0
        raise OverflowError(f"setting loss scale to: {self.loss_scale}")
