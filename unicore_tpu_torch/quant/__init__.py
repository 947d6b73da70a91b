"""Post-training quantization for the serving plane (counterpart of
``unicore_tpu/quant/__init__.py``).

- :class:`QTensor` -- an int8/fp8 tensor and its dequant scale, the typed
  boundary between a ``QuantDense(quantize_output=True)`` site and the
  quantized-input op that consumes it (``ops/quant_norm.py``);
- :func:`calibration_scope` -- a thread-local flag that makes every
  :class:`~unicore_tpu_torch.quant.dense.QuantDense` site run its fp32 path
  and record its input absmax (and output absmax at ``quantize_output``
  sites) as a running max;
- :mod:`~unicore_tpu_torch.quant.calibrate` -- the startup calibration pass,
  the prepared serving weights, the scale sidecar and the drift bound.

Modes: ``int8`` (the int8 kernels of ``ops/quant_matmul.py``,
``ops/quant_norm.py`` and ``ops/quant_softmax_dropout.py``) and ``fp8``
(``float8_e4m3fn`` rounding of weights and activations, fp32 compute in
plain torch on either device, as the JAX package routes it).  Inference
only; training precision is untouched.
"""

import contextlib
import threading
from typing import NamedTuple

MODES = ("off", "int8", "fp8")

#: symmetric quantization ranges per mode
QMAX = {"int8": 127.0, "fp8": 448.0}  # float8_e4m3fn finite max


class QTensor(NamedTuple):
    """A quantized tensor and its dequant scale (a 0-d or per-channel fp32
    tensor).  ``dequant()`` is for references and tests; the consumers fuse
    the multiply into their own first pass."""

    values: object  # int8 / float8_e4m3fn tensor
    scale: object   # fp32 tensor

    def dequant(self):
        return self.values.float() * self.scale


_state = threading.local()


def calibrating() -> bool:
    """True inside :func:`calibration_scope` on this thread."""
    return getattr(_state, "calibrating", False)


@contextlib.contextmanager
def calibration_scope():
    prev = calibrating()
    _state.calibrating = True
    try:
        yield
    finally:
        _state.calibrating = prev


def check_mode(mode: str) -> str:
    """Normalize/validate a ``--serve-quantize`` value; '' == 'off'."""
    mode = mode or "off"
    if mode not in MODES:
        raise ValueError(f"quantize mode {mode!r} not in {MODES}")
    return mode


from unicore_tpu_torch.quant.dense import QuantDense  # noqa: E402

__all__ = [
    "MODES",
    "QMAX",
    "QTensor",
    "QuantDense",
    "calibrating",
    "calibration_scope",
    "check_mode",
]
