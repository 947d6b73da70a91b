"""``QuantDense`` -- the one quantize-aware dense layer every wired call site
uses (counterpart of ``unicore_tpu/quant/dense.py``): the attention's
``in_proj``/``out_proj``, the FFN's ``fc1``/``fc2`` and the BERT LM head's
``dense``.

Three behaviours behind one module, picked by ``quantize`` and the
calibration flag:

- **fp path** (``quantize`` '' or 'off', or inside
  :func:`~unicore_tpu_torch.quant.calibration_scope`): exactly
  ``F.linear`` then the fused ``activation`` -- the parameters are
  ``nn.Linear``'s ``weight``/``bias``, so every checkpoint loads as before
  and training and fp32 serving are untouched;
- **calibration** (the fp path inside the scope): also records the input's
  absmax, and the output's for ``quantize_output`` sites of a quantized
  model, as running maxes on the device (``calibrate.collect_scales`` reads
  them);
- **quantized path** (``quantize`` 'int8' or 'fp8', after
  :meth:`QuantDense.to_quantized` and a load of the prepared weights): the
  buffers ``weight_q`` ((N, K), the Linear layout, int8 or
  ``float8_e4m3fn``), ``weight_scale`` (N,), ``act_scale`` and, for
  ``quantize_output``, ``out_scale``.  The input quantizes against the
  calibrated ``act_scale`` and ``ops/quant_matmul.py`` runs with the
  combined scale ``act_scale * weight_scale``, computed once when the
  prepared weights load (a non-persistent buffer), never per call.  With
  ``quantize_output`` the result re-quantizes against ``out_scale`` and
  returns as a :class:`~unicore_tpu_torch.quant.QTensor`.

The quantized path is inference only.
"""

import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch import quant as _q
from unicore_tpu_torch.ops.quant_matmul import quant_matmul, quantize_to_dtype
from unicore_tpu_torch.utils import get_activation_fn


def storage_dtype(mode: str):
    return torch.int8 if mode == "int8" else torch.float8_e4m3fn


def _refresh_scale(module, incompatible_keys=None):
    """Load post-hook: the combined dequant factor of a quantized site."""
    if module.is_quantized():
        module.scale = module.act_scale * module.weight_scale


class QuantDense(nn.Linear):
    """``nn.Linear`` with a fused ``activation`` (a ``utils.get_activation_fn``
    name, applied on both paths), a quantized serving path and
    ``quantize_output`` (emit a :class:`QTensor` when quantized)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, activation: str = "", quantize_output: bool = False):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.activation = activation
        self.quantize_output = quantize_output
        #: '' (fp path), 'int8' or 'fp8'; set on a model's quantized twin
        self.quantize = ""
        #: calibration running maxes (0-d device tensors), by leaf name
        self.calib = {}
        self.register_load_state_dict_post_hook(_refresh_scale)

    def is_quantized(self) -> bool:
        return "weight_q" in self._buffers

    def to_quantized(self) -> None:
        """Swap ``weight`` for the prepared buffers of mode ``self.quantize``
        (zeros until the prepared weights load)."""
        mode = _q.check_mode(self.quantize)
        if mode == "off" or self.is_quantized():
            return
        dev = self.weight.device
        N, K = self.weight.shape
        del self.weight
        self.register_buffer("weight_q", torch.zeros((N, K), dtype=storage_dtype(mode),
                                                     device=dev))
        self.register_buffer("weight_scale", torch.ones(N, device=dev))
        self.register_buffer("act_scale", torch.ones((), device=dev))
        if self.quantize_output:
            self.register_buffer("out_scale", torch.ones((), device=dev))
        self.register_buffer("scale", torch.ones(N, device=dev), persistent=False)
        _refresh_scale(self)

    def _record(self, name: str, value) -> None:
        absmax = value.detach().float().abs().amax()
        prev = self.calib.get(name)
        self.calib[name] = absmax if prev is None else torch.maximum(prev, absmax)

    def forward(self, x):
        quantized = _q.check_mode(self.quantize) != "off"
        if quantized and not _q.calibrating():
            return self._quantized(x)
        if self.is_quantized():
            raise RuntimeError("a prepared QuantDense has no fp32 weight to calibrate")
        if _q.calibrating():
            self._record("act_absmax", x)
        y = F.linear(x, self.weight, self.bias)
        if self.activation:
            y = get_activation_fn(self.activation)(y)
        if _q.calibrating() and quantized and self.quantize_output:
            self._record("out_absmax", y)
        return y

    def _quantized(self, x):
        if not self.is_quantized():
            raise RuntimeError(
                f"QuantDense in mode {self.quantize!r} has no prepared weights "
                "(quant.calibrate.load_prepared)"
            )
        mode = self.quantize
        qmax, dtype = _q.QMAX[mode], storage_dtype(mode)
        x_q = quantize_to_dtype(x, self.act_scale, qmax, dtype)
        y = quant_matmul(x_q, self.weight_q, self.scale, self.bias,
                         activation=self.activation, out_dtype=x.dtype)
        if self.quantize_output:
            return _q.QTensor(quantize_to_dtype(y, self.out_scale, qmax, dtype),
                              self.out_scale)
        return y
