"""LayerNorm / RMSNorm modules (counterpart of
``unicore_tpu/modules/layer_norm.py``).

One flag picks the path (``--fused-norm {auto,on,off}``, wired through
:func:`configure_fused_norm`):

- ``auto`` (default) and ``on``: the fused-norm wrappers of
  ``ops/fused_norm.py`` — the hand-written CUDA kernel for a CUDA tensor,
  its plain version for a CPU tensor.  (The JAX package's ``auto`` picks
  jnp because XLA fuses the norm into its neighbours; eager PyTorch has no
  such fusion, so here ``auto`` takes the kernel.)
- ``off``: the module's own plain composition, an explicit choice.

A :class:`~unicore_tpu_torch.quant.QTensor` input (the int8 or fp8 output
of the BERT LM head's ``QuantDense`` in quantized serving) goes to
``ops/quant_norm.py``, whatever the flag: the dequant multiply fused into
the statistics pass, fp32 out, as the JAX ``LayerNorm`` routes it.

Semantics on every path: eps defaults (1e-5 LN / 1e-6 RMS),
elementwise affine (weight=1, bias=0 init), fp32 statistics whatever the
input type, output cast back to the input type.  The JAX package also
journals each module's chosen path once a trace (``fused-norm-path``); the
port's journal does not carry it (the choice follows the flag and the
tensor's device on every call).
"""

from typing import Optional

import torch
from torch import nn

from unicore_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
from unicore_tpu_torch.ops.quant_norm import quant_layer_norm
from unicore_tpu_torch.quant import QTensor

_MODES = ("auto", "on", "off")
_mode = "auto"


def configure_fused_norm(mode: Optional[str]):
    """Wire ``--fused-norm`` (None resets to ``auto``)."""
    global _mode
    if mode is None:
        mode = "auto"
    if mode not in _MODES:
        raise ValueError(f"--fused-norm {mode!r} not in {_MODES}")
    _mode = mode


def _use_kernel() -> bool:
    return _mode != "off"


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        assert elementwise_affine
        self.normalized_shape = int(normalized_shape)
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(self.normalized_shape, dtype=torch.float32, device=device)
        )
        self.bias = nn.Parameter(
            torch.zeros(self.normalized_shape, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        if isinstance(x, QTensor):
            return quant_layer_norm(x.values, x.scale, self.weight, self.bias,
                                    eps=self.eps, out_dtype=torch.float32)
        if _use_kernel():
            # the kernel reads rows in place: a transposed view is copied
            return fused_layer_norm(x.contiguous(), self.weight, self.bias, eps=self.eps)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm: no mean subtraction, scale-only affine, fp32 statistics."""

    def __init__(self, normalized_shape: int, eps: float = 1e-6,
                 elementwise_affine: bool = True, device=None):
        super().__init__()
        assert elementwise_affine
        self.normalized_shape = int(normalized_shape)
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(self.normalized_shape, dtype=torch.float32, device=device)
        )

    def forward(self, x):
        if _use_kernel():
            return fused_rms_norm(x, self.weight, eps=self.eps)
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf / torch.sqrt(ms + self.eps)
        y = y * self.weight
        return y.to(x.dtype)
