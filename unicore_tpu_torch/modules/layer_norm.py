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
input type, output cast back to the input type.

The chosen path is journaled (``fused-norm-path``, the JAX package's
fields: ``module``, ``dim``, ``path``, ``source``) once per (module kind,
width, path) and journal, as the JAX package journals it once a trace:
``path`` is ``cuda`` where the wrappers launch the kernel (a CUDA tensor)
and ``plain`` where the plain version runs (a CPU tensor, or ``off``).
"""

from typing import Optional

import torch
from torch import nn

from unicore_tpu_torch.ops.fused_norm import fused_layer_norm, fused_rms_norm
from unicore_tpu_torch.ops.quant_norm import quant_layer_norm
from unicore_tpu_torch.quant import QTensor
from unicore_tpu_torch.telemetry import journal as _journal_mod

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


#: (module kind, width, path) already journaled into the journal
#: ``_journaled_for[0]`` (a new journal starts the set afresh)
_journaled = set()
_journaled_for = [None]


def norm_path(x: torch.Tensor) -> str:
    """The path a forward on ``x`` takes: the CUDA kernel or the plain
    version."""
    return "cuda" if _use_kernel() and x.is_cuda else "plain"


def journal_choice(kind: str, dim: int, path: str) -> None:
    """Journal one norm module's path, once per (kind, dim, path) and
    journal; nothing before the journal is configured."""
    j = _journal_mod.active()
    if j is None:
        return
    if _journaled_for[0] is not j:
        _journaled.clear()
        _journaled_for[0] = j
    key = (kind, dim, path)
    if key in _journaled:
        return
    _journaled.add(key)
    _journal_mod.emit("fused-norm-path", module=kind, dim=dim, path=path,
                      source=f"flag:{_mode}")


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
        journal_choice("LayerNorm", self.normalized_shape, norm_path(x))
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
        journal_choice("RMSNorm", self.normalized_shape, norm_path(x))
        if _use_kernel():
            return fused_rms_norm(x, self.weight, eps=self.eps)
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf / torch.sqrt(ms + self.eps)
        y = y * self.weight
        return y.to(x.dtype)
