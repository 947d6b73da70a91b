"""Quantized-input fused softmax(+mask)(+bias)(+dropout) (counterpart of
``unicore_tpu/ops/quant_softmax_dropout.py``).

The int8 serving plane's attention scores: q and k quantize to int8, the
score product sums exactly in int32, and THIS op consumes the int32 scores
directly -- the dequant multiply by one fp32 scale happens inside the
softmax row pass, so the fp32 score tensor never exists.

:func:`quant_softmax_dropout` routes as the JAX package routes on a TPU:

- an int8 or int32 input at a shape the fp32 kernel takes
  (``softmax_dropout.kernel_would_run``, the JAX ``pallas_plan``: last dim
  a multiple of 128 up to 8192, rows a multiple of 8, a ``bcast``/``tile``
  mask and bias) runs the hand-written forward of
  ``csrc/softmax_dropout.cu`` on a CUDA tensor -- or raises -- and
  :func:`quant_softmax_dropout_plain`, the same function in plain PyTorch
  with the kernel's Philox dropout, on a CPU tensor.  The TPU's extra
  32-row rule for int8 is a tiling rule of that chip and is not carried;
- any other input runs :func:`quant_softmax_dropout_reference`, the plain
  composition (the JAX jnp route), on either device.

The scale is a 0-d tensor on the input's device (``q_scale * k_scale`` in
the attention), never a host float, so no call syncs the stream.  Forward
only: no gradient for a quantized input.
"""

from typing import Optional

import torch

from .softmax_dropout import (
    _QUANT_DTYPES,
    kernel_would_run as _fp_kernel_would_run,
    quant_softmax_dropout_kernel,
    softmax_dropout_plain,
    softmax_dropout_reference,
)


def _dequant(input_q, x_scale):
    return input_q.float() * torch.as_tensor(x_scale, dtype=torch.float32,
                                             device=input_q.device)


def quant_softmax_dropout_reference(input_q, x_scale, dropout_prob: float = 0.0,
                                    is_training: bool = False, mask=None, bias=None,
                                    rng=None, out_dtype=torch.float32):
    """The JAX ``quant_softmax_dropout_reference``: dequantize in fp32, then
    the plain softmax composition (its dropout, at a nonzero rate in
    training, from ``rng.device``)."""
    rate = float(dropout_prob) if is_training else 0.0
    return softmax_dropout_reference(_dequant(input_q, x_scale), rate, mask, bias,
                                     rng).to(out_dtype)


def quant_softmax_dropout_plain(input_q, x_scale, rate: float = 0.0, mask=None,
                                bias=None, seed: int = 0):
    """The kernel's function in plain PyTorch: ``input_q * x_scale`` in fp32
    (+ mask) (+ bias), fp32 softmax, the Philox dropout of
    ``softmax_dropout_plain`` at ``rate``; fp32 out."""
    return softmax_dropout_plain(_dequant(input_q, x_scale), rate, mask, bias, seed)


def kernel_would_run(input_shape, input_dtype, mask, bias) -> bool:
    """Whether the JAX package on a TPU would send this call to its Pallas
    kernel (``quant_softmax_dropout._pallas_eligible``, less the int8 row
    tiling): an int8/int32 input whose fp32 plan exists."""
    return input_dtype in _QUANT_DTYPES and _fp_kernel_would_run(
        input_shape, torch.float32, mask, bias)


def quant_softmax_dropout(
    input_q: torch.Tensor,
    x_scale,
    dropout_prob: float = 0.0,
    is_training: bool = False,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    rng=None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """softmax(dequant(input_q) [+ mask] [+ bias]) with dropout in training.

    ``input_q``: int8, or the int32 sum of an int8 product; ``x_scale``: its
    scalar dequant factor.  ``rng`` (a :class:`DropoutRng`) is needed only
    when training with a nonzero rate, as for ``softmax_dropout``."""
    rate = float(dropout_prob) if is_training else 0.0
    if rate > 0.0 and rng is None:
        raise ValueError(
            "quant_softmax_dropout needs a DropoutRng when training with dropout"
        )
    if not kernel_would_run(input_q.shape, input_q.dtype, mask, bias):
        return quant_softmax_dropout_reference(input_q, x_scale, rate, rate > 0.0,
                                               mask, bias, rng, out_dtype)
    seed = rng.kernel_seed() if rate > 0.0 else 0
    if input_q.device.type == "cpu":
        out = quant_softmax_dropout_plain(input_q, x_scale, rate, mask, bias, seed)
    else:
        scale = torch.as_tensor(x_scale, dtype=torch.float32, device=input_q.device)
        out = quant_softmax_dropout_kernel(input_q, scale, rate, mask, bias, seed)
    return out.to(out_dtype)
