"""Quantized-input LayerNorm (counterpart of ``unicore_tpu/ops/quant_norm.py``).

Consumes the int8 activation a ``QuantDense(quantize_output=True)`` site
emits (the BERT LM head in int8 serving): the dequant multiply is fused into
the norm's fp32 statistics pass, so the fp32 activation between the dense
and the norm never exists as a tensor.

:func:`quant_layer_norm` routes as the JAX package routes on a TPU:

- an int8 input runs the hand-written kernel of ``csrc/fused_norm.cu``
  (``fused_norm.quant_layer_norm_kernel``) on a CUDA tensor -- or raises --
  and ``fused_norm.quant_layer_norm_plain`` on a CPU tensor.  The TPU's
  32-row gate is a tiling rule of that chip; the CUDA kernel takes any row
  count;
- a float8 input (``--serve-quantize fp8``) runs the plain composition on
  either device: the JAX Pallas kernel takes only int8, so fp8 goes through
  its jnp oracle there.  This is the JAX route, not a fallback.

The JAX oracle, ``quant_layer_norm_reference``, is the kernel's plain
function: dequantize in fp32, then the two-pass LayerNorm.

Forward only (no gradient for a quantized input).
"""

import torch

from .fused_norm import quant_layer_norm_kernel, quant_layer_norm_plain


def kernel_would_run(x_q) -> bool:
    """Whether the JAX package on a TPU would send ``x_q`` to its Pallas
    kernel, less the TPU's row tiling: an int8 tensor of at least one row."""
    return x_q.dtype == torch.int8 and x_q.ndim >= 2 and x_q.numel() > 0


def quant_layer_norm(x_q, x_scale, weight, bias, eps: float = 1e-5,
                     out_dtype=torch.float32):
    """``LayerNorm(x_q * x_scale) * weight + bias`` over the last dim with
    fp32 statistics; ``x_scale`` a scalar or (D,) tensor."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x_q.device)
    if not kernel_would_run(x_q) or x_q.device.type == "cpu":
        return quant_layer_norm_plain(x_q, x_scale, weight, bias, eps, out_dtype)
    return quant_layer_norm_kernel(x_q, x_scale, weight, bias, eps).to(out_dtype)
