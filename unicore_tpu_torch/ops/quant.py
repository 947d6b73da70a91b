"""The symmetric int8 quantize step (counterpart of the part of
``unicore_tpu/ops/quant_matmul.py`` the decode plane uses: ``INT8_QMAX``
and ``quantize_to_dtype``).  The int8 matmul kernel itself is not ported
yet; the int8 KV cache (``serve/kv_cache.py``) and the decode route of
``modules/multihead_attention.py`` quantize through this one function."""

import torch

#: int8 symmetric range (the -128 column is excluded so dequant is exact
#: under negation)
INT8_QMAX = 127.0


def quantize_to_dtype(x, scale, qmax: float, dtype):
    """Symmetric quantization against a static scale, as the JAX package
    computes it: fp32 ``x / scale``, clipped to [-qmax, qmax], then (int8)
    rounded half to even (``torch.round`` and ``jnp.round`` agree), then
    cast.  Values outside the calibrated range saturate."""
    v = torch.clamp(x.float() / scale, -qmax, qmax)
    if dtype == torch.int8:
        v = torch.round(v)
    return v.to(dtype)
