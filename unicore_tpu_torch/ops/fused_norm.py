"""Fused LayerNorm / RMSNorm forward (counterpart of
``unicore_tpu/ops/fused_norm.py``; this slice ports the forward, whose TPU
kernel is ``_ln_fwd_kernel``).

:func:`fused_layer_norm` and :func:`fused_rms_norm` take a CPU tensor
through :func:`fused_norm_plain`, the same function in plain PyTorch with
the same casts, and a CUDA tensor through the hand-written kernel
``csrc/fused_norm.cu`` — or raise.  There is no fallback between the two.

Statistics are fp32 whatever the input type; weight and bias are fp32 and
the output takes the input's type.  The backward kernels (``_ln_dx_kernel``,
``_ln_dwdb_kernel``) come with the training slice.
"""

import torch

from . import _kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = _kernels.counter("fused_norm_fwd")


def fused_norm_plain(x, weight, bias, eps: float, rms: bool):
    """The kernel's function in plain PyTorch: two-pass fp32 statistics,
    ``(x - mean) * rsqrt(var + eps) * w (+ b)``, cast to ``x``'s type."""
    xf = x.float()
    if rms:
        mean = 0.0
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _launch(x, weight, bias, eps: float, rms: bool):
    name = "fused_rms_norm" if rms else "fused_layer_norm"
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} unsupported (fp32/bf16)")
    D = x.shape[-1]
    for what, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (D,)):
            raise ValueError(
                f"{name}: {what} must be fp32 of shape ({D},), got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    _kernels.require_cuda(name, x, weight, bias)
    y = torch.empty_like(x)
    N = x.numel() // D if D else 0
    if N == 0:
        return y
    lib = _kernels.library()
    rc = lib.unicore_fused_norm_fwd(
        x.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        N, D, float(eps), int(rms), _DTYPES[x.dtype],
        _kernels.stream_handle(x.device),
    )
    _kernels.check(rc, name)
    LAUNCHES.add()
    return y


def _fused_norm(x, weight, bias, eps: float, rms: bool):
    if x.device.type == "cpu":
        return fused_norm_plain(x, weight, bias, eps, rms)
    return _launch(x, weight, bias, eps, rms)


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """Fused LayerNorm over the last dim: y = (x - mu) * rstd * w + b."""
    return _fused_norm(x, weight, bias, eps, False)


def fused_rms_norm(x, weight, eps: float = 1e-6):
    """Fused RMSNorm over the last dim: y = x * rsqrt(mean(x^2)) * w."""
    return _fused_norm(x, weight, None, eps, True)
