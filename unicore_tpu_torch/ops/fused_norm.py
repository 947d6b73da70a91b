"""Fused LayerNorm / RMSNorm, forward and backward (counterpart of
``unicore_tpu/ops/fused_norm.py``, whose TPU kernels are ``_ln_fwd_kernel``,
``_ln_dx_kernel`` and ``_ln_dwdb_kernel``).

:func:`fused_layer_norm` and :func:`fused_rms_norm` take a CPU tensor
through :func:`fused_norm_plain`, the same function in plain PyTorch with
the same casts, whose gradient autograd takes; a CUDA tensor goes through
the hand-written kernels of ``csrc/fused_norm.cu`` — or raises.  There is
no fallback between the two.

On a CUDA tensor that needs a gradient the call is a
:class:`torch.autograd.Function`, as the JAX package's ``jax.custom_vjp``:
the forward kernel also writes the fp32 row statistics (mean, rstd), which
the backward's two kernels read (dx per row; dw/db as a column reduction).
Without a gradient the forward writes no statistics.

Statistics are fp32 whatever the input type; weight and bias are fp32 and
the output and dx take the input's type; dw and db are fp32.
"""

import torch

from . import _kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = _kernels.counter("fused_norm_fwd")
DX_LAUNCHES = _kernels.counter("fused_norm_dx")
DWDB_LAUNCHES = _kernels.counter("fused_norm_dwdb")


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


def _check(x, weight, bias, rms: bool) -> str:
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
    return name


def _launch_fwd(x2, weight, bias, eps: float, rms: bool, want_stats: bool, name):
    N, D = x2.shape
    y = torch.empty_like(x2)
    mean = rstd = None
    if want_stats:
        mean = torch.empty(N, dtype=torch.float32, device=x2.device)
        rstd = torch.empty_like(mean)
    if N == 0 or D == 0:
        return y, mean, rstd
    rc = _kernels.library().unicore_fused_norm_fwd(
        x2.data_ptr(), weight.data_ptr(), _kernels.ptr(bias), y.data_ptr(),
        _kernels.ptr(mean), _kernels.ptr(rstd), N, D, float(eps), int(rms),
        _DTYPES[x2.dtype], _kernels.stream_handle(x2.device),
    )
    _kernels.check(rc, name)
    LAUNCHES.add()
    return y, mean, rstd


def _launch_dx(x2, weight, mean, rstd, dy2, rms: bool, name):
    N, D = x2.shape
    dx = torch.empty_like(x2)
    if N == 0:
        return dx
    rc = _kernels.library().unicore_fused_norm_dx(
        x2.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy2.data_ptr(), dx.data_ptr(), N, D, int(rms), _DTYPES[x2.dtype],
        _kernels.stream_handle(x2.device),
    )
    _kernels.check(rc, f"{name} dx")
    DX_LAUNCHES.add()
    return dx


def _launch_dwdb(x2, mean, rstd, dy2, has_bias: bool, name):
    N, D = x2.shape
    dev = x2.device
    dw = torch.zeros(D, dtype=torch.float32, device=dev)
    db = torch.zeros(D, dtype=torch.float32, device=dev) if has_bias else None
    if N == 0:
        return dw, db
    lib = _kernels.library()
    partial = torch.empty(lib.unicore_fused_norm_dwdb_scratch(N, D),
                          dtype=torch.float32, device=dev)
    rc = lib.unicore_fused_norm_dwdb(
        x2.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy2.data_ptr(),
        partial.data_ptr(), dw.data_ptr(), _kernels.ptr(db), N, D,
        _DTYPES[x2.dtype], _kernels.stream_handle(dev),
    )
    _kernels.check(rc, f"{name} dw/db")
    DWDB_LAUNCHES.add()
    return dw, db


class _FusedNorm(torch.autograd.Function):
    """The kernels with their gradient: residuals are x, w and the fp32
    statistics, as the JAX ``_fused_norm_fwd`` keeps them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms, name):
        x2 = x.reshape(-1, x.shape[-1])
        y, mean, rstd = _launch_fwd(x2, weight, bias, eps, rms, True, name)
        ctx.save_for_backward(x2, weight, mean, rstd)
        ctx.rms, ctx.name, ctx.has_bias = rms, name, bias is not None
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, mean, rstd = ctx.saved_tensors
        dy2 = dy.to(x2.dtype).reshape(x2.shape).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _launch_dx(x2, weight, mean, rstd, dy2, ctx.rms,
                            ctx.name).view(dy.shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _launch_dwdb(x2, mean, rstd, dy2, ctx.has_bias, ctx.name)
        return dx, dw, db, None, None, None


def _fused_norm(x, weight, bias, eps: float, rms: bool):
    if x.device.type == "cpu":
        return fused_norm_plain(x, weight, bias, eps, rms)
    name = _check(x, weight, bias, rms)
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias)
    ):
        return _FusedNorm.apply(x, weight, bias, eps, rms, name)
    y, _, _ = _launch_fwd(x.view(-1, x.shape[-1]), weight, bias, eps, rms,
                          False, name)
    return y.view(x.shape)


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """Fused LayerNorm over the last dim: y = (x - mu) * rstd * w + b."""
    return _fused_norm(x, weight, bias, eps, False)


def fused_rms_norm(x, weight, eps: float = 1e-6):
    """Fused RMSNorm over the last dim: y = x * rsqrt(mean(x^2)) * w."""
    return _fused_norm(x, weight, None, eps, True)
