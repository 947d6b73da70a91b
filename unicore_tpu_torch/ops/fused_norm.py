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
the backward reads.  The backward is one C call that enqueues one pass over
x and dy (dx, and each block's dw/db partial sums) and a small launch that
adds the partials and writes dw and db in the weight's type; the JAX
package's two kernels ``_ln_dx_kernel`` and ``_ln_dwdb_kernel`` compute the
same function, which :func:`fused_norm_bwd_plain` states in torch ops.
Without a gradient the forward writes no statistics.

Statistics are fp32 whatever the input type.  x is fp32, bf16 or fp16
(the JAX package sends every norm to its Pallas kernel, fp16 ones too);
weight and bias are fp32, bf16 or fp16 (a ``--bf16`` / ``--fp16`` run
casts them, as the JAX trainer casts every floating parameter), read in
place by the kernels and widened to fp32.  The output and dx take x's type;
dw and db are summed in fp32 and returned in the weight's type, as the JAX
``_fused_norm_bwd`` returns ``dw.astype(w.dtype)``.

The quantized-input forward (the TPU kernel's int8 ``scale_ref`` variant,
``quant_layer_norm_pallas``) is :func:`quant_layer_norm_kernel` on the card
and :func:`quant_layer_norm_plain` on the CPU, routed by
``ops/quant_norm.py``: LayerNorm of an int8 tensor whose dequant multiply
(one fp32 scale or (D,) of them, read on the device) is fused into the
statistics pass; fp32 out, no statistics, no gradient.
"""

import functools

import torch

from . import _kernels

#: the kernels' type codes (csrc/common.cuh)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 4}
LAUNCHES = _kernels.counter("fused_norm_fwd")
DX_LAUNCHES = _kernels.counter("fused_norm_dx")
DWDB_LAUNCHES = _kernels.counter("fused_norm_dwdb")
QUANT_LAUNCHES = _kernels.counter("quant_layer_norm")


def fused_norm_plain(x, weight, bias, eps: float, rms: bool):
    """The kernel's function in plain PyTorch: two-pass fp32 statistics,
    ``(x - mean) * rsqrt(var + eps) * w (+ b)`` with w and b widened to
    fp32, cast to ``x``'s type."""
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


def fused_norm_stats_plain(x, eps: float, rms: bool):
    """The forward kernel's fp32 row statistics in plain PyTorch, as
    :func:`fused_norm_plain` computes them: (mean, rstd), each (..., 1);
    RMSNorm's mean zeros."""
    xf = x.float()
    if rms:
        mean = torch.zeros_like(xf[..., :1])
        var = xf.square().mean(dim=-1, keepdim=True)
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


#: csrc/fused_norm.cu's forward entry point, bound at its first launch
_fwd_entry = None


def _launch_fwd(x, weight, bias, eps: float, rms: bool, want_stats: bool, name):
    """The forward kernel on card tensors: y in x's shape and type and, with
    ``want_stats``, the fp32 row statistics mean and rstd ((N,) each, N the
    rows of x; RMSNorm's mean zeros), else None for both.  One launch.
    Raises on a CPU tensor and on anything the kernel does not take."""
    global _fwd_entry
    code, wcode = _DTYPES.get(x.dtype), _DTYPES.get(weight.dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {x.dtype} unsupported (fp32/bf16/fp16)")
    D = x.shape[-1]
    for what, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype not in _DTYPES or t.shape != (D,)):
            raise ValueError(
                f"{name}: {what} must be fp32, bf16 or fp16 of shape ({D},), got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if bias is not None and bias.dtype != weight.dtype:
        raise ValueError(f"{name}: weight {weight.dtype} and bias {bias.dtype} differ")
    _kernels.require_cuda(name, x, weight, bias)
    y = torch.empty_like(x)
    N = x.numel() // D if D else 0
    mean = rstd = None
    if want_stats:
        mean, rstd = torch.empty((2, N), dtype=torch.float32, device=x.device).unbind()
    if N == 0:
        return y, mean, rstd
    if _fwd_entry is None:
        _fwd_entry = _kernels.library().unicore_fused_norm_fwd
    rc = _fwd_entry(
        x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), N, D, eps, rms, code, wcode,
        _kernels.stream_handle(x.device),
    )
    if rc:
        _kernels.check(rc, name)
    LAUNCHES.add()
    return y, mean, rstd


def fused_norm_bwd_plain(x2, w, mean, rstd, dy2, rms: bool, has_bias: bool,
                         need_dx: bool = True, need_dwdb: bool = True):
    """The backward kernel's function in plain PyTorch, as the JAX
    ``_ln_dx_kernel`` and ``_ln_dwdb_kernel`` compute it: x2, dy2 (N, D),
    the forward's fp32 statistics mean and rstd ((N,) or (N, 1); mean 0 for
    RMSNorm); x^ = (x - mean) * rstd and wdy = dy * w in fp32,
    ``dx = (wdy - mean(wdy) - x^ * mean(wdy * x^)) * rstd`` (RMSNorm: no
    ``mean(wdy)``) in x's type; dw = sum over rows of dy * x^ and db = sum
    of dy, summed in fp32 and cast once to w's type.  Returns (dx, dw, db),
    None for what is not asked for (db without ``has_bias``)."""
    xf, dyf = x2.float(), dy2.float()
    rstd = rstd.reshape(-1, 1)
    xhat = (xf - mean.reshape(-1, 1)) * rstd
    dx = dw = db = None
    if need_dx:
        wdy = dyf * w.float()
        c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
        if rms:
            dx = (wdy - xhat * c2) * rstd
        else:
            c1 = wdy.mean(dim=-1, keepdim=True)
            dx = (wdy - c1 - xhat * c2) * rstd
        dx = dx.to(x2.dtype)
    if need_dwdb:
        dw = (dyf * xhat).sum(dim=0).to(w.dtype)
        db = dyf.sum(dim=0).to(w.dtype) if has_bias else None
    return dx, dw, db


@functools.lru_cache(maxsize=512)
def _bwd_scratch(N: int, D: int, dtype: int, wdtype: int, aligned: bool) -> int:
    """fp32 floats of the backward's dw/db partials for this shape; below 0
    for a shape or type code the kernel does not take."""
    return _kernels.library().unicore_fused_norm_bwd_scratch(N, D, dtype, wdtype,
                                                            int(aligned))


def _launch_bwd(x2, weight, mean, rstd, dy2, rms: bool, has_bias: bool, need_dx: bool,
                need_dwdb: bool, name):
    """The backward kernel on card tensors: (dx or None, dw or None, db or
    None), dw and db in the weight's type.  One C call enqueues the pass
    over x and dy and, for dw/db, the launch that adds the partials.  Raises
    on a CPU tensor and on a shape or type the kernel does not take."""
    _kernels.require_cuda(f"{name} backward", x2, weight, mean, rstd, dy2)
    N, D = x2.shape
    dev = x2.device
    dx = torch.empty_like(x2) if need_dx else None
    dw = torch.empty(D, dtype=weight.dtype, device=dev) if need_dwdb else None
    db = torch.empty(D, dtype=weight.dtype, device=dev) if need_dwdb and has_bias else None
    if N == 0 or D == 0:  # no rows: dw and db are empty sums
        return dx, None if dw is None else dw.zero_(), None if db is None else db.zero_()
    ptrs = x2.data_ptr() | dy2.data_ptr() | weight.data_ptr()
    aligned = (ptrs | (0 if dx is None else dx.data_ptr())) % 16 == 0
    floats = _bwd_scratch(N, D, _DTYPES[x2.dtype], _DTYPES[weight.dtype], aligned)
    if floats < 0:
        raise ValueError(f"{name} backward: the kernel takes no ({N}, {D}) "
                         f"{x2.dtype} rows with a {weight.dtype} weight")
    partial = torch.empty(floats, dtype=torch.float32, device=dev) if need_dwdb else None
    rc = _kernels.library().unicore_fused_norm_bwd(
        x2.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dy2.data_ptr(), _kernels.ptr(dx), _kernels.ptr(dw), _kernels.ptr(db),
        _kernels.ptr(partial), floats if need_dwdb else 0, N, D, int(rms),
        _DTYPES[x2.dtype], _DTYPES[weight.dtype], _kernels.stream_handle(dev),
    )
    _kernels.check(rc, f"{name} backward")
    if need_dx:
        DX_LAUNCHES.add()
    if need_dwdb:
        DWDB_LAUNCHES.add()
    return dx, dw, db


class _FusedNorm(torch.autograd.Function):
    """The kernels with their gradient: residuals are x, w and the fp32
    statistics, as the JAX ``_fused_norm_fwd`` keeps them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, rms, name):
        y, mean, rstd = _launch_fwd(x, weight, bias, eps, rms, True, name)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.rms, ctx.name, ctx.has_bias = rms, name, bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dy2 = dy.to(x2.dtype).reshape(x2.shape).contiguous()
        need_dx = ctx.needs_input_grad[0]
        need_dwdb = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        if not (need_dx or need_dwdb):
            return None, None, None, None, None, None
        dx, dw, db = _launch_bwd(x2, weight, mean, rstd, dy2, ctx.rms, ctx.has_bias,
                                 need_dx, need_dwdb, ctx.name)
        return None if dx is None else dx.view(dy.shape), dw, db, None, None, None


def _fused_norm(x, weight, bias, eps: float, rms: bool):
    if x.device.type == "cpu":
        return fused_norm_plain(x, weight, bias, eps, rms)
    name = "fused_rms_norm" if rms else "fused_layer_norm"
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or (
            bias is not None and bias.requires_grad)):
        return _FusedNorm.apply(x, weight, bias, eps, rms, name)
    return _launch_fwd(x, weight, bias, eps, rms, False, name)[0]


def fused_layer_norm(x, weight, bias, eps: float = 1e-5):
    """Fused LayerNorm over the last dim: y = (x - mu) * rstd * w + b."""
    return _fused_norm(x, weight, bias, eps, False)


def fused_rms_norm(x, weight, eps: float = 1e-6):
    """Fused RMSNorm over the last dim: y = x * rsqrt(mean(x^2)) * w."""
    return _fused_norm(x, weight, None, eps, True)


# ---------------------------------------------------------------------------
# the quantized-input forward
# ---------------------------------------------------------------------------

def quant_layer_norm_plain(x_q, x_scale, weight, bias, eps: float = 1e-5,
                           out_dtype=torch.float32):
    """The kernel's function in plain PyTorch (the JAX
    ``quant_layer_norm_reference``): ``x_q`` dequantized in fp32
    (``x_q * x_scale``, a scalar or (D,) scale), then the two-pass LayerNorm
    with fp32 statistics, ``* weight + bias``, cast to ``out_dtype``."""
    x = x_q.float() * x_scale
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(out_dtype)


def quant_layer_norm_kernel(x_q, x_scale, weight, bias, eps: float = 1e-5):
    """The CUDA kernel on card tensors: int8 ``x_q`` (..., D), fp32
    ``x_scale`` of one element or (D,), fp32 weight and bias (D,); fp32 out.
    Raises on anything it does not take."""
    D = x_q.shape[-1]
    if x_q.dtype != torch.int8:
        raise ValueError(f"quant_layer_norm kernel: int8 input only, got {x_q.dtype}")
    if x_scale.dtype != torch.float32 or x_scale.numel() not in (1, D):
        raise ValueError(
            f"quant_layer_norm: scale must be fp32 with 1 or {D} elements, got "
            f"{x_scale.dtype} {tuple(x_scale.shape)}"
        )
    for what, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (D,):
            raise ValueError(f"quant_layer_norm: {what} must be fp32 of shape ({D},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    x2 = x_q.reshape(-1, D).contiguous()
    scale = x_scale.reshape(-1).contiguous()
    _kernels.require_cuda("quant_layer_norm", x2, scale, weight, bias)
    y = torch.empty(x2.shape, dtype=torch.float32, device=x2.device)
    if x2.shape[0] == 0 or D == 0:
        return y.view(x_q.shape)
    rc = _kernels.library().unicore_quant_layer_norm_fwd(
        x2.data_ptr(), scale.data_ptr(), int(scale.numel() == D and D > 1),
        weight.data_ptr(), bias.data_ptr(), y.data_ptr(), x2.shape[0], D,
        float(eps), _kernels.stream_handle(x2.device),
    )
    _kernels.check(rc, "quant_layer_norm")
    QUANT_LAUNCHES.add()
    return y.view(x_q.shape)
