"""Fused softmax(+mask)(+bias)(+dropout), forward and backward (counterpart
of ``unicore_tpu/ops/softmax_dropout.py`` and
``unicore_tpu/ops/softmax_dropout_pallas.py``, whose TPU kernels are
``_fwd_kernel`` and ``_bwd_kernel``).

:func:`softmax_dropout` routes as the JAX package routes on a TPU:

- a shape its Pallas kernel takes (:func:`kernel_would_run`, the JAX
  ``pallas_plan``: last dim a multiple of 128 up to 8192, rows a multiple
  of 8, fp32/bf16, an expressible mask/bias layout) runs the hand-written
  kernels of ``csrc/softmax_dropout.cu`` on a CUDA tensor -- or raises --
  and :func:`softmax_dropout_plain`, the same function in plain PyTorch
  with the same casts and the same Philox mask, on a CPU tensor;
- any other shape runs :func:`softmax_dropout_reference`, the plain
  composition, on either device: the JAX package runs its jnp composition
  there (``softmax_dropout_reference``), so this is the JAX route, not a
  fallback.  Its dropout mask is drawn from the caller's
  :class:`~unicore_tpu_torch.modules.dropout.DropoutRng`, never from the
  global generator.

On a CUDA tensor the kernel route is a :class:`torch.autograd.Function`, as
the JAX ``jax.custom_vjp`` ``_sd``: its residuals are x, mask, bias and the
int32 seed; the backward kernel recomputes p and regenerates the keep mask
(neither is stored) and writes the fp32 ``ds``; dx is ``ds`` cast to x's
type and the mask/bias gradients are fp32 sums of ``ds`` over their
broadcast dims, cast to their types (the JAX ``_grad_reduce``).

Roundings, as the JAX kernel's: the softmax is fp32 whatever the input
type; the forward casts p to the output type, then divides kept values by
``1 - rate`` rounded to the output type and casts again (JAX's ``y / (1.0
- rate)`` on the cast ``y``); the backward works in fp32 on the recomputed
p with ``dp = keep ? dy * (1 / (1 - rate)) : 0``
(:func:`softmax_dropout_bwd_plain` is that backward in plain PyTorch).

The forward kernel also takes a quantized input (the JAX kernel's
``scale_ref`` variant): :func:`quant_softmax_dropout_kernel` runs it on int8
or int32 scores dequantized by one fp32 scale read on the device, fp32 out,
no gradient; ``ops/quant_softmax_dropout.py`` routes to it.

Dropout keeps an element when the Philox4x32-10 bits of the counter
(col / 4, m, r, 0), keyed on the int32 seed, are at least
``min(int(rate * 2**32), 2**32 - 1)``: the attention kernels' generator and
keep rule, with the input viewed as (R, M, L), so
``philox_keep_plain(1, R, M, L, seed, rate)`` is the mask.  The TPU's own
bits cannot be reproduced; kernel and plain version drop the same elements.
"""

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from . import _kernels
from .attention_fullrow import dropout_threshold, philox_keep_plain

#: the Pallas kernel's geometry limits (ops/softmax_dropout_pallas.py)
_MAX_L = 8192
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the quantized inputs of the forward kernel (the TPU kernel's ``scale_ref``
#: variant) and their codes in csrc/softmax_dropout.cu
_QUANT_DTYPES = {torch.int8: 2, torch.int32: 3}

FWD_LAUNCHES = _kernels.counter("softmax_dropout_fwd")
BWD_LAUNCHES = _kernels.counter("softmax_dropout_bwd")
QUANT_LAUNCHES = _kernels.counter("quant_softmax_dropout_fwd")


def _broadcastable_to(shape, target):
    if len(shape) != len(target):
        return False
    return all(s == t or s == 1 for s, t in zip(shape, target))


def _expand_extra(x: Optional[torch.Tensor], input_shape) -> Optional[torch.Tensor]:
    """Broadcast mask/bias to the input shape under the reference's rules:
    trailing dims must match or be 1; a leading batch dim ``b`` with
    ``input.size(0) % b == 0`` repeats (the Uni-Fold triangle-attention
    layout)."""
    if x is None:
        return None
    input_shape = tuple(input_shape)
    if x.ndim < len(input_shape):
        x = x.reshape((1,) * (len(input_shape) - x.ndim) + tuple(x.shape))
    if _broadcastable_to(tuple(x.shape), input_shape):
        return x.expand(input_shape)
    # reference semantics: flatten leading dims; input rows divisible by
    # extra rows
    rows_in = math.prod(input_shape[:-2])
    rows_x = math.prod(x.shape[:-2])
    if rows_in % rows_x == 0:
        x = x.reshape((rows_x,) + tuple(x.shape[-2:]))
        x = x.repeat(rows_in // rows_x, 1, 1)
        return x.reshape(input_shape)
    raise ValueError(
        f"mask/bias shape {tuple(x.shape)} not broadcastable to input "
        f"{input_shape}"
    )


def plan_extra(shape: Tuple[int, ...], ishape: Tuple[int, ...]):
    """The Pallas kernel's layout plan for one mask/bias operand
    (``softmax_dropout_pallas.plan_extra``): ``("bcast", padded)`` when
    every dim, left-padded with 1s, is 1 or full; ``("tile", rows)`` for
    whole (M, L) slabs whose flattened leading rows divide the input's;
    else None (the kernel cannot express it)."""
    if len(shape) > len(ishape):
        return None
    padded = (1,) * (len(ishape) - len(shape)) + tuple(shape)
    if all(p == d or p == 1 for p, d in zip(padded, ishape)):
        return ("bcast", padded)
    if padded[-2:] != tuple(ishape[-2:]):
        return None
    rows_in = math.prod(ishape[:-2])
    rows_x = math.prod(padded[:-2])
    if rows_x == 0 or rows_in % rows_x != 0:
        return None
    return ("tile", rows_x)


def kernel_would_run(input_shape, input_dtype, mask, bias) -> bool:
    """Whether the JAX package on a TPU (mode ``auto``) would send this call
    to its Pallas kernel (``softmax_dropout_pallas.pallas_plan``)."""
    input_shape = tuple(input_shape)
    if len(input_shape) < 2:
        return False
    M, L = input_shape[-2], input_shape[-1]
    R = math.prod(input_shape[:-2])
    if R == 0 or M == 0 or L == 0:
        return False
    if input_dtype not in _KERNEL_DTYPES:
        return False
    if L > _MAX_L or L % 128 != 0 or M % 8 != 0:
        return False
    return all(
        x is None or plan_extra(tuple(x.shape), input_shape) is not None
        for x in (mask, bias)
    )


def _keep_divisor(rate: float, dtype) -> float:
    """``1 - rate`` rounded to ``dtype``: the JAX kernel divides the cast
    probabilities by it in the output type."""
    return float(torch.tensor(1.0 - rate, dtype=torch.float32).to(dtype))


def _keep_scale(rate: float) -> float:
    """fp32 ``1 / (1 - rate)``: the JAX backward kernel's dropout scale."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _drop(y: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``keep ? y / (1 - rate) : 0`` on the cast probabilities ``y``, the
    quotient computed in fp32 and cast to y's type (XLA's bf16 division)."""
    div = _keep_divisor(rate, y.dtype)
    return torch.where(keep, y.float() / div, 0.0).to(y.dtype)


def _rows(shape) -> Tuple[int, int, int]:
    return math.prod(shape[:-2]), shape[-2], shape[-1]


def _with_extras(input, mask, bias) -> torch.Tensor:
    x = input.float()
    if mask is not None:
        x = x + _expand_extra(mask.float(), x.shape)
    if bias is not None:
        x = x + _expand_extra(bias.float(), x.shape)
    return x


def softmax_dropout_reference(input: torch.Tensor, rate: float = 0.0,
                              mask: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None,
                              rng=None) -> torch.Tensor:
    """The plain composition (the JAX ``softmax_dropout_reference``): fp32
    softmax of input (+ mask) (+ bias), cast back to the input type; at a
    nonzero ``rate``, dropout with a Bernoulli mask from ``rng.device``."""
    probs = torch.softmax(_with_extras(input, mask, bias), dim=-1).to(input.dtype)
    if rate > 0.0:
        keep = torch.empty(probs.shape, dtype=torch.float32, device=probs.device)
        keep = keep.bernoulli_(1.0 - rate, generator=rng.device).bool()
        probs = _drop(probs, keep, rate)
    return probs


def softmax_dropout_plain(input, rate: float = 0.0, mask=None, bias=None,
                          seed: int = 0) -> torch.Tensor:
    """The kernel's forward in plain PyTorch (autograd gives its gradient):
    fp32 softmax of input (+ mask) (+ bias), cast to the input type, then
    the Philox dropout of :func:`philox_keep_plain` at ``rate``."""
    y = torch.softmax(_with_extras(input, mask, bias), dim=-1).to(input.dtype)
    if rate > 0.0:
        R, M, L = _rows(input.shape)
        keep = philox_keep_plain(1, R, M, L, seed, rate, device=input.device)
        y = _drop(y, keep.view(input.shape), rate)
    return y


def softmax_dropout_bwd_plain(input, mask, bias, dy, rate: float = 0.0,
                              seed: int = 0) -> torch.Tensor:
    """The backward kernel's ``ds`` (fp32, input's shape) in plain PyTorch:
    p recomputed in fp32, ``dp = keep ? dy * (1 / (1 - rate)) : 0``,
    ``ds = p * (dp - rowsum(dp * p))``.  Autograd of
    :func:`softmax_dropout_plain` rounds dp to the output type on its way
    through the cast; at fp32 the two are the same function."""
    p = torch.softmax(_with_extras(input, mask, bias), dim=-1)
    dp = dy.float()
    if rate > 0.0:
        R, M, L = _rows(input.shape)
        keep = philox_keep_plain(1, R, M, L, seed, rate, device=input.device)
        dp = torch.where(keep.view(input.shape), dp * _keep_scale(rate), 0.0)
    return p * (dp - (dp * p).sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _extra_desc(x: torch.Tensor, plan, ishape) -> List[int]:
    """The extra's index map for the C entry points: ``[dtype, nlead,
    row_stride, col_stride, dims..., strides...]`` (``_extra_row_index``
    of the JAX kernel, as leading dims with element strides; the kernels
    refuse more than 8 leading dims)."""
    kind, info = plan
    M, L = ishape[-2], ishape[-1]
    if kind == "tile":
        dims = [math.prod(ishape[:-2]) // info, info]
        strides = [0, M * L]
        Mx, Lx = M, L
    else:
        padded = info
        Mx, Lx = padded[-2], padded[-1]
        dims = list(ishape[:-2]) or [1]
        lead_e = list(padded[:-2]) or [1]
        strides, step = [0] * len(dims), Mx * Lx
        for d in range(len(dims) - 1, -1, -1):
            strides[d] = 0 if lead_e[d] == 1 else step
            step *= lead_e[d]
    return [_DTYPES[x.dtype], len(dims), Lx if Mx > 1 else 0,
            1 if Lx > 1 else 0, *dims, *strides]


def _descs(x, mask, bias, plans):
    ishape = tuple(x.shape)
    out = []
    for ext, plan in zip((mask, bias), plans):
        if ext is None:
            out.append(None)
            continue
        d = _extra_desc(ext, plan, ishape)
        out.append((ctypes.c_longlong * len(d))(*d))
    return out


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it where its data does not start 16-byte aligned
    (a view at an odd offset): the kernels read and write every row as
    16-byte vectors."""
    if t is None or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _dropout_args(rate: float, seed: int):
    """(on, seed, threshold) as the C entry points take them."""
    if rate == 0.0:
        return 0, 0, 0
    return 1, int(seed) & 0xFFFFFFFF, dropout_threshold(rate)


def _launch_fwd(x, mask, bias, plans, rate: float, seed: int):
    R, M, L = _rows(x.shape)
    y = torch.empty_like(x)
    md, bd = _descs(x, mask, bias, plans)
    rc = _kernels.library().unicore_softmax_dropout_fwd(
        x.data_ptr(), _kernels.ptr(mask), md, _kernels.ptr(bias), bd,
        y.data_ptr(), R, M, L, *_dropout_args(rate, seed),
        _keep_divisor(rate, x.dtype), _DTYPES[x.dtype],
        _kernels.stream_handle(x.device),
    )
    _kernels.check(rc, "softmax_dropout")
    FWD_LAUNCHES.add()
    return y


def _launch_quant_fwd(x, scale, mask, bias, plans, rate: float, seed: int):
    R, M, L = _rows(x.shape)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    md, bd = _descs(x, mask, bias, plans)
    rc = _kernels.library().unicore_quant_softmax_dropout_fwd(
        x.data_ptr(), scale.data_ptr(), _kernels.ptr(mask), md, _kernels.ptr(bias), bd,
        y.data_ptr(), R, M, L, *_dropout_args(rate, seed),
        _keep_divisor(rate, torch.float32), _QUANT_DTYPES[x.dtype],
        _kernels.stream_handle(x.device),
    )
    _kernels.check(rc, "quant_softmax_dropout")
    QUANT_LAUNCHES.add()
    return y


def _launch_bwd(x, mask, bias, plans, dy, rate: float, seed: int):
    R, M, L = _rows(x.shape)
    ds = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    md, bd = _descs(x, mask, bias, plans)
    rc = _kernels.library().unicore_softmax_dropout_bwd(
        x.data_ptr(), _kernels.ptr(mask), md, _kernels.ptr(bias), bd,
        dy.data_ptr(), ds.data_ptr(), R, M, L, *_dropout_args(rate, seed),
        _keep_scale(rate), _DTYPES[x.dtype], _kernels.stream_handle(x.device),
    )
    _kernels.check(rc, "softmax_dropout backward")
    BWD_LAUNCHES.add()
    return ds


def _grad_reduce(ds: torch.Tensor, plan, extra: torch.Tensor) -> torch.Tensor:
    """The fp32 cotangent summed over the extra's broadcast dims, in the
    extra's shape and type (``softmax_dropout_pallas._grad_reduce``)."""
    kind, info = plan
    if kind == "tile":
        M, L = ds.shape[-2], ds.shape[-1]
        red = ds.reshape(-1, info, M, L).sum(0)
    else:
        axes = [i for i, (p, d) in enumerate(zip(info, ds.shape)) if p == 1 and d != 1]
        red = ds.sum(dim=axes, keepdim=True) if axes else ds
    return red.reshape(extra.shape).to(extra.dtype)


class _SoftmaxDropout(torch.autograd.Function):
    """The kernels with their gradient; residuals are x, mask, bias and the
    seed, as the JAX ``_sd_fwd`` keeps them."""

    @staticmethod
    def forward(ctx, x, mask, bias, plans, rate, seed):
        ctx.save_for_backward(x, mask, bias)
        ctx.plans, ctx.rate, ctx.seed = plans, rate, seed
        return _launch_fwd(x, mask, bias, plans, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        x, mask, bias = ctx.saved_tensors
        ds = _launch_bwd(x, mask, bias, ctx.plans, _aligned(dy.to(x.dtype).contiguous()),
                         ctx.rate, ctx.seed)
        dx = ds.to(x.dtype) if ctx.needs_input_grad[0] else None
        dmask = dbias = None
        if mask is not None and ctx.needs_input_grad[1]:
            dmask = _grad_reduce(ds, ctx.plans[0], mask)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = _grad_reduce(ds, ctx.plans[1], bias)
        return dx, dmask, dbias, None, None, None


def softmax_dropout_kernel(input, rate: float = 0.0, mask=None, bias=None,
                           seed: int = 0) -> torch.Tensor:
    """The CUDA kernels (with their gradient) on card tensors at a shape
    :func:`kernel_would_run` accepts; raises on anything else."""
    if not kernel_would_run(input.shape, input.dtype, mask, bias):
        raise ValueError(
            f"softmax_dropout kernel refused input {tuple(input.shape)} "
            f"{input.dtype} with mask "
            f"{None if mask is None else tuple(mask.shape)} / bias "
            f"{None if bias is None else tuple(bias.shape)}"
        )
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"softmax_dropout: dropout rate {rate} outside [0, 1)")
    ishape = tuple(input.shape)
    plans = tuple(None if t is None else plan_extra(tuple(t.shape), ishape)
                  for t in (mask, bias))
    x = _aligned(input.contiguous())
    mask, bias = (None if t is None else
                  _aligned((t if t.dtype in _DTYPES else t.float()).contiguous())
                  for t in (mask, bias))
    _kernels.require_cuda("softmax_dropout", x, mask, bias)
    return _SoftmaxDropout.apply(x, mask, bias, plans, float(rate), int(seed))


def quant_softmax_dropout_kernel(input_q, x_scale, rate: float = 0.0, mask=None,
                                 bias=None, seed: int = 0) -> torch.Tensor:
    """The forward kernel on a quantized input: int8 or int32 ``input_q``
    dequantized by the one-element fp32 ``x_scale`` (read on the device) in
    the row pass, at a shape :func:`kernel_would_run` accepts for fp32;
    fp32 out, no gradient.  Raises on anything else."""
    if input_q.dtype not in _QUANT_DTYPES:
        raise ValueError(f"quant_softmax_dropout kernel: int8/int32 input only, got "
                         f"{input_q.dtype}")
    if not kernel_would_run(input_q.shape, torch.float32, mask, bias):
        raise ValueError(
            f"quant_softmax_dropout kernel refused input {tuple(input_q.shape)} with "
            f"mask {None if mask is None else tuple(mask.shape)} / bias "
            f"{None if bias is None else tuple(bias.shape)}"
        )
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"quant_softmax_dropout: dropout rate {rate} outside [0, 1)")
    if x_scale.dtype != torch.float32 or x_scale.numel() != 1:
        raise ValueError("quant_softmax_dropout: the scale must be one fp32 value, got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)}")
    ishape = tuple(input_q.shape)
    plans = tuple(None if t is None else plan_extra(tuple(t.shape), ishape)
                  for t in (mask, bias))
    x = _aligned(input_q.contiguous())
    scale = x_scale.reshape(1).contiguous()
    mask, bias = (None if t is None else
                  _aligned((t if t.dtype in _DTYPES else t.float()).contiguous())
                  for t in (mask, bias))
    _kernels.require_cuda("quant_softmax_dropout", x, scale, mask, bias)
    return _launch_quant_fwd(x, scale, mask, bias, plans, float(rate), int(seed))


def softmax_dropout(
    input: torch.Tensor,
    dropout_prob: float,
    is_training: bool = True,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    rng=None,
    inplace: bool = True,  # kept for API parity; the port never writes in place
) -> torch.Tensor:
    """softmax(input [+ mask] [+ bias]) with dropout in training.

    ``rng`` (a :class:`DropoutRng`) is required when training with a
    nonzero rate: the kernel route draws its int32 seed from ``rng.host``,
    the plain composition its Bernoulli mask from ``rng.device``."""
    rate = float(dropout_prob) if is_training else 0.0
    if rate > 0.0 and rng is None:
        raise ValueError(
            "softmax_dropout needs a DropoutRng when training with dropout"
        )
    if not kernel_would_run(input.shape, input.dtype, mask, bias):
        return softmax_dropout_reference(input, rate, mask, bias, rng)
    seed = rng.kernel_seed() if rate > 0.0 else 0
    if input.device.type == "cpu":
        return softmax_dropout_plain(input, rate, mask, bias, seed)
    return softmax_dropout_kernel(input, rate, mask, bias, seed)
