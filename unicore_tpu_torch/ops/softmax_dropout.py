"""Fused softmax(+mask)(+bias)(+dropout) (counterpart of
``unicore_tpu/ops/softmax_dropout.py``; the eval path is ported: training
dropout, whose TPU kernel is the Evoformer slice's, raises
``NotImplementedError``).

The JAX package dispatches between a jnp composition and a Pallas kernel
(``ops/softmax_dropout_pallas.py``): on a TPU, mode ``auto`` takes the
kernel whenever its geometry plan accepts the call.  Here a CPU tensor
runs :func:`softmax_dropout_reference`, the plain composition; a CUDA
tensor runs it only where the JAX package would NOT have sent the call to
its kernel, and otherwise raises ``NotImplementedError`` naming that
kernel, which is not ported yet.  The softmax runs in fp32 whatever the
input type.
"""

from typing import Optional, Tuple

import torch

#: the Pallas kernel's geometry limits (ops/softmax_dropout_pallas.py)
_MAX_L = 8192
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


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
    rows_in = 1
    for s in input_shape[:-2]:
        rows_in *= s
    rows_x = 1
    for s in x.shape[:-2]:
        rows_x *= s
    if rows_in % rows_x == 0:
        x = x.reshape((rows_x,) + tuple(x.shape[-2:]))
        x = x.repeat(rows_in // rows_x, 1, 1)
        return x.reshape(input_shape)
    raise ValueError(
        f"mask/bias shape {tuple(x.shape)} not broadcastable to input "
        f"{input_shape}"
    )


def _plan_extra(shape: Tuple[int, ...], ishape: Tuple[int, ...]) -> bool:
    """Whether the Pallas kernel could express this mask/bias layout
    (``softmax_dropout_pallas.plan_extra`` returning a plan)."""
    if len(shape) > len(ishape):
        return False
    padded = (1,) * (len(ishape) - len(shape)) + tuple(shape)
    if all(p == d or p == 1 for p, d in zip(padded, ishape)):
        return True
    if padded[-2:] != tuple(ishape[-2:]):
        return False
    rows_in = 1
    for d in ishape[:-2]:
        rows_in *= d
    rows_x = 1
    for d in padded[:-2]:
        rows_x *= d
    return rows_x != 0 and rows_in % rows_x == 0


def kernel_would_run(input_shape, input_dtype, mask, bias) -> bool:
    """Whether the JAX package on a TPU (mode ``auto``) would send this call
    to its Pallas kernel (``softmax_dropout_pallas.pallas_plan``)."""
    input_shape = tuple(input_shape)
    if len(input_shape) < 2:
        return False
    M, L = input_shape[-2], input_shape[-1]
    R = 1
    for d in input_shape[:-2]:
        R *= d
    if R == 0 or M == 0 or L == 0:
        return False
    if input_dtype not in _KERNEL_DTYPES:
        return False
    if L > _MAX_L or L % 128 != 0 or M % 8 != 0:
        return False
    return all(
        x is None or _plan_extra(tuple(x.shape), input_shape)
        for x in (mask, bias)
    )


def softmax_dropout_reference(
    input: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain composition (eval): fp32 softmax of input (+ mask)
    (+ bias), cast back to the input type."""
    x = input.float()
    if mask is not None:
        x = x + _expand_extra(mask.float(), x.shape)
    if bias is not None:
        x = x + _expand_extra(bias.float(), x.shape)
    return torch.softmax(x, dim=-1).to(input.dtype)


def softmax_dropout(
    input: torch.Tensor,
    dropout_prob: float,
    is_training: bool = True,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(input [+ mask] [+ bias]); dropout only in training, which
    is not ported yet."""
    if is_training and dropout_prob > 0.0:
        raise NotImplementedError(
            "softmax_dropout with training dropout is not ported yet: its "
            "TPU kernel (unicore_tpu/ops/softmax_dropout_pallas.py "
            "_fwd_kernel) comes with the Evoformer slice; pad sequences to "
            "128 (--seq-pad-multiple 128) to train through the full-row "
            "attention kernel"
        )
    if input.device.type != "cpu" and kernel_would_run(
        input.shape, input.dtype, mask, bias
    ):
        raise NotImplementedError(
            f"softmax_dropout on {tuple(input.shape)} {input.dtype}: the JAX "
            "package runs this geometry in its Pallas kernel "
            "(unicore_tpu/ops/softmax_dropout_pallas.py _fwd_kernel), which "
            "is not ported to CUDA yet"
        )
    return softmax_dropout_reference(input, mask=mask, bias=bias)
