"""Full-row attention for moderate sequence lengths (L <= 1024)
(counterpart of ``unicore_tpu/ops/attention_fullrow.py``; this slice ports
the forward, whose TPU kernel is ``_fwd_kernel``).

:func:`fullrow_attention` computes softmax(q k^T * scale + bias, key mask) v
with q, k, v in (B, H, L, D) and the one-shot full-row softmax, where a
fully-masked row gives zeros.  A CPU tensor goes through
:func:`fullrow_attention_plain`, the same function in plain PyTorch with
the same casts; a CUDA tensor goes through the hand-written kernel
``csrc/attention_fullrow.cu`` — or raises.  There is no fallback between
the two.

:func:`supported` is the JAX package's gate copied verbatim, budget
arithmetic included, so both packages route every shape to the same
kernel.  Its VMEM budget is the TPU's, kept only so the routing agrees.
"""

from typing import Optional

import torch

from . import _kernels

#: the TPU kernel's limits (unicore_tpu/ops/_pallas.py), kept for routing
MAX_ROW = 1024
_VMEM_BUDGET = 12 * 1024 * 1024
#: masked scores (ops/flash_attention.py NEG_INF)
NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = _kernels.counter("fullrow_attention_fwd")


class KernelGeometryError(ValueError):
    """A kernel was handed a shape outside its gate."""


def supported(Lq, Lk, D, bias_batch, has_bias=None) -> bool:
    if has_bias is None:
        has_bias = bias_batch is not None
    # the backward's FIXED VMEM footprint (bias block + db scratch/output +
    # fp32 score/probability temporaries) must fit even at group=1 —
    # otherwise _auto_group bottoms out and Mosaic fails at compile time
    # instead of this gate routing the shape to the online kernel
    fixed = ((3 if has_bias else 0) + 4) * Lq * Lk * 4
    per_g1 = 2 * 8 * max(Lq, Lk) * D * 4
    return (
        Lq % 128 == 0
        and Lk % 128 == 0
        and Lq <= MAX_ROW
        and Lk <= MAX_ROW
        and D <= 128
        and bias_batch in (None, 1)
        and fixed + per_g1 <= _VMEM_BUDGET
    )


def _softmax_row(s, kvm):
    """One-shot fp32 softmax over the last dim; fully-masked rows -> zeros
    (the TPU kernel's ``_softmax_row``)."""
    if kvm is not None:
        s = torch.where(kvm, NEG_INF, s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if kvm is not None:
        p = torch.where(kvm, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    return p * torch.where(l > 0.0, 1.0 / l, 0.0)


def fullrow_attention_plain(q, k, v, bias=None, kv_mask=None,
                            sm_scale: float = 1.0):
    """The kernel's function in plain PyTorch.  ``bias`` (1, 1|H, Lq, Lk),
    ``kv_mask`` (B, Lk) int, nonzero = masked out."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    kvm = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    p = _softmax_row(s, kvm)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _launch(q, k, v, bias, kv_mask, sm_scale):
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"fullrow_attention: q/k/v must share one of fp32/bf16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if tuple(k.shape) != (B, H, Lk, D) or tuple(v.shape) != (B, H, Lk, D):
        raise ValueError(
            f"fullrow_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    if bias is not None and bias.dtype != torch.float32:
        raise ValueError(f"fullrow_attention: bias must be fp32, got {bias.dtype}")
    if kv_mask is not None:
        if kv_mask.dtype != torch.int32 or tuple(kv_mask.shape) != (B, Lk):
            raise ValueError(
                f"fullrow_attention: key mask must be int32 ({B}, {Lk}), got "
                f"{kv_mask.dtype} {tuple(kv_mask.shape)}"
            )
    _kernels.require_cuda("fullrow_attention", q, k, v, bias, kv_mask)
    o = torch.empty_like(q)
    lib = _kernels.library()
    rc = lib.unicore_fullrow_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if kv_mask is None else kv_mask.data_ptr(),
        o.data_ptr(), B, H, Lq, Lk, D,
        1 if bias is None else bias.shape[1], float(sm_scale),
        _DTYPES[q.dtype], _kernels.stream_handle(q.device),
    )
    _kernels.check(rc, "fullrow_attention")
    LAUNCHES.add()
    return o


def fullrow_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """softmax(q k^T * scale + bias, mask) v with q, k, v in (B, H, L, D).

    Requirements (checked by ``supported``): Lq, Lk multiples of 128 and
    <= 1024, D <= 128, bias batch dim 1.  ``bias``: (1|omitted, 1|H, Lq,
    Lk) additive.  ``kv_padding_mask``: (B, Lk), nonzero = masked out."""
    if bias is not None:
        if bias.ndim == 3:
            bias = bias[None]
        if bias.ndim != 4 or bias.shape[0] != 1:
            raise KernelGeometryError(
                f"fullrow_attention bias must be (1, 1|H, Lq, Lk), "
                f"got shape {tuple(bias.shape)}"
            )
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if not supported(Lq, Lk, D, None if bias is None else bias.shape[0]):
        raise KernelGeometryError(
            f"fullrow_attention refused q={tuple(q.shape)} "
            f"k={tuple(k.shape)}: needs Lq/Lk 128-multiples <= {MAX_ROW}, "
            "D <= 128, bias batch 1, and a group=1 footprint inside the "
            "budget — such shapes go to flash attention"
        )
    if dropout_rate != 0.0:
        raise NotImplementedError(
            "fullrow_attention with dropout: the in-kernel dropout of "
            "unicore_tpu/ops/attention_fullrow.py _fwd_kernel is not ported "
            "yet (it comes with the backward kernel in the training slice)"
        )
    if kv_padding_mask is not None:
        kv_padding_mask = kv_padding_mask.to(torch.int32)
    if q.device.type == "cpu":
        return fullrow_attention_plain(q, k, v, bias, kv_padding_mask, sm_scale)
    if bias is not None:
        bias = bias.contiguous()
    if kv_padding_mask is not None:
        kv_padding_mask = kv_padding_mask.contiguous()
    return _launch(q, k, v, bias, kv_padding_mask, sm_scale)
