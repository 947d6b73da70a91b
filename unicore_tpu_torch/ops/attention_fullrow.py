"""Full-row attention for moderate sequence lengths (L <= 1024), forward and
fused backward (counterpart of ``unicore_tpu/ops/attention_fullrow.py``,
whose TPU kernels are ``_fwd_kernel`` and ``_bwd_kernel``).

:func:`fullrow_attention` computes softmax(q k^T * scale + bias, key mask),
dropped out, times v, with q, k, v in (B, H, L, D) and the one-shot
full-row softmax, where a fully-masked row gives zeros.  A CPU tensor goes
through :func:`fullrow_attention_plain`, the same function in plain PyTorch
with the same casts, whose gradient autograd takes; a CUDA tensor goes
through the hand-written kernels of ``csrc/attention_fullrow.cu`` — or
raises.  There is no fallback between the two.

On a CUDA tensor the call is a :class:`torch.autograd.Function`, as the JAX
package's ``jax.custom_vjp``.  The bias may be fp32, or bf16 with bf16
q/k/v (a ``--bf16`` run casts the rel-pos table as the JAX trainer casts
every parameter): the kernels read it in place and widen it on load (its
type a template argument), and dbias, summed in fp32, comes back in the
bias's type, as the JAX ``_fullrow_bwd`` returns
``dbias.astype(bias.dtype)``.  Its residuals are the inputs, the dropout
seed, its own output and, unlike the JAX package's, the forward's fp32 row
statistics ``lse = m + log(l)`` (B, H, Lq), written only when a backward
will follow (:func:`_needs_backward`; the serving path writes none).  No
probabilities are saved: the backward's two kernels (dq and dbias
query-major, then dk and dv key-major) recompute ``p = exp(s - lse)`` and
regenerate the dropout mask.  :func:`fullrow_attention_bwd_plain` is that
backward in plain PyTorch, with the kernel's bf16 roundings, for holding
the kernel against it.

The kernels run their products on tensor cores; fp32 inputs as 3xTF32
(each operand split into two TF32 parts, three products), which
:func:`tf32_split_plain` emulates for the tests.

Dropout keeps a probability when its Philox4x32-10 bits, keyed on the int32
seed and counted from (key column / 4, query row, head, batch), are at
least ``min(int(rate * 2**32), 2**32 - 1)``, and scales kept values by
``1 / (1 - rate)`` — the TPU kernels' rule on another generator (the TPU's
own bits cannot be reproduced off the TPU).  :func:`philox_keep_plain`
computes the same bits in torch integer ops, so kernel and plain version
drop the same probabilities.

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

#: the kernels' type codes, of q/k/v and of the bias (fp16 attention takes
#: the plain composition in the JAX package, so no kernel sees it)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LAUNCHES = _kernels.counter("fullrow_attention_fwd")
BWD_LAUNCHES = _kernels.counter("fullrow_attention_bwd")

# Philox4x32-10 constants (Random123; csrc/common.cuh)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


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


def dropout_threshold(rate: float) -> int:
    """The uint32 keep threshold of the TPU kernels' ``_keep_mask``."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of ``a * m`` for int64 lanes ``a`` < 2**32
    and a 32-bit constant ``m``, without overflowing int64: ``m`` is split
    into 16-bit halves so no partial product reaches 2**49."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 counter words (they
    broadcast against each other) and a 64-bit key as two ints: the four
    uint32 output words, as ``csrc/common.cuh`` computes them."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_keep_plain(B: int, H: int, Lq: int, Lk: int, seed: int,
                      rate: float, device=None) -> torch.Tensor:
    """The kernels' dropout keep mask (B, H, Lq, Lk) bool, computed with
    torch int64 ops (lanes masked to 32 bits): the Philox4x32-10 bits of
    the counter (col // 4, row, h, b), word col % 4, key (seed, 0)."""
    if Lk % 4:
        raise ValueError(f"the dropout counter needs Lk % 4 == 0, got {Lk}")
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)  # noqa: E731
    words = philox4x32_10(
        ar(Lk // 4).view(1, 1, 1, -1), ar(Lq).view(1, 1, -1, 1),
        ar(H).view(1, -1, 1, 1), ar(B).view(-1, 1, 1, 1), int(seed) & _U32, 0,
    )
    thr, shape = dropout_threshold(rate), (B, H, Lq, Lk // 4)
    keep = torch.stack([(w >= thr).expand(shape) for w in words], dim=-1)
    return keep.reshape(B, H, Lq, Lk)


def tf32_split_plain(x: torch.Tensor):
    """The kernels' 3xTF32 split of an fp32 tensor: ``hi`` = x rounded to
    TF32 (10 mantissa bits, to nearest, ties away from zero: PTX
    ``cvt.rna.tf32.f32``, done here on the int32 view) and ``lo`` = the
    remainder ``x - hi`` rounded the same way.  ``hi_a hi_b + hi_a lo_b +
    lo_a hi_b`` is the product the kernels' tensor cores sum."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        bits = torch.where(torch.isfinite(t), (bits + 0x1000) & ~0x1FFF, bits)
        return bits.view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


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
                            sm_scale: float = 1.0, dropout_rate: float = 0.0,
                            seed: int = 0):
    """The kernel's function in plain PyTorch (autograd gives its
    gradient).  ``bias`` (1, 1|H, Lq, Lk), ``kv_mask`` (B, Lk) int,
    nonzero = masked out; dropout by :func:`philox_keep_plain`."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    kvm = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    p = _softmax_row(s, kvm)
    if dropout_rate > 0.0:
        B, H, Lq, Lk = p.shape
        keep = philox_keep_plain(B, H, Lq, Lk, seed, dropout_rate, p.device)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def fullrow_lse_plain(q, k, bias=None, kv_mask=None, sm_scale: float = 1.0):
    """The forward kernel's row statistics in plain PyTorch: ``lse = m +
    log(l)`` over each row's unmasked keys, fp32 (B, H, Lq); 0 for a row
    whose every key is masked (its p is 0 wherever it is read)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if kv_mask is not None:
        s = s.masked_fill((kv_mask != 0)[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(lse), lse, 0.0)


def bwd_plain_terms(q, k, v, bias, kv_mask, do, sm_scale: float = 1.0,
                    dropout_rate: float = 0.0, seed: int = 0):
    """The backward kernel's intermediates in plain PyTorch: (pd, ds32,
    ds).  p and dp are fp32; ``ds32 = p * (dp_keep - rowsum(pd * dp))``,
    zeroed on masked keys, is what dbias sums; ``pd`` (the dropped p) and
    ``ds`` are rounded to the inputs' type, as they enter the products."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()
    kvm = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    p = _softmax_row(s, kvm)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        B, H, Lq, Lk = p.shape
        keep = philox_keep_plain(B, H, Lq, Lk, seed, dropout_rate, p.device)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds32 = p * (dp - (p * dp).sum(-1, keepdim=True))
    if kvm is not None:
        ds32 = torch.where(kvm, 0.0, ds32)
    return pd.to(q.dtype).float(), ds32, ds32.to(q.dtype).float()


def fullrow_attention_bwd_plain(q, k, v, bias, kv_mask, do, sm_scale: float = 1.0,
                                dropout_rate: float = 0.0, seed: int = 0):
    """The backward kernel's function in plain PyTorch: (dq in q's type;
    dk, dv and dbias as the fp32 sums the kernel adds before it casts dk
    and dv).  For bf16 inputs, pd and ds are rounded to bf16 before their
    products, as in the TPU ``_bwd_kernel``; autograd of
    :func:`fullrow_attention_plain` rounds dp instead, through its cast of
    p.  At fp32 the two are the same function."""
    pd, ds32, ds = bwd_plain_terms(q, k, v, bias, kv_mask, do, sm_scale,
                                   dropout_rate, seed)
    dq = (sm_scale * torch.matmul(ds, k.float())).to(q.dtype)
    dk = sm_scale * torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(pd.transpose(-1, -2), do.float())
    db = None
    if bias is not None:
        db = ds32.sum(0, keepdim=True)
        if bias.shape[1] == 1:
            db = db.sum(1, keepdim=True)
    return dq, dk, dv, db


def bwd_rounding_slack(q, k, v, bias, kv_mask, do, sm_scale: float = 1.0,
                       dropout_rate: float = 0.0, seed: int = 0):
    """Per element of (dq, dk, dv) before their cast: how far the
    roundings of pd and ds to bf16 can move it between two computations of
    :func:`fullrow_attention_bwd_plain`'s function whose fp32 values differ
    in the last bits (the kernel and its plain version).  Each rounding
    may land one bf16 ulp (at most 2**-7 of the magnitude) apart, so an
    element may move by 2**-7 times the magnitude sum of its product terms.
    Zero for fp32 inputs, which round nothing."""
    if q.dtype != torch.bfloat16:
        return (0.0, 0.0, 0.0)
    pd, _, ds = bwd_plain_terms(q, k, v, bias, kv_mask, do, sm_scale,
                                dropout_rate, seed)
    return rounding_slack(q, k, do, pd, ds, sm_scale)


def rounding_slack(q, k, do, pd, ds, sm_scale: float):
    """(dq, dk, dv) slack of one bf16 ulp (2**-7) of each product term, from
    the backward's rounded ``pd`` and ``ds`` (the flash backward's too)."""
    ulp = 2.0 ** -7
    return (ulp * sm_scale * torch.matmul(ds.abs(), k.float().abs()),
            ulp * sm_scale * torch.matmul(ds.abs().transpose(-1, -2), q.float().abs()),
            ulp * torch.matmul(pd.abs().transpose(-1, -2), do.float().abs()))


def _check(q, k, v, bias, kv_mask, name="fullrow_attention"):
    """The C entry points' contract (the flash wrapper's too), else raise."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{name}: q/k/v must share one of fp32/bf16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )
    if tuple(k.shape) != (B, H, Lk, D) or tuple(v.shape) != (B, H, Lk, D):
        raise ValueError(
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do "
            f"not match q {tuple(q.shape)}"
        )
    if bias is not None and bias.dtype not in (torch.float32, q.dtype):
        raise ValueError(f"{name}: bias must be fp32, or bf16 with bf16 q/k/v, got "
                         f"{bias.dtype}")
    if kv_mask is not None:
        if kv_mask.dtype != torch.int32 or tuple(kv_mask.shape) != (B, Lk):
            raise ValueError(
                f"{name}: key mask must be int32 ({B}, {Lk}), got "
                f"{kv_mask.dtype} {tuple(kv_mask.shape)}"
            )
    _kernels.require_cuda(name, q, k, v, bias, kv_mask)


def _bias_dtype(bias) -> int:
    """The bias's type code for the C entry points (fp32 without a bias)."""
    return _DTYPES[torch.float32 if bias is None else bias.dtype]


def _dropout_args(rate: float, seed: int):
    """(on, seed, threshold, scale) as the C entry points take them."""
    if rate == 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed), dropout_threshold(rate), 1.0 / (1.0 - rate)


def _launch_fwd(q, k, v, bias, kv_mask, sm_scale, rate, seed, want_lse):
    """The forward kernel: (o, lse), lse (B, H, Lq) fp32 only when
    ``want_lse`` (a backward will follow), else None."""
    B, H, Lq, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    rc = _kernels.library().unicore_fullrow_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _kernels.ptr(bias),
        _kernels.ptr(kv_mask), o.data_ptr(), _kernels.ptr(lse), B, H, Lq,
        k.shape[2], D, 1 if bias is None else bias.shape[1], float(sm_scale),
        *_dropout_args(rate, seed), _DTYPES[q.dtype], _bias_dtype(bias),
        _kernels.stream_handle(q.device),
    )
    _kernels.check(rc, "fullrow_attention")
    LAUNCHES.add()
    return o, lse


def _launch_bwd(q, k, v, bias, kv_mask, o, do, lse, sm_scale, rate, seed, want_db):
    """The backward kernels (two launches, one count): dq in q's type; dk,
    dv as the fp32 sums the key-major kernel writes; dbias fp32 or None."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    dev = q.device
    dq = torch.empty_like(q)
    dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
    dv = torch.empty(v.shape, dtype=torch.float32, device=dev)
    di = torch.empty((B, H, Lq), dtype=torch.float32, device=dev)
    # dbias sums over the batch (and the heads when shared): fp32 adds
    db = torch.zeros(bias.shape, dtype=torch.float32, device=dev) if want_db else None
    rc = _kernels.library().unicore_fullrow_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _kernels.ptr(bias),
        _kernels.ptr(kv_mask), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _kernels.ptr(db), B, H, Lq, Lk, D,
        1 if bias is None else bias.shape[1], float(sm_scale),
        *_dropout_args(rate, seed), _DTYPES[q.dtype], _bias_dtype(bias),
        _kernels.stream_handle(dev),
    )
    _kernels.check(rc, "fullrow_attention backward")
    BWD_LAUNCHES.add()
    return dq, dk, dv, db


def _needs_backward(*tensors) -> bool:
    """Whether autograd will call the backward of this forward: grad mode
    on and an input that requires grad.  Only then does the forward write
    its row statistics."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _FullrowAttention(torch.autograd.Function):
    """The kernels with their gradient; residuals are the inputs, the seed,
    the output and the forward's row statistics (kept only when a backward
    will follow)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, sm_scale, rate, seed, need_bwd):
        o, lse = _launch_fwd(q, k, v, bias, kv_mask, sm_scale, rate, seed, need_bwd)
        if need_bwd:
            ctx.save_for_backward(q, k, v, bias, kv_mask, o, lse)
        ctx.sm_scale, ctx.rate, ctx.seed = sm_scale, rate, seed
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv, db = _launch_bwd(
            q, k, v, bias, kv_mask, o, do.to(q.dtype).contiguous(), lse,
            ctx.sm_scale, ctx.rate, ctx.seed,
            bias is not None and ctx.needs_input_grad[3],
        )
        if db is not None:
            db = db.to(bias.dtype)
        return dq, dk.to(k.dtype), dv.to(v.dtype), db, None, None, None, None, None


def fullrow_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    sm_scale: float = 1.0,
    dropout_seed: int = 0,
) -> torch.Tensor:
    """dropout(softmax(q k^T * scale + bias, mask)) v, q, k, v (B, H, L, D).

    Requirements (checked by ``supported``): Lq, Lk multiples of 128 and
    <= 1024, D <= 128, bias batch dim 1.  ``bias``: (1|omitted, 1|H, Lq,
    Lk) additive.  ``kv_padding_mask``: (B, Lk), nonzero = masked out.
    ``dropout_seed``: the int32 that keys the dropout mask."""
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
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"fullrow_attention: dropout rate {dropout_rate} "
                         "outside [0, 1)")
    if kv_padding_mask is not None:
        kv_padding_mask = kv_padding_mask.to(torch.int32)
    if q.device.type == "cpu":
        return fullrow_attention_plain(q, k, v, bias, kv_padding_mask, sm_scale,
                                       dropout_rate, dropout_seed)
    if bias is not None:
        bias = bias.contiguous()
    if kv_padding_mask is not None:
        kv_padding_mask = kv_padding_mask.contiguous()
    _check(q, k, v, bias, kv_padding_mask)
    return _FullrowAttention.apply(q, k, v, bias, kv_padding_mask,
                                   float(sm_scale), float(dropout_rate),
                                   int(dropout_seed),
                                   _needs_backward(q, k, v, bias))
