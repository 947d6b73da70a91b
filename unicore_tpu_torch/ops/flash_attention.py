"""Flash (online-softmax) attention with a grouped bias, forward and
backward (counterpart of ``unicore_tpu/ops/flash_attention.py``, whose TPU
kernels are ``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel`` and
``_db_kernel``).

:func:`flash_attention` computes softmax(q k^T * scale + bias, key mask),
dropped out, times v, over (B, H, L, D), without ever holding a whole
(L, L) score matrix.  ``bias`` is GROUPED: (Bb, 1|H, Lq, Lk) with
B % Bb == 0, batch b reading group b // (B / Bb) -- Bb == 1 shared,
Bb == B per batch, and in between the Evoformer's layout, where the MSA
rows (or the pair rows) of one sample share that sample's slab.
``kv_padding_mask`` (B, Lk) is nonzero at masked keys; a row whose keys
are all masked gives exact zeros and zero gradients.

A CPU tensor goes through :func:`flash_attention_plain`, the function of
the JAX package's ``mha_reference`` plus dropout, in plain PyTorch
(autograd gives its gradient); a CUDA tensor goes through the hand-written
kernels of ``csrc/flash_attention.cu`` -- or raises.  There is no other
gate.  On a CUDA tensor the call is a :class:`torch.autograd.Function`, as
the JAX ``jax.custom_vjp`` ``_flash``: the forward kernel writes the output
and the fp32 row ``lse = m + log(max(l, 1e-37))``; the backward is two
launches on tensor cores, each recomputing p from lse: a query-major one
that computes ``di = rowsum(out * do)`` in fp32 and dq, and a key-major one
that computes dk, dv and -- from the same ds -- dbias, the fp32 sum of ds
over each group's B / Bb batches (and over the heads when the bias has
one), whose partial sums an ordered third launch adds where one block
does not hold a whole sum.  The bias may be fp32, or bf16 with bf16
q/k/v: the kernels read it in place and widen it on load (its type a
template argument), and dbias comes back in its type.
:func:`flash_attention_bwd_plain` is that backward in plain PyTorch with
the kernels' bf16 roundings (ds and the dropped p rounded to the inputs'
type before their products), for holding the kernels against it.

Dropout: the full-row kernels' Philox4x32-10 stream
(:func:`~unicore_tpu_torch.ops.attention_fullrow.philox_keep_plain`), keyed
on the int32 seed and counted from (key column / 4, query row, head,
batch), so a flash call and a full-row call with the same seed drop the
same probabilities.  The TPU's own bits cannot be reproduced.

Lengths must be multiples of 128, as the TPU kernel's ``_pick_block``
tiles them (the attention routers pad), and the head dim at most 128.
"""

from typing import Optional

import torch

from . import _kernels
from .attention_fullrow import (
    _DTYPES,
    NEG_INF,
    KernelGeometryError,
    _bias_dtype,
    _check,
    _dropout_args,
    philox_keep_plain,
    rounding_slack,
)

#: the TPU kernel's length tiling (unicore_tpu/ops/_pallas.py LANE)
TILE = 128
MAX_HEAD_DIM = 128

FWD_LAUNCHES = _kernels.counter("flash_attention_fwd")
DQ_LAUNCHES = _kernels.counter("flash_attention_dq")
DKV_LAUNCHES = _kernels.counter("flash_attention_dkv")
DB_LAUNCHES = _kernels.counter("flash_attention_db")


def _grouped(bias: torch.Tensor, B: int) -> torch.Tensor:
    """(Bb, Hb, Lq, Lk) -> (B, Hb, Lq, Lk): group g for its B / Bb
    batches (autograd sums the gradient back over them)."""
    return bias.repeat_interleave(B // bias.shape[0], dim=0)


def _scores(q, k, bias, kv_mask, sm_scale: float):
    """fp32 s = q k^T * scale + bias, NEG_INF at masked keys; and the
    (B, 1, 1, Lk) bool mask (None without one)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + _grouped(bias.float(), q.shape[0])
    kvm = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    if kvm is not None:
        s = torch.where(kvm, NEG_INF, s)
    return s, kvm


def _dropped(p, rate: float, seed: int):
    """keep ? p / (1 - rate) : 0 with the Philox mask; the keep mask too."""
    if rate == 0.0:
        return p, None
    B, H, Lq, Lk = p.shape
    keep = philox_keep_plain(B, H, Lq, Lk, seed, rate, p.device)
    return torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0), keep


def flash_attention_fwd_plain(q, k, v, bias=None, kv_mask=None, sm_scale: float = 1.0,
                              dropout_rate: float = 0.0, seed: int = 0):
    """(out, lse): the kernel's forward in plain PyTorch.  fp32 softmax with
    masked keys at 0 (a fully masked row gives zeros and lse ~ NEG_INF),
    Philox dropout, out in q's type, lse (B, H, Lq) fp32."""
    s, kvm = _scores(q, k, bias, kv_mask, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if kvm is not None:
        p = torch.where(kvm, 0.0, p)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    # 1 / l only where l > 0, so no inf reaches autograd
    p = p * torch.where(l > 0.0, 1.0 / torch.where(l > 0.0, l, 1.0), 0.0)
    p, _ = _dropped(p, dropout_rate, seed)
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_attention_plain(q, k, v, bias=None, kv_mask=None, sm_scale: float = 1.0,
                          dropout_rate: float = 0.0, seed: int = 0):
    """The kernels' function in plain PyTorch (autograd gives its
    gradient): ``mha_reference`` of the JAX package plus dropout."""
    return flash_attention_fwd_plain(q, k, v, bias, kv_mask, sm_scale,
                                     dropout_rate, seed)[0]


def bwd_plain_terms(q, k, v, bias, kv_mask, out, lse, do, sm_scale: float = 1.0,
                    dropout_rate: float = 0.0, seed: int = 0):
    """The backward kernels' intermediates in plain PyTorch: (pd, ds32,
    ds).  p = exp(s - lse), 0 at masked keys; dp = do v^T dropped as p;
    ``ds32 = p * (dp - di)``, di = rowsum(out * do) in fp32, 0 at masked
    keys, is what dbias sums; ``pd`` (the dropped p) and ``ds`` are
    rounded to the inputs' type, as they enter the products."""
    s, kvm = _scores(q, k, bias, kv_mask, sm_scale)
    p = torch.exp(s - lse[..., None])
    if kvm is not None:
        p = torch.where(kvm, 0.0, p)
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    pd, keep = _dropped(p, dropout_rate, seed)
    if keep is not None:
        dp = torch.where(keep, dp * (1.0 / (1.0 - dropout_rate)), 0.0)
    di = (out.float() * dof).sum(-1, keepdim=True)
    ds32 = p * (dp - di)
    if kvm is not None:
        ds32 = torch.where(kvm, 0.0, ds32)
    return pd.to(q.dtype).float(), ds32, ds32.to(q.dtype).float()


def _reduce_db(ds32, bias):
    """fp32 ds summed over each bias group's batches (and heads when Hb == 1)."""
    Bb, Hb = bias.shape[0], bias.shape[1]
    B, H, Lq, Lk = ds32.shape
    db = ds32.reshape(Bb, B // Bb, H, Lq, Lk).sum(1)
    return db.sum(1, keepdim=True) if Hb == 1 else db


def flash_attention_bwd_plain(q, k, v, bias, kv_mask, out, lse, do,
                              sm_scale: float = 1.0, dropout_rate: float = 0.0,
                              seed: int = 0):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv in the
    inputs' type, dbias fp32 or None), from the forward's ``out`` and
    ``lse``.  For bf16 inputs ds and the dropped p are rounded to bf16
    before their products, as in the TPU ``_dq_kernel`` / ``_dkv_kernel``;
    autograd of :func:`flash_attention_plain` rounds nothing there.  At
    fp32 the two are the same function."""
    pd, ds32, ds = bwd_plain_terms(q, k, v, bias, kv_mask, out, lse, do,
                                   sm_scale, dropout_rate, seed)
    dq = (sm_scale * torch.matmul(ds, k.float())).to(q.dtype)
    dk = (sm_scale * torch.matmul(ds.transpose(-1, -2), q.float())).to(k.dtype)
    dv = torch.matmul(pd.transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv, None if bias is None else _reduce_db(ds32, bias)


def bwd_rounding_slack(q, k, v, bias, kv_mask, out, lse, do, sm_scale: float = 1.0,
                       dropout_rate: float = 0.0, seed: int = 0):
    """Per element of (dq, dk, dv) before their cast: how far the roundings
    of pd and ds to bf16 can move it between two computations of
    :func:`flash_attention_bwd_plain`'s function whose fp32 values differ
    in the last bits (the kernels and the plain version): one bf16 ulp
    (2**-7 of the magnitude) of each product term.  Zero for fp32."""
    if q.dtype != torch.bfloat16:
        return (0.0, 0.0, 0.0)
    pd, _, ds = bwd_plain_terms(q, k, v, bias, kv_mask, out, lse, do, sm_scale,
                                dropout_rate, seed)
    return rounding_slack(q, k, do, pd, ds, sm_scale)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _geom(q, k, bias, sm_scale, rate, seed):
    """The C entry points' trailing arguments, before dtype and stream."""
    B, H, Lq, D = q.shape
    Bb, Hb = (1, 1) if bias is None else (bias.shape[0], bias.shape[1])
    return (B, H, Lq, k.shape[2], D, Bb, Hb, float(sm_scale),
            *_dropout_args(rate, seed), _DTYPES[q.dtype], _bias_dtype(bias),
            _kernels.stream_handle(q.device))


def _launch_fwd(q, k, v, bias, kv_mask, sm_scale, rate, seed):
    B, H, Lq, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    rc = _kernels.library().unicore_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _kernels.ptr(bias),
        _kernels.ptr(kv_mask), o.data_ptr(), lse.data_ptr(),
        *_geom(q, k, bias, sm_scale, rate, seed),
    )
    _kernels.check(rc, "flash_attention")
    FWD_LAUNCHES.add()
    return o, lse


def _launch_dq(q, k, v, bias, kv_mask, lse, out, do, sm_scale, rate, seed):
    """The query-major launch: (dq, di), di = rowsum(out * do) (B, H, Lq)
    fp32 for :func:`_launch_dkv`."""
    dq = torch.empty_like(q)
    di = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    rc = _kernels.library().unicore_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _kernels.ptr(bias),
        _kernels.ptr(kv_mask), lse.data_ptr(), out.data_ptr(), do.data_ptr(),
        dq.data_ptr(), di.data_ptr(), *_geom(q, k, bias, sm_scale, rate, seed),
    )
    _kernels.check(rc, "flash_attention dq")
    DQ_LAUNCHES.add()
    return dq, di


def _launch_dkv(q, k, v, bias, kv_mask, lse, di, do, sm_scale, rate, seed,
                need_db: bool = False):
    """The key-major launch: (dk, dv, dbias), dbias (Bb, Hb, Lq, Lk) fp32
    from the same ds when ``need_db`` (its partial sums added by the
    ordered reduction the C entry launches after it), else None."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _kernels.library()
    partial = db = None
    if need_db:
        if bias is None:
            raise ValueError("flash_attention dk/dv: dbias asked for without a bias")
        B, H, Lq, D = q.shape
        floats = lib.unicore_flash_attention_dkv_scratch(
            B, H, Lq, k.shape[2], D, bias.shape[0], bias.shape[1], _DTYPES[q.dtype],
            _bias_dtype(bias))
        if floats < 0:
            raise RuntimeError(f"flash_attention dk/dv: no dbias plan for q={tuple(q.shape)} "
                               f"bias={tuple(bias.shape)}")
        if floats:
            partial = torch.empty(floats, dtype=torch.float32, device=q.device)
        db = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    rc = lib.unicore_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _kernels.ptr(bias),
        _kernels.ptr(kv_mask), lse.data_ptr(), di.data_ptr(), do.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _kernels.ptr(partial), _kernels.ptr(db),
        *_geom(q, k, bias, sm_scale, rate, seed),
    )
    _kernels.check(rc, "flash_attention dk/dv/dbias")
    DKV_LAUNCHES.add()
    if need_db:
        DB_LAUNCHES.add()
    return dk, dv, db


class _FlashAttention(torch.autograd.Function):
    """The kernels with their gradient; residuals are the inputs, the seed,
    the output and lse, as the JAX ``_flash_fwd`` keeps them."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_mask, sm_scale, rate, seed):
        out, lse = _launch_fwd(q, k, v, bias, kv_mask, sm_scale, rate, seed)
        ctx.save_for_backward(q, k, v, bias, kv_mask, out, lse)
        ctx.sm_scale, ctx.rate, ctx.seed = sm_scale, rate, seed
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, kv_mask, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        rest = (ctx.sm_scale, ctx.rate, ctx.seed)
        dq, di = _launch_dq(q, k, v, bias, kv_mask, lse, out, do, *rest)
        dk, dv, db = _launch_dkv(q, k, v, bias, kv_mask, lse, di, do, *rest,
                                 need_db=bias is not None and ctx.needs_input_grad[3])
        if db is not None:  # the fp32 sums in the bias's type
            db = db.to(bias.dtype)
        return dq, dk, dv, db, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    kv_padding_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_seed: int = 0,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Online-softmax attention: dropout(softmax(q k^T * scale + bias,
    mask)) v over q, k, v (B, H, L, D).

    ``bias``: (Bb, 1|H, Lq, Lk) (or rank 3, one group) with B % Bb == 0,
    grouped as the module docstring says.  ``kv_padding_mask``: (B, Lk),
    nonzero = masked out.  ``dropout_seed``: the int32 that keys the
    dropout mask.  Lq and Lk multiples of 128, D <= 128."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if bias is not None:
        if bias.ndim == 3:
            bias = bias[None]
        if bias.ndim != 4:
            raise KernelGeometryError(
                f"bias must be rank 3 or 4, got shape {tuple(bias.shape)}")
        if B % bias.shape[0] != 0:
            raise KernelGeometryError(
                f"bias batch {bias.shape[0]} must divide batch {B}")
        if bias.shape[1] not in (1, H):
            raise KernelGeometryError(f"bias heads {bias.shape[1]} must be 1 or {H}")
        if tuple(bias.shape[2:]) != (Lq, Lk):
            raise KernelGeometryError(
                f"bias {tuple(bias.shape)} does not match Lq={Lq}, Lk={Lk}")
    if Lq % TILE or Lk % TILE or not 0 < D <= MAX_HEAD_DIM:
        raise KernelGeometryError(
            f"flash_attention refused q={tuple(q.shape)} k={tuple(k.shape)}: "
            f"needs Lq, Lk multiples of {TILE} (the router pads) and "
            f"D <= {MAX_HEAD_DIM}"
        )
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash_attention: dropout rate {dropout_rate} outside [0, 1)")
    if kv_padding_mask is not None:
        kv_padding_mask = kv_padding_mask.to(torch.int32)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, kv_padding_mask, sm_scale,
                                     dropout_rate, dropout_seed)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None:
        bias = bias.contiguous()
    if kv_padding_mask is not None:
        kv_padding_mask = kv_padding_mask.contiguous()
    _check(q, k, v, bias, kv_padding_mask, "flash_attention")
    return _FlashAttention.apply(q, k, v, bias, kv_padding_mask, float(sm_scale),
                                 float(dropout_rate), int(dropout_seed))
