"""Single-query cache-reading attention, the decode step's kernel
(counterpart of ``unicore_tpu/ops/decode_attention.py``, whose TPU kernel is
``_decode_kernel``).

Incremental decode attends ONE query row per sequence against that
sequence's K/V cache: q is ``(B, H, D)``, pre-scaled; the gathered caches
are ``(B, H, L, D)`` (``L`` the cache-length bucket), in q's type, fp32
(a bf16 or fp16 model's step against the fp32 pool, as the JAX kernel reads
a bf16 query against an fp32 cache), or int8;
``positions[b]`` names the current token's row, and rows beyond it are dead
(pad junk or pages not yet written).  int8 caches come with per-(head,
channel) fp32 dequant scales ``(H, D)``, multiplied in as each row is read.
The bias row is any float type; every operand is read as fp32.  The output
is ``(B, H, D)`` in q's type.  Forward only: the cache read path never
trains.

A CPU tensor goes through :func:`decode_attention_plain`, the JAX package's
``decode_attention_reference`` in plain PyTorch; a CUDA tensor goes through
the hand-written kernel of ``csrc/decode_attention.cu`` — or raises.  There
is no fallback between the two.  The kernel splits the rows of each (b, h)
across :func:`choose_splits` blocks and combines their partials in the same
launch, through a scratch slab (``torch.empty``) and a per-device buffer of
arrival counters that every launch leaves at zero: one launch at a time
may use a device's counters, as the port's single stream does.  The TPU kernel's eligibility rule (L a
multiple of the cache type's sublane tile) is the TPU's tiling and is not
carried over: the CUDA kernel takes every L, and refuses only a head dim
that is not a multiple of 4 or is above 256, q types other than fp32,
bf16 and fp16, and caches of a 16-bit type other than q's.  The launches of
a bf16 q against fp32 caches count apart (``decode_attention_bf16q``), so a
bf16 model's served step shows which variant it ran; every other launch
counts as ``decode_attention``.
"""

from typing import Optional

import torch

from . import _kernels

#: finite stand-in for -inf: keeps masked rows NaN-free through softmax
NEG = -1e30
#: the kernel's limits: 4-element loads, at most 2 per lane of a warp
MAX_HEAD_DIM = 256

#: the kernel's q, cache and bias float types (the C entry point's codes)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 4}
LAUNCHES = _kernels.counter("decode_attention")
#: launches of the bf16-query variant: a bf16 q against fp32 caches
LAUNCHES_BF16Q = _kernels.counter("decode_attention_bf16q")

#: blocks a call aims for (several an SM of a 132-SM card), and the fewest
#: rows a block takes once the rows are split
TARGET_BLOCKS = 512
MIN_SPLIT_ROWS = 32

_COUNTERS = {}


def choose_splits(bh: int, L: int) -> int:
    """Blocks the kernel gives each (b, h): doubled from 1 while the
    ``bh * S`` blocks fall short of :data:`TARGET_BLOCKS` and each split
    keeps at least :data:`MIN_SPLIT_ROWS` of the ``L`` rows.  A function of
    the shape only (never of the positions): 8 at the served (8, 12, 512)
    step, 4 at the 128 bucket, 1 below 64 rows."""
    s = 1
    while bh * s < TARGET_BLOCKS and -(-L // (2 * s)) >= MIN_SPLIT_ROWS:
        s *= 2
    return s


def _counters(device, n: int) -> torch.Tensor:
    """The device's arrival counters (int32 zeros, at least ``n``)."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dequant (int8 caches) and an
    fp32 row softmax over the live cache prefix, rows past ``positions[b]``
    set to -1e30."""
    L = k_cache.shape[2]
    kf = k_cache.float()
    vf = v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[None, :, None, :]
    if v_scale is not None:
        vf = vf * v_scale.float()[None, :, None, :]
    s = torch.einsum("bhd,bhld->bhl", q.float(), kf)
    if bias is not None:
        s = s + bias.float()
    dead = (torch.arange(L, device=q.device)[None, None, :]
            > positions.to(torch.int64)[:, None, None])
    s = s.masked_fill(dead, NEG)
    # the query's own row is always live (positions[b] points at it), so
    # no fully-masked-row guard is needed
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,bhld->bhd", p, vf).to(q.dtype)


def _launch(q, k_cache, v_cache, positions, bias, k_scale, v_scale):
    B, H, L, D = k_cache.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: q dtype {q.dtype} unsupported (fp32/bf16/fp16)")
    if k_cache.dtype not in (torch.int8, q.dtype, torch.float32):
        raise NotImplementedError(
            f"decode_attention: caches of {k_cache.dtype} with q of {q.dtype}; the "
            "kernel takes caches of q's type, fp32 or int8"
        )
    if v_cache.dtype != k_cache.dtype or tuple(v_cache.shape) != (B, H, L, D):
        raise ValueError("decode_attention: k and v caches differ in type or shape")
    if D % 4 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"decode_attention: head dim {D} must be a multiple of 4 and at most "
            f"{MAX_HEAD_DIM} (the kernel loads 4 channels at a time, at most two "
            "loads per lane of a 32-lane warp)"
        )
    if tuple(q.shape) != (B, H, D) or tuple(positions.shape) != (B,):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)} / positions "
            f"{tuple(positions.shape)} do not fit caches {(B, H, L, D)}"
        )
    if positions.dtype != torch.int32:
        raise ValueError(f"decode_attention: positions must be int32, got {positions.dtype}")
    if bias is not None and (bias.dtype not in _DTYPES
                             or tuple(bias.shape) != (B, H, L)):
        raise ValueError(
            f"decode_attention: bias must be fp32, bf16 or fp16 (B, H, L) = {(B, H, L)}, "
            f"got {bias.dtype} {tuple(bias.shape)}"
        )
    for what, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s is not None and (s.dtype != torch.float32 or tuple(s.shape) != (H, D)):
            raise ValueError(
                f"decode_attention: {what} must be fp32 (H, D) = {(H, D)}, got "
                f"{s.dtype} {tuple(s.shape)}"
            )
    _kernels.require_cuda("decode_attention", q, k_cache, v_cache, positions, bias,
                          k_scale, v_scale)
    out = torch.empty_like(q)
    if B == 0 or H == 0 or L == 0:
        return out
    splits = choose_splits(B * H, L)
    partials = counters = None
    if splits > 1:
        partials = torch.empty(B * H * splits * (D + 2), dtype=torch.float32, device=q.device)
        counters = _counters(q.device, B * H)
    rc = _kernels.library().unicore_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), positions.data_ptr(),
        _kernels.ptr(bias), _kernels.ptr(k_scale), _kernels.ptr(v_scale),
        out.data_ptr(), _kernels.ptr(partials), _kernels.ptr(counters), B, H, L, D,
        _DTYPES[q.dtype], _DTYPES.get(k_cache.dtype, 0),
        _DTYPES[bias.dtype] if bias is not None else 0,
        int(k_cache.dtype == torch.int8), splits, _kernels.stream_handle(q.device),
    )
    _kernels.check(rc, "decode_attention")
    mixed = q.dtype == torch.bfloat16 and k_cache.dtype == torch.float32
    (LAUNCHES_BF16Q if mixed else LAUNCHES).add()
    return out


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    positions: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step of attention: ``softmax(q k^T + bias, live-mask) v``
    with ``q`` (B, H, D) pre-scaled, caches (B, H, L, D), ``positions``
    (B,) int32 naming each row's current token (each in [0, L): cache rows
    beyond it are masked out), ``bias`` (B, H, L) of any float type, or None.

    ``k_scale``/``v_scale`` (H, D) fp32: static per-(head, channel) dequant
    scales for int8 caches.  Scales must come paired with int8 caches and
    vice versa.  Every tensor must be contiguous."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if (k_cache.dtype == torch.int8) != (k_scale is not None):
        raise ValueError(
            f"int8 caches need dequant scales (cache dtype "
            f"{k_cache.dtype}, k_scale {'set' if k_scale is not None else 'None'})"
        )
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, positions, bias=bias,
                                      k_scale=k_scale, v_scale=v_scale)
    return _launch(q, k_cache, v_cache, positions, bias, k_scale, v_scale)
