"""Multi-head self-attention with pair-bias support (counterpart of
``unicore_tpu/modules/multihead_attention.py``).

Attention stays in the JAX package's (B, H, L, D) layout, and ``_attend``
routes exactly as the JAX package routes on a TPU:

- **kernel route** (lengths within the pad-waste limit, head dim a
  multiple of 8, fp32/bf16): pad to 128 and run
  ``ops/attention_fullrow.py`` when its ``supported()`` gate accepts the
  shape.  Shapes the JAX package would send to its online flash kernel
  (rows over 1024, per-batch bias) raise ``NotImplementedError``: that
  kernel is not ported yet, and nothing falls back to plain code.
- **fused-softmax route** (everything else): the attention matrix is
  materialized and ``ops/softmax_dropout.py`` takes the softmax.

The JAX package's ``return_attn`` consumers, its sequence-parallel (ring,
Ulysses), quantized and incremental-decode routes are not ported yet.
"""

import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch.ops.attention_fullrow import (
    fullrow_attention,
    supported as _fullrow_supported,
)
from unicore_tpu_torch.ops.softmax_dropout import softmax_dropout

logger = logging.getLogger(__name__)

_warned_fallbacks = set()


def _warn_flash_fallback(reason):
    """Say ONCE per reason that the fused-softmax route, which materializes
    the attention matrix, runs instead of the kernel."""
    if reason in _warned_fallbacks:
        return
    _warned_fallbacks.add(reason)
    logger.warning(
        f"attention kernel unavailable ({reason}); using the fused-softmax "
        "path, which materializes the full attention matrix"
    )


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _bias_to_bhll(bias, bsz, num_heads, tgt_len, src_len):
    """Materialized-broadcast bias for the fused-softmax path — accepts
    (B,H,Q,K), (H,Q,K), (B*H,Q,K), (G,Q,K) with B*H % G == 0, or (Q,K)."""
    if bias is None:
        return None
    target = (bsz, num_heads, tgt_len, src_len)
    if bias.ndim == 4:
        return bias.expand(target)
    if bias.ndim == 3:
        g = bias.shape[0]
        if g == num_heads:
            return bias[None].expand(target)
        if g == bsz * num_heads:
            return bias.reshape(target)
        if (bsz * num_heads) % g == 0:
            rep = (bsz * num_heads) // g
            return bias.repeat(rep, 1, 1).reshape(target)
    if bias.ndim == 2:
        return bias[None, None].expand(target)
    raise ValueError(f"unsupported attn bias shape {tuple(bias.shape)}")


def _bias_min_broadcast(bias, bsz, num_heads, tgt_len, src_len):
    """Minimal-copy bias layout for the kernel route: (1|B, 1|H, Q, K);
    broadcast dims stay size-1.  Returns None when the layout can't be
    expressed without materializing (the fused route then runs)."""
    if bias is None:
        return None
    if bias.ndim == 2:
        return bias[None, None]
    if bias.ndim == 3:
        g = bias.shape[0]
        if g == num_heads:
            return bias[None]
        if g == 1:
            return bias[None]
        if g == bsz * num_heads:
            return bias.reshape(bsz, num_heads, tgt_len, src_len)
        return None
    if bias.ndim == 4:
        Bb, Hb = bias.shape[0], bias.shape[1]
        if Bb in (1, bsz) and Hb in (1, num_heads):
            return bias
        return None
    return None


def _flash_pad(tgt_len, src_len):
    """Router-side padding to the kernel's 128-multiple tile sizes:
    (pad_q, pad_k).  Padded key columns are masked out, padded query rows
    are sliced off the output."""
    return (-tgt_len) % 128, (-src_len) % 128


def _flash_pad_waste_ok(tgt_len, src_len):
    """Padding must not waste more compute than the kernel saves (>37.5%
    rejected)."""
    pad_q, pad_k = _flash_pad(tgt_len, src_len)
    return (tgt_len + pad_q) * (src_len + pad_k) <= 1.6 * tgt_len * src_len


def _flash_grouped(q, k, v, bias, kvm, Lq, Lk, dropout_rate=0.0,
                   dropout_seed=0, try_fullrow=False):
    """Pad (N, H, L, hd) operands to the kernels' 128 tiles and run the
    full-row kernel when its gate accepts the shape and ``try_fullrow``.
    Any other shape belongs to the JAX package's online flash kernel,
    which is not ported yet.

    ``kvm``: (N, Lk) int, nonzero = masked OUT; ``bias``: (G, 1|H, Lq, Lk)
    or None."""
    N = q.shape[0]
    pad_q, pad_k = _flash_pad(Lq, Lk)
    if pad_q or pad_k:
        q = F.pad(q, (0, 0, 0, pad_q))
        k = F.pad(k, (0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, pad_k))
        if pad_k:  # only padded KEYS need masking out
            if kvm is None:
                kvm = torch.zeros((N, Lk), dtype=torch.int32, device=q.device)
            kvm = F.pad(kvm, (0, pad_k), value=1)
        if bias is not None:
            bias = F.pad(bias, (0, pad_k, 0, pad_q))
    if try_fullrow and _fullrow_supported(
        Lq + pad_q, Lk + pad_k, q.shape[-1],
        None if bias is None else bias.shape[0],
    ):
        return fullrow_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            bias=bias, kv_padding_mask=kvm, dropout_rate=dropout_rate,
            sm_scale=1.0,  # q is pre-scaled
            dropout_seed=dropout_seed,
        )[:, :, :Lq]
    raise NotImplementedError(
        f"attention over q {tuple(q.shape)} / k {tuple(k.shape)} with bias "
        f"{None if bias is None else tuple(bias.shape)}: the JAX package "
        "runs this shape in its online flash kernel "
        "(unicore_tpu/ops/flash_attention.py _fwd_kernel), which is not "
        "ported yet"
    )


def _flash_ok(tgt_len, src_len, head_dim, dtype):
    """Shape gate of the kernel route (the JAX package's, without its
    backend check: the port's kernels serve both devices — the CUDA kernel
    on the card, its plain version on the CPU).  Returns (ok, reason)."""
    if not _flash_pad_waste_ok(tgt_len, src_len):
        return False, (
            f"sequence lengths ({tgt_len}, {src_len}) are far from the "
            "kernel's 128 tile (padding would waste >37% of the compute)"
        )
    if head_dim % 8 != 0:
        return False, f"head dim {head_dim} is not a multiple of 8"
    if dtype not in (torch.float32, torch.bfloat16):
        return False, f"dtype {dtype} unsupported (need fp32/bf16)"
    return True, None


def _attend(q, k, v, key_padding_mask, attn_bias, dropout_rate, train,
            rng=None):
    """Shared core: pick the kernel route or the fused-softmax route.
    ``rng`` (a :class:`DropoutRng`) draws the kernel's dropout seed."""
    bsz, num_heads, tgt_len, head_dim = q.shape
    src_len = k.shape[2]

    if key_padding_mask is not None and key_padding_mask.ndim == 0:
        key_padding_mask = None

    eff_dropout = dropout_rate if train else 0.0

    shapes_ok, reason = _flash_ok(tgt_len, src_len, head_dim, q.dtype)
    if not shapes_ok:
        _warn_flash_fallback(reason)
    if shapes_ok:
        bias_min = _bias_min_broadcast(
            attn_bias, bsz, num_heads, tgt_len, src_len
        )
        if attn_bias is not None and bias_min is None:
            _warn_flash_fallback(
                f"attn bias shape {tuple(attn_bias.shape)} needs "
                "materialization"
            )
        if attn_bias is None or bias_min is not None:
            seed = 0
            if eff_dropout > 0.0:
                if rng is None:
                    raise ValueError(
                        "attention dropout in training needs an explicit "
                        "DropoutRng (seed, update, micro-batch)"
                    )
                seed = rng.kernel_seed()
            kmask = (
                None if key_padding_mask is None
                else key_padding_mask.to(torch.int32)
            )
            return _flash_grouped(
                q, k, v, bias_min, kmask, tgt_len, src_len,
                dropout_rate=eff_dropout, dropout_seed=seed,
                try_fullrow=True,
            )

    # fused-softmax path (materializes the attention matrix)
    attn_weights = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if key_padding_mask is not None:
        attn_weights = attn_weights.masked_fill(
            key_padding_mask[:, None, None, :].to(torch.bool),
            torch.finfo(torch.float32).min,
        )
    bias4 = _bias_to_bhll(attn_bias, bsz, num_heads, tgt_len, src_len)
    attn = softmax_dropout(attn_weights, eff_dropout, is_training=train,
                           bias=bias4)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v)


class SelfMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        self.scaling = self.head_dim ** -0.5
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim, device=device)
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(
        self,
        query,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_bias: Optional[torch.Tensor] = None,
        rng=None,
    ):
        """Self-attention over ``query`` (B, L, E); ``key_padding_mask``
        (B, L) nonzero = padding; ``attn_bias`` any layout
        ``_bias_to_bhll`` accepts.  Dropout follows ``self.training`` and
        draws from ``rng`` (a :class:`DropoutRng`)."""
        bsz, tgt_len, embed_dim = query.shape
        assert embed_dim == self.embed_dim
        q, k, v = self.in_proj(query).chunk(3, dim=-1)
        # q is pre-scaled; the kernel then runs with sm_scale=1.0
        q = _split_heads(q, self.num_heads) * self.scaling
        k = _split_heads(k, self.num_heads)
        v = _split_heads(v, self.num_heads)
        o = _attend(q, k, v, key_padding_mask, attn_bias, self.dropout,
                    self.training, rng)
        return self.out_proj(_merge_heads(o))
