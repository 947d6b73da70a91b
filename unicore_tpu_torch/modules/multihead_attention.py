"""Multi-head self-attention with pair-bias support (counterpart of
``unicore_tpu/modules/multihead_attention.py``).

Attention stays in the JAX package's (B, H, L, D) layout, and ``_attend``
routes exactly as the JAX package routes on a TPU:

- **kernel route** (lengths within the pad-waste limit, head dim a
  multiple of 8, fp32/bf16): pad to 128 and run
  ``ops/attention_fullrow.py`` when its ``supported()`` gate accepts the
  shape, else ``ops/flash_attention.py`` (rows over 1024, a per-batch
  bias), as the JAX package's ``_flash_grouped`` routes them.
- **fused-softmax route** (everything else): the attention matrix is
  materialized and ``ops/softmax_dropout.py`` takes the softmax.
- **return_attn route** (Uni-Mol's pair encoder, JAX :414-443): the
  pre-softmax weights are a model output, so the fused-softmax route runs
  whatever the shape: key padding masked with the fp32 minimum first, then
  the pair bias added, then ``softmax_dropout`` with no extra; it returns
  (output, weights, probabilities).  From the pair encoder's second layer
  on the bias itself holds the fp32 minimum at padded keys, so their sum is
  -inf there; the softmax gives 0 for it and its gradient 0, as in the JAX
  package.

- **decode route** (``cache_kv`` given, JAX :484-594): one query token per
  sequence; its K/V row (quantized against ``kv_scales`` when the cache is
  int8) is written into the gathered cache at each sequence's position, so
  the token attends itself, and ``ops/decode_attention.py`` reads the
  cache.  ``return_kv`` instead returns a prefill's split-heads K/V beside
  the output, to seed the cache.

- **quantized route** (``quantize == "int8"``, not training, not
  ``return_attn``; JAX ``_quant_attend`` :239-275, picked at :301): q and k
  quantize to int8 against dynamic per-tensor scales (0-d device tensors),
  their product sums exactly in int32, and
  ``ops/quant_softmax_dropout.py`` takes the int32 scores with the scale
  ``q_scale * k_scale``, the additive ``finfo.min`` key mask and the bias;
  the probabilities multiply v in fp32.  ``in_proj``/``out_proj`` are
  :class:`~unicore_tpu_torch.quant.dense.QuantDense` sites.  In fp8 mode
  only the projections quantize: the scores stay fp32 and take the routes
  above, as in the JAX package.

The JAX package's sequence-parallel (ring, Ulysses) routes are not ported
yet.
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
from unicore_tpu_torch.ops.decode_attention import decode_attention
from unicore_tpu_torch.ops.flash_attention import flash_attention
from unicore_tpu_torch.ops.quant_matmul import (
    INT8_QMAX,
    dynamic_act_scale,
    quantize_to_dtype,
    quantize_to_int8,
)
from unicore_tpu_torch.ops.quant_softmax_dropout import quant_softmax_dropout
from unicore_tpu_torch.ops.softmax_dropout import softmax_dropout
from unicore_tpu_torch.quant.dense import QuantDense

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
    full-row kernel when ``try_fullrow`` and its gate accepts the shape,
    else the grouped flash kernel: padded keys mask out, padded query rows
    slice off.  The one copy of the padding contract, shared by this
    module's router and the Evoformer's ``GatedAttention``.

    ``kvm``: (N, Lk) int, nonzero = masked OUT; ``bias``: grouped
    (G, 1|H, Lq, Lk) with N % G == 0, or None."""
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if try_fullrow and _fullrow_supported(
        Lq + pad_q, Lk + pad_k, q.shape[-1],
        None if bias is None else bias.shape[0],
    ):
        return fullrow_attention(
            q, k, v, bias=bias, kv_padding_mask=kvm, dropout_rate=dropout_rate,
            sm_scale=1.0,  # q is pre-scaled
            dropout_seed=dropout_seed,
        )[:, :, :Lq]
    return flash_attention(
        q, k, v, bias=bias, kv_padding_mask=kvm, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
        sm_scale=1.0,  # q is pre-scaled
    )[:, :, :Lq]


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


#: the int8 score product in fp32 is exact while every partial sum of
#: head_dim products of two int8 values (at most 127**2 each) stays below
#: 2**24: head dims up to 1040 (BERT's is 64)
_EXACT_FP32_HEAD_DIM = (2 ** 24) // (127 * 127)


def _int8_scores(q_q, k_q):
    """The exact int32 ``q_q @ k_q^T`` of int8 (B, H, L, D) operands, the
    JAX ``dot_general(preferred_element_type=int32)``.  torch has no batched
    int8 product that accumulates in int32, so the operands widen: to fp32
    when the product is exact there (head dim at most 1040, and no TF32 on
    the card), else to float64.  A TF32 product is never taken."""
    exact_fp32 = (
        q_q.shape[-1] <= _EXACT_FP32_HEAD_DIM
        and torch.get_float32_matmul_precision() == "highest"
        and not (q_q.is_cuda and torch.backends.cuda.matmul.allow_tf32)
    )
    wide = torch.float32 if exact_fp32 else torch.float64
    return torch.matmul(q_q.to(wide), k_q.to(wide).transpose(-1, -2)).to(torch.int32)


def _quant_attend(q, k, v, key_padding_mask, attn_bias, bsz, num_heads,
                  tgt_len, src_len):
    """The int8 serving scores (JAX ``_quant_attend``): int8 q and k, their
    exact int32 product, softmax of the dequantized scores with the key
    mask and bias in ``ops/quant_softmax_dropout.py``, fp32 probabilities
    times v."""
    q_scale = dynamic_act_scale(q)
    k_scale = dynamic_act_scale(k)
    scores_q = _int8_scores(quantize_to_int8(q, q_scale), quantize_to_int8(k, k_scale))
    mask_add = None
    if key_padding_mask is not None:
        # the additive form of the fp route's where(mask, finfo.min): the
        # dequantized scores are far below the fp32 maximum, so the sum
        # stays finite and a fully masked row degrades to a uniform softmax
        mask_add = (key_padding_mask[:, None, None, :].to(torch.float32)
                    * torch.finfo(torch.float32).min)
    bias4 = _bias_min_broadcast(attn_bias, bsz, num_heads, tgt_len, src_len)
    if bias4 is None:
        bias4 = _bias_to_bhll(attn_bias, bsz, num_heads, tgt_len, src_len)
    probs = quant_softmax_dropout(scores_q, q_scale * k_scale, 0.0, is_training=False,
                                  mask=mask_add, bias=bias4, out_dtype=v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _attend(q, k, v, key_padding_mask, attn_bias, dropout_rate, train,
            rng=None, return_attn=False, quantize=""):
    """Shared core: pick the kernel route or the fused-softmax route.
    ``rng`` (a :class:`DropoutRng`) draws the dropout.  Returns the output,
    or with ``return_attn`` (output, pre-softmax weights, probabilities)."""
    bsz, num_heads, tgt_len, head_dim = q.shape
    src_len = k.shape[2]

    if key_padding_mask is not None and key_padding_mask.ndim == 0:
        key_padding_mask = None

    eff_dropout = dropout_rate if train else 0.0

    if quantize == "int8" and not train and not return_attn:
        # fp8 quantizes the projections only: its scores stay fp32
        return _quant_attend(q, k, v, key_padding_mask, attn_bias, bsz, num_heads,
                             tgt_len, src_len)

    if return_attn:
        shapes_ok = False
    else:
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
        # the fp32 minimum in the scores' type: -inf in bf16 and fp16, as
        # the JAX package's asarray(finfo(float32).min, dtype) gives
        neg = torch.tensor(torch.finfo(torch.float32).min).to(attn_weights.dtype)
        attn_weights = attn_weights.masked_fill(
            key_padding_mask[:, None, None, :].to(torch.bool), neg.item())
    bias4 = _bias_to_bhll(attn_bias, bsz, num_heads, tgt_len, src_len)
    if not return_attn:
        attn = softmax_dropout(attn_weights, eff_dropout, is_training=train,
                               bias=bias4, rng=rng)
        return torch.einsum("bhqk,bhkd->bhqd", attn, v)
    if bias4 is not None:
        attn_weights = attn_weights + bias4
    attn = softmax_dropout(attn_weights, eff_dropout, is_training=train,
                           rng=rng, inplace=False)
    return torch.einsum("bhqk,bhkd->bhqd", attn, v), attn_weights, attn


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
        #: '' (training precision), 'int8' or 'fp8': set on a model's
        #: quantized twin; 'int8' takes the quantized score route in eval
        self.quantize = ""
        self.in_proj = QuantDense(embed_dim, 3 * embed_dim, device=device)
        self.out_proj = QuantDense(embed_dim, embed_dim, device=device)

    def forward(
        self,
        query,
        key_padding_mask: Optional[torch.Tensor] = None,
        attn_bias: Optional[torch.Tensor] = None,
        rng=None,
        return_attn: bool = False,
        cache_kv=None,
        cache_positions: Optional[torch.Tensor] = None,
        kv_scales=None,
        return_kv: bool = False,
    ):
        """Self-attention over ``query`` (B, L, E); ``key_padding_mask``
        (B, L) nonzero = padding; ``attn_bias`` any layout
        ``_bias_to_bhll`` accepts.  Dropout follows ``self.training`` and
        draws from ``rng`` (a :class:`DropoutRng`).  With ``return_attn``
        it returns (output, pre-softmax weights, probabilities), the
        latter two (B, H, L, L).

        Incremental decode, same projections and parameters:

        * ``return_kv``: also return the split-heads K/V ((B, H, L, D)
          each), so a prefill can seed the cache: ``(out, (k, v))``;
        * ``cache_kv=(k_cache, v_cache)`` ((B, H, Lc, D) each, fp32/bf16
          or int8) with ``cache_positions`` (B,) int32: decode.  ``query``
          is one token (B, 1, E) and ``attn_bias`` the (B, H, Lc) bias row
          at the current positions.  Returns ``(out, (k_row, v_row))``,
          the new rows (B, H, D) in the cache type, for the caller's page
          scatter."""
        bsz, tgt_len, embed_dim = query.shape
        assert embed_dim == self.embed_dim
        q, k, v = self.in_proj(query).chunk(3, dim=-1)
        # q is pre-scaled; the kernel then runs with sm_scale=1.0
        q = _split_heads(q, self.num_heads) * self.scaling
        k = _split_heads(k, self.num_heads)
        v = _split_heads(v, self.num_heads)
        if cache_kv is not None:
            assert tgt_len == 1, f"decode takes one token per step, got {tgt_len}"
            o, rows = self._decode(q, k, v, cache_kv, cache_positions, kv_scales,
                                   attn_bias)
            return self.out_proj(_merge_heads(o)), rows
        o = _attend(q, k, v, key_padding_mask, attn_bias, self.dropout,
                    self.training, rng, return_attn, self.quantize)
        if return_attn:
            o, attn_weights, attn_probs = o
            return self.out_proj(_merge_heads(o)), attn_weights, attn_probs
        if return_kv:
            return self.out_proj(_merge_heads(o)), (k, v)
        return self.out_proj(_merge_heads(o))

    def _decode(self, q, k, v, cache_kv, positions, kv_scales, attn_bias):
        """One incremental step: write this token's K/V row into the
        gathered cache (so the token attends itself), then read the cache
        through the single-query kernel.  The gathered cache is the
        caller's ephemeral copy of the page pool, written in place here;
        only the new rows return (the pool is the source of truth,
        ``serve/kv_cache.py``)."""
        k_cache, v_cache = cache_kv
        k_row, v_row = k[:, :, 0], v[:, :, 0]  # (B, H, D)
        k_scale = v_scale = None
        if k_cache.dtype == torch.int8:
            assert kv_scales is not None, "int8 KV cache needs kv_scales"
            k_scale, v_scale = kv_scales  # (H, D) each
            k_row = quantize_to_dtype(k_row, k_scale[None], INT8_QMAX, torch.int8)
            v_row = quantize_to_dtype(v_row, v_scale[None], INT8_QMAX, torch.int8)
        else:
            k_row, v_row = k_row.to(k_cache.dtype), v_row.to(v_cache.dtype)
        rows = torch.arange(q.shape[0], device=q.device)
        # advanced indices around a slice: the indexed block is (B, H, D)
        k_cache[rows, :, positions.long()] = k_row
        v_cache[rows, :, positions.long()] = v_row
        o = decode_attention(
            q[:, :, 0].contiguous(), k_cache, v_cache, positions.to(torch.int32),
            bias=attn_bias, k_scale=k_scale, v_scale=v_scale,
        )
        return o[:, :, None], (k_row, v_row)
