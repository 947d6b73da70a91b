"""Transformer encoder stack (counterpart of
``unicore_tpu/modules/transformer_encoder.py``).

- the bucketed relative-position table is a numpy constant, held as a
  non-persistent buffer;
- the rel-pos bias stays (H, L, L) and broadcasts over the batch inside the
  attention op instead of being repeated per batch row;
- BERT init (normal 0.02, zero bias) is :func:`init_bert_params`, drawn
  from a ``torch.Generator``;
- dropout in training draws from the :class:`DropoutRng` passed to
  ``forward``, never from the global generator.

- quantized serving: ``fc1`` is a
  :class:`~unicore_tpu_torch.quant.dense.QuantDense` with the activation
  fused into it (the epilogue of the int8 kernel on the quantized path,
  ``F.linear`` then the activation on the fp path), ``fc2`` one without;
  the attention's projections are ``QuantDense`` too.

The JAX package's pipeline, mixture-of-experts, remat and sequence-parallel
variants are not ported yet.
"""

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from unicore_tpu_torch import utils
from unicore_tpu_torch.quant.dense import QuantDense
from .dropout import dropout
from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention

BERT_INIT_STD = 0.02


@torch.no_grad()
def init_bert_params(module: nn.Module, generator: Optional[torch.Generator] = None):
    """BERT initialization over a module tree: every linear / embedding
    weight N(0, 0.02), linear biases 0 (LayerNorms keep weight 1, bias 0)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, BERT_INIT_STD, generator=generator)
        if isinstance(m, nn.Linear) and m.bias is not None:
            m.bias.zero_()


def relative_position_bucket(relative_position, num_buckets=32, max_distance=128):
    """Signed log-bucketed relative positions (numpy)."""
    sign = np.sign(relative_position)
    num_buckets //= 2
    n = np.abs(relative_position)

    # half of the buckets are for exact increments in positions
    max_exact = num_buckets // 2
    is_small = n < max_exact
    max_bucket_val = num_buckets - 1 - max_exact
    # the other half logarithmically covers positions up to max_distance
    # (clamp the log argument: n==0 rows are overwritten by the is_small branch)
    safe_n = np.maximum(n, 1)
    val_if_large = max_exact + np.ceil(
        np.log(safe_n.astype(np.float32) / max_exact)
        / math.log((max_distance - 1) / max_exact)
        * max_bucket_val
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return np.where(is_small, n, val_if_large) * sign


def make_rp_bucket(max_seq_len, rel_pos_bins, max_rel_pos):
    """Precompute the (L, L) bucket table as a host constant."""
    context_position = np.arange(max_seq_len, dtype=np.int64)[:, None]
    memory_position = np.arange(max_seq_len, dtype=np.int64)[None, :]
    relative_position = memory_position - context_position
    rp_bucket = relative_position_bucket(
        relative_position, num_buckets=rel_pos_bins, max_distance=max_rel_pos
    )
    rp_bucket -= rp_bucket.min()
    return rp_bucket


class TransformerEncoderLayer(nn.Module):
    """Pre-/post-LN encoder layer."""

    def __init__(
        self,
        embed_dim: int = 768,
        ffn_embed_dim: int = 3072,
        attention_heads: int = 8,
        dropout: float = 0.1,
        attention_dropout: float = 0.1,
        activation_dropout: float = 0.0,
        activation_fn: str = "gelu",
        post_ln: bool = False,
        device=None,
    ):
        super().__init__()
        self.dropout = dropout
        self.activation_dropout = activation_dropout
        self.post_ln = post_ln
        self.self_attn = SelfMultiheadAttention(
            embed_dim, attention_heads, dropout=attention_dropout, device=device
        )
        self.self_attn_layer_norm = LayerNorm(embed_dim, device=device)
        utils.get_activation_fn(activation_fn)  # an unknown name raises here
        # the activation fused into fc1: the same composition on the fp path,
        # the int8 kernel's epilogue on the quantized one
        self.fc1 = QuantDense(embed_dim, ffn_embed_dim, device=device,
                              activation=activation_fn)
        self.fc2 = QuantDense(ffn_embed_dim, embed_dim, device=device)
        self.final_layer_norm = LayerNorm(embed_dim, device=device)

    def forward(
        self,
        x,
        attn_bias: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        rng=None,
        return_attn: bool = False,
    ):
        """The layer's output; with ``return_attn`` (output, the attention's
        pre-softmax weights, its probabilities)."""
        residual = x
        if not self.post_ln:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, key_padding_mask=padding_mask, attn_bias=attn_bias,
                           rng=rng, return_attn=return_attn)
        if return_attn:
            x, attn_weights, attn_probs = x
        x = dropout(x, self.dropout, self.training, rng)
        x = residual + x
        if self.post_ln:
            x = self.self_attn_layer_norm(x)

        residual = x
        if not self.post_ln:
            x = self.final_layer_norm(x)
        x = self.fc1(x)
        x = dropout(x, self.activation_dropout, self.training, rng)
        x = self.fc2(x)
        x = dropout(x, self.dropout, self.training, rng)
        x = residual + x
        if self.post_ln:
            x = self.final_layer_norm(x)
        if return_attn:
            return x, attn_weights, attn_probs
        return x


class TransformerEncoder(nn.Module):
    """Encoder stack with bucketed relative-position bias."""

    def __init__(
        self,
        encoder_layers: int = 6,
        embed_dim: int = 768,
        ffn_embed_dim: int = 3072,
        attention_heads: int = 8,
        emb_dropout: float = 0.1,
        dropout: float = 0.1,
        attention_dropout: float = 0.1,
        activation_dropout: float = 0.0,
        max_seq_len: int = 256,
        activation_fn: str = "gelu",
        rel_pos: bool = True,
        rel_pos_bins: int = 32,
        max_rel_pos: int = 128,
        post_ln: bool = False,
        device=None,
    ):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.rel_pos = rel_pos
        self.post_ln = post_ln
        self.emb_layer_norm = LayerNorm(embed_dim, device=device)
        if not post_ln:
            self.final_layer_norm = LayerNorm(embed_dim, device=device)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                embed_dim=embed_dim,
                ffn_embed_dim=ffn_embed_dim,
                attention_heads=attention_heads,
                dropout=dropout,
                attention_dropout=attention_dropout,
                activation_dropout=activation_dropout,
                activation_fn=activation_fn,
                post_ln=post_ln,
                device=device,
            )
            for _ in range(encoder_layers)
        )
        if rel_pos:
            assert rel_pos_bins % 2 == 0
            self.relative_attention_bias = nn.Embedding(
                rel_pos_bins, attention_heads, device=device
            )
            self.register_buffer(
                "rp_bucket",
                torch.as_tensor(
                    make_rp_bucket(max_seq_len, rel_pos_bins, max_rel_pos),
                    device=device,
                ),
                persistent=False,
            )

    def get_rel_pos_bias(self, seq_len):
        # (L, L) bucket table -> (H, L, L), contiguous so the kernel reads
        # it as is; the batch broadcast is left to the attention op
        rp_bucket = self.rp_bucket[:seq_len, :seq_len]
        values = self.relative_attention_bias(rp_bucket)  # (L, L, H)
        return values.permute(2, 0, 1).contiguous()

    def forward(
        self,
        emb: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        rng=None,
    ) -> torch.Tensor:
        seq_len = emb.shape[1]
        x = self.emb_layer_norm(emb)
        x = dropout(x, self.emb_dropout, self.training, rng)

        # account for padding while computing the representation
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))

        rel_pos_bias = self.get_rel_pos_bias(seq_len) if self.rel_pos else None
        if attn_mask is None:
            attn_bias = rel_pos_bias  # (H, L, L), broadcasts over batch
        elif rel_pos_bias is not None:
            attn_bias = attn_mask + rel_pos_bias
        else:
            attn_bias = attn_mask

        # the key-padding mask stays separate from the bias: the attention
        # routes apply it internally (the kernel as an in-kernel mask, the
        # fused route as an additive minimum)
        for layer in self.layers:
            x = layer(x, attn_bias, padding_mask, rng)

        if not self.post_ln:
            x = self.final_layer_norm(x)
        return x
