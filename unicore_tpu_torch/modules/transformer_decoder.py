"""Transformer decoder stack (counterpart of
``unicore_tpu/modules/transformer_decoder.py``): causal self-attention and
FFN layers, pre-/post-LN, the bucketed rel-pos bias, plus the incremental
decode surface — ``return_kv`` stacks a prefill's per-layer K/V and
:meth:`TransformerDecoder.decode_step` runs one cached step.

Cross-attention is not ported: a decoder-only layer creates no
``encoder_attn`` or ``encoder_attn_layer_norm`` parameters (Flax creates
them only when called, so a JAX ``transformer_lm`` has none either), and a
layer given ``encoder_out`` raises ``NotImplementedError``.
"""

from typing import Optional

import torch
from torch import nn

from unicore_tpu_torch import utils
from .dropout import dropout
from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention
from .transformer_encoder import make_rp_bucket

#: the additive causal mask (the JAX package's finite -inf stand-in)
CAUSAL_NEG = -1e30


class TransformerDecoderLayer(nn.Module):
    """Pre-/post-LN decoder layer: self-attention, then the FFN."""

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
        self.activation_fn = utils.get_activation_fn(activation_fn)
        self.post_ln = post_ln
        self.self_attn = SelfMultiheadAttention(
            embed_dim, attention_heads, dropout=attention_dropout, device=device
        )
        self.self_attn_layer_norm = LayerNorm(embed_dim, device=device)
        self.fc1 = nn.Linear(embed_dim, ffn_embed_dim, device=device)
        self.fc2 = nn.Linear(ffn_embed_dim, embed_dim, device=device)
        self.final_layer_norm = LayerNorm(embed_dim, device=device)

    def forward(
        self,
        x,
        encoder_out: Optional[torch.Tensor] = None,
        attn_bias: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        rng=None,
        cache_kv=None,
        cache_positions: Optional[torch.Tensor] = None,
        kv_scales=None,
        return_kv: bool = False,
    ):
        """The layer's output; with ``return_kv`` or ``cache_kv``
        ``(output, (k, v))``, as ``SelfMultiheadAttention`` returns them."""
        if encoder_out is not None:
            raise NotImplementedError(
                "cross-attention (encoder_out) of the decoder is not ported yet"
            )
        with_kv = cache_kv is not None or return_kv
        residual = x
        if not self.post_ln:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, key_padding_mask=padding_mask, attn_bias=attn_bias,
                           rng=rng, cache_kv=cache_kv, cache_positions=cache_positions,
                           kv_scales=kv_scales, return_kv=return_kv)
        if with_kv:
            x, kv = x
        x = dropout(x, self.dropout, self.training, rng)
        x = residual + x
        if self.post_ln:
            x = self.self_attn_layer_norm(x)

        residual = x
        if not self.post_ln:
            x = self.final_layer_norm(x)
        x = self.activation_fn(self.fc1(x))
        x = dropout(x, self.activation_dropout, self.training, rng)
        x = self.fc2(x)
        x = dropout(x, self.dropout, self.training, rng)
        x = residual + x
        if self.post_ln:
            x = self.final_layer_norm(x)
        if with_kv:
            return x, kv
        return x


class TransformerDecoder(nn.Module):
    """Decoder stack with the bucketed relative-position bias and, when
    ``auto_regressive``, the additive causal mask."""

    def __init__(
        self,
        decoder_layers: int = 6,
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
        auto_regressive: bool = True,
        device=None,
    ):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.rel_pos = rel_pos
        self.post_ln = post_ln
        self.auto_regressive = auto_regressive
        self.emb_layer_norm = LayerNorm(embed_dim, device=device)
        if not post_ln:
            self.final_layer_norm = LayerNorm(embed_dim, device=device)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(
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
            for _ in range(decoder_layers)
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
        """(H, L, L), contiguous; the batch broadcast is left to the
        attention op."""
        values = self.relative_attention_bias(self.rp_bucket[:seq_len, :seq_len])
        return values.permute(2, 0, 1).contiguous()

    def get_rel_pos_bias_row(self, positions, seq_len):
        """The bias ROW each decoding sequence needs: the query at
        ``positions[b]`` against keys ``0..seq_len-1``, read from the same
        bucket table the full forward reads, so decode and full-forward
        biases agree exactly.  Returns (B, H, seq_len), contiguous."""
        rows = self.rp_bucket[positions.long(), :seq_len]  # (B, seq_len)
        return self.relative_attention_bias(rows).permute(0, 2, 1).contiguous()

    def forward(
        self,
        emb: torch.Tensor,
        encoder_out: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        rng=None,
        return_kv: bool = False,
    ):
        """The stack's output over ``emb`` (B, L, E); with ``return_kv``
        also the per-layer K/V stacks, (n_layers, B, H, L, D) each — the
        prefill's cache seed."""
        seq_len = emb.shape[1]
        x = self.emb_layer_norm(emb)
        x = dropout(x, self.emb_dropout, self.training, rng)
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))

        rel_pos_bias = self.get_rel_pos_bias(seq_len) if self.rel_pos else None
        if attn_mask is None:
            attn_bias = rel_pos_bias
        elif rel_pos_bias is not None:
            attn_bias = attn_mask + rel_pos_bias
        else:
            attn_bias = attn_mask
        if self.auto_regressive:
            causal = torch.triu(
                torch.full((seq_len, seq_len), CAUSAL_NEG, device=emb.device), 1
            )
            if attn_bias is not None:
                # in the bias's type, as JAX's weakly typed -1e30 joins a bf16
                # or fp16 bias (-1.00026e30 in bf16, -inf in fp16)
                attn_bias = attn_bias + causal.to(attn_bias.dtype)
            else:
                attn_bias = causal

        # the key-padding mask stays separate from the bias (see the encoder)
        ks, vs = [], []
        for layer in self.layers:
            x = layer(x, encoder_out=encoder_out, attn_bias=attn_bias,
                      padding_mask=padding_mask, rng=rng, return_kv=return_kv)
            if return_kv:
                x, (k, v) = x
                ks.append(k)
                vs.append(v)

        if not self.post_ln:
            x = self.final_layer_norm(x)
        if return_kv:
            return x, (torch.stack(ks), torch.stack(vs))
        return x

    def decode_step(self, emb_t, caches, positions, kv_scales=None):
        """One incremental decode step: ``emb_t`` (B, 1, E) the current
        token's embedding, ``caches = (k, v)`` the gathered per-layer
        caches ((n_layers, B, H, L, D) each, fp32 or int8), ``positions``
        (B,) int32 each sequence's current row, ``kv_scales`` ((n_layers,
        H, D) each) for int8 caches.  Each layer writes its new K/V row
        into the gathered caches before attending (the token sees itself,
        matching the causal full forward row for row) and the new rows
        return for the caller's page scatter.  Returns ``(x, (k_rows,
        v_rows))`` with rows (n_layers, B, H, D) in the cache type."""
        k_caches, v_caches = caches
        seq_len = k_caches.shape[3]
        x = self.emb_layer_norm(emb_t)
        # causality is positional here: rows past each sequence's position
        # are skipped inside ops/decode_attention, no triu
        bias_row = (self.get_rel_pos_bias_row(positions, seq_len)
                    if self.rel_pos else None)
        k_rows, v_rows = [], []
        for i, layer in enumerate(self.layers):
            scales_i = (None if kv_scales is None
                        else (kv_scales[0][i], kv_scales[1][i]))
            x, (k_t, v_t) = layer(
                x, attn_bias=bias_row, cache_kv=(k_caches[i], v_caches[i]),
                cache_positions=positions, kv_scales=scales_i,
            )
            k_rows.append(k_t)
            v_rows.append(v_t)
        if not self.post_ln:
            x = self.final_layer_norm(x)
        return x, (torch.stack(k_rows), torch.stack(v_rows))
