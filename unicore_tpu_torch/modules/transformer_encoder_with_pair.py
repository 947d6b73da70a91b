"""Transformer encoder that co-evolves a pairwise representation, the
Uni-Mol backbone (counterpart of
``unicore_tpu/modules/transformer_encoder_with_pair.py``).

Each layer's attention consumes the running (B, H, L, L) pair bias and
returns its pre-softmax weights, which become the next layer's bias, so
every layer runs the attention's ``return_attn`` route (the fused softmax
of ``ops/softmax_dropout.py``).  After the stack: the final LayerNorm, the
``x_norm`` and ``delta_norm`` regularisers, the padded pairs zeroed in the
pair representation and its change, and ``final_head_layer_norm`` over the
heads of that change.

The JAX package's GPipe (``pipeline_stages``) and sequence-sharded
(``seq_shard``) variants are not ported; asking for them raises.
"""

from typing import Optional

import torch
from torch import nn

from .dropout import dropout
from .layer_norm import LayerNorm
from .transformer_encoder import TransformerEncoderLayer


def masked_norm(t: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """RMS of ``t`` over the unmasked rows (``mask`` (B, L), 1 = padding)."""
    if mask is None:
        return torch.sqrt(torch.mean(torch.square(t)) + 1e-12)
    keep = (1 - mask).to(t.dtype)
    return torch.sqrt(
        torch.sum(torch.square(t * keep[..., None]))
        / (torch.sum(keep) * t.shape[-1] + 1e-6)
        + 1e-12
    )


class TransformerEncoderWithPair(nn.Module):
    def __init__(
        self,
        encoder_layers: int = 6,
        embed_dim: int = 512,
        ffn_embed_dim: int = 2048,
        attention_heads: int = 64,
        emb_dropout: float = 0.1,
        dropout: float = 0.1,
        attention_dropout: float = 0.1,
        activation_dropout: float = 0.0,
        activation_fn: str = "gelu",
        post_ln: bool = False,
        no_final_head_layer_norm: bool = False,
        pipeline_stages: int = 0,
        seq_shard: bool = False,
        device=None,
    ):
        super().__init__()
        if pipeline_stages > 1 or seq_shard:
            raise NotImplementedError(
                "the pipelined and sequence-sharded pair encoder "
                "(--pipeline-parallel-size / --seq-parallel-size) is not "
                "ported yet"
            )
        self.emb_dropout = emb_dropout
        self.post_ln = post_ln
        self.emb_layer_norm = LayerNorm(embed_dim, device=device)
        if not post_ln:
            self.final_layer_norm = LayerNorm(embed_dim, device=device)
        self.final_head_layer_norm = (
            None if no_final_head_layer_norm
            else LayerNorm(attention_heads, device=device)
        )
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

    def forward(
        self,
        emb: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        rng=None,
    ):
        """Returns (x, pair_rep, delta_pair_rep, x_norm, delta_pair_rep_norm)
        for ``emb`` (B, L, E), the initial pair bias ``attn_mask``
        (B, H, L, L) and ``padding_mask`` (B, L), nonzero = padding."""
        x = self.emb_layer_norm(emb)
        x = dropout(x, self.emb_dropout, self.training, rng)
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))

        pair_bias = attn_mask
        attn_weights = None
        for layer in self.layers:
            x, attn_weights, _ = layer(x, attn_bias=pair_bias,
                                       padding_mask=padding_mask, rng=rng,
                                       return_attn=True)
            pair_bias = attn_weights

        if not self.post_ln:
            x = self.final_layer_norm(x)
        x_norm = masked_norm(x.float(), padding_mask)

        pair_rep = attn_weights
        delta = pair_rep if attn_mask is None else pair_rep - attn_mask
        if padding_mask is not None:
            pm = padding_mask.bool()
            pair_mask = pm[:, None, :, None] | pm[:, None, None, :]
            # the -inf of padded keys leaves both through the select
            delta = torch.where(pair_mask, 0.0, delta)
            pair_rep = torch.where(pair_mask, 0.0, pair_rep)
        delta_norm = torch.sqrt(torch.mean(torch.square(delta.float())) + 1e-12)

        if self.final_head_layer_norm is not None:
            # (B, H, L, L) -> normalise over the heads
            d = self.final_head_layer_norm(delta.permute(0, 2, 3, 1).contiguous())
            delta = d.permute(0, 3, 1, 2)
        return x, pair_rep, delta, x_norm, delta_norm
