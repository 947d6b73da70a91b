"""BERT masked-LM model family (counterpart of ``unicore_tpu/models/bert.py``).

Learned positional embeddings added to token embeddings, then the
rel-pos-bias TransformerEncoder, then the LM head whose output projection
is tied to the token embedding.  Positions count pad positions too
(``embed_positions(arange(L))``), and the padding mask is
``src_tokens == padding_idx``.  Training projects only the masked positions
(``masked_positions``).  The classification head and the
mixture-of-experts archs are not ported yet.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch import utils
from unicore_tpu_torch.models import register_model, register_model_architecture
from unicore_tpu_torch.models.unicore_model import BaseUnicoreModel
from unicore_tpu_torch.modules import (
    LayerNorm,
    TransformerEncoder,
    init_bert_params,
)


class BertLMHead(nn.Module):
    """Masked-LM head; the tied projection weight is passed in."""

    def __init__(self, embed_dim: int, output_dim: int,
                 activation_fn: str = "gelu", device=None):
        super().__init__()
        self.dense = nn.Linear(embed_dim, embed_dim, device=device)
        self.activation_fn = utils.get_activation_fn(activation_fn)
        self.layer_norm = LayerNorm(embed_dim, device=device)
        self.bias = nn.Parameter(
            torch.zeros(output_dim, dtype=torch.float32, device=device)
        )

    def forward(self, features, embed_weight):
        x = self.activation_fn(self.dense(features))
        x = self.layer_norm(x)
        return F.linear(x, embed_weight) + self.bias


@register_model("bert")
class BertModel(BaseUnicoreModel):
    def __init__(
        self,
        vocab_size: int = 30522,
        padding_idx: int = 1,
        encoder_layers: int = 12,
        encoder_embed_dim: int = 768,
        encoder_ffn_embed_dim: int = 3072,
        encoder_attention_heads: int = 12,
        dropout: float = 0.1,
        emb_dropout: float = 0.1,
        attention_dropout: float = 0.1,
        activation_dropout: float = 0.0,
        max_seq_len: int = 512,
        activation_fn: str = "gelu",
        post_ln: bool = True,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.padding_idx = padding_idx
        self.max_seq_len = max_seq_len
        self.embed_tokens = nn.Embedding(vocab_size, encoder_embed_dim, device=device)
        self.embed_positions = nn.Embedding(max_seq_len, encoder_embed_dim, device=device)
        self.sentence_encoder = TransformerEncoder(
            encoder_layers=encoder_layers,
            embed_dim=encoder_embed_dim,
            ffn_embed_dim=encoder_ffn_embed_dim,
            attention_heads=encoder_attention_heads,
            emb_dropout=emb_dropout,
            dropout=dropout,
            attention_dropout=attention_dropout,
            activation_dropout=activation_dropout,
            max_seq_len=max_seq_len,
            activation_fn=activation_fn,
            rel_pos=True,
            rel_pos_bins=32,
            max_rel_pos=128,
            post_ln=post_ln,
            device=device,
        )
        self.lm_head = BertLMHead(
            encoder_embed_dim, vocab_size, activation_fn=activation_fn,
            device=device,
        )
        init_bert_params(self, generator)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--encoder-layers", type=int,
                            help="num encoder layers")
        parser.add_argument("--encoder-embed-dim", type=int,
                            help="encoder embedding dimension")
        parser.add_argument("--encoder-ffn-embed-dim", type=int,
                            help="encoder embedding dimension for FFN")
        parser.add_argument("--encoder-attention-heads", type=int,
                            help="num encoder attention heads")
        parser.add_argument("--activation-fn", type=str,
                            help="activation function to use")
        parser.add_argument("--emb-dropout", type=float, metavar="D",
                            help="dropout probability for embeddings")
        parser.add_argument("--dropout", type=float, metavar="D",
                            help="dropout probability")
        parser.add_argument("--attention-dropout", type=float, metavar="D",
                            help="dropout probability for attention weights")
        parser.add_argument("--activation-dropout", type=float, metavar="D",
                            help="dropout probability after activation in FFN")
        parser.add_argument("--max-seq-len", type=int,
                            help="number of positional embeddings to learn")
        parser.add_argument("--post-ln", type=utils.str_to_bool,
                            help="use post layernorm or pre layernorm")

    @classmethod
    def build_model(cls, args, task, device=None, generator=None):
        base_architecture(args)
        if (getattr(args, "num_classes", -1) or -1) > 0:
            raise NotImplementedError(
                "the BERT classification head is not ported yet"
            )
        if getattr(args, "moe_experts", 0):
            raise NotImplementedError(
                "the mixture-of-experts BERT archs are not ported yet"
            )
        return cls(
            vocab_size=len(task.dictionary),
            padding_idx=task.dictionary.pad(),
            encoder_layers=args.encoder_layers,
            encoder_embed_dim=args.encoder_embed_dim,
            encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
            encoder_attention_heads=args.encoder_attention_heads,
            dropout=args.dropout,
            emb_dropout=args.emb_dropout,
            attention_dropout=args.attention_dropout,
            activation_dropout=args.activation_dropout,
            max_seq_len=args.max_seq_len,
            activation_fn=args.activation_fn,
            post_ln=args.post_ln,
            device=device,
            generator=generator,
        )

    def forward(self, src_tokens, masked_positions=None, rng=None):
        """Logits (B, L, vocab) for ``src_tokens`` (B, L).  With
        ``masked_positions`` (B, M) the LM head projects only those
        positions, giving (B, M, vocab) — the JAX model's static-shape
        masked gather.  Dropout in training draws from ``rng`` (a
        :class:`DropoutRng`)."""
        padding_mask = src_tokens == self.padding_idx
        seq_len = src_tokens.shape[1]
        x = self.embed_tokens(src_tokens)
        # positions count pad positions too
        pos = self.embed_positions(
            torch.arange(seq_len, device=src_tokens.device)
        )
        x = x + pos[None, :, :]
        x = self.sentence_encoder(x, padding_mask=padding_mask, rng=rng)
        if masked_positions is not None:
            x = torch.gather(
                x, 1, masked_positions[:, :, None].expand(-1, -1, x.shape[-1])
            )
        return self.lm_head(x, self.embed_tokens.weight)


@register_model_architecture("bert", "bert")
def base_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 12)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 768)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 3072)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 12)
    args.dropout = getattr(args, "dropout", 0.1)
    args.emb_dropout = getattr(args, "emb_dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.activation_dropout = getattr(args, "activation_dropout", 0.0)
    args.pooler_dropout = getattr(args, "pooler_dropout", 0.0)
    args.max_seq_len = getattr(args, "max_seq_len", 512)
    args.activation_fn = getattr(args, "activation_fn", "gelu")
    args.pooler_activation_fn = getattr(args, "pooler_activation_fn", "tanh")
    args.post_ln = getattr(args, "post_ln", True)


@register_model_architecture("bert", "bert_base")
def bert_base_architecture(args):
    base_architecture(args)


@register_model_architecture("bert", "bert_large")
def bert_large_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 24)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 1024)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 4096)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 16)
    base_architecture(args)


@register_model_architecture("bert", "bert_tiny")
def bert_tiny_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 2)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 64)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 128)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 4)
    args.max_seq_len = getattr(args, "max_seq_len", 128)
    base_architecture(args)


@register_model_architecture("bert", "xlm")
def xlm_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 16)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 1280)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 1280 * 4)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 16)
    base_architecture(args)
