"""Decoder-only causal LM (counterpart of
``unicore_tpu/models/transformer_lm.py``).

Learned positional embeddings added to token embeddings, the causal
rel-pos-bias :class:`TransformerDecoder`, and the LM head tied to the token
embedding plus ``out_bias`` (no intermediate dense).  :meth:`prefill` and
:meth:`decode_step` are the serving surface of incremental decode: prefill
runs the causal forward once and returns the per-layer K/V stacks;
decode_step embeds ONE token per sequence at its position and runs the
cache-reading step (``ops/decode_attention``).  All three share the same
submodules, so incremental decode is held step for step against the full
forward (``tests/test_torch_decode.py``).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch import utils
from unicore_tpu_torch.models import register_model, register_model_architecture
from unicore_tpu_torch.models.unicore_model import BaseUnicoreModel
from unicore_tpu_torch.modules import init_bert_params
from unicore_tpu_torch.modules.transformer_decoder import TransformerDecoder


@register_model("transformer_lm")
class TransformerLMModel(BaseUnicoreModel):
    def __init__(
        self,
        vocab_size: int = 30522,
        padding_idx: int = 1,
        decoder_layers: int = 6,
        decoder_embed_dim: int = 768,
        decoder_ffn_embed_dim: int = 3072,
        decoder_attention_heads: int = 12,
        dropout: float = 0.1,
        emb_dropout: float = 0.1,
        attention_dropout: float = 0.1,
        activation_dropout: float = 0.0,
        max_seq_len: int = 512,
        activation_fn: str = "gelu",
        post_ln: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.padding_idx = padding_idx
        self.max_seq_len = max_seq_len
        self.decoder_layers = decoder_layers
        self.decoder_embed_dim = decoder_embed_dim
        self.decoder_attention_heads = decoder_attention_heads
        self.embed_tokens = nn.Embedding(vocab_size, decoder_embed_dim, device=device)
        self.embed_positions = nn.Embedding(max_seq_len, decoder_embed_dim, device=device)
        self.decoder = TransformerDecoder(
            decoder_layers=decoder_layers,
            embed_dim=decoder_embed_dim,
            ffn_embed_dim=decoder_ffn_embed_dim,
            attention_heads=decoder_attention_heads,
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
            auto_regressive=True,
            device=device,
        )
        self.out_bias = nn.Parameter(
            torch.zeros(vocab_size, dtype=torch.float32, device=device)
        )
        # bert_init: embeddings and dense kernels N(0, 0.02), dense biases
        # 0 (the attention projections' normal(0.02) is the same draw)
        init_bert_params(self, generator)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--decoder-layers", type=int,
                            help="num decoder layers")
        parser.add_argument("--decoder-embed-dim", type=int,
                            help="decoder embedding dimension")
        parser.add_argument("--decoder-ffn-embed-dim", type=int,
                            help="decoder FFN embedding dimension")
        parser.add_argument("--decoder-attention-heads", type=int,
                            help="num decoder attention heads")
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
        lm_base_architecture(args)
        return cls(
            vocab_size=len(task.dictionary),
            padding_idx=task.dictionary.pad(),
            decoder_layers=args.decoder_layers,
            decoder_embed_dim=args.decoder_embed_dim,
            decoder_ffn_embed_dim=args.decoder_ffn_embed_dim,
            decoder_attention_heads=args.decoder_attention_heads,
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

    def _logits(self, x):
        return F.linear(x, self.embed_tokens.weight) + self.out_bias

    def _embed(self, src_tokens):
        seq_len = src_tokens.shape[1]
        pos = self.embed_positions(torch.arange(seq_len, device=src_tokens.device))
        return self.embed_tokens(src_tokens) + pos[None, :, :]

    def forward(self, src_tokens, rng=None):
        """Logits (B, L, vocab) of the causal forward over ``src_tokens``
        (B, L), pad keys masked out."""
        padding_mask = src_tokens == self.padding_idx
        x = self.decoder(self._embed(src_tokens), padding_mask=padding_mask, rng=rng)
        return self._logits(x)

    # -- serving surface ---------------------------------------------------

    def prefill(self, src_tokens):
        """Causal forward over the (right-padded) prompt bucket, seeding the
        cache: returns ``(logits, (k, v))`` with per-layer K/V stacks
        (n_layers, B, H, Lp, D).  No padding mask: pads sit on the right,
        so the causal mask already keeps them out of every real row; pad
        rows' K/V are junk the decode step never reads."""
        x, kv = self.decoder(self._embed(src_tokens), return_kv=True)
        return self._logits(x), kv

    def decode_step(self, tokens_t, caches, positions, kv_scales=None):
        """One decode step: ``tokens_t`` (B,) the current token ids,
        ``positions`` (B,) int32 their rows.  Returns ``(logits, (k_rows,
        v_rows))``: logits (B, vocab) for choosing the NEXT token, rows
        (n_layers, B, H, D) for the caller's page scatter."""
        x = (self.embed_tokens(tokens_t.long())
             + self.embed_positions(positions.long()))[:, None, :]
        x, rows = self.decoder.decode_step(x, caches, positions, kv_scales=kv_scales)
        return self._logits(x[:, 0]), rows


@register_model_architecture("transformer_lm", "transformer_lm")
def lm_base_architecture(args):
    args.decoder_layers = getattr(args, "decoder_layers", 6)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 768)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 3072)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 12)
    args.dropout = getattr(args, "dropout", 0.1)
    args.emb_dropout = getattr(args, "emb_dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.activation_dropout = getattr(args, "activation_dropout", 0.0)
    args.max_seq_len = getattr(args, "max_seq_len", 512)
    args.activation_fn = getattr(args, "activation_fn", "gelu")
    args.post_ln = getattr(args, "post_ln", False)


@register_model_architecture("transformer_lm", "transformer_lm_tiny")
def transformer_lm_tiny_architecture(args):
    args.decoder_layers = getattr(args, "decoder_layers", 2)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 64)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 128)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 4)
    args.max_seq_len = getattr(args, "max_seq_len", 128)
    lm_base_architecture(args)
