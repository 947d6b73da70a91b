"""Uni-Mol molecular pretraining model (counterpart of
``unicore_tpu/models/unimol.py``).

Atom-type embeddings; a learned Gaussian basis over interatomic distances,
projected per head into the (B, H, L, L) pair bias; the pair-evolving
:class:`TransformerEncoderWithPair`; and three heads: masked-atom logits
(projection tied to the token embedding), an SE(3)-equivariant coordinate
update (pair weights times direction vectors) and a symmetrised distance
head.  Weights are drawn as the JAX package initialises them (normal 0.02
for every dense and embedding weight, zero biases, the Gaussian layer's
``mul`` ones and ``bias`` zeros, ``means`` and ``stds`` uniform on [0, 3)),
from a ``torch.Generator``.  The pipelined and sequence-sharded variants
are not ported.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch import utils
from unicore_tpu_torch.models import register_model, register_model_architecture
from unicore_tpu_torch.models.unicore_model import (
    BaseUnicoreModel,
    refuse_unported_parallelism,
)
from unicore_tpu_torch.modules import (
    LayerNorm,
    TransformerEncoderWithPair,
    init_bert_params,
)


class NonLinearHead(nn.Module):
    """Two-layer MLP head."""

    def __init__(self, input_dim: int, out_dim: int, hidden: Optional[int] = None,
                 activation_fn: str = "gelu", device=None):
        super().__init__()
        hidden = hidden or input_dim
        self.linear1 = nn.Linear(input_dim, hidden, device=device)
        self.linear2 = nn.Linear(hidden, out_dim, device=device)
        self.activation_fn = utils.get_activation_fn(activation_fn)

    def forward(self, x):
        return self.linear2(self.activation_fn(self.linear1(x)))


class GaussianLayer(nn.Module):
    """Distance featurisation: a per-edge-type affine map of the distance,
    then ``kernels`` Gaussian basis functions with learned means/stds."""

    def __init__(self, kernels: int = 128, edge_types: int = 1024, device=None):
        super().__init__()
        self.mul = nn.Embedding(edge_types, 1, device=device)
        self.bias = nn.Embedding(edge_types, 1, device=device)
        self.means = nn.Parameter(torch.zeros(kernels, device=device))
        self.stds = nn.Parameter(torch.zeros(kernels, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.mul.weight.fill_(1.0)
        self.bias.weight.zero_()
        self.means.uniform_(0.0, 3.0, generator=generator)
        self.stds.uniform_(0.0, 3.0, generator=generator)

    def forward(self, dist, edge_type):
        # dist (B, L, L) -> (B, L, L, K)
        x = self.mul(edge_type)[..., 0] * dist + self.bias(edge_type)[..., 0]
        std = self.stds.abs() + 1e-5
        pre = -0.5 * torch.square((x[..., None] - self.means) / std)
        a = 1.0 / (std * math.sqrt(2 * math.pi))
        return (a * torch.exp(pre)).float()


class MaskLMHead(nn.Module):
    """Masked-atom head; the tied projection weight is passed in."""

    def __init__(self, embed_dim: int, output_dim: int, activation_fn: str = "gelu",
                 device=None):
        super().__init__()
        self.dense = nn.Linear(embed_dim, embed_dim, device=device)
        self.activation_fn = utils.get_activation_fn(activation_fn)
        self.layer_norm = LayerNorm(embed_dim, device=device)
        self.bias = nn.Parameter(torch.zeros(output_dim, device=device))

    def forward(self, features, embed_weight):
        x = self.layer_norm(self.activation_fn(self.dense(features)))
        return F.linear(x, embed_weight) + self.bias


class DistanceHead(nn.Module):
    """Pairwise distance regression from the pair representation."""

    def __init__(self, heads: int, activation_fn: str = "gelu", device=None):
        super().__init__()
        self.dense = nn.Linear(heads, heads, device=device)
        self.layer_norm = LayerNorm(heads, device=device)
        self.out_proj = nn.Linear(heads, 1, device=device)
        self.activation_fn = utils.get_activation_fn(activation_fn)

    def forward(self, pair):  # (B, L, L, H)
        x = self.layer_norm(self.activation_fn(self.dense(pair)))
        x = self.out_proj(x)[..., 0]
        return 0.5 * (x + x.transpose(1, 2))  # symmetrise


@register_model("unimol")
class UniMolModel(BaseUnicoreModel):
    def __init__(
        self,
        vocab_size: int = 32,
        padding_idx: int = 0,
        encoder_layers: int = 15,
        encoder_embed_dim: int = 512,
        encoder_ffn_embed_dim: int = 2048,
        encoder_attention_heads: int = 64,
        dropout: float = 0.1,
        emb_dropout: float = 0.1,
        attention_dropout: float = 0.1,
        activation_dropout: float = 0.0,
        activation_fn: str = "gelu",
        post_ln: bool = False,
        gaussian_kernels: int = 128,
        masked_token_loss: float = 1.0,
        masked_coord_loss: float = 1.0,
        masked_dist_loss: float = 1.0,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        H, K = encoder_attention_heads, gaussian_kernels
        self.padding_idx = padding_idx
        self.embed_tokens = nn.Embedding(vocab_size, encoder_embed_dim, device=device)
        self.gbf = GaussianLayer(kernels=K, edge_types=vocab_size ** 2, device=device)
        self.gbf_proj = NonLinearHead(K, H, hidden=K, activation_fn=activation_fn,
                                      device=device)
        self.encoder = TransformerEncoderWithPair(
            encoder_layers=encoder_layers,
            embed_dim=encoder_embed_dim,
            ffn_embed_dim=encoder_ffn_embed_dim,
            attention_heads=H,
            emb_dropout=emb_dropout,
            dropout=dropout,
            attention_dropout=attention_dropout,
            activation_dropout=activation_dropout,
            activation_fn=activation_fn,
            post_ln=post_ln,
            device=device,
        )
        self.lm_head = self.pair2coord_proj = self.dist_head = None
        if masked_token_loss > 0:
            self.lm_head = MaskLMHead(encoder_embed_dim, vocab_size,
                                      activation_fn=activation_fn, device=device)
        if masked_coord_loss > 0:
            self.pair2coord_proj = NonLinearHead(H, 1, hidden=H,
                                                 activation_fn=activation_fn,
                                                 device=device)
        if masked_dist_loss > 0:
            self.dist_head = DistanceHead(H, activation_fn=activation_fn, device=device)
        init_bert_params(self, generator)
        self.gbf.reset_parameters(generator)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--encoder-layers", type=int)
        parser.add_argument("--encoder-embed-dim", type=int)
        parser.add_argument("--encoder-ffn-embed-dim", type=int)
        parser.add_argument("--encoder-attention-heads", type=int)
        parser.add_argument("--emb-dropout", type=float, metavar="D")
        parser.add_argument("--dropout", type=float, metavar="D")
        parser.add_argument("--attention-dropout", type=float, metavar="D")
        parser.add_argument("--activation-dropout", type=float, metavar="D")
        parser.add_argument("--max-seq-len", type=int)
        parser.add_argument("--activation-fn", type=str)
        parser.add_argument("--post-ln", type=utils.str_to_bool)
        parser.add_argument("--gaussian-kernels", type=int,
                            help="number of Gaussian basis kernels for distances")
        parser.add_argument("--masked-token-loss", type=float)
        parser.add_argument("--masked-coord-loss", type=float)
        parser.add_argument("--masked-dist-loss", type=float)

    @classmethod
    def build_model(cls, args, task, device=None, generator=None):
        unimol_base_architecture(args)
        refuse_unported_parallelism(args, "Uni-Mol")
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
            activation_fn=args.activation_fn,
            post_ln=args.post_ln,
            gaussian_kernels=args.gaussian_kernels,
            masked_token_loss=args.masked_token_loss,
            masked_coord_loss=args.masked_coord_loss,
            masked_dist_loss=args.masked_dist_loss,
            device=device,
            generator=generator,
        )

    def forward(self, src_tokens, src_coord, src_distance, src_edge_type,
                features_only: bool = False, rng=None):
        """(logits, distance, coord, x_norm, delta_norm): logits (B, L,
        vocab), distance (B, L, L), coord (B, L, 3), the two regulariser
        norms; a head the loss weights leave out gives None.  With
        ``features_only``: (encoder_rep, pair_rep).  Dropout in training
        draws from ``rng`` (a :class:`DropoutRng`)."""
        padding_mask = (src_tokens == self.padding_idx).float()
        x = self.embed_tokens(src_tokens)
        # (B, L, L) distances -> (B, L, L, K) basis -> (B, H, L, L) pair bias
        gbf_feature = self.gbf(src_distance, src_edge_type)
        graph_attn_bias = self.gbf_proj(gbf_feature.to(x.dtype)).permute(0, 3, 1, 2)

        encoder_rep, pair_rep, delta_pair_rep, x_norm, delta_norm = self.encoder(
            x, attn_mask=graph_attn_bias, padding_mask=padding_mask, rng=rng
        )
        if features_only:
            return encoder_rep, pair_rep

        logits = encoder_coord = encoder_distance = None
        if self.lm_head is not None:
            logits = self.lm_head(encoder_rep, self.embed_tokens.weight)
        if self.pair2coord_proj is not None:
            # SE(3)-equivariant update: per-pair scalar weights from the
            # evolved pair channel, applied to direction vectors and
            # normalised by the neighbour count
            coord_emb = delta_pair_rep.permute(0, 2, 3, 1)  # (B, L, L, H)
            attn_probs = self.pair2coord_proj(coord_emb)[..., 0]  # (B, L, L)
            delta_pos = src_coord[:, :, None, :] - src_coord[:, None, :, :]
            num = torch.clamp(
                torch.sum(1 - padding_mask, dim=1, keepdim=True) - 1, min=1
            )[..., None]
            coord_update = torch.sum(attn_probs[..., None] * delta_pos, dim=2) / num
            encoder_coord = src_coord + coord_update
        if self.dist_head is not None:
            encoder_distance = self.dist_head(pair_rep.permute(0, 2, 3, 1))
        return logits, encoder_distance, encoder_coord, x_norm, delta_norm


@register_model_architecture("unimol", "unimol")
def unimol_base_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 15)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 512)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 2048)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 64)
    args.dropout = getattr(args, "dropout", 0.1)
    args.emb_dropout = getattr(args, "emb_dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.activation_dropout = getattr(args, "activation_dropout", 0.0)
    args.max_seq_len = getattr(args, "max_seq_len", 512)
    args.activation_fn = getattr(args, "activation_fn", "gelu")
    args.post_ln = getattr(args, "post_ln", False)
    args.gaussian_kernels = getattr(args, "gaussian_kernels", 128)
    args.masked_token_loss = getattr(args, "masked_token_loss", 1.0)
    args.masked_coord_loss = getattr(args, "masked_coord_loss", 5.0)
    args.masked_dist_loss = getattr(args, "masked_dist_loss", 10.0)


@register_model_architecture("unimol", "unimol_tiny")
def unimol_tiny_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 2)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 64)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 128)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads", 8)
    args.max_seq_len = getattr(args, "max_seq_len", 64)
    args.gaussian_kernels = getattr(args, "gaussian_kernels", 32)
    unimol_base_architecture(args)
