"""Evoformer model for masked-MSA pretraining (counterpart of
``unicore_tpu/models/evoformer_model.py``; BASELINE.json config 4).

AF2-style input embedder: MSA tokens -> the msa channel; the target (first
row) tokens, outer-summed, plus bucketed relative positions -> the pair
channel; an :class:`EvoformerStack` refines both; a masked-MSA head on the
normalised msa predicts the corrupted positions.  Weights are drawn as the
JAX package initialises them (:func:`init_evoformer_params`, the head's
kernel zero), from a ``torch.Generator``.
"""

from typing import Optional

import torch
from torch import nn

from unicore_tpu_torch.data.data_utils import pad_to_multiple_size
from unicore_tpu_torch.models import register_model, register_model_architecture
from unicore_tpu_torch.models.unicore_model import BaseUnicoreModel
from unicore_tpu_torch.modules import LayerNorm, make_rp_bucket
from unicore_tpu_torch.modules.evoformer import EvoformerStack, init_evoformer_params


def _remat_policy(args) -> str:
    """The JAX ``resolve_remat_policy``: ``--remat-policy`` wins, else the
    deprecated ``--activation-checkpoint`` means 'all', else 'none'."""
    policy = getattr(args, "remat_policy", None)
    if policy is not None:
        return policy
    return "all" if getattr(args, "activation_checkpoint", False) else "none"


@register_model("evoformer")
class EvoformerModel(BaseUnicoreModel):
    def __init__(
        self,
        vocab_size: int = 32,
        padding_idx: int = 0,
        num_blocks: int = 4,
        msa_dim: int = 128,
        pair_dim: int = 64,
        msa_heads: int = 8,
        pair_heads: int = 4,
        dropout: float = 0.1,
        max_seq_len: int = 256,
        rel_pos_bins: int = 32,
        remat_policy: str = "",
        pipeline_stages: int = 0,
        seq_shard: bool = False,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.padding_idx = padding_idx
        self.msa_embed = nn.Embedding(vocab_size, msa_dim, device=device)
        self.target_embed_i = nn.Embedding(vocab_size, pair_dim, device=device)
        self.target_embed_j = nn.Embedding(vocab_size, pair_dim, device=device)
        self.rel_pos_embed = nn.Embedding(rel_pos_bins, pair_dim, device=device)
        # the collater rounds L up to a multiple of 8: the table covers the
        # padded maximum
        self.register_buffer(
            "rp_bucket",
            torch.as_tensor(make_rp_bucket(pad_to_multiple_size(max_seq_len, 8),
                                           rel_pos_bins, 128), device=device),
            persistent=False,
        )
        self.evoformer = EvoformerStack(
            num_blocks=num_blocks, msa_dim=msa_dim, pair_dim=pair_dim,
            msa_heads=msa_heads, pair_heads=pair_heads, dropout=dropout,
            remat_policy=remat_policy, pipeline_stages=pipeline_stages,
            seq_shard=seq_shard, device=device,
        )
        self.masked_msa_head = nn.Linear(msa_dim, vocab_size, device=device)
        self.msa_norm = LayerNorm(msa_dim, device=device)
        init_evoformer_params(self, generator)
        with torch.no_grad():
            self.masked_msa_head.weight.zero_()

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--num-blocks", type=int, help="evoformer blocks")
        parser.add_argument("--msa-dim", type=int)
        parser.add_argument("--pair-dim", type=int)
        parser.add_argument("--msa-heads", type=int)
        parser.add_argument("--pair-heads", type=int)
        parser.add_argument("--dropout", type=float)
        parser.add_argument("--max-seq-len", type=int)
        parser.add_argument("--activation-checkpoint", action="store_true",
                            help="DEPRECATED: same as --remat-policy all (not "
                                 "ported: raises)")
        parser.add_argument("--pipeline-microbatches", type=int,
                            help="GPipe microbatches per update when "
                                 "--pipeline-parallel-size > 1 (not ported)")

    @classmethod
    def build_model(cls, args, task, device=None, generator=None):
        evoformer_base_architecture(args)
        pp = getattr(args, "pipeline_parallel_size", 1)
        return cls(
            vocab_size=len(task.dictionary),
            padding_idx=task.dictionary.pad(),
            num_blocks=args.num_blocks,
            msa_dim=args.msa_dim,
            pair_dim=args.pair_dim,
            msa_heads=args.msa_heads,
            pair_heads=args.pair_heads,
            dropout=args.dropout,
            max_seq_len=args.max_seq_len,
            remat_policy=_remat_policy(args),
            pipeline_stages=pp if pp > 1 else 0,
            seq_shard=getattr(args, "seq_parallel_size", 1) > 1,
            device=device,
            generator=generator,
        )

    def forward(self, src_msa, rng=None, **unused):
        """(logits (B, R, L, vocab), pair (B, L, L, pair_dim)) for
        ``src_msa`` (B, R, L) tokens, row 0 the target sequence.  Dropout in
        training draws from ``rng`` (a :class:`DropoutRng`)."""
        B, R, L = src_msa.shape
        if L > self.rp_bucket.shape[0]:
            raise ValueError(f"sequence length {L} exceeds the rel-pos table "
                             f"({self.rp_bucket.shape[0]}); raise --max-seq-len")
        msa_mask = (src_msa != self.padding_idx).float()
        target = src_msa[:, 0]
        seq_ok = (target != self.padding_idx).float()
        pair_mask = seq_ok[:, :, None] * seq_ok[:, None, :]

        msa = self.msa_embed(src_msa)
        pair = (self.target_embed_i(target)[:, :, None, :]
                + self.target_embed_j(target)[:, None, :, :])
        pair = pair + self.rel_pos_embed(self.rp_bucket[:L, :L])[None]
        msa, pair = self.evoformer(msa, pair, msa_mask=msa_mask, pair_mask=pair_mask,
                                   rng=rng)
        return self.masked_msa_head(self.msa_norm(msa)), pair


@register_model_architecture("evoformer", "evoformer")
def evoformer_base_architecture(args):
    args.num_blocks = getattr(args, "num_blocks", 12)
    args.msa_dim = getattr(args, "msa_dim", 256)
    args.pair_dim = getattr(args, "pair_dim", 128)
    args.msa_heads = getattr(args, "msa_heads", 8)
    args.pair_heads = getattr(args, "pair_heads", 4)
    args.dropout = getattr(args, "dropout", 0.1)
    args.max_seq_len = getattr(args, "max_seq_len", 256)


@register_model_architecture("evoformer", "evoformer_tiny")
def evoformer_tiny_architecture(args):
    args.num_blocks = getattr(args, "num_blocks", 2)
    args.msa_dim = getattr(args, "msa_dim", 32)
    args.pair_dim = getattr(args, "pair_dim", 16)
    args.msa_heads = getattr(args, "msa_heads", 4)
    args.pair_heads = getattr(args, "pair_heads", 4)
    args.max_seq_len = getattr(args, "max_seq_len", 64)
    evoformer_base_architecture(args)
