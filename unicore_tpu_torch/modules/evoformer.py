"""Evoformer building blocks (counterpart of ``unicore_tpu/modules/evoformer.py``,
with its class and parameter names).

- :class:`GatedAttention`: AF2-style gated multi-head attention over any
  leading dims, with a GROUPED bias (G, 1|H, Lq, Lk) over the flattened
  leading dims.  It routes as the JAX package does on a TPU: the direct
  flash route (``_flash_grouped`` of the attention router: pad to 128,
  the flash kernel with the bias indexed by group, never a materialised
  (N, H, L, L) bias) when :func:`_flash_ok` accepts the shape, else the
  fused-softmax route (``ops/softmax_dropout.py`` on the materialised
  scores, with the key mask as an additive -1e9).
- MSA row attention with pair bias, MSA column attention, the outer product
  mean, the triangle multiplications and attentions, the transitions,
  composed into :class:`EvoformerIteration` and :class:`EvoformerStack`.

Dropout is AF2's row-wise ``drop_row`` (one mask shared along dim 1) from
the trainer's :class:`DropoutRng`; attention itself runs at rate 0.  Weights
are drawn as the JAX package initialises them by :func:`init_evoformer_params`.
The JAX package's sequence-sharded (``seq_shard`` / ``seq_dim``),
rematerialised and pipelined stacks are not ported and raise.
"""

import math
from typing import Optional

import torch
from torch import nn

from unicore_tpu_torch.ops.softmax_dropout import softmax_dropout
from .dropout import dropout
from .layer_norm import LayerNorm
from .multihead_attention import _flash_grouped, _flash_pad_waste_ok
from .transformer_encoder import init_bert_params


def mask_to_bias(mask):
    """(..., L) 1 = valid -> additive (-1e9 at invalid)."""
    return (mask.float() - 1.0) * 1e9


def _flash_ok(N, Lq, Lk, head_dim, dtype, bias):
    """The JAX package's gate of the direct flash route, without its backend
    check (the port's kernel serves both devices: CUDA on the card, its
    plain version on the CPU): pad waste within budget, a head dim that is
    a multiple of 8, fp32/bf16, and a bias group count dividing N."""
    return (
        _flash_pad_waste_ok(Lq, Lk)
        and head_dim % 8 == 0
        and dtype in (torch.float32, torch.bfloat16)
        and (bias is None or N % bias.shape[0] == 0)
    )


class GatedAttention(nn.Module):
    """out = out_proj(sigmoid(gate_proj(q_x)) * attention(q_x, kv_x)).

    Inputs (*B, Lq, D_q) x (*B, Lk, D_kv); ``bias`` GROUPED (G, 1|H, Lq, Lk)
    with prod(B) % G == 0 (consecutive runs of prod(B) / G rows share a
    slab); ``kv_mask`` (*B, Lk), 1 = valid."""

    def __init__(self, embed_dim: int, num_heads: int, gating: bool = True,
                 device=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.gating = gating
        self.q_proj = nn.Linear(embed_dim, embed_dim, bias=False, device=device)
        self.k_proj = nn.Linear(embed_dim, embed_dim, bias=False, device=device)
        self.v_proj = nn.Linear(embed_dim, embed_dim, bias=False, device=device)
        if gating:
            self.gate_proj = nn.Linear(embed_dim, embed_dim, device=device)
        self.out_proj = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, q_x, kv_x, bias: Optional[torch.Tensor] = None,
                kv_mask: Optional[torch.Tensor] = None):
        H = self.num_heads
        head_dim = self.embed_dim // H
        if bias is not None and bias.ndim != 4:
            raise ValueError(
                f"GatedAttention bias must be GROUPED 4-d (G, 1|H, Lq, Lk) over "
                f"the flattened leading dims, got shape {tuple(bias.shape)}"
            )
        q = self.q_proj(q_x) * head_dim ** -0.5
        k = self.k_proj(kv_x)
        v = self.v_proj(kv_x)
        *lead, Lq, _ = q.shape
        Lk = k.shape[-2]

        def split(t, L):
            return t.reshape(*lead, L, H, head_dim).transpose(-2, -3)

        q, k, v = split(q, Lq), split(k, Lk), split(v, Lk)  # (*B, H, L, hd)
        N = math.prod(lead)
        if _flash_ok(N, Lq, Lk, head_dim, q.dtype, bias):
            kvm = None
            if kv_mask is not None:  # the kernel's mask: nonzero = masked out
                kvm = 1 - kv_mask.reshape(N, Lk).to(torch.int32)
            o = _flash_grouped(
                q.reshape(N, H, Lq, head_dim), k.reshape(N, H, Lk, head_dim),
                v.reshape(N, H, Lk, head_dim), bias, kvm, Lq, Lk,
            ).reshape(*lead, H, Lq, head_dim)
        else:
            s = torch.einsum("...hqd,...hkd->...hqk", q, k)
            if bias is not None:
                G = bias.shape[0]
                b5 = bias[:, None]  # (G, 1, 1|H, Lq, Lk)
                if kv_mask is not None:
                    b5 = b5 + mask_to_bias(kv_mask).reshape(G, N // G, 1, 1, Lk)
                probs = softmax_dropout(
                    s.reshape(G, N // G, H, Lq, Lk), 0.0, is_training=False, bias=b5,
                ).reshape(s.shape)
            elif kv_mask is not None:
                probs = softmax_dropout(s, 0.0, is_training=False,
                                        bias=mask_to_bias(kv_mask)[..., None, None, :])
            else:
                probs = softmax_dropout(s, 0.0, is_training=False)
            o = torch.einsum("...hqk,...hkd->...hqd", probs, v)
        o = o.transpose(-2, -3).reshape(*lead, Lq, self.embed_dim)
        if self.gating:
            o = torch.sigmoid(self.gate_proj(q_x)) * o
        return self.out_proj(o)


class MSARowAttentionWithPairBias(nn.Module):
    """Attention along the residue dim of each MSA row, biased by the pair
    representation: all R rows of sample b share bias slab b."""

    def __init__(self, embed_dim: int, pair_dim: int, num_heads: int, device=None):
        super().__init__()
        self.ln_m = LayerNorm(embed_dim, device=device)
        self.ln_z = LayerNorm(pair_dim, device=device)
        self.pair_bias = nn.Linear(pair_dim, num_heads, bias=False, device=device)
        self.attn = GatedAttention(embed_dim, num_heads, device=device)

    def forward(self, msa, pair, msa_mask=None):
        # msa (B, R, L, D_m); pair (B, L, L, D_z)
        m = self.ln_m(msa)
        bias = self.pair_bias(self.ln_z(pair)).permute(0, 3, 1, 2)  # (B, H, L, L)
        return self.attn(m, m, bias=bias, kv_mask=msa_mask)


class MSAColumnAttention(nn.Module):
    """Attention along the row dim of each MSA column."""

    def __init__(self, embed_dim: int, num_heads: int, device=None):
        super().__init__()
        self.ln_m = LayerNorm(embed_dim, device=device)
        self.attn = GatedAttention(embed_dim, num_heads, device=device)

    def forward(self, msa, msa_mask=None):
        mt = self.ln_m(msa).transpose(1, 2)  # (B, L, R, D)
        col_mask = msa_mask.transpose(1, 2) if msa_mask is not None else None
        return self.attn(mt, mt, kv_mask=col_mask).transpose(1, 2)


class OuterProductMean(nn.Module):
    """MSA -> pair update: the mean over rows of outer products."""

    def __init__(self, embed_dim: int, pair_dim: int, hidden: int = 32, device=None):
        super().__init__()
        self.ln = LayerNorm(embed_dim, device=device)
        self.proj_a = nn.Linear(embed_dim, hidden, device=device)
        self.proj_b = nn.Linear(embed_dim, hidden, device=device)
        self.out_proj = nn.Linear(hidden * hidden, pair_dim, device=device)

    def forward(self, msa, msa_mask=None):
        m = self.ln(msa)
        a, b = self.proj_a(m), self.proj_b(m)
        if msa_mask is not None:
            w = msa_mask.to(m.dtype)[..., None]
            a, b = a * w, b * w
            mf = msa_mask.float()
            # max (not + eps): an all-ones mask is exactly the R normalisation
            norm = torch.clamp(torch.einsum("bri,brj->bij", mf, mf), min=1e-3)[..., None]
        else:
            norm = msa.shape[1]
        outer = torch.einsum("brid,brje->bijde", a, b)
        # the fp32 norm promotes the quotient; the projection runs in m's
        # type, as the JAX Dense(dtype=m.dtype) casts its input
        outer = outer.reshape(*outer.shape[:3], -1) / norm
        return self.out_proj(outer.to(m.dtype))


class TriangleMultiplication(nn.Module):
    """Triangle multiplicative update; ``outgoing`` uses edges (i, k),
    (j, k), else (k, i), (k, j)."""

    def __init__(self, pair_dim: int, hidden: int = 128, outgoing: bool = True,
                 device=None):
        super().__init__()
        self.outgoing = outgoing
        self.ln_in = LayerNorm(pair_dim, device=device)
        self.a_proj = nn.Linear(pair_dim, hidden, device=device)
        self.b_proj = nn.Linear(pair_dim, hidden, device=device)
        self.a_gate = nn.Linear(pair_dim, hidden, device=device)
        self.b_gate = nn.Linear(pair_dim, hidden, device=device)
        self.ln_out = LayerNorm(hidden, device=device)
        self.out_proj = nn.Linear(hidden, pair_dim, device=device)
        self.out_gate = nn.Linear(pair_dim, pair_dim, device=device)

    def forward(self, pair, pair_mask=None):
        z = self.ln_in(pair)
        a = self.a_proj(z) * torch.sigmoid(self.a_gate(z))
        b = self.b_proj(z) * torch.sigmoid(self.b_gate(z))
        if pair_mask is not None:
            w = pair_mask.to(z.dtype)[..., None]
            a, b = a * w, b * w
        if self.outgoing:
            x = torch.einsum("bikd,bjkd->bijd", a, b)
        else:
            x = torch.einsum("bkid,bkjd->bijd", a, b)
        x = self.out_proj(self.ln_out(x))
        return x * torch.sigmoid(self.out_gate(z))


class TriangleAttention(nn.Module):
    """Triangle self-attention; ``starting`` attends along rows (starting
    node), else along columns (ending node).  Every lead row i of pair
    matrix b shares bias slab b."""

    def __init__(self, pair_dim: int, num_heads: int, starting: bool = True,
                 device=None):
        super().__init__()
        self.starting = starting
        self.ln = LayerNorm(pair_dim, device=device)
        self.tri_bias = nn.Linear(pair_dim, num_heads, bias=False, device=device)
        self.attn = GatedAttention(pair_dim, num_heads, device=device)

    def forward(self, pair, pair_mask=None):
        z = self.ln(pair if self.starting else pair.transpose(1, 2))
        bias = self.tri_bias(z).permute(0, 3, 1, 2)  # (B, H, I, J)
        pm = None
        if pair_mask is not None:
            pm = pair_mask if self.starting else pair_mask.transpose(1, 2)
        out = self.attn(z, z, bias=bias, kv_mask=pm)
        return out if self.starting else out.transpose(1, 2)


class Transition(nn.Module):
    """Pointwise 2-layer MLP with pre-LN (MSA and pair transitions)."""

    def __init__(self, dim: int, ratio: int = 4, device=None):
        super().__init__()
        self.ln = LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, dim * ratio, device=device)
        self.fc2 = nn.Linear(dim * ratio, dim, device=device)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(self.ln(x))))


class EvoformerIteration(nn.Module):
    def __init__(self, msa_dim: int = 256, pair_dim: int = 128, msa_heads: int = 8,
                 pair_heads: int = 4, dropout: float = 0.1, device=None):
        super().__init__()
        self.dropout = dropout
        self.msa_row_attn = MSARowAttentionWithPairBias(
            msa_dim, pair_dim, msa_heads, device=device)
        self.msa_col_attn = MSAColumnAttention(msa_dim, msa_heads, device=device)
        self.msa_transition = Transition(msa_dim, device=device)
        self.outer_product_mean = OuterProductMean(msa_dim, pair_dim, device=device)
        self.tri_mul_out = TriangleMultiplication(pair_dim, outgoing=True, device=device)
        self.tri_mul_in = TriangleMultiplication(pair_dim, outgoing=False, device=device)
        self.tri_attn_start = TriangleAttention(pair_dim, pair_heads, starting=True,
                                                device=device)
        self.tri_attn_end = TriangleAttention(pair_dim, pair_heads, starting=False,
                                              device=device)
        self.pair_transition = Transition(pair_dim, device=device)

    def forward(self, msa, pair, msa_mask=None, pair_mask=None, rng=None):
        def drop_row(x):  # one mask shared along dim 1 (AF2 row-wise dropout)
            return dropout(x, self.dropout, self.training, rng, broadcast_dims=(1,))

        msa = msa + drop_row(self.msa_row_attn(msa, pair, msa_mask))
        msa = msa + self.msa_col_attn(msa, msa_mask)
        msa = msa + self.msa_transition(msa)
        pair = pair + self.outer_product_mean(msa, msa_mask)
        pair = pair + drop_row(self.tri_mul_out(pair, pair_mask))
        pair = pair + drop_row(self.tri_mul_in(pair, pair_mask))
        pair = pair + drop_row(self.tri_attn_start(pair, pair_mask))
        pair = pair + drop_row(self.tri_attn_end(pair, pair_mask))
        pair = pair + self.pair_transition(pair)
        return msa, pair


class EvoformerStack(nn.Module):
    """``num_blocks`` :class:`EvoformerIteration` s in a plain loop, named
    ``block_{i}`` as in the JAX package.  ``remat`` (default False here;
    the JAX class defaults to True), ``remat_policy`` other than ''/'none',
    ``pipeline_stages > 1`` and ``seq_shard`` raise: the JAX package's
    ``modules/remat.py``, ``_pipeline_forward`` (GPipe over
    ``parallel/pipeline.py``) and sequence-sharded route are not ported."""

    def __init__(self, num_blocks: int = 48, msa_dim: int = 256, pair_dim: int = 128,
                 msa_heads: int = 8, pair_heads: int = 4, dropout: float = 0.1,
                 remat: bool = False, remat_policy: str = "", pipeline_stages: int = 0,
                 pipeline_microbatches: int = 4, seq_shard: bool = False, device=None):
        super().__init__()
        if remat or remat_policy not in ("", "none"):
            raise NotImplementedError(
                "activation rematerialisation of the Evoformer stack "
                "(unicore_tpu/modules/remat.py, EvoformerStack.remat / "
                "remat_policy) is not ported yet")
        if pipeline_stages > 1:
            raise NotImplementedError(
                "the pipelined Evoformer stack (unicore_tpu/modules/evoformer.py "
                "EvoformerStack._pipeline_forward) is not ported yet")
        if seq_shard:
            raise NotImplementedError(
                "the sequence-sharded Evoformer stack (unicore_tpu/modules/"
                "evoformer.py seq_shard / GatedAttention.seq_dim) is not ported yet")
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block_{i}", EvoformerIteration(
                msa_dim, pair_dim, msa_heads, pair_heads, dropout, device=device))

    def forward(self, msa, pair, msa_mask=None, pair_mask=None, rng=None):
        for i in range(self.num_blocks):
            msa, pair = getattr(self, f"block_{i}")(msa, pair, msa_mask, pair_mask, rng)
        return msa, pair


@torch.no_grad()
def init_evoformer_params(module: nn.Module, generator: Optional[torch.Generator] = None):
    """The JAX package's initialisers over a module tree: dense and
    embedding weights N(0, 0.02), biases 0 (``bert_init``), then AF2's
    zero-init final projections and gates (weights 0, gate biases 1) and
    the pair/triangle bias projections N(0, 1 / sqrt(pair_dim))."""
    init_bert_params(module, generator)

    def gate(lin):
        lin.weight.zero_()
        lin.bias.fill_(1.0)

    for m in module.modules():
        if isinstance(m, GatedAttention):
            if m.gating:
                gate(m.gate_proj)
            m.out_proj.weight.zero_()
        elif isinstance(m, (MSARowAttentionWithPairBias, TriangleAttention)):
            lin = m.pair_bias if isinstance(m, MSARowAttentionWithPairBias) else m.tri_bias
            lin.weight.normal_(0.0, lin.in_features ** -0.5, generator=generator)
        elif isinstance(m, TriangleMultiplication):
            for lin in (m.a_gate, m.b_gate, m.out_gate):
                gate(lin)
            m.out_proj.weight.zero_()
        elif isinstance(m, OuterProductMean):
            m.out_proj.weight.zero_()
        elif isinstance(m, Transition):
            m.fc2.weight.zero_()
