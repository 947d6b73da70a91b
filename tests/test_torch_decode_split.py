"""The split decode attention's arithmetic and the two kernels' choosers,
on the CPU.

``csrc/decode_attention.cu`` splits the rows of each (b, h) across S
blocks: a block streams its chunk's live rows in tiles of T, keeps an online
softmax (m, l, o) across its tiles, and the last block of the (b, h)
combines the S partials in split order (empty chunks and chunks of -inf
scores carry l = 0 and weight 0).  :func:`split_decode_emulation` repeats
that arithmetic in float32 torch ops; it is held against the JAX package's
``decode_attention_reference`` at 1e-6 absolute (the outputs are O(1)
convex combinations of V rows; both sides sum in fp32 in other orders) over
several S and T, positions 0 / middle / L - 1, junk past the positions,
-inf bias rows and int8 caches.  The kernel itself is held against
``decode_attention_plain`` on the card (tests/test_torch_gpu.py,
chip_smoke.py).

The choosers (``choose_splits`` for #12, ``choose_tile_n`` for #13) are
held at every shape ``chip_smoke.py`` phase 3 and the A/B tool run, and
for what the kernels require of them.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unicore_tpu_torch.ops import decode_attention as port_da
from unicore_tpu_torch.ops import quant_matmul as port_qm

jax_da = importlib.import_module("unicore_tpu.ops.decode_attention")

TOL = 1e-6
NEG_INF = torch.tensor(float("-inf"))


def split_decode_emulation(q, k, v, pos, bias, k_scale, v_scale, S, T):
    """The kernel's split-and-combine rule in float32 torch ops."""
    B, H, L, D = k.shape
    out = torch.empty(B, H, D)
    chunk = -(-L // S)
    for b in range(B):
        live = min(max(int(pos[b]) + 1, 1), L)
        for h in range(H):
            parts = []
            for s in range(S):
                r0 = s * chunk
                n = max(0, min(r0 + chunk, live) - r0)
                m, l, o = NEG_INF.clone(), torch.tensor(0.0), torch.zeros(D)
                for t0 in range(0, n, T):
                    rows = slice(r0 + t0, r0 + min(t0 + T, n))
                    kk = k[b, h, rows].float()
                    vv = v[b, h, rows].float()
                    if k_scale is not None:
                        kk, vv = kk * k_scale[h], vv * v_scale[h]
                    sc = kk @ q[b, h].float()
                    if bias is not None:
                        sc = sc + bias[b, h, rows]
                    m_new = torch.maximum(m, sc.max())
                    if m_new == NEG_INF:  # -inf scores so far: l and o stay 0
                        corr, p = torch.tensor(1.0), torch.zeros_like(sc)
                    else:
                        corr, p = torch.exp(m - m_new), torch.exp(sc - m_new)
                    l = l * corr + p.sum()
                    o = o * corr + p @ vv
                    m = m_new
                parts.append((m, l, o))
            if S == 1:
                out[b, h] = parts[0][2] / parts[0][1]
                continue
            mm = max((m for m, l, _ in parts if l > 0), default=NEG_INF)
            acc, total = torch.zeros(D), torch.tensor(0.0)
            for m, l, o in parts:
                if l > 0:
                    w = torch.exp(m - mm)
                    total = total + l * w
                    acc = acc + w * o
            out[b, h] = acc / total
    return out


def _inputs(B, H, L, D, seed, int8=False, neg_inf=False):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, D) * D ** -0.5).astype(np.float32)
    k = rng.randn(B, H, L, D).astype(np.float32)
    v = rng.randn(B, H, L, D).astype(np.float32)
    pos = np.array([0, L // 2, L - 1][:B], dtype=np.int32)
    bias = rng.randn(B, H, L).astype(np.float32)
    if neg_inf:
        bias[B - 1, 0, :min(L - 1, 24)] = -np.inf  # a whole chunk of -inf scores
        bias[B - 1, H - 1, 3] = -np.inf            # and one -inf entry
    scales = (None, None)
    if int8:
        ks = np.abs(k).max(axis=(0, 2)) / 127.0 + 1e-8
        vs = np.abs(v).max(axis=(0, 2)) / 127.0 + 1e-8
        k = np.clip(np.round(k / ks[None, :, None]), -127, 127).astype(np.int8)
        v = np.clip(np.round(v / vs[None, :, None]), -127, 127).astype(np.int8)
        scales = (ks.astype(np.float32), vs.astype(np.float32))
    for b, p in enumerate(pos):  # junk past each position: never read
        k[b, :, p + 1:] = 127 if int8 else 1e6
        v[b, :, p + 1:] = -127 if int8 else -1e6
    return q, k, v, pos, bias, scales


def _jax_reference(q, k, v, pos, bias, scales):
    ks, vs = scales
    out = jax_da.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(bias),
        None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs))
    return np.asarray(out, dtype=np.float32)


@pytest.mark.parametrize("S,T", [(1, 8), (2, 8), (3, 16), (8, 32), (16, 8)])
@pytest.mark.parametrize("case", ["fp32", "int8", "neg_inf"])
def test_split_emulation_matches_jax_reference(S, T, case):
    B, H, L, D = 3, 2, 96, 16
    q, k, v, pos, bias, scales = _inputs(B, H, L, D, seed=S * 31 + T, int8=case == "int8",
                                         neg_inf=case == "neg_inf")
    t = torch.as_tensor
    got = split_decode_emulation(t(q), t(k), t(v), t(pos), t(bias),
                                 None if scales[0] is None else t(scales[0]),
                                 None if scales[1] is None else t(scales[1]), S, T)
    ref = _jax_reference(q, k, v, pos, bias, scales)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("L", [1, 37, 300])
def test_split_emulation_at_the_chosen_split(L):
    """L not a multiple of the chunk, and a single row: the split the
    wrapper chooses, with the kernel's tile rows at D = 64 fp32 (32)."""
    B, H, D = 3, 4, 64
    q, k, v, pos, bias, scales = _inputs(B, H, L, D, seed=L, neg_inf=L > 30)
    S = port_da.choose_splits(B * H, L)
    t = torch.as_tensor
    got = split_decode_emulation(t(q), t(k), t(v), t(pos), t(bias), None, None, S, 32)
    np.testing.assert_allclose(got.numpy(), _jax_reference(q, k, v, pos, bias, scales),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("bh,L,want", [
    (8 * 12, 512, 8),   # phase 3 "serve" and phase 7's decode step at the top bucket
    (8 * 12, 384, 8),
    (8 * 12, 256, 8),
    (8 * 12, 128, 4),   # phase 3 "bucket128": 384 blocks of 32 rows
    (2 * 2, 64, 2),     # the CPU rehearsal's shape: two chunks of 32
    (3 * 2, 37, 1),
    (2 * 3, 1, 1),
    (1, 100000, 512),   # one long cache: the split count stops at the target
])
def test_choose_splits_at_the_checked_shapes(bh, L, want):
    assert port_da.choose_splits(bh, L) == want


def test_choose_splits_is_a_function_of_the_shape_and_fits_the_kernel():
    """Same answer on every call; the kernel takes 1 <= S <= min(L, 512);
    once split, every chunk keeps MIN_SPLIT_ROWS rows; S stops at the
    first count that reaches TARGET_BLOCKS."""
    for bh in (1, 3, 12, 96, 400, 600):
        for L in (1, 2, 31, 32, 63, 64, 65, 128, 129, 511, 512, 2048):
            s = port_da.choose_splits(bh, L)
            assert s == port_da.choose_splits(bh, L)
            assert 1 <= s <= min(L, 512)
            if s > 1:
                assert -(-L // s) >= port_da.MIN_SPLIT_ROWS
                assert bh * (s // 2) < port_da.TARGET_BLOCKS


@pytest.mark.parametrize("M,K,N,want", [
    (4096, 768, 2304, 192),  # in_proj: 384 tiles, 3 full waves
    (4096, 768, 768, 192),   # out_proj and the LM head: 128 tiles for 132 SMs
    (4096, 768, 3072, 128),  # fc1: 128, 192 and 256 tie at 768 columns of waves
    (4096, 3072, 768, 192),  # fc2
    (4093, 768, 2304, 192),  # odd_m
    (256, 64, 192, 128),     # the CPU rehearsal's in_proj
    (1, 32, 8, 128),
])
def test_choose_tile_n_at_the_checked_shapes(M, K, N, want):
    assert port_qm.choose_tile_n(M, K=K, N=N) == want


def test_choose_tile_n_minimises_the_waves_narrowest_on_a_tie():
    for M in (1, 100, 4093, 4096, 9000):
        for N in (8, 40, 136, 768, 2304, 3072, 4096):
            got = port_qm.choose_tile_n(M, N, 768)
            assert got in port_qm.TILE_NS and got == port_qm.choose_tile_n(M, N, 3072)

            def cost(bn):
                tiles = -(-M // port_qm.TILE_M) * -(-N // bn)
                return -(-tiles // port_qm.SMS) * bn

            best = min(cost(bn) for bn in port_qm.TILE_NS)
            assert cost(got) == best
            assert got == min(bn for bn in port_qm.TILE_NS if cost(bn) == best)
