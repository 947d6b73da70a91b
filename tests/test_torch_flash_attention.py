"""The port's flash attention (unicore_tpu_torch/ops/flash_attention.py) and
the repaired attention router against the JAX package on the CPU.

Inputs come from a numpy seed.  The JAX side runs its Pallas flash kernels
(``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``, ``_db_kernel``) in
interpret mode, as tests/test_flash_attention.py runs them, through a
fixture that restores the process-global interpret switch; the port's side
runs ``flash_attention_plain`` (autograd gives its gradient), the function
the CUDA kernels are held against on the card by chip_smoke.py.  The JAX
flash dropout uses the TPU's own bits and runs only on a TPU, so dropout is
held against the port's full-row attention instead: both draw the same
Philox bits.

Tolerances: fp32 outputs 2e-5 absolute (magnitude ~1: both sides take fp32
scores and softmax and differ in summation order and exp's last bits);
fp32 gradients 5e-5 of the tensor's largest magnitude (at least 1): the
flash backward recomputes p from lse and sums dbias over up to 4 batches
and 2 heads.  bf16 gradients: the plain backward rounds ds and the dropped
p to bf16 as the kernels do, so a rounding may land one bf16 ulp apart
(``bwd_rounding_slack``) on top of the fp32 allowance, plus two bf16 ulps
of the element for the bf16 outputs.  Fully masked rows must give exact
zeros, output and gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.modules import multihead_attention as jax_mha
from unicore_tpu.ops import _pallas
from unicore_tpu.ops import flash_attention as jax_fa

from unicore_tpu_torch.modules import multihead_attention as port_mha
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import attention_fullrow as port_fr
from unicore_tpu_torch.ops import flash_attention as port_fa

ATOL = 2e-5
GRAD_TOL = 5e-5
BF16_ULPS = 2.0 ** -6


@pytest.fixture
def pallas_interpret():
    """Run the JAX Pallas kernels in interpret mode for one test, restoring
    the process-global override exactly as it was."""
    saved = _pallas._override
    _pallas.set_interpret(True)
    try:
        yield
    finally:
        _pallas._override = saved


def _inputs(B, H, L, D, bias_shape, masked, seed):
    """q, k, v, do, bias, key mask as numpy fp32 / int32; the mask's last
    row masks every key (padded residues give such rows)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(4))
    q *= D ** -0.5
    bias = None if bias_shape is None else rng.standard_normal(bias_shape).astype(np.float32)
    mask = None
    if masked:
        lens = np.linspace(L, L // 3, B).astype(np.int64)
        lens[-1] = 0
        mask = (np.arange(L)[None, :] >= lens[:, None]).astype(np.int32)
    return q, k, v, do, bias, mask


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close_grad(got, ref, what, slack=0.0, bf16=False):
    got, ref = got.double(), ref.double()
    tol = GRAD_TOL * max(1.0, ref.abs().max().item()) + slack
    if bf16:
        tol = tol + BF16_ULPS * ref.abs()
    err = (got - ref).abs()
    assert bool(torch.isfinite(got).all()) and bool((err <= tol).all()), (
        what, err.max().item())


# (batch, heads, L, bias (Bb, Hb) or None, key mask): the bias groups of
# the JAX kernel's _bias_index -- shared (Bb = 1), grouped (1 < Bb < B, the
# Evoformer's), per batch (Bb = B) -- each with a per-head and a shared bias
CASES = [
    (4, 2, 128, (1, 2), True),
    (4, 2, 128, (1, 1), False),
    (4, 2, 128, (2, 2), True),
    (4, 2, 256, (2, 1), True),
    (4, 2, 256, (4, 2), False),
    (4, 2, 128, (4, 1), True),
    (2, 2, 256, None, True),
]


@pytest.mark.parametrize("B,H,L,bias_bh,masked", CASES)
def test_plain_matches_jax_flash(pallas_interpret, B, H, L, bias_bh, masked):
    """Forward and every gradient (dq, dk, dv, dbias) of the port's plain
    version against the JAX Pallas kernels (interpret mode)."""
    D = 16
    bias_shape = None if bias_bh is None else (bias_bh[0], bias_bh[1], L, L)
    q, k, v, do, bias, mask = _inputs(B, H, L, D, bias_shape, masked, seed=B + L)
    scale = 0.7
    jargs = [_j(q), _j(k), _j(v)] + ([_j(bias)] if bias is not None else [])

    def jf(*xs):
        return jax_fa.flash_attention(xs[0], xs[1], xs[2],
                                      bias=xs[3] if bias is not None else None,
                                      kv_padding_mask=_j(mask), sm_scale=scale)

    jout, vjp = jax.vjp(jf, *jargs)
    jgrads = vjp(_j(do))

    leaves = [_t(x).requires_grad_(True) for x in (q, k, v) + ((bias,) if bias is not None else ())]
    out = port_fa.flash_attention(leaves[0], leaves[1], leaves[2],
                                  bias=leaves[3] if bias is not None else None,
                                  kv_padding_mask=_t(mask), sm_scale=scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=ATOL)
    grads = torch.autograd.grad(out, leaves, _t(do))
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), grads, jgrads):
        _close_grad(g, _t(np.asarray(r)), name)
    if masked:  # the fully masked row: exact zeros out and in dq
        assert out[-1].abs().max().item() == 0.0
        assert grads[0][-1].abs().max().item() == 0.0
    # the plain backward (the kernels' function) is autograd's at fp32
    _, lse = port_fa.flash_attention_fwd_plain(*map(_t, (q, k, v, bias, mask)), scale)
    bwd = port_fa.flash_attention_bwd_plain(*map(_t, (q, k, v, bias, mask)), out.detach(),
                                            lse, _t(do), scale)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), bwd, grads):
        _close_grad(g, r, f"bwd_plain {name}")
    assert sum(_kernels.launch_counts().values()) == 0


def _mm(a, b, three=True):
    """a @ b as the backward kernels' tensor cores take an fp32 product:
    both operands split by ``tf32_split_plain`` and summed as hi hi + hi lo
    + lo hi in fp32 (3xTF32), or, for ``three=False``, one plain TF32
    product hi hi."""
    (ah, al), (bh, bl) = port_fr.tf32_split_plain(a), port_fr.tf32_split_plain(b)
    return ah @ bh + ah @ bl + al @ bh if three else ah @ bh


def _tf32_backward(q, k, v, bias, mask, do, three):
    """dq, dk, dv, dbias from ``bwd_plain_terms``' definitions (p from the
    forward's lse, di = rowsum(out * do), ds = p (dp - di), 0 at masked
    keys) with every product -- s, dp, dq, dk, dv -- taken as :func:`_mm`
    takes it; fp32, dropout 0, sm_scale 1."""
    out, lse = port_fa.flash_attention_fwd_plain(q, k, v, bias, mask)
    kvm = (mask != 0)[:, None, None, :]
    s = _mm(q, k.transpose(-1, -2), three) + bias
    p = torch.where(kvm, 0.0, torch.exp(s - lse[..., None]))
    dp = _mm(do, v.transpose(-1, -2), three)
    di = (out * do).sum(-1, keepdim=True)
    ds = torch.where(kvm, 0.0, p * (dp - di))
    return (_mm(ds, k, three), _mm(ds.transpose(-1, -2), q, three),
            _mm(p.transpose(-1, -2), do, three), ds.sum(0, keepdim=True))


def test_3xtf32_backward_holds_the_jax_gradients(pallas_interpret):
    """The arithmetic of the tensor-core backward (every product 3xTF32:
    hi hi + hi lo + lo hi of ``tf32_split_plain``'s halves, fp32 sums) at
    the triangle attention's head dim, (4, 4, 256, 32) with a (1, 4, 256,
    256) bias and a key mask whose last row masks every key: dq, dk, dv
    and dbias against ``jax.vjp`` of the JAX Pallas flash kernels
    (interpret mode) within GRAD_TOL, and exact zeros for the fully masked
    row.  One plain TF32 product (hi hi) misses that tolerance, which is
    why the kernels never take one on fp32 inputs."""
    B, H, L, D = 4, 4, 256, 32
    q, k, v, do, bias, mask = _inputs(B, H, L, D, (1, H, L, L), True, seed=808)

    def jf(*xs):
        return jax_fa.flash_attention(xs[0], xs[1], xs[2], bias=xs[3],
                                      kv_padding_mask=_j(mask))

    _, vjp = jax.vjp(jf, _j(q), _j(k), _j(v), _j(bias))
    jgrads = [_t(np.asarray(g)) for g in vjp(_j(do))]
    args = [_t(x) for x in (q, k, v, bias, mask, do)]
    three = _tf32_backward(*args, three=True)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), three, jgrads):
        _close_grad(g, r, f"3xTF32 {name}")
    assert three[0][-1].abs().max().item() == 0.0
    one = _tf32_backward(*args, three=False)
    worst = max(((g.double() - r.double()).abs().max()
                 / (GRAD_TOL * max(1.0, r.abs().max().item()))).item()
                for g, r in zip(one, jgrads))
    assert worst > 1.0, worst


def _tf32_forward(q, k, v, bias, mask, three):
    """(out, lse) of the tensor-core forward's arithmetic (fp32, dropout 0,
    sm_scale 1): s = q k^T taken as :func:`_mm` takes it, plus the bias,
    NEG_INF at masked keys; an online softmax over 64-key tiles (running max
    m and sum l, p exactly 0 at masked keys); each tile's p rounded to v's
    type (fp32 here) and added as p v through :func:`_mm`; out = acc / l
    where l > 0, and lse = m + log(max(l, 1e-37))."""
    kvm = (mask != 0)[:, None, None, :]
    s_all = torch.where(kvm, port_fr.NEG_INF, _mm(q, k.transpose(-1, -2), three) + bias)
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for j in range(0, k.shape[2], 64):
        s, km = s_all[..., j:j + 64], kvm[..., j:j + 64]
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - mn)
        p = torch.where(km, 0.0, torch.exp(s - mn))
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm(p.to(v.dtype).float(), v[..., j:j + 64, :], three)
        m = mn
    out = acc * torch.where(l > 0.0, 1.0 / torch.where(l > 0.0, l, 1.0), 0.0)
    return out, (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]


def test_3xtf32_forward_holds_the_jax_forward(pallas_interpret):
    """The arithmetic of the tensor-core forward (3xTF32 products, an online
    softmax over 64-key tiles, p rounded to v's type before p v) at the
    triangle attention's head dim, (4, 4, 256, 32) with a (1, 4, 256, 256)
    bias and a key mask whose last row masks every key: out within ATOL
    and lse within 1e-5 of the JAX Pallas flash forward (interpret mode),
    exact zeros on the fully masked row.  One plain TF32 product (hi hi)
    misses ATOL."""
    B, H, L, D = 4, 4, 256, 32
    q, k, v, _, bias, mask = _inputs(B, H, L, D, (1, H, L, L), True, seed=909)
    jout, jlse = jax_fa._fwd(_j(q), _j(k), _j(v), _j(bias), _j(mask)[:, None, :],
                             jnp.zeros((1,), jnp.int32), 1.0, 0.0, 256, 512)
    jout, jlse = _t(np.asarray(jout)), _t(np.asarray(jlse)[..., 0])
    args = [_t(x) for x in (q, k, v, bias, mask)]
    out, lse = _tf32_forward(*args, three=True)
    assert (out - jout).abs().max().item() <= ATOL
    assert (lse - jlse).abs().max().item() <= 1e-5
    assert out[-1].abs().max().item() == 0.0 and float(lse[-1].max()) <= -1e29
    one, _ = _tf32_forward(*args, three=False)
    assert (one - jout).abs().max().item() > ATOL


def test_lse_and_fully_masked_rows():
    """lse = logsumexp of the masked scores; a fully masked row gives lse
    ~ NEG_INF (m + log(1e-37) with m = -1e30) and zero output."""
    q, k, v, _, bias, mask = _inputs(3, 2, 128, 8, (1, 2, 128, 128), True, seed=5)
    out, lse = port_fa.flash_attention_fwd_plain(*map(_t, (q, k, v, bias, mask)))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) + bias
    s = np.where(mask[:, None, None, :] != 0, -np.inf, s)
    ref = np.log(np.exp(s[:2]).sum(-1))
    np.testing.assert_allclose(lse[:2].numpy(), ref, rtol=0, atol=1e-5)
    assert float(lse[2].max()) <= -1e29 and out[2].abs().max().item() == 0.0


def test_bf16_backward_rounds_as_the_kernels(pallas_interpret):
    """bf16 inputs: the plain backward (ds and the dropped p rounded to bf16
    before their products) against the JAX kernels' gradients, from the JAX
    forward's own output and lse."""
    B, H, L, D = 2, 2, 128, 16
    q, k, v, do, bias, mask = _inputs(B, H, L, D, (1, H, L, L), True, seed=11)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    out, lse = jax_fa._fwd(bf[0], bf[1], bf[2], _j(bias), _j(mask)[:, None, :],
                           jnp.zeros((1,), jnp.int32), 1.0, 0.0, 256, 512)
    jgrads = jax_fa._bwd(bf[0], bf[1], bf[2], _j(bias), _j(mask)[:, None, :],
                         jnp.zeros((1,), jnp.int32), 1.0, 0.0, 256, 512, out, lse, bf[3])
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                       for x in bf)
    tout = torch.from_numpy(np.array(out.astype(jnp.float32))).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse)[..., 0])
    args = (tq, tk, tv, _t(bias), _t(mask), tout, tlse, tdo)
    got = port_fa.flash_attention_bwd_plain(*args)
    slack = list(port_fa.bwd_rounding_slack(*args)) + [0.0]
    for name, g, r, s in zip(("dq", "dk", "dv", "dbias"), got, jgrads, slack):
        ref = torch.from_numpy(np.array(r.astype(jnp.float32)))
        assert g.dtype == (torch.float32 if name == "dbias" else torch.bfloat16), name
        _close_grad(g.float(), ref, name, slack=s, bf16=name != "dbias")


def test_flash_and_fullrow_drop_the_same_elements():
    """At a shape both take, the flash and full-row plain versions with the
    same seed drop the same probabilities (one Philox stream keyed on
    (key column / 4, query row, head, batch)): equal outputs and gradients.
    Dropout there is deterministic in the seed and keeps about 1 - rate."""
    q, k, v, do, bias, mask = _inputs(2, 2, 128, 16, (1, 2, 128, 128), True, seed=3)
    rate, seed = 0.1, 1234

    def run(fn):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v, bias)]
        out = fn(*leaves[:3], leaves[3], _t(mask), 1.0, rate, seed)
        return out, torch.autograd.grad(out, leaves, _t(do))

    fo, fg = run(port_fa.flash_attention_plain)
    ro, rg = run(port_fr.fullrow_attention_plain)
    np.testing.assert_allclose(fo.detach().numpy(), ro.detach().numpy(), rtol=0, atol=1e-6)
    for g, r in zip(fg, rg):
        _close_grad(g, r, "grad")
    again, _ = run(port_fa.flash_attention_plain)
    assert torch.equal(again, fo)
    other, _ = run(lambda *a: port_fa.flash_attention_plain(*a[:-1], seed + 1))
    assert not torch.equal(other, fo)
    keep = port_fr.philox_keep_plain(2, 2, 128, 128, seed, rate)
    assert abs(keep.float().mean().item() - (1 - rate)) < 5 * (rate * (1 - rate) / keep.numel()) ** 0.5


@pytest.mark.parametrize("case", ["rows_1152", "per_batch_bias"])
def test_router_sends_fullrow_refusals_to_flash(pallas_interpret, case):
    """The repaired router: shapes the full-row gate refuses (rows over
    1024, a per-batch bias) run the flash attention, where the JAX router
    sends them (``_flash_grouped`` with ``try_fullrow``): same answers."""
    if case == "rows_1152":
        B, H, L, D, bias = 1, 1, 1152, 8, None
    else:
        B, H, L, D = 2, 2, 100, 8  # padded to 128 by the router
        bias = np.random.default_rng(2).standard_normal((B, H, L, L)).astype(np.float32)
    q, k, v, _, _, mask = _inputs(B, H, L, D, None, True, seed=L)
    mask[-1, : L // 2] = 0  # no fully masked row: both routes agree on all
    assert not port_fr.supported(L + (-L) % 128, L + (-L) % 128, D,
                                 None if bias is None else B)
    got = port_mha._attend(_t(q), _t(k), _t(v), _t(mask), _t(bias), 0.0, False)
    ref, _, _ = jax_mha._attend(None, _j(q), _j(k), _j(v), _j(mask), _j(bias), 0.0,
                                False, False, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_refuses_what_the_jax_kernel_refuses():
    """Bias groups that do not divide the batch, bias heads other than 1 or
    H, and lengths off the 128 tiling raise, as the JAX ``flash_attention``
    and its ``_pick_block`` do; a rate outside [0, 1) raises."""
    q = torch.zeros(4, 2, 128, 8)
    for bad in (torch.zeros(3, 2, 128, 128), torch.zeros(1, 3, 128, 128),
                torch.zeros(2, 128, 128, 1, 1)):
        with pytest.raises(port_fr.KernelGeometryError):
            port_fa.flash_attention(q, q, q, bias=bad)
    with pytest.raises(port_fr.KernelGeometryError):
        port_fa.flash_attention(torch.zeros(1, 1, 100, 8), q[:1, :1], q[:1, :1])
    with pytest.raises(ValueError):
        port_fa.flash_attention(q, q, q, dropout_rate=1.0)
