"""The port's full-row attention (unicore_tpu_torch/ops/attention_fullrow.py)
and its router (modules/multihead_attention.py) against the JAX package on
the CPU.

Inputs come from a numpy seed and go through both packages.  On a CPU
tensor the port's wrapper runs its plain version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py.

Tolerance: fp32 2e-5 absolute on outputs of magnitude ~1 — both sides
compute fp32 scores and an fp32 softmax and differ only in summation order.
Fully-masked rows must be exact zeros on every side.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.modules import multihead_attention as jax_mha
from unicore_tpu.ops import _pallas
from unicore_tpu.ops import attention_fullrow as jax_fr
from unicore_tpu.ops import softmax_dropout_pallas as jax_sdp
from unicore_tpu.ops.flash_attention import mha_reference

from unicore_tpu_torch.modules import multihead_attention as port_mha
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import attention_fullrow as port_fr
from unicore_tpu_torch.ops import softmax_dropout as port_sd

ATOL = 2e-5


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


def _inputs(B, H, L, D, bias_heads, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32)
               for _ in range(3))
    q *= D ** -0.5
    bias = (None if bias_heads is None else
            rng.standard_normal((1, bias_heads, L, L)).astype(np.float32))
    # ragged key mask: row 0 full, the middle rows ragged, the LAST row
    # fully masked (the serve engine's dummy fill rows are such rows)
    lens = np.linspace(L, L // 3, B).astype(np.int64)
    lens[-1] = 0
    mask = (np.arange(L)[None, :] >= lens[:, None]).astype(np.int32)
    return q, k, v, bias, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("L", [128, 256])
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("bias_heads", [None, 1, 3])
def test_plain_matches_jax(pallas_interpret, L, D, bias_heads):
    B, H = 3, 3
    q, k, v, bias, mask = _inputs(B, H, L, D, bias_heads, seed=L + D)
    _kernels.reset_launch_counts()
    port = port_fr.fullrow_attention(
        _t(q), _t(k), _t(v), bias=_t(bias), kv_padding_mask=_t(mask)
    ).numpy()
    ref = np.asarray(mha_reference(
        _j(q), _j(k), _j(v), bias=_j(bias), kv_padding_mask=_j(mask)
    ))
    kern = np.asarray(jax_fr.fullrow_attention(
        _j(q), _j(k), _j(v), bias=_j(bias), kv_padding_mask=_j(mask)
    ))
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(port, kern, rtol=0, atol=ATOL)
    # the fully-masked row is exact zeros everywhere
    assert not port[-1].any() and not ref[-1].any() and not kern[-1].any()
    assert port_fr.LAUNCHES.count == 0  # CPU tensors: plain path only


def test_wrapper_refusals():
    q = torch.zeros(1, 1, 128, 16)
    with pytest.raises(ValueError, match="dropout rate"):
        port_fr.fullrow_attention(q, q, q, dropout_rate=1.0)
    with pytest.raises(port_fr.KernelGeometryError):
        port_fr.fullrow_attention(torch.zeros(1, 1, 130, 16), q, q)
    with pytest.raises(port_fr.KernelGeometryError):
        port_fr.fullrow_attention(q, q, q, bias=torch.zeros(2, 1, 128, 128))


def test_supported_gate_matches_jax():
    for Lq, Lk, D, bb in itertools.product(
        [64, 128, 130, 384, 512, 1024, 1152],
        [128, 256, 1024, 2048],
        [8, 64, 128, 136],
        [None, 1, 4],
    ):
        for has_bias in (None, True, False):
            assert port_fr.supported(Lq, Lk, D, bb, has_bias) == \
                jax_fr.supported(Lq, Lk, D, bb, has_bias), (Lq, Lk, D, bb, has_bias)


def test_router_helpers_match_jax(pallas_interpret):
    dtypes = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.float16, jnp.float16)]
    for tq, tk, hd in itertools.product([1, 60, 100, 128, 200, 512],
                                        [60, 100, 128, 200, 512], [8, 12, 64]):
        assert port_mha._flash_pad(tq, tk) == jax_mha._flash_pad(tq, tk)
        assert port_mha._flash_pad_waste_ok(tq, tk) == \
            jax_mha._flash_pad_waste_ok(tq, tk)
        for td, jd in dtypes:
            assert port_mha._flash_ok(tq, tk, hd, td)[0] == \
                jax_mha._flash_ok(tq, tk, hd, jd)[0], (tq, tk, hd, td)
    B, H, L = 2, 3, 16
    for shape in [(L, L), (H, L, L), (1, L, L), (B * H, L, L), (4, L, L),
                  (1, H, L, L), (B, 1, L, L), (2 * B, H, L, L)]:
        x = np.zeros(shape, np.float32)
        pm = port_mha._bias_min_broadcast(torch.from_numpy(x), B, H, L, L)
        jm = jax_mha._bias_min_broadcast(jnp.asarray(x), B, H, L, L)
        assert (pm is None) == (jm is None), shape
        if pm is not None:
            assert tuple(pm.shape) == tuple(jm.shape), shape


@pytest.mark.parametrize("L,route", [(128, "fullrow"), (216, "fullrow"),
                                     (100, "fused"), (60, "fused")])
def test_attend_routes_match_jax(pallas_interpret, L, route):
    """The whole router, padding and refusals included: port vs JAX with
    the JAX kernels in interpret mode (so JAX routes as on a TPU)."""
    B, H, D = 2, 2, 16
    q, k, v, bias, mask = _inputs(B, H, L, D, H, seed=L)
    mask[-1, : L // 2] = 0  # no fully-masked row: the routes agree on all
    bias3 = bias[0]  # (H, L, L) as the encoder passes it
    assert port_mha._flash_pad_waste_ok(L, L) == (route == "fullrow")
    port = port_mha._attend(_t(q), _t(k), _t(v), _t(mask), _t(bias3), 0.1, False)
    ref, _, _ = jax_mha._attend(
        None, _j(q), _j(k), _j(v), _j(mask), _j(bias3), 0.1, False, False,
        True,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_attend_refuses_unported_flash_shapes():
    """Rows over 1024 and per-batch biases, which the full-row gate refuses,
    go to the online flash kernel, as in the JAX package (before it was
    ported the router raised for them): the router's answer is the flash
    attention's plain version on the same inputs, to the bit."""
    from unicore_tpu_torch.ops import flash_attention as port_fa

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1, 1152, 8, generator=g)
    got = port_mha._attend(q, q, q, None, None, 0.0, False)
    assert torch.equal(got, port_fa.flash_attention_plain(q, q, q))
    q = torch.randn(2, 2, 128, 8, generator=g)
    per_batch = torch.randn(2, 2, 128, 128, generator=g)
    got = port_mha._attend(q, q, q, None, per_batch, 0.0, False)
    assert torch.equal(got, port_fa.flash_attention_plain(q, q, q, per_batch))


def test_softmax_kernel_gate_matches_jax():
    """Where the JAX package on a TPU would run its softmax_dropout Pallas
    kernel, the port raises on CUDA tensors; the gate must agree."""
    for shape, extra in itertools.product(
        [(2, 3, 8, 128), (2, 3, 8, 100), (2, 3, 6, 128), (4, 8, 256),
         (2, 3, 8, 9216)],
        [None, (3, 8, 128), (1, 1, 8, 128), (2, 1, 1, 128), (4, 8, 256)],
    ):
        ext = None if extra is None else np.zeros(extra, np.float32)
        for dt, jdt in [(torch.float32, jnp.float32), (torch.float16, jnp.float16)]:
            j = jax_sdp.pallas_plan(shape, jdt, None, _j(ext)) is not None
            p = port_sd.kernel_would_run(shape, dt, None, _t(ext))
            assert p == j, (shape, extra, dt)


GRAD_TOL = 1e-5  # error over the reference's largest magnitude (at least 1)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("L,bias_heads", [(128, 3), (128, 1), (256, 3), (256, None)])
def test_plain_gradients_match_jax_grad(pallas_interpret, L, bias_heads):
    """dq, dk, dv and dbias of the port's plain path (autograd) against
    ``jax.grad`` of the JAX full-row kernels in interpret mode (their
    custom VJP runs the fused ``_bwd_kernel``), with a per-head (1,H,L,L)
    or shared (1,1,L,L) bias and a key mask holding a fully-masked row,
    dropout 0, fp32: the model of tests/test_attention_fullrow.py:74-104."""
    B, H, D = 2, 3, 32
    q, k, v, bias, mask = _inputs(B, H, L, D, bias_heads, seed=L + 5)
    do = np.random.default_rng(L).standard_normal((B, H, L, D)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in ((q, k, v) if bias is None else (q, k, v, bias))]
    out = port_fr.fullrow_attention(*leaves[:3], bias=leaves[3] if bias is not None else None,
                                    kv_padding_mask=_t(mask), sm_scale=0.8)
    out.backward(torch.from_numpy(do))

    def f(q, k, v, b=None):
        o = jax_fr.fullrow_attention(q, k, v, bias=b, kv_padding_mask=_j(mask),
                                     sm_scale=0.8)
        return jnp.sum(o * jnp.asarray(do))

    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    ref = jax.grad(f, argnums=argnums)(*[_j(a) for a in
                                         ((q, k, v) if bias is None else (q, k, v, bias))])
    for name, leaf, r in zip(("dq", "dk", "dv", "dbias"), leaves, ref):
        assert leaf.grad.shape == tuple(r.shape), name
        assert _rel(leaf.grad.numpy(), r) < GRAD_TOL, name


def test_philox_matches_known_answers():
    """The plain Philox4x32-10 (the same function as csrc/common.cuh) on
    Random123's published known-answer vectors."""
    kat = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in kat:
        got = port_fr.philox4x32_10(*(torch.tensor([c]) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want


def test_philox_mask_seeds_and_keep_rate():
    """Same seed, same mask; another seed, another mask; the keep rate
    within 5 binomial sigmas of 1 - rate; the threshold rule of the TPU
    kernels' ``_keep_mask``."""
    B, H, L, rate = 2, 3, 128, 0.1
    a = port_fr.philox_keep_plain(B, H, L, L, 11, rate)
    assert torch.equal(a, port_fr.philox_keep_plain(B, H, L, L, 11, rate))
    b = port_fr.philox_keep_plain(B, H, L, L, 12, rate)
    assert not torch.equal(a, b)
    n = a.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    for m in (a, b):
        assert abs(m.float().mean().item() - (1 - rate)) < 5 * sigma
    assert port_fr.dropout_threshold(rate) == int(rate * 2 ** 32)
    assert port_fr.dropout_threshold(1.0) == 2 ** 32 - 1
    assert port_fr.philox_keep_plain(1, 1, 4, 8, 3, 0.0).all()


def test_dropout_gradient_is_analytic_under_regenerated_mask():
    """With dropout, autograd of the plain path equals the analytic
    backward of ``_bwd_kernel`` under the mask regenerated from the seed:
    di = rowsum(pd * dp), ds = p * (dp_keep - di) zeroed on masked keys,
    dv = pd^T do, dq = s ds k, dk = s ds^T q, dbias = sum_b ds."""
    B, H, L, D, rate, seed, scale = 2, 3, 128, 16, 0.2, 99, 0.7
    q, k, v, bias, mask = _inputs(B, H, L, D, H, seed=3)
    do = np.random.default_rng(4).standard_normal((B, H, L, D)).astype(np.float32)
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (q, k, v, bias)]
    out = port_fr.fullrow_attention_plain(
        *[t.float() for t in leaves[:3]], leaves[3].float(), _t(mask), scale,
        rate, seed)
    out.backward(torch.from_numpy(do))

    qf, kf, vf, bf = (torch.from_numpy(a).double() for a in (q, k, v, bias))
    kvm = torch.from_numpy(mask != 0)[:, None, None, :]
    s = torch.where(kvm, -1e30, qf @ kf.transpose(-1, -2) * scale + bf)
    p = torch.where(kvm, 0.0, torch.softmax(s, -1))
    p = torch.where(p.sum(-1, keepdim=True) > 0, p, 0.0)
    keep = port_fr.philox_keep_plain(B, H, L, L, seed, rate)
    assert 0.75 < keep.double().mean() < 0.85
    inv = 1.0 / (1.0 - rate)
    pd = torch.where(keep, p * inv, 0.0)
    dp = torch.from_numpy(do).double() @ vf.transpose(-1, -2)
    dp_keep = torch.where(keep, dp * inv, 0.0)
    di = (pd * dp).sum(-1, keepdim=True)
    ds = torch.where(kvm, 0.0, p * (dp_keep - di))
    analytic = [scale * ds @ kf, scale * ds.transpose(-1, -2) @ qf,
                pd.transpose(-1, -2) @ torch.from_numpy(do).double(),
                ds.sum(0, keepdim=True)]
    for name, leaf, r in zip(("dq", "dk", "dv", "dbias"), leaves, analytic):
        assert _rel(leaf.grad.numpy(), r.numpy()) < 1e-5, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_heads", [3, 1])
def test_plain_backward_matches_jax_bwd_kernel(pallas_interpret, dtype, bias_heads):
    """``fullrow_attention_bwd_plain``, the backward kernel's function with
    its bf16 roundings (the plain version chip_smoke.py holds the CUDA
    backward against), against ``jax.grad`` of the JAX kernels in interpret
    mode, whose custom VJP runs ``_bwd_kernel``; at fp32 also against
    autograd of the plain forward.  Tolerance per element: 1e-5 of the
    reference's largest magnitude (at least 1; fp32 summation order), plus
    for bf16 ``bwd_rounding_slack`` (pd and ds may round to neighbouring
    bf16 values) and 2**-6 of the element (two bf16 ulps) where a side
    stores it in bf16."""
    B, H, L, D, scale = 2, 3, 128, 32, 0.8
    q, k, v, bias, mask = _inputs(B, H, L, D, bias_heads, seed=bias_heads + 40)
    do = np.random.default_rng(9).standard_normal((B, H, L, D)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    got = port_fr.fullrow_attention_bwd_plain(tq, tk, tv, _t(bias), _t(mask), tdo, scale)
    slack = list(port_fr.bwd_rounding_slack(tq, tk, tv, _t(bias), _t(mask), tdo, scale))

    def f(q, k, v, b):
        o = jax_fr.fullrow_attention(q, k, v, bias=b, kv_padding_mask=_j(mask),
                                     sm_scale=scale)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do).astype(jdt).astype(jnp.float32))

    refs = [[np.asarray(r.astype(jnp.float32)) for r in jax.grad(f, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a).astype(jdt) for a in (q, k, v)], _j(bias))]]
    if dtype == "float32":
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv, _t(bias))]
        out = port_fr.fullrow_attention_plain(*leaves[:3], leaves[3], _t(mask), scale)
        refs.append([r.numpy() for r in torch.autograd.grad(out, leaves, tdo)])
    for ref in refs:
        for name, g, r, s in zip(("dq", "dk", "dv", "dbias"), got, ref, slack + [0.0]):
            r = torch.from_numpy(r.copy())
            assert tuple(g.shape) == tuple(r.shape), name
            tol = 1e-5 * max(1.0, r.abs().max().item()) + s
            if dtype == "bfloat16" and name != "dbias":
                tol = tol + 2.0 ** -6 * r.abs()
            err = (g.float() - r).abs()
            assert (err <= tol).all(), (name, (err / tol).max().item())
