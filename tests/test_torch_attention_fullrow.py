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
    with pytest.raises(NotImplementedError, match="dropout"):
        port_fr.fullrow_attention(q, q, q, dropout_rate=0.1)
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
    """Rows over 1024 and per-batch biases go to the JAX package's online
    flash kernel, which is not ported: the port raises, naming it."""
    q = torch.zeros(1, 1, 1152, 8)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        port_mha._attend(q, q, q, None, None, 0.0, False)
    q = torch.zeros(2, 2, 128, 8)
    per_batch = torch.zeros(2, 2, 128, 128)
    with pytest.raises(NotImplementedError, match="flash_attention"):
        port_mha._attend(q, q, q, None, per_batch, 0.0, False)


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
