"""The port's LayerNorm/RMSNorm forward (``fused_norm_plain`` and
``fused_norm_stats_plain`` in unicore_tpu_torch/ops/fused_norm.py, the
yardsticks of the CUDA forward kernel, and the CPU training route through
``fused_layer_norm`` / ``fused_rms_norm``) and the int8-input LayerNorm
(``quant_layer_norm_plain``) against the JAX package's Pallas forward on
the CPU.

Inputs come from a numpy seed and cross as numpy arrays.  The JAX side runs
its Pallas kernels in interpret mode: ``_ln_fwd`` (y and the fp32 row
statistics) and ``quant_layer_norm_pallas``, as tests/test_torch_fused_norm.py
reaches them.  The widths are the ones the CUDA kernel splits on (1, the
one-element route at 33, teams of 16 to 32 lanes at 64 and 128, a warp with
two to six vectors at 256 and 768, the column-tiled route at 5001), at row
counts that fill no team or block.  The CUDA kernel itself is held against
these plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.

Tolerances: y in fp32 1e-5 absolute, as tests/test_torch_fused_norm.py (both
sides compute the same two-pass fp32 statistics and differ only in
summation order); in bf16 / fp16 one ulp of the type (relative 2**-7 /
2**-10) plus 1e-3 absolute near zero, since both round one fp32 value once
and last-bit fp32 differences may land on neighbouring values.  The
statistics 1e-5 of max(1, |ref|), as chip_smoke.py holds the kernel's.  The
int8 LayerNorm 1e-5 absolute (fp32 out, the same dequantized fp32 rows).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.ops import _pallas
from unicore_tpu.ops import fused_norm as jax_fn

from unicore_tpu_torch.ops import fused_norm as port_fn

FP32_ATOL = 1e-5
STATS_TOL = 1e-5
ATOL_16 = 1e-3
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
#: (N, D): each width class of the CUDA forward, rows that fill no team
WIDTHS = [(3, 1), (7, 33), (9, 64), (37, 128), (5, 256), (3, 768), (2, 5001)]


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


def _inputs(N, D, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N, D)) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, w, b


@functools.lru_cache(maxsize=None)
def _jax_forward(N, D, dtype, wdtype, rms):
    """numpy x, w, b; the JAX ``_ln_fwd``'s y (fp32 numpy), mean and rstd
    ((N,) fp32 numpy).  The interpret switch is set by the calling test's
    fixture."""
    x, w, b = _inputs(N, D, seed=N * 1000 + D)
    jt, jwt = DTYPES[dtype][1], DTYPES[wdtype][1]
    eps = 1e-6 if rms else 1e-5
    x2p, _ = jax_fn._pad_rows(jnp.asarray(x, jt))
    y, mean, rstd = jax_fn._ln_fwd(x2p, jnp.asarray(w, jwt),
                                   None if rms else jnp.asarray(b, jwt), eps, rms)
    as_np = [np.array(jnp.asarray(a[:N], jnp.float32)) for a in (y, mean, rstd)]
    return (x, w, b), as_np[0], as_np[1][:, 0], as_np[2][:, 0]


def _assert_y(got, ref, dtype):
    ref = torch.from_numpy(ref)
    err = (got.float() - ref).abs()
    if dtype == torch.float32:
        assert err.max().item() <= FP32_ATOL, err.max().item()
    else:
        assert (err <= ATOL_16 + ULP[dtype] * ref.abs()).all(), err.max().item()


def _assert_stats(got, ref):
    ref = torch.from_numpy(ref)
    err = (got.reshape(-1).float() - ref).abs().max().item()
    assert err <= STATS_TOL * max(1.0, ref.abs().max().item()), err


def _port(N, D, dtype, wdtype, rms):
    (x, w, b), y_ref, mean_ref, rstd_ref = _jax_forward(N, D, dtype, wdtype, rms)
    tt, twt = DTYPES[dtype][0], DTYPES[wdtype][0]
    xt, wt = torch.from_numpy(x).to(tt), torch.from_numpy(w).to(twt)
    bt = None if rms else torch.from_numpy(b).to(twt)
    return (xt, wt, bt), (y_ref, mean_ref, rstd_ref)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("N,D", WIDTHS)
def test_plain_forward_and_stats_match_jax(pallas_interpret, N, D, rms):
    """fp32: y, mean and rstd at every width class."""
    (x, w, b), (y_ref, mean_ref, rstd_ref) = _port(N, D, "float32", "float32", rms)
    eps = 1e-6 if rms else 1e-5
    y = port_fn.fused_norm_plain(x, w, b, eps, rms)
    assert y.dtype == torch.float32 and tuple(y.shape) == (N, D)
    _assert_y(y, y_ref, torch.float32)
    mean, rstd = port_fn.fused_norm_stats_plain(x, eps, rms)
    assert mean.dtype == rstd.dtype == torch.float32 and tuple(rstd.shape) == (N, 1)
    _assert_stats(mean, mean_ref)
    _assert_stats(rstd, rstd_ref)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("dtype,wdtype", [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                                          ("float16", "float32"), ("float16", "float16"),
                                          ("float32", "bfloat16")])
@pytest.mark.parametrize("N,D", [(9, 64), (5, 256)])
def test_plain_forward_low_precision_matches_jax(pallas_interpret, N, D, dtype, wdtype, rms):
    """bf16 / fp16 rows with the weight in fp32 or in x's type (a --bf16 /
    --fp16 run), and fp32 rows with a bf16 weight: y in x's type, the fp32
    statistics of the widened rows."""
    (x, w, b), (y_ref, mean_ref, rstd_ref) = _port(N, D, dtype, wdtype, rms)
    eps = 1e-6 if rms else 1e-5
    y = port_fn.fused_norm_plain(x, w, b, eps, rms)
    assert y.dtype == x.dtype
    _assert_y(y, y_ref, x.dtype)
    mean, rstd = port_fn.fused_norm_stats_plain(x, eps, rms)
    _assert_stats(mean, mean_ref)
    _assert_stats(rstd, rstd_ref)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("N,D", [(7, 33), (37, 128), (3, 768)])
def test_cpu_training_route_matches_jax(pallas_interpret, N, D, rms):
    """The public call on CPU leaves that need a gradient (the CPU side of
    ``_FusedNorm``: autograd through the plain version) over a leading
    batch dimension: the JAX forward's y, and a gradient for every leaf."""
    (x, w, b), (y_ref, _, _) = _port(N, D, "float32", "float32", rms)
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]
    x3 = leaves[0].reshape(1, N, D)
    y = (port_fn.fused_rms_norm(x3, leaves[1]) if rms
         else port_fn.fused_layer_norm(x3, leaves[1], leaves[2]))
    assert y.requires_grad and tuple(y.shape) == (1, N, D)
    _assert_y(y.detach().reshape(N, D), y_ref, torch.float32)
    y.square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor_scale", "channel_scale"])
@pytest.mark.parametrize("N,D", [(7, 33), (5, 768), (2, 5001)])
def test_quant_plain_matches_jax_kernel(pallas_interpret, N, D, per_channel):
    """7q: int8 rows dequantized by one scale or D of them, then the
    LayerNorm, fp32 out, against ``quant_layer_norm_pallas``."""
    rng = np.random.default_rng(N * 10 + D)
    x = rng.integers(-127, 128, size=(N, D)).astype(np.int8)
    scale = np.asarray(rng.random(D if per_channel else ()) * 0.05 + 0.01, np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ref = jax_fn.quant_layer_norm_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w),
                                         jnp.asarray(b))
    got = port_fn.quant_layer_norm_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                         torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=FP32_ATOL)


def test_forward_launch_refuses_cpu_tensors():
    """The forward's launch function on CPU tensors raises: it never takes
    the plain version in the kernel's place."""
    x, w, b = (torch.from_numpy(a) for a in _inputs(8, 64, seed=5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_fn._launch_fwd(x, w, b, 1e-5, False, True, "fused_layer_norm")
    with pytest.raises(ValueError, match="fp32, bf16 or fp16"):
        port_fn._launch_fwd(x, w.double(), b, 1e-5, False, False, "fused_layer_norm")


def test_jax_reference_is_cpu():
    """The comparisons above run the JAX side on the CPU."""
    assert jax.default_backend() == "cpu"
