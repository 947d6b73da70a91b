"""The port's LayerNorm/RMSNorm backward (``fused_norm_bwd_plain`` in
unicore_tpu_torch/ops/fused_norm.py, the yardstick of the one-pass CUDA
backward) against the JAX package's norm gradient on the CPU.

Inputs come from a numpy seed and cross as numpy arrays.  The JAX side runs
its Pallas kernels in interpret mode (``_ln_fwd`` for the row statistics,
then ``jax.vjp`` of ``fused_layer_norm`` / ``fused_rms_norm``, whose custom
VJP runs ``_ln_dx_kernel`` and ``_ln_dwdb_kernel``), as
tests/test_torch_fused_norm.py reaches them; the port's plain backward gets
the JAX forward's statistics, so the two are held on the same inputs.  The
CUDA kernel itself is held against ``fused_norm_bwd_plain`` on the card by
tests/test_torch_gpu.py and chip_smoke.py.

Tolerances, per element, of the reference's largest magnitude (at least 1):
fp32 1e-5, as ``GRAD_TOL["norm"]`` (both sides compute the same fp32
formula and differ only in summation order); bf16 1e-5 of it plus two bf16
ulps of the element (2**-6 |ref|) where the gradient is stored in bf16, as
chip_smoke.py's ``grad_tolerance`` gives it (both round one fp32 value to
bf16, and last-bit fp32 differences may land on neighbouring bf16 values).
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

GRAD_TOL = 1e-5
BF16_ULPS = 2.0 ** -6
SHAPES = [(8, 64), (40, 128), (16, 256), (24, 96), (7, 33)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


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
    dy = rng.standard_normal((N, D)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    return x, dy, w, b


@functools.lru_cache(maxsize=None)
def _jax_reference(N, D, dtype, wdtype, rms):
    """numpy x, dy, w, b; the JAX forward's fp32 mean and rstd (N,); the
    JAX gradient (dx, dw, db) as numpy fp32 (db None for RMSNorm).  The
    interpret switch is set by the calling test's fixture."""
    x, dy, w, b = _inputs(N, D, seed=N * 1000 + D)
    jt, jwt = DTYPES[dtype][1], DTYPES[wdtype][1]
    xj, dyj = jnp.asarray(x, jt), jnp.asarray(dy, jt)
    wj, bj = jnp.asarray(w, jwt), jnp.asarray(b, jwt)
    eps = 1e-6 if rms else 1e-5
    x2p, _ = jax_fn._pad_rows(xj)
    _, mean, rstd = jax_fn._ln_fwd(x2p, wj, None if rms else bj, eps, rms)
    if rms:
        _, vjp = jax.vjp(lambda x, w: jax_fn.fused_rms_norm(x, w, eps), xj, wj)
        grads = list(vjp(dyj)) + [None]
    else:
        _, vjp = jax.vjp(lambda x, w, b: jax_fn.fused_layer_norm(x, w, b, eps), xj, wj, bj)
        grads = list(vjp(dyj))
    as_np = [None if g is None else np.array(jnp.asarray(g, jnp.float32)) for g in grads]
    stats = [np.array(s[:N, 0]) for s in (mean, rstd)]
    return (x, dy, w, b), stats, as_np, [None if g is None else str(g.dtype) for g in grads]


def _check(name, got, ref):
    ref_t = torch.from_numpy(ref)
    err = (got.float() - ref_t).abs()
    tol = GRAD_TOL * max(1.0, ref_t.abs().max().item())
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * ref_t.abs()
    ratio = (err / tol).max().item()
    assert ratio <= 1.0, (name, ratio, err.max().item())


def _port_backward(N, D, dtype, wdtype, rms, need_dx, need_dwdb):
    (x, dy, w, b), (mean, rstd), ref, ref_dtypes = _jax_reference(N, D, dtype, wdtype, rms)
    tt, twt = DTYPES[dtype][0], DTYPES[wdtype][0]
    got = port_fn.fused_norm_bwd_plain(
        torch.from_numpy(x).to(tt), torch.from_numpy(w).to(twt), torch.from_numpy(mean),
        torch.from_numpy(rstd), torch.from_numpy(dy).to(tt), rms, not rms, need_dx,
        need_dwdb)
    return got, ref, ref_dtypes, (tt, twt)


@pytest.mark.parametrize("mode", ["dx_and_dwdb", "dx_only", "dwdb_only"])
@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D", SHAPES)
def test_plain_backward_matches_jax_gradient(pallas_interpret, N, D, dtype, rms, mode):
    need_dx, need_dwdb = mode != "dwdb_only", mode != "dx_only"
    got, ref, ref_dtypes, (tt, twt) = _port_backward(N, D, dtype, "float32", rms, need_dx,
                                                     need_dwdb)
    for name, g, r, want in zip(("dx", "dw", "db"), got, ref, (tt, twt, twt)):
        asked = need_dx if name == "dx" else need_dwdb and (name == "dw" or not rms)
        if not asked:
            assert g is None, name
            continue
        assert g.dtype == want and tuple(g.shape) == r.shape, name
        _check(name, g, r)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
def test_plain_backward_low_precision_weights(pallas_interpret, rms):
    """A --bf16 run's norm: bf16 x, weight and bias; dw and db summed in fp32
    and rounded once to bf16, as the JAX ``dw.astype(w.dtype)``."""
    got, ref, ref_dtypes, _ = _port_backward(16, 256, "bfloat16", "bfloat16", rms, True, True)
    for name, g, r, want in zip(("dx", "dw", "db"), got, ref, ref_dtypes):
        if r is None:
            assert g is None
            continue
        assert str(g.dtype).split(".")[1] == want == "bfloat16", name
        _check(name, g, r)


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
def test_plain_backward_matches_cpu_autograd(rms):
    """The CPU training route (autograd through ``fused_norm_plain``) and the
    kernel's plain backward agree on the same fp32 inputs and statistics."""
    x, dy, w, b = (torch.from_numpy(a) for a in _inputs(40, 128, seed=3))
    eps = 1e-6 if rms else 1e-5
    leaves = [t.clone().requires_grad_(True) for t in ((x, w) if rms else (x, w, b))]
    out = port_fn.fused_norm_plain(leaves[0], leaves[1], None if rms else leaves[2], eps, rms)
    ref = torch.autograd.grad(out, leaves, dy)
    mean = torch.zeros(40) if rms else x.mean(-1)
    rstd = torch.rsqrt((x - mean[:, None]).square().mean(-1) + eps)
    got = port_fn.fused_norm_bwd_plain(x, w, mean, rstd, dy, rms, not rms)
    for name, g, r in zip(("dx", "dw", "db"), got, ref):
        _check(name, g, r.numpy())


def test_kernel_launch_refuses_cpu_tensors():
    """The backward's launch function on CPU tensors raises: it never takes
    the plain version in the kernel's place."""
    x, dy, w, _ = (torch.from_numpy(a) for a in _inputs(8, 64, seed=5))
    mean, rstd = x.mean(-1), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_fn._launch_bwd(x, w, mean, rstd, dy, False, False, True, True,
                            "fused_layer_norm")


def test_jax_reference_is_cpu():
    """The comparisons above run the JAX side on the CPU."""
    assert jax.default_backend() == "cpu"
