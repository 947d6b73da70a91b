"""The port's LayerNorm/RMSNorm (unicore_tpu_torch/ops/fused_norm.py,
modules/layer_norm.py) against the JAX package on the CPU.

Inputs come from a numpy seed and go through both packages.  On a CPU tensor
the port's wrapper runs its plain version; the CUDA kernel itself is held
against that plain version on the card by chip_smoke.py.

Tolerances: fp32 1e-5 absolute — both sides compute the same two-pass fp32
statistics and differ only in summation order.  bf16 one bf16 ulp (relative
2**-7, plus 1e-3 absolute near zero) — both compute in fp32 and round once
to bf16, so last-bit fp32 differences may land on neighbouring bf16 values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unicore_tpu.modules import layer_norm as jax_ln
from unicore_tpu.ops import _pallas
from unicore_tpu.ops import fused_norm as jax_fn

from unicore_tpu_torch.modules import layer_norm as port_ln
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import fused_norm as port_fn

FP32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-3


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


@pytest.fixture
def fused_norm_mode():
    """Restore the port's --fused-norm mode after a test that sets it."""
    saved = port_ln._mode
    try:
        yield port_ln.configure_fused_norm
    finally:
        port_ln._mode = saved


def _inputs(rows, dim, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, dim)) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(dim)).astype(np.float32)
    b = (0.1 * rng.standard_normal(dim)).astype(np.float32)
    return x, w, b


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _to_jax(x, dtype):
    return jnp.asarray(x, dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _assert_close(port, ref, dtype):
    port = port.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(port, ref, rtol=0, atol=FP32_ATOL)
    else:
        np.testing.assert_allclose(port, ref, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("rows,dim", [(7, 64), (33, 96)])
def test_plain_matches_jax_kernel(pallas_interpret, dtype, rms, rows, dim):
    x, w, b = _inputs(rows, dim, seed=rows * 10 + dim)
    _kernels.reset_launch_counts()
    if rms:
        port = port_fn.fused_rms_norm(_to_torch(x, dtype), torch.from_numpy(w))
        ref = jax_fn.fused_rms_norm(_to_jax(x, dtype), jnp.asarray(w))
    else:
        port = port_fn.fused_layer_norm(
            _to_torch(x, dtype), torch.from_numpy(w), torch.from_numpy(b)
        )
        ref = jax_fn.fused_layer_norm(
            _to_jax(x, dtype), jnp.asarray(w), jnp.asarray(b)
        )
    assert port.dtype == dtype and tuple(port.shape) == (rows, dim)
    _assert_close(port, ref, dtype)
    # a CPU tensor takes the plain path: the kernel was never launched
    assert port_fn.LAUNCHES.count == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["LayerNorm", "RMSNorm"])
@pytest.mark.parametrize("mode", ["auto", "off"])
def test_modules_match_jax_modules(fused_norm_mode, dtype, kind, mode):
    """Both of the port module's paths against the JAX module's jnp path,
    with the same (non-default) affine parameters; odd leading shape."""
    x, w, b = _inputs(3 * 5, 48, seed=7)
    x = x.reshape(3, 5, 48)
    fused_norm_mode(mode)
    port_mod = getattr(port_ln, kind)(48)
    with torch.no_grad():
        port_mod.weight.copy_(torch.from_numpy(w))
        if kind == "LayerNorm":
            port_mod.bias.copy_(torch.from_numpy(b))
    params = {"weight": jnp.asarray(w)}
    if kind == "LayerNorm":
        params["bias"] = jnp.asarray(b)
    jax_mod = getattr(jax_ln, kind)(48, use_pallas=False)
    ref = jax_mod.apply({"params": params}, _to_jax(x, dtype))
    with torch.no_grad():
        port = port_mod(_to_torch(x, dtype))
    assert port.dtype == dtype
    _assert_close(port, ref, dtype)


def test_empty_and_guarded_inputs():
    """Zero rows pass through; a CUDA-only check refuses CPU tensors."""
    x = torch.zeros((0, 16))
    y = port_fn.fused_layer_norm(x, torch.ones(16), torch.zeros(16))
    assert tuple(y.shape) == (0, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _kernels.require_cuda("fused_layer_norm", torch.zeros(4, 16))


def test_jax_reference_is_cpu():
    """The comparisons above run the JAX side on the CPU."""
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("rows,dim", [(7, 64), (33, 96), (128, 256)])
def test_plain_gradients_match_jax_grad(pallas_interpret, rms, rows, dim):
    """dx, dw (and db) of the port's plain path (autograd) against
    ``jax.grad`` of the JAX kernels in interpret mode (their custom VJP
    runs ``_ln_dx_kernel`` and ``_ln_dwdb_kernel``), fp32, as
    tests/test_fused_norm.py takes them: the gradient of sum(y^2), error
    over the largest magnitude (at least 1) within 1e-5."""
    x, w, b = _inputs(rows, dim, seed=rows + dim)
    eps = 1e-6 if rms else 1e-5
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    if rms:
        port_fn.fused_rms_norm(xt, wt, eps).square().sum().backward()
        got = [xt.grad, wt.grad]
        ref = jax.grad(lambda x, w: jnp.sum(jax_fn.fused_rms_norm(x, w, eps) ** 2),
                       argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    else:
        port_fn.fused_layer_norm(xt, wt, bt, eps).square().sum().backward()
        got = [xt.grad, wt.grad, bt.grad]
        ref = jax.grad(
            lambda x, w, b: jnp.sum(jax_fn.fused_layer_norm(x, w, b, eps) ** 2),
            argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for name, g, r in zip(("dx", "dw", "db"), got, ref):
        r = np.asarray(r)
        scale = max(1.0, float(np.abs(r).max()))
        assert float(np.abs(g.numpy() - r).max()) / scale < 1e-5, name
