"""The port's decode attention (unicore_tpu_torch/ops/decode_attention.py)
against the JAX package's on the CPU.

Inputs come from a numpy seed.  The JAX side runs its Pallas kernel
``_decode_kernel`` in interpret mode with the dispatch mode ``on``; the
port's side runs ``decode_attention_plain``, the function the CUDA kernel is
held against on the card (chip_smoke.py, tests/test_torch_gpu.py).  Rows
past each sequence's position hold junk (K +1e6, V -1e6), which must not
leak into either output.

Tolerances: fp32 1e-5 absolute (both sides take an fp32 softmax and differ
in summation order); int8 caches 1e-5 against the JAX kernel's fused
dequant; a bf16 / fp16 output two ulps of its type of the element
(2 x 2**-7 / 2 x 2**-10 of it) plus 1e-6 (both sides compute in fp32 and
round once; last-bit fp32 differences may round to a neighbouring value).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unicore_tpu.ops import _pallas

from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import decode_attention as port_da
from unicore_tpu_torch.ops.quant_matmul import INT8_QMAX, quantize_to_dtype

jax_da = importlib.import_module("unicore_tpu.ops.decode_attention")

FP32_TOL = 1e-5
BF16_ULPS = 2 * 2.0 ** -7
#: two ulps of a 16-bit output type, relative
ULPS = {"bfloat16": BF16_ULPS, "float16": 2 * 2.0 ** -10}


@pytest.fixture
def pallas_on():
    """The JAX decode-attention dispatch in mode ``on`` with the Pallas
    kernel in interpret mode, both process-global switches restored exactly
    as they were after the test."""
    saved_interpret, saved_mode = _pallas._override, jax_da._gate._mode
    _pallas.set_interpret(True)
    jax_da.set_decode_attention_mode("on")
    try:
        yield
    finally:
        _pallas._override = saved_interpret
        jax_da._gate._mode = saved_mode


def _inputs(B, H, L, D, seed, with_bias):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, D) * D ** -0.5).astype(np.float32)
    k = rng.randn(B, H, L, D).astype(np.float32)
    v = rng.randn(B, H, L, D).astype(np.float32)
    pos = np.linspace(0, L - 1, B).astype(np.int32)  # 0, middle, L - 1
    for b, p in enumerate(pos):  # junk past each position
        k[b, :, p + 1:] = 1e6
        v[b, :, p + 1:] = -1e6
    bias = rng.randn(B, H, L).astype(np.float32) if with_bias else None
    return q, k, v, pos, bias


def _port(q, k, v, pos, bias, dtype, **scales):
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    _kernels.reset_launch_counts()
    out = port_da.decode_attention(
        t(q).to(dtype), t(k).to(dtype) if k.dtype != np.int8 else t(k),
        t(v).to(dtype) if v.dtype != np.int8 else t(v), t(pos), bias=t(bias),
        **{n: t(s) for n, s in scales.items()})
    assert sum(_kernels.launch_counts().values()) == 0  # CPU: the plain version
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("L", [32, 64])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(pallas_on, dtype, with_bias, L):
    q, k, v, pos, bias = _inputs(3, 2, L, 16, seed=L + with_bias, with_bias=with_bias)
    jd = getattr(jnp, dtype)
    want = np.asarray(jax_da.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(pos),
        bias=None if bias is None else jnp.asarray(bias)).astype(jnp.float32))
    got = _port(q, k, v, pos, bias, getattr(torch, dtype))
    assert np.all(np.isfinite(got)) and np.all(np.abs(got) < 100)  # no junk leaked
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= BF16_ULPS * np.abs(want) + 1e-6)


@pytest.mark.parametrize("L", [32, 64])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16", "float16"])
def test_plain_int8_matches_jax_kernel(pallas_on, qdtype, L):
    q, kf, vf, pos, bias = _inputs(3, 2, L, 16, seed=7 * L, with_bias=True)
    for b, p in enumerate(pos):  # real rows only: the scales see no junk
        kf[b, :, p + 1:] = 0.0
        vf[b, :, p + 1:] = 0.0
    ks = (np.abs(kf).max(axis=(0, 2)) / INT8_QMAX + 1e-8).astype(np.float32)
    vs = (np.abs(vf).max(axis=(0, 2)) / INT8_QMAX + 1e-8).astype(np.float32)
    ki = quantize_to_dtype(torch.as_tensor(kf), torch.as_tensor(ks)[None, :, None],
                           INT8_QMAX, torch.int8).numpy()
    vi = quantize_to_dtype(torch.as_tensor(vf), torch.as_tensor(vs)[None, :, None],
                           INT8_QMAX, torch.int8).numpy()
    for b, p in enumerate(pos):  # int8 junk past each position
        ki[b, :, p + 1:] = 127
        vi[b, :, p + 1:] = -127
    jd = getattr(jnp, qdtype)
    want = np.asarray(jax_da.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(ki), jnp.asarray(vi), jnp.asarray(pos),
        bias=jnp.asarray(bias), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs)).astype(jnp.float32))
    got = _port(q, ki, vi, pos, bias, getattr(torch, qdtype), k_scale=ks, v_scale=vs)
    if qdtype == "float32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= ULPS[qdtype] * np.abs(want) + 1e-6)
    # dequantized fp32 caches give the same answer to quantization error
    fp = _port(q, kf, vf, pos, bias, getattr(torch, qdtype))
    assert np.max(np.abs(fp - got)) < 0.05


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("qdtype", ["bfloat16", "float16"])
def test_plain_16bit_q_against_fp32_cache_matches_jax(pallas_on, qdtype, bias_dtype):
    """A bf16 or fp16 model's step against the fp32 pool: a 16-bit q and
    bias against fp32 caches, every operand read as fp32, the output in q's
    type (the JAX kernel in interpret mode for bf16; its reference for
    fp16, which the JAX dispatch sends past the kernel)."""
    q, k, v, pos, bias = _inputs(3, 2, 64, 16, seed=5, with_bias=True)
    jq, jb = getattr(jnp, qdtype), getattr(jnp, bias_dtype)
    want = np.asarray(jax_da.decode_attention(
        jnp.asarray(q, jq), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        bias=jnp.asarray(bias, jb)).astype(jnp.float32))
    t = torch.as_tensor
    _kernels.reset_launch_counts()
    out = port_da.decode_attention(t(q).to(getattr(torch, qdtype)), t(k), t(v), t(pos),
                                   bias=t(bias).to(getattr(torch, bias_dtype)))
    assert sum(_kernels.launch_counts().values()) == 0  # CPU: the plain version
    assert out.dtype == getattr(torch, qdtype)
    got = out.float().numpy()
    assert np.all(np.isfinite(got)) and np.all(np.abs(got) < 100)  # no junk leaked
    assert np.all(np.abs(got - want) <= ULPS[qdtype] * np.abs(want) + 1e-6)


def test_plain_matches_live_prefix_softmax():
    """Each row's output is the softmax over its live prefix alone."""
    q, k, v, pos, _ = _inputs(3, 2, 16, 8, seed=2, with_bias=False)
    got = _port(q, k, v, pos, None, torch.float32)
    for b, p in enumerate(pos):
        s = np.einsum("hd,hld->hl", q[b], k[b, :, : p + 1])
        e = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("hl,hld->hd", e / e.sum(-1, keepdims=True), v[b, :, : p + 1])
        np.testing.assert_allclose(got[b], want, atol=FP32_TOL, rtol=1e-5)


def test_scale_pairing_enforced():
    q = torch.zeros(1, 1, 4)
    kf = torch.zeros(1, 1, 8, 4)
    pos = torch.zeros(1, dtype=torch.int32)
    ks = torch.ones(1, 4)
    with pytest.raises(ValueError, match="together"):
        port_da.decode_attention(q, kf, kf, pos, k_scale=ks)
    with pytest.raises(ValueError, match="int8"):
        port_da.decode_attention(q, kf, kf, pos, k_scale=ks, v_scale=ks)
    with pytest.raises(ValueError, match="int8"):
        ki = torch.zeros(1, 1, 8, 4, dtype=torch.int8)
        port_da.decode_attention(q, ki, ki, pos)
