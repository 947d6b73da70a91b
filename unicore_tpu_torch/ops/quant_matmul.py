"""Quantized dense: int8 x int8 -> int32 with the dequantization (per-channel
scale + bias + activation) fused into the epilogue (counterpart of
``unicore_tpu/ops/quant_matmul.py``, whose TPU kernel is ``_qmm_kernel``).

Also the symmetric quantize step every quantized path of the port shares
(``INT8_QMAX``, :func:`quantize_to_dtype`, :func:`quantize_to_int8`,
:func:`dynamic_act_scale`): ``QuantDense``, the int8 attention scores, the
int8 KV cache and the decode route quantize through this one function.

:func:`quant_matmul` routes as the JAX package routes on a TPU:

- int8 operands run the hand-written kernel of ``csrc/quant_matmul.cu`` on
  a CUDA tensor -- or raise -- and :func:`quant_matmul_plain`, the same
  function in plain PyTorch, on a CPU tensor.  The TPU kernel's gate (K and
  N multiples of 128, rows of 32) is a tiling rule of that chip; the CUDA
  kernel takes any M, K a multiple of 32 and N a multiple of 8, every BERT
  geometry, with an output tile 128 rows high and :func:`choose_tile_n`
  wide;
- ``float8_e4m3fn`` operands (``--serve-quantize fp8``) run
  :func:`quant_matmul_plain` on either device: the JAX Pallas kernel is
  int8-only and its fp8 route is the jnp composition (values carry the fp8
  rounding, the product accumulates in fp32), so this is the JAX route,
  not a fallback.

The weight keeps ``nn.Linear``'s (N, K) layout -- the JAX package's kernel
is (K, N) -- because Hopper's 8-bit tensor-core products take only K-major
operands; the transpose happens once, when a model is prepared for serving.

torch has no int8 matrix product that accumulates in int32 on both
devices (an int8 ``matmul`` on the CPU returns int8 and wraps; CUDA has no
integer ``matmul``), so the plain version widens to float64, where every
partial sum of int8 products is an integer below 2**53 and exact, then
casts the sum to int32.  Inference only: nothing here has a gradient.
"""

import torch

from unicore_tpu_torch.utils import get_activation_fn
from . import _kernels

#: int8 symmetric range (the -128 column is excluded so dequant is exact
#: under negation)
INT8_QMAX = 127.0

#: the epilogue's activations (``utils.get_activation_fn`` names) and their
#: codes in csrc/quant_matmul.cu
_ACTIVATIONS = {"": 0, "linear": 0, "relu": 1, "gelu": 2, "gelu_fast": 3,
                "gelu_accurate": 3, "tanh": 4, "swish": 5, "silu": 5}

LAUNCHES = _kernels.counter("quant_matmul")

#: the kernel's output tile: 128 rows, one of these widths
TILE_M = 128
TILE_NS = (256, 192, 128)
#: SMs of the card the tile width is chosen for (an H100 SXM)
SMS = 132


def choose_tile_n(M: int, N: int, K: int) -> int:
    """The kernel's tile width for an (M, K) x (K, N) product: the one of
    :data:`TILE_NS` whose waves of tiles over :data:`SMS` SMs cost the
    fewest columns (waves x width), the narrowest on a tie (more, smaller
    tiles: measured faster at fc1, where 128, 192 and 256 tie).  A function
    of the shape only: 192 at N = 768 (128 tiles of 4096 rows for 132 SMs,
    where 128 wide made 192 tiles and a second, thin wave), 192 at
    in_proj's 2304, 128 at fc1's 3072.  ``K`` does not move it: every tile
    runs the same K loop."""
    row_tiles = -(-M // TILE_M)
    best = None
    for bn in TILE_NS:
        waves = -(-row_tiles * -(-N // bn) // SMS)
        if best is None or waves * bn <= best[0]:
            best = (waves * bn, bn)
    return best[1]


def quantize_to_dtype(x, scale, qmax: float, dtype):
    """Symmetric quantization against a static scale, as the JAX package
    computes it: fp32 ``x / scale``, clipped to [-qmax, qmax], then (int8)
    rounded half to even (``torch.round`` and ``jnp.round`` agree), then
    cast (to ``float8_e4m3fn`` with round to nearest even, as JAX casts).
    Values outside the calibrated range saturate."""
    v = torch.clamp(x.float() / scale, -qmax, qmax)
    if dtype == torch.int8:
        v = torch.round(v)
    return v.to(dtype)


def quantize_to_int8(x, scale):
    """``round(x / scale)`` clipped to [-127, 127]; ``scale`` is the dequant
    step (absmax / 127), a scalar or broadcastable per-channel tensor."""
    return quantize_to_dtype(x, scale, INT8_QMAX, torch.int8)


def dynamic_act_scale(x):
    """Per-tensor dynamic activation scale (absmax / 127) as a 0-d device
    tensor (no host sync), floored so an all-zero tensor quantizes to zeros
    instead of NaN."""
    absmax = x.float().abs().amax()
    return torch.clamp_min(absmax / INT8_QMAX, 1e-8)


def int8_matmul_plain(x_q, w_q):
    """The exact int32 sum ``x_q @ w_q.T`` of int8 (M, K) and (N, K), through
    float64 (exact: every partial sum is an integer below 2**53)."""
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def _epilogue(acc, scale, bias, activation: str):
    y = acc.float() * scale
    if bias is not None:
        y = y + bias.float()
    if activation and activation != "linear":
        y = get_activation_fn(activation)(y)
    return y


def quant_matmul_plain(x_q, w_q, scale, bias=None, activation: str = "",
                       out_dtype=torch.float32):
    """The kernel's function in plain PyTorch (the JAX
    ``quant_matmul_reference``): ``act((x_q @ w_q.T) * scale + bias)`` over
    2-D ``x_q`` (M, K) and ``w_q`` (N, K).  int8 operands accumulate exactly
    in int32; float8 operands are upcast and multiplied in fp32 (TF32 off)."""
    if x_q.dtype == torch.int8:
        acc = int8_matmul_plain(x_q, w_q)
    else:
        acc = x_q.float() @ w_q.float().t()
    return _epilogue(acc, scale, bias, activation).to(out_dtype)


def _check(x2, w_q, scale, bias, activation):
    M, K = x2.shape
    N = w_q.shape[0]
    if x2.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"quant_matmul kernel: int8 operands only, got "
                         f"{x2.dtype} / {w_q.dtype}")
    if tuple(w_q.shape) != (N, K):
        raise ValueError(f"quant_matmul: weight {tuple(w_q.shape)} does not take "
                         f"K = {K}")
    if K % 32 != 0 or N % 8 != 0:
        raise ValueError(
            f"quant_matmul kernel: K = {K} must be a multiple of 32 and N = {N} "
            "of 8 (k32 tensor-core products, column pairs)"
        )
    if M >= 2 ** 31:
        raise ValueError(f"quant_matmul kernel: M = {M} rows must be below 2**31")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"quant_matmul: activation {activation!r} not in "
                         f"{sorted(_ACTIVATIONS)}")
    for what, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (N,)):
            raise ValueError(f"quant_matmul: {what} must be fp32 of shape ({N},), "
                             f"got {t.dtype} {tuple(t.shape)}")
    _kernels.require_cuda("quant_matmul", x2, w_q, scale, bias)
    if x2.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("quant_matmul kernel: operands must be 16-byte aligned")


def quant_matmul_kernel(x2, w_q, scale, bias=None, activation: str = ""):
    """The CUDA kernel on card tensors: int8 x2 (M, K), int8 w_q (N, K), fp32
    scale (N,) and bias (N,) or None; fp32 (M, N) out.  Raises on anything
    it does not take."""
    _check(x2, w_q, scale, bias, activation)
    M, K = x2.shape
    N = w_q.shape[0]
    y = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    if M == 0:
        return y
    rc = _kernels.library().unicore_quant_matmul(
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), _kernels.ptr(bias),
        y.data_ptr(), M, N, K, _ACTIVATIONS[activation], choose_tile_n(M, N, K),
        _kernels.stream_handle(x2.device),
    )
    _kernels.check(rc, "quant_matmul")
    LAUNCHES.add()
    return y


def quant_matmul(x_q, w_q, scale, bias=None, activation: str = "",
                 out_dtype=torch.float32):
    """Quantized dense: ``act(dequant(x_q @ w_q.T) + bias)``.

    ``x_q``: (..., K) int8 or float8_e4m3fn; ``w_q``: (N, K), same type;
    ``scale``: the combined per-channel dequant factor (N,) fp32
    (activation scale x weight scale); ``bias``: (N,) or None."""
    lead = x_q.shape[:-1]
    K = x_q.shape[-1]
    N = w_q.shape[0]
    x2 = x_q.reshape(-1, K)
    if x2.dtype == torch.int8 and x2.device.type != "cpu":
        out = quant_matmul_kernel(x2.contiguous(), w_q, scale, bias, activation)
        out = out.to(out_dtype)
    else:
        out = quant_matmul_plain(x2, w_q, scale, bias, activation, out_dtype)
    return out.reshape(*lead, N)
