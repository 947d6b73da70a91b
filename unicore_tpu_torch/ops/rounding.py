"""Stochastic rounding fp32 -> bf16 (counterpart of
``unicore_tpu/ops/rounding.py``).

The fp32 bit pattern plus 16 random low bits, then the top 16 bits as
bf16: a value rounds up with probability equal to its distance from the
lower bf16 neighbour, so the rounding is unbiased and small updates are
not lost to bf16's 8-bit mantissa.  The mixed-precision optimizer's
master -> parameter copy-back uses it under ``--bf16-sr``.

The JAX function is jnp with no Pallas kernel, and so is this one: plain
torch integer ops on the ``int32`` view, on either device.  The add is the
uint32 add of the JAX function on two's-complement bits; a carry out of
the mantissa moves into the exponent (the largest finite values round up
to infinity), and an arithmetic shift by 16 gives the top half as the
signed ``int16`` whose bits ``.view(torch.bfloat16)`` reads.

:func:`fp32_to_bf16_sr_bits` takes the noise explicitly (the tests feed it
JAX's bits); :func:`fp32_to_bf16_sr` draws it from a ``torch.Generator``.
"""

from typing import Optional

import torch


def fp32_to_bf16_sr_bits(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to bf16 with the given 16-bit ``noise`` (an
    integer tensor of ``x``'s shape, values in [0, 65536))."""
    if x.dtype != torch.float32:
        raise ValueError(f"fp32_to_bf16_sr: expected float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = bits + noise.to(device=x.device, dtype=torch.int32)
    return (rounded >> 16).to(torch.int16).view(torch.bfloat16)


def fp32_to_bf16_sr(x: torch.Tensor, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Stochastically round an fp32 tensor to bf16, the 16 noise bits of
    each element drawn from ``generator`` (on ``x``'s device)."""
    noise = torch.randint(0, 1 << 16, tuple(x.shape), dtype=torch.int32, device=x.device,
                          generator=generator)
    return fp32_to_bf16_sr_bits(x, noise)
