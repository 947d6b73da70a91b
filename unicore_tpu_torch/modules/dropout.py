"""Dropout from explicit generators.

The JAX trainer hands each micro-batch's forward a ``"dropout"`` key folded
from (seed, update, micro-batch) (``unicore_tpu/trainer.py`` ``make_rng``);
no module draws from a global stream.  :class:`DropoutRng` is the port's
counterpart: one per micro-batch, built by the trainer from the same three
numbers and passed down the model's ``forward``.  A module in training
with a nonzero rate and no ``DropoutRng`` raises instead of drawing from
PyTorch's global generator.

It holds two generators: ``device`` draws the elementwise masks on the
activations' device; ``host`` (always a CPU generator) draws the int32
seeds of the attention kernel's in-kernel Philox dropout, so a run on the
card and a run on the CPU from the same three numbers drop the same
attention probabilities.
"""

import torch

_MIX = 1000003  # the JAX kernels' seed-mixing multiplier (_seed_block)


def fold_key(seed: int, *fold: int) -> int:
    """A generator seed from ``seed`` and the numbers folded into it."""
    key = int(seed)
    for f in fold:
        key = (key * _MIX + int(f)) % (2 ** 63)
    return key


class DropoutRng:
    def __init__(self, seed: int, device, *fold: int):
        key = fold_key(seed, *fold)
        self.device = torch.Generator(device=device).manual_seed(key)
        self.host = torch.Generator().manual_seed(key)

    def kernel_seed(self) -> int:
        """An int32 seed for one in-kernel dropout call."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.host))


def dropout(x: torch.Tensor, p: float, training: bool, rng,
            broadcast_dims=()) -> torch.Tensor:
    """Inverted dropout of ``x`` at rate ``p`` with the mask drawn from
    ``rng.device``; the identity outside training or at ``p == 0``.
    ``broadcast_dims``: dims of ``x`` that share one mask -- it is drawn for
    ``x``'s shape with those dims set to 1, then broadcast (flax
    ``nn.Dropout(broadcast_dims=...)``; the Evoformer's row-wise dropout)."""
    if not training or p == 0.0:
        return x
    if rng is None:
        raise ValueError(
            "dropout in training needs an explicit DropoutRng (seed, update, "
            "micro-batch); the port never draws from the global generator"
        )
    # drawn in fp32 whatever x's type, so a bf16 run drops what an fp32 run
    # from the same generator drops
    if broadcast_dims:
        shared = {b % x.ndim for b in broadcast_dims}
        shape = [1 if d in shared else n for d, n in enumerate(x.shape)]
        keep = torch.empty(shape, dtype=torch.float32, device=x.device)
    else:
        keep = torch.empty_like(x, dtype=torch.float32)
    keep.bernoulli_(1.0 - p, generator=rng.device)
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))
