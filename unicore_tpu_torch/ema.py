"""Exponential moving average of the parameters (counterpart of
``unicore_tpu/ema.py``).

An fp32 shadow of every trained parameter, updated after each optimizer
step as ``e <- e - (1 - decay) (e - p)``; a skipped update (non-finite
gradient norm) leaves it as it was, as the JAX trainer keeps the old EMA
on an overflow.  Under ``--bf16`` / ``--fp16`` the trainer hands it the
optimizer's fp32 master, not the rounded parameters, as the JAX trainer
averages its master.  Under ``--zero-stage`` >= 1 the trainer hands it the
rank's share of the master (``parallel/zero.py``), as the JAX trainer
shards its EMA like the master, and gathers it whole for a checkpoint and
``--validate-with-ema``.  Plain ``torch._foreach_*`` ops over all tensors at
once; the JAX package has no Pallas kernel here either.
"""

from collections import OrderedDict
from typing import Dict, Mapping

import torch


class EMA:
    def __init__(self, params: Mapping[str, torch.Tensor], decay: float):
        self.decay = decay
        self.shadow: Dict[str, torch.Tensor] = OrderedDict(
            (n, p.detach().to(torch.float32, copy=True)) for n, p in params.items()
        )

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor]) -> None:
        """One step toward ``params`` (same names as the shadow)."""
        e = list(self.shadow.values())
        p = [params[n].detach().float() for n in self.shadow]
        diff = torch._foreach_sub(e, p)
        torch._foreach_mul_(diff, 1.0 - self.decay)
        torch._foreach_sub_(e, diff)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.shadow

    @torch.no_grad()
    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        if state_dict.keys() != self.shadow.keys():
            raise ValueError("EMA state names differ from the model's parameters")
        for n, e in self.shadow.items():
            e.copy_(state_dict[n])
