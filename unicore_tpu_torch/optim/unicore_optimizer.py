"""Optimizer base class (counterpart of
``unicore_tpu/optim/unicore_optimizer.py``).

An optimizer owns fp32 per-parameter state and applies one update in
place: ``step(params, grads, lr)``, where ``params`` and ``grads`` are
name -> tensor maps of the model's parameters.  The update math is fp32;
bf16 parameters and their fp32 master copy wait for the bf16 slice.

Weight decay follows the JAX package's decay mask: no decay for tensors of
rank <= 1 or whose name holds ``bias``, ``layer_norm`` or ``layernorm``.
The JAX mask reads Flax names; here it reads each parameter's Flax name
(:func:`checkpoint_utils.jax_param_names`, the inverse of the weight map
``from_jax_params``), so the same tensors decay in both packages.
"""

from typing import Dict, Iterable, Tuple

import torch

NO_DECAY_NAMES = ("bias", "layer_norm", "layernorm")


def decays(jax_name: str, ndim: int) -> bool:
    """True where weight decay applies (the JAX ``make_decay_mask`` leaf
    rule on the Flax name)."""
    if ndim <= 1:
        return False
    return not any(nd in jax_name.lower() for nd in NO_DECAY_NAMES)


def total_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm over tensors, in fp32 (a 0-d tensor on their device)."""
    tensors = list(tensors)
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_grad_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                   eps: float = 1e-6) -> torch.Tensor:
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm`` (no-op when ``max_norm <= 0``); returns the norm before
    clipping.  Branch-free on the device, as the JAX ``clip_grad_norm``."""
    gnorm = total_norm(grads.values())
    if max_norm > 0:
        coef = torch.clamp(max_norm / (gnorm + eps), max=1.0)
        torch._foreach_mul_(list(grads.values()), coef)
    return gnorm


class UnicoreOptimizer(object):
    def __init__(self, args):
        super().__init__()
        self.args = args
        self.num_steps = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.decay: Dict[str, bool] = {}

    @classmethod
    def add_args(cls, parser):
        pass

    def init_state(self, named_params: Dict[str, torch.Tensor],
                   jax_names: Dict[str, str]) -> None:
        """fp32 slots per parameter and its decay flag from its Flax name."""
        for name, p in named_params.items():
            self.state[name] = self._init_slots(p)
            self.decay[name] = decays(jax_names[name], p.ndim)

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> None:
        """One update of ``params`` in place from fp32 ``grads``."""
        raise NotImplementedError

    def state_dict(self):
        return {"num_steps": self.num_steps, "state": self.state}


def bias_corrected_step_size(lr: float, step: int,
                             betas: Tuple[float, float]) -> float:
    """``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` computed in fp32, as the
    JAX Adam folds its bias correction into the step size."""
    stepf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(betas[0], dtype=torch.float32), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(betas[1], dtype=torch.float32), stepf)
    lr32 = torch.tensor(lr, dtype=torch.float32)
    return float(lr32 * torch.sqrt(bc2) / bc1)
