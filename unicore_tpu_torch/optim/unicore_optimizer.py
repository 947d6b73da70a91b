"""Optimizer base class (counterpart of
``unicore_tpu/optim/unicore_optimizer.py``).

An optimizer owns fp32 per-parameter state and applies one update in
place: ``step(params, grads, lr)``, where ``params`` and ``grads`` are
name -> tensor maps of the model's parameters and the gradients are fp32.
The update math is always fp32.  Parameters in bf16 or fp16 (``--bf16``,
``--fp16``) get an fp32 master copy in the optimizer state (``master``,
the JAX ``state['master']``): the update runs on the master, which is then
copied back into the parameters, rounded to nearest-even -- or, under
``--bf16-sr``, stochastically for the bf16 ones (``ops/rounding.py``),
with the noise from the generator the trainer hands ``step``.  fp32
parameters are their own master.

Weight decay follows the JAX package's decay mask: no decay for tensors of
rank <= 1 or whose name holds ``bias``, ``layer_norm`` or ``layernorm``.
The JAX mask reads Flax names; here it reads each parameter's Flax name
(:func:`checkpoint_utils.jax_param_names`, the inverse of the weight map
``from_jax_params``), so the same tensors decay in both packages.
"""

from typing import Dict, Iterable, Optional, Tuple

import torch

from unicore_tpu_torch.ops.rounding import fp32_to_bf16_sr

from .multi_tensor import clip_coef

LOW_PRECISION = (torch.bfloat16, torch.float16)

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
        torch._foreach_mul_(list(grads.values()), clip_coef(gnorm, max_norm, eps))
    return gnorm


class UnicoreOptimizer(object):
    def __init__(self, args):
        super().__init__()
        self.args = args
        self.num_steps = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.decay: Dict[str, bool] = {}
        #: the fp32 master of low-precision parameters (None: fp32 run)
        self.master: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def add_args(cls, parser):
        pass

    def init_state(self, named_params: Dict[str, torch.Tensor],
                   jax_names: Dict[str, str]) -> None:
        """fp32 slots per parameter and its decay flag from its Flax name;
        an fp32 master copy of the parameters when any is bf16 or fp16 (the
        JAX ``init_state``)."""
        if any(p.dtype in LOW_PRECISION for p in named_params.values()):
            self.master = {}
        for name, p in named_params.items():
            if self.master is not None:
                self.master[name] = p.detach().to(torch.float32, copy=True)
            self.state[name] = self._init_slots(p)
            self.decay[name] = decays(jax_names[name], p.ndim)

    @torch.no_grad()
    def refresh_master(self, named_params: Dict[str, torch.Tensor]) -> None:
        """The master set from the (cast) parameters, as the JAX trainer
        refreshes it when it loads weights without an optimizer state."""
        if self.master is not None:
            for n, m in self.master.items():
                m.copy_(named_params[n])

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @property
    def supports_accum(self) -> bool:
        """True when micro-batch gradients can fold straight into the
        optimizer's accumulators (``--grad-accum adama``)."""
        return False

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             lr: float, sr_generator: Optional[torch.Generator] = None) -> None:
        """One update of ``params`` in place from fp32 ``grads``: on the
        master, then copied back, when there is one."""
        target = params if self.master is None else self.master
        self._update(target, grads, lr)
        if self.master is not None:
            self._copy_back(params, sr_generator)

    def _update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                lr: float) -> None:
        """The fp32 update of ``params`` (the master, or the fp32
        parameters) in place."""
        raise NotImplementedError

    @torch.no_grad()
    def _copy_back(self, params: Dict[str, torch.Tensor],
                   sr_generator: Optional[torch.Generator]) -> None:
        """master -> parameters (the JAX ``_copy_back``): stochastic
        rounding for bf16 parameters under ``--bf16-sr`` (noise drawn per
        tensor in parameter order), else round to nearest-even."""
        sr = bool(getattr(self.args, "bf16_sr", False)) and sr_generator is not None
        for n, p in params.items():
            m = self.master[n]
            if sr and p.dtype == torch.bfloat16:
                p.copy_(fp32_to_bf16_sr(m, sr_generator))
            else:
                p.copy_(m)

    def state_dict(self):
        """The step count, the slots and the master by parameter name, each
        tensor its own storage: under ``--fused-adam`` they are views into
        flat buffers, which ``torch.save`` would store whole, so a
        checkpoint has one layout with and without the flag."""
        state = {"num_steps": self.num_steps,
                 "state": {n: {k: _owned(v) for k, v in slots.items()}
                           for n, slots in self.state.items()}}
        if self.master is not None:
            state["master"] = {n: _owned(m) for n, m in self.master.items()}
        return state

    def load_state_dict(self, state_dict, optimizer_overrides=None):
        """Restore the step count and every slot in place (onto the slots'
        device) from :meth:`state_dict`.  ``optimizer_overrides`` (the
        ``--optimizer-overrides`` dict) updates the optimizer's args first,
        as the JAX package's ``load_state_dict`` does; betas, eps and weight
        decay are read from the args at each step.  Returns False, leaving
        the fresh state, when the saved slots do not match the parameters
        (names or shapes), or when one of the two has a master and the
        other has none.  The master comes back from the saved one."""
        if optimizer_overrides:
            self.args.__dict__.update(optimizer_overrides)
        saved = state_dict["state"]
        same = saved.keys() == self.state.keys() and all(
            saved[n].keys() == slots.keys()
            and all(saved[n][k].shape == v.shape for k, v in slots.items())
            for n, slots in self.state.items()
        )
        saved_master = state_dict.get("master")
        if (saved_master is None) != (self.master is None):
            return False
        if saved_master is not None and (
            saved_master.keys() != self.master.keys()
            or any(saved_master[n].shape != m.shape for n, m in self.master.items())
        ):
            return False
        if not same:
            return False
        with torch.no_grad():
            for n, slots in self.state.items():
                for k, v in slots.items():
                    v.copy_(saved[n][k])
            if saved_master is not None:
                for n, m in self.master.items():
                    m.copy_(saved_master[n])
        self.num_steps = int(state_dict["num_steps"])
        return True


def _owned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it is a view into a larger storage."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone()


def bias_corrected_step_size(lr: float, step: int,
                             betas: Tuple[float, float]) -> float:
    """``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` computed in fp32, as the
    JAX Adam folds its bias correction into the step size."""
    stepf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(betas[0], dtype=torch.float32), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(betas[1], dtype=torch.float32), stepf)
    lr32 = torch.tensor(lr, dtype=torch.float32)
    return float(lr32 * torch.sqrt(bc2) / bc1)
