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

Under ``--zero-stage`` >= 1 (``parallel/zero.py``, set by the trainer
through :meth:`UnicoreOptimizer.configure_zero` before ``init_state``) each
rank keeps its share of the slots and the master: on this per-tensor path
each tensor's slice along its ``zero.split_dim`` (``layout``, a
:class:`~unicore_tpu_torch.parallel.zero.TensorLayout`), under
``--fused-adam`` its segment of the flat buffers (``optim/adam.py``).  The
update runs on the rank's slices and the updated slices are all-gathered
into the parameters; ``state_dict`` gathers every tensor whole (a
collective: every rank calls it), and ``load_state_dict`` keeps the rank's
share, so a checkpoint is the same at every world size and stage.
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
        #: ZeRO: the rank's spec (None: the whole state), and the layout of
        #: its share of ``state`` and ``master`` (None: by name, whole)
        self.zero = None
        self.layout = None
        #: the parameters' names and shapes, in order
        self.shapes: Dict[str, torch.Size] = {}

    @classmethod
    def add_args(cls, parser):
        pass

    def configure_zero(self, spec) -> None:
        """Shard the state over the data-parallel ranks (a
        :class:`~unicore_tpu_torch.parallel.zero.ZeroSpec`, or None); call
        before :meth:`init_state`."""
        self.zero = spec

    def init_state(self, named_params: Dict[str, torch.Tensor],
                   jax_names: Dict[str, str]) -> None:
        """fp32 slots per parameter and its decay flag from its Flax name;
        an fp32 master copy of the parameters when any is bf16 or fp16 (the
        JAX ``init_state``); under ZeRO each of the rank's slice."""
        self.shapes = {n: p.shape for n, p in named_params.items()}
        if self.zero is not None:
            from unicore_tpu_torch.parallel import zero

            self.layout = zero.TensorLayout(self.shapes, self.zero.world, self.zero.rank)
        if any(p.dtype in LOW_PRECISION for p in named_params.values()):
            self.master = {}
        local = self.local_view(named_params)
        for name, p in local.items():
            if self.master is not None:
                self.master[name] = p.detach().to(torch.float32, copy=True)
            self.state[name] = self._init_slots(p)
            self.decay[name] = decays(jax_names[name], p.ndim)

    # -- the rank's share (ZeRO) --------------------------------------------------

    def local_view(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's share of whole tensors by name (views on the
        per-tensor path; ``named`` itself without ZeRO)."""
        return named if self.layout is None else self.layout.local(named)

    def gather_local(self, local: Dict[str, torch.Tensor],
                     dst: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """Whole tensors by name from every rank's share (a collective
        under ZeRO; ``local`` itself without).  With ``dst``, under ZeRO,
        rank ``dst`` alone gets them, on its host; the others get None."""
        return dict(local) if self.layout is None else self.layout.gather(local, dst)

    def local_weights(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's share of the fp32 weights the update writes and the
        EMA averages: the master, or the fp32 parameters' share."""
        return self.master if self.master is not None else self.local_view(params)

    def state_bytes(self) -> int:
        """Bytes of the optimizer state this rank holds: its share of the
        slots and of the fp32 master (an fp32 run's master is the
        parameters)."""
        tensors = [t for slots in self.state.values() for t in slots.values()]
        tensors += list((self.master or {}).values())
        return sum(t.numel() * t.element_size() for t in tensors)

    @torch.no_grad()
    def refresh_master(self, named_params: Dict[str, torch.Tensor]) -> None:
        """The master set from the (cast) parameters, as the JAX trainer
        refreshes it when it loads weights without an optimizer state."""
        if self.master is not None:
            for n, t in self.local_view(named_params).items():
                self.master[n].copy_(t)

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
        master, then copied back, when there is one; under ZeRO on the
        rank's slices, then gathered."""
        target = self.local_weights(params)
        self._update(target, self.local_view(grads), lr)
        self._finish(params, target, sr_generator)

    @torch.no_grad()
    def _finish(self, params, target, sr_generator) -> None:
        """After the fp32 update of ``target`` (the rank's share): under
        ZeRO the other ranks' slices gathered in, then the copy-back from
        the whole master into the parameters, when there is one."""
        master = self.master
        if self.layout is not None:
            split = {n: t for n, t in target.items() if self.layout.dims[n] is not None}
            whole = self.layout.gather(split) if split else {}
            if master is None:
                for n, t in whole.items():
                    params[n].copy_(t)
            else:
                master = {**master, **whole}
        if master is not None:
            self._copy_back(params, sr_generator, master)

    def _update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                lr: float) -> None:
        """The fp32 update of ``params`` (the master, or the fp32
        parameters) in place."""
        raise NotImplementedError

    @torch.no_grad()
    def _copy_back(self, params: Dict[str, torch.Tensor],
                   sr_generator: Optional[torch.Generator],
                   master: Dict[str, torch.Tensor]) -> None:
        """``master`` (whole, by name) -> parameters (the JAX
        ``_copy_back``): stochastic rounding for bf16 parameters under
        ``--bf16-sr`` (noise drawn per tensor in parameter order), else
        round to nearest-even."""
        sr = bool(getattr(self.args, "bf16_sr", False)) and sr_generator is not None
        for n, p in params.items():
            m = master[n]
            if sr and p.dtype == torch.bfloat16:
                p.copy_(fp32_to_bf16_sr(m, sr_generator))
            else:
                p.copy_(m)

    def _slot_kinds(self):
        return list(next(iter(self.state.values())).keys()) if self.state else []

    def state_dict(self, dst: Optional[int] = None):
        """The step count, the slots and the master by parameter name, each
        tensor whole and its own storage: under ``--fused-adam`` they are
        views into flat buffers, which ``torch.save`` would store whole, and
        under ZeRO each rank's share, gathered here (a collective: every
        rank calls it), so a checkpoint has one layout with and without the
        flags.  With ``dst``, under ZeRO, only rank ``dst`` gets the state,
        on its host (a checkpoint's gather: no other rank holds it whole);
        the others get None."""
        slots = {k: self.gather_local({key: s[k] for key, s in self.state.items()}, dst)
                 for k in self._slot_kinds()}
        master = self.gather_local(self.master, dst) if self.master is not None else None
        if any(v is None for v in slots.values()) or (self.master is not None
                                                     and master is None):
            return None
        state = {"num_steps": self.num_steps,
                 "state": {n: {k: _owned(slots[k][n]) for k in slots} for n in self.shapes}}
        if master is not None:
            state["master"] = {n: _owned(master[n]) for n in self.shapes}
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
        kinds = set(self._slot_kinds())
        same = saved.keys() == self.shapes.keys() and all(
            set(saved[n].keys()) == kinds
            and all(t.shape == shape for t in saved[n].values())
            for n, shape in self.shapes.items()
        )
        saved_master = state_dict.get("master")
        if (saved_master is None) != (self.master is None):
            return False
        if saved_master is not None and (
            saved_master.keys() != self.shapes.keys()
            or any(saved_master[n].shape != shape for n, shape in self.shapes.items())
        ):
            return False
        if not same:
            return False
        with torch.no_grad():
            for k in kinds:
                for key, t in self.local_copy({n: saved[n][k] for n in self.shapes}).items():
                    self.state[key][k].copy_(t)
            if saved_master is not None:
                for key, t in self.local_copy(saved_master).items():
                    self.master[key].copy_(t)
        self.num_steps = int(state_dict["num_steps"])
        return True

    def local_copy(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's share of whole fp32 tensors by name (of a checkpoint),
        in the layout of ``state`` and ``master``."""
        return self.local_view(named)


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
