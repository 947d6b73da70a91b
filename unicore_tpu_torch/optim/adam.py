"""Adam(W) (counterpart of ``unicore_tpu/optim/adam.py``).

fp32 moments; bias correction folded into the step size; decoupled weight
decay ``p *= 1 - step_size * wd`` applied first, on the tensors the decay
mask selects; then ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= step_size * m / (sqrt(v) + eps)``, on the fp32 master when the
parameters are bf16 or fp16 (copied back to them).  Every operation is
rounded on its own (:func:`multi_tensor.adam_elementwise`), so the two
paths agree bit for bit:

- the default path: ``torch._foreach_*`` over the per-parameter tensors;
- ``--fused-adam``: the parameters, master and slots live in flat
  buffers (``optim/multi_tensor.py``), and an update is the
  ``multi_tensor_l2norm`` kernel for the gradient norm and the
  ``fused_adam`` kernel for the clip, decay, moments, update and
  copy-back: one pass per dtype group.  On the CPU the same functions in
  plain torch.

``--grad-accum adama`` (arXiv 2305.19982, the JAX ``accum_*`` and
``update_from_accum``): each micro-batch's gradient folds straight into
moment accumulators, normalisation and clipping are deferred into the
moment recovery, and the pre-update moments stay untouched until the
update, so a skipped update leaves them bit for bit.  These stay
per-tensor under ``--fused-adam`` too, as in the JAX package.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import multi_tensor, register_optimizer
from .multi_tensor import AdamHyper, FlatPlan, adam_apply, adam_elementwise
from .unicore_optimizer import LOW_PRECISION, UnicoreOptimizer, bias_corrected_step_size, decays


@register_optimizer("adam")
class Adam(UnicoreOptimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adam-betas", default="(0.9, 0.999)", metavar="B",
                            help="betas for Adam optimizer")
        parser.add_argument("--adam-eps", type=float, default=1e-8, metavar="D",
                            help="epsilon for Adam optimizer")
        parser.add_argument("--weight-decay", "--wd", default=0.0, type=float,
                            metavar="WD", help="weight decay")
        parser.add_argument("--fused-adam", action="store_true",
                            help="multi-tensor Adam: run grad-norm/clip/moments/decay as "
                                 "one fused pass per dtype-homogeneous flat buffer instead "
                                 "of O(leaves) per-leaf ops (optim/multi_tensor.py; "
                                 "bit-identical update in fp32)")

    def __init__(self, args):
        super().__init__(args)
        #: --fused-adam: the flat plan and, per dtype group, its buffers
        #: (``master``, ``param`` -- None when the master is the parameters
        #: --, ``m``, ``v``, ``g``)
        self.plan: Optional[FlatPlan] = None
        self.flat = []

    @property
    def use_fused(self):
        return bool(getattr(self.args, "fused_adam", False))

    @property
    def betas(self):
        b = getattr(self.args, "adam_betas", "(0.9, 0.999)")
        if isinstance(b, str):
            b = tuple(float(x) for x in b.strip("()[] ").split(","))
        return tuple(b)

    @property
    def eps(self):
        return getattr(self.args, "adam_eps", 1e-8)

    @property
    def weight_decay(self):
        return getattr(self.args, "weight_decay", 0.0)

    def hyper(self, lr: float) -> AdamHyper:
        """The scalars of update ``num_steps``: the step size in fp32 (the
        JAX ``lr * sqrt(bc2) / bc1``) and the decay factor ``1 - step_size
        * wd`` in fp32, as the JAX update computes it."""
        step_size = bias_corrected_step_size(lr, self.num_steps, self.betas)
        wd = self.weight_decay
        factor = float(np.float32(1.0) - np.float32(step_size) * np.float32(wd))
        return AdamHyper(self.betas[0], self.betas[1], self.eps, step_size, wd, factor)

    def _init_slots(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    def init_state(self, named_params, jax_names):
        """Under ``--fused-adam`` the flat buffers of every dtype group,
        the parameters, master and slots made views into them; else the
        per-tensor state."""
        if not self.use_fused:
            return super().init_state(named_params, jax_names)
        self.decay = {n: decays(jax_names[n], p.ndim) for n, p in named_params.items()}
        low = any(p.dtype in LOW_PRECISION for p in named_params.values())
        self.plan = FlatPlan.build(named_params, self.decay)
        self.flat = []
        for group in self.plan.groups:
            params_flat = group.flatten({n: p.detach() for n, p in named_params.items()})
            bufs = {"m": torch.zeros_like(params_flat, dtype=torch.float32)}
            bufs["v"] = torch.zeros_like(bufs["m"])
            # adama folds gradients into per-tensor accumulators instead
            adama = getattr(self.args, "grad_accum", "buffer") == "adama"
            bufs["g"] = None if adama else torch.zeros_like(bufs["m"])
            if low:
                bufs["master"], bufs["param"] = params_flat.float(), params_flat
            else:
                bufs["master"], bufs["param"] = params_flat, None
            for name, view in group.views(params_flat).items():
                named_params[name].data = view
            self.flat.append(bufs)
        for key in ("m", "v"):
            for n, view in self.plan.unflatten([b[key] for b in self.flat]).items():
                self.state.setdefault(n, {})[key] = view
        if low:
            self.master = self.plan.unflatten([b["master"] for b in self.flat])

    @torch.no_grad()
    def _update(self, params, grads, lr):
        self.num_steps += 1
        hp = self.hyper(lr)
        names = list(params)
        adam_elementwise([params[n] for n in names], [grads[n] for n in names],
                         [self.state[n]["m"] for n in names],
                         [self.state[n]["v"] for n in names], hp,
                         [self.decay[n] for n in names])

    # -- --fused-adam -----------------------------------------------------------

    def grad_buffers(self) -> Dict[str, torch.Tensor]:
        """name -> the view of its flat gradient accumulator (zeroed by
        :meth:`zero_grad_buffers`)."""
        return self.plan.unflatten([b["g"] for b in self.flat])

    def zero_grad_buffers(self) -> None:
        for b in self.flat:
            b["g"].zero_()

    def fused_grad_norm(self, denom: torch.Tensor) -> torch.Tensor:
        """The global norm of the accumulated gradients divided by
        ``denom``: ``multi_tensor_l2norm`` over the flat buffers, a device
        scalar (no sync)."""
        return multi_tensor.multi_tensor_l2norm([b["g"] for b in self.flat], denom)

    @torch.no_grad()
    def fused_step(self, lr: float, denom: torch.Tensor, gnorm: torch.Tensor,
                   max_norm: float, sr_key: Optional[Tuple[int, int]]) -> None:
        """One update of every group from its flat gradient accumulator:
        ``fused_adam`` per group, reading ``denom`` and the norm on the
        device; a non-finite norm leaves everything as it was (the caller
        then calls :meth:`unstep`)."""
        self.num_steps += 1
        hp = self.hyper(lr)
        for i, (group, b) in enumerate(zip(self.plan.groups, self.flat)):
            multi_tensor.adam_group(b["master"], b["m"], b["v"], b["g"], group, hp, b["param"],
                                    denom=denom, gnorm=gnorm, max_norm=max_norm,
                                    sr_key=sr_key, buffer_id=i)

    def unstep(self) -> None:
        """Undo the step count of a :meth:`fused_step` the kernel skipped."""
        self.num_steps -= 1

    # -- --grad-accum adama -------------------------------------------------------

    @property
    def supports_accum(self):
        return True

    @torch.no_grad()
    def accum_init(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The moment accumulators at the start of an update: ``beta1 m``
        and ``beta2 v`` (per tensor, beside the moments)."""
        beta1, beta2 = self.betas
        return {"m": {n: s["m"] * beta1 for n, s in self.state.items()},
                "v": {n: s["v"] * beta2 for n, s in self.state.items()}}

    @torch.no_grad()
    def accum_fold(self, acc, grads: Dict[str, torch.Tensor]) -> None:
        """One micro-batch's gradients (fp32) folded in place:
        ``m_acc += (1 - beta1) g``, ``v_acc += (1 - beta2) g^2``."""
        beta1, beta2 = self.betas
        for n, g in grads.items():
            acc["m"][n].add_(g * (1.0 - beta1))
            acc["v"][n].add_((g * g).mul_(1.0 - beta2))

    @torch.no_grad()
    def accum_gnorm(self, acc) -> torch.Tensor:
        """||sum_k g_k|| recovered from the first-moment accumulator; non-
        finite iff a micro-batch's gradient was."""
        beta1 = self.betas[0]
        inv = 1.0 / (1.0 - beta1)
        parts = [(acc["m"][n] - s["m"] * beta1) * inv for n, s in self.state.items()]
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(parts)))

    @torch.no_grad()
    def update_from_accum(self, acc, params, lr: float, denom: torch.Tensor,
                          clip_coef: torch.Tensor, sr_generator=None) -> None:
        """Finish an accumulated update: the deferred normalise and clip
        folded into the moment recovery, then the bias-corrected AdamW
        update and the copy-back."""
        beta1, beta2 = self.betas
        scale_m = clip_coef / denom
        scale_v = scale_m * scale_m
        for n, s in self.state.items():
            for key, beta, scale in (("m", beta1, scale_m), ("v", beta2, scale_v)):
                old = s[key] * beta
                s[key].copy_(old + (acc[key][n] - old) * scale)
        self.num_steps += 1
        hp = self.hyper(lr)
        target = params if self.master is None else self.master
        names = list(params)
        adam_apply([target[n] for n in names], [self.state[n]["m"] for n in names],
                   [self.state[n]["v"] for n in names], hp, [self.decay[n] for n in names])
        if self.master is not None:
            self._copy_back(params, sr_generator)
