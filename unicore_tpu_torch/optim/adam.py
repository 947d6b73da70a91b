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

Under ``--zero-stage`` >= 1 with ``--fused-adam`` (``parallel/zero.py``)
the flat buffers are padded to a multiple of the world size times
``NORM_SPAN`` and each rank allocates ``m``, ``v`` and, for bf16/fp16
parameters, the fp32 master for its segment only; the parameters and the
gradient accumulator stay whole (the backward writes every gradient), and
the reduce-scatter of stages 2/3 writes the rank's segment of the
accumulator in place: stage 2 holds no more than stage 1 and moves half
the bytes of an all-reduce.  An update is K-a over the whole reduced
gradient (stage 1) or its sum-of-squares mode on the reduce-scattered
segment with the partials gathered (stages 2/3; both stage 0's bits), K-b
on the segment, and one all-gather per group rebuilding the parameters:
all on the device.  Under ``--grad-accum adama`` the state follows the
per-tensor rule instead (the base class).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import multi_tensor, register_optimizer
from .multi_tensor import NORM_SPAN, AdamHyper, FlatPlan, adam_apply, adam_elementwise
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
        #: each group's first element of the rank's segment (0: the whole)
        self.starts = []

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
        the parameters, master and slots made views into them (under ZeRO
        the rank's segment of each: ``m``, ``v`` and the master its own,
        ``state`` and ``master`` keyed ``flat.<group>``); else the
        per-tensor state."""
        # adama folds gradients into per-tensor accumulators instead
        adama = getattr(self.args, "grad_accum", "buffer") == "adama"
        if not self.use_fused or (adama and self.zero is not None):
            return super().init_state(named_params, jax_names)
        from unicore_tpu_torch.parallel import zero

        self.shapes = {n: p.shape for n, p in named_params.items()}
        self.decay = {n: decays(jax_names[n], p.ndim) for n, p in named_params.items()}
        low = any(p.dtype in LOW_PRECISION for p in named_params.values())
        z = self.zero
        self.plan = FlatPlan.build(named_params, self.decay,
                                   pad=z.world * NORM_SPAN if z is not None else 1)
        self.layout = zero.FlatLayout(self.plan, z.world, z.rank) if z is not None else None
        self.flat, self.starts = [], []
        for group in self.plan.groups:
            params_flat = group.flatten({n: p.detach() for n, p in named_params.items()})
            start, size = self.layout.segment(group) if z is not None else (0, group.padded)
            seg = params_flat[start:start + size]
            self.starts.append(start)
            bufs = {"full": params_flat, "m": torch.zeros_like(seg, dtype=torch.float32)}
            bufs["v"] = torch.zeros_like(bufs["m"])
            bufs["g"] = None if adama else torch.zeros_like(params_flat, dtype=torch.float32)
            # the gradient the update reads: the rank's segment of the whole
            # one, which the reduce-scatter of stages 2/3 writes in place
            if bufs["g"] is not None:
                bufs["g_seg"] = bufs["g"][start:start + size]
            if low:
                bufs["master"], bufs["param"] = seg.float(), seg
            else:
                bufs["master"], bufs["param"] = seg, None
            for name, view in group.views(params_flat).items():
                named_params[name].data = view
            self.flat.append(bufs)
        if z is not None:
            keys = [f"flat.{i}" for i in range(len(self.flat))]
            self.state = {k: {"m": b["m"], "v": b["v"]} for k, b in zip(keys, self.flat)}
            if low:
                self.master = {k: b["master"] for k, b in zip(keys, self.flat)}
            return
        for key in ("m", "v"):
            for n, view in self.plan.unflatten([b[key] for b in self.flat]).items():
                self.state.setdefault(n, {})[key] = view
        if low:
            self.master = self.plan.unflatten([b["master"] for b in self.flat])

    # -- the rank's share under ZeRO (the flat layout) ----------------------------

    @property
    def _flat_zero(self) -> bool:
        return self.plan is not None and self.layout is not None

    def local_copy(self, named):
        return self.layout.local(named) if self._flat_zero else super().local_copy(named)

    def local_weights(self, params):
        if self._flat_zero:
            return {f"flat.{i}": b["master"] for i, b in enumerate(self.flat)}
        return super().local_weights(params)

    @torch.no_grad()
    def refresh_master(self, named_params):
        if self._flat_zero:
            if self.master is not None:
                for b in self.flat:
                    b["master"].copy_(b["param"])
            return
        super().refresh_master(named_params)

    def live_buffers(self) -> Dict[str, torch.Tensor]:
        """The flat state a rewind restores, each buffer its own storage:
        every group's whole parameter buffer (an fp32 run's master), its
        share of ``m`` and ``v`` and of a low-precision run's master."""
        live = {}
        for i, b in enumerate(self.flat):
            live[f"flat.{i}.full"] = b["full"]
            if b["param"] is not None:
                live[f"flat.{i}.master"] = b["master"]
            live[f"flat.{i}.m"] = b["m"]
            live[f"flat.{i}.v"] = b["v"]
        return live

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

    def scatter_buffers(self):
        """(whole gradient buffers, the rank's segment of each, a view) of
        the stage-2 reduce-scatter, which writes the segment in place."""
        return [b["g"] for b in self.flat], [b["g_seg"] for b in self.flat]

    def fused_grad_norm(self, denom: torch.Tensor) -> torch.Tensor:
        """The global norm of the accumulated gradients divided by
        ``denom``, a device scalar (no sync): ``multi_tensor_l2norm`` over
        the flat buffers' parameter elements, or under a reduce-scatter its
        sum-of-squares mode on the rank's segments, the partials gathered
        in rank order and folded by its stage 2 alone (stage 0's bits: the
        segments start at multiples of ``NORM_SPAN``)."""
        if not (self._flat_zero and self.zero.scatter):
            return multi_tensor.multi_tensor_l2norm(
                [b["g"][:g.numel] for g, b in zip(self.plan.groups, self.flat)], denom)
        from unicore_tpu_torch.parallel import zero

        mine = multi_tensor.l2norm_partials([b["g_seg"] for b in self.flat], denom)
        rows = zero.all_gather(mine, self.zero.world).view(self.zero.world, -1)
        parts, col = [], 0
        for g, b in zip(self.plan.groups, self.flat):
            n = b["g_seg"].numel() // NORM_SPAN
            parts.append(rows[:, col:col + n].reshape(-1)[:multi_tensor.norm_partials(g.numel)])
            col += n
        return multi_tensor.l2norm_final(torch.cat(parts))

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
            multi_tensor.adam_group(b["master"], b["m"], b["v"], b["g_seg"], group, hp,
                                    b["param"], offset=self.starts[i], denom=denom,
                                    gnorm=gnorm, max_norm=max_norm, sr_key=sr_key, buffer_id=i)
        if self._flat_zero:
            from unicore_tpu_torch.parallel import zero

            # every rank's updated segment into every rank's parameters (a
            # skipped update sends the segment as it was)
            for b, start in zip(self.flat, self.starts):
                zero.all_gather_into(b["full"], start, b["m"].numel())

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
        """One micro-batch's gradients (fp32, whole) folded in place into
        the rank's share: ``m_acc += (1 - beta1) g``, ``v_acc += (1 - beta2)
        g^2``."""
        beta1, beta2 = self.betas
        for n, g in self.local_view(grads).items():
            acc["m"][n].add_(g * (1.0 - beta1))
            acc["v"][n].add_((g * g).mul_(1.0 - beta2))

    @torch.no_grad()
    def accum_gnorm(self, acc) -> torch.Tensor:
        """||sum_k g_k|| recovered from the first-moment accumulator; non-
        finite iff a micro-batch's gradient was.  Under ZeRO the squares of
        each rank's slices (a whole tensor's on rank 0 alone) summed over the
        ranks on the device: the norm within fp32 reassociation of the
        unsharded one."""
        beta1 = self.betas[0]
        inv = 1.0 / (1.0 - beta1)
        parts = [(acc["m"][n] - s["m"] * beta1) * inv for n, s in self.state.items()]
        if self.layout is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(parts)))
        import torch.distributed as dist

        mine = [p for n, p in zip(self.state, parts)
                if self.layout.dims[n] is not None or self.zero.rank == 0]
        sq = torch.stack(torch._foreach_norm(mine)).square().sum() if mine else \
            parts[0].new_zeros(())
        dist.all_reduce(sq)
        return torch.sqrt(sq)

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
        target = self.local_weights(params)
        names = list(params)
        adam_apply([target[n] for n in names], [self.state[n]["m"] for n in names],
                   [self.state[n]["v"] for n in names], hp, [self.decay[n] for n in names])
        self._finish(params, target, sr_generator)
