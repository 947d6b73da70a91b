"""SGD, Adagrad and Adadelta (counterpart of ``unicore_tpu/optim/sgd.py``).

fp32 updates of the parameters (or the fp32 master), per tensor in plain
torch; the JAX package has no kernel here either.  Weight decay is added to
the gradient (``g + wd * p``) on the tensors the decay mask selects, as the
JAX optimizers add it.  None of them supports ``--grad-accum adama``.
"""

import torch

from . import register_optimizer
from .unicore_optimizer import UnicoreOptimizer


def _with_decay(opt, params, grads, names):
    """The gradients with ``wd * p`` added where the decay mask says."""
    wd = getattr(opt.args, "weight_decay", 0.0)
    if wd == 0.0:
        return [grads[n] for n in names]
    return [grads[n] + params[n] * wd if opt.decay[n] else grads[n] for n in names]


@register_optimizer("sgd")
class SGD(UnicoreOptimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--momentum", default=0.0, type=float, metavar="M",
                            help="momentum factor")
        parser.add_argument("--weight-decay", "--wd", default=0.0, type=float,
                            metavar="WD", help="weight decay")

    @property
    def momentum(self):
        return getattr(self.args, "momentum", 0.0)

    def _init_slots(self, p):
        if self.momentum != 0.0:
            return {"momentum": torch.zeros_like(p, dtype=torch.float32)}
        return {}

    @torch.no_grad()
    def _update(self, params, grads, lr):
        self.num_steps += 1
        names = list(params)
        g = _with_decay(self, params, grads, names)
        p = [params[n] for n in names]
        if self.momentum != 0.0:
            buf = [self.state[n]["momentum"] for n in names]
            torch._foreach_mul_(buf, self.momentum)
            torch._foreach_add_(buf, g)
            g = buf
        torch._foreach_sub_(p, torch._foreach_mul(g, lr))


@register_optimizer("adagrad")
class Adagrad(UnicoreOptimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--weight-decay", "--wd", default=0.0, type=float,
                            metavar="WD", help="weight decay")
        parser.add_argument("--adagrad-eps", default=1e-10, type=float)

    def _init_slots(self, p):
        return {"sum": torch.zeros_like(p, dtype=torch.float32)}

    @torch.no_grad()
    def _update(self, params, grads, lr):
        self.num_steps += 1
        eps = getattr(self.args, "adagrad_eps", 1e-10)
        names = list(params)
        g = _with_decay(self, params, grads, names)
        s = [self.state[n]["sum"] for n in names]
        torch._foreach_add_(s, torch._foreach_mul(g, g))
        denom = torch._foreach_sqrt(s)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_mul(g, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_([params[n] for n in names], upd)


@register_optimizer("adadelta")
class Adadelta(UnicoreOptimizer):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adadelta-rho", type=float, default=0.9, metavar="RHO",
                            help="coefficient used for computing a running average")
        parser.add_argument("--adadelta-eps", type=float, default=1e-6, metavar="EPS",
                            help="term added to the denominator")
        parser.add_argument("--weight-decay", "--wd", default=0.0, type=float,
                            metavar="WD", help="weight decay")

    def _init_slots(self, p):
        return {"square_avg": torch.zeros_like(p, dtype=torch.float32),
                "acc_delta": torch.zeros_like(p, dtype=torch.float32)}

    @torch.no_grad()
    def _update(self, params, grads, lr):
        self.num_steps += 1
        rho = getattr(self.args, "adadelta_rho", 0.9)
        eps = getattr(self.args, "adadelta_eps", 1e-6)
        names = list(params)
        g = _with_decay(self, params, grads, names)
        sq = [self.state[n]["square_avg"] for n in names]
        acc = [self.state[n]["acc_delta"] for n in names]
        torch._foreach_mul_(sq, rho)
        gg = torch._foreach_mul(g, g)
        torch._foreach_mul_(gg, 1 - rho)
        torch._foreach_add_(sq, gg)
        # delta = sqrt(acc + eps) / sqrt(sq + eps) * g
        delta = torch._foreach_sqrt(torch._foreach_add(acc, eps))
        torch._foreach_div_(delta, torch._foreach_sqrt(torch._foreach_add(sq, eps)))
        torch._foreach_mul_(delta, g)
        torch._foreach_mul_(acc, rho)
        dd = torch._foreach_mul(delta, delta)
        torch._foreach_mul_(dd, 1 - rho)
        torch._foreach_add_(acc, dd)
        torch._foreach_sub_([params[n] for n in names], torch._foreach_mul(delta, lr))
