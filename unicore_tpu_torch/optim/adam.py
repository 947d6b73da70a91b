"""Adam(W) (counterpart of ``unicore_tpu/optim/adam.py``'s per-leaf path).

fp32 moments; bias correction folded into the step size; decoupled weight
decay ``p *= 1 - step_size * wd`` applied first, on the tensors the decay
mask selects; then ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``p -= step_size * m / (sqrt(v) + eps)``, on the fp32 master when the
parameters are bf16 or fp16 (``UnicoreOptimizer.step`` copies it back).
The updates are plain PyTorch
tensor ops over all parameters at once (``torch._foreach_*``); the JAX
package has no Pallas kernel here either.
"""

import torch

from . import register_optimizer
from .unicore_optimizer import UnicoreOptimizer, bias_corrected_step_size


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

    def _init_slots(self, p):
        return {"m": torch.zeros_like(p, dtype=torch.float32),
                "v": torch.zeros_like(p, dtype=torch.float32)}

    @torch.no_grad()
    def _update(self, params, grads, lr):
        beta1, beta2 = self.betas
        self.num_steps += 1
        step_size = bias_corrected_step_size(lr, self.num_steps, (beta1, beta2))
        names = list(params)
        wd = self.weight_decay
        if wd != 0.0:
            decayed = [params[n] for n in names if self.decay[n]]
            if decayed:
                torch._foreach_mul_(decayed, 1.0 - step_size * wd)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        m = [self.state[n]["m"] for n in names]
        v = [self.state[n]["v"] for n in names]
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, g, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(p, m, denom, value=-step_size)
