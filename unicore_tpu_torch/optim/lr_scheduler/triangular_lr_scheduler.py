"""Triangular cyclical lr (CLR), optionally shrinking per cycle (counterpart of
``unicore_tpu/optim/lr_scheduler/triangular_lr_scheduler.py``; pure Python,
so the port's lrs equal the JAX package's)."""

import math

from . import UnicoreLRScheduler, register_lr_scheduler, single_lr


def triangular_lr(num_updates, *, min_lr, max_lr, stepsize, lr_shrink,
                  shrink_min):
    """Sawtooth between min and max with half-cycle ``stepsize`` updates;
    every full cycle scales the peak (and optionally the floor) by
    ``lr_shrink``."""
    cycle = math.floor(num_updates / (2 * stepsize))
    shrink = lr_shrink ** cycle
    hi = max_lr * shrink
    lo = min_lr * shrink if shrink_min else min_lr
    # distance from the cycle's peak, normalized to [0, 1]
    x = abs(num_updates / stepsize - 2 * (cycle + 1) + 1)
    return lo + (hi - lo) * max(0, 1 - x)


@register_lr_scheduler("triangular")
class TriangularLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        self.min_lr = single_lr(args, "triangular")
        assert args.max_lr > self.min_lr, "max_lr must be more than lr"
        self.stepsize = args.lr_period_updates // 2
        self.set_lr(self.min_lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--max-lr", required=True, type=float, metavar="LR",
            help="max learning rate, must be more than args.lr",
        )
        parser.add_argument(
            "--lr-period-updates", default=5000, type=float, metavar="LR",
            help="initial number of updates per period (cycle length)",
        )
        parser.add_argument(
            "--lr-shrink", default=0.1, type=float, metavar="LS",
            help="shrink factor for annealing",
        )
        parser.add_argument(
            "--shrink-min", action="store_true",
            help="if set, also shrinks min lr",
        )

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.get_lr()

    def step_update(self, num_updates):
        self.set_lr(
            triangular_lr(
                num_updates,
                min_lr=self.min_lr,
                max_lr=self.args.max_lr,
                stepsize=self.stepsize,
                lr_shrink=self.args.lr_shrink,
                shrink_min=self.args.shrink_min,
            )
        )
        return self.get_lr()
