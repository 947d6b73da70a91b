"""Cosine annealing with warm restarts (SGDR) and linear warmup (counterpart of
``unicore_tpu/optim/lr_scheduler/cosine_lr_scheduler.py``; pure Python, so
the port's lrs equal the JAX package's)."""

import math

from . import UnicoreLRScheduler, linear_warmup, register_lr_scheduler, single_lr


def cosine_lr(num_updates, *, warmup_updates, warmup_init_lr, min_lr, max_lr,
              period, t_mult, lr_shrink):
    """lr after warmup: cosine within the current restart period.

    With ``t_mult != 1`` period i has length ``t_mult^i * period``; each
    restart shrinks both ends of the range by ``lr_shrink``.
    """
    if num_updates < warmup_updates:
        return linear_warmup(num_updates, warmup_updates, warmup_init_lr, max_lr)
    t = num_updates - warmup_updates
    if t_mult != 1:
        # which restart period t falls in, and the offset into it
        i = math.floor(math.log(1 - t / period * (1 - t_mult), t_mult))
        length = t_mult ** i * period
        start = (1 - t_mult ** i) / (1 - t_mult) * period
        frac = (t - start) / length
    else:
        i = 0
        frac = min(1.0, t / period)
    shrink = lr_shrink ** i
    lo, hi = min_lr * shrink, max_lr * shrink
    return lo + 0.5 * (hi - lo) * (1 + math.cos(math.pi * frac))


@register_lr_scheduler("cosine")
class CosineLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, unicore_optimizer, total_train_steps):
        super().__init__(args, unicore_optimizer, total_train_steps)
        self.max_lr = single_lr(args, "cosine")
        assert self.max_lr > args.min_lr, (
            f"max_lr (={args.lr}) must be more than min_lr (={args.min_lr})"
        )
        assert total_train_steps is not None
        if args.warmup_ratio > 0:
            self.warmup_updates = int(args.warmup_ratio * total_train_steps)
        else:
            self.warmup_updates = args.warmup_updates
        if args.warmup_init_lr < 0:
            args.warmup_init_lr = args.min_lr
        self.period = args.lr_period_updates
        if self.period <= 0:
            self.period = total_train_steps - self.warmup_updates
        self.set_lr(args.warmup_init_lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--warmup-updates", default=0, type=int, metavar="N",
            help="warmup the learning rate linearly for the first N updates",
        )
        parser.add_argument(
            "--warmup-ratio", default=-1.0, type=float, metavar="N",
            help="warmup the learning rate linearly for the first N-percent updates",
        )
        parser.add_argument(
            "--warmup-init-lr", default=-1, type=float, metavar="LR",
            help="initial learning rate during warmup phase; default is args.lr",
        )
        parser.add_argument(
            "--min-lr", type=float, metavar="LR", default=0.0,
            help="min learning rate",
        )
        parser.add_argument(
            "--max-lr", type=float, metavar="LR",
            help="max learning rate, must be more than args.lr",
        )
        parser.add_argument(
            "--t-mult", default=1, type=float, metavar="LR",
            help="factor to grow the length of each period",
        )
        parser.add_argument(
            "--lr-period-updates", default=-1, type=float, metavar="LR",
            help="initial number of updates per period",
        )
        parser.add_argument(
            "--lr-shrink", default=0.1, type=float, metavar="LS",
            help="shrink factor for annealing",
        )

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.get_lr()

    def step_update(self, num_updates):
        self.set_lr(
            cosine_lr(
                num_updates,
                warmup_updates=self.warmup_updates,
                warmup_init_lr=self.args.warmup_init_lr,
                min_lr=self.args.min_lr,
                max_lr=self.max_lr,
                period=self.period,
                t_mult=self.args.t_mult,
                lr_shrink=self.args.lr_shrink,
            )
        )
        return self.get_lr()
