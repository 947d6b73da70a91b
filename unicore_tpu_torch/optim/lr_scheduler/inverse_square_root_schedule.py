"""Inverse-square-root decay with linear warmup (the Transformer schedule)
(counterpart of
``unicore_tpu/optim/lr_scheduler/inverse_square_root_schedule.py``; pure
Python, so the port's lrs equal the JAX package's)."""

from . import UnicoreLRScheduler, linear_warmup, register_lr_scheduler, single_lr


def inverse_sqrt_lr(num_updates, warmup_updates, warmup_init_lr, peak_lr):
    """Linear ramp to ``peak_lr`` over the warmup, then decay proportional
    to 1/sqrt(update) — continuous at the boundary."""
    if num_updates < warmup_updates:
        return linear_warmup(num_updates, warmup_updates, warmup_init_lr, peak_lr)
    return peak_lr * (warmup_updates ** 0.5) * num_updates ** -0.5


@register_lr_scheduler("inverse_sqrt")
class InverseSquareRootSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if args.warmup_updates <= 0:
            # the decay term is peak * sqrt(warmup/t): warmup 0 would mean
            # a permanent lr of 0 — reject loudly
            raise ValueError(
                "inverse_sqrt requires --warmup-updates > 0"
            )
        self.peak_lr = single_lr(args, "inverse_sqrt")
        if args.warmup_init_lr < 0:
            args.warmup_init_lr = 0 if args.warmup_updates > 0 else self.peak_lr
        self.set_lr(args.warmup_init_lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--warmup-updates", default=4000, type=int, metavar="N",
            help="warmup the learning rate linearly for the first N updates",
        )
        parser.add_argument(
            "--warmup-init-lr", default=-1, type=float, metavar="LR",
            help="initial learning rate during warmup phase; default is args.lr",
        )

    def step(self, epoch, val_loss=None):
        super().step(epoch, val_loss)
        return self.get_lr()

    def step_update(self, num_updates):
        self.set_lr(
            inverse_sqrt_lr(
                num_updates,
                self.args.warmup_updates,
                self.args.warmup_init_lr,
                self.peak_lr,
            )
        )
        return self.get_lr()
