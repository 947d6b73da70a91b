"""Exponential decay (smooth or staircase) with linear warmup (counterpart of
``unicore_tpu/optim/lr_scheduler/exponential_decay_schedule.py``; pure
Python, so the port's lrs equal the JAX package's)."""

from . import UnicoreLRScheduler, register_lr_scheduler


def exponential_decay_lr(num_updates, base_lr, warmup_updates, decay_ratio,
                         decay_steps, stair):
    """Warmup ramp, then ``base * ratio^(t/decay_steps)``; staircase mode
    floors the exponent (and counts t from update 0, as Uni-Core
    does)."""
    if 0 < warmup_updates and num_updates <= warmup_updates:
        return base_lr * num_updates / float(warmup_updates)
    if stair:
        exponent = int(num_updates // decay_steps)
    else:
        exponent = (num_updates - warmup_updates) / float(decay_steps)
    return base_lr * float(decay_ratio ** exponent)


@register_lr_scheduler("exponential_decay")
class ExponentialDecayLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        self.lr = args.lr[0]
        warmup = args.warmup_updates
        self.set_lr(self.lr / warmup if warmup > 0 else self.lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--warmup-updates", default=1000, type=int, metavar="N",
            help="warmup the learning rate linearly for the first N updates",
        )
        parser.add_argument("--decay-ratio", default=0.95, type=float)
        parser.add_argument("--decay-steps", default=500, type=int)
        parser.add_argument("--stair-decay", action="store_true")

    def step_update(self, num_updates):
        self.set_lr(
            exponential_decay_lr(
                num_updates,
                self.lr,
                self.args.warmup_updates,
                self.args.decay_ratio,
                self.args.decay_steps,
                getattr(self.args, "stair_decay", False),
            )
        )
        return self.get_lr()
