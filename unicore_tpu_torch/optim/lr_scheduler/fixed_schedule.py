"""Fixed lr with optional linear warmup and forced epoch annealing (counterpart
of ``unicore_tpu/optim/lr_scheduler/fixed_schedule.py``; pure Python, so the
port's lrs equal the JAX package's)."""

from . import UnicoreLRScheduler, register_lr_scheduler


def epoch_lr(lrs, epoch, force_anneal, lr_shrink):
    """lr for ``epoch`` (1-based): the per-epoch list entry, or — past the
    forced-annealing epoch — the last entry shrunk geometrically."""
    if force_anneal is None or epoch < force_anneal:
        return lrs[min(epoch - 1, len(lrs) - 1)]
    return lrs[-1] * lr_shrink ** (epoch + 1 - force_anneal)


@register_lr_scheduler("fixed")
class FixedLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        self.lr = args.lr[0]
        self.warmup_factor = (
            1.0 / args.warmup_updates if args.warmup_updates > 0 else 1
        )

    @staticmethod
    def add_args(parser):
        parser.add_argument(
            "--force-anneal", "--fa", type=int, metavar="N",
            help="force annealing at specified epoch",
        )
        parser.add_argument(
            "--lr-shrink", default=0.1, type=float, metavar="LS",
            help="shrink factor for annealing, lr_new = (lr * lr_shrink)",
        )
        parser.add_argument(
            "--warmup-updates", default=0, type=int, metavar="N",
            help="warmup the learning rate linearly for the first N updates",
        )

    def state_dict(self):
        return {"lr": self.lr}

    def load_state_dict(self, state_dict):
        if "lr" in state_dict:
            self.lr = state_dict["lr"]

    def get_next_lr(self, epoch):
        return epoch_lr(
            self.args.lr, epoch, self.args.force_anneal, self.args.lr_shrink
        )

    def step_begin_epoch(self, epoch):
        self.lr = self.get_next_lr(epoch)
        self.set_lr(self.warmup_factor * self.lr)
        return self.get_lr()

    def step_update(self, num_updates):
        warmup = self.args.warmup_updates
        if 0 < warmup and num_updates < warmup:
            self.warmup_factor = (num_updates + 1) / float(warmup)
            self.set_lr(self.warmup_factor * self.lr)
        else:
            self.set_lr(self.lr)
        return self.get_lr()
