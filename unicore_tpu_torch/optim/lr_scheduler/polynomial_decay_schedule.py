"""Polynomial decay to an end lr, with warmup by count or ratio
(counterpart of ``unicore_tpu/optim/lr_scheduler/polynomial_decay_schedule.py``)."""

from . import UnicoreLRScheduler, register_lr_scheduler


def polynomial_decay_lr(num_updates, base_lr, end_lr, warmup_updates,
                        total_updates, power):
    """Ramp ``num_updates/warmup * base_lr`` through the warmup, then decay
    ``(base - end) * remaining^power + end`` to ``end_lr`` at
    ``total_updates``."""
    if 0 < warmup_updates and num_updates <= warmup_updates:
        return base_lr * num_updates / float(warmup_updates)
    if num_updates >= total_updates:
        return end_lr
    remaining = 1 - (num_updates - warmup_updates) / float(
        total_updates - warmup_updates
    )
    return (base_lr - end_lr) * remaining ** power + end_lr


@register_lr_scheduler("polynomial_decay")
class PolynomialDecayLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if args.warmup_ratio > 0:
            # ratio form needs the externally-known total step count
            assert total_train_steps is not None
            self.warmup_updates = int(args.warmup_ratio * total_train_steps)
            self.total_num_update = total_train_steps
        else:
            assert args.total_num_update > 0
            self.warmup_updates = args.warmup_updates
            self.total_num_update = args.total_num_update
        self.lr = args.lr[0]
        self.warmup_factor = (
            1.0 / self.warmup_updates if self.warmup_updates > 0 else 1
        )
        self.end_learning_rate = args.end_learning_rate
        self.power = args.power
        self.set_lr(self.warmup_factor * self.lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument("--force-anneal", "--fa", type=int, metavar="N",
                            help="force annealing at specified epoch")
        parser.add_argument("--warmup-updates", default=0, type=int, metavar="N",
                            help="warmup the learning rate linearly for the first N updates")
        parser.add_argument("--warmup-ratio", default=-1.0, type=float, metavar="N",
                            help="warmup the learning rate linearly for the first N-percent updates")
        parser.add_argument("--end-learning-rate", default=0.0, type=float)
        parser.add_argument("--power", default=1.0, type=float)
        parser.add_argument("--total-num-update", default=1000000, type=int)

    def get_next_lr(self, epoch):
        if self.args.force_anneal is None or epoch < self.args.force_anneal:
            lrs = self.args.lr
            return lrs[min(epoch, len(lrs) - 1)]
        return self.get_lr()

    def step_begin_epoch(self, epoch):
        self.lr = self.get_next_lr(epoch)
        self.set_lr(self.warmup_factor * self.lr)
        return self.get_lr()

    def step_update(self, num_updates):
        if 0 < self.warmup_updates and num_updates <= self.warmup_updates:
            # keep the factor: step_begin_epoch re-applies it mid-warmup
            self.warmup_factor = num_updates / float(self.warmup_updates)
        self.set_lr(
            polynomial_decay_lr(
                num_updates, self.lr, self.end_learning_rate,
                self.warmup_updates, self.total_num_update, self.power,
            )
        )
        return self.get_lr()
