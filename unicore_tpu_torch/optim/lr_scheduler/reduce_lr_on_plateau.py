"""Reduce-on-plateau: the lr shrinks by ``--lr-shrink`` after ``--lr-patience``
epochs without a better validation loss, with linear warmup (counterpart of
``unicore_tpu/optim/lr_scheduler/reduce_lr_on_plateau.py``; pure Python, so
the port's lrs equal the JAX package's)."""

from . import UnicoreLRScheduler, register_lr_scheduler


@register_lr_scheduler("reduce_lr_on_plateau")
class ReduceLROnPlateauLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if len(args.lr) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with reduce_lr_on_plateau."
                " Consider --lr-scheduler=fixed instead."
            )
        self.patience = args.lr_patience
        self.factor = args.lr_shrink
        self.threshold = args.lr_threshold
        self.maximize = getattr(args, "maximize_best_checkpoint_metric", False)
        self.best_metric = None
        self.num_bad_epochs = 0
        self.last_epoch = 0

        warmup_end_lr = args.lr[0]
        if args.warmup_init_lr < 0:
            args.warmup_init_lr = 0 if args.warmup_updates > 0 else warmup_end_lr
        if args.warmup_updates > 0:
            self.lr_step = (warmup_end_lr - args.warmup_init_lr) / args.warmup_updates
        self.warmup_end = True if args.warmup_updates <= 0 else False
        self.peak_lr = warmup_end_lr
        self.lr = args.warmup_init_lr
        self.set_lr(self.lr)

    @staticmethod
    def add_args(parser):
        parser.add_argument('--lr-shrink', default=0.1, type=float, metavar='LS',
                            help='shrink factor for annealing, lr_new = (lr * lr_shrink)')
        parser.add_argument('--lr-threshold', default=1e-4, type=float, metavar='LT',
                            help='threshold for measuring the new optimum')
        parser.add_argument('--lr-patience', default=0, type=int,
                            help='number of epochs with no improvement before reducing lr')
        parser.add_argument('--warmup-updates', default=0, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--warmup-init-lr', default=-1, type=float, metavar='LR',
                            help='initial learning rate during warmup phase; default is args.lr')

    def state_dict(self):
        return {
            "best": self.best_metric,
            "last_epoch": self.last_epoch,
            "num_bad_epochs": self.num_bad_epochs,
            "lr": self.get_lr(),
        }

    def load_state_dict(self, state_dict):
        self.best_metric = state_dict.get("best", None)
        self.last_epoch = state_dict.get("last_epoch", 0)
        self.num_bad_epochs = state_dict.get("num_bad_epochs", 0)
        if "lr" in state_dict:
            self.set_lr(state_dict["lr"])

    def _is_better(self, metric):
        if self.best_metric is None:
            return True
        if self.maximize:
            return metric > self.best_metric * (1 + self.threshold)
        return metric < self.best_metric * (1 - self.threshold)

    def step(self, epoch, val_loss=None):
        if val_loss is not None and self.warmup_end:
            if self._is_better(val_loss):
                self.best_metric = val_loss
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
                if self.num_bad_epochs > self.patience:
                    self.set_lr(self.get_lr() * self.factor)
                    self.num_bad_epochs = 0
        self.last_epoch = epoch
        return self.get_lr()

    def step_update(self, num_updates):
        if self.args.warmup_updates > 0:
            if num_updates <= self.args.warmup_updates:
                self.lr = self.args.warmup_init_lr + num_updates * self.lr_step
                self.set_lr(self.lr)
            else:
                if self.warmup_end is False:
                    self.warmup_end = True
        return self.get_lr()
