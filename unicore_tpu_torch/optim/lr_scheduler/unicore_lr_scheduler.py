"""LR scheduler protocol (counterpart of
``unicore_tpu/optim/lr_scheduler/unicore_lr_scheduler.py``): the scheduler
owns the current lr; ``step_begin_epoch`` / ``step`` (end of epoch) /
``step_update`` (after each update, returns the next lr) hooks."""


class UnicoreLRScheduler(object):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__()
        self.args = args
        self.optimizer = optimizer
        self.total_train_steps = total_train_steps
        self.best = None
        lr_arg = getattr(args, "lr", 0.0)
        self._lr = lr_arg[0] if isinstance(lr_arg, list) else lr_arg

    @classmethod
    def add_args(cls, parser):
        pass

    def set_lr(self, lr):
        self._lr = lr

    def get_lr(self):
        return self._lr

    def state_dict(self):
        return {"best": self.best, "lr": self._lr}

    def step_begin_epoch(self, epoch):
        """Hook: a new epoch is starting."""
        pass

    def step(self, epoch, val_loss=None):
        """Hook: an epoch finished."""
        if val_loss is not None:
            self.best = val_loss if self.best is None else min(self.best, val_loss)

    def step_update(self, num_updates):
        """Hook: an optimizer update finished; returns the lr to use."""
        return self.get_lr()
