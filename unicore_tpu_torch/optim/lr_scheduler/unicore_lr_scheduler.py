"""LR scheduler protocol (counterpart of
``unicore_tpu/optim/lr_scheduler/unicore_lr_scheduler.py``): the scheduler
owns the current lr; ``step_begin_epoch`` / ``step`` (end of epoch, sees
the validation loss) / ``step_update`` (after each update, returns the next
lr) hooks, and ``state_dict`` / ``load_state_dict`` for resume.  The
schedules are pure Python on host floats, so the port's lrs equal the JAX
package's."""


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

    def load_state_dict(self, state_dict):
        self.best = state_dict.get("best", None)
        if "lr" in state_dict:
            self._lr = state_dict["lr"]

    def step_begin_epoch(self, epoch):
        """Hook: a new epoch is starting."""
        pass

    def step(self, epoch, val_loss=None):
        """Hook: an epoch finished; tracks the best validation loss."""
        if val_loss is not None:
            self.best = val_loss if self.best is None else min(self.best, val_loss)

    def step_update(self, num_updates):
        """Hook: an optimizer update finished; returns the lr to use."""
        return self.get_lr()


def linear_warmup(num_updates, warmup_updates, init_lr, end_lr):
    """lr on the warmup ramp: init_lr at update 0 rising linearly to end_lr
    at update ``warmup_updates``."""
    if warmup_updates <= 0:
        return end_lr
    frac = min(num_updates, warmup_updates) / float(warmup_updates)
    return init_lr + (end_lr - init_lr) * frac


def single_lr(args, name):
    """The schedule's base lr; rejects the fixed-schedule multi-lr list."""
    lr = args.lr
    if not isinstance(lr, (list, tuple)):
        return lr
    if len(lr) > 1:
        raise ValueError(
            f"Cannot use a fixed learning rate schedule with {name}."
            f" Consider --lr-scheduler=fixed instead. ({lr})"
        )
    return lr[0]
