"""Delegating schedule for optimizers that bring their own scheduler: every
hook forwards to ``optimizer.lr_scheduler`` (counterpart of
``unicore_tpu/optim/lr_scheduler/pass_through.py``; pure Python, so the
port's lrs equal the JAX package's)."""

from . import UnicoreLRScheduler, register_lr_scheduler


@register_lr_scheduler("pass_through")
class PassThroughScheduleSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if getattr(optimizer, "lr_scheduler", None) is None:
            raise AssertionError(
                "Pass-through schedule can only be used with optimizers "
                "with their own schedulers"
            )
        self._inner = optimizer.lr_scheduler

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state_dict):
        self._inner.load_state_dict(state_dict)

    def step_begin_epoch(self, epoch):
        return self._inner.step_begin_epoch(epoch)

    def step_update(self, num_updates):
        return self._inner.step_update(num_updates)
