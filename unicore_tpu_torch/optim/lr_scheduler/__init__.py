"""LR scheduler registry (counterpart of
``unicore_tpu/optim/lr_scheduler/__init__.py``): the nine schedules of the
JAX package, ``fixed`` the default; each module registers itself on
import."""

import importlib
import pkgutil

from unicore_tpu_torch import registry
from .unicore_lr_scheduler import (  # noqa
    UnicoreLRScheduler,
    linear_warmup,
    single_lr,
)

(
    build_lr_scheduler_,
    register_lr_scheduler,
    LR_SCHEDULER_REGISTRY,
) = registry.setup_registry(
    "--lr-scheduler", base_class=UnicoreLRScheduler, default="fixed"
)


def build_lr_scheduler(args, optimizer, total_train_steps):
    return build_lr_scheduler_(args, optimizer, total_train_steps)


for _mod in pkgutil.iter_modules(__path__):
    if not _mod.name.startswith("_") and _mod.name != "unicore_lr_scheduler":
        importlib.import_module(f"{__name__}.{_mod.name}")
