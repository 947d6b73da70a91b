"""Task registry and auto-discovery (counterpart of
``unicore_tpu/tasks/__init__.py``): ``@register_task("name")`` +
``setup_task(args)`` dispatch; bundled task modules self-register on
import."""

import importlib
import pkgutil

from .unicore_task import UnicoreTask

TASK_REGISTRY = {}
TASK_CLASS_NAMES = set()


def register_task(name):
    """Decorator registering a :class:`UnicoreTask` subclass under ``name``."""

    def deco(cls):
        if not issubclass(cls, UnicoreTask):
            raise ValueError(
                f"Task ({name}: {cls.__name__}) must extend UnicoreTask"
            )
        if name in TASK_REGISTRY:
            raise ValueError(f"Cannot register duplicate task ({name})")
        if cls.__name__ in TASK_CLASS_NAMES:
            raise ValueError(
                f"Cannot register task with duplicate class name "
                f"({cls.__name__})"
            )
        TASK_REGISTRY[name] = cls
        TASK_CLASS_NAMES.add(cls.__name__)
        return cls

    return deco


def setup_task(args, **kwargs):
    """Build the task ``args.task`` names via its ``setup_task`` hook."""
    return TASK_REGISTRY[args.task].setup_task(args, **kwargs)


def get_task(name):
    return TASK_REGISTRY[name]


# import every bundled task module so its decorator runs
for _mod in pkgutil.iter_modules(__path__):
    if not _mod.name.startswith("_") and _mod.name != "unicore_task":
        importlib.import_module(f"{__name__}.{_mod.name}")
