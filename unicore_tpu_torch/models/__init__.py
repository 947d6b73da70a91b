"""Model registry (counterpart of ``unicore_tpu/models/__init__.py``)."""

import importlib
import os

from .unicore_model import BaseUnicoreModel

MODEL_REGISTRY = {}
ARCH_MODEL_REGISTRY = {}
ARCH_MODEL_INV_REGISTRY = {}
ARCH_CONFIG_REGISTRY = {}

__all__ = [
    "BaseUnicoreModel",
    "MODEL_REGISTRY",
    "ARCH_MODEL_REGISTRY",
    "ARCH_CONFIG_REGISTRY",
    "register_model",
    "register_model_architecture",
    "build_model",
]


def build_model(args, task, **kwargs):
    if getattr(args, "arch", None) in ARCH_MODEL_REGISTRY:
        model_cls = ARCH_MODEL_REGISTRY[args.arch]
    elif getattr(args, "arch", None) in MODEL_REGISTRY:
        model_cls = MODEL_REGISTRY[args.arch]
    else:
        raise ValueError(f"Could not infer model type from {args.arch}")
    return model_cls.build_model(args, task, **kwargs)


def register_model(name):
    """Decorator registering a :class:`BaseUnicoreModel` subclass by name."""

    def register_model_cls(cls):
        if name in MODEL_REGISTRY:
            raise ValueError(f"Cannot register duplicate model ({name})")
        if not issubclass(cls, BaseUnicoreModel):
            raise ValueError(
                f"Model ({name}: {cls.__name__}) must extend BaseUnicoreModel"
            )
        MODEL_REGISTRY[name] = cls
        return cls

    return register_model_cls


def register_model_architecture(model_name, arch_name):
    """Decorator registering an architecture config function for a model.

    The function mutates ``args`` in place, setting any unset
    hyperparameters to the architecture's defaults."""

    def register_model_arch_fn(fn):
        if model_name not in MODEL_REGISTRY:
            raise ValueError(
                f"Cannot register model architecture for unknown model type ({model_name})"
            )
        if arch_name in ARCH_MODEL_REGISTRY:
            raise ValueError(f"Cannot register duplicate model architecture ({arch_name})")
        if not callable(fn):
            raise ValueError(f"Model architecture must be callable ({arch_name})")
        ARCH_MODEL_REGISTRY[arch_name] = MODEL_REGISTRY[model_name]
        ARCH_MODEL_INV_REGISTRY.setdefault(model_name, []).append(arch_name)
        ARCH_CONFIG_REGISTRY[arch_name] = fn
        return fn

    return register_model_arch_fn


# Auto-import any models defined alongside this package.
models_dir = os.path.dirname(__file__)
for file in sorted(os.listdir(models_dir)):
    if (
        file.endswith(".py")
        and not file.startswith(("_", "."))
        and file != "unicore_model.py"
    ):
        importlib.import_module(f"{__name__}.{file[:-3]}")
