"""Optimizer registry (counterpart of ``unicore_tpu/optim/__init__.py``)."""

import importlib
import os

from unicore_tpu_torch.registry import setup_registry
from .unicore_optimizer import UnicoreOptimizer  # noqa

build_optimizer_, register_optimizer, OPTIMIZER_REGISTRY = setup_registry(
    "--optimizer", base_class=UnicoreOptimizer, default="adam"
)


def build_optimizer(args, *extra_args, **extra_kwargs):
    return build_optimizer_(args, *extra_args, **extra_kwargs)


__all__ = ["UnicoreOptimizer", "OPTIMIZER_REGISTRY", "build_optimizer",
           "register_optimizer"]

for file in sorted(os.listdir(os.path.dirname(__file__))):
    if file.endswith(".py") and not file.startswith("_") and file != "unicore_optimizer.py":
        importlib.import_module("unicore_tpu_torch.optim." + file[: -len(".py")])
