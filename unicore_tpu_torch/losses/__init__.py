"""Loss registry (counterpart of ``unicore_tpu/losses/__init__.py``)."""

import importlib
import os

from unicore_tpu_torch.registry import setup_registry
from .unicore_loss import UnicoreLoss

build_loss_, register_loss, LOSS_REGISTRY = setup_registry(
    "--loss", base_class=UnicoreLoss, default="masked_lm"
)


def build_loss(args, task):
    return build_loss_(args, task)


__all__ = ["UnicoreLoss", "LOSS_REGISTRY", "register_loss", "build_loss"]

for file in sorted(os.listdir(os.path.dirname(__file__))):
    if file.endswith(".py") and not file.startswith("_") and file != "unicore_loss.py":
        importlib.import_module("unicore_tpu_torch.losses." + file[: -len(".py")])
