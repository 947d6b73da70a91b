"""Base model class (counterpart of ``unicore_tpu/models/unicore_model.py``).

A model is a ``torch.nn.Module`` holding its own parameters;
``build_model(args, task)`` constructs it from the CLI namespace.
"""

from torch import nn


class BaseUnicoreModel(nn.Module):
    """Base class for all models.  The registry contract mirrors the JAX
    package: ``add_args`` injects CLI flags, ``build_model(args, task)``
    constructs the module instance."""

    @classmethod
    def add_args(cls, parser):
        """Add model-specific arguments to the parser."""
        pass

    @classmethod
    def build_model(cls, args, task):
        """Build a new model instance."""
        raise NotImplementedError("Model must implement the build_model method")
