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


def refuse_unported_parallelism(args, model: str) -> None:
    """Raise for ``--pipeline-parallel-size`` / ``--seq-parallel-size`` > 1
    and a ``--remat-policy`` other than 'none': the JAX package's
    pipelined, sequence-parallel and rematerialised stacks of ``model`` are
    not ported."""
    if getattr(args, "pipeline_parallel_size", 1) > 1 or \
            getattr(args, "seq_parallel_size", 1) > 1:
        raise NotImplementedError(
            f"pipeline and sequence parallelism of {model} are not ported yet")
    if getattr(args, "remat_policy", None) not in (None, "none"):
        raise NotImplementedError(
            f"activation rematerialisation (--remat-policy) of {model} is not "
            "ported yet")
