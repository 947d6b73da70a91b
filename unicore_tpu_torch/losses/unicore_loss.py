"""Base loss class (counterpart of ``unicore_tpu/losses/unicore_loss.py``).

A loss maps ``(model, sample, rng)`` to ``(loss, sample_size,
logging_output)``: the scalar loss is differentiated by the trainer and its
gradient divided by the summed ``sample_size`` of the update's
micro-batches; ``logging_output`` is a flat dict of scalars."""

import inspect


class UnicoreLoss:
    def __init__(self, task):
        self.task = task
        self.args = task.args if task is not None else None

    @classmethod
    def add_args(cls, parser):
        pass

    @classmethod
    def build_loss(cls, args, task):
        """Construct a loss, matching ``__init__`` parameters against args
        by name: ``task`` is injected, other parameters take the like-named
        args attribute, else their declared default."""
        kwargs = {}
        for p in inspect.signature(cls).parameters.values():
            if p.kind in (p.POSITIONAL_ONLY, p.VAR_POSITIONAL, p.VAR_KEYWORD):
                raise NotImplementedError("losses must take explicit keyword arguments")
            if p.name == "task":
                kwargs["task"] = task
            elif hasattr(args, p.name):
                kwargs[p.name] = getattr(args, p.name)
            elif p.default is p.empty:
                raise NotImplementedError(f"Unable to infer loss argument: {p.name}")
        return cls(**kwargs)

    def forward(self, model, sample, rng=None):
        """Returns ``(loss, sample_size, logging_output)``."""
        raise NotImplementedError

    def __call__(self, model, sample, rng=None):
        return self.forward(model, sample, rng=rng)

    @staticmethod
    def reduce_metrics(logging_outputs, split="train") -> None:
        """Aggregate the micro-batches' logging outputs into metrics."""
        raise NotImplementedError
