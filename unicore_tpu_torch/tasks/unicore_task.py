"""Task base class (counterpart of ``unicore_tpu/tasks/unicore_task.py``;
this slice ports what serving needs: construction and ``build_model``.
Datasets and batch iterators come with the training slice)."""

from argparse import Namespace


class UnicoreTask(object):
    @classmethod
    def add_args(cls, parser):
        pass

    def __init__(self, args: Namespace, **kwargs):
        self.args = args

    @classmethod
    def setup_task(cls, args: Namespace, **kwargs):
        return cls(args, **kwargs)

    def build_model(self, args: Namespace, **kwargs):
        from unicore_tpu_torch import models

        return models.build_model(args, self, **kwargs)
