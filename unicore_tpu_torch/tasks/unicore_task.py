"""Task base class (counterpart of ``unicore_tpu/tasks/unicore_task.py``):
construction, dataset access, the epoch batch iterator and model/loss
construction.  The JAX package's checkpointable task state, length
buckets and loader threads are not ported."""

import logging
from argparse import Namespace

from unicore_tpu_torch.data import UnicoreDataset, data_utils, iterators

logger = logging.getLogger(__name__)


class UnicoreTask(object):
    @classmethod
    def add_args(cls, parser):
        pass

    def __init__(self, args: Namespace, **kwargs):
        self.args = args
        self.datasets = dict()
        self.dataset_to_epoch_iter = dict()

    @classmethod
    def setup_task(cls, args: Namespace, **kwargs):
        return cls(args, **kwargs)

    def load_dataset(self, split: str, **kwargs):
        """Load a dataset split; must populate ``self.datasets[split]``."""
        raise NotImplementedError

    def dataset(self, split):
        try:
            ds = self.datasets[split]
        except KeyError:
            raise KeyError("Dataset not loaded: " + split) from None
        if not isinstance(ds, UnicoreDataset):
            raise TypeError("Datasets are expected to be of type UnicoreDataset")
        return ds

    def get_batch_iterator(self, dataset, batch_size=None,
                           required_batch_size_multiple=1, seed=1,
                           num_shards=1, shard_id=0, epoch=1):
        """The epoch batch iterator over ``dataset``, planned as the JAX
        package plans it: the dataset sees its epoch first, its index
        order is drawn under the run seed, then chunked into batches.
        Epoch-invariant datasets reuse their iterator across epochs;
        epoch-aware ones (per-epoch shuffles) rebuild it."""
        assert isinstance(dataset, UnicoreDataset)
        cacheable = getattr(dataset, "can_reuse_epoch_itr_across_epochs", False)
        cached = self.dataset_to_epoch_iter.get(dataset) if cacheable else None
        if cached is not None:
            return cached
        dataset.set_epoch(epoch)
        with data_utils.numpy_seed(seed):
            order = dataset.ordered_indices()
        epoch_iter = iterators.EpochBatchIterator(
            dataset=dataset,
            collate_fn=dataset.collater,
            batch_sampler=dataset.batch_by_size(
                order, batch_size=batch_size,
                required_batch_size_multiple=required_batch_size_multiple,
            ),
            seed=seed,
            num_shards=num_shards,
            shard_id=shard_id,
            epoch=epoch,
        )
        if cacheable:
            self.dataset_to_epoch_iter[dataset] = epoch_iter
        return epoch_iter

    def build_model(self, args: Namespace, **kwargs):
        from unicore_tpu_torch import models

        return models.build_model(args, self, **kwargs)

    def build_loss(self, args: Namespace):
        from unicore_tpu_torch import losses

        return losses.build_loss(args, self)

    def begin_epoch(self, epoch, model):
        """Hook at the beginning of each epoch."""
        pass

    def reduce_metrics(self, logging_outputs, loss, split="train"):
        """Aggregate the micro-batches' logging outputs into metrics."""
        from unicore_tpu_torch.logging import metrics

        bsz = [log["bsz"] for log in logging_outputs if "bsz" in log]
        if bsz:
            metrics.log_scalar("bsz", sum(bsz), priority=190, round=1)
        loss.__class__.reduce_metrics(logging_outputs, split)
