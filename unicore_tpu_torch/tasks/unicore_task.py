"""Task base class (counterpart of ``unicore_tpu/tasks/unicore_task.py``):
construction, dataset access, the ``--length-bucket`` edges, the epoch
batch iterator (with its loader threads, buffer and stall watchdog) and
model/loss construction.  The JAX package's checkpointable task state is
not ported."""

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

    def length_bucket_edges(self):
        """The run's ``--length-bucket`` edges: at most that many lengths
        evenly spaced over ``--max-seq-len``, each rounded up to
        ``--seq-pad-multiple``; None when bucketing is off.  (The JAX
        package spaces them by quantiles when a dataset reports its
        per-sample sizes; none of the port's datasets does, nor do the
        lazily tokenized ones of the JAX tasks that bucket.)"""
        return data_utils.compute_length_buckets(
            getattr(self.args, "length_bucket", 0), self.args.max_seq_len,
            multiple=getattr(self.args, "seq_pad_multiple", 1))

    def get_batch_iterator(self, dataset, batch_size=None,
                           required_batch_size_multiple=1, seed=1,
                           num_shards=1, shard_id=0, num_workers=0, epoch=1,
                           data_buffer_size=0, data_stall_timeout=0.0):
        """The epoch batch iterator over ``dataset``, planned as the JAX
        package plans it: the dataset sees its epoch first, its index
        order is drawn under the run seed, then chunked into batches.
        Epoch-invariant datasets reuse their iterator across epochs;
        epoch-aware ones (per-epoch shuffles) rebuild it.  ``num_workers``
        loader threads, a ``data_buffer_size`` read-ahead and its
        ``data_stall_timeout`` as ``EpochBatchIterator`` takes them."""
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
            num_workers=num_workers,
            buffer_size=data_buffer_size,
            stall_timeout=data_stall_timeout,
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

    def token_array(self, sample):
        """The micro-batch's token ids, whose last dim is its padded length
        (the trainer counts non-pad tokens, samples and lengths from it)."""
        return sample["net_input"]["src_tokens"]

    def reduce_metrics(self, logging_outputs, loss, split="train"):
        """Aggregate the micro-batches' logging outputs into metrics."""
        from unicore_tpu_torch.logging import metrics

        bsz = [log["bsz"] for log in logging_outputs if "bsz" in log]
        if bsz:
            metrics.log_scalar("bsz", sum(bsz), priority=190, round=1)
        loss.__class__.reduce_metrics(logging_outputs, split)
