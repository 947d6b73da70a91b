"""A ``bert_tiny`` run through the JAX ``Trainer`` and the port's from the
same weights and batches (the setup of ``test_torch_train.py``), shared by
the trainer-level tests of the optimizer plane."""

import math

import jax
import numpy as np

from unicore_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
from unicore_tpu.models.bert import BertModel as JaxBert
from unicore_tpu.tasks.unicore_task import UnicoreTask as JaxTask
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.losses import LOSS_REGISTRY as PORT_LOSSES
from unicore_tpu_torch.models.bert import BertModel as PortBert
from unicore_tpu_torch.tasks.bert import BertTask as PortBertTask
from unicore_tpu_torch.trainer import Trainer as PortTrainer

from test_torch_train import TINY, train_args
from test_torch_train_data import write_corpus


def setup(tmp_path, n_batches, n_docs=48, **overrides):
    """(args, port task, the first ``n_batches`` batches, JAX trainer with
    its state initialised, the JAX weights)."""
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=n_docs)
    args = train_args(data)
    for k, v in overrides.items():
        setattr(args, k, v)
    task = PortBertTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=args.batch_size, seed=1)
    samples = list(itr.next_epoch_itr(shuffle=True))[:n_batches]
    assert len(samples) == n_batches

    class JaxBertTask(JaxTask):
        dictionary = task.dictionary

    jax_model = JaxBert(vocab_size=len(task.dictionary), padding_idx=task.dictionary.pad(),
                        **TINY)
    jax_tr = JaxTrainer(args, JaxBertTask(args), jax_model,
                        JAX_LOSSES["masked_lm"](JaxBertTask(args)))
    jax_tr.init_state(samples[0])
    return args, task, samples, jax_tr, jax.device_get(jax_tr._state["params"])


def port_trainer(args, task, variables, device="cpu"):
    model = PortBert(vocab_size=len(task.dictionary), padding_idx=task.dictionary.pad(),
                     **TINY)
    model.load_state_dict(checkpoint_utils.from_jax_params(variables))
    return PortTrainer(args, task, model, PORT_LOSSES["masked_lm"](task), device)


def run_both(jax_tr, port_tr, groups):
    """Each group through both trainers; the per-update losses (bits)."""
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    prev = {"loss": 0.0, "sample_size": 0.0}
    jax_losses = []
    for group in groups:
        jax_tr.train_step(group)
        port_tr.train_step(group)
        macc = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
        jax_losses.append((macc["loss"] - prev["loss"])
                          / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
        prev = macc
    return jax_losses, list(port_tr.update_losses)


def max_param_diff(model, jax_tr):
    ref = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    return max(float((p.detach() - ref[n]).abs().max()) for n, p in model.named_parameters())


def assert_close_losses(got, want, rel):
    for g, w in zip(got, want):
        assert abs(g - w) <= rel * abs(w), (got, want)
    assert np.all(np.isfinite(got))
