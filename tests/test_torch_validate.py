"""Validation, the EMA and the checkpoint bookkeeping of the port against
the JAX package's on the CPU (``transformer_lm_tiny``, dropouts 0, the same
weights through ``from_jax_params``).

1. The validation loss of the CLI's ``validate`` against the JAX
   ``valid_step`` summed over the same batches, at the init weights and
   after two updates: 1e-6 relative.
2. The EMA after 3 updates against the JAX trainer's (``update_ema``):
   1e-6 absolute; a skipped update (non-finite gradient norm) leaves the
   EMA and the weights as they were, bit for bit.
3. The save names against JAX ``_checkpoint_names`` over its condition
   matrix; retention against JAX ``ckp_copy_fun`` on a directory of
   checkpoints; ``EarlyStopMonitor`` against the JAX CLI's.
"""

import itertools
import math
from argparse import Namespace

import jax
import pytest
import torch

from unicore_tpu import checkpoint_utils as jax_ckpt
from unicore_tpu_cli.train import EarlyStopMonitor as JaxEarlyStop

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.cli import train

from test_torch_lm_train import lm_args, lm_samples, lm_trainers, write_lm_corpus

VALID_ARGS = dict(valid_subset="valid", max_valid_steps=None, best_checkpoint_metric="loss",
                  maximize_best_checkpoint_metric=False)


def _jax_valid_loss(jax_tr, samples):
    totals = {}
    for s in samples:
        out = jax_tr.valid_step(s)
        for k, v in out.items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return totals["loss"] / totals["sample_size"] / math.log(2)


def test_valid_loss_matches_jax_valid_step(tmp_path):
    data = str(tmp_path / "corpus")
    write_lm_corpus(data, n_valid=10)
    args = lm_args(data, **VALID_ARGS)
    samples = lm_samples(args, 4)
    jax_tr, port_tr, task = lm_trainers(args, samples)
    task.load_dataset("valid")
    valid = list(port_tr.get_valid_iterator("valid").next_epoch_itr(shuffle=False))
    assert len(valid) == 3  # 10 documents in batches of 4, in order
    for step in range(3):
        if step:
            jax_tr.train_step(samples[2 * step - 2:2 * step])
            port_tr.train_step(samples[2 * step - 2:2 * step])
        records = []
        got = train.validate(args, port_tr, task, ["valid"], records)
        want = _jax_valid_loss(jax_tr, valid)
        assert abs(records[-1]["loss"] - want) <= 1e-6 * want, (step, records, want)
        assert got == [round(records[-1]["loss"], 3)]
        assert port_tr.model.training is False


def test_ema_matches_jax_and_keeps_on_a_skipped_update(tmp_path, monkeypatch):
    data = str(tmp_path / "corpus")
    write_lm_corpus(data)
    args = lm_args(data, ema_decay=0.9)
    samples = lm_samples(args, 6)
    jax_tr, port_tr, _ = lm_trainers(args, samples)
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    for step in range(3):
        jax_tr.train_step(samples[2 * step:2 * step + 2])
        port_tr.train_step(samples[2 * step:2 * step + 2])
    ref = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["ema"]))
    assert port_tr.ema.shadow.keys() == dict(port_tr.model.named_parameters()).keys()
    for name, e in port_tr.ema.shadow.items():
        assert (e - ref[name]).abs().max().item() <= 1e-6, name
        assert not torch.equal(e, port_tr.params[name].detach()), name

    ema = {n: e.clone() for n, e in port_tr.ema.shadow.items()}
    params = {n: p.detach().clone() for n, p in port_tr.params.items()}
    monkeypatch.setattr("unicore_tpu_torch.trainer.clip_grad_norm",
                        lambda grads, max_norm: torch.tensor(float("nan")))
    gnorm = port_tr.train_step(samples[:2])
    assert math.isnan(gnorm) and port_tr.get_num_updates() == 4
    for n in ema:
        assert torch.equal(port_tr.ema.shadow[n], ema[n]), n
        assert torch.equal(port_tr.params[n].detach(), params[n]), n


# ---------------------------------------------------------------------------
# checkpoint bookkeeping
# ---------------------------------------------------------------------------

def _ckpt_args(**kw):
    args = dict(no_epoch_checkpoints=False, save_interval=1, save_interval_updates=0,
                keep_best_checkpoints=-1, best_checkpoint_metric="loss",
                no_last_checkpoints=False, keep_interval_updates=-1, keep_last_epochs=-1,
                maximize_best_checkpoint_metric=False)
    args.update(kw)
    return Namespace(**args)


NAME_CONFIGS = [
    {},
    {"save_interval": 2},
    {"save_interval_updates": 5},
    {"save_interval_updates": 5, "no_epoch_checkpoints": True},
    {"keep_best_checkpoints": 2},
    {"keep_best_checkpoints": 2, "best_checkpoint_metric": "acc"},
    {"no_last_checkpoints": True, "save_interval_updates": 3},
    {"no_last_checkpoints": True, "no_epoch_checkpoints": True},
]


@pytest.mark.parametrize("config", NAME_CONFIGS, ids=lambda c: ",".join(c) or "defaults")
@pytest.mark.parametrize("suffix", ["", "-shard0"])
def test_checkpoint_names_match_jax(config, suffix):
    args = _ckpt_args(**config)
    for epoch, updates, end_of_epoch, val_loss, best in itertools.product(
            (1, 2, 3), (5, 6, 15), (False, True), (None, 2.345, -1.5), (False, True)):
        call = (args, suffix, epoch, updates, end_of_epoch, val_loss if best else None, best)
        if best and val_loss is None:
            continue
        assert (checkpoint_utils._checkpoint_names(*call)
                == jax_ckpt._checkpoint_names(*call)), call


RETENTION_CONFIGS = [
    dict(keep_interval_updates=2),
    dict(keep_interval_updates=2, end_of_epoch=True),
    dict(keep_last_epochs=1, keep_best_checkpoints=2),
    dict(keep_best_checkpoints=1, maximize_best_checkpoint_metric=True, keep_last_epochs=0),
]


@pytest.mark.parametrize("config", RETENTION_CONFIGS, ids=str)
def test_retention_matches_jax(tmp_path, config):
    config = dict(config)
    end_of_epoch = config.pop("end_of_epoch", False)
    names = ["checkpoint_1_2.pt", "checkpoint_1_4.pt", "checkpoint_2_6.pt",
             "checkpoint_2_8.pt", "checkpoint1.pt", "checkpoint2.pt", "checkpoint3.pt",
             "checkpoint.best_loss_3.12_4.pt", "checkpoint.best_loss_-0.50_6.pt",
             "checkpoint.best_loss_2.71_8.pt", "checkpoint_best.pt", "checkpoint_last.pt",
             "other.txt"]
    dirs = {}
    for side in ("port", "jax"):
        d = tmp_path / side
        d.mkdir()
        for n in names:
            (d / n).write_bytes(b"x")
        dirs[side] = d
    for side, fun in (("port", checkpoint_utils.ckp_copy_fun), ("jax", jax_ckpt.ckp_copy_fun)):
        d = str(dirs[side])
        args = _ckpt_args(save_dir=d, tmp_save_dir=d, **config)
        assert (checkpoint_utils._retention_rules(args, end_of_epoch)
                == jax_ckpt._retention_rules(args, end_of_epoch))
        src = str(dirs[side] / "checkpoint_last.pt")
        fun(src, [src], end_of_epoch, args)
    port = sorted(p.name for p in dirs["port"].iterdir())
    assert port == sorted(p.name for p in dirs["jax"].iterdir())
    # interval pruning waits at an epoch boundary
    assert (len(port) == len(names)) == (end_of_epoch and "keep_last_epochs" not in config)


@pytest.mark.parametrize("patience,maximize", [(0, False), (2, False), (3, True)])
def test_early_stop_monitor_matches_jax(patience, maximize):
    values = [5.0, 4.0, None, 4.5, 4.0, 3.9, 4.2, 4.3, 4.4, 3.0, 3.1, 3.2, 3.3, 3.4]
    port = train.EarlyStopMonitor(patience, maximize)
    ref = JaxEarlyStop(patience, maximize)
    got = [port.should_stop(v) for v in values]
    assert got == [ref.should_stop(v) for v in values]
    assert (patience <= 0) != any(got)
    assert (port.best, port.strikes) == (ref.best, ref.strikes)
