"""Resume, fine-tune and the restore decision of the port's train CLI on the
CPU (``transformer_lm_tiny`` on ``causal_lm``, its dropouts on, an EMA
validated every 2 updates).

1. A 6-update run equals a 3-update run resumed for 3 more, and an
   8-update run a 4 + 4 one (the resume at the epoch boundary), BIT FOR BIT:
   per-update losses and lrs, and in the last checkpoint the weights, the
   Adam moments and step count, the EMA, the lr scheduler and the iterator
   position.
2. ``--finetune-from-model`` loads the weights and resets every other
   group (optimizer, lr scheduler, meters, dataloader, update count).
3. Each ``ValueError`` of the JAX ``_resolve_restore`` is raised alike.
4. ``--reset-dataloader`` restarts the epoch and keeps the update count.
5. A checkpoint in the earlier port layout (``optimizer``,
   ``lr_scheduler``, ``num_updates``, ``epoch_itr``) still serves, and
   resumes with a warning that names what it lacks.
"""

import logging
import os
from argparse import Namespace

import pytest
import torch

from unicore_tpu import checkpoint_utils as jax_ckpt

from unicore_tpu_torch import checkpoint_utils, options, tasks
from unicore_tpu_torch.cli import serve, train
from unicore_tpu_torch.trainer import Trainer

from test_torch_lm_train import write_lm_corpus

PER_EPOCH = 4  # 16 documents in batches of 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "corpus")
    write_lm_corpus(path, n_train=4 * PER_EPOCH, n_valid=4)
    return path


def _argv(data, save_dir, *extra):
    return [data, "--task", "causal_lm", "--loss", "lm_cross_entropy",
            "--arch", "transformer_lm_tiny", "--device", "cpu", "--optimizer", "adam",
            "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-6", "--clip-norm", "1.0",
            "--weight-decay", "0.01", "--lr-scheduler", "inverse_sqrt", "--lr", "1e-3",
            "--warmup-updates", "3", "--batch-size", "4", "--seq-pad-multiple", "8",
            "--ema-decay", "0.9", "--validate-with-ema",
            "--validate-interval-updates", "2", "--log-interval", "1",
            "--save-dir", str(save_dir), "--seed", "1", *extra]


def _args(data, save_dir, *extra):
    return options.parse_args_and_arch(options.get_training_parser(),
                                       _argv(data, save_dir, *extra))


def _run(data, save_dir, *extra):
    return train.main(_args(data, save_dir, *extra), torch.device("cpu"))


def _trainer(args):
    task = tasks.setup_task(args)
    model = task.build_model(args, generator=torch.Generator().manual_seed(args.seed))
    task.load_dataset(args.train_subset)
    return Trainer(args, task, model, task.build_loss(args), "cpu")


def _last(save_dir):
    return checkpoint_utils.load_checkpoint_to_cpu(
        os.path.join(save_dir, "checkpoint_last.pt"))


def _assert_trees_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, where


@pytest.mark.parametrize("split,total", [(3, 6), (PER_EPOCH, 2 * PER_EPOCH)],
                         ids=["mid_epoch", "epoch_boundary"])
def test_resumed_run_equals_uninterrupted_bit_for_bit(data, tmp_path, split, total):
    full = _run(data, tmp_path / "full", "--max-update", str(total))
    head = _run(data, tmp_path / "resumed", "--max-update", str(split))
    saved = _last(tmp_path / "resumed")["extra_state"]["train_iterator"]
    assert saved["iterations_in_epoch"] == split % PER_EPOCH
    tail = _run(data, tmp_path / "resumed", "--max-update", str(total))
    assert tail["resumed_from_update"] == split and tail["updates"] == total
    assert head["loss_per_update"] + tail["loss_per_update"] == full["loss_per_update"]
    assert head["lr_per_update"] + tail["lr_per_update"] == full["lr_per_update"]
    a, b = _last(tmp_path / "full"), _last(tmp_path / "resumed")
    for key in ("model", "optimizer_state", "ema", "optimizer_history"):
        _assert_trees_equal(a[key], b[key], key)
    assert a["extra_state"]["train_iterator"] == b["extra_state"]["train_iterator"]
    assert a["extra_state"]["val_loss"] == b["extra_state"]["val_loss"]
    assert not torch.equal(a["ema"]["embed_tokens.weight"], a["model"]["embed_tokens.weight"])


def test_finetune_resets_every_group(data, tmp_path):
    _run(data, tmp_path / "pre", "--max-update", "3")
    pre = _last(tmp_path / "pre")
    args = _args(data, tmp_path / "ft", "--finetune-from-model",
                 str(tmp_path / "pre" / "checkpoint_last.pt"))
    fresh = _trainer(_args(data, tmp_path / "fresh"))
    tr = _trainer(args)
    extra = checkpoint_utils.load_checkpoint(args, tr)
    assert "train_iterator" not in extra
    for n, p in tr.model.state_dict().items():
        assert torch.equal(p, pre["model"][n]), n
    assert tr.get_num_updates() == 0 and tr.resumed_from_update is None
    assert tr._optimizer.num_steps == 0
    assert all(not v.any() for slots in tr._optimizer.state.values() for v in slots.values())
    assert tr.get_lr() == fresh.get_lr()
    epoch_itr = train.restore_session(args, tr)
    assert (epoch_itr.next_epoch_idx, epoch_itr.iterations_in_epoch) == (1, 0)
    # the second launch of the same fine-tune resumes its own checkpoint
    stats = _run(data, tmp_path / "ft", "--max-update", "2", "--finetune-from-model",
                 str(tmp_path / "pre" / "checkpoint_last.pt"))
    assert stats["resumed_from_update"] is None and stats["updates"] == 2
    stats = _run(data, tmp_path / "ft", "--max-update", "3", "--finetune-from-model",
                 str(tmp_path / "pre" / "checkpoint_last.pt"))
    assert stats["resumed_from_update"] == 2


@pytest.mark.parametrize("case", ["finetune_and_reset", "finetune_and_restore_file",
                                  "finetune_missing"])
def test_resolve_restore_raises_as_jax(tmp_path, case):
    save_dir = str(tmp_path / "ckpt")
    kw = dict(save_dir=save_dir, restore_file="checkpoint_last.pt",
              finetune_from_model=str(tmp_path / "pre.pt"), reset_optimizer=False,
              reset_lr_scheduler=False, reset_meters=False, reset_dataloader=False)
    (tmp_path / "pre.pt").write_bytes(b"")
    if case == "finetune_and_reset":
        kw["reset_meters"] = True
    elif case == "finetune_and_restore_file":
        kw["restore_file"] = str(tmp_path / "other.pt")
    else:
        kw["finetune_from_model"] = str(tmp_path / "missing.pt")
    with pytest.raises(ValueError) as want:
        jax_ckpt._resolve_restore(Namespace(**kw), "")
    with pytest.raises(ValueError) as got:
        checkpoint_utils._resolve_restore(Namespace(**kw), "")
    assert str(got.value) == str(want.value)


def test_reset_dataloader_restarts_the_epoch(data, tmp_path):
    _run(data, tmp_path / "ckpt", "--max-update", "3")
    for extra, want in (((), (1, 3)), (("--reset-dataloader",), (1, 0))):
        args = _args(data, tmp_path / "ckpt", *extra)
        tr = _trainer(args)
        epoch_itr = train.restore_session(args, tr)
        assert tr.get_num_updates() == 3
        assert (epoch_itr.next_epoch_idx, epoch_itr.iterations_in_epoch) == want


class _Items:
    """A dataset whose item i is i, batches collated to lists."""

    def __getitem__(self, i):
        return i

    def __len__(self):
        return 40


@pytest.mark.parametrize("num_batches", [10, 5, 20], ids=["same", "halved", "doubled"])
def test_iterator_resumes_mid_epoch_as_jax(num_batches):
    """``load_state_dict`` of a saved mid-epoch position (3 of 10 batches),
    into an iterator whose epoch has ``num_batches`` batches (the offset
    rescaled when that changed), then ``CountingIterator.skip``: the same
    batches in the same order as the JAX package's iterator."""
    from unicore_tpu.data.iterators import EpochBatchIterator as JaxItr

    from unicore_tpu_torch.data.iterators import EpochBatchIterator as PortItr

    size = 40 // num_batches
    batches = [list(range(i, i + size)) for i in range(0, 40, size)]
    saved = {"epoch": 2, "iterations_in_epoch": 3, "shuffle": True, "len": 10}
    got, want = [], []
    for cls, out in ((PortItr, got), (JaxItr, want)):
        itr = cls(_Items(), list, batches, seed=5, epoch=1)
        itr.load_state_dict(saved)
        assert itr.next_epoch_idx == 2
        epoch = itr.next_epoch_itr(shuffle=True)
        assert epoch.n == 3 * num_batches // 10
        out.append(list(next(epoch)))
        epoch.skip(2)
        out.extend(list(b) for b in epoch)
        assert itr.end_of_epoch() and itr.state_dict()["epoch"] == 3
    assert got == want and len(got) == num_batches - 3 * num_batches // 10 - 2


def test_earlier_layout_checkpoint_serves_and_resumes(data, tmp_path, caplog):
    _run(data, tmp_path / "new", "--max-update", "3")
    new = _last(tmp_path / "new")
    old_path = tmp_path / "old" / "checkpoint_last.pt"
    old_path.parent.mkdir()
    # the layout the trainer wrote before this one
    torch.save({"args": new["args"], "model": new["model"],
                "optimizer": new["optimizer_state"],
                "lr_scheduler": new["optimizer_history"][-1]["lr_scheduler_state"],
                "num_updates": 3,
                "epoch_itr": new["extra_state"]["train_iterator"]}, old_path)

    model, pad, _, vocab, _ = serve.load_serving_model(
        Namespace(path=str(old_path), data=None), torch.device("cpu"))
    for n, p in model.state_dict().items():
        assert torch.equal(p, new["model"][n]), n
    with torch.no_grad():
        logits = model(torch.tensor([[2, 7, 8, 9]]))
    assert logits.shape == (1, 4, vocab) and torch.isfinite(logits).all()

    args = _args(data, tmp_path / "old")
    tr = _trainer(args)
    with caplog.at_level(logging.WARNING, logger="unicore_tpu_torch.trainer"):
        epoch_itr = train.restore_session(args, tr)
    warned = " ".join(r.getMessage() for r in caplog.records)
    for lacking in ("extra_state.metrics", "extra_state.previous_training_time", "ema"):
        assert lacking in warned, warned
    assert tr.get_num_updates() == 3 and tr._optimizer.num_steps == 3
    assert (epoch_itr.next_epoch_idx, epoch_itr.iterations_in_epoch) == (1, 3)
