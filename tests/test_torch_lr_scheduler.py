"""The port's nine lr schedulers against the JAX package's on the CPU.

Each schedule is driven as the trainers drive it: ``step_begin_epoch`` and
``step_update`` at every epoch start, ``step_update`` after every update,
``step`` with a validation loss at every epoch end (a fixed sequence, so
``reduce_lr_on_plateau`` shrinks), over 3 epochs of 6 updates.  The lrs
are pure Python on both sides, so they must be EQUAL, not close.  A second
port scheduler is restored from the first one's ``state_dict`` mid-epoch
(then, as a resumed run does, ``step_update`` and ``step_begin_epoch``)
and must go on giving the same lrs.
"""

import argparse

import pytest

from unicore_tpu.optim import lr_scheduler as jax_sched

from unicore_tpu_torch.optim import lr_scheduler as port_sched

UPDATES_PER_EPOCH, EPOCHS = 6, 3
VAL_LOSSES = [3.0, 3.5, 2.0]
MAX_UPDATE = UPDATES_PER_EPOCH * EPOCHS

CONFIGS = {
    "fixed": ["--lr", "0.1,0.05", "--warmup-updates", "3", "--force-anneal", "3"],
    "polynomial_decay": ["--lr", "1e-3", "--warmup-updates", "3",
                         "--total-num-update", "14", "--end-learning-rate", "1e-5",
                         "--power", "2"],
    "cosine": ["--lr", "1e-3", "--warmup-updates", "2", "--min-lr", "1e-5",
               "--lr-period-updates", "4", "--t-mult", "2", "--lr-shrink", "0.5"],
    "exponential_decay": ["--lr", "1e-3", "--warmup-updates", "2", "--decay-steps", "3",
                          "--decay-ratio", "0.9"],
    "inverse_sqrt": ["--lr", "1e-3", "--warmup-updates", "4"],
    "pass_through": ["--lr", "1e-3"],
    "reduce_lr_on_plateau": ["--lr", "1e-3", "--warmup-updates", "2",
                             "--lr-patience", "0", "--lr-shrink", "0.5"],
    "tri_stage": ["--lr", "1e-3", "--warmup-steps", "3", "--hold-steps", "4",
                  "--decay-steps", "6", "--final-lr-scale", "0.05"],
    "triangular": ["--lr", "1e-3", "--max-lr", "1e-2", "--lr-period-updates", "6",
                   "--lr-shrink", "0.5", "--shrink-min"],
}


class _Optimizer:
    """Holds the inner schedule ``pass_through`` forwards to."""

    def __init__(self, inner=None):
        self.lr_scheduler = inner


def _build(mod, name):
    parser = argparse.ArgumentParser()
    parser.add_argument("--lr", type=lambda x: [float(v) for v in x.split(",")])
    mod.LR_SCHEDULER_REGISTRY[name].add_args(parser)
    args = parser.parse_args(CONFIGS[name])
    args.max_update = MAX_UPDATE
    optimizer = _Optimizer()
    if name == "pass_through":
        inner_args = argparse.Namespace(lr=[1e-3, 5e-4], warmup_updates=2,
                                        force_anneal=3, lr_shrink=0.5)
        optimizer.lr_scheduler = mod.LR_SCHEDULER_REGISTRY["fixed"](inner_args, None,
                                                                    MAX_UPDATE)
    return mod.LR_SCHEDULER_REGISTRY[name](args, optimizer, MAX_UPDATE)


def _drive(sched, start=0, resume=False):
    """lrs after every update from ``start`` on (``resume``: the scheduler
    was just restored at update ``start``)."""
    lrs = []
    n = start
    for epoch in range(1, EPOCHS + 1):
        first = (epoch - 1) * UPDATES_PER_EPOCH
        if n >= first + UPDATES_PER_EPOCH:
            continue
        if resume:  # set_num_updates, then the resumed epoch begins
            sched.step_update(n)
            resume = False
        sched.step_begin_epoch(epoch)
        lrs.append(("begin", epoch, sched.step_update(n)))
        while n < first + UPDATES_PER_EPOCH:
            n += 1
            lrs.append(("update", n, sched.step_update(n)))
        sched.step(epoch, VAL_LOSSES[epoch - 1])
        lrs.append(("end", epoch, sched.step_update(n)))
    return lrs


def test_every_jax_scheduler_is_ported():
    assert set(port_sched.LR_SCHEDULER_REGISTRY) == set(jax_sched.LR_SCHEDULER_REGISTRY)
    assert set(CONFIGS) == set(port_sched.LR_SCHEDULER_REGISTRY)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_scheduler_lrs_equal_jax_and_survive_state_dict(name):
    port, jax_ = _build(port_sched, name), _build(jax_sched, name)
    assert port.get_lr() == jax_.get_lr()
    got, want = _drive(port), _drive(jax_)
    assert got == want
    assert len({lr for _, _, lr in got}) > 2, got  # the schedule moves

    # restored mid-epoch 2 from a state_dict: the rest of the run alike
    split = UPDATES_PER_EPOCH + 2
    first = _build(port_sched, name)
    head = _drive_until(first, split)
    second = _build(port_sched, name)
    second.load_state_dict(first.state_dict())
    tail = _drive(second, start=split, resume=True)
    uninterrupted = [r for r in got if r[0] == "update" and r[1] > split]
    assert [r for r in tail if r[0] == "update"] == uninterrupted
    assert head == [r for r in got if r[0] != "update" or r[1] <= split][:len(head)]


def _drive_until(sched, stop):
    """:func:`_drive` cut after update ``stop`` (the run that checkpoints)."""
    lrs, n = [], 0
    for epoch in range(1, EPOCHS + 1):
        sched.step_begin_epoch(epoch)
        lrs.append(("begin", epoch, sched.step_update(n)))
        for _ in range(UPDATES_PER_EPOCH):
            n += 1
            lrs.append(("update", n, sched.step_update(n)))
            if n == stop:
                return lrs
        sched.step(epoch, VAL_LOSSES[epoch - 1])
        lrs.append(("end", epoch, sched.step_update(n)))
    return lrs
