"""The port's training-health sentinel against the JAX package's on the CPU.

1. The three detectors on the same seeded numpy streams (noisy healthy,
   spike, NaN after warmup, the explosion factor, collapse with and without
   recovery): the same ``Anomaly`` fields at every step and the same
   streaming statistics, exactly (the arithmetic is the same Python).
2. ``SnapshotRing`` against the JAX ring on one sequence of adds, drops and
   lookups.
3. The sentinel's ladder against the JAX sentinel with stub trainers (host
   sums standing in for the metric accumulator): rewind, then cooldown,
   then abort; no snapshot means abort; overflow windows never fold; a
   flush between holds; the checkpointed history -- equal ``events`` lists,
   restores, skips, lr scales and abort messages.
4. ``parse_fault_spec`` and ``fault_multipliers`` against
   ``unicore_tpu.distributed.chaos``, including no second firing after a
   rewind; the kinds not ported raise ``NotImplementedError``.
5. ``bert_tiny`` through the JAX ``Trainer`` and the port's from the same
   weights and batches (``torch_trainer_pair.py``) with ``--sentinel-interval``
   1 and 3 and ``loss-spike@k``: the same rewind event, the post-rewind
   losses within ``test_torch_train.py``'s 1e-4, and on the port the
   restored state equal to the snapshot's update bit for bit, the
   ``--fused-adam`` parameters still views into their flat buffers.
"""

import math
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from unicore_tpu import health as jax_health
from unicore_tpu.data import iterators as jax_iterators
from unicore_tpu.distributed import chaos as jax_chaos
from unicore_tpu.distributed import guard as jax_guard
from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan

from unicore_tpu_torch import health as port_health
from unicore_tpu_torch.data import iterators as port_iterators
from unicore_tpu_torch.distributed import chaos as port_chaos

import torch_trainer_pair as pair


@pytest.fixture(autouse=True)
def _reset_chaos():
    # a JAX Trainer sets the JAX package's process-global parallel plan and
    # mesh: put back what was there, so later tests in this process see it
    # (a plan and a mesh left together shard test_decode's KV pools)
    plan, mesh = get_global_plan(), get_global_mesh()
    yield
    set_global_plan(plan)
    set_global_mesh(mesh)
    jax_chaos.reset()
    jax_guard.reset()
    port_chaos.reset()


# ---------------------------------------------------------------------------
# 1. detectors
# ---------------------------------------------------------------------------

def _noisy(n, seed, start=8.0, end=2.0, noise=0.15):
    rng = np.random.RandomState(seed)
    return np.linspace(start, end, n) * (1.0 + noise * rng.randn(n))


def _stream(kind):
    """(detector class name, kwargs, values) of one seeded stream."""
    if kind == "noisy_healthy":
        return "LossSpikeDetector", dict(zmax=6.0, window=64, warmup=20), _noisy(300, 0)
    if kind == "spike":
        v = _noisy(100, 1)
        v[80] *= 50.0
        v[90] *= 8.0
        return "LossSpikeDetector", dict(zmax=6.0, window=16, warmup=20), v
    if kind == "nan_after_warmup":
        v = _noisy(40, 2, noise=0.01)
        v[3] = np.nan  # in the warmup: no anomaly
        v[30] = np.nan
        v[31] = np.inf
        return "LossSpikeDetector", dict(zmax=6.0, window=16, warmup=5), v
    if kind == "plateau_floor":
        v = np.full(60, 4.0)
        v[50] = 4.0 * (1 + 1e-2)
        return "LossSpikeDetector", dict(zmax=6.0, window=16, warmup=5, min_obs=3), v
    if kind == "explosion_factor":
        rng = np.random.RandomState(3)
        v = 1.0 + 0.05 * rng.rand(60)
        v[40], v[41], v[50], v[51] = 5.0, 15.0, np.inf, 30.0
        return "GradNormExplosionDetector", dict(factor=10.0, window=32, warmup=5), v
    if kind == "collapse_recovered":
        v = [1024, 512, 256, 128, 256, 128, 64, 32, 64, 32, 16]
        return "LossScaleCollapseDetector", dict(halvings=4), np.array(v, float)
    if kind == "collapse":
        v = [1024, 512, 256, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1, 0.5]
        return "LossScaleCollapseDetector", dict(halvings=4, warmup=2), np.array(v, float)
    raise KeyError(kind)


STREAMS = ["noisy_healthy", "spike", "nan_after_warmup", "plateau_floor",
           "explosion_factor", "collapse_recovered", "collapse"]


@pytest.mark.parametrize("kind", STREAMS)
def test_detectors_match_jax(kind):
    name, kw, values = _stream(kind)
    port = getattr(port_health, name)(**kw)
    ref = getattr(jax_health, name)(**kw)
    hits = 0
    for step, v in enumerate(values, start=1):
        got, want = port.observe(step, float(v)), ref.observe(step, float(v))
        assert (got is None) == (want is None), (step, got, want)
        if got is not None:
            hits += 1
            # repr: every field, NaN equal to NaN
            assert repr(got) == repr(want), step
            assert got.describe() == want.describe()
    stats = getattr(ref, "_stats", None)
    if stats is not None:
        assert (port._stats.mean, port._stats.var, port._stats.n) == (
            stats.mean, stats.var, stats.n)
    else:
        assert (port._prev, port._drops, port._peak) == (ref._prev, ref._drops, ref._peak)
    assert hits == {"noisy_healthy": 0, "spike": 2, "nan_after_warmup": 2,
                    "plateau_floor": 1, "explosion_factor": 2, "collapse_recovered": 0,
                    "collapse": 2}[kind]


# ---------------------------------------------------------------------------
# 2. the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [1, 2, 3])
def test_snapshot_ring_matches_jax(keep):
    rings = {"port": port_health.SnapshotRing(keep), "jax": jax_health.SnapshotRing(keep)}
    snaps = {"port": port_health.HealthSnapshot, "jax": jax_health.HealthSnapshot}
    trace = {}
    for side, ring in rings.items():
        out = []
        for step in (2, 4, 6, 8, 10):
            ring.add(snaps[side](step=step, state={"w": np.full(3, float(step))}))
            out.append(ring.steps())
        for q in (1, 5, 7, 10, 11):
            hit = ring.newest_at_or_before(q)
            out.append(None if hit is None else hit.step)
        out.append(ring.drop_newer_than(7))
        out.append(ring.steps())
        ring.add(snaps[side](step=9, state={}))
        out.append((ring.steps(), len(ring)))
        trace[side] = out
    assert trace["port"] == trace["jax"]


# ---------------------------------------------------------------------------
# 3. the ladder
# ---------------------------------------------------------------------------

def _sentinel_args(**overrides):
    base = dict(sentinel_interval=1, snapshot_interval=2, snapshot_keep=2,
                sentinel_warmup=4, loss_spike_zmax=4.0, loss_spike_window=8,
                gnorm_explosion_factor=10.0, scale_collapse_halvings=4,
                spike_skip_updates=2, spike_cooldown_updates=6,
                spike_cooldown_factor=0.1, max_rewinds=2, fp16=False)
    base.update(overrides)
    return Namespace(**base)


class _StubTrainer:
    """Host running sums stand in for the metric accumulator (a new dict
    each update, as the port's trainer keeps them); snapshots and restores
    move the step."""

    def __init__(self, snapshot_cls, use_loss_scale=False):
        self.snapshot_cls = snapshot_cls
        self.use_loss_scale = use_loss_scale
        self.step = 0
        self._macc = None
        self._sums = {}
        self.restored_to = []

    def get_num_updates(self):
        return self.step

    def run_update(self, loss, gnorm=1.0, overflow=0.0, scale=None):
        self.step += 1
        upd = {"_n": 1.0, "loss": loss, "gnorm": gnorm, "sample_size": 1.0,
               "overflow": overflow}
        if scale is not None:
            upd["loss_scale"] = scale
        for k, v in upd.items():
            self._sums[k] = self._sums.get(k, 0.0) + v
        self._macc = {k: np.float32(v) for k, v in self._sums.items()}

    def flush(self):
        self._macc = None
        self._sums = {}

    def capture_health_snapshot(self, epoch_itr=None):
        return self.snapshot_cls(step=self.step, state={"w": np.float32(self.step)})

    def restore_health_snapshot(self, snap):
        self.restored_to.append(snap.step)
        self.step = snap.step
        self.flush()


class _FakeItr:
    def __init__(self):
        self.n = 0

    def skip(self, k):
        self.n += k


def _ladder(sent, tr, itr):
    lrs = []

    def drive(loss):
        tr.run_update(loss)
        sent.after_update(tr, None, itr)
        lrs.append(sent.lr_scale(tr.step))

    for _ in range(9):
        drive(1.0)
    drive(100.0)
    drive(1.0)
    drive(1.0)
    drive(1.0)
    drive(90.0)
    drive(1.0)
    drive(1.0)
    drive(95.0)
    drive(1.0)  # the third anomaly: --max-rewinds 2 spent, abort
    return lrs


def _no_snapshot(sent, tr, itr):
    for _ in range(8):
        tr.run_update(1.0)
        sent.after_update(tr, None, None)
    tr.run_update(100.0)
    sent.after_update(tr, None, None)
    tr.run_update(1.0)
    sent.after_update(tr, None, None)


def _overflows(sent, tr, itr):
    for i in range(30):
        if i % 5 == 4:
            tr.run_update(float("inf"), gnorm=float("inf"), overflow=1.0)
        else:
            tr.run_update(1.0)
        sent.after_update(tr, None, None)
    tr.run_update(1.0)
    sent.after_update(tr, None, None)
    return sent.overflow_skips


def _flush_between_holds(sent, tr, itr):
    for i in range(1, 31):
        tr.run_update(1.0 + 0.01 * (i % 3))
        sent.after_update(tr, None, itr)
        if i % 5 == 0:
            tr.flush()  # after the health check, as the CLI flushes
    tr.run_update(200.0)
    sent.after_update(tr, None, itr)
    for _ in range(3):
        tr.run_update(1.0)
        sent.after_update(tr, None, itr)


def _grad_and_cooldown_expiry(sent, tr, itr):
    lrs = []
    for i in range(12):
        tr.run_update(1.0, gnorm=1.0 + 0.01 * (i % 4))
        sent.after_update(tr, None, itr)
    for _ in range(2):
        tr.run_update(1.0, gnorm=50.0)  # an explosion; then again after the rewind
        sent.after_update(tr, None, itr)
        for _ in range(3):
            tr.run_update(1.0, gnorm=1.0)
            sent.after_update(tr, None, itr)
            lrs.append(sent.lr_scale(tr.step))
    for _ in range(12):  # a clean cooldown de-escalates the ladder
        tr.run_update(1.0, gnorm=1.0)
        sent.after_update(tr, None, itr)
        lrs.append(sent.lr_scale(tr.step))
    return lrs, sent.rewind_count, sent.state_dict(), sent.fingerprint_token()


def _scale_collapse(sent, tr, itr):
    scale = 1024.0
    for i in range(8):
        tr.run_update(1.0, scale=scale)
        sent.after_update(tr, None, itr)
    for _ in range(5):
        scale /= 2
        tr.run_update(1.0, scale=scale, overflow=1.0, gnorm=float("inf"))
        sent.after_update(tr, None, itr)


LADDERS = {
    "rewind_cooldown_abort": (_ladder, {}),
    "no_snapshot_aborts": (_no_snapshot, {"snapshot_interval": 0}),
    "overflow_never_folds": (_overflows, {"snapshot_interval": 0}),
    "flush_between_holds": (_flush_between_holds, {"sentinel_interval": 3,
                                                   "sentinel_warmup": 3}),
    "grad_explosion_cooldown": (_grad_and_cooldown_expiry, {"max_rewinds": 5,
                                                            "snapshot_interval": 3}),
    "scale_collapse": (_scale_collapse, {"fp16": True, "max_rewinds": 5}),
}


def _drive(health_mod, scenario):
    fn, over = LADDERS[scenario]
    sent = health_mod.TrainingHealthSentinel(_sentinel_args(**over))
    tr = _StubTrainer(health_mod.HealthSnapshot, use_loss_scale=over.get("fp16", False))
    itr = _FakeItr()
    err = None
    result = None
    try:
        result = fn(sent, tr, itr)
    except health_mod.TrainingHealthError as e:
        err = str(e)
    return {"events": sent.events, "restored_to": tr.restored_to, "skipped": itr.n,
            "ring": sent.ring.steps(), "rewinds": sent.rewind_count, "error": err,
            "result": result}


@pytest.mark.parametrize("scenario", list(LADDERS))
def test_sentinel_ladder_matches_jax(scenario):
    port = _drive(port_health, scenario)
    ref = _drive(jax_health, scenario)
    assert port == ref
    expect_events = {"rewind_cooldown_abort": 3, "no_snapshot_aborts": 1,
                     "overflow_never_folds": 0, "flush_between_holds": 1,
                     "grad_explosion_cooldown": 2, "scale_collapse": 1}[scenario]
    assert len(port["events"]) == expect_events
    if scenario == "rewind_cooldown_abort":
        assert [e["action"] for e in port["events"]] == ["rewind", "rewind+cooldown", "abort"]
        assert "detector=loss-spike" in port["error"]


def test_sentinel_state_round_trip_and_disabled():
    assert port_health.build_sentinel(Namespace(sentinel_interval=0)) is None
    assert port_health.build_sentinel(Namespace()) is None
    port = _drive(port_health, "grad_explosion_cooldown")
    fresh = port_health.TrainingHealthSentinel(_sentinel_args())
    state = port["result"][2]
    fresh.load_state_dict(state)
    assert fresh.state_dict() == state
    assert fresh.fingerprint_token() == port["result"][3]


# ---------------------------------------------------------------------------
# 4. fault plans
# ---------------------------------------------------------------------------

SPECS = ["loss-spike@6", "loss-spike:80@6", "grad-explosion:30@2", "raise@3", "raise@3@0",
         "disk-full@0", "slow-disk:0.5@4", "bit-flip-checkpoint:3@5",
         "truncate-checkpoint@1@0"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_jax(spec):
    port, ref = port_chaos.parse_fault_spec(spec), jax_chaos.parse_fault_spec(spec)
    assert (port.kind, port.step, port.param, port.rank, repr(port)) == (
        ref.kind, ref.step, ref.param, ref.rank, repr(ref))
    for step in range(8):
        assert port.active(step) == ref.active(step)


@pytest.mark.parametrize("spec", ["loss-spike:50@6@1", "nope@1", "raise", "raise@1@2@3"])
def test_bad_fault_specs_rejected_as_jax(spec):
    with pytest.raises(ValueError) as ref:
        jax_chaos.parse_fault_spec(spec)
    with pytest.raises(ValueError) as port:
        port_chaos.parse_fault_spec(spec)
    assert type(port.value) is type(ref.value)


@pytest.mark.parametrize("spec", ["seed-skew@1", "collective-delay:2@1", "host-loss@3"])
def test_unported_fault_kinds_name_their_queue(spec):
    jax_chaos.parse_fault_spec(spec)  # a kind the JAX package runs
    with pytest.raises(NotImplementedError, match="queue A item"):
        port_chaos.parse_fault_spec(spec)


@pytest.mark.parametrize("spec,steps", [
    ("loss-spike:80@6", [5, 6, 6, "note7", 6, 7]),
    ("grad-explosion:30@2", [1, 2, "note2", 2, "note3", 2]),
    ("loss-spike@0", [0, "note1", 0]),
    ("raise@2", [2]),
])
def test_fault_multipliers_match_jax(spec, steps):
    for mod in (jax_chaos, port_chaos):
        mod.configure(Namespace(fault_inject=spec))
    for s in steps:
        if isinstance(s, str):
            jax_chaos.note_step(int(s[4:]))
            port_chaos.note_step(int(s[4:]))
            continue
        assert port_chaos.fault_multipliers(s) == jax_chaos.fault_multipliers(s), s
    with pytest.raises(port_chaos.ChaosError) if spec.startswith("raise") else _nothing():
        port_chaos.maybe_raise(2)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_skip_relaxes_the_stall_budget_as_jax():
    """``CountingIterator.skip`` over a ``BufferedIterator`` whose items
    each take longer than the stall budget: the skip passes (budget x10)
    and the normal budget is armed again after it, on both sides."""
    import time

    class Slow:
        def __len__(self):
            return 6

        def __iter__(self):
            for i in range(6):
                if 1 <= i <= 3:
                    time.sleep(0.3)
                yield {"batch": i}

    for mod in (port_iterators, jax_iterators):
        it = mod.CountingIterator(mod.BufferedIterator(2, Slow(), stall_timeout=0.15))
        assert next(it) == {"batch": 0}
        it.skip(3)
        assert it.n == 4 and next(it) == {"batch": 4}
        assert mod._stall_relaxed == 0


# ---------------------------------------------------------------------------
# 5. the trainers
# ---------------------------------------------------------------------------

SPIKE_AT, UPDATES = 9, 14


def _flat_views_alias(tr):
    """Every parameter is still the view of its segment of its flat buffer."""
    opt = tr._optimizer
    for group, bufs in zip(opt.plan.groups, opt.flat):
        buf = bufs["param"] if bufs["param"] is not None else bufs["master"]
        for seg in group.segments:
            p = tr.params[seg.name]
            assert p.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
            assert p.data_ptr() == buf[seg.start:].data_ptr(), seg.name


@pytest.mark.parametrize("interval,fused", [(1, False), (3, False), (1, True)])
def test_trainer_rewind_matches_jax(tmp_path, interval, fused):
    over = dict(sentinel_interval=interval, snapshot_interval=3, snapshot_keep=2,
                sentinel_warmup=4, loss_spike_window=8, loss_spike_zmax=6.0,
                spike_skip_updates=2, max_update=UPDATES + 4, total_num_update=UPDATES + 4,
                fault_inject=f"loss-spike:1000@{SPIKE_AT}", fused_adam=fused,
                update_freq=[1])
    args, task, samples, jax_tr, variables = pair.setup(tmp_path, UPDATES + 6, n_docs=96,
                                                         **over)
    port_tr = pair.port_trainer(args, task, variables)
    assert port_tr.sentinel is not None and jax_tr.sentinel is not None
    groups = [[s] for s in samples]
    jax_itr = jax_iterators.CountingIterator(groups)
    port_itr = port_iterators.CountingIterator(groups)
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    kept = {}
    jax_losses, prev = [], {"loss": 0.0, "sample_size": 0.0}
    port_losses = []
    for _ in range(UPDATES):
        if not (jax_itr.has_next() and port_itr.has_next()):
            break
        jax_tr.train_step(next(jax_itr))
        port_tr.train_step(next(port_itr))
        macc = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
        jax_losses.append((jax_tr.get_num_updates(), (macc["loss"] - prev["loss"])
                           / (macc["sample_size"] - prev["sample_size"]) / math.log(2)))
        port_losses.append((port_tr.get_num_updates(), port_tr.update_losses[-1]))
        jax_tr.health_check(None, jax_itr)
        port_tr.health_check(None, port_itr)
        if port_tr.get_num_updates() % 3 == 0 and not port_tr.sentinel.events:
            kept[port_tr.get_num_updates()] = {k: v.clone() for k, v in
                                               port_tr._live_state().items()}
        if port_tr.sentinel.events and "restored" not in kept:
            target = port_tr.sentinel.events[0]["target_step"]
            kept["restored"] = target
            live = port_tr._live_state()
            assert live.keys() == kept[target].keys()
            for k, v in live.items():
                assert torch.equal(v, kept[target][k]), k  # bit for bit
            assert port_tr.get_num_updates() == target
            if fused:
                _flat_views_alias(port_tr)
        # the JAX CLI flushes at --log-interval; here every 4 updates, so
        # interval 3 sees a flush between holds
        if jax_tr.get_num_updates() % 4 == 0:
            jax_tr.flush_metrics()
            port_tr.flush_metric_sums()
        if jax_tr._macc is None:
            prev = {"loss": 0.0, "sample_size": 0.0}
        else:
            prev = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
    key = ("step", "detector", "action", "target_step")
    port_ev = [{k: e[k] for k in key} for e in port_tr.sentinel.events]
    assert port_ev == [{k: e[k] for k in key} for e in jax_tr.sentinel.events]
    assert len(port_ev) == 1 and port_ev[0]["detector"] == "loss-spike"
    assert port_ev[0]["action"] == "rewind" and "restored" in kept
    assert port_tr.sentinel.events[0]["value"] == pytest.approx(
        jax_tr.sentinel.events[0]["value"], rel=1e-4)
    assert jax_itr.n == port_itr.n  # the same data skipped
    assert [n for n, _ in port_losses] == [n for n, _ in jax_losses]
    after = [i for i, (n, _) in enumerate(port_losses) if i and n <= port_losses[i - 1][0]]
    assert after, "no rewind in the update counter"
    pair.assert_close_losses([v for _, v in port_losses[after[0]:]],
                             [v for _, v in jax_losses[after[0]:]], 1e-4)
    assert port_tr.get_lr() == pytest.approx(jax_tr.get_lr(), rel=1e-6)
    state = port_tr.state_dict()["extra_state"]["sentinel"]
    assert state["events"] == port_tr.sentinel.events and state["rewind_count"] == 1
