"""The port's logging and telemetry modules against the JAX package's on the
same inputs (CPU, no training):

- meters and metrics: the same ``log_scalar`` / ``log_speed`` /
  ``log_derived`` / start-stop calls under a scripted clock give the same
  smoothed values, and each package's ``state_dict`` loads into the other;
- progress bars: the same stats give byte-equal ``json`` and ``simple``
  lines, the TensorBoard wrapper's event files (read back with
  ``EventAccumulator``) hold the JAX wrapper's tags, steps and values, and
  the missing-package warnings are the JAX text;
- step spans: one scripted update sequence under a stubbed clock and a
  stubbed ``_device_sync`` gives equal ``drain`` totals and equal ``span``
  journal records (envelope aside), with zero syncs on unsampled updates;
- ``parse_profile_steps`` gives the JAX answers and errors, a CPU window
  over update 0 writes a Chrome trace, and the trainer's Prometheus
  exposition has the JAX names for the same span totals;
- the trace merger on a fixture journal prints the JAX merger's stdout and
  writes its Chrome trace.
"""

import json
import logging
import os
import types
from argparse import Namespace
from collections import OrderedDict

import pytest

from unicore_tpu import telemetry as jax_telemetry
from unicore_tpu.logging import meters as jax_meters
from unicore_tpu.logging import metrics as jax_metrics
from unicore_tpu.logging import progress_bar as jax_pb
from unicore_tpu.telemetry import journal as jax_journal
from unicore_tpu.telemetry import profiler as jax_profiler
from unicore_tpu.telemetry import prometheus as jax_prom
from unicore_tpu.telemetry import spans as jax_spans
from unicore_tpu.telemetry import trace as jax_trace
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.cli import trace as port_trace_cli
from unicore_tpu_torch.logging import meters, metrics
from unicore_tpu_torch.logging import progress_bar as port_pb
from unicore_tpu_torch.telemetry import profiler, prometheus, spans, trace

PKGS = {"jax": (jax_meters, jax_metrics, jax_pb, jax_spans, jax_telemetry),
        "port": (meters, metrics, port_pb, spans, telemetry)}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv(jax_journal.ENV_RUN_ID, raising=False)
    for mod in (jax_telemetry, telemetry, jax_metrics, metrics):
        mod.reset()
    yield
    for mod in (jax_telemetry, telemetry, jax_metrics, metrics):
        mod.reset()


class ScriptedClock:
    """A stand-in for the ``time`` module: every read advances the clock
    by ``step``, so two modules making the same reads see the same times."""

    def __init__(self, step=0.125):
        self.now = 100.0
        self.step = step

    def _tick(self):
        self.now += self.step
        return self.now

    perf_counter = monotonic = time = _tick


def _stub_clocks(monkeypatch, *modules):
    clocks = [ScriptedClock() for _ in modules]
    for mod, clock in zip(modules, clocks):
        monkeypatch.setattr(mod, "time", clock)
    return clocks


# ---------------------------------------------------------------------------
# meters and metrics
# ---------------------------------------------------------------------------

def _script(metrics_mod, kind):
    """One scripted sequence of metrics calls; returns the smoothed values
    of every named aggregator and the default one."""
    m = metrics_mod
    if kind == "scalars":
        with m.aggregate("train"):
            for i in range(5):
                with m.aggregate("train_inner"):
                    m.log_scalar("loss", 4.0 - 0.1 * i, 8 + i, round=3)
                    m.log_scalar("bsz", 8, priority=190, round=1)
                    m.log_scalar("lr", 1e-3 * (i + 1), weight=0, priority=300, round=9)
                    m.log_scalar("num_updates", i + 1, weight=0, priority=200)
    elif kind == "speed_and_stopwatch":
        m.log_start_time("wall", priority=790, round=2)
        with m.aggregate("train"):
            for i in range(4):
                with m.aggregate("train_inner"):
                    m.log_start_time("train_wall", priority=800, round=2)
                    m.log_speed("ups", 1.0, priority=100, round=2)
                    m.log_stop_time("train_wall")
    elif kind == "derived":
        with m.aggregate("train"):
            m.log_scalar("loss", 2.0, 4)
            m.log_scalar("loss", 3.0, 4)
            m.log_derived("ppl", lambda meters_: 2 ** meters_["loss"].avg)
    elif kind == "new_root_and_reset":
        with m.aggregate("train"):
            m.log_scalar("loss", 5.0)
            with m.aggregate(new_root=True) as agg:
                m.log_scalar("loss", 1.0)
                inner = agg.get_smoothed_values()
            m.log_scalar("gnorm", 2.5, priority=400, round=3)
        m.reset_meter("train", "gnorm")
        with m.aggregate("train"):
            m.log_scalar("gnorm", 1.5, priority=400, round=3)
        return {"inner": dict(inner), **{n: dict(m.get_smoothed_values(n))
                                         for n in ("train", "default")}}
    return {n: dict(m.get_smoothed_values(n)) for n in ("train", "train_inner", "default")
            if m.get_meters(n) is not None}


@pytest.mark.parametrize("kind", ["scalars", "speed_and_stopwatch", "derived",
                                  "new_root_and_reset"])
def test_metrics_script_matches_jax(monkeypatch, kind):
    _stub_clocks(monkeypatch, jax_meters, meters)
    got = _script(metrics, kind)
    want = _script(jax_metrics, kind)
    assert got == want
    assert [list(v) for v in got.values()] == [list(v) for v in want.values()]  # key order


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_meters_state_dict_loads_both_ways(monkeypatch, direction):
    clocks = _stub_clocks(monkeypatch, jax_meters, meters)
    src, dst = (jax_metrics, metrics) if direction == "jax_to_port" else (metrics, jax_metrics)
    _script(src, "speed_and_stopwatch")
    with src.aggregate("train"):
        src.log_scalar("loss", 3.25, 16, round=3)
    for clock in clocks:  # a rate's elapsed time is read at serialization
        clock.step = 0.0
    state = src.state_dict()
    dst.load_state_dict(state)
    assert dst.state_dict() == state
    for name in ("train", "train_inner"):
        got, want = dst.get_meters(name), src.get_meters(name)
        assert list(got) == list(want)
        assert {k: type(v).__name__ for k, v in got.items()} == \
            {k: type(v).__name__ for k, v in want.items()}
        for k, meter in got.items():
            if isinstance(meter, (meters.AverageMeter, jax_meters.AverageMeter)):
                assert meter.smoothed_value == want[k].smoothed_value


@pytest.mark.parametrize("value,ndigits", [(3.14159, 2), (7, 0), ("x", 1), (None, 3)])
def test_safe_round_and_to_py_match_jax(value, ndigits):
    assert meters.safe_round(value, ndigits) == jax_meters.safe_round(value, ndigits)
    assert meters.to_py(value) == jax_meters.to_py(value)


# ---------------------------------------------------------------------------
# progress bars
# ---------------------------------------------------------------------------

class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append((record.name, record.getMessage()))


def _stats(meters_mod):
    avg = meters_mod.AverageMeter(round=3)
    avg.update(4.25, 3)
    avg.update(4.0, 1)
    stop = meters_mod.StopwatchMeter(round=2)
    stop.sum, stop.n = 12.75, 3
    return OrderedDict([("loss", 4.1875), ("seq_len", 128), ("ups", 2.44), ("bsz", 48),
                        ("num_updates", 6), ("lr", 0.001), ("gnorm", avg),
                        ("train_wall", stop), ("clip", None), ("wall", 29.0)])


def _bar_lines(pb_mod, meters_mod, fmt, call, tag, epoch=3):
    cap = _Capture()
    pb_mod.logger.addHandler(cap)
    level = pb_mod.logger.level
    pb_mod.logger.setLevel(logging.INFO)
    try:
        bar = pb_mod.progress_bar(list(range(12)), log_format=fmt, log_interval=2,
                                  epoch=epoch, prefix="valid on 'valid' subset"
                                  if call == "print" else None)
        for i, _ in enumerate(bar):
            if call == "log":
                bar.log(_stats(meters_mod), tag=tag, step=i + 1)
        if call == "print":
            bar.print(_stats(meters_mod), tag=tag, step=12)
    finally:
        pb_mod.logger.removeHandler(cap)
        pb_mod.logger.setLevel(level)
    return cap.lines


@pytest.mark.parametrize("fmt", ["json", "simple", "none"])
@pytest.mark.parametrize("call,tag", [("log", "train_inner"), ("print", "train"),
                                      ("print", "valid")])
def test_text_lines_are_byte_equal_to_jax(fmt, call, tag):
    got = _bar_lines(port_pb, meters, fmt, call, tag)
    want = _bar_lines(jax_pb, jax_meters, fmt, call, tag)
    assert got == want
    if fmt == "none":
        assert got == []
    else:
        assert got and all(name == tag for name, _ in got)
    if fmt == "json":
        for _, line in got:
            json.loads(line)


def test_tqdm_off_a_tty_is_simple_lines():
    bar = port_pb.progress_bar([1, 2], log_format="tqdm", epoch=1)
    assert type(bar).__name__ == type(jax_pb.progress_bar([1, 2], log_format="tqdm",
                                                          epoch=1)).__name__
    assert isinstance(bar, port_pb.SimpleProgressBar)


def event_accumulator():
    """tensorboard's ``EventAccumulator`` on its stub TF API: reading event
    files needs no TensorFlow, which would take ~16 s to import here."""
    import sys
    import types

    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("notf"))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    return EventAccumulator


def _scalars(logdir):
    EventAccumulator = event_accumulator()

    out = {}
    subs = [""] + sorted(n for n in os.listdir(logdir) if os.path.isdir(logdir / n))
    for sub in subs:
        ea = EventAccumulator(str(logdir / sub))
        ea.Reload()
        out[sub] = {tag: [(e.step, e.value) for e in ea.Scalars(tag)]
                    for tag in sorted(ea.Tags()["scalars"])}
    return out


def _tb_run(pb_mod, meters_mod, logdir):
    bar = pb_mod.progress_bar(list(range(4)), log_format="none", log_interval=2, epoch=1,
                              tensorboard_logdir=str(logdir))
    bar.log_config({"run_id": "r1", "attempt": 0, "telemetry_journal": "/j"})
    for i, _ in enumerate(bar):
        stats = _stats(meters_mod)
        stats["num_updates"] = i + 1
        bar.log(stats, tag="train_inner", step=i + 1)
    bar.print(_stats(meters_mod), tag="train")
    bar.print(_stats(meters_mod), tag="valid", step=4)
    for w in pb_mod._tb_writers.values():
        w.close()
    pb_mod._tb_writers.clear()


def test_tensorboard_events_match_jax(tmp_path):
    _tb_run(port_pb, meters, tmp_path / "port")
    _tb_run(jax_pb, jax_meters, tmp_path / "jax")
    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert got == want
    assert set(got) == {"", "train", "train_inner", "valid"}
    assert [s for s, _ in got["train_inner"]["loss"]] == [1, 2, 3, 4]
    assert got["train"]["loss"] == [(6, pytest.approx(4.1875))]


def test_missing_sink_warnings_are_the_jax_text(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(port_pb, "_writer_cls", [None])
    monkeypatch.setattr(port_pb, "_tb_missing_warned", [False])
    monkeypatch.setattr(jax_pb, "SummaryWriter", None)
    monkeypatch.setattr(jax_pb, "wandb", None)
    texts = {}
    for name, pb_mod in (("port", port_pb), ("jax", jax_pb)):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            bar = pb_mod.progress_bar([1], log_format="none", epoch=1,
                                      tensorboard_logdir=str(tmp_path / name),
                                      wandb_project="proj")
            bar.log({"loss": 1.0}, tag="train_inner", step=1)
        texts[name] = [r.getMessage() for r in caplog.records]
    assert texts["port"] == texts["jax"] == [
        "tensorboard not found, please install with: pip install tensorboardX",
        "wandb not found, skipping wandb logging"]
    # the port warns once a process, whatever the number of bars
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        port_pb.progress_bar([1], log_format="none", tensorboard_logdir=str(tmp_path))
    assert caplog.records == []


# ---------------------------------------------------------------------------
# step spans
# ---------------------------------------------------------------------------

class _Handle:
    """A probe handle the stubbed sync records; a real sync is never made."""


def _span_script(pkg, tmp_path, interval, monkeypatch):
    """One scripted update sequence through ``pkg``'s recorder: returns the
    drain totals after each interval, the sync count, the span records
    (envelope aside) and the smoothed step wall."""
    _, _, _, spans_mod, tel = PKGS[pkg]
    syncs = []
    monkeypatch.setattr(spans_mod, "_device_sync", lambda h: syncs.append(h))
    tel.configure(Namespace(save_dir=str(tmp_path / pkg), telemetry_dir=None,
                            telemetry_sample_interval=interval, metrics_port=0,
                            profile_steps=None), rank=0, role="trainer")
    rec = spans_mod.recorder()
    drains = []
    for u in range(7):
        with rec.between_span("data_wait"):
            pass
        rec.begin_update(u)
        with rec.span("h2d"):
            pass
        rec.add("h2d", 0.01 * u)
        rec.add_dispatch_residual(0.5 + 0.1 * u)
        rec.note_dispatched(u, _Handle())
        rec.end_update(u)
        if u == 2:  # a validation's copies between updates: dropped
            rec.add("h2d", 9.0)
        if u % 3 == 2:
            drains.append(rec.drain())
    drains.append(rec.drain())
    path = tel.journal_path()
    keep = set(jax_trace.ENVELOPE_KEYS) - {"update", "kind"}
    records = [{k: v for k, v in json.loads(line).items() if k not in keep}
               for line in open(path)]
    return drains, len(syncs), [r for r in records if r["kind"] == "span"], \
        rec.avg_step_wall()


@pytest.mark.parametrize("interval", [0, 1, 2, 3])
def test_span_script_matches_jax(tmp_path, monkeypatch, interval):
    _stub_clocks(monkeypatch, jax_spans, spans)
    got = _span_script("port", tmp_path, interval, monkeypatch)
    want = _span_script("jax", tmp_path, interval, monkeypatch)
    assert got == want
    drains, syncs, records, wall = got
    sampled = [u for u in range(7) if interval and u % interval == 0]
    # lag-1: the last sampled update's probe is still pending at the end
    assert syncs == max(len(sampled) - (6 in sampled), 0)
    assert {r["update"] for r in records} == set(sampled)
    assert sum(d["device_samples"] for d in drains) == syncs
    assert wall > 0


def test_unsampled_updates_make_zero_syncs(tmp_path, monkeypatch):
    syncs = []
    monkeypatch.setattr(spans, "_device_sync", lambda h: syncs.append(h))
    telemetry.configure(Namespace(save_dir=str(tmp_path), telemetry_sample_interval=4),
                        rank=0, role="trainer")
    rec = spans.recorder()
    for u in range(1, 4):  # no update here is sampled
        with rec.between_span("data_wait"):
            pass
        rec.begin_update(u)
        rec.note_dispatched(u, _Handle())
        rec.end_update(u)
    assert syncs == []
    assert spans.recorder().drain()["device_samples"] == 0
    assert spans.HostProbe().synchronize() is None


# ---------------------------------------------------------------------------
# profiler and Prometheus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "", "8:10", "0:1", "5", "a:b", "3:3", "-1:2",
                                  "1:2:3", "4:2"])
def test_parse_profile_steps_matches_jax(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as err:
            return ("error", str(err))

    assert outcome(profiler.parse_profile_steps) == \
        outcome(jax_profiler.parse_profile_steps)


def test_cpu_window_over_update_zero_writes_a_trace(tmp_path):
    import torch

    args = Namespace(save_dir=str(tmp_path), telemetry_dir=None, profile_steps="0:2",
                     telemetry_sample_interval=0, device="cpu")
    telemetry.configure(args, rank=0, role="trainer")
    for u in range(3):
        profiler.tick(u)
        torch.ones(8).add_(1)
        profiler.tick(u + 1)
    win = profiler.window()
    assert win.done and not win.active
    trace_file = win.trace_path
    assert trace_file == str(tmp_path / "telemetry" / "profile_rank0"
                             / "updates_0_2.pt.trace.json")
    assert json.load(open(trace_file))["traceEvents"]
    recs = [json.loads(line) for line in open(telemetry.journal_path())]
    edges = [(r["kind"], r["update"]) for r in recs if r["kind"].startswith("profile-")]
    assert edges == [("profile-start", 0), ("profile-stop", 2)]
    assert recs[1]["window"] == [0, 2] and recs[1]["dir"] == win.out_dir


def test_trainer_exposition_has_the_jax_names(tmp_path, monkeypatch):
    _stub_clocks(monkeypatch, jax_spans, spans)
    totals = {}
    for pkg in ("port", "jax"):
        drains, _, _, wall = _span_script(pkg, tmp_path, 2, monkeypatch)
        totals[pkg] = (drains[-1], wall)
    fake = types.SimpleNamespace(get_num_updates=lambda: 7, _recompile_count=3)
    JaxTrainer._export_prometheus(fake, 1.0, totals["jax"][0])
    prometheus.export_trainer(7, 1.0, *totals["port"])
    want = "\n".join(block for block in jax_prom.registry().render().split("# HELP ")
                     if "recompiles" not in block)
    got = "\n".join(prometheus.registry().render().split("# HELP "))
    assert got == want
    assert "unicore_tpu_train_updates_total 7" in got
    assert "unicore_tpu_train_step_wall_seconds" in got and "recompiles" not in got


# ---------------------------------------------------------------------------
# the trace merger
# ---------------------------------------------------------------------------

def _fixture_journals(d):
    """Two trainer ranks (skewed clocks), a serve journal and a router's."""
    os.makedirs(d, exist_ok=True)
    base = {"run_id": "run-1", "attempt": 0, "membership_epoch": 0}

    def rec(rank, update, wall, kind, **fields):
        return {**base, "rank": rank, "update": update, "mono": wall - 1e9,
                "wall": wall, "kind": kind, **fields}

    r0 = [rec(0, 0, 1000.0, "run-start", role="trainer"),
          rec(0, 0, 1000.1, "comm-plan", axes={"data": 2}, two_level=False)]
    r1 = [rec(1, 0, 1003.0, "run-start", role="trainer")]
    for u in range(6):
        for rank, skew, out in ((0, 0.0, r0), (1, 3.0, r1)):
            out.append(rec(rank, u, 1001.0 + u + skew, "span", name="dispatch", dur=0.25))
            out.append(rec(rank, u, 1001.1 + u + skew, "span", name="device_busy", dur=0.5,
                           upper_bound=True))
    r0 += [rec(0, 4, 1005.5, "checkpoint-save", epoch=1, path="/c/checkpoint_1_4.pt",
               names=["checkpoint_1_4.pt"], val_loss=4.2, write_seconds=0.1),
           rec(0, 5, 1006.2, "sentinel-rewind", detector="loss-spike", stat="loss",
               value=300.0, threshold=4.0, action="rewind", target_step=4,
               skipped_chunks=2, rewind_count=1),
           rec(0, 6, 1007.0, "agreed-stop", reason="received SIGTERM", signal="SIGTERM"),
           rec(0, 6, 1007.1, "checkpoint-emergency", save_kind="preempt",
               path="/c/checkpoint_last.pt", landed=True, seconds=0.2, budget=30.0),
           rec(0, 0, 1008.0, "checkpoint-fallback", corrupt="/c/checkpoint_last.pt",
               fallback="/c/checkpoint_1_4.pt", detail="failed to load"),
           rec(0, 4, 1008.1, "checkpoint-load", path="/c/checkpoint_1_4.pt",
               loaded_updates=4)]
    serve = [rec(0, -1, 1002.0, "run-start", role="serve"),
             rec(0, -1, 1002.5, "serve-shed", reason="queue-full", count=3)]
    for name, records in (("events_rank0.jsonl", r0), ("events_rank1.jsonl", r1),
                          ("events_rank0_serve.jsonl", serve)):
        with open(os.path.join(d, name), "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        with open(os.path.join(d, name), "a") as f:
            f.write('{"torn tail\n')
    return d


@pytest.mark.parametrize("flags", [[], ["--summary-only"], ["--kind", "span"]])
def test_trace_merger_matches_jax(tmp_path, capsys, flags):
    d = _fixture_journals(str(tmp_path / "telemetry"))
    out = str(tmp_path / "trace.json")
    outputs = {}
    for name, main in (("jax", jax_trace.main), ("port", port_trace_cli.main)):
        assert main([str(tmp_path)] + flags + ["--out", out]) == 0
        outputs[name] = (capsys.readouterr().out, open(out).read())
        os.remove(out)
    assert outputs["port"] == outputs["jax"]
    stdout, chrome = outputs["port"]
    assert "SENTINEL REWIND at update 5 -> snapshot @update 4" in stdout
    assert "CHECKPOINT FALLBACK: /c/checkpoint_last.pt -> /c/checkpoint_1_4.pt" in stdout
    assert "agreed stop at update 6: received SIGTERM" in stdout
    assert json.loads(chrome)["traceEvents"]
    assert trace.ENVELOPE_KEYS == jax_trace.ENVELOPE_KEYS


def test_trace_cli_without_journals(tmp_path, capsys):
    assert port_trace_cli.main([str(tmp_path)]) == 2
    assert "unicore-tpu-torch-trace: no events_rank*.jsonl" in capsys.readouterr().err
