"""The port's train CLI against the JAX package's on the same tiny-BERT runs
(``tests/torch_telemetry_runs.py``: one process a package, both started
together; the JAX side on one CPU device, so both see the same batches):
a fresh run with a loss spike under the health sentinel, then a resume past
a torn ``checkpoint_last.pt``.  Held against the JAX CLI:

- the ``train_inner`` / ``train`` / ``valid`` JSON progress lines: the same
  key lists in the same order (the JAX ``recompiles`` stat aside: eager
  PyTorch compiles no step programs), the same update counts, lrs, batch
  sizes, sequence lengths and clip shares;
- the event journals: the same kinds in the same order (spans by name), and
  for each kind the JAX field names; the rewind's, the fallback's and the
  load's values;
- the port's ``/metrics`` scrapes during the run (the JAX names), its
  TensorBoard event files, and ``unicore-tpu-torch-trace`` on its journal.
"""

import json
import os
import re
import socket
import subprocess
import sys

import pytest

from unicore_tpu.telemetry import trace as jax_trace

from test_torch_train_data import write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_telemetry_runs.py")
ENVELOPE = set(jax_trace.ENVELOPE_KEYS)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("telemetry_runs")
    data = str(root / "corpus")
    write_corpus(data, n_docs=48)
    valid = str(root / "valid_corpus")
    write_corpus(valid, n_docs=8, seed=1)
    for name in os.listdir(valid):
        if name.startswith("train"):
            os.replace(os.path.join(valid, name),
                       os.path.join(data, name.replace("train", "valid", 1)))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    procs = {}
    for which in ("jax", "port"):
        out = root / which
        out.mkdir()
        log = open(out / "runner.log", "w")
        procs[which] = (subprocess.Popen(
            [sys.executable, RUNNER, which, data, str(out), str(_free_port())],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env), log, out)
    result = {}
    for which, (proc, log, out) in procs.items():
        rc = proc.wait(timeout=600)
        log.close()
        assert rc == 0, (out / "runner.log").read_text()[-6000:]
        result[which] = {
            "dir": out,
            "lines": {run: _progress_lines(out / f"{run}.log") for run in ("A", "B")},
            "journal": [json.loads(line) for line in
                        open(out / "ckpt" / "telemetry" / "events_rank0.jsonl")],
            "scrapes": json.load(open(out / "scrapes.json")),
        }
    return result


def _progress_lines(path):
    """(tag, stats) of every progress line of a run's log."""
    out = []
    for line in open(path):
        parts = line.rstrip("\n").split(" | ", 3)
        if len(parts) == 4 and parts[2] in ("train_inner", "train", "valid"):
            out.append((parts[2], json.loads(parts[3])))
    return out


def _keys(stats):
    return [k for k in stats if not k.endswith("recompiles")]


# ---------------------------------------------------------------------------
# progress lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", ["A", "B"])
@pytest.mark.parametrize("tag", ["train_inner", "train", "valid"])
def test_progress_key_lists_match_jax(runs, run, tag):
    got = [_keys(s) for t, s in runs["port"]["lines"][run] if t == tag]
    want = [_keys(s) for t, s in runs["jax"]["lines"][run] if t == tag]
    assert got == want and got
    if tag == "train_inner" and run == "A":
        assert got[0] == ["epoch", "update", "loss", "seq_len", "ups", "bsz", "num_updates",
                          "lr", "gnorm", "clip", "train_wall", "transfer_wall",
                          "host_blocked", "device_busy", "wall"]


@pytest.mark.parametrize("run", ["A", "B"])
def test_progress_values_match_jax(runs, run):
    """What does not depend on the weights' init or the clock is equal:
    the update counts, lrs, batch sizes, sequence lengths, clip shares, and
    the epoch fractions of the lines."""
    same = ("epoch", "update", "num_updates", "lr", "bsz", "seq_len", "clip", "valid_bsz",
            "valid_seq_len", "valid_num_updates", "train_num_updates", "train_bsz")
    pick = [[(t, {k: s[k] for k in same if k in s}) for t, s in runs[w]["lines"][run]]
            for w in ("port", "jax")]
    assert pick[0] == pick[1]
    for tag, stats in runs["port"]["lines"][run]:
        for k, v in stats.items():
            assert v is None or isinstance(v, (int, float)) or re.fullmatch(
                r"-?[0-9.e+-]+|nan|inf", v), (tag, k, v)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

#: kinds of the JAX journal the port has no counterpart for
UNPORTED = {"fusion-audit", "recompile-after-warmup"}


def _kinds(records):
    return [r["kind"] + (f":{r['name']}" if r["kind"] == "span" else "")
            for r in records if r["kind"] not in UNPORTED]


def test_journal_kinds_in_the_jax_order(runs):
    got, want = _kinds(runs["port"]["journal"]), _kinds(runs["jax"]["journal"])
    assert got == want
    for kind in ("run-start", "fused-norm-path", "comm-plan", "span:data_wait", "span:h2d",
                 "span:dispatch", "span:device_busy", "checkpoint-save",
                 "checkpoint-publish", "sentinel-rewind", "agreed-stop",
                 "checkpoint-fallback", "checkpoint-load"):
        assert kind in got, kind


@pytest.mark.parametrize("kind", ["run-start", "fused-norm-path", "comm-plan", "span",
                                  "checkpoint-save", "checkpoint-publish", "sentinel-rewind",
                                  "agreed-stop", "checkpoint-fallback", "checkpoint-load"])
def test_journal_fields_match_jax(runs, kind):
    def fields(which):
        return [sorted(set(r) - ENVELOPE) for r in runs[which]["journal"]
                if r["kind"] == kind]

    got, want = fields("port"), fields("jax")
    assert got == want and got
    for r in runs["port"]["journal"]:
        assert ENVELOPE <= set(r) and r["rank"] == 0 and r["attempt"] == 0


def _one(runs, which, kind):
    (rec,) = [r for r in runs[which]["journal"] if r["kind"] == kind]
    return rec


def test_rewind_fallback_and_load_match_jax(runs):
    keys = {"sentinel-rewind": ("update", "detector", "stat", "action", "target_step",
                                "skipped_chunks", "rewind_count"),
            "checkpoint-load": ("update", "loaded_updates"),
            "comm-plan": ("axes", "pods", "pod_size", "xpod_combine", "two_level")}
    for kind, names in keys.items():
        got, want = ([{k: r[k] for k in names} for r in runs[w]["journal"] if r["kind"] == kind]
                     for w in ("port", "jax"))
        assert got == want and got, kind
    got, want = _one(runs, "port", "checkpoint-fallback"), _one(runs, "jax", "checkpoint-fallback")
    assert os.path.basename(got["corrupt"]) == os.path.basename(want["corrupt"]) \
        == "checkpoint_last.pt"
    assert os.path.basename(got["fallback"]) == os.path.basename(want["fallback"])
    assert got["detail"].startswith("failed to load (CorruptCheckpointError")
    assert os.path.basename(_one(runs, "port", "checkpoint-load")["path"]) \
        == os.path.basename(got["fallback"])
    norms = [(r["module"], r["dim"], r["path"], r["source"]) for r in runs["port"]["journal"]
             if r["kind"] == "fused-norm-path"]
    assert norms == [("LayerNorm", 64, "plain", "flag:auto")] * 2  # one a run


def test_device_probe_on_the_cpu_is_an_upper_bound(runs):
    busy = [r for r in runs["port"]["journal"]
            if r["kind"] == "span" and r["name"] == "device_busy"]
    assert busy and all(r["upper_bound"] is True for r in busy)
    device_busy = [s["device_busy"] for t, s in runs["port"]["lines"]["A"]
                   if t == "train_inner" and s["device_busy"] is not None]
    assert device_busy and all(float(v) == 0.0 for v in device_busy)


# ---------------------------------------------------------------------------
# the sinks
# ---------------------------------------------------------------------------

def test_metrics_scrapes_during_the_run(runs):
    scrapes = runs["port"]["scrapes"]
    assert scrapes
    values = []
    for text in scrapes:
        samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                       if line and not line.startswith("#"))
        if "unicore_tpu_train_updates_total" in samples:
            values.append(float(samples["unicore_tpu_train_updates_total"]))
            for name in ("host_blocked", "device_busy", "data_wait", "h2d", "dispatch"):
                float(samples[f"unicore_tpu_train_{name}_seconds"])
    assert values and max(values) >= 4
    assert "unicore_tpu_train_recompiles_total" not in "".join(scrapes)


def test_tensorboard_event_files(runs):
    from test_torch_logging import event_accumulator

    EventAccumulator = event_accumulator()

    tb = runs["port"]["dir"] / "tb"
    tags = {}
    for sub in ("train_inner", "train", "valid"):
        ea = EventAccumulator(str(tb / sub))
        ea.Reload()
        tags[sub] = ea
    inner = [s for t, s in runs["port"]["lines"]["A"] if t == "train_inner"]
    steps = [e.step for e in tags["train_inner"].Scalars("loss")]
    assert steps == [int(s["num_updates"]) for s in inner if s["loss"] is not None]
    values = [round(e.value, 3) for e in tags["train_inner"].Scalars("loss")]
    assert values == [float(s["loss"]) for s in inner if s["loss"] is not None]
    assert "loss" in tags["train"].Tags()["scalars"]
    assert "loss" in tags["valid"].Tags()["scalars"]


def test_trace_cli_merges_the_run(runs, tmp_path):
    telemetry_dir = str(runs["port"]["dir"] / "ckpt" / "telemetry")
    out = str(tmp_path / "trace.json")
    proc = subprocess.run([sys.executable, "-m", "unicore_tpu_torch.cli.trace", telemetry_dir,
                           "--out", out, "--summary-only"], capture_output=True, text=True,
                          cwd=REPO, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "SENTINEL REWIND at update 7 -> snapshot @update 6" in proc.stdout
    assert "CHECKPOINT FALLBACK:" in proc.stdout and "resumed from" in proc.stdout
    events = json.load(open(out))["traceEvents"]
    assert any(e.get("ph") == "X" and e["name"] == "dispatch" for e in events)
