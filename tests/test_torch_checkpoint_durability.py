"""The port's durable checkpoints against the JAX package's on the CPU.

1. A v2 round trip (bf16, fp32 and int tensors, the saved ``Namespace``),
   and ``unicore_tpu.checkpoint.format.verify`` / ``read_header`` accepting
   the port's file (the envelope is byte-compatible).
2. A single flipped payload byte rejected before ``torch.load`` runs,
   naming the same chunk as the JAX verifier on the same file; a torn tail
   diagnosed on both sides; a damaged bare ``torch.save`` file raises
   ``CorruptCheckpointError`` (the parse-layer wrapper), not the zip
   reader's own error.
3. ``_fallback_checkpoints`` on one directory equal to JAX's, and
   ``load_checkpoint`` falling back to the file JAX's loop picks, only when
   resuming the implicit ``checkpoint_last``.
4. The ENOSPC preflight, injected ENOSPC and ``--on-save-failure
   warn|abort`` as the JAX ``persistent_save`` escalates them; a transient
   failure retried; ``--checkpoint-write-version 1``.
5. The emergency saves: a minimal ``checkpoint_last`` straight into
   ``--save-dir`` (preemption) and ``checkpoint_emergency`` (a fatal error),
   which no resume picks; the async publish with staging apart.
6. SIGTERM to ``python -m unicore_tpu_torch.cli.train`` mid-run: exit 0, a
   loadable minimal ``checkpoint_last.pt``, and the resume reaches
   ``--max-update``.
"""

import argparse
import json
import logging
import os
import pickle
import signal
import struct
import subprocess
import sys
import time
from argparse import Namespace

import numpy as np
import pytest
import torch

from unicore_tpu import checkpoint_utils as jax_ckpt
from unicore_tpu.checkpoint import durable as jax_durable
from unicore_tpu.checkpoint import format as jax_format
from unicore_tpu.distributed import chaos as jax_chaos

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.checkpoint import durable
from unicore_tpu_torch.checkpoint import format as ckpt_format
from unicore_tpu_torch.distributed import chaos, guard

from test_torch_serve import REPO, _env
from test_torch_train_data import write_corpus


@pytest.fixture(autouse=True)
def _reset():
    yield
    for mod in (durable, jax_durable, chaos, jax_chaos):
        mod.reset()
    checkpoint_utils.set_best_score(None)


def _state(seed=0, n=3000):
    g = torch.Generator().manual_seed(seed)
    return {
        "args": Namespace(arch="bert_tiny", seed=seed, lr=[1e-3]),
        "model": {"w": torch.randn(n, generator=g),
                  "b": torch.randn(n // 3, generator=g).to(torch.bfloat16),
                  "ids": torch.arange(17)},
        "extra_state": {"train_iterator": {"epoch": 1, "iterations_in_epoch": 5}},
    }


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a == b


# ---------------------------------------------------------------------------
# 1-2. the envelope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1 << 10, ckpt_format.DEFAULT_CHUNK_SIZE])
def test_v2_round_trip_and_jax_verifies_it(tmp_path, chunk):
    path = str(tmp_path / "ck.pt")
    state = _state()
    ckpt_format.write(state, path, meta={"step": 7, "suffix": ""}, chunk_size=chunk)
    assert ckpt_format.is_v2(path) and jax_format.is_v2(path)
    header, got = ckpt_format.read(path)
    assert _equal(got, state)
    assert header["step"] == 7 and header["payload"] == "torch"
    assert jax_format.verify(path) == header == jax_format.read_header(path)
    assert jax_format.payload_bounds(path) == ckpt_format.payload_bounds(path)
    assert _equal(checkpoint_utils.load_checkpoint_to_cpu(path), state)


@pytest.mark.parametrize("where", [0.0, 0.37, 0.999])
def test_flipped_byte_rejected_before_load_as_jax(tmp_path, monkeypatch, where):
    path = str(tmp_path / "ck.pt")
    ckpt_format.write(_state(), path, chunk_size=1 << 10)
    lo, hi = ckpt_format.payload_bounds(path)
    off = lo + int((hi - lo - 1) * where)
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ 0x10]))

    def no_load(*a, **k):
        raise AssertionError("the payload was loaded before the manifest was checked")

    monkeypatch.setattr(torch, "load", no_load)
    with pytest.raises(ckpt_format.CorruptCheckpointError) as port:
        checkpoint_utils.load_checkpoint_to_cpu(path)
    with pytest.raises(jax_format.CorruptCheckpointError) as ref:
        jax_format.verify(path)
    chunk = f"chunk {(off - lo) // (1 << 10) + 1}/"
    assert chunk in str(port.value) and chunk in str(ref.value)
    assert str(port.value).split("(crc32")[0] == str(ref.value).split("(crc32")[0]


@pytest.mark.parametrize("keep", [0.3, 0.9, -1])
def test_torn_tail_diagnosed(tmp_path, keep):
    path = str(tmp_path / "ck.pt")
    ckpt_format.write(_state(), path, chunk_size=1 << 10)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size + keep if keep < 0 else int(size * keep))
    with pytest.raises(ckpt_format.CorruptCheckpointError, match="torn"):
        checkpoint_utils.load_checkpoint_to_cpu(path)
    with pytest.raises(jax_format.CorruptCheckpointError, match="torn"):
        jax_format.verify(path)


class _RunsCode:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


@pytest.mark.parametrize("part", ["header", "footer"])
def test_envelope_pickle_runs_no_code(tmp_path, part):
    """The header and the footer lie outside the CRCs: a file whose
    envelope pickles a call is refused without running it."""
    path = str(tmp_path / "ck.pt")
    ckpt_format.write(_state(), path, chunk_size=1 << 10)
    raw = open(path, "rb").read()
    n = len(ckpt_format.MAGIC)
    (hlen,) = struct.unpack("<I", raw[n:n + 4])
    (flen,) = struct.unpack("<I", raw[-n - 4:-n])
    lo, hi = n + 4 + hlen, len(raw) - n - 4 - flen
    parts = {"header": raw[n + 4:lo], "footer": raw[hi:-n - 4]}
    marker = tmp_path / "ran"
    parts[part] = pickle.dumps(_RunsCode(marker))
    with open(path, "wb") as f:
        f.write(ckpt_format.MAGIC + struct.pack("<I", len(parts["header"]))
                + parts["header"] + raw[lo:hi] + parts["footer"]
                + struct.pack("<I", len(parts["footer"])) + ckpt_format.END_MAGIC)
    for load in (checkpoint_utils.load_checkpoint_to_cpu, ckpt_format.read_header):
        with pytest.raises(ckpt_format.CorruptCheckpointError, match="refused"):
            load(path)
    assert not marker.exists()
    pickle.loads(parts[part])  # the crafted bytes do run code when unpickled plainly
    assert marker.exists()


@pytest.mark.parametrize("damage", ["truncate", "zero_tail", "garbage"])
def test_damaged_bare_torch_file_is_corrupt(tmp_path, damage):
    """A bare ``torch.save`` file (the port's earlier checkpoints) still
    loads; damaged, every parse failure surfaces as
    ``CorruptCheckpointError``."""
    path = str(tmp_path / "ck.pt")
    torch.save(_state(), path)
    assert _equal(checkpoint_utils.load_checkpoint_to_cpu(path), _state())
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if damage == "truncate":
            f.truncate(size // 2)
        elif damage == "zero_tail":
            f.seek(size - 200)
            f.write(b"\0" * 200)
        else:
            f.write(b"\x80\x04not a zip at all")
    with pytest.raises(ckpt_format.CorruptCheckpointError, match="could not read"):
        checkpoint_utils.load_checkpoint_to_cpu(path)


# ---------------------------------------------------------------------------
# 3. the fallback
# ---------------------------------------------------------------------------

NAMES = ["checkpoint_last.pt", "checkpoint_1_10.pt", "checkpoint_1_20.pt", "checkpoint1.pt",
         "checkpoint_2_30.pt", "checkpoint_best.pt", "checkpoint_emergency.pt",
         "checkpoint.best_loss_2.50_20.pt", "checkpoint_2_40-s1.pt", "other.pt"]


@pytest.mark.parametrize("suffix", ["", "-s1"])
def test_fallback_order_matches_jax(tmp_path, suffix):
    for i, name in enumerate(NAMES):
        p = tmp_path / name
        p.write_bytes(b"x")
        t = 1_000_000 + (7 * i) % len(NAMES) * 10
        os.utime(p, (t, t))
    got = checkpoint_utils._fallback_checkpoints(str(tmp_path), suffix)
    assert got == jax_ckpt._fallback_checkpoints(str(tmp_path), suffix)
    assert all("emergency" not in p and "last" not in p for p in got)


class _LoadTrainer:
    """Loads through the port's file layer (``trainer.load_checkpoint``'s
    contract: None for a missing file, the extra state otherwise)."""

    checkpoint_suffix = ""

    def __init__(self, error_cls=ckpt_format.CorruptCheckpointError):
        self.loaded = []
        self.error_cls = error_cls  # what the loader's fallback catches

    def load_checkpoint(self, path, *a, **k):
        if not os.path.exists(path):
            return None
        try:
            state = checkpoint_utils.load_checkpoint_to_cpu(path)
        except ckpt_format.CorruptCheckpointError as e:
            raise self.error_cls(str(e)) from e
        self.loaded.append(os.path.basename(path))
        return dict(state["extra_state"])


def _restore_args(save_dir, **over):
    a = Namespace(save_dir=save_dir, restore_file="checkpoint_last.pt",
                  finetune_from_model=None, reset_optimizer=False,
                  reset_lr_scheduler=False, reset_meters=False, reset_dataloader=False,
                  optimizer_overrides="{}", checkpoint_suffix="")
    for k, v in over.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("explicit", [False, True])
def test_load_falls_back_where_jax_does(tmp_path, caplog, explicit):
    t = 1_000_000
    for name, rotten in (("checkpoint_1_10.pt", False), ("checkpoint_1_20.pt", True),
                         ("checkpoint_last.pt", True), ("checkpoint_emergency.pt", False)):
        path = str(tmp_path / name)
        state = _state()
        state["extra_state"]["name"] = name
        ckpt_format.write(state, path, chunk_size=1 << 10)
        if rotten:
            chaos._flip_payload_bytes(path, 1)
        t += 10
        os.utime(path, (t, t))
    over = {"restore_file": str(tmp_path / "checkpoint_1_20.pt")} if explicit else {}
    port_tr, jax_tr = _LoadTrainer(), _LoadTrainer(jax_format.CorruptCheckpointError)
    if explicit:  # a named file has no substitute
        with pytest.raises(ckpt_format.CorruptCheckpointError):
            checkpoint_utils.load_checkpoint(_restore_args(str(tmp_path), **over), port_tr)
        with pytest.raises(jax_format.CorruptCheckpointError):
            jax_ckpt.load_checkpoint(_restore_args(str(tmp_path), **over), jax_tr)
        return
    with caplog.at_level(logging.WARNING):
        extra = checkpoint_utils.load_checkpoint(_restore_args(str(tmp_path)), port_tr)
    jax_extra = jax_ckpt.load_checkpoint(_restore_args(str(tmp_path)), jax_tr)
    assert extra["name"] == jax_extra["name"] == "checkpoint_1_10.pt"
    assert port_tr.loaded == jax_tr.loaded == ["checkpoint_1_10.pt"]
    text = caplog.text
    assert "CHECKPOINT CORRUPT" in text and "digest mismatch" in text


# ---------------------------------------------------------------------------
# 4. durable writes
# ---------------------------------------------------------------------------

def _durable_case(mod_ckpt, mod_durable, tmp_path, policy, monkeypatch, how):
    mod_durable.configure(Namespace(on_save_failure=policy))
    path = str(tmp_path / f"{mod_ckpt.__name__.split('.')[0]}.pt")
    obj = {"model": {"w": np.ones(256, np.float32)}}
    if how == "preflight":
        monkeypatch.setattr("shutil.disk_usage",
                            lambda d: Namespace(total=1 << 30, used=1 << 30, free=1024))
    try:
        result = mod_ckpt.persistent_save(obj, path, backoff=0.0)
    except Exception as e:  # noqa: BLE001 -- compared across the two packages
        result = type(e).__name__
    monkeypatch.undo()
    return result, os.path.exists(path), os.path.exists(path + ".tmp"), \
        mod_durable.tracker().token()


@pytest.mark.parametrize("policy", ["warn", "abort"])
@pytest.mark.parametrize("how", ["preflight", "disk-full"])
def test_save_failure_escalates_as_jax(tmp_path, monkeypatch, policy, how):
    if how == "disk-full":
        for mod in (chaos, jax_chaos):
            mod.configure(Namespace(fault_inject="disk-full@0"))
            mod.note_step(1)
    port = _durable_case(checkpoint_utils, durable, tmp_path, policy, monkeypatch, how)
    ref = _durable_case(jax_ckpt, jax_durable, tmp_path, policy, monkeypatch, how)
    assert port == ref
    assert port[0] == (False if policy == "warn" else "CheckpointWriteError")
    assert port[3] == (1, 1)


def test_transient_failure_retried(tmp_path, monkeypatch):
    calls = []
    real = ckpt_format.write

    def flaky(obj, path, **kw):
        calls.append(path)
        if len(calls) == 1:
            raise OSError(5, "EIO (a network filesystem blip)")
        return real(obj, path, **kw)

    monkeypatch.setattr(ckpt_format, "write", flaky)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    path = str(tmp_path / "ck.pt")
    assert checkpoint_utils.persistent_save(_state(), path) is True
    assert len(calls) == 2 and durable.tracker().token() is None
    assert _equal(checkpoint_utils.load_checkpoint_to_cpu(path), _state())


def test_write_version_1_is_a_bare_torch_file(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        durable.configure(Namespace(checkpoint_write_version=1, verify_checkpoint_writes=True))
    assert "NOTHING to verify" in caplog.text
    path = str(tmp_path / "ck.pt")
    assert checkpoint_utils.persistent_save(_state(), path) is True
    assert not ckpt_format.is_v2(path)
    with torch.serialization.safe_globals([argparse.Namespace]):
        assert _equal(torch.load(path, weights_only=True), _state())
    durable.configure(Namespace(verify_checkpoint_writes=True))
    assert checkpoint_utils.persistent_save(_state(), path) is True
    assert ckpt_format.verify(path)["version"] == 2


# ---------------------------------------------------------------------------
# 5. emergency saves and the publish
# ---------------------------------------------------------------------------

class _SaverTrainer:
    def __init__(self, updates=5):
        self.updates = updates

    def get_num_updates(self):
        return self.updates

    def save_checkpoint(self, filename, extra_state):
        return checkpoint_utils.persistent_save(
            {"model": {"w": torch.ones(16)}, "extra_state": extra_state}, filename)


class _Itr:
    epoch = 2

    def state_dict(self):
        return {"epoch": 2, "iterations_in_epoch": 5}

    def end_of_epoch(self):
        return False


def _save_args(tmp_path, **over):
    a = Namespace(save_dir=str(tmp_path / "save"), tmp_save_dir=str(tmp_path / "tmp"),
                  no_save=False, checkpoint_suffix="", preemption_save_deadline=5.0,
                  no_epoch_checkpoints=True, save_interval=1, save_interval_updates=5,
                  keep_interval_updates=-1, keep_last_epochs=-1, keep_best_checkpoints=-1,
                  best_checkpoint_metric="loss", maximize_best_checkpoint_metric=False,
                  no_last_checkpoints=False)
    for k, v in over.items():
        setattr(a, k, v)
    return a


@pytest.mark.parametrize("kind", ["preempt", "error"])
def test_emergency_save_is_minimal_and_named_apart(tmp_path, caplog, kind):
    args = _save_args(tmp_path)
    os.makedirs(args.tmp_save_dir)
    with caplog.at_level(logging.INFO):
        out = checkpoint_utils.save_checkpoint(args, _SaverTrainer(), _Itr(), 0.75, None,
                                               emergency=kind)
    name = "checkpoint_last.pt" if kind == "preempt" else "checkpoint_emergency.pt"
    assert out == [os.path.join(args.save_dir, name)]
    assert sorted(os.listdir(args.save_dir)) == [name]
    assert os.listdir(args.tmp_save_dir) == []
    assert checkpoint_utils.best_score() is None  # no bookkeeping
    es = checkpoint_utils.load_checkpoint_to_cpu(out[0])["extra_state"]
    assert es["emergency_save"]["kind"] == kind
    assert es["train_iterator"] == {"epoch": 2, "iterations_in_epoch": 5}
    assert "EMERGENCY SAVE" in caplog.text and "over budget" not in caplog.text
    # the crashing state is never a resume candidate
    assert checkpoint_utils._fallback_checkpoints(args.save_dir, "") == []


def test_preemption_killed_before_publish_keeps_previous_last(tmp_path, monkeypatch):
    args = _save_args(tmp_path)
    checkpoint_utils.save_checkpoint(args, _SaverTrainer(), _Itr(), 0.75, None,
                                     emergency="preempt")

    def killed(src, dst):
        raise SystemExit("SIGKILL at the end of the grace period")

    monkeypatch.setattr(os, "replace", killed)
    with pytest.raises(SystemExit):
        checkpoint_utils.save_checkpoint(args, _SaverTrainer(), _Itr(), 0.5, None,
                                         emergency="preempt")
    last = os.path.join(args.save_dir, "checkpoint_last.pt")
    assert checkpoint_utils.load_checkpoint_to_cpu(last)["extra_state"]["val_loss"] == 0.75


def test_preemption_over_budget_still_lands(tmp_path, caplog):
    chaos.configure(Namespace(fault_inject="slow-disk:0.3@0"))
    chaos.note_step(1)
    args = _save_args(tmp_path, preemption_save_deadline=0.05)
    with caplog.at_level(logging.WARNING):
        checkpoint_utils.save_checkpoint(args, _SaverTrainer(), _Itr(), None, None,
                                         emergency="preempt")
    assert os.path.exists(os.path.join(args.save_dir, "checkpoint_last.pt"))
    assert "EMERGENCY SAVE over budget" in caplog.text and "slow disk" in caplog.text


def test_async_publish_from_a_staging_dir(tmp_path):
    args = _save_args(tmp_path)
    pool = checkpoint_utils.make_copy_pool()
    out = checkpoint_utils.save_checkpoint(args, _SaverTrainer(5), _Itr(), 1.5, pool)
    pool.close()
    pool.join()
    assert sorted(os.listdir(args.save_dir)) == ["checkpoint_2_5.pt", "checkpoint_best.pt",
                                                 "checkpoint_last.pt"]
    assert out == [os.path.join(args.save_dir, n) for n in
                   ("checkpoint_2_5.pt", "checkpoint_best.pt", "checkpoint_last.pt")]
    assert os.listdir(args.tmp_save_dir) == []  # the staged file went
    for name in os.listdir(args.save_dir):
        ckpt_format.verify(os.path.join(args.save_dir, name))
    seconds = checkpoint_utils.save_seconds()
    assert len(seconds["write"]) >= 1 and len(seconds["publish"]) >= 1


def test_staged_write_that_failed_is_not_published(tmp_path, caplog):
    durable.configure(Namespace(on_save_failure="warn"))
    chaos.configure(Namespace(fault_inject="disk-full@0"))
    chaos.note_step(5)
    args = _save_args(tmp_path)
    with caplog.at_level(logging.INFO):
        assert checkpoint_utils.save_checkpoint(args, _SaverTrainer(), _Itr(), None) is None
    assert os.listdir(args.save_dir) == []
    assert "skipping checkpoint publish" in caplog.text


# ---------------------------------------------------------------------------
# 6. SIGTERM to the train CLI
# ---------------------------------------------------------------------------

def _cli(data, save_dir, *extra):
    return [sys.executable, "-m", "unicore_tpu_torch.cli.train", data, "--device", "cpu",
            "--task", "bert", "--loss", "masked_lm", "--arch", "bert_tiny",
            "--optimizer", "adam", "--lr", "1e-3", "--batch-size", "2",
            "--log-interval", "1", "--save-dir", save_dir, "--num-workers", "0",
            "--seq-pad-multiple", "128", "--seed", "1", "--disable-validation", *extra]


@pytest.mark.parametrize("run", ["stopped", "raised"])
def test_train_main_gives_back_signal_handlers(monkeypatch, run):
    """An in-process ``train.main`` restores the caller's SIGTERM/SIGINT
    handlers when it ends, and a stop it saw does not carry into the next
    run."""
    from unicore_tpu_torch.cli import train as train_cli

    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}

    def body(args, device):
        assert guard.stop_requested() is None
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.stop_requested_global() == "SIGTERM"
        if run == "raised":
            raise RuntimeError("the run failed")
        return {}

    monkeypatch.setattr(train_cli, "_train", body)
    for _ in range(2):
        if run == "raised":
            with pytest.raises(RuntimeError):
                train_cli.main(None, None)
        else:
            assert train_cli.main(None, None) == {}
        assert {s: signal.getsignal(s) for s in before} == before


def test_sigterm_saves_and_resume_finishes(tmp_path):
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=400)
    save_dir = str(tmp_path / "ckpt")
    log_path = tmp_path / "run.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(_cli(data, save_dir, "--max-update", "100000",
                                     "--preemption-save-deadline", "30"),
                                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=_env())
        try:
            deadline = time.monotonic() + 120
            while "num_updates=3," not in log_path.read_text():
                assert proc.poll() is None, log_path.read_text()[-3000:]
                assert time.monotonic() < deadline, log_path.read_text()[-3000:]
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=120) == 0, log_path.read_text()[-3000:]
        finally:
            if proc.poll() is None:
                proc.kill()
    text = log_path.read_text()
    stats = json.loads(text.strip().splitlines()[-1][len("TRAIN stats "):])
    assert stats["stop_signal"] == "SIGTERM" and "EMERGENCY SAVE" in text
    stopped = stats["updates"]
    assert 3 <= stopped < 100000
    state = checkpoint_utils.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))
    assert state["optimizer_history"][-1]["num_updates"] == stopped
    assert state["extra_state"]["emergency_save"]["kind"] == "preempt"
    # (beside the run's event journal, <save-dir>/telemetry)
    assert sorted(set(os.listdir(save_dir)) - {"telemetry"}) == ["checkpoint_last.pt"]
    resumed = subprocess.run(_cli(data, save_dir, "--max-update", str(stopped + 2)),
                             capture_output=True, text=True, timeout=300, cwd=REPO, env=_env())
    assert resumed.returncode == 0, (resumed.stdout + resumed.stderr)[-3000:]
    stats = json.loads(resumed.stdout.strip().splitlines()[-1][len("TRAIN stats "):])
    assert stats["resumed_from_update"] == stopped and stats["updates"] == stopped + 2
    assert stats["stop_signal"] is None


def test_orbax_format_refused():
    from unicore_tpu_torch import options

    with pytest.raises(SystemExit):
        options.parse_args_and_arch(options.get_training_parser(),
                                    ["d", "--arch", "bert_tiny", "--checkpoint-format", "orbax"])
