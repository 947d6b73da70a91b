"""Resume and serving of mixed-precision runs of the port's train CLI on the
CPU (``transformer_lm_tiny`` on ``causal_lm``, dropouts on, an EMA
validated every 2 updates, as ``tests/test_torch_resume.py``).

1. ``--bf16 --bf16-sr --ema-decay 0.99``: a 6-update run equals a 3-update
   run resumed for 3 more BIT FOR BIT -- per-update losses and lrs, and in
   the last checkpoint the bf16 weights, the fp32 master, the Adam moments
   and step count and the EMA (the SR noise is keyed on the seed and the
   update count, so the resumed run rounds as the uninterrupted one).
   The same under ``--fp16`` with a scale window of 2, the loss scale of
   every update and the schedule's counters included.
2. A resume with ``--reset-optimizer`` rebuilds the master from the cast
   parameters (moments and step count at zero); a ``--bf16`` fine-tune of
   an fp32 checkpoint starts its master from the bf16-rounded weights.
3. ``cli.train --device cpu --bf16`` on ``bert`` writes a checkpoint of
   bf16 weights that ``cli.serve --device cpu`` serves in bf16, as the JAX
   server applies the tree in its own type (saying so in its log), and
   answers one ``/v1/infer`` from.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from unicore_tpu_torch import checkpoint_utils

from test_torch_resume import _args, _assert_trees_equal, _last, _run, _trainer
from test_torch_serve import PortServer, _post
from test_torch_train import _train_cli
from test_torch_lm_train import write_lm_corpus
from test_torch_train_data import write_corpus

PRECISION = {"bf16_sr": ("--bf16", "--bf16-sr", "--ema-decay", "0.99"),
             "fp16": ("--fp16", "--fp16-init-scale", "8", "--fp16-scale-window", "2",
                      "--ema-decay", "0.99")}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "corpus")
    write_lm_corpus(path, n_train=16, n_valid=4)
    return path


@pytest.mark.parametrize("precision", list(PRECISION))
def test_mixed_precision_resume_equals_uninterrupted(data, tmp_path, precision):
    flags = PRECISION[precision]
    full = _run(data, tmp_path / "full", "--max-update", "6", *flags)
    head = _run(data, tmp_path / "resumed", "--max-update", "3", *flags)
    tail = _run(data, tmp_path / "resumed", "--max-update", "6", *flags)
    assert tail["resumed_from_update"] == 3 and tail["updates"] == 6
    assert full["dtype"] == ("bfloat16" if precision == "bf16_sr" else "float16")
    assert full["bf16_sr"] == (precision == "bf16_sr")
    for key in ("loss_per_update", "lr_per_update", "loss_scale"):
        assert head[key] + tail[key] == full[key], key
    a, b = _last(tmp_path / "full"), _last(tmp_path / "resumed")
    for key in ("model", "optimizer_state", "ema", "optimizer_history"):
        _assert_trees_equal(a[key], b[key], key)
    low = torch.bfloat16 if precision == "bf16_sr" else torch.float16
    assert all(t.dtype == low for t in a["model"].values() if t.is_floating_point())
    master = a["optimizer_state"]["master"]
    assert all(m.dtype == torch.float32 for m in master.values())
    assert a["extra_state"]["loss_scale"] == b["extra_state"]["loss_scale"]
    assert a["extra_state"]["loss_scale_state"] == b["extra_state"]["loss_scale_state"]
    if precision == "fp16":
        assert full["loss_scale"] == [8.0, 8.0, 16.0, 16.0, 32.0, 32.0]
    else:  # SR: some weights sit off the nearest-even rounding of the master
        assert any(not torch.equal(a["model"][n], m.to(low)) for n, m in master.items())


def test_reset_optimizer_and_bf16_finetune_refresh_the_master(data, tmp_path):
    _run(data, tmp_path / "bf16", "--max-update", "3", "--bf16")
    args = _args(data, tmp_path / "bf16", "--bf16", "--reset-optimizer")
    tr = _trainer(args)
    checkpoint_utils.load_checkpoint(args, tr)
    saved = _last(tmp_path / "bf16")
    assert tr._optimizer.num_steps == 0
    assert all(not v.any() for slots in tr._optimizer.state.values() for v in slots.values())
    for n, p in tr.params.items():
        assert torch.equal(p.detach(), saved["model"][n]), n
        assert torch.equal(tr._optimizer.master[n], p.detach().float()), n

    _run(data, tmp_path / "fp32", "--max-update", "3")
    pre = _last(tmp_path / "fp32")["model"]
    args = _args(data, tmp_path / "ft", "--bf16", "--finetune-from-model",
                 str(tmp_path / "fp32" / "checkpoint_last.pt"))
    tr = _trainer(args)
    checkpoint_utils.load_checkpoint(args, tr)
    for n, p in tr.params.items():
        assert pre[n].dtype == torch.float32 and p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), pre[n].to(torch.bfloat16)), n
        assert torch.equal(tr._optimizer.master[n], pre[n].to(torch.bfloat16).float()), n


def test_bf16_checkpoint_serves_upcast(tmp_path):
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=24)
    save_dir = str(tmp_path / "ckpt")
    proc = _train_cli(data, save_dir, "--device", "cpu", "--bf16")
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1][len("TRAIN stats "):])
    assert stats["dtype"] == "bfloat16" and stats["loss_scale"] == [1.0] * 4
    ckpt = os.path.join(save_dir, "checkpoint_last.pt")
    state = checkpoint_utils.load_checkpoint_to_cpu(ckpt)
    assert {t.dtype for t in state["model"].values() if t.is_floating_point()} == {torch.bfloat16}
    srv = PortServer(tmp_path / "serve.log", [
        "--path", ckpt, "--device", "cpu", "--port", "0",
        "--serve-batch-size", "2", "--serve-buckets", "1",
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])
    try:
        srv.wait_ready()
        code, body = _post(srv.base + "/v1/infer", {"tokens": [2, 7, 8, 9, 3]})
        assert code == 200 and len(body["output"]) == 5, body
        assert np.isfinite(body["score"])
        assert "checkpoint weights in bfloat16: served in bfloat16" in srv.log()
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
    finally:
        srv.close()
