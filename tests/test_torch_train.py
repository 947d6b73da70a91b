"""The port's training path against the JAX package's on the CPU.

1. ``bert_tiny`` from the same weights (JAX init -> ``from_jax_params``) and
   the same batches (the port's pipeline, identical to the JAX package's,
   tests/test_torch_train_data.py), all dropouts 0: three updates at
   ``--update-freq 2`` through the JAX ``Trainer`` in-process and through
   the port's ``Trainer``.  Per-update loss within 1e-4 relative;
   parameters within 1e-5 absolute: the two agree to about 1e-7, while an
   update skipped or misapplied moves a weight by up to the lr, 1e-3.
2. ``python -m unicore_tpu_torch.cli.train --device cpu`` for 4 updates,
   then ``python -m unicore_tpu_torch.cli.serve --device cpu`` loads the
   checkpoint it wrote and answers one ``/v1/infer``; without a card and
   without ``--device cpu`` the trainer exits 76 naming the card.
"""

import json
import math
import os
import signal
import subprocess
import sys
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from unicore_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
from unicore_tpu.models.bert import BertModel as JaxBert
from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan
from unicore_tpu.tasks.unicore_task import UnicoreTask as JaxTask
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.losses import LOSS_REGISTRY as PORT_LOSSES
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.tasks.bert import BertTask as PortBertTask
from unicore_tpu_torch.trainer import Trainer as PortTrainer

from test_torch_serve import REPO, PortServer, _env, _post
from test_torch_train_data import write_corpus


@pytest.fixture(autouse=True)
def _restore_parallel_plan():
    # a JAX Trainer sets the JAX package's process-global parallel plan and
    # mesh: put back what was there, so later tests in this process see it
    # (a plan and a mesh left together shard test_decode's KV pools)
    plan, mesh = get_global_plan(), get_global_mesh()
    yield
    set_global_plan(plan)
    set_global_mesh(mesh)


LR, STEPS, UPDATE_FREQ = 1e-3, 3, 2
TINY = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
            encoder_attention_heads=4, max_seq_len=128, post_ln=True,
            dropout=0.0, emb_dropout=0.0, attention_dropout=0.0)


def train_args(data):
    return Namespace(
        # shared
        data=data, seed=1, task="bert", arch="bert_tiny", loss="masked_lm",
        optimizer="adam", adam_betas="(0.9, 0.98)", adam_eps=1e-6,
        weight_decay=1e-4, clip_norm=1.0, lr_scheduler="polynomial_decay",
        lr=[LR], warmup_updates=1, warmup_ratio=-1.0, total_num_update=STEPS,
        end_learning_rate=0.0, power=1.0, force_anneal=None, max_update=STEPS,
        update_freq=[UPDATE_FREQ], batch_size=4, required_batch_size_multiple=1,
        train_subset="train", max_seq_len=128, mask_prob=0.15,
        leave_unmasked_prob=0.1, random_token_prob=0.1, seq_pad_multiple=128,
        # the JAX trainer's own knobs at their single-host defaults
        bf16=False, fp16=False, bf16_sr=False, allreduce_fp32_grad=False,
        fp16_init_scale=4, fp16_scale_window=None, min_loss_scale=1e-4,
        per_sample_clip_norm=0.0, data_parallel_size=-1, model_parallel_size=1,
        seq_parallel_size=1, pipeline_parallel_size=1, expert_parallel_size=1,
        zero_shard_optimizer=False, fused_adam=False, ema_decay=-1.0,
        validate_with_ema=False, donate_train_state=False,
    )


def test_trainer_matches_jax(tmp_path):
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=24)
    args = train_args(data)
    task = PortBertTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=4, seed=1)
    samples = list(itr.next_epoch_itr(shuffle=True))[: STEPS * UPDATE_FREQ]
    vocab, pad = len(task.dictionary), task.dictionary.pad()

    class JaxBertTask(JaxTask):
        dictionary = task.dictionary

    jax_model = JaxBert(vocab_size=vocab, padding_idx=pad, **TINY)
    jax_tr = JaxTrainer(args, JaxBertTask(args), jax_model,
                        JAX_LOSSES["masked_lm"](JaxBertTask(args)))
    jax_tr.init_state(samples[0])
    variables = jax.device_get(jax_tr._state["params"])

    from unicore_tpu_torch.models.bert import BertModel as PortBert

    model = PortBert(vocab_size=vocab, padding_idx=pad, **TINY)
    model.load_state_dict(checkpoint_utils.from_jax_params(variables))
    port_tr = PortTrainer(args, task, model, PORT_LOSSES["masked_lm"](task), "cpu")

    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    prev = {"loss": 0.0, "sample_size": 0.0}
    _kernels.reset_launch_counts()
    for step in range(STEPS):
        group = samples[step * UPDATE_FREQ:(step + 1) * UPDATE_FREQ]
        jax_tr.train_step(group)
        port_tr.train_step(group)
        macc = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
        jax_loss = ((macc["loss"] - prev["loss"])
                    / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
        prev = macc
        port_loss = port_tr.update_losses[-1]
        assert abs(port_loss - jax_loss) <= 1e-4 * abs(jax_loss), (step, port_loss, jax_loss)
        assert port_tr.get_lr() == jax_tr.get_lr()
    assert port_tr.get_num_updates() == jax_tr.get_num_updates() == STEPS
    assert port_tr.micro_batches == STEPS * UPDATE_FREQ
    assert sum(_kernels.launch_counts().values()) == 0  # CPU: plain versions

    ref = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    tol = 1e-5
    moved = 0
    for name, p in model.named_parameters():
        diff = (p.detach() - ref[name]).abs().max().item()
        assert diff <= tol, (name, diff)
        moved += int((p.detach() - checkpoint_utils.from_jax_params(variables)[name]).abs().max() > 0)
    assert moved > 0.9 * len(ref)  # the updates really moved the weights


def _train_cli(data, save_dir, *extra, **env):
    argv = [sys.executable, "-m", "unicore_tpu_torch.cli.train", data,
            "--task", "bert", "--loss", "masked_lm", "--arch", "bert_tiny",
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)",
            "--adam-eps", "1e-6", "--clip-norm", "1.0", "--weight-decay", "1e-4",
            "--lr-scheduler", "polynomial_decay", "--lr", "1e-3",
            "--warmup-updates", "2", "--total-num-update", "4",
            "--max-update", "4", "--max-epoch", "2", "--batch-size", "4",
            "--update-freq", "2", "--log-interval", "1", "--log-format", "simple",
            "--save-interval-updates", "2", "--keep-interval-updates", "1",
            "--save-dir", save_dir, "--tmp-save-dir", save_dir,
            "--num-workers", "0", "--seq-pad-multiple", "128", "--seed", "1",
            *extra]
    return subprocess.run(argv, capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=_env(**env))


def test_train_cli_checkpoint_serves(tmp_path):
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=24)
    save_dir = str(tmp_path / "ckpt")
    proc = _train_cli(data, save_dir, "--device", "cpu")
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("TRAIN stats ")
    stats = json.loads(last[len("TRAIN stats "):])
    assert stats["updates"] == 4 and stats["micro_batches"] == 8
    assert all(np.isfinite(stats["loss_per_update"]))
    assert sum(stats["kernel_launches"].values()) == 0
    # 3 updates per epoch, saved as the JAX CLI names them: checkpoint_1_2
    # (update 2), checkpoint1 (the end of epoch 1), checkpoint_2_4 (update
    # 4, the last) pruning checkpoint_1_2 (--keep-interval-updates 1)
    # (beside the run's event journal, <save-dir>/telemetry)
    assert sorted(set(os.listdir(save_dir)) - {"telemetry"}) == [
        "checkpoint1.pt", "checkpoint_2_4.pt", "checkpoint_last.pt"]

    ckpt = os.path.join(save_dir, "checkpoint_last.pt")
    state = checkpoint_utils.load_checkpoint_to_cpu(ckpt)
    assert state["optimizer_history"][-1]["num_updates"] == 4
    assert state["optimizer_state"]["num_steps"] == 4
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
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
    finally:
        srv.close()


def test_train_cli_wants_a_card_by_default(tmp_path):
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=4)
    proc = _train_cli(data, str(tmp_path / "ckpt"), CUDA_VISIBLE_DEVICES="")
    out = proc.stdout + proc.stderr
    assert proc.returncode == 76, out[-4000:]
    assert "no CUDA card" in out and "TRAIN stats" not in out


def test_port_trainer_runs_attention_dropout_with_explicit_rng(tmp_path):
    """Training with attention dropout draws its kernel seeds from the
    trainer's (seed, update, micro-batch) generators: two trainers from the
    same weights take the same steps."""
    data = str(tmp_path / "corpus")
    write_corpus(data, n_docs=8)
    args = train_args(data)
    task = PortBertTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=4, seed=1)
    group = list(itr.next_epoch_itr(shuffle=True))[:2]
    from unicore_tpu_torch.models.bert import BertModel as PortBert

    losses = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(0)
        model = PortBert(vocab_size=len(task.dictionary),
                         padding_idx=task.dictionary.pad(), generator=gen,
                         **dict(TINY, attention_dropout=0.1, dropout=0.1))
        tr = PortTrainer(args, task, model, PORT_LOSSES["masked_lm"](task), "cpu")
        tr.begin_epoch(1)
        tr.train_step(group)
        tr.train_step(group)
        losses.append(tr.update_losses)
    assert losses[0] == losses[1]
