"""Causal-LM training in the port against the JAX package's on the CPU.

1. ``lm_cross_entropy`` against the JAX loss on the same logits (a row
   with no pad, right-padded rows, a one-token row): 1e-6 relative.
2. BERT and causal-LM batches at ``--length-bucket 3`` equal to the JAX
   pipeline's over two epochs, padded lengths included.
3. ``transformer_lm_tiny`` from the same weights (JAX init ->
   ``from_jax_params``), all dropouts 0, three updates at
   ``--update-freq 2`` through the JAX ``Trainer`` and the port's: loss
   1e-4 relative, parameters 1e-5 absolute, lrs equal.
4. ``python -m unicore_tpu_torch.cli.train --device cpu`` on ``causal_lm``
   writes a checkpoint that ``python -m unicore_tpu_torch.cli.serve
   --device cpu`` answers a ``/v1/generate`` from.
"""

import json
import math
import os
import signal
import subprocess
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
from unicore_tpu.models.transformer_lm import TransformerLMModel as JaxLM
from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan
from unicore_tpu.tasks.bert import BertTask as JaxBertTask
from unicore_tpu.tasks.causal_lm import CausalLMTask as JaxCausalLMTask
from unicore_tpu.tasks.unicore_task import UnicoreTask as JaxTask
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.data import make_builder
from unicore_tpu_torch.losses import LOSS_REGISTRY as PORT_LOSSES
from unicore_tpu_torch.models.transformer_lm import TransformerLMModel as PortLM
from unicore_tpu_torch.tasks.bert import BertTask as PortBertTask
from unicore_tpu_torch.tasks.causal_lm import CausalLMTask as PortCausalLMTask
from unicore_tpu_torch.trainer import Trainer as PortTrainer

from test_torch_serve import REPO, PortServer, _env, _post
from test_torch_train_data import VOCAB, WORDS, batches, task_args


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
TINY = dict(decoder_layers=2, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
            decoder_attention_heads=4, max_seq_len=128, dropout=0.0, emb_dropout=0.0,
            attention_dropout=0.0, activation_dropout=0.0)


def write_lm_corpus(path, n_train=24, n_valid=6, seed=0, words=(20, 100)):
    """dict.txt and indexed ``train`` and ``valid`` splits of documents of
    ``words`` words drawn from a seed."""
    rng = np.random.RandomState(seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "dict.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    for split, n in (("train", n_train), ("valid", n_valid)):
        builder = make_builder(os.path.join(path, split))
        for _ in range(n):
            builder.add_item(" ".join(rng.choice(WORDS, size=rng.randint(*words))))
        builder.finalize()


def lm_args(data, **kw):
    """The causal-LM training args both trainers read."""
    args = Namespace(
        data=data, seed=1, task="causal_lm", arch="transformer_lm_tiny",
        loss="lm_cross_entropy", optimizer="adam", adam_betas="(0.9, 0.98)",
        adam_eps=1e-6, weight_decay=0.01, clip_norm=1.0, lr_scheduler="inverse_sqrt",
        lr=[LR], warmup_updates=2, warmup_init_lr=-1, max_update=STEPS,
        update_freq=[UPDATE_FREQ], batch_size=4, batch_size_valid=4,
        required_batch_size_multiple=1, train_subset="train", max_seq_len=128,
        seq_pad_multiple=8, length_bucket=0,
        # the JAX trainer's own knobs at their single-host defaults
        bf16=False, fp16=False, bf16_sr=False, allreduce_fp32_grad=False,
        fp16_init_scale=4, fp16_scale_window=None, min_loss_scale=1e-4,
        per_sample_clip_norm=0.0, data_parallel_size=-1, model_parallel_size=1,
        seq_parallel_size=1, pipeline_parallel_size=1, expert_parallel_size=1,
        zero_shard_optimizer=False, fused_adam=False, ema_decay=-1.0,
        validate_with_ema=False, donate_train_state=False,
    )
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def lm_trainers(args, samples):
    """A JAX ``Trainer`` and a port ``Trainer`` of ``transformer_lm_tiny``
    (dropouts 0) from the same weights: the JAX init, crossed with
    ``from_jax_params``."""
    task = PortCausalLMTask.setup_task(args)
    vocab, pad = len(task.dictionary), task.dictionary.pad()

    class JaxLMTask(JaxTask):
        dictionary = task.dictionary

    jax_task = JaxLMTask(args)
    jax_tr = JaxTrainer(args, jax_task, JaxLM(vocab_size=vocab, padding_idx=pad, **TINY),
                        JAX_LOSSES["lm_cross_entropy"](jax_task))
    jax_tr.init_state(samples[0])
    model = PortLM(vocab_size=vocab, padding_idx=pad, **TINY)
    model.load_state_dict(checkpoint_utils.from_jax_params(
        jax.device_get(jax_tr._state["params"])), strict=True)
    port_tr = PortTrainer(args, task, model, PORT_LOSSES["lm_cross_entropy"](task), "cpu")
    return jax_tr, port_tr, task


def lm_samples(args, n):
    task = PortCausalLMTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=args.batch_size,
                                  seed=args.seed)
    return list(itr.next_epoch_itr(shuffle=True))[:n]


# ---------------------------------------------------------------------------
# 1. the loss
# ---------------------------------------------------------------------------

def _loss_inputs(case, vocab=13, pad=1):
    rng = np.random.default_rng(3)
    if case == "no_pad":
        tokens = rng.integers(2, vocab, (2, 9))
    elif case == "right_pad":
        tokens = rng.integers(2, vocab, (3, 9))
        tokens[0, 5:] = pad
        tokens[2, 2:] = pad
    else:  # a row of one real token: nothing to predict in it
        tokens = rng.integers(2, vocab, (2, 9))
        tokens[1, 1:] = pad
    logits = (3 * rng.standard_normal(tokens.shape + (vocab,))).astype(np.float32)
    return tokens, logits


class _Logits(torch.nn.Module):
    def __init__(self, logits):
        super().__init__()
        self.logits = logits

    def forward(self, src_tokens, rng=None):
        return self.logits


class _JaxLogits:
    def __init__(self, logits):
        self.logits = logits

    def apply(self, params, src_tokens, train=True, rngs=None):
        return self.logits


@pytest.mark.parametrize("case", ["no_pad", "right_pad", "one_token_row"])
def test_lm_cross_entropy_matches_jax(case):
    tokens, logits = _loss_inputs(case)
    task = Namespace(dictionary=Namespace(pad=lambda: 1), args=None)
    sample = {"net_input": {"src_tokens": tokens}, "target": tokens}
    jax_loss, jax_ss, jax_log = JAX_LOSSES["lm_cross_entropy"](task).forward(
        _JaxLogits(jnp.asarray(logits)), None,
        {"net_input": {"src_tokens": jnp.asarray(tokens)}, "target": jnp.asarray(tokens)},
        train=False)
    t = torch.from_numpy(tokens)
    loss, ss, log = PORT_LOSSES["lm_cross_entropy"](task).forward(
        _Logits(torch.from_numpy(logits)),
        {"net_input": {"src_tokens": t}, "target": t})
    assert int(ss) == int(jax_ss) == int((tokens[:, 1:] != 1).sum())
    assert abs(float(loss) - float(jax_loss)) <= 1e-6 * abs(float(jax_loss))
    assert log["bsz"] == int(jax_log["bsz"]) == tokens.shape[0]


# ---------------------------------------------------------------------------
# 2. the length-bucketed batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task_name", ["bert", "causal_lm"])
def test_length_bucket_batches_identical_to_jax(tmp_path, task_name):
    pytest.importorskip("tokenizers")
    data = str(tmp_path / "corpus")
    write_lm_corpus(data, n_train=23, words=(2, 30))
    kw = dict(seq_pad_multiple=8, length_bucket=3)
    port_cls, jax_cls = {"bert": (PortBertTask, JaxBertTask),
                         "causal_lm": (PortCausalLMTask, JaxCausalLMTask)}[task_name]
    port_task = port_cls.setup_task(task_args(data, **kw))
    jax_task = jax_cls.setup_task(task_args(data, **kw))
    assert port_task.length_bucket_edges() == jax_task.length_bucket_edges() == (16, 32, 48)
    got = batches(port_task, epochs=2, batch_size=4, update_freq=2)
    ref = batches(jax_task, epochs=2, batch_size=4, update_freq=2)
    assert len(got) == len(ref) == 12
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["net_input"]["src_tokens"],
                                      r["net_input"]["src_tokens"])
        np.testing.assert_array_equal(g["target"], r["target"])
    lengths = {g["target"].shape[1] for g in got}
    assert lengths <= {16, 32, 48} and len(lengths) > 1, lengths


# ---------------------------------------------------------------------------
# 3. three updates through both trainers
# ---------------------------------------------------------------------------

def test_lm_trainer_matches_jax(tmp_path):
    data = str(tmp_path / "corpus")
    write_lm_corpus(data)
    args = lm_args(data)
    samples = lm_samples(args, STEPS * UPDATE_FREQ)
    jax_tr, port_tr, _ = lm_trainers(args, samples)
    start = {n: p.detach().clone() for n, p in port_tr.model.named_parameters()}
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    prev = {"loss": 0.0, "sample_size": 0.0}
    for step in range(STEPS):
        group = samples[step * UPDATE_FREQ:(step + 1) * UPDATE_FREQ]
        assert port_tr.get_lr() == jax_tr.get_lr()
        jax_tr.train_step(group)
        port_tr.train_step(group)
        macc = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
        jax_loss = ((macc["loss"] - prev["loss"])
                    / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
        prev = macc
        assert abs(port_tr.update_losses[-1] - jax_loss) <= 1e-4 * abs(jax_loss), step
    ref = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    for name, p in port_tr.model.named_parameters():
        assert (p.detach() - ref[name]).abs().max().item() <= 1e-5, name
    moved = sum(int((p.detach() != start[n]).any())
                for n, p in port_tr.model.named_parameters())
    assert moved > 0.9 * len(ref)


# ---------------------------------------------------------------------------
# 4. train on the CPU, then serve the checkpoint
# ---------------------------------------------------------------------------

def test_lm_train_cli_checkpoint_serves_generate(tmp_path):
    data = str(tmp_path / "corpus")
    write_lm_corpus(data)
    save_dir = str(tmp_path / "ckpt")
    argv = [sys.executable, "-m", "unicore_tpu_torch.cli.train", data,
            "--task", "causal_lm", "--loss", "lm_cross_entropy",
            "--arch", "transformer_lm_tiny", "--device", "cpu", "--optimizer", "adam",
            "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-6", "--clip-norm", "1.0",
            "--weight-decay", "0.01", "--lr-scheduler", "inverse_sqrt", "--lr", "1e-3",
            "--warmup-updates", "2", "--max-update", "4", "--batch-size", "4",
            "--update-freq", "1", "--seq-pad-multiple", "32", "--length-bucket", "4",
            "--ema-decay", "0.9", "--validate-with-ema",
            "--validate-interval-updates", "2", "--save-interval-updates", "2",
            "--log-interval", "1", "--save-dir", save_dir, "--seed", "1"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=300, cwd=REPO,
                          env=_env())
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1][len("TRAIN stats "):])
    assert stats["updates"] == 4 and stats["resumed_from_update"] is None
    assert all(np.isfinite(stats["loss_per_update"]))
    assert set(stats["micro_batch_lengths"]) <= {32, 64, 96, 128}
    assert [v["update"] for v in stats["validations"]] == [2, 4]
    assert stats["best"] == min(stats["valid_losses"])
    assert sorted(set(os.listdir(save_dir)) - {"telemetry"}) == [
        "checkpoint_1_2.pt", "checkpoint_1_4.pt", "checkpoint_best.pt", "checkpoint_last.pt"]
    state = checkpoint_utils.load_checkpoint_to_cpu(
        os.path.join(save_dir, "checkpoint_last.pt"))
    assert state["ema"] and set(state["ema"]) <= set(state["model"])
    assert any(not torch.equal(e, state["model"][n]) for n, e in state["ema"].items())
    srv = PortServer(tmp_path / "serve.log", [
        "--path", os.path.join(save_dir, "checkpoint_last.pt"), "--device", "cpu",
        "--port", "0", "--serve-batch-size", "2", "--decode-batch-size", "2",
        "--serve-buckets", "2", "--cache-pages", "16", "--max-new-tokens", "5",
        "--default-deadline-ms", "30000", "--drain-deadline", "30",
    ])
    try:
        srv.wait_ready()
        code, body = _post(srv.base + "/v1/generate", {"tokens": [2, 7, 8, 9, 10]})
        assert code == 200 and body["status"] == "ok", body
        assert 1 <= len(body["output"]) <= 5 and np.isfinite(body["score"])
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0, srv.log()[-4000:]
    finally:
        srv.close()
