"""Data-parallel training of the port (``--distributed-world-size 2``, gloo
on the CPU) against the JAX ``Trainer`` at ``--data-parallel-size 2`` and
against the port's one-process ``--update-freq 2`` run.

One 2-rank job (``tests/torch_dp_ranks.py train``), spawned once for the
module through the port's ``call_main``, runs every scenario through the
train CLI's ``main``; the cases read its results.  ``bert_tiny``, dropouts
0 where numbers are compared, every run from the JAX trainer's initial
weights (``--finetune-from-model``, a port checkpoint of them).  The global
batch of update u is the epoch's shuffled batches 2u (rank 0) and 2u + 1
(rank 1); the JAX trainer takes the two concatenated (one batch over its 2
devices), the one-process run takes them as its 2 micro-batches.

Tolerances: losses 1e-4 relative and parameters 1e-5 absolute, as the pair
tests (``tests/test_torch_train.py``: an update skipped or misapplied moves a
weight by up to the lr, 1e-3); gradient norms 1e-4 relative.  Between the
two ranks: the same bits.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.cli.serve import load_serving_model
from unicore_tpu_torch.modules.dropout import DropoutRng, dropout

import torch_trainer_pair as pair
from test_torch_train_data import write_corpus
from torch_dp_ranks import SPIKE_AT, SPIKE_UPDATES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPDATES = 3
LOSS_REL, PARAM_ABS, GNORM_REL = 1e-4, 1e-5, 1e-4


def _concat(a, b):
    if isinstance(a, dict):
        return {k: _concat(a[k], b[k]) for k in a}
    a, b = np.asarray(a), np.asarray(b)
    return np.concatenate([a, b]) if a.ndim else a


def _jax_dp2(args, task, variables):
    """The JAX trainer over a 2-device data axis (its mesh takes the first
    two of the suite's 8 CPU devices), from ``variables``."""
    from unicore_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
    from unicore_tpu.models.bert import BertModel as JaxBert
    from unicore_tpu.tasks.unicore_task import UnicoreTask as JaxTask
    from unicore_tpu.trainer import Trainer as JaxTrainer

    class JaxBertTask(JaxTask):
        dictionary = task.dictionary

    real = jax.devices
    jax.devices = lambda *a: real(*a)[:2]
    try:
        a = pair.train_args(args.data)
        a.data_parallel_size = 2
        tr = JaxTrainer(a, JaxBertTask(a), JaxBert(vocab_size=len(task.dictionary),
                                                  padding_idx=task.dictionary.pad(),
                                                  **pair.TINY),
                        JAX_LOSSES["masked_lm"](JaxBertTask(a)))
        assert tr.data_parallel_world_size == 2
    finally:
        jax.devices = real
    return tr


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    plan, mesh = get_global_plan(), get_global_mesh()
    root = tmp_path_factory.mktemp("dp")
    args, task, samples, jax_init, variables = pair.setup(root, 2 * UPDATES, n_docs=48)
    # the epoch's batches in the CLI's order: rank r takes those at r, r + 2, ...
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=4, seed=1, epoch=1)
    batches = list(itr.next_epoch_itr(shuffle=True))
    tail = str(root / "tail")
    write_corpus(tail, n_docs=26)  # 7 batches of at most 4
    init = str(root / "init.pt")
    checkpoint_utils.write_checkpoint(init, args, checkpoint_utils.from_jax_params(variables))
    out = root / "out"
    out.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_dp_ranks.py"),
                           "train", str(out), args.data, tail, init],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    ranks = [json.load(open(out / f"train_rank{r}.json")) for r in range(2)]
    params = [dict(np.load(out / f"dp_params_rank{r}.npz")) for r in range(2)]

    groups = [[batches[2 * u], batches[2 * u + 1]] for u in range(UPDATES)]
    # the JAX trainer at --data-parallel-size 2 on the concatenated batches
    jax_tr = _jax_dp2(args, task, variables)
    jax_tr.init_state(_concat(*groups[0]))
    start = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    for n, t in checkpoint_utils.from_jax_params(variables).items():
        assert torch.equal(start[n], t), n  # the seed's weights, as the port's runs
    jax_tr.begin_epoch(1)
    jax_losses, jax_gnorms, prev = [], [], {"loss": 0.0, "sample_size": 0.0, "gnorm": 0.0}
    for g in groups:
        jax_tr.train_step([_concat(*g)])
        macc = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
        jax_losses.append((macc["loss"] - prev["loss"])
                          / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
        jax_gnorms.append(macc["gnorm"] - prev["gnorm"])
        prev = macc
    jax_params = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    # the port's one process at --update-freq 2 on the same pairs
    args.update_freq = [2]
    one = pair.port_trainer(args, task, variables)
    one.begin_epoch(1)
    for g in groups:
        one.train_step(g)
    # its validation on the train split, as the CLI's validate sums it
    totals = {}
    for sample in one.get_valid_iterator("train").next_epoch_itr(shuffle=False):
        for k, v in (one.valid_step(sample) or {}).items():
            totals[k] = totals.get(k, 0.0) + float(v)
    one_valid = totals["loss"] / totals["sample_size"] / math.log(2)
    set_global_plan(plan)
    set_global_mesh(mesh)
    return dict(out=out, ranks=ranks, params=params, jax_losses=jax_losses,
                jax_gnorms=jax_gnorms, jax_params=jax_params, one=one, one_valid=one_valid,
                data=args.data, root=root)


def test_ranks_bit_identical(job):
    """The same bits on both ranks after every update (a sha256 of the
    parameters each time) and at the end."""
    d0, d1 = (job["ranks"][r]["dp"]["digests"] for r in range(2))
    assert len(d0) == UPDATES and d0 == d1 and len(set(d0)) == UPDATES
    a, b = job["params"]
    assert a.keys() == b.keys()
    for n in a:
        assert np.array_equal(a[n], b[n]), n
    digests = {r["param_sha256"] for r in job["ranks"][0]["dp"]["ranks"]}
    assert len(digests) == 1


@pytest.mark.parametrize("ref", ["jax", "one_process"])
def test_losses_match(job, ref):
    got = job["ranks"][0]["dp"]["losses"]
    want = job["jax_losses"] if ref == "jax" else job["one"].update_losses
    assert len(got) == UPDATES
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_REL * abs(w), (got, want)
    assert job["ranks"][1]["dp"]["losses"] == got


@pytest.mark.parametrize("ref", ["jax", "one_process"])
def test_gnorms_match(job, ref):
    got = job["ranks"][0]["dp"]["gnorms"]
    want = job["jax_gnorms"] if ref == "jax" else job["one"].update_gnorms
    for g, w in zip(got, want):
        assert abs(g - w) <= GNORM_REL * abs(w), (got, want)


@pytest.mark.parametrize("ref", ["jax", "one_process"])
def test_params_match(job, ref):
    got = job["params"][0]
    if ref == "jax":
        want = {n: t.numpy() for n, t in job["jax_params"].items()}
    else:
        want = {n: p.detach().numpy() for n, p in job["one"].model.named_parameters()}
    worst = max(float(np.abs(got[n] - want[n]).max()) for n in want)
    assert worst <= PARAM_ABS, worst


def test_reduction_record(job):
    d = job["ranks"][0]["dp"]["distributed"]
    assert d["world_size"] == 2 and d["backend"] == "gloo" and not d["two_level"]
    assert len(d["ms_per_update"]) == UPDATES
    n = sum(p.numel() for p in job["one"].model.parameters())
    assert d["buffer_bytes"][0] >= 4 * n and d["dcn_bytes"] == [0]


def test_only_rank0_writes_checkpoints(job):
    assert "checkpoint_last.pt" in job["ranks"][0]["dp"]["files"]
    assert job["ranks"][1]["dp"]["files"] == []


def test_uneven_tail_runs_the_dummy_batch(job):
    """7 batches (26 rows) over 2 ranks at --update-freq 2: rank 1's second
    update pairs its last batch with the weight-0 dummy; both ranks take 2
    updates of 4 micro-batches, and the rows counted are the epoch's, rank
    1's from 3 batches."""
    t0, t1 = job["ranks"][0]["tail"], job["ranks"][1]["tail"]
    assert t0["updates"] == t1["updates"] == 2
    assert t0["micro_batches"] == t1["micro_batches"] == 4
    assert t0["losses"] == t1["losses"] and all(np.isfinite(t0["losses"]))
    assert t0["samples"] + t1["samples"] == 26
    assert t0["samples"] >= 14 and t1["samples"] <= 12
    assert len({r["param_sha256"] for r in t0["ranks"]}) == 1


def test_dropout_streams(job):
    """Masks differ between the ranks at p > 0; rank r draws the stream of
    (seed, update, micro-batch, r); at world size 1 the rank is not folded."""
    m0, m1 = (np.asarray(job["ranks"][r]["dropout_mask"]) for r in range(2))
    assert (m0 != m1).any()
    for r, m in enumerate((m0, m1)):
        want = dropout(torch.ones(4096), 0.5, True, DropoutRng(1, "cpu", UPDATES, 0, r))
        assert np.array_equal(m, (want > 0).numpy().astype(int))
    one = job["one"]
    assert one.dp_world_size == 1
    got = dropout(torch.ones(4096), 0.5, True, one._rng(0))
    want = dropout(torch.ones(4096), 0.5, True, DropoutRng(1, "cpu", UPDATES, 0))
    assert torch.equal(got, want)


def test_spike_on_one_rank_rewinds_both(job):
    s0, s1 = job["ranks"][0]["spike"], job["ranks"][1]["spike"]
    assert s0["events"] == s1["events"] and len(s0["events"]) == 1
    ev = s0["events"][0]
    assert ev["detector"] == "loss-spike" and ev["action"] == "rewind"
    assert ev["step"] == SPIKE_AT + 1 and ev["target_step"] <= SPIKE_AT
    assert s0["update_ids"] == s1["update_ids"]
    assert s0["update_ids"][-1] == SPIKE_UPDATES
    assert len({r["param_sha256"] for r in s0["ranks"]}) == 1


def test_divergent_proposals_abort(job):
    for r in range(2):
        msg = job["ranks"][r]["divergent"]
        assert msg is not None and "DIVERGED" in msg
        assert f"rank {1 - r} proposed" in msg


def test_stop_on_rank1_stops_both(job):
    s0, s1 = job["ranks"][0]["stop"], job["ranks"][1]["stop"]
    assert s0["updates"] == s1["updates"] == 2
    assert s0["update_ids"] == s1["update_ids"] == [1, 2]
    assert s1["stop_signal"] == "a test stop on rank 1"
    assert s0["stop_signal"] == "stop requested on another rank"
    assert "checkpoint_last.pt" in s0["files"]


def test_two_rank_resume_continues(job):
    r0, r1 = job["ranks"][0]["resume"], job["ranks"][1]["resume"]
    assert r0["resumed_from"] == r1["resumed_from"] == 2
    assert r0["updates"] == 6 and r0["update_ids"] == [3, 4, 5, 6]
    assert r0["losses"] == r1["losses"] and all(np.isfinite(r0["losses"]))
    assert len({r["param_sha256"] for r in r0["ranks"]}) == 1


def test_two_rank_checkpoint_is_served(job):
    from argparse import Namespace

    path = str(job["out"] / "stop" / "checkpoint_last.pt")
    model = load_serving_model(Namespace(path=path, data=None, serve_quantize="off"),
                               torch.device("cpu"))[0]
    state = checkpoint_utils.load_checkpoint_to_cpu(path)
    assert state["optimizer_history"][-1]["num_updates"] == 6
    for n, p in model.state_dict().items():
        assert torch.equal(p, state["model"][n]), n
    vocab = model.state_dict()["embed_tokens.weight"].shape[0]
    tokens = torch.randint(4, vocab, (2, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(tokens)
    logits = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(logits).all()


def test_journal_rank_and_run_id(job):
    ids = {job["ranks"][r]["run_id"] for r in range(2)}
    assert ids == {"run-of-rank-0"}
    for r in range(2):
        path = job["ranks"][r]["journal_file"]
        assert path.endswith(f"events_rank{r}.jsonl")
        rec = [json.loads(line) for line in open(path)]
        mine = [x for x in rec if x["kind"] == "dp-test"]
        assert mine and mine[0]["rank"] == r and mine[0]["run_id"] == "run-of-rank-0"


def test_sharded_validation_sums_over_ranks(job):
    """The end-of-run validation on the train split, each rank its shard,
    the sums reduced: the one-process loss over every batch, within the
    loss tolerance (the parameters agree to ~1e-7)."""
    for r in range(2):
        (v,) = job["ranks"][r]["dp"]["validations"]
        assert v["update"] == UPDATES
        assert abs(v["loss"] - job["one_valid"]) <= LOSS_REL * job["one_valid"], (v, job["one_valid"])


def test_train_cli_spawns_two_cpu_ranks(job):
    """``unicore-tpu-torch-train --cpu --distributed-world-size 2
    --distributed-backend gloo``: the CLI spawns the ranks, rank 0 alone
    prints ``TRAIN stats`` and its ``ranks`` hold the same parameters."""
    from torch_dp_ranks import train_argv

    save = str(job["root"] / "cli")
    argv = [a for a in train_argv(job["data"], save, updates=2) if a not in ("--device", "cpu")]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "unicore_tpu_torch.cli.train", *argv, "--cpu",
                           "--distributed-world-size", "2", "--distributed-backend", "gloo",
                           "--no-save"], capture_output=True, text=True, timeout=300,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN stats ")]
    assert len(lines) == 1
    stats = json.loads(lines[0][len("TRAIN stats "):])
    assert stats["updates"] == 2 and stats["distributed"]["world_size"] == 2
    assert stats["distributed"]["backend"] == "gloo" and stats["device"] == "cpu"
    assert len({r["param_sha256"] for r in stats["ranks"]}) == 1


def test_failed_group_initialisation_raises():
    from argparse import Namespace

    from unicore_tpu_torch.distributed import utils as du

    args = Namespace(device="cpu", distributed_backend="gloo", distributed_world_size=2,
                     distributed_rank=0, distributed_init_method="bogus://nowhere",
                     distributed_port=-1, distributed_no_spawn=True, device_id=0, zero_stage=0)
    threads = torch.get_num_threads()
    with pytest.raises(RuntimeError, match="bogus"):
        du.distributed_init(args)
    assert torch.get_num_threads() == threads  # this process left as it was
