"""The port's Evoformer training path (tasks/msa_pretrain.py,
losses/masked_msa.py, the trainer and the train CLI) against the JAX
package on the CPU.

1. The task: the port's masked-MSA batches equal the JAX task's, array for
   array, over two epochs, with a ``dict.txt`` and with the default
   amino-acid dictionary.
2. The trainer: two updates of a 1-block ``evoformer_tiny`` through the
   port's ``Trainer`` and the JAX ``Trainer`` from the same weights (the
   JAX init moved by 0.05 N(0, 1), so the AF2 zero-init projections pass
   gradient) and batches, dropout 0: losses within 1e-4 relative,
   parameters within 1e-5 absolute (an update missed would move a weight
   by up to the lr, 1e-3).
3. The CLI: ``python -m unicore_tpu_torch.cli.train --task msa_pretrain
   --loss masked_msa --arch evoformer --device cpu`` at a width whose
   MSA-row and triangle attentions take the flash route (msa 64 / 8 heads,
   pair 32 / 4 heads, 1 block, L = 104-120), 2 updates of ``--update-freq
   2``: its ``TRAIN stats`` line and checkpoint.
4. The weight map: every Evoformer parameter has its Flax name, and the
   unported stack options raise from the flags.
"""

import json
import math
import os
import subprocess
import sys
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from unicore_tpu.losses.masked_msa import MaskedMSALoss as JaxLoss
from unicore_tpu.models.evoformer_model import EvoformerModel as JaxEvoformer
from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan
from unicore_tpu.tasks.msa_pretrain import MSAPretrainTask as JaxTask
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.data import make_builder
from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss as PortLoss
from unicore_tpu_torch.models.evoformer_model import EvoformerModel as PortEvoformer
from unicore_tpu_torch.tasks.msa_pretrain import MSAPretrainTask as PortTask
from unicore_tpu_torch.trainer import Trainer as PortTrainer

from test_torch_serve import REPO, _env
from test_torch_train import train_args


@pytest.fixture(autouse=True)
def _restore_parallel_plan():
    # a JAX Trainer sets the JAX package's process-global parallel plan and
    # mesh: put back what was there, so later tests in this process see it
    # (a plan and a mesh left together shard test_decode's KV pools)
    plan, mesh = get_global_plan(), get_global_mesh()
    yield
    set_global_plan(plan)
    set_global_mesh(mesh)


AA = list("ACDEFGHIKLMNPQRSTVWY") + ["-"]
SPECIALS = ["[CLS]", "[PAD]", "[SEP]", "[UNK]"]
TINY = dict(num_blocks=2, msa_dim=32, pair_dim=16, msa_heads=4, pair_heads=4, dropout=0.0)


def write_msas(path, n, length=(24, 56), rows=(4, 24), seed=11, with_dict=True):
    """Indexed MSA records ``{"msa": (R, L) int16 ids}`` drawn from a seed, as
    examples/evoformer/make_example_data.py writes them: a target sequence
    and point-mutated homologs (gaps included)."""
    os.makedirs(path, exist_ok=True)
    if with_dict:
        with open(os.path.join(path, "dict.txt"), "w") as f:
            f.write("\n".join(SPECIALS + AA) + "\n")
    rng = np.random.RandomState(seed)
    builder = make_builder(os.path.join(path, "train"))
    for _ in range(n):
        L = rng.randint(*length)
        R = rng.randint(*rows)
        target = rng.randint(0, 20, size=L)
        msa = [target]
        for _ in range(R - 1):
            row = target.copy()
            pos = rng.choice(L, size=rng.randint(0, L // 3), replace=False)
            row[pos] = rng.randint(0, 21, size=len(pos))
            msa.append(row)
        builder.add_item({"msa": (np.stack(msa) + len(SPECIALS)).astype(np.int16)})
    builder.finalize()


def _task_args(data, **kw):
    args = Namespace(data=data, seed=3, max_seq_len=48, mask_prob=0.15, max_msa_rows=8,
                     train_subset="train")
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _batches(task, epochs, batch_size):
    task.load_dataset("train")
    out = []
    for epoch in range(1, epochs + 1):
        itr = task.get_batch_iterator(task.dataset("train"), batch_size=batch_size,
                                      seed=task.args.seed, epoch=epoch)
        out.extend(itr.next_epoch_itr(shuffle=True))
    return out


@pytest.mark.parametrize("with_dict", [True, False])
def test_batches_identical_to_jax(tmp_path, with_dict):
    data = str(tmp_path / "msas")
    write_msas(data, n=10, with_dict=with_dict)
    jax_task = JaxTask.setup_task(_task_args(data))
    port_task = PortTask.setup_task(_task_args(data))
    assert port_task.dictionary.symbols == jax_task.dictionary.symbols
    assert jax_task.mask_idx == port_task.mask_idx
    got = _batches(port_task, epochs=2, batch_size=3)
    ref = _batches(jax_task, epochs=2, batch_size=3)
    assert len(got) == len(ref) == 8  # 4 batches per epoch, 2 epochs
    for g, r in zip(got, ref):
        for a, b in ((g["net_input"]["src_msa"], r["net_input"]["src_msa"]),
                     (g["target"], r["target"])):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        src = np.asarray(g["net_input"]["src_msa"])
        assert src.shape[1] == 8 and src.shape[2] % 8 == 0 and src.shape[2] <= 48
    # the epochs differ: rows re-sampled and re-masked
    assert not all(np.array_equal(a["target"], b["target"]) for a, b in zip(got[:4], got[4:]))


class _PerturbedJaxEvoformer(JaxEvoformer):
    """The JAX model whose init moves every weight by 0.05 N(0, 1) (numpy
    seed), so the zero-init projections and gates pass gradient."""

    def init_params(self, rng, sample):
        variables = jax.device_get(super().init_params(rng, sample))
        leaves, tdef = jax.tree_util.tree_flatten(variables)
        r = np.random.default_rng(5)
        return tdef.unflatten([np.asarray(x) + 0.05 * r.standard_normal(x.shape).astype(np.float32)
                               for x in leaves])


def test_trainer_matches_jax(tmp_path):
    data = str(tmp_path / "msas")
    write_msas(data, n=8)
    steps, lr = 2, 1e-3
    args = train_args(data)
    tiny = dict(TINY, num_blocks=1)
    for k, val in dict(task="msa_pretrain", arch="evoformer_tiny", loss="masked_msa",
                       lr=[lr], total_num_update=steps, max_update=steps, update_freq=[1],
                       adam_betas="(0.9, 0.999)", adam_eps=1e-8, mask_prob=0.15,
                       max_msa_rows=8, max_seq_len=48, remat_policy=None,
                       activation_checkpoint=False, **tiny).items():
        setattr(args, k, val)
    task = PortTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=2, seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[:steps]
    V, pad = len(task.dictionary), task.dictionary.pad()

    jtask = JaxTask.setup_task(args)
    jmodel = _PerturbedJaxEvoformer(vocab_size=V, padding_idx=pad, max_seq_len=48, **tiny)
    jax_tr = JaxTrainer(args, jtask, jmodel, JaxLoss(jtask))
    jax_tr.init_state(samples[0])
    variables = jax.device_get(jax_tr._state["params"])

    model = PortEvoformer(vocab_size=V, padding_idx=pad, max_seq_len=48, **tiny)
    model.load_state_dict(checkpoint_utils.from_jax_params(variables))
    port_tr = PortTrainer(args, task, model, PortLoss(task), "cpu")
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    prev = {"loss": 0.0, "sample_size": 0.0}
    for step in range(steps):
        jax_tr.train_step([samples[step]])
        port_tr.train_step([samples[step]])
        macc = {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}
        jax_loss = ((macc["loss"] - prev["loss"])
                    / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
        prev = macc
        assert abs(port_tr.update_losses[-1] - jax_loss) <= 1e-4 * abs(jax_loss), step
    ref = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    init = checkpoint_utils.from_jax_params(variables)
    for name, p in model.named_parameters():
        diff = (p.detach() - ref[name]).abs().max().item()
        assert diff <= 1e-5, (name, diff)
        # every weight moves but the last block's pair updates, which do
        # not reach the masked-MSA loss
        unreached = name.startswith("evoformer.block_0.") and ".msa_" not in name
        assert bool((p.detach() - init[name]).abs().max() > 0) != unreached, name
    assert port_tr.samples == 2 * steps
    assert port_tr.micro_batch_lengths == [int(np.asarray(s["net_input"]["src_msa"]).shape[2])
                                           for s in samples]


def test_train_cli_evoformer_cpu(tmp_path):
    """The CLI at a width that takes the flash route (the plain version on
    the CPU): 2 updates of 2 micro-batches, then its stats and checkpoint."""
    data = str(tmp_path / "msas")
    write_msas(data, n=8, length=(104, 121), rows=(10, 14))
    save_dir = str(tmp_path / "ckpt")
    argv = [sys.executable, "-m", "unicore_tpu_torch.cli.train", data,
            "--task", "msa_pretrain", "--loss", "masked_msa", "--arch", "evoformer",
            "--num-blocks", "1", "--msa-dim", "64", "--msa-heads", "8", "--pair-dim", "32",
            "--pair-heads", "4", "--max-seq-len", "128", "--max-msa-rows", "8",
            "--device", "cpu", "--optimizer", "adam", "--adam-betas", "(0.9, 0.999)",
            "--adam-eps", "1e-8", "--clip-norm", "1.0", "--weight-decay", "1e-4",
            "--lr-scheduler", "polynomial_decay", "--lr", "1e-3", "--warmup-updates", "2",
            "--total-num-update", "2", "--max-update", "2", "--batch-size", "1",
            "--update-freq", "2", "--log-interval", "1", "--log-format", "simple",
            "--save-dir", save_dir, "--tmp-save-dir", save_dir, "--seed", "1"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=300, cwd=REPO,
                          env=_env())
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("TRAIN stats ")
    stats = json.loads(last[len("TRAIN stats "):])
    assert stats["updates"] == 2 and stats["micro_batches"] == 4 and stats["samples"] == 4
    assert all(n % 8 == 0 and 104 <= n <= 128 for n in stats["micro_batch_lengths"])
    assert all(np.isfinite(stats["loss_per_update"]))
    assert stats["samples_per_s"] > 0 and stats["tokens"] > 4 * 8 * 104 * 0.5
    assert sum(stats["kernel_launches"].values()) == 0
    state = checkpoint_utils.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))
    assert state["args"].task == "msa_pretrain"
    assert "evoformer.block_0.tri_attn_end.attn.q_proj.weight" in state["model"]


def test_weight_names_and_unported_flags():
    """Every port parameter maps to its Flax name (``block_{i}`` kept, dense
    kernels and embeddings renamed), and the unported stack flags raise."""
    model = PortEvoformer(vocab_size=26, padding_idx=1, max_seq_len=48, **TINY)
    names = checkpoint_utils.jax_param_names(model)
    assert names["msa_embed.weight"] == "msa_embed.embedding"
    assert names["evoformer.block_1.msa_row_attn.pair_bias.weight"] == \
        "evoformer.block_1.msa_row_attn.pair_bias.kernel"
    assert names["evoformer.block_0.tri_mul_in.ln_out.weight"] == \
        "evoformer.block_0.tri_mul_in.ln_out.weight"
    assert len(set(names.values())) == len(names)

    class Task:
        dictionary = type("D", (), {"pad": staticmethod(lambda: 1),
                                    "__len__": lambda self: 26})()

    for flags, match in ((dict(pipeline_parallel_size=2), "pipeline"),
                         (dict(seq_parallel_size=2), "sequence"),
                         (dict(remat_policy="all"), "remat"),
                         (dict(activation_checkpoint=True), "remat")):
        args = Namespace(arch="evoformer_tiny", **flags)
        with pytest.raises(NotImplementedError, match=match):
            PortEvoformer.build_model(args, Task)
