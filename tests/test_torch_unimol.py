"""The port's Uni-Mol training path against the JAX package's on the CPU.

1. The model and loss: a small Uni-Mol (2 layers, 32 wide, 4 heads, 16
   Gaussian kernels) from the same JAX-initialised weights
   (``from_jax_params``), dropouts 0, on the same batch with padded rows:
   logits, distance, coordinates, ``x_norm`` and ``delta_norm``, then the
   gradient of ``UniMolLoss`` for every parameter.  At L = 128 the JAX side
   runs its softmax_dropout Pallas kernels (interpret mode, mode ``on``;
   the port's plain version of its CUDA kernels), at L = 40 its jnp route.
   From the second layer on the pair bias holds -inf at the padded keys,
   so both runs cover it.  Tolerances: outputs 1e-5 of the tensor's
   largest magnitude (at least 1), gradients 5e-5 of it: fp32 both sides,
   summation orders differ, and the pair stream carries them through 2
   layers and three heads.
2. The task: the port's Uni-Mol batches equal the JAX task's, array for
   array, over two epochs.
3. The trainer: two updates of ``unimol_tiny`` through the port's
   ``Trainer`` and the JAX ``Trainer`` from the same weights and batches,
   dropouts 0: losses within 1e-4 relative, parameters within 1e-5
   absolute (an update missed would move a weight by up to the lr, 1e-3).
4. The CLI: ``python -m unicore_tpu_torch.cli.train --task unimol --arch
   unimol_tiny --device cpu`` ends with a ``TRAIN stats`` line.
"""

import json
import math
import os
import subprocess
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu.losses.unimol import UniMolLoss as JaxUniMolLoss
from unicore_tpu.models.unimol import UniMolModel as JaxUniMol
from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan
from unicore_tpu.tasks.unimol import UniMolTask as JaxUniMolTask
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.data import make_builder
from unicore_tpu_torch.losses.unimol import UniMolLoss as PortUniMolLoss
from unicore_tpu_torch.models.unimol import UniMolModel as PortUniMol
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.ops import softmax_dropout as port_sd
from unicore_tpu_torch.tasks.unimol import UniMolTask as PortUniMolTask
from unicore_tpu_torch.trainer import Trainer as PortTrainer

from test_torch_serve import REPO, _env
from test_torch_softmax_dropout import pallas_on  # noqa: F401  (fixture)
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


ATOMS = ["C", "N", "O", "S", "H", "F", "Cl", "Br", "P"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + ATOMS
SMALL = dict(encoder_layers=2, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
             encoder_attention_heads=4, gaussian_kernels=16,
             dropout=0.0, emb_dropout=0.0, attention_dropout=0.0,
             masked_token_loss=1.0, masked_coord_loss=5.0, masked_dist_loss=10.0)
OUT_TOL, GRAD_TOL = 1e-5, 5e-5


def write_conformers(path, n=24, lo=8, hi=40, seed=7):
    """dict.txt and an indexed train split of conformers drawn from a seed
    (random walks with bond-like steps, as examples/unimol makes them)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "dict.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    rng = np.random.RandomState(seed)
    builder = make_builder(os.path.join(path, "train"))
    for _ in range(n):
        k = rng.randint(lo, hi + 1)
        coords = np.cumsum(rng.randn(k, 3) * 0.8 + 0.4, axis=0)
        builder.add_item({"atoms": list(rng.choice(ATOMS, size=k)),
                          "coordinates": (coords - coords.mean(0)).astype(np.float32)})
    builder.finalize()


def _batch(L, seed):
    """One batch of two rows (lengths L and 3L/4, the rest padding) with
    targets, as the task collates them."""
    rng = np.random.RandomState(seed)
    V, pad, B = len(VOCAB) + 1, 0, 2
    lens = [L, 3 * L // 4]
    tokens = np.full((B, L), pad, np.int64)
    coord = np.zeros((B, L, 3), np.float32)
    tgt = np.full((B, L), pad, np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.randint(4, V, n)
        tokens[i, 0], tokens[i, n - 1] = 2, 3
        coord[i, :n] = np.cumsum(rng.randn(n, 3) * 0.8, axis=0)
        m = rng.rand(n) < 0.15
        m[0] = m[n - 1] = False
        tgt[i, :n][m] = tokens[i, :n][m]
    dist = np.sqrt(((coord[:, :, None] - coord[:, None]) ** 2).sum(-1) + 1e-12)
    noisy = coord + (tgt != pad)[..., None] * rng.randn(B, L, 3).astype(np.float32)
    noisy_dist = np.sqrt(((noisy[:, :, None] - noisy[:, None]) ** 2).sum(-1) + 1e-12)
    return {
        "net_input": {
            "src_tokens": tokens, "src_coord": noisy.astype(np.float32),
            "src_distance": noisy_dist.astype(np.float32),
            "src_edge_type": tokens[:, :, None] * V + tokens[:, None, :],
        },
        "target": {"tokens_target": tgt, "coord_target": coord,
                   "distance_target": dist.astype(np.float32)},
    }


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _close(got, ref, floor, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    tol = floor * max(1.0, float(np.abs(ref).max()))
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


@pytest.mark.parametrize("L", [128, 40])
def test_model_and_loss_match_jax(pallas_on, L):  # noqa: F811
    """Forward outputs and every parameter's loss gradient, port against
    the JAX package, from the same weights (module docstring, item 1)."""
    sample = _batch(L, seed=L)
    V = len(VOCAB) + 1
    args = Namespace(masked_token_loss=1.0, masked_coord_loss=5.0, masked_dist_loss=10.0)

    class Task:  # what the losses read of a task
        dictionary = Namespace(pad=lambda: 0)

    Task.args = args
    jmodel = JaxUniMol(vocab_size=V, padding_idx=0, **SMALL)
    variables = jmodel.init_params(jax.random.PRNGKey(3), _jnp(sample))
    jout = jmodel.apply(variables, **_jnp(sample["net_input"]), train=True)
    jloss = JaxUniMolLoss(Task)

    def loss_fn(v):
        return jloss.forward(jmodel, v, _jnp(sample), train=True)[0]

    jval, jgrads = jax.value_and_grad(loss_fn)(variables)

    port = PortUniMol(vocab_size=V, padding_idx=0, **SMALL)
    port.load_state_dict(checkpoint_utils.from_jax_params(jax.device_get(variables)))
    port.train()
    _kernels.reset_launch_counts()
    tsample = _torch(sample)
    assert port_sd.kernel_would_run((2, 4, L, L), torch.float32, None, None) == (L == 128)
    pout = port(**tsample["net_input"])
    names = ("logits", "distance", "coord", "x_norm", "delta_norm")
    for name, p, j in zip(names, pout, jout):
        _close(p.detach().numpy(), np.asarray(j), OUT_TOL, name)
    loss, _, _ = PortUniMolLoss(Task)(port, tsample)
    loss.backward()
    assert abs(loss.item() - float(jval)) <= 1e-5 * abs(float(jval))
    ref = checkpoint_utils.from_jax_params(jax.device_get(jgrads))
    assert set(ref) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        _close(p.grad.numpy(), ref[name].numpy(), GRAD_TOL, f"grad {name}")
    assert sum(_kernels.launch_counts().values()) == 0


def test_jax_param_names_cover_unimol():
    """Every port parameter maps to its Flax name and back: the weight map
    and the Adam decay mask read the same tensors."""
    model = PortUniMol(vocab_size=14, padding_idx=0, **SMALL)
    names = checkpoint_utils.jax_param_names(model)
    assert names["gbf.mul.weight"] == "gbf.mul.embedding"
    assert names["gbf.bias.weight"] == "gbf.bias.embedding"
    assert names["gbf.means"] == "gbf.means"
    assert names["lm_head.bias"] == "lm_head.bias"
    assert names["encoder.final_head_layer_norm.weight"] == \
        "encoder.final_head_layer_norm.weight"
    assert names["encoder.layers.1.self_attn.in_proj.weight"] == \
        "encoder.layers_1.self_attn.in_proj.kernel"
    assert len(set(names.values())) == len(names)


def _task_args(data, **kw):
    args = Namespace(data=data, seed=5, max_seq_len=64, mask_prob=0.15,
                     leave_unmasked_prob=0.05, random_token_prob=0.05, noise=1.0,
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


def test_batches_identical_to_jax(tmp_path):
    data = str(tmp_path / "conformers")
    write_conformers(data, n=22)
    jax_task = JaxUniMolTask.setup_task(_task_args(data))
    port_task = PortUniMolTask.setup_task(_task_args(data))
    assert jax_task.mask_idx == port_task.mask_idx
    got = _batches(port_task, epochs=2, batch_size=4)
    ref = _batches(jax_task, epochs=2, batch_size=4)
    assert len(got) == len(ref) == 12  # 6 batches per epoch, 2 epochs
    for g, r in zip(got, ref):
        for part in ("net_input", "target"):
            assert set(g[part]) == set(r[part])
            for key in g[part]:
                a, b = np.asarray(g[part][key]), np.asarray(r[part][key])
                assert a.dtype == b.dtype, key
                np.testing.assert_array_equal(a, b, err_msg=key)
        assert g["net_input"]["src_tokens"].shape[1] % 8 == 0
    # the epochs differ: reshuffled and re-masked
    assert not all(np.array_equal(a["net_input"]["src_coord"], b["net_input"]["src_coord"])
                   for a, b in zip(got[:6], got[6:]))


def test_trainer_matches_jax(tmp_path):
    data = str(tmp_path / "conformers")
    write_conformers(data, n=12)
    steps, lr = 2, 1e-3
    args = train_args(data)
    tiny = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                encoder_attention_heads=8, gaussian_kernels=32,
                dropout=0.0, emb_dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0)
    for k, v in dict(task="unimol", arch="unimol_tiny", loss="unimol", lr=[lr],
                     total_num_update=steps, max_update=steps, update_freq=[1],
                     adam_betas="(0.9, 0.99)", mask_prob=0.15,
                     leave_unmasked_prob=0.05, random_token_prob=0.05, noise=1.0,
                     masked_token_loss=1.0, masked_coord_loss=5.0,
                     masked_dist_loss=10.0, **tiny).items():
        setattr(args, k, v)
    task = PortUniMolTask.setup_task(args)
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=4, seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[:steps]
    V, pad = len(task.dictionary), task.dictionary.pad()

    jtask = JaxUniMolTask.setup_task(args)
    jmodel = JaxUniMol(vocab_size=V, padding_idx=pad, **tiny)
    jax_tr = JaxTrainer(args, jtask, jmodel, JaxUniMolLoss(jtask))
    jax_tr.init_state(samples[0])
    variables = jax.device_get(jax_tr._state["params"])

    model = PortUniMol(vocab_size=V, padding_idx=pad, **tiny)
    model.load_state_dict(checkpoint_utils.from_jax_params(variables))
    port_tr = PortTrainer(args, task, model, PortUniMolLoss(task), "cpu")
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
    moved = 0
    for name, p in model.named_parameters():
        diff = (p.detach() - ref[name]).abs().max().item()
        assert diff <= 1e-5, (name, diff)
        moved += int((p.detach() - init[name]).abs().max() > 0)
    assert moved > 0.9 * len(ref)


def test_train_cli_unimol_cpu(tmp_path):
    data = str(tmp_path / "conformers")
    write_conformers(data, n=12)
    save_dir = str(tmp_path / "ckpt")
    argv = [sys.executable, "-m", "unicore_tpu_torch.cli.train", data,
            "--task", "unimol", "--loss", "unimol", "--arch", "unimol_tiny",
            "--device", "cpu", "--optimizer", "adam", "--adam-betas", "(0.9, 0.99)",
            "--adam-eps", "1e-6", "--clip-norm", "1.0", "--weight-decay", "1e-4",
            "--lr-scheduler", "polynomial_decay", "--lr", "1e-4",
            "--warmup-updates", "2", "--total-num-update", "4", "--max-update", "4",
            "--batch-size", "4", "--update-freq", "1", "--log-interval", "1",
            "--log-format", "simple", "--save-dir", save_dir,
            "--tmp-save-dir", save_dir, "--seed", "1"]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=300, cwd=REPO,
                          env=_env())
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("TRAIN stats ")
    stats = json.loads(last[len("TRAIN stats "):])
    assert stats["updates"] == 4 and stats["micro_batches"] == 4
    assert all(n % 8 == 0 for n in stats["micro_batch_lengths"])
    assert all(np.isfinite(stats["loss_per_update"]))
    assert sum(stats["kernel_launches"].values()) == 0
    state = checkpoint_utils.load_checkpoint_to_cpu(os.path.join(save_dir, "checkpoint_last.pt"))
    assert state["args"].task == "unimol" and "gbf.means" in state["model"]


def test_open_text_dataset_reads_indexed_shards_only(tmp_path):
    """The port opens the indexed shard format; an LMDB split, which the
    JAX package also reads, raises naming it, and a missing split raises."""
    from unicore_tpu_torch.tasks.bert import open_text_dataset

    write_conformers(str(tmp_path / "idx"), n=3)
    assert len(open_text_dataset(str(tmp_path / "idx" / "train"))) == 3
    (tmp_path / "lmdb" / "train.lmdb").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="LMDB"):
        open_text_dataset(str(tmp_path / "lmdb" / "train"))
    with pytest.raises(FileNotFoundError):
        open_text_dataset(str(tmp_path / "none" / "train"))
