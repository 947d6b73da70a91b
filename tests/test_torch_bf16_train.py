"""Mixed-precision training in the port against the JAX package's on the CPU.

1. Three updates at ``--update-freq 2 --bf16`` of each family the port
   trains (``bert_tiny``, ``unimol_tiny``, a 1-block ``evoformer_tiny``,
   ``transformer_lm_tiny``; all dropouts 0) through the JAX ``Trainer`` and
   the port's, from the JAX init crossed with ``from_jax_params`` (bf16
   arrays -> bf16 tensors).  Each update's loss within 2e-2 relative and
   gradient norm within 5e-2 relative (Uni-Mol: 1e-1, see below), and each
   update's change to the
   fp32 master within 10% in L2 over all parameters: both sides round
   every bf16 product and activation, but at other places (XLA fuses, the
   port runs op by op), so the two runs drift apart by bf16 roundings
   (2**-8 relative each), not by the size of an update.  The bf16
   parameters equal the nearest-even rounding of the port's own master,
   bit for bit.  Uni-Mol's gradient norm is dominated by the distance
   head's bias, a sum over every (row, i, j) pair; XLA on the CPU sums that
   bf16 gradient in bf16 and lands 6.3% off its own fp32 norm at update 2,
   while the port (fp32 accumulation, as XLA on a TPU and cuBLAS) stays
   within 0.15% of it; the two bf16 runs are 6.9% apart there.
2. ``from_jax_params`` of JAX bf16 arrays: bf16 tensors of the same bits,
   with ``ml_dtypes`` never imported by the port.
3. ``--fp16`` on the LM against the JAX trainer, as the JAX
   ``tests/test_fp16_overflow.py`` drives it: an init scale of 2**120
   overflows, the update is skipped (parameters, master and EMA unchanged
   bit for bit), the scale halves and the overflow is counted, on both
   sides; a scale pinned at ``--min-loss-scale`` raises
   ``FloatingPointError`` at the metrics flush; clean fp16 updates double
   the scale at each window of 2, as the JAX schedule does.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unicore_tpu.losses import LOSS_REGISTRY as JAX_LOSSES
from unicore_tpu.losses.masked_msa import MaskedMSALoss as JaxMSALoss
from unicore_tpu.losses.unimol import UniMolLoss as JaxUniMolLoss
from unicore_tpu.models.bert import BertModel as JaxBert
from unicore_tpu.models.unimol import UniMolModel as JaxUniMol
from unicore_tpu.parallel.mesh import get_global_mesh, set_global_mesh
from unicore_tpu.parallel.plan import get_global_plan, set_global_plan
from unicore_tpu.tasks.msa_pretrain import MSAPretrainTask as JaxMSATask
from unicore_tpu.tasks.unicore_task import UnicoreTask as JaxTask
from unicore_tpu.tasks.unimol import UniMolTask as JaxUniMolTask
from unicore_tpu.trainer import Trainer as JaxTrainer

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.losses import LOSS_REGISTRY as PORT_LOSSES
from unicore_tpu_torch.losses.masked_msa import MaskedMSALoss as PortMSALoss
from unicore_tpu_torch.losses.unimol import UniMolLoss as PortUniMolLoss
from unicore_tpu_torch.models.bert import BertModel as PortBert
from unicore_tpu_torch.models.evoformer_model import EvoformerModel as PortEvoformer
from unicore_tpu_torch.models.unimol import UniMolModel as PortUniMol
from unicore_tpu_torch.tasks.bert import BertTask as PortBertTask
from unicore_tpu_torch.tasks.msa_pretrain import MSAPretrainTask as PortMSATask
from unicore_tpu_torch.tasks.unimol import UniMolTask as PortUniMolTask
from unicore_tpu_torch.trainer import Trainer as PortTrainer

from test_torch_evoformer_train import TINY as EVO_TINY
from test_torch_evoformer_train import _PerturbedJaxEvoformer, write_msas
from test_torch_lm_train import lm_args, lm_samples, lm_trainers, write_lm_corpus
from test_torch_serve import REPO
from test_torch_train import TINY as BERT_TINY
from test_torch_train import train_args
from test_torch_train_data import write_corpus
from test_torch_unimol import write_conformers


@pytest.fixture(autouse=True)
def _restore_parallel_plan():
    # a JAX Trainer sets the JAX package's process-global parallel plan and
    # mesh: put back what was there, so later tests in this process see it
    # (a plan and a mesh left together shard test_decode's KV pools)
    plan, mesh = get_global_plan(), get_global_mesh()
    yield
    set_global_plan(plan)
    set_global_mesh(mesh)


STEPS, UPDATE_FREQ = 3, 2
LOSS_TOL, GNORM_TOL, MASTER_TOL = 2e-2, 5e-2, 0.1
#: the JAX side's own bf16 drift (module docstring)
GNORM_TOL_FAMILY = {"unimol": 1e-1}
UNIMOL_TINY = dict(encoder_layers=2, encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                   encoder_attention_heads=8, gaussian_kernels=32, dropout=0.0,
                   emb_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def _samples(task, args, batch_size, n):
    task.load_dataset("train")
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=batch_size,
                                  seed=args.seed)
    samples = list(itr.next_epoch_itr(shuffle=True))[:n]
    assert len(samples) == n
    return samples


def _cross(jax_tr, port_model, port_task, port_loss, args, samples):
    """The JAX trainer initialised on ``samples[0]``, the port model loaded
    with its (compute-dtype) weights and the port's trainer around it."""
    jax_tr.init_state(samples[0])
    port_model.load_state_dict(checkpoint_utils.from_jax_params(
        jax.device_get(jax_tr._state["params"])), strict=True)
    return PortTrainer(args, port_task, port_model, port_loss, "cpu")


def family_trainers(family, tmp_path, **over):
    """(jax trainer, port trainer, samples) of ``family`` at tiny widths,
    from the same weights, with ``over`` set on both trainers' args."""
    data = str(tmp_path / family)
    n = STEPS * UPDATE_FREQ
    common = dict(update_freq=[UPDATE_FREQ], max_update=STEPS, total_num_update=STEPS)
    common.update(over)
    if family == "lm":
        write_lm_corpus(data)
        args = lm_args(data, **common)
        samples = lm_samples(args, n)
        jax_tr, port_tr, _ = lm_trainers(args, samples)
        return jax_tr, port_tr, samples
    if family == "bert":
        write_corpus(data, n_docs=24)
        args = train_args(data)
        for k, v in common.items():
            setattr(args, k, v)
        task = PortBertTask.setup_task(args)
        samples = _samples(task, args, 4, n)
        V, pad = len(task.dictionary), task.dictionary.pad()

        class JaxBertTask(JaxTask):
            dictionary = task.dictionary

        jtask = JaxBertTask(args)
        jax_tr = JaxTrainer(args, jtask, JaxBert(vocab_size=V, padding_idx=pad, **BERT_TINY),
                            JAX_LOSSES["masked_lm"](jtask))
        return jax_tr, _cross(jax_tr, PortBert(vocab_size=V, padding_idx=pad, **BERT_TINY),
                              task, PORT_LOSSES["masked_lm"](task), args, samples), samples
    args = train_args(data)
    if family == "unimol":
        write_conformers(data, n=12)
        for k, v in dict(task="unimol", arch="unimol_tiny", loss="unimol",
                         adam_betas="(0.9, 0.99)", mask_prob=0.15, leave_unmasked_prob=0.05,
                         random_token_prob=0.05, noise=1.0, masked_token_loss=1.0,
                         masked_coord_loss=5.0, masked_dist_loss=10.0, **UNIMOL_TINY,
                         **common).items():
            setattr(args, k, v)
        task = PortUniMolTask.setup_task(args)
        samples = _samples(task, args, 2, n)
        V, pad = len(task.dictionary), task.dictionary.pad()
        jtask = JaxUniMolTask.setup_task(args)
        jax_tr = JaxTrainer(args, jtask, JaxUniMol(vocab_size=V, padding_idx=pad,
                                                   **UNIMOL_TINY), JaxUniMolLoss(jtask))
        return jax_tr, _cross(jax_tr, PortUniMol(vocab_size=V, padding_idx=pad, **UNIMOL_TINY),
                              task, PortUniMolLoss(task), args, samples), samples
    assert family == "evoformer"
    write_msas(data, n=12)
    tiny = dict(EVO_TINY, num_blocks=1)
    for k, v in dict(task="msa_pretrain", arch="evoformer_tiny", loss="masked_msa",
                     adam_betas="(0.9, 0.999)", adam_eps=1e-8, mask_prob=0.15,
                     max_msa_rows=8, max_seq_len=48, remat_policy=None,
                     activation_checkpoint=False, **tiny, **common).items():
        setattr(args, k, v)
    task = PortMSATask.setup_task(args)
    samples = _samples(task, args, 2, n)
    V, pad = len(task.dictionary), task.dictionary.pad()
    jtask = JaxMSATask.setup_task(args)
    jax_tr = JaxTrainer(args, jtask, _PerturbedJaxEvoformer(vocab_size=V, padding_idx=pad,
                                                            max_seq_len=48, **tiny),
                        JaxMSALoss(jtask))
    return jax_tr, _cross(jax_tr, PortEvoformer(vocab_size=V, padding_idx=pad, max_seq_len=48,
                                                **tiny),
                          task, PortMSALoss(task), args, samples), samples


def _jax_master(jax_tr):
    return checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["opt"]["master"]))


def _macc(jax_tr):
    return {k: float(v) for k, v in jax.device_get(jax_tr._macc).items()}


# ---------------------------------------------------------------------------
# 1. three bf16 updates through both trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["bert", "unimol", "evoformer", "lm"])
def test_bf16_updates_match_jax(family, tmp_path):
    jax_tr, port_tr, samples = family_trainers(family, tmp_path, bf16=True)
    ref0 = checkpoint_utils.from_jax_params(jax.device_get(jax_tr._state["params"]))
    for n, p in port_tr.params.items():
        assert p.dtype == ref0[n].dtype == torch.bfloat16, n
        assert torch.equal(p.detach().view(torch.int16), ref0[n].view(torch.int16)), n
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    prev = {"loss": 0.0, "sample_size": 0.0, "gnorm": 0.0}
    for step in range(STEPS):
        jm0, pm0 = _jax_master(jax_tr), {n: m.clone() for n, m in port_tr._optimizer.master.items()}
        group = samples[step * UPDATE_FREQ:(step + 1) * UPDATE_FREQ]
        jax_tr.train_step(group)
        gnorm = port_tr.train_step(group)
        macc = _macc(jax_tr)
        jax_loss = ((macc["loss"] - prev["loss"])
                    / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
        jax_gnorm = macc["gnorm"] - prev["gnorm"]
        prev = macc
        assert abs(port_tr.update_losses[-1] - jax_loss) <= LOSS_TOL * abs(jax_loss), \
            (step, port_tr.update_losses[-1], jax_loss)
        tol = GNORM_TOL_FAMILY.get(family, GNORM_TOL)
        assert abs(gnorm - jax_gnorm) <= tol * jax_gnorm, (step, gnorm, jax_gnorm)
        jm1 = _jax_master(jax_tr)
        diff = ref = 0.0
        for n, m in port_tr._optimizer.master.items():
            dj, dp = jm1[n] - jm0[n], m - pm0[n]
            diff += float((dp - dj).square().sum())
            ref += float(dj.square().sum())
        assert math.sqrt(diff) <= MASTER_TOL * math.sqrt(ref), (step, diff, ref)
        assert (ref > 0) == (port_tr.update_lrs[-1] > 0), step  # warmup starts at lr 0
    for n, p in port_tr.params.items():
        assert torch.equal(p.detach(), port_tr._optimizer.master[n].to(torch.bfloat16)), n


# ---------------------------------------------------------------------------
# 2. from_jax_params on bf16 arrays
# ---------------------------------------------------------------------------

def test_from_jax_params_keeps_bf16_bits():
    r = np.random.default_rng(0)
    x = jnp.asarray(r.standard_normal((5, 3)).astype(np.float32)).astype(jnp.bfloat16)
    b = jnp.asarray(np.array([0.0, -0.0, 3.3895e38, -1e-40], np.float32)).astype(jnp.bfloat16)
    tree = jax.device_get({"fc": {"kernel": x, "bias": b}, "ln": {"weight": x[0]}})
    out = checkpoint_utils.from_jax_params(tree)
    bits = lambda a: np.asarray(a).view(np.int16)  # noqa: E731
    assert out["fc.weight"].dtype == out["fc.bias"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["fc.weight"].view(torch.int16).numpy(), bits(x).T)
    np.testing.assert_array_equal(out["fc.bias"].view(torch.int16).numpy(), bits(b))
    np.testing.assert_array_equal(out["ln.weight"].view(torch.int16).numpy(), bits(x[0]))
    code = ("import sys, numpy as np, torch\n"
            "from unicore_tpu_torch import checkpoint_utils\n"
            "checkpoint_utils.from_jax_params({'w': np.ones(2, np.float32)})\n"
            "assert 'ml_dtypes' not in sys.modules, 'the port imported ml_dtypes'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# 3. the fp16 loss scale
# ---------------------------------------------------------------------------

def test_fp16_overflow_skips_halves_and_counts_as_jax(tmp_path):
    jax_tr, port_tr, samples = family_trainers(
        "lm", tmp_path, fp16=True, fp16_init_scale=2 ** 120, fp16_scale_window=4,
        ema_decay=0.9)
    for n, p in port_tr.params.items():
        assert p.dtype == torch.float16, n
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    params = {n: p.detach().clone() for n, p in port_tr.params.items()}
    master = {n: m.clone() for n, m in port_tr._optimizer.master.items()}
    ema = {n: e.clone() for n, e in port_tr.ema.shadow.items()}
    jax_tr.train_step(samples[:2])
    gnorm = port_tr.train_step(samples[:2])
    assert not math.isfinite(gnorm)
    assert port_tr.get_loss_scale() == float(jax.device_get(jax_tr._state["loss_scale"])) \
        == 2.0 ** 119
    assert port_tr.overflows == 1 and _macc(jax_tr)["overflow"] == 1.0
    assert port_tr._optimizer.num_steps == 0 and port_tr.get_num_updates() == 1
    for n in params:
        assert torch.equal(port_tr.params[n].detach(), params[n]), n
        assert torch.equal(port_tr._optimizer.master[n], master[n]), n
        assert torch.equal(port_tr.ema.shadow[n], ema[n]), n
    port_tr.flush_metrics()  # an overflow that did not pin does not raise


def test_fp16_pinned_scale_raises_at_flush(tmp_path):
    jax_tr, port_tr, samples = family_trainers(
        "lm", tmp_path, fp16=True, fp16_init_scale=2 ** 120, min_loss_scale=2.0 ** 119)
    port_tr.begin_epoch(1)
    port_tr.train_step(samples[:2])
    with pytest.raises(FloatingPointError, match="Minimum loss scale"):
        port_tr.flush_metrics()
    port_tr.flush_metrics()  # raised once for the event
    jax_tr.begin_epoch(1)
    jax_tr.train_step(samples[:2])
    with pytest.raises(FloatingPointError, match="Minimum loss scale"):
        jax_tr.flush_metrics()


def test_fp16_clean_updates_grow_the_scale_at_the_window(tmp_path):
    jax_tr, port_tr, samples = family_trainers(
        "lm", tmp_path, fp16=True, fp16_init_scale=4, fp16_scale_window=2)
    jax_tr.begin_epoch(1)
    port_tr.begin_epoch(1)
    scales = []
    for step in range(STEPS):
        group = samples[step * UPDATE_FREQ:(step + 1) * UPDATE_FREQ]
        jax_tr.train_step(group)
        port_tr.train_step(group)
        scales.append(port_tr.get_loss_scale())
        assert scales[-1] == float(jax.device_get(jax_tr._state["loss_scale"])), step
    assert scales == [4.0, 8.0, 8.0] and port_tr.update_loss_scales == [4.0, 4.0, 8.0]
    assert port_tr.overflows == 0 and _macc(jax_tr)["overflow"] == 0.0
    assert port_tr._optimizer.num_steps == STEPS
