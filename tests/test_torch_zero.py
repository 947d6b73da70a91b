"""ZeRO in the port (``--zero-stage`` 1/2/3, ``unicore_tpu_torch/parallel/zero.py``)
against its own stage 0 and against the JAX package.

One 2-rank gloo job (``tests/torch_dp_ranks.py zero``), spawned once for the
module through the port's ``call_main``, runs every leg of
``torch_dp_ranks.ZERO_LEGS`` through the train CLI's ``main``: ``bert_tiny``,
3 updates, each leg from the JAX trainer's initial weights.  Each leg
reports its losses, gradient norms, a sha256 of the parameters and of the
optimizer state gathered whole (``m``, ``v``, the master) and each rank's
memory.  Each ``*_s0`` leg keeps its reduced gradients, and the sharded
legs of its kind update from them (``tools/dp_pair.py``
``replay_gradients``, after their own reduction): two training runs on a
busy CPU differ in the gradient's last bits (the products' threading), so
the stages are held against stage 0 on the same gradients, and each leg's
own reduced gradient against stage 0's within 1e-5 absolute.

What holds, and how closely:

- the stages against stage 0 at clip 0 and at clip 1: the same bits in the
  parameters, ``m``, ``v`` and the norms, the losses within 1e-6 relative
  (each leg's own forward).  The norm is stage
  0's bits at stages 2/3 too: K-a's partials are fixed spans of the buffer,
  each rank's segment starts at a multiple of the span, and the gathered
  partials fold in stage 0's order;
- ``--bf16 --bf16-sr`` stage 3 against stage 0: the same bits (the SR
  noise counted from each element's place in the whole buffer);
- the per-tensor path at stage 1 (with the EMA) and ``--grad-accum adama``
  at stage 2 (clip 0, the state split per tensor): the same bits, but
  adama's norm only within 1e-6 relative: its sharded norm sums the
  slices' squares over the ranks, another order than the per-tensor norms;
- the port at stage 2 against the JAX ``Trainer`` at
  ``--data-parallel-size 2 --zero-stage 2 --fused-adam``: losses 1e-4
  relative, gradient norms 1e-4, parameters 1e-5, as
  ``tests/test_torch_dp_train.py``;
- a checkpoint's gather (``state_dict(dst=0)``) reaches rank 0 alone,
  with the state and EMA the all-gather gives;
- a stage-2 save resumed at one rank (stage 0) and at two (stage 1): the
  loaded ``m``, ``v``, master, EMA and step count the saved bits;
- a sentinel rewind at stage 2: the restored state stage 0's, bit for bit;
- each rank's optimizer-state bytes: half of stage 0's, plus at most half
  the padding (the flat layout), or exactly each tensor's slice (the
  per-tensor layout).
"""

import json
import math
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from unicore_tpu.parallel import mesh as jax_mesh
from unicore_tpu.parallel import plan as jax_plan
from unicore_tpu.parallel import sharding as jax_sharding

from unicore_tpu_torch import checkpoint_utils
from unicore_tpu_torch.optim import multi_tensor as mt
from unicore_tpu_torch.parallel import zero

import torch_trainer_pair as pair
from unicore_tpu_torch.tools.dp_pair import state_digests

from torch_dp_ranks import _parse, train_argv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPDATES = 3
LOSS_REL, PARAM_ABS, GNORM_REL = 1e-4, 1e-5, 1e-4
#: adama's sharded norm against its unsharded one
ADAMA_GNORM_REL = 1e-6
#: a sharded leg's own reduced gradient (reduce-scatter or all-reduce)
#: against its stage-0 leg's, before the replay
GRAD_ABS = 1e-5
#: a leg's losses against its stage-0 leg's: the forward of two runs on a
#: busy CPU differs in the last bits (5e-8 relative seen)
RUN_LOSS_REL = 1e-6


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    plan, mesh = jax_plan.get_global_plan(), jax_mesh.get_global_mesh()
    root = tmp_path_factory.mktemp("zero")
    args, task, _, _, variables = pair.setup(root, 2 * UPDATES, n_docs=48)
    # the JAX trainer pair.setup built set the JAX package's globals
    jax_plan.set_global_plan(plan)
    jax_mesh.set_global_mesh(mesh)
    init = str(root / "init.pt")
    checkpoint_utils.write_checkpoint(init, args, checkpoint_utils.from_jax_params(variables))
    out = root / "out"
    out.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "torch_dp_ranks.py"),
                           "zero", str(out), args.data, init],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    ranks = [json.load(open(out / f"zero_rank{r}.json")) for r in range(2)]
    return dict(out=out, ranks=ranks, legs=ranks[0]["legs"], args=args, task=task,
                variables=variables, data=args.data, root=root)


def _same_leg(job, a, b, gnorm=True):
    la, lb = job["legs"][a], job["legs"][b]
    for r in range(2):  # the leg's own gradients, then stage 0's in their place
        diffs = job["ranks"][r]["legs"][a]["grad_max_abs_diff"]
        assert diffs and max(diffs) <= GRAD_ABS, (a, r, diffs)
    assert la["param_sha256"] == lb["param_sha256"]
    assert la["state"] == lb["state"]
    _close_losses(la["losses"], lb["losses"])
    if gnorm:
        assert la["gnorms"] == lb["gnorms"]
    for leg in (a, b):  # the ranks the same bits
        assert job["ranks"][1]["legs"][leg]["param_sha256"] == job["legs"][leg]["param_sha256"]
        assert len({r["param_sha256"] for r in job["legs"][leg]["ranks"]}) == 1


def _close_losses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g - w) <= RUN_LOSS_REL * abs(w), (got, want)


# -- (a) the flags ----------------------------------------------------------------

@pytest.mark.parametrize("stage,shim,fused", [
    (0, False, False), (1, False, False), (0, True, False), (3, True, True),
    (2, False, True), (2, False, False), (3, True, False),
])
def test_resolve_zero_stage_matches_jax(stage, shim, fused):
    args = Namespace(zero_stage=stage, zero_shard_optimizer=shim, fused_adam=fused)
    try:
        want = jax_sharding.resolve_zero_stage(args)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            zero.resolve_zero_stage(args)
        assert str(got.value) == str(err)
        return
    assert zero.resolve_zero_stage(args) == want


def test_shim_warns_once_as_jax(monkeypatch, caplog):
    monkeypatch.setattr(zero, "_zero_shim_warned", False)
    monkeypatch.setattr(jax_sharding, "_zero_shim_warned", False)
    args = Namespace(zero_stage=0, zero_shard_optimizer=True, fused_adam=False)
    with caplog.at_level("WARNING"):
        for _ in range(3):
            assert zero.resolve_zero_stage(args) == 1
            jax_sharding.resolve_zero_stage(args)
    port = [r.getMessage() for r in caplog.records if r.name == zero.logger.name]
    ref = [r.getMessage() for r in caplog.records if r.name == jax_sharding.logger.name]
    assert len(port) == 1 and port == ref


# -- (b) the per-tensor rule ---------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_split_dim_matches_zero1_pspecs(job, world):
    import jax
    import jax.numpy as jnp

    from unicore_tpu.parallel import make_mesh

    model = pair.port_trainer(job["args"], job["task"], job["variables"]).model
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    # and shapes no dim of which the world divides, or only a later one
    shapes.update({"odd": (3, 5), "odd_1d": (7,), "later": (3, 8), "small": (1, 2)})
    mesh = make_mesh(data=world, devices=jax.devices()[:world])
    specs = jax_sharding.zero1_pspecs({n: jnp.zeros(s) for n, s in shapes.items()}, mesh)
    for n, shape in shapes.items():
        want = next((d for d, e in enumerate(specs[n]) if e is not None), None)
        assert zero.split_dim(shape, world) == want, (n, shape, specs[n])
    assert zero.split_dim((3, 5), world) is None and zero.split_dim((3, 8), world) == 1


# -- (c)-(f) the stages against stage 0 ------------------------------------------------

@pytest.mark.parametrize("leg", ["clip0_s1", "clip0_s2", "clip0_s3", "clip1_s1", "clip1_s2"])
def test_stages_give_stage0_bits(job, leg):
    clip = leg.split("_")[0]
    _same_leg(job, f"fused_{leg}", f"fused_{clip}_s0")
    got = job["legs"][f"fused_{leg}"]
    stage = int(leg[-1])
    assert got["memory"]["zero_stage"] == stage and got["memory"]["zero_sharded"]
    assert got["reduction"]["reduce_scatter"] == (stage >= 2)
    assert got["local_keys"] == ["flat.0"]  # the rank's segment, not per name
    assert all(math.isfinite(x) for x in got["losses"] + got["gnorms"])


def test_bf16_sr_stage3_gives_stage0_bits(job):
    _same_leg(job, "bf16sr_s3", "bf16sr_s0")
    assert "master" in job["legs"]["bf16sr_s3"]["state"]


def test_per_tensor_stage1_gives_stage0_bits(job):
    _same_leg(job, "tensor_s1", "tensor_s0")
    assert job["legs"]["tensor_s1"]["ema_sha256"] == job["legs"]["tensor_s0"]["ema_sha256"]
    assert not job["legs"]["tensor_s1"]["reduction"]["reduce_scatter"]


def test_adama_stage2_gives_stage0_bits(job):
    _same_leg(job, "adama_s2", "adama_s0", gnorm=False)
    got, want = job["legs"]["adama_s2"]["gnorms"], job["legs"]["adama_s0"]["gnorms"]
    for g, w in zip(got, want):
        assert abs(g - w) <= ADAMA_GNORM_REL * abs(w), (got, want)
    # adama keeps the per-tensor rule under --fused-adam
    assert job["legs"]["adama_s2"]["local_keys"] != ["flat.0"]


# -- (g) against the JAX trainer at --zero-stage 2 ------------------------------------------

@pytest.fixture(scope="module")
def jax_zero2(job):
    import jax

    from test_torch_dp_train import _concat, _jax_dp2

    plan, mesh = jax_plan.get_global_plan(), jax_mesh.get_global_mesh()
    args, task = job["args"], job["task"]
    itr = task.get_batch_iterator(task.dataset("train"), batch_size=4, seed=1, epoch=1)
    batches = list(itr.next_epoch_itr(shuffle=True))
    groups = [_concat(batches[2 * u], batches[2 * u + 1]) for u in range(UPDATES)]
    real = pair.train_args

    def zero2_args(data):
        a = real(data)
        a.zero_stage, a.fused_adam = 2, True
        return a

    pair.train_args = zero2_args
    try:
        tr = _jax_dp2(args, task, job["variables"])
        assert tr.zero_stage == 2
        tr.init_state(groups[0])
        tr.begin_epoch(1)
        losses, gnorms, prev = [], [], {"loss": 0.0, "sample_size": 0.0, "gnorm": 0.0}
        for g in groups:
            tr.train_step([g])
            macc = {k: float(v) for k, v in jax.device_get(tr._macc).items()}
            losses.append((macc["loss"] - prev["loss"])
                          / (macc["sample_size"] - prev["sample_size"]) / math.log(2))
            gnorms.append(macc["gnorm"] - prev["gnorm"])
            prev = macc
        params = checkpoint_utils.from_jax_params(jax.device_get(tr._state["params"]))
    finally:
        pair.train_args = real
        jax_plan.set_global_plan(plan)
        jax_mesh.set_global_mesh(mesh)
    return losses, gnorms, {n: t.numpy() for n, t in params.items()}


def test_stage2_matches_jax_trainer(job, jax_zero2):
    losses, gnorms, params = jax_zero2
    got = job["legs"]["fused_clip1_s2"]
    for g, w in zip(got["losses"], losses):
        assert abs(g - w) <= LOSS_REL * abs(w), (got["losses"], losses)
    for g, w in zip(got["gnorms"], gnorms):
        assert abs(g - w) <= GNORM_REL * abs(w), (got["gnorms"], gnorms)
    mine = dict(np.load(job["out"] / "zero_params_rank0.npz"))
    assert mine.keys() == params.keys()
    worst = max(float(np.abs(mine[n] - params[n]).max()) for n in params)
    assert worst <= PARAM_ABS, worst


# -- (h) checkpoints reshard ----------------------------------------------------------

def _saved(job):
    return checkpoint_utils.load_checkpoint_to_cpu(
        str(job["out"] / "save_s2_rank0" / "checkpoint_last.pt"))


def test_stage2_save_resumes_at_one_rank_stage0(job, caplog):
    from unicore_tpu_torch import tasks
    from unicore_tpu_torch.trainer import Trainer

    saved = _saved(job)
    assert saved["args"].zero_stage == 2 and saved["optimizer_state"]["num_steps"] == UPDATES
    a = _parse(train_argv(job["data"], str(job["root"] / "one"), "--fused-adam", "--bf16",
                          "--ema-decay", "0.9"))
    task = tasks.setup_task(a)
    tr = Trainer(a, task, task.build_model(a), task.build_loss(a), "cpu")
    assert tr.zero is None
    with caplog.at_level("INFO"):
        tr.load_checkpoint(str(job["out"] / "save_s2_rank0" / "checkpoint_last.pt"))
    assert any("saved by 2 rank(s) at --zero-stage 2, loaded by 1 at --zero-stage 0"
               in r.getMessage() for r in caplog.records)
    got = tr._optimizer.state_dict()
    assert got["num_steps"] == UPDATES and tr.get_num_updates() == UPDATES
    for part in ("state", "master"):
        want = saved["optimizer_state"][part]
        for n, t in want.items():
            pieces = t.items() if part == "state" else [("master", t)]
            mine = got[part][n]
            for k, w in pieces:
                g = mine[k] if part == "state" else mine
                assert torch.equal(g.view(torch.int32), w.view(torch.int32)), (part, n, k)
    for n, e in tr.ema.shadow.items():
        assert torch.equal(e, saved["ema"][n]), n
    assert state_digests(got) == job["legs"]["save_s2"]["state"]


@pytest.mark.parametrize("leg", ["fused_clip0_s2", "bf16sr_s3", "tensor_s1"])
def test_checkpoint_gather_reaches_rank0_alone(job, leg):
    """``state_dict(dst=0)`` (a checkpoint's gather) gives rank 0 the state
    and EMA the all-gather gives, and rank 1 nothing."""
    mine = [job["ranks"][r]["legs"][leg] for r in range(2)]
    assert mine[0]["dst0_state"] == mine[0]["state"] == mine[1]["state"]
    assert mine[1]["dst0_state"] is None
    if "ema_sha256" in mine[0]:
        assert mine[0]["dst0_ema_sha256"] == mine[0]["ema_sha256"]
        assert mine[1]["dst0_ema_sha256"] is None


def test_stage2_save_resumes_at_two_ranks_stage1(job):
    got = [job["ranks"][r]["reload_s1"] for r in range(2)]
    assert got[0]["state"] == got[1]["state"]
    assert got[0]["state"] == job["legs"]["save_s2"]["state"]
    assert got[0]["ema_sha256"] == job["legs"]["save_s2"]["ema_sha256"]
    assert got[0]["updates"] == UPDATES
    assert got[0]["memory"]["zero_stage"] == 1 and got[0]["memory"]["zero_sharded"]


# -- (i) rewinds ---------------------------------------------------------------------

def test_stage2_rewind_restores_stage0_state(job):
    r0, r2 = job["legs"]["rewind_s0"], job["legs"]["rewind_s2"]
    assert len(r2["restored"]) == 1 and r2["restored"] == r0["restored"]
    assert r2["param_sha256"] == r0["param_sha256"] and r2["state"] == r0["state"]
    # the losses of the kept trajectory: before the spike, and from the
    # rewind on (the spike on rank 1 alone leaves the abandoned updates'
    # states apart: each rank normalised by its own denominator)
    ids = r2["update_ids"]
    back = next(i for i in range(1, len(ids)) if ids[i] <= ids[i - 1])
    assert ids == r0["update_ids"] and ids[back] == r2["restored"][0]["step"] + 1
    spike = r2["restored"][0]["step"]
    _close_losses(r2["losses"][:spike], r0["losses"][:spike])
    _close_losses(r2["losses"][back:], r0["losses"][back:])
    for r in range(2):
        assert job["ranks"][r]["legs"]["rewind_s2"]["restored"] == r2["restored"]


# -- (j) each rank's state bytes ----------------------------------------------------------

def test_flat_state_bytes_are_half_plus_padding(job):
    n = sum(t.numel() for t in checkpoint_utils.from_jax_params(job["variables"]).values())
    for leg, buffers in (("fused_clip0_s1", 2), ("fused_clip0_s2", 2), ("bf16sr_s3", 3)):
        base = job["legs"][leg.replace("_s1", "_s0").replace("_s2", "_s0").replace("_s3", "_s0")]
        whole = base["memory"]["optimizer_state_bytes"]
        numel = whole // (4 * buffers)
        assert numel >= n and numel - n < mt.ALIGN * 64  # the parameters, ALIGN-rounded
        padded = -(-numel // (2 * mt.NORM_SPAN)) * 2 * mt.NORM_SPAN
        for r in job["legs"][leg]["ranks"]:
            mine = r["memory"]["optimizer_state_bytes"]
            assert 0 <= mine - whole / 2 <= (padded - numel) * 4 * buffers / 2, (leg, mine)
            assert mine == padded // 2 * 4 * buffers


def test_tensor_state_bytes_are_each_slice(job):
    model = pair.port_trainer(job["args"], job["task"], job["variables"]).model
    want = sum(p.numel() // (2 if zero.split_dim(p.shape, 2) is not None else 1)
               for p in model.parameters()) * 4 * 2
    for r in job["legs"]["tensor_s1"]["ranks"]:
        assert r["memory"]["optimizer_state_bytes"] == want
    assert job["legs"]["tensor_s0"]["memory"]["optimizer_state_bytes"] == \
        sum(p.numel() for p in model.parameters()) * 4 * 2
    assert job["legs"]["tensor_s1"]["memory"]["ema_bytes"] * 2 == want


# -- (k) the plain versions of the segment modes ------------------------------------------------

def _group(n, seed):
    g = torch.Generator().manual_seed(seed)
    sizes = [3 * mt.CHUNK + 5, 1000, n - 3 * mt.CHUNK - 1008]
    named = {f"t{i}": torch.randn(s, generator=g) for i, s in enumerate(sizes)}
    decay = {"t0": True, "t1": False, "t2": True}
    return mt.FlatPlan.build(named, decay, pad=2 * mt.NORM_SPAN).groups[0], named


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "bfloat16_sr"])
def test_plain_adam_on_segments_equals_whole(kind):
    """K-b's plain version on each rank's segment (offset, clipped chunk
    table) gives the whole buffer's bits, SR noise included."""
    group, named = _group(70_001, 3)
    n = group.padded
    g = torch.Generator().manual_seed(4)
    master = group.flatten(named)
    m = torch.randn(n, generator=g) * 1e-3
    v = torch.rand(n, generator=g) * 1e-6
    grad = group.flatten({k: torch.randn(t.shape, generator=g) * 1e-3 for k, t in named.items()})
    param = None if kind == "float32" else master.to(torch.bfloat16)
    hp = mt.AdamHyper(0.9, 0.98, 1e-6, 1e-4, 0.01, 1.0 - 1e-6)
    kw = dict(denom=torch.tensor(3.0), gnorm=torch.tensor(2.0), max_norm=1.0,
              sr_key=(0x1234567, 0x89) if kind == "bfloat16_sr" else None, buffer_id=1)
    whole = [t.clone() if t is not None else None for t in (master, m, v, param)]
    mt.adam_group(*whole[:3], grad, group, hp, whole[3], **kw)
    segs = [t.clone() if t is not None else None for t in (master, m, v, param)]
    half = n // 2
    for start in (0, half):
        sl = [t[start:start + half] if t is not None else None for t in segs]
        mt.adam_group(*sl[:3], grad[start:start + half], group, hp, sl[3], offset=start, **kw)
    for a, b in zip(whole, segs):
        if a is not None:
            assert torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                               b.view(torch.int16 if b.element_size() == 2 else torch.int32))


@pytest.mark.parametrize("n", [70_001, 3 * mt.NORM_SPAN])
def test_plain_l2norm_partials_on_segments_equal_whole(n):
    """K-a's sum-of-squares mode on each rank's segment of the padded
    buffer, the partials in rank order cut to the whole buffer's count,
    then stage 2 alone: the whole buffer's norm bit for bit."""
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 1e-3
    denom = torch.tensor(3.0)
    whole = mt.multi_tensor_l2norm([x], denom)
    padded = mt.pad_to(x, 2 * mt.NORM_SPAN)
    half = padded.numel() // 2
    parts = torch.cat([mt.l2norm_partials([padded[a:a + half]], denom) for a in (0, half)])
    got = mt.l2norm_final(parts[:mt.norm_partials(n)])
    assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
    assert abs(float(whole) - float(torch.linalg.vector_norm(x / denom))) <= 1e-6 * float(whole)
