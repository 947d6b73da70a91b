"""The gloo ranks of the port's data-parallel tests, started once per test
file: ``python tests/torch_dp_ranks.py JOB OUT_DIR [ARGS...]`` spawns the
job's ranks through the port's ``distributed_utils.call_main`` (as the
train CLI does), each of which runs every scenario of the job and writes
its results under OUT_DIR.  The ranks import torch, numpy and the port,
never the JAX package; the test files hold the results against it.

Jobs:

* ``hierarchy`` (4 ranks, pods=2 x data=2): the port's
  ``two_level_reduce`` in {sum, adasum} x {deterministic, not} on the
  inputs of :func:`reduce_inputs`, and at pods=2 x data=1 (ranks 0 and 1)
  the two-level sum beside the flat all-reduce.
* ``train`` (2 ranks): the scenarios of ``tests/test_torch_dp_train.py``
  through the train CLI's ``main``, one after the other in the same group:
  ``dp``, the dropout masks, ``tail``, ``spike``, the divergent proposals,
  ``stop`` and its resume, the journal.
* ``zero`` (2 ranks): the ZeRO legs of ``tests/test_torch_zero.py``
  (:data:`ZERO_LEGS`) through the train CLI's ``main``, each from the same
  weights; per leg the losses, norms, parameters' and gathered optimizer
  state's digests and each rank's memory; the stage-2 save reloaded at two
  ranks and stage 1; a sentinel rewind at stages 0 and 2.
"""

import json
import os
import sys
from argparse import Namespace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the flat buffer's length in the reduction job: odd, so the reduce-scatter
#: pads it
REDUCE_LEN = 1031
#: (name, pods, pod_size, mode, deterministic) of the reduction job
REDUCE_CASES = [(f"{mode}_{'det' if det else 'free'}", 2, 2, mode, det)
                for mode in ("sum", "adasum") for det in (False, True)]


def reduce_inputs(n_ranks, seed=1):
    """Each rank's flat buffer (one row a rank), the same on both sides."""
    return np.random.RandomState(seed).randn(n_ranks, REDUCE_LEN).astype(np.float32)


def _rank_args(world, **kw):
    base = dict(device="cpu", distributed_backend="gloo", distributed_world_size=world,
                distributed_rank=0, distributed_init_method=None, distributed_port=-1,
                distributed_no_spawn=False, device_id=0, data_parallel_size=-1,
                num_pods=1, xpod_combine="sum", deterministic_reductions=False,
                zero_stage=0)
    base.update(kw)
    return Namespace(**base)


# ---------------------------------------------------------------------------
# the reduction job
# ---------------------------------------------------------------------------

def hierarchy_main(args, out_dir):
    import torch
    import torch.distributed as dist

    from unicore_tpu_torch.parallel import groups
    from unicore_tpu_torch.parallel import hierarchy as H

    rank = dist.get_rank()
    x = torch.from_numpy(reduce_inputs(4)[rank].copy())
    res = {}
    for name, pods, pod_size, mode, det in REDUCE_CASES:
        (out,) = H.two_level_reduce(
            [x], n_pods=pods, pod_size=pod_size, mode=mode, deterministic=det,
            inpod_group=groups.inpod_group(), xpod_group=groups.xpod_group(),
            data_index=groups.data_index())
        res[name] = out.numpy()
    # pods=2 x data=1 on ranks 0 and 1: every rank creates every group
    pair = dist.new_group([0, 1])
    singles = [dist.new_group([r]) for r in range(4)]
    if rank < 2:
        y = torch.from_numpy(reduce_inputs(2, seed=2)[rank].copy())
        flat = y.clone()
        dist.all_reduce(flat, group=pair)
        res["pair_flat"] = flat.numpy()
        for det in (False, True):
            (two,) = H.two_level_reduce([y], n_pods=2, pod_size=1, mode="sum",
                                        deterministic=det, inpod_group=singles[rank],
                                        xpod_group=pair, data_index=0)
            res[f"pair_sum_{'det' if det else 'free'}"] = two.numpy()
    # the trainer's reducer on this job's plan (--num-pods 2, adasum)
    reducer = H.GradReducer(groups.plan())
    grads = {"a": x[:1000].clone().view(40, 25), "b": x[1000:].clone()}
    got = reducer.reduce_grads(grads)
    res["reducer"] = torch.cat([got["a"].reshape(-1), got["b"]]).numpy()
    res["reducer_two_level"] = np.asarray(reducer.two_level)
    res["reducer_dcn_bytes"] = np.asarray(reducer.dcn_bytes)
    # the rank queries and the host collectives of distributed/utils.py
    from unicore_tpu_torch.distributed import utils as du

    t = torch.full((3,), float(rank))
    du.broadcast_tensors([t], src_rank=1)
    du.barrier("hierarchy")
    res["queries"] = np.asarray([du.get_world_size(), du.get_global_rank(),
                                 du.get_data_parallel_world_size(),
                                 du.get_data_parallel_rank(), du.get_pod_count(),
                                 du.get_pod_index(), int(du.is_master())])
    res["all_reduce_max"] = du.all_reduce([rank, -rank], op="max")
    res["all_reduce_dict"] = np.asarray(list(du.all_reduce_dict({"a": rank, "b": 1.5}).values()))
    res["all_gather_list"] = np.asarray([len(x) for x in du.all_gather_list("r" * rank)])
    res["broadcast_object"] = np.asarray(du.broadcast_object([rank, "x"] if rank == 2 else None,
                                                             2)[0])
    res["broadcast_tensors"] = t.numpy()
    np.savez(os.path.join(out_dir, f"hierarchy_rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# the training job
# ---------------------------------------------------------------------------

#: the spike scenario: the update rank 1's loss is multiplied at, and the
#: run's length
SPIKE_AT, SPIKE_UPDATES = 9, 14


def train_argv(data, save_dir, *extra, updates=3, validate=False):
    """The train CLI's arguments of a ``bert_tiny`` run of ``updates``
    updates (the setup of ``tests/test_torch_train.py``, dropouts 0); with
    ``validate``, one validation on the ``train`` split at the end, else
    none."""
    return [data, "--task", "bert", "--loss", "masked_lm", "--arch", "bert_tiny",
            "--optimizer", "adam", "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-6",
            "--clip-norm", "1.0", "--weight-decay", "1e-4",
            "--lr-scheduler", "polynomial_decay", "--lr", "1e-3",
            "--warmup-updates", "1", "--total-num-update", str(updates),
            "--max-update", str(updates), "--batch-size", "4",
            "--log-interval", "1", "--num-workers", "0", "--seq-pad-multiple", "128",
            "--seed", "1", "--device", "cpu", "--dropout", "0", "--attention-dropout", "0",
            "--emb-dropout", "0", "--save-dir", save_dir, "--tmp-save-dir", save_dir,
            *(["--valid-subset", "train"] if validate else ["--disable-validation"]), *extra]


def _parse(argv):
    from unicore_tpu_torch import options

    return options.parse_args_and_arch(options.get_training_parser(), argv)


def _params(model):
    return {n: p.detach().clone().numpy() for n, p in model.named_parameters()}


def train_main(args, out_dir, data, tail_data, init):
    import torch
    import torch.distributed as dist

    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.distributed import chaos, guard
    from unicore_tpu_torch.health import sentinel as sentinel_mod
    from unicore_tpu_torch.modules import dropout as dropout_mod
    from unicore_tpu_torch.telemetry import journal
    from unicore_tpu_torch.trainer import Trainer

    rank = dist.get_rank()
    res = {"rank": rank}
    device = torch.device("cpu")
    holder = {}
    real_init = Trainer.__init__

    def keep(self, *a, **kw):  # the last trainer a run built
        real_init(self, *a, **kw)
        holder["trainer"] = self

    Trainer.__init__ = keep

    def run(save_dir, *extra, updates=3, corpus=data, validate=False):
        a = _parse(train_argv(corpus, save_dir, *extra, updates=updates, validate=validate))
        a.distributed_world_size = args.distributed_world_size
        stats = cli.main(a, device)
        return stats, holder["trainer"]

    def listing(d):
        # the checkpoints (every rank journals into <save-dir>/telemetry)
        return sorted(set(os.listdir(d)) - {"telemetry"}) if os.path.isdir(d) else []

    # dp: 3 updates from the JAX weights, dropouts 0, the parameters'
    # digest after each; each rank its own --save-dir, so only rank 0's may
    # hold a checkpoint
    real_step = Trainer.train_step
    digests = []

    def step_and_digest(self, samples):
        out = real_step(self, samples)
        digests.append(cli.param_digest(self.model))
        return out

    dp_dir = os.path.join(out_dir, f"dp_rank{rank}")
    Trainer.train_step = step_and_digest
    try:
        stats, tr = run(dp_dir, "--finetune-from-model", init, validate=True)
    finally:
        Trainer.train_step = real_step
    res["dp"] = {"losses": stats["loss_per_update"], "gnorms": stats["gnorm_per_update"],
                 "digests": digests, "validations": stats["validations"],
                 "micro_batches": stats["micro_batches"],
                 "distributed": stats.get("distributed"), "ranks": stats.get("ranks"),
                 "files": listing(dp_dir)}
    np.savez(os.path.join(out_dir, f"dp_params_rank{rank}.npz"), **_params(tr.model))

    # dropout: the keep mask each rank draws at p > 0 (micro-batch 0's stream)
    keep_mask = dropout_mod.dropout(torch.ones(4096), 0.5, True, tr._rng(0))
    res["dropout_mask"] = (keep_mask > 0).numpy().astype(int).tolist()

    # tail: an epoch of 7 batches at --update-freq 2: rank 1's second update
    # runs the dummy batch
    stats, tr = run(os.path.join(out_dir, "tail"), "--max-epoch", "1", "--update-freq", "2",
                    updates=100, corpus=tail_data)
    res["tail"] = {"losses": stats["loss_per_update"], "micro_batches": stats["micro_batches"],
                   "micro_batch_lengths": stats["micro_batch_lengths"],
                   "samples": tr.samples, "updates": stats["updates"],
                   "ranks": stats.get("ranks")}

    # spike: a loss spike on rank 1 alone, at update SPIKE_AT
    real_mult = chaos.fault_multipliers
    fired = []

    def spike(step):  # once, as the loss-spike kind: a rewind replays the step
        if rank == 1 and step == SPIKE_AT and not fired:
            fired.append(step)
            return 1000.0, 1.0
        return real_mult(step)

    chaos.fault_multipliers = spike
    try:
        stats, tr = run(os.path.join(out_dir, "spike"), "--sentinel-interval", "1",
                        "--snapshot-interval", "3", "--snapshot-keep", "2",
                        "--sentinel-warmup", "4", "--loss-spike-window", "8",
                        "--loss-spike-zmax", "6", "--spike-skip-updates", "2",
                        updates=SPIKE_UPDATES)
    finally:
        chaos.fault_multipliers = real_mult
    res["spike"] = {"events": stats["sentinel_events"], "update_ids": stats["update_ids"],
                    "losses": stats["loss_per_update"], "ranks": stats.get("ranks")}

    # divergent: the ranks propose different recoveries
    sent = sentinel_mod.TrainingHealthSentinel(
        _parse(train_argv(data, out_dir, "--sentinel-interval", "1")))
    anomaly = sentinel_mod.Anomaly(detector="loss-spike", step=5, stat="loss", value=9.0,
                                   threshold=6.0, message="a test anomaly")
    try:
        sent._agree(anomaly, 3 if rank == 0 else 0, "rewind")
        res["divergent"] = None
    except sentinel_mod.ConsistencyError as err:
        res["divergent"] = str(err)
    sent._agree(anomaly, 3, "rewind")  # the same proposal passes

    # stop: rank 1 asks to stop after its second update
    def step_then_stop(self, samples):
        out = real_step(self, samples)
        if rank == 1 and self.get_num_updates() == 2:
            guard.request_stop("a test stop on rank 1")
        return out

    stop_dir = os.path.join(out_dir, "stop")
    Trainer.train_step = step_then_stop
    try:
        stats, tr = run(stop_dir, updates=6)
    finally:
        Trainer.train_step = real_step
    res["stop"] = {"updates": stats["updates"], "stop_signal": stats["stop_signal"],
                   "update_ids": stats["update_ids"], "files": listing(stop_dir)}

    # resume: the stopped run goes on to update 6 at world size 2
    stats, tr = run(stop_dir, updates=6)
    res["resume"] = {"updates": stats["updates"], "resumed_from": stats["resumed_from_update"],
                     "update_ids": stats["update_ids"], "losses": stats["loss_per_update"],
                     "ranks": stats.get("ranks")}

    # the journal: each rank's records carry its rank, the run id is rank 0's
    os.environ[journal.ENV_RUN_ID] = f"run-of-rank-{rank}"
    journal.configure(Namespace(telemetry_dir=os.path.join(out_dir, "telemetry")), rank=rank)
    res["run_id"] = journal.sync_run_id()
    journal.emit("dp-test", value=rank)
    res["journal_file"] = journal.journal_path()
    journal.reset()
    Trainer.__init__ = real_init
    with open(os.path.join(out_dir, f"train_rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# the ZeRO job
# ---------------------------------------------------------------------------

#: leg name -> the train CLI's extra arguments (3 updates each, from the
#: same weights; clip 1.0 unless a leg sets --clip-norm)
ZERO_LEGS = {
    "fused_clip0_s0": ["--fused-adam", "--clip-norm", "0", "--zero-stage", "0"],
    "fused_clip0_s1": ["--fused-adam", "--clip-norm", "0", "--zero-stage", "1"],
    "fused_clip0_s2": ["--fused-adam", "--clip-norm", "0", "--zero-stage", "2"],
    "fused_clip0_s3": ["--fused-adam", "--clip-norm", "0", "--zero-stage", "3"],
    "fused_clip1_s0": ["--fused-adam", "--zero-stage", "0"],
    "fused_clip1_s1": ["--fused-adam", "--zero-shard-optimizer"],
    "fused_clip1_s2": ["--fused-adam", "--zero-stage", "2"],
    "bf16sr_s0": ["--fused-adam", "--clip-norm", "0", "--bf16", "--bf16-sr"],
    "bf16sr_s3": ["--fused-adam", "--clip-norm", "0", "--bf16", "--bf16-sr",
                  "--zero-stage", "3"],
    "tensor_s0": ["--ema-decay", "0.9", "--zero-stage", "0"],
    "tensor_s1": ["--ema-decay", "0.9", "--zero-stage", "1"],
    "adama_s0": ["--grad-accum", "adama", "--update-freq", "2", "--fused-adam",
                 "--clip-norm", "0"],
    "adama_s2": ["--grad-accum", "adama", "--update-freq", "2", "--fused-adam",
                 "--clip-norm", "0", "--zero-stage", "2"],
    # saved with its optimizer state and EMA: the reshard cases' checkpoint
    "save_s2": ["--fused-adam", "--bf16", "--ema-decay", "0.9", "--zero-stage", "2"],
}
#: the rewind legs: the spike scenario of the ``train`` job (a loss spike on
#: rank 1 at update SPIKE_AT) under --fused-adam
REWIND_FLAGS = ["--fused-adam", "--sentinel-interval", "1", "--snapshot-interval", "3",
                "--snapshot-keep", "2", "--sentinel-warmup", "4", "--loss-spike-window", "8",
                "--loss-spike-zmax", "6", "--spike-skip-updates", "2"]


def _ema_digest(ema):
    from unicore_tpu_torch.tools.dp_pair import state_digests

    return state_digests({"state": {n: {"m": t} for n, t in ema.items()}, "num_steps": 0})["m"]


def zero_main(args, out_dir, data, init):
    import torch
    import torch.distributed as dist

    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.distributed import chaos
    from unicore_tpu_torch.parallel import zero
    from unicore_tpu_torch.tools.dp_pair import replay_gradients, state_digests
    from unicore_tpu_torch.trainer import Trainer

    # gathers to rank 0 (the checkpoints' and ``dst0_state``) in several
    # pieces, one not a divisor of a segment
    zero.HOST_GATHER_CHUNK = 4099
    rank = dist.get_rank()
    res = {"rank": rank, "legs": {}}
    device = torch.device("cpu")
    holder = {}
    real_init, real_restore = Trainer.__init__, Trainer.restore_health_snapshot

    def keep(self, *a, **kw):
        real_init(self, *a, **kw)
        holder["trainer"] = self

    recorded = {}

    def run(tag, extra, updates=3, save=False):
        """One leg; a ``*_s0`` leg keeps its reduced gradients, a sharded
        leg with a ``*_s0`` twin updates from them (``replay_gradients``)."""
        save_dir = os.path.join(out_dir, f"{tag}_rank{rank}")
        argv = train_argv(data, save_dir, "--finetune-from-model", init, *extra,
                          *([] if save else ["--no-save"]), updates=updates)
        a = _parse(argv)
        a.distributed_world_size = args.distributed_world_size
        base = tag.rsplit("_s", 1)[0]
        replay = {}
        undo = (replay_gradients(replay, None if tag.endswith("_s0") else recorded[base])
                if tag.endswith("_s0") or base in recorded else (lambda: None))
        try:
            stats = cli.main(a, device)
        finally:
            undo()
        if "grads" in replay:
            recorded[base] = replay["grads"]
        tr = holder["trainer"]
        state = tr._optimizer.state_dict()  # a collective under ZeRO
        leg = {"losses": stats["loss_per_update"], "gnorms": stats["gnorm_per_update"],
               "update_ids": stats["update_ids"],
               "param_sha256": cli.param_digest(tr.model), "state": state_digests(state),
               "ranks": stats.get("ranks"), "memory": tr.memory_stats(),
               "reduction": stats.get("distributed"),
               "local_keys": sorted(tr._optimizer.state),
               "grad_max_abs_diff": replay.get("grad_max_abs_diff")}
        # a checkpoint's gather: to rank 0 alone
        dst0 = tr._optimizer.state_dict(dst=0)
        leg["dst0_state"] = None if dst0 is None else state_digests(dst0)
        if tr.ema is not None:
            ema = tr._ema_whole()
            leg["ema_sha256"] = _ema_digest(ema)
            ema0 = tr._ema_whole(dst=0)
            leg["dst0_ema_sha256"] = None if ema0 is None else _ema_digest(ema0)
        res["legs"][tag] = leg
        return tr, state, save_dir

    Trainer.__init__ = keep
    try:
        for tag, extra in ZERO_LEGS.items():
            tr, state, save_dir = run(tag, extra, save=tag == "save_s2")
            if tag == "fused_clip1_s2":
                np.savez(os.path.join(out_dir, f"zero_params_rank{rank}.npz"), **_params(tr.model))
            if tag == "save_s2":
                saved = os.path.join(save_dir.replace(f"_rank{rank}", "_rank0"),
                                     "checkpoint_last.pt")
        # the stage-2 save loaded at two ranks, stage 1: each rank's share of
        # the saved state, gathered back whole
        a = _parse(train_argv(data, os.path.join(out_dir, "reload"), "--fused-adam", "--bf16",
                              "--ema-decay", "0.9", "--zero-stage", "1"))
        from unicore_tpu_torch import tasks

        task = tasks.setup_task(a)
        model = task.build_model(a)
        tr = Trainer(a, task, model, task.build_loss(a), device)
        tr.load_checkpoint(saved)
        res["reload_s1"] = {"state": state_digests(tr._optimizer.state_dict()),
                            "ema_sha256": _ema_digest(tr._ema_whole()),
                            "memory": tr.memory_stats(), "updates": tr.get_num_updates()}

        # rewinds: the state each stage restores, gathered whole
        real_mult = chaos.fault_multipliers
        for stage in (0, 2):
            fired, restored = [], []

            def spike(step):
                if rank == 1 and step == SPIKE_AT and not fired:
                    fired.append(step)
                    return 1000.0, 1.0
                return real_mult(step)

            def restore(self, snap):
                real_restore(self, snap)
                restored.append({"step": snap.step, "param_sha256": cli.param_digest(self.model),
                                 "state": state_digests(self._optimizer.state_dict())})

            chaos.fault_multipliers = spike
            Trainer.restore_health_snapshot = restore
            try:
                run(f"rewind_s{stage}", REWIND_FLAGS + ["--zero-stage", str(stage)],
                    updates=SPIKE_UPDATES)
            finally:
                chaos.fault_multipliers = real_mult
                Trainer.restore_health_snapshot = real_restore
            res["legs"][f"rewind_s{stage}"]["restored"] = restored
    finally:
        Trainer.__init__ = real_init
    with open(os.path.join(out_dir, f"zero_rank{rank}.json"), "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------

def _setup():
    import logging

    logging.basicConfig(level=logging.WARNING, stream=sys.stdout)


def main(argv):
    from unicore_tpu_torch.distributed import utils as distributed_utils

    job, out_dir = argv[0], argv[1]
    if job == "hierarchy":
        args = _rank_args(4, num_pods=2, xpod_combine="adasum")
        distributed_utils.call_main(args, hierarchy_main, setup=_setup, out_dir=out_dir)
    elif job == "zero":
        args = _rank_args(2)
        distributed_utils.call_main(args, zero_main, setup=_setup, out_dir=out_dir,
                                    data=argv[2], init=argv[3])
    elif job == "train":
        args = _rank_args(2)
        distributed_utils.call_main(args, train_main, setup=_setup, out_dir=out_dir,
                                    data=argv[2], tail_data=argv[3], init=argv[4])
    else:
        raise SystemExit(f"unknown job {job}")


if __name__ == "__main__":
    main(sys.argv[1:])
