"""Data-parallel training runs in one spawned set of ranks: the train CLI's
``main`` under ``--num-pods`` (``parallel/hierarchy.py``), once per
``--xpod-combine`` mode given, then under ``--zero-stage`` once per leg of
``--zero-stages``, all in the same processes and process group, so the runs
pay one start-up.  Run from the root of a checkout::

    python -m unicore_tpu_torch.tools.dp_pair --out DIR [--combines sum,adasum] \\
        [--zero-stages 0,1,2,bf16:0,bf16:3] \\
        -- <the train CLI's arguments, --distributed-world-size N --num-pods P ...>

The ranks spawn as the CLI spawns them (``distributed_utils.call_main``).
Each mode's run gets ``--save-dir`` + ``_<mode>``.  Under ``sum`` every
reduction of the run is also made flat (one all-reduce of a copy of the same
gradient buffers), and the two results are compared bit for bit: at
pod_size 1 the two-level sum adds the same values in the same order as the
flat all-reduce.  Each rank writes ``DIR/dp_pair_rank<r>.json``: per mode
the losses, gradient norms, whether every reduction's buffers were finite,
the sum-against-flat verdicts, and on rank 0 the CLI's ``TRAIN stats``
(``ranks`` holds each rank's parameter digest).

A ZeRO leg (``[bf16:]STAGE``) runs the same arguments at ``--num-pods 1``
with ``--fused-adam --clip-norm 0 --zero-stage STAGE`` (and ``--bf16
--bf16-sr`` for ``bf16:``), its ``--save-dir`` + ``_zero_<leg>``; list each
dtype's stage-0 leg first.  The stage-0 leg keeps each update's reduced
gradient, and every later leg of its dtype updates from it
(:func:`replay_gradients`: two training runs differ in the gradient's
last bits), noting how far its own was (``grad_max_abs_diff``).  Its record:
the losses and norms, on rank 0 a sha256 of the optimizer state gathered
whole (``m``, ``v``, the master; :func:`state_digests`) and the ``TRAIN
stats`` (each rank's parameter digest, optimizer-state bytes and peak
allocated bytes, the update walls, the reduction's ms and bytes); the peak
is reset before each leg, after the last one's memory is released.  The
state is gathered to rank 0's host as a checkpoint gathers it
(``state_dict(dst=0)``), and on a card each rank's allocated bytes before
that gather and its peak during it are kept (``allocated_before_save_bytes``,
``save_peak_allocated_bytes``).  The first leg at stage 2 also saves the
gathered state with ``torch.save`` on rank 0 and every rank loads it back
with ``torch.load``: ``reload_equal`` says the rank's own share came back
bit for bit.
"""

import argparse
import copy
import gc
import hashlib
import json
import os
import sys
import time


def _watch(reducer, mode, record):
    """Wrap ``reducer.reduce_``: record that its outputs are finite and,
    under ``sum``, whether they are the bits of the flat all-reduce."""
    import torch
    import torch.distributed as dist

    real = reducer.reduce_

    def reduce_(bufs):
        flat = None
        if mode == "sum":
            flat = [b.clone() for b in bufs]
            for f in flat:
                dist.all_reduce(f)
        real(bufs)
        record["finite"].append(all(bool(torch.isfinite(b).all()) for b in bufs))
        if flat is not None:
            record["sum_equals_flat"].append(all(
                torch.equal(b.view(torch.int32), f.view(torch.int32))
                for b, f in zip(bufs, flat)))

    reducer.reduce_ = reduce_


def state_digests(state) -> dict:
    """sha256 of each part of an optimizer ``state_dict`` (whole tensors by
    name, in order): ``m``, ``v``, ``master`` when there is one, and the
    step count."""
    import torch

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().contiguous().cpu().view(torch.int32).numpy().tobytes())
        return h.hexdigest()

    names = list(state["state"])
    out = {k: digest(state["state"][n][k] for n in names) for k in ("m", "v")
           if k in state["state"][names[0]]}
    if state.get("master") is not None:
        out["master"] = digest(state["master"][n] for n in names)
    out["num_steps"] = int(state["num_steps"])
    return out


def _local_digest(opt) -> str:
    """sha256 of the rank's own share of the optimizer state."""
    import torch

    h = hashlib.sha256()
    for key in sorted(opt.state):
        for k in sorted(opt.state[key]):
            h.update(opt.state[key][k].float().contiguous().cpu().view(torch.int32)
                     .numpy().tobytes())
    for key in sorted(opt.master or {}):
        h.update(opt.master[key].contiguous().cpu().view(torch.int32).numpy().tobytes())
    return h.hexdigest()


def replay_gradients(record, grads):
    """Patch the gradient reduction (``GradReducer.reduce_`` and
    ``reduce_scatter_``, every reduction a trainer makes) for one run: with
    ``grads`` None keep a host copy of each reduction's output in
    ``record["grads"]``; else, after each reduction of the run's own, note
    how far its output is from the recorded one (``grad_max_abs_diff``)
    and put the recorded values in its place -- this rank's segment of
    them after a reduce-scatter.  Two training runs differ in the
    gradient's last bits (on the card #2 sums the bias gradient with
    atomics; on a busy CPU the products' threading varies), so a sharded
    run is compared with stage 0 on stage 0's gradients; ``grad_max_abs``
    is the largest recorded value the rank's reduction was held to (the
    scale the distance is read against).  Returns the call that undoes the
    patch."""
    import torch

    from unicore_tpu_torch.parallel import groups
    from unicore_tpu_torch.parallel.hierarchy import GradReducer

    real_reduce, real_scatter = GradReducer.reduce_, GradReducer.reduce_scatter_
    calls = []

    def put(dst, src):
        src = src.to(dst.device)
        if src.numel() < dst.numel():  # a buffer padded for the ZeRO layout
            src = torch.cat([src, src.new_zeros(dst.numel() - src.numel())])
        worst = float((dst - src).abs().max()) if dst.numel() else 0.0
        scale = float(src.abs().max()) if dst.numel() else 0.0
        dst.copy_(src)
        return worst, scale

    def recorded():
        calls.append(None)
        return grads[len(calls) - 1]

    def note(pairs):
        pairs = list(pairs)
        record.setdefault("grad_max_abs_diff", []).append(max(w for w, _ in pairs))
        record.setdefault("grad_max_abs", []).append(max(m for _, m in pairs))

    def reduce_(self, bufs):
        real_reduce(self, bufs)
        if grads is None:
            record.setdefault("grads", []).append(
                [b.detach().reshape(-1).to("cpu", copy=True) for b in bufs])
            return
        note(put(b.view(-1), r) for b, r in zip(bufs, recorded()))

    def reduce_scatter_(self, bufs, segs):
        real_scatter(self, bufs, segs)
        rank = groups.dp_rank()
        note(put(s, r[rank * s.numel():(rank + 1) * s.numel()])
             for s, r in zip(segs, recorded()))

    GradReducer.reduce_ = reduce_
    if grads is not None:  # a stage-0 run never reduce-scatters
        GradReducer.reduce_scatter_ = reduce_scatter_

    def undo():
        GradReducer.reduce_, GradReducer.reduce_scatter_ = real_reduce, real_scatter

    return undo


def _zero_leg(args, leg, rank, world, device, holder, reload, grads):
    """One ZeRO leg (module docstring) from its stage-0 leg's gradients
    (``grads``; None: this is that leg, which records them); returns its
    record."""
    import torch
    import torch.distributed as dist

    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.parallel import groups, plan as plan_mod

    dtype, _, stage = leg.rpartition(":")
    a = copy.copy(args)
    a.num_pods, a.xpod_combine = 1, "sum"
    a.fused_adam, a.clip_norm, a.zero_stage = True, 0.0, int(stage)
    a.bf16 = a.bf16_sr = dtype == "bf16"
    a.save_dir = a.tmp_save_dir = f"{args.save_dir}_zero_{leg.replace(':', '_')}"
    plan = groups.setup(plan_mod.plan_from_args(a), world, rank, groups.backend())
    plan_mod.set_global_plan(plan)
    holder.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    record = {"leg": leg}
    undo = replay_gradients(record, grads)
    t0 = time.monotonic()
    try:
        stats = cli.main(a, device)
    finally:
        undo()
    tr = holder["trainer"]
    opt = tr._optimizer
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        record["allocated_before_save_bytes"] = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    # gathered whole to rank 0's host, as a checkpoint gathers it: a collective
    state = opt.state_dict(dst=0)
    if device.type == "cuda":
        record["save_peak_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
    record.update(zero_stage=tr.zero_stage, losses=stats["loss_per_update"],
                  gnorms=stats["gnorm_per_update"], plan=plan.describe(),
                  state=state_digests(state) if rank == 0 else None,
                  rank_got_state=state is not None)
    if reload:
        # the whole state through torch.save on rank 0 and torch.load on
        # every rank, each keeping its own share: the share the same bits
        mine = _local_digest(opt)
        path = os.path.join(a.save_dir, "zero_state.pt")
        if rank == 0:
            os.makedirs(a.save_dir, exist_ok=True)
            torch.save(state, path)
        del state
        dist.barrier()
        ok = opt.load_state_dict(torch.load(path, map_location="cpu"))
        record["reload_equal"] = bool(ok) and _local_digest(opt) == mine
        dist.barrier()
        if rank == 0:
            os.remove(path)
    record["seconds"] = time.monotonic() - t0
    if rank == 0:
        record["stats"] = stats
    return record


def _rank(args, out, combines, zero_legs=()):
    import torch.distributed as dist

    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.cli.serve import resolve_device
    from unicore_tpu_torch.parallel import groups, plan as plan_mod
    from unicore_tpu_torch.trainer import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    device = resolve_device(args.device)
    result = {"rank": rank, "runs": {}, "zero": {}}
    real_init = Trainer.__init__
    for mode in combines:
        record = {"finite": [], "sum_equals_flat": []}
        a = copy.copy(args)
        a.xpod_combine = mode
        a.save_dir = a.tmp_save_dir = f"{args.save_dir}_{mode}"
        plan = groups.setup(plan_mod.plan_from_args(a), world, rank, groups.backend())
        plan_mod.set_global_plan(plan)

        def init(self, *x, **kw):
            real_init(self, *x, **kw)
            _watch(self._reducer, mode, record)

        Trainer.__init__ = init
        try:
            stats = cli.main(a, device)
        finally:
            Trainer.__init__ = real_init
        record.update(losses=stats["loss_per_update"], gnorms=stats["gnorm_per_update"],
                      plan=plan.describe())
        if rank == 0:
            record["stats"] = stats
        result["runs"][mode] = record
    holder = {}

    def keep(self, *x, **kw):
        real_init(self, *x, **kw)
        holder["trainer"] = self

    Trainer.__init__ = keep
    try:
        reload, recorded = True, {}
        for leg in zero_legs:
            dtype, _, stage = leg.rpartition(":")
            first_s2 = reload and stage == "2"
            rec = _zero_leg(args, leg, rank, world, device, holder, first_s2,
                            recorded.get(dtype))
            if "grads" in rec:
                recorded[dtype] = rec.pop("grads")
            result["zero"][leg] = rec
            reload = reload and not first_s2
    finally:
        Trainer.__init__ = real_init
        holder.clear()
    with open(os.path.join(out, f"dp_pair_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--combines", default="sum,adasum",
                        help="--xpod-combine modes to run ('' for none)")
    parser.add_argument("--zero-stages", default="",
                        help="ZeRO legs to run after them: [bf16:]STAGE, comma-separated")
    opts = parser.parse_args(argv[:split])
    from unicore_tpu_torch import options
    from unicore_tpu_torch.cli.train import configure_logging
    from unicore_tpu_torch.distributed import utils as distributed_utils

    configure_logging()
    args = options.parse_args_and_arch(options.get_training_parser(), argv[split + 1:])
    os.makedirs(opts.out, exist_ok=True)
    distributed_utils.call_main(args, _rank, setup=configure_logging, out=opts.out,
                                combines=[c for c in opts.combines.split(",") if c],
                                zero_legs=[z for z in opts.zero_stages.split(",") if z])
    return 0


if __name__ == "__main__":
    sys.exit(main())
