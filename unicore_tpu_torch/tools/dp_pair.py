"""Two-level data-parallel training runs in one spawned set of ranks: the
train CLI's ``main`` under ``--num-pods`` (``parallel/hierarchy.py``), once
per ``--xpod-combine`` mode given, all in the same processes and process
group, so the modes pay one start-up.  Run from the root of a checkout::

    python -m unicore_tpu_torch.tools.dp_pair --out DIR [--combines sum,adasum] \\
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
"""

import argparse
import copy
import json
import os
import sys


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


def _rank(args, out, combines):
    import torch.distributed as dist

    from unicore_tpu_torch.cli import train as cli
    from unicore_tpu_torch.cli.serve import resolve_device
    from unicore_tpu_torch.parallel import groups, plan as plan_mod
    from unicore_tpu_torch.trainer import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    device = resolve_device(args.device)
    result = {"rank": rank, "runs": {}}
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
    with open(os.path.join(out, f"dp_pair_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--combines", default="sum,adasum")
    opts = parser.parse_args(argv[:split])
    from unicore_tpu_torch import options
    from unicore_tpu_torch.cli.train import configure_logging
    from unicore_tpu_torch.distributed import utils as distributed_utils

    configure_logging()
    args = options.parse_args_and_arch(options.get_training_parser(), argv[split + 1:])
    os.makedirs(opts.out, exist_ok=True)
    distributed_utils.call_main(args, _rank, setup=configure_logging, out=opts.out,
                                combines=opts.combines.split(","))
    return 0


if __name__ == "__main__":
    sys.exit(main())
