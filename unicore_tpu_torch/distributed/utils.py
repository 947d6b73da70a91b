"""The distributed runtime (counterpart of ``unicore_tpu/distributed/utils.py``):
one process per data-parallel rank over ``torch.distributed``, NCCL on the
card and gloo on the CPU.

* :func:`infer_init_method` finds the rendezvous: ``--distributed-init-method``,
  else a launcher's ``MASTER_ADDR`` / ``MASTER_PORT`` (``torchrun``), else
  ``--distributed-port`` on localhost.
* :func:`distributed_init` puts the rank on ``cuda:(local_rank %
  device_count)`` (``--device cuda``), forms the default group and the
  data-parallel tier's groups (``parallel/groups.py``).  A group that fails
  to form raises; NCCL with two ranks on one card raises naming gloo.
* :func:`call_main` spawns ``--distributed-world-size`` processes unless
  ``--distributed-no-spawn`` is set or a launcher set the rank; the parent
  never touches CUDA, so each rank initialises its own.
* the rank queries and the host-level collectives of the JAX module:
  :func:`all_reduce`, :func:`all_gather_list`, :func:`all_reduce_dict`,
  :func:`broadcast_tensors`, :func:`broadcast_object`, :func:`barrier`.
  Without a group each is the identity of one rank.  Gloo takes tensors on
  the card as they are (two ranks sharing one card, which NCCL refuses).
"""

import logging
import os
import socket
from datetime import timedelta
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

#: the rendezvous gives up after this long (a peer that never arrives)
_INIT_TIMEOUT = timedelta(seconds=300)


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def _launcher_env() -> bool:
    """A launcher (``torchrun``) set this process's rank and world size."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def infer_init_method(args) -> Optional[str]:
    """The rendezvous address: the explicit flag, a launcher's environment,
    or ``--distributed-port`` on localhost; None when there is none (a run
    of one rank without a group)."""
    if args.distributed_init_method is not None:
        return args.distributed_init_method
    if _launcher_env():
        return "tcp://{}:{}".format(os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"])
    if args.distributed_port > 0 and (args.distributed_world_size or 1) > 1:
        return f"tcp://localhost:{args.distributed_port}"
    return None


def resolve_backend(args) -> str:
    """``--distributed-backend``: the JAX CLI's default 'xla' means nccl on
    the card and gloo on the CPU; nccl on the CPU is refused."""
    backend = getattr(args, "distributed_backend", "xla") or "xla"
    if backend == "xla":
        return "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl" and args.device == "cpu":
        raise ValueError("--distributed-backend nccl needs --device cuda; the CPU "
                         "ranks run --distributed-backend gloo")
    return backend


def _local_ranks(args) -> int:
    """How many ranks run on this host."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return max(1, args.distributed_world_size or 1)


def check_backend_devices(args, device_count: int) -> None:
    """NCCL takes one card a rank: two ranks mapped to one card raise,
    naming gloo (no backend or device is chosen silently)."""
    if resolve_backend(args) == "nccl" and _local_ranks(args) > max(device_count, 1):
        raise ValueError(
            f"--distributed-backend nccl: {_local_ranks(args)} ranks on this host but "
            f"{device_count} CUDA card(s), and NCCL refuses two ranks on one card "
            "(a duplicate GPU); run them over --distributed-backend gloo, whose "
            "collectives take the tensors on the shared card")


def distributed_init(args) -> int:
    """Form this rank's process group when the run has a rendezvous (world
    size above 1, or an explicit init method at world size 1), set
    ``args.distributed_rank`` and, on the card, the rank's device; returns
    the rank.  A run with no rendezvous stays one rank without a group."""
    import torch

    from unicore_tpu_torch.distributed import chaos
    from unicore_tpu_torch.parallel import groups, plan as plan_mod

    plan_mod.refuse_unported(args)
    if _launcher_env() and args.distributed_init_method is None:
        args.distributed_rank = int(os.environ["RANK"])
        args.distributed_world_size = int(os.environ["WORLD_SIZE"])
        args.device_id = int(os.environ.get("LOCAL_RANK", args.device_id))
    init_method = infer_init_method(args)
    world = args.distributed_world_size or 1
    if init_method is None:
        if world > 1:
            raise ValueError(f"--distributed-world-size {world} needs a rendezvous: "
                             "--distributed-init-method, --distributed-port or a "
                             "launcher's MASTER_ADDR / MASTER_PORT")
        args.distributed_rank = 0
        return 0
    import torch.distributed as dist

    backend = resolve_backend(args)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA card is visible to rank "
                               f"{args.distributed_rank}")
        check_backend_devices(args, torch.cuda.device_count())
        torch.cuda.set_device(args.device_id % torch.cuda.device_count())
    logger.info(f"initializing the process group: {backend} at {init_method}, rank "
                f"{args.distributed_rank} of {world}")
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=args.distributed_rank, timeout=_INIT_TIMEOUT)
    if args.device == "cpu" and _local_ranks(args) > 1:
        # the host's cores split between its ranks, not each rank taking all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // _local_ranks(args)))
    plan = groups.setup(plan_mod.plan_from_args(args), world, args.distributed_rank, backend)
    plan_mod.set_global_plan(plan)
    chaos.set_rank(args.distributed_rank, world)
    return args.distributed_rank


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    import torch.distributed as dist

    from unicore_tpu_torch.distributed import chaos
    from unicore_tpu_torch.parallel import groups, plan as plan_mod

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    groups.teardown()
    plan_mod.set_global_plan(None)
    chaos.set_rank(0, 1)


def free_port() -> int:
    """A free TCP port on localhost for the spawned ranks' rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(args, main, kwargs):
    try:
        distributed_init(args)
        return main(args, **kwargs)
    finally:
        destroy()


def _spawned_main(i, args, main, kwargs, setup):
    if setup is not None:
        setup()
    args.distributed_rank = i
    args.device_id = i
    _run(args, main, kwargs)


def call_main(args, main, setup=None, **kwargs):
    """Run ``main(args, **kwargs)`` on every rank.  With
    ``--distributed-world-size`` above 1, no ``--distributed-no-spawn`` and
    no launcher, this process spawns the ranks (each calls ``setup()``
    first: logging, say) and returns None once all have exited; a rank's
    exception is raised here.  Otherwise this process is one rank and
    main's result is returned."""
    world = args.distributed_world_size or 1
    if world > 1 and not args.distributed_no_spawn and not _launcher_env():
        import torch.multiprocessing as mp

        if args.distributed_init_method is None:
            port = args.distributed_port if args.distributed_port > 0 else free_port()
            args.distributed_init_method = f"tcp://localhost:{port}"
        if args.device == "cuda":
            # counted without a CUDA context, which the spawned ranks would
            # otherwise inherit the wish for
            import torch

            check_backend_devices(args, torch.cuda.device_count())
        mp.spawn(_spawned_main, args=(args, main, kwargs, setup), nprocs=world, join=True)
        return None
    return _run(args, main, kwargs)


# ---------------------------------------------------------------------------
# rank queries
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def get_world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def get_global_rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def get_data_parallel_world_size() -> int:
    from unicore_tpu_torch.parallel import groups

    return groups.dp_world_size()


def get_data_parallel_rank() -> int:
    from unicore_tpu_torch.parallel import groups

    return groups.dp_rank()


def get_pod_count() -> int:
    from unicore_tpu_torch.parallel import groups

    return groups.num_pods()


def get_pod_index() -> int:
    from unicore_tpu_torch.parallel import groups

    return groups.pod_index()


def is_master(args=None) -> bool:
    return get_global_rank() == 0


# ---------------------------------------------------------------------------
# host-level collectives
# ---------------------------------------------------------------------------

def _comm_device():
    """Where small control-plane tensors live: the card under nccl, the
    host under gloo."""
    import torch

    from unicore_tpu_torch.parallel import groups

    if groups.backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_tensor(tensor, op: str = "sum", group=None):
    """All-reduce ``tensor`` in place and return it."""
    dist = _dist()
    if dist is None:
        return tensor
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    dist.all_reduce(tensor, op=red, group=group)
    return tensor


def all_reduce(values, op: str = "sum"):
    """All-reduce a small array of numbers across the ranks (float64);
    returns a numpy array."""
    import numpy as np
    import torch

    arr = np.asarray(values, dtype=np.float64)
    if _dist() is None:
        return arr
    t = torch.as_tensor(arr).to(_comm_device())
    all_reduce_tensor(t, op)
    return t.cpu().numpy()


def all_gather_list(data) -> List[Any]:
    """Every rank's picklable ``data``, in rank order."""
    dist = _dist()
    if dist is None:
        return [data]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, data)
    return out


def all_reduce_dict(data: Dict[str, Any]) -> Dict[str, float]:
    """Sum a flat dict of numbers across the ranks (float64, one
    collective; every rank must hold the same keys)."""
    keys = sorted(data)
    vec = all_reduce([float(data[k]) for k in keys])
    return {k: float(vec[i]) for i, k in enumerate(keys)}


def broadcast_tensors(tensors, src_rank: int = 0):
    """Overwrite each tensor in place with ``src_rank``'s (every rank
    passes tensors of the same shapes and types)."""
    dist = _dist()
    if dist is None:
        return tensors
    for t in tensors:
        dist.broadcast(t, src_rank)
    return tensors


def broadcast_object(obj, src_rank: int = 0):
    """``src_rank``'s picklable ``obj`` on every rank."""
    dist = _dist()
    if dist is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src_rank)
    return box[0]


def barrier(tag: str = "barrier") -> None:
    """Every rank reaches ``tag`` before any goes on."""
    dist = _dist()
    if dist is None:
        return
    if dist.get_backend() == "nccl":
        import torch

        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
