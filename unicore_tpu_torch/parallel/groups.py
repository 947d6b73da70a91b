"""The process groups of the data-parallel tier (counterpart of
``unicore_tpu/parallel/mesh.py``, which lays a device mesh where the port
forms ``torch.distributed`` groups).

One process is one rank, and the ranks are laid out as the JAX mesh lays
its devices, pod outermost: rank = pod * pod_size + data index.  So each
pod's ranks are contiguous, and the two tiers of the two-level reduction
(``parallel/hierarchy.py``) are:

* the **in-pod** group of each pod (``pod_size`` ranks, the ICI tier);
* the **cross-pod** group of each data index (``pods`` ranks, one a pod:
  the DCN tier).

:func:`setup` forms them once the default group exists
(``distributed/utils.py`` ``distributed_init``); every rank creates every
group, as ``torch.distributed.new_group`` requires.  Without a default
group the queries answer for one rank (world size 1, no group).

NCCL takes one card a rank.  Several ranks time-sharing one card run over
gloo, which takes the tensors on the card as they are (all-reduce,
broadcast, reduce-scatter and all-gather).
"""

import logging
from typing import Optional

from .plan import ParallelPlan

logger = logging.getLogger(__name__)


class _Tier:
    """The data-parallel layout of this process: the plan resolved with the
    world size, this rank, the backend and the two tiers' groups."""

    def __init__(self, plan: ParallelPlan, rank: int, backend: str, inpod, xpod):
        self.plan = plan
        self.rank = rank
        self.backend = backend
        self.inpod = inpod
        self.xpod = xpod


_tier: Optional[_Tier] = None


def setup(plan: ParallelPlan, world_size: int, rank: int, backend: str) -> ParallelPlan:
    """Resolve ``plan`` against ``world_size`` (its ``data=-1`` absorbs the
    ranks the pods leave; a mismatch raises the plan's named
    ``PlanLegalityError``) and form the in-pod and cross-pod groups.
    Call on every rank, after ``torch.distributed.init_process_group``."""
    import torch.distributed as dist

    global _tier
    plan = plan.validate(world_size)
    pods, pod_size = plan.pods, plan.pod_size
    inpod = xpod = None
    # every rank creates every group, in the same order
    for p in range(pods):
        g = dist.new_group(list(range(p * pod_size, (p + 1) * pod_size)))
        if rank // pod_size == p:
            inpod = g
    for d in range(pod_size):
        g = dist.new_group([p * pod_size + d for p in range(pods)])
        if rank % pod_size == d:
            xpod = g
    _tier = _Tier(plan, rank, backend, inpod, xpod)
    logger.info(f"data-parallel tier: {plan.describe()} over {world_size} rank(s) "
                f"({backend}); rank {rank} = pod {rank // pod_size} x data "
                f"{rank % pod_size}")
    return plan


def teardown() -> None:
    global _tier
    _tier = None


def active() -> bool:
    """True when a process group carries this run (world size 1 included)."""
    return _tier is not None


def plan() -> Optional[ParallelPlan]:
    return _tier.plan if _tier is not None else None


def backend() -> Optional[str]:
    return _tier.backend if _tier is not None else None


def dp_world_size() -> int:
    """Data-parallel ranks: pods x pod_size (1 without a group)."""
    if _tier is None:
        return 1
    return _tier.plan.pods * _tier.plan.pod_size


def dp_rank() -> int:
    return _tier.rank if _tier is not None else 0


def pod_size() -> int:
    return _tier.plan.pod_size if _tier is not None else 1


def num_pods() -> int:
    return _tier.plan.pods if _tier is not None else 1


def pod_index() -> int:
    """This rank's pod (pod-major layout: contiguous blocks of pod_size)."""
    return dp_rank() // pod_size()


def data_index() -> int:
    """This rank's index inside its pod."""
    return dp_rank() % pod_size()


def inpod_group():
    return _tier.inpod if _tier is not None else None


def xpod_group():
    return _tier.xpod if _tier is not None else None


_warned_once = set()


def warn_once(logger_, msg: str) -> None:
    """Log ``msg`` at WARNING level once per process."""
    if msg in _warned_once:
        return
    _warned_once.add(msg)
    logger_.warning(msg)
