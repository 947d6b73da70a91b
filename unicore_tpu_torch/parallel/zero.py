"""ZeRO over the data-parallel ranks (counterpart of
``unicore_tpu/parallel/sharding.py``'s ``resolve_zero_stage`` /
``zero1_pspecs`` and ``unicore_tpu/optim/multi_tensor.py``'s
``_zero_shard``): each rank keeps and updates only its share of the
optimizer state.

``--zero-stage`` (``--zero-shard-optimizer`` is the deprecated spelling of
stage 1), as the JAX package defines the stages:

* **1** -- the fp32 master, the Adam moments and the EMA are sharded.  The
  gradients are still all-reduced whole, so the norm is stage 0's; each
  rank updates its share, then one all-gather per flat buffer rebuilds the
  parameters.
* **2** -- also the gradients: each flat gradient buffer is
  reduce-scattered into the rank's segment, the norm is K-a's
  sum-of-squares mode on the segments with the partials gathered in rank
  order (stage 0's bits), and the update reads the segment.
* **3** -- in the JAX package stage 3 differs from stage 2 only in the
  layout inside its compiled pass (``docs/performance.md``, "Memory
  headroom"), and its master is sharded at rest from stage 1 on; so here
  stage 3 runs stage 2.  The parameters are never sharded for the forward,
  as the JAX package does not shard them.

Stages 2 and 3 need ``--fused-adam`` (the flat buffers); stage 1 runs on
the per-tensor path too.  Two layouts of the rank's share:

* :class:`FlatLayout` (``--fused-adam``): each dtype group's buffers are
  zero-padded to a multiple of ``world * NORM_SPAN`` elements and rank r
  owns the contiguous segment ``[r S, (r + 1) S)``; K-b runs on it.
* :class:`TensorLayout` (the per-tensor path, and ``--grad-accum adama``'s
  accumulators): each tensor is split along its first dim that the world
  size divides, the JAX ``zero1_pspecs`` rule; a tensor with none stays
  whole on every rank.

Either way the checkpoint holds every tensor whole, by name, as at stage 0
(``gather``), and a load keeps the rank's share (``local``), so a state
saved at one world size and stage resumes at another.  Every collective
here runs on the device: no host read.  Several ranks on one card run over
gloo, which takes ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
on card tensors; a backend that does not raises.

The stages on a plan whose data-parallel tier is two-level (``--num-pods``
above 1) shard the state as on a flat tier, and stages 2/3 reduce the
gradients as stage 1 does: the JAX ``_zero_mesh`` keeps its flat-buffer
sharding to single-live-axis meshes too.
"""

import dataclasses
import logging
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

_zero_shim_warned = False


def resolve_zero_stage(args) -> int:
    """ZeRO stage from the flags, honoring the deprecation shim:
    ``--zero-shard-optimizer`` (the old boolean) means ``--zero-stage 1``
    and warns once.  An explicit ``--zero-stage`` wins when both are set
    (the boolean then adds nothing)."""
    global _zero_shim_warned
    stage = int(getattr(args, "zero_stage", 0) or 0)
    if getattr(args, "zero_shard_optimizer", False):
        if not _zero_shim_warned:
            _zero_shim_warned = True
            logger.warning(
                "--zero-shard-optimizer is deprecated; use --zero-stage 1 "
                "(stages 2/3 additionally shard the flat gradient / master "
                "buffers — docs/performance.md, 'Memory headroom')"
            )
        stage = max(stage, 1)
    if stage >= 2 and not getattr(args, "fused_adam", False):
        raise ValueError(
            f"--zero-stage {stage} shards the fused optimizer's flat "
            "buffers and therefore requires --fused-adam (stages 2/3 have "
            "no per-leaf equivalent; use --zero-stage 1 for the per-leaf "
            "sharding)"
        )
    return stage


_preset_logged = set()


def log_preset(args, world: int) -> str:
    """Log once per preset what the flags resolved to (the JAX
    ``resolve_ddp_preset`` line): ``replicated`` or ``zero<stage>``, and
    where the state lives; returns the preset's name."""
    stage = resolve_zero_stage(args)
    preset = f"zero{stage}" if stage > 0 else "replicated"
    if (preset, world) not in _preset_logged:
        _preset_logged.add((preset, world))
        backend = getattr(args, "ddp_backend", "c10d")
        where = ("every rank keeps the whole optimizer state" if stage == 0 or world <= 1
                 else f"each of {world} ranks keeps 1/{world} of the optimizer state")
        logger.info(f"--ddp-backend={backend} -> preset '{preset}' ({where})")
    return preset


def split_dim(shape: Sequence[int], world: int) -> Optional[int]:
    """The dim a tensor's state splits along over ``world`` ranks: the
    first whose size ``world`` divides (the JAX ``zero1_pspecs`` loop), or
    None (the tensor stays whole on every rank)."""
    for dim, size in enumerate(shape):
        if size % world == 0 and size >= world:
            return dim
    return None


@dataclasses.dataclass(frozen=True)
class ZeroSpec:
    """One rank's ZeRO: the stage, the data-parallel world and this rank,
    and whether the gradients are reduce-scattered (stages 2/3 on a flat
    tier) or reduced whole."""

    stage: int
    world: int
    rank: int
    scatter: bool = False


def spec_for(stage: int, world: int, rank: int, two_level: bool) -> Optional[ZeroSpec]:
    """The rank's :class:`ZeroSpec`, or None when nothing shards (stage 0,
    or one rank)."""
    if stage <= 0 or world <= 1:
        return None
    if stage >= 3 and "stage3" not in _preset_logged:
        _preset_logged.add("stage3")
        logger.info("--zero-stage 3 runs stage 2 here: the master is sharded at rest from "
                    "stage 1 on, and the parameters stay whole for the forward, as in the "
                    "JAX package")
    if stage >= 2 and two_level:
        from . import groups

        groups.warn_once(logger, f"--zero-stage {stage}: the gradient reduction is "
                                 "two-level (--num-pods > 1), so the gradients are reduced "
                                 "whole, as at stage 1; the state stays sharded")
    return ZeroSpec(stage, world, rank, scatter=stage >= 2 and not two_level)


# ---------------------------------------------------------------------------
# collectives (the default group: the data-parallel tier is every rank)
# ---------------------------------------------------------------------------

def all_gather(t: torch.Tensor, world: int) -> torch.Tensor:
    """``(world * len,)``: every rank's 1-d ``t``, in rank order."""
    from .hierarchy import _gather

    return _gather(t.reshape(-1), world, None).view(-1)


#: elements of ``t`` a gather to the host moves at a time (64 MB in fp32)
HOST_GATHER_CHUNK = 1 << 24


def gather_to_host(t: torch.Tensor, world: int, rank: int, dst: int) -> Optional[torch.Tensor]:
    """``(world * len,)`` on rank ``dst``'s host: every rank's 1-d ``t``, in
    rank order, gathered into ``dst``'s device :data:`HOST_GATHER_CHUNK`
    elements a rank at a time and copied out; None on the other ranks,
    which hold nothing more than ``t``."""
    import torch.distributed as dist

    t = t.reshape(-1).contiguous()
    n = t.numel()
    out = torch.empty(world * n, dtype=t.dtype) if rank == dst else None
    for a in range(0, max(n, 1), HOST_GATHER_CHUNK):
        piece = t[a:a + HOST_GATHER_CHUNK]
        parts = [torch.empty_like(piece) for _ in range(world)] if out is not None else None
        dist.gather(piece, parts, dst=dst)
        for r, p in enumerate(parts or ()):
            out[r * n + a:r * n + a + p.numel()].copy_(p)
    return out


def all_gather_into(full: torch.Tensor, start: int, size: int) -> None:
    """Rebuild ``full`` (1-d, ``world * size`` elements) on every rank from
    each rank's ``full[start:start + size]``."""
    from .hierarchy import _collective

    _collective("all_gather_single", "all_gather_into_tensor")(
        full, full[start:start + size].clone())


# ---------------------------------------------------------------------------
# layouts: a rank's share of named tensors
# ---------------------------------------------------------------------------

class TensorLayout:
    """Each named tensor split along its :func:`split_dim` over the ranks:
    rank r holds the r-th of ``world`` equal slices (a view), or the whole
    tensor when no dim divides."""

    def __init__(self, shapes: Mapping[str, Sequence[int]], world: int, rank: int):
        self.world, self.rank = world, rank
        self.shapes = {n: torch.Size(s) for n, s in shapes.items()}
        self.dims = {n: split_dim(s, world) for n, s in self.shapes.items()}

    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        if d is None:
            return t
        k = t.shape[d] // self.world
        return t.narrow(d, self.rank * k, k)

    def local(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self.view(n, t) for n, t in named.items()}

    def gather(self, local: Mapping[str, torch.Tensor],
               dst: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """Each tensor whole: the split ones' slices all-gathered (one
        collective per dtype) and put back along their dim; the whole ones
        as they are.  With ``dst`` the slices are gathered to rank ``dst``
        alone, which gets every tensor on its host; the others get None."""
        if dst is None:
            out = dict(local)
        else:
            out = {n: t.cpu() for n, t in local.items()} if self.rank == dst else {}
        split = [n for n in local if self.dims[n] is not None]
        for dtype in dict.fromkeys(local[n].dtype for n in split):
            names = [n for n in split if local[n].dtype == dtype]
            packed = torch.cat([local[n].reshape(-1) for n in names])
            if dst is None:
                rows = all_gather(packed, self.world)
            else:
                rows = gather_to_host(packed, self.world, self.rank, dst)
                if rows is None:
                    continue
            rows = rows.view(self.world, -1)
            off = 0
            for n in names:
                piece = local[n]
                k = piece.numel()
                out[n] = torch.cat([rows[r, off:off + k].view(piece.shape)
                                    for r in range(self.world)], dim=self.dims[n])
                off += k
        return out if dst is None or self.rank == dst else None


class FlatLayout:
    """The flat buffers of a :class:`~unicore_tpu_torch.optim.multi_tensor.
    FlatPlan` built with ``pad = world * NORM_SPAN``: rank r owns each
    group's segment ``[r S, (r + 1) S)``, ``S = padded / world``; the rank's
    share of named tensors is ``{"flat.<group>": segment}``."""

    def __init__(self, plan, world: int, rank: int):
        self.plan, self.world, self.rank = plan, world, rank
        for g in plan.groups:
            if g.padded % world:
                raise ValueError(f"flat group of {g.padded} elements does not split over "
                                 f"{world} ranks")

    def segment(self, group) -> Tuple[int, int]:
        """(first element, length) of the rank's segment of ``group``."""
        size = group.padded // self.world
        return self.rank * size, size

    def local(self, named: Mapping[str, torch.Tensor],
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """The rank's segments of ``named`` (every name of the plan) laid
        flat in ``dtype``: new tensors on ``named``'s device."""
        out = {}
        for i, g in enumerate(self.plan.groups):
            a, s = self.segment(g)
            out[f"flat.{i}"] = g.flatten(named, dtype)[a:a + s].clone()
        return out

    def gather(self, local: Mapping[str, torch.Tensor],
               dst: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """Every name of the plan whole, from the ranks' segments: one
        all-gather per group; each tensor its own storage.  With ``dst`` one
        gather per group to rank ``dst`` alone, which gets every tensor on
        its host (a group whole on its card only while it is copied out);
        the others get None."""
        views = {}
        for i, g in enumerate(self.plan.groups):
            if dst is None:
                full = all_gather(local[f"flat.{i}"], self.world)
            else:
                full = gather_to_host(local[f"flat.{i}"], self.world, self.rank, dst)
                if full is None:
                    continue
            views.update(g.views(full))
        if dst is not None and self.rank != dst:
            return None
        return {n: views[n].clone() for n in self.plan.names}
