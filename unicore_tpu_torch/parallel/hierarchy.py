"""The data-parallel gradient reduction, flat and two-level (counterpart
of ``unicore_tpu/parallel/hierarchy.py``).

The trainer reduces each update's gradients once, after the last
micro-batch, over the flat buffers of ``optim/multi_tensor.py``'s
:class:`~unicore_tpu_torch.optim.multi_tensor.FlatPlan`, one buffer per
dtype group: under ``--fused-adam`` the optimizer's own gradient buffers,
else one fp32 buffer the per-name gradients are flattened into.

* **Flat** (``--num-pods 1``): one all-reduce (sum) per flat buffer over
  every rank.
* **Two-level** (``--num-pods`` > 1, the JAX ``two_level_reduce``):

  1. a reduce-scatter inside the pod: each in-pod rank ends up with
     ``1/pod_size`` of the buffer, summed over its pod;
  2. the cross-pod combine on that shard over the cross-pod group, the
     only bytes that cross the slow tier: ``--xpod-combine sum``, or
     ``adasum`` (arXiv 2006.02924), whose dots and norms are summed over
     the in-pod group so the coefficients are the full vectors'::

         adasum(a, b) = (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b

     More than two pods fold pairwise in pod-index order;
  3. an all-gather inside the pod rebuilds the whole buffer.

  At pods=2 x data=1 ``sum`` adds the same two values as the flat
  all-reduce, so the two are the same bits.

``--deterministic-reductions`` pins every order this module chooses: the
in-pod reduction gathers and folds in rank order instead of the backend's
reduce-scatter, and the cross-pod sum folds in pod-index order.

Under ``--zero-stage`` 2/3 on a flat tier (``parallel/zero.py``) the
reduction is :meth:`GradReducer.reduce_scatter_`: each flat buffer summed
into this rank's segment only (gathered and folded in rank order under
``--deterministic-reductions``).

The adasum dots and norms run as plain torch reductions over the flat
buffers, as the JAX ``adasum_pair`` runs jnp: no kernel of its own.
"""

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import groups
from .plan import DATA_AXIS, POD_AXIS, ParallelPlan

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# engagement
# ---------------------------------------------------------------------------

def engaged(plan: Optional[ParallelPlan]) -> Tuple[bool, Optional[str]]:
    """Whether the two-level reduction runs for ``plan``, and when the plan
    asked for it but cannot have it, the reason (the run reduces flat).
    It runs when the plan declares a DCN tier (``pods > 1``) and the
    data-parallel tier is its only live parallelism."""
    if plan is None or not plan.has_dcn:
        return False, None
    live = {a for a, n in plan.axis_sizes().items() if n > 1}
    if not live <= {POD_AXIS, DATA_AXIS}:
        return False, (
            "two-level gradient reduction: the plan declares a dcn tier "
            f"(pods={plan.pods}) but carries live model-parallel axes "
            f"({', '.join(sorted(live - {POD_AXIS, DATA_AXIS}))}); falling back "
            "to the flat reduction")
    return True, None


# ---------------------------------------------------------------------------
# combine math
# ---------------------------------------------------------------------------

def _ordered_fold_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Fold ``stacked[(n, ...)]`` in index order: the deterministic sum."""
    acc = stacked[0]
    for i in range(1, stacked.shape[0]):
        acc = acc + stacked[i]
    return acc


def adasum_pair(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """One Adasum combine of two gradient buffers.  ``group``: when ``a``
    and ``b`` are 1/pod_size shards of the full vectors, the dots and
    norms are summed over it, so every rank applies the full vectors'
    coefficients to its shard."""
    a32 = a.float()
    b32 = b.float()
    scalars = torch.stack([(a32 * b32).sum(), a32.square().sum(), b32.square().sum()])
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(scalars, group=group)
    dot, na, nb = scalars.unbind()
    zero = torch.zeros_like(dot)
    # zero-norm guard: a zero operand contributes nothing and must not
    # scale the other side (dot is then 0, so the live coefficient is 1)
    ca = 1.0 - torch.where(na > 0.0, dot / (2.0 * na), zero)
    cb = 1.0 - torch.where(nb > 0.0, dot / (2.0 * nb), zero)
    return (ca * a32 + cb * b32).to(a.dtype)


def combine_stack(stacked: torch.Tensor, mode: str, group=None) -> torch.Tensor:
    """Fold a gathered ``(n_pods, ...)`` stack of per-pod partial
    gradients in pod-index order: the pairwise Adasum tree for ``adasum``
    (an odd tail carries to the next round), the left fold for ``sum``."""
    if mode == "sum":
        return _ordered_fold_sum(stacked)
    parts = [stacked[i] for i in range(stacked.shape[0])]
    while len(parts) > 1:
        folded = [adasum_pair(parts[i], parts[i + 1], group)
                  for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            folded.append(parts[-1])
        parts = folded
    return parts[0]


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------

def _collective(new: str, old: str):
    """``torch.distributed``'s single-tensor collective by its current name,
    else by the older one (the same signature)."""
    import torch.distributed as dist

    return getattr(dist, new, None) or getattr(dist, old)


def _gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """``(n, len)``: every group member's ``t``, in group-rank order."""
    out = t.new_empty(n * t.numel())
    _collective("all_gather_single", "all_gather_into_tensor")(out, t.contiguous(),
                                                                group=group)
    return out.view(n, t.numel())


def two_level_reduce(bufs: Sequence[torch.Tensor], *, n_pods: int, pod_size: int,
                     mode: str = "sum", deterministic: bool = False,
                     inpod_group=None, xpod_group=None,
                     data_index: int = 0) -> List[torch.Tensor]:
    """Each flat buffer reduced over the whole data-parallel tier,
    two-level (module docstring); returns new tensors of the buffers'
    lengths.  The zero padding to a multiple of ``pod_size`` feeds no
    reduction over the flat dim, so values match the flat all-reduce up to
    fp32 reassociation, and bit for bit at ``pod_size == 1``."""
    import torch.distributed as dist

    from unicore_tpu_torch.optim.multi_tensor import pad_to

    out = []
    for buf in bufs:
        length = buf.numel()
        padded = pad_to(buf.reshape(-1), pod_size)
        shard_len = padded.numel() // pod_size
        # 1. in-pod reduce-scatter
        if pod_size <= 1:
            shard = padded.clone()
        elif deterministic:
            total = _ordered_fold_sum(_gather(padded, pod_size, inpod_group))
            shard = total[data_index * shard_len:(data_index + 1) * shard_len].clone()
        else:
            shard = padded.new_empty(shard_len)
            _collective("reduce_scatter_single", "reduce_scatter_tensor")(
                shard, padded.contiguous(), group=inpod_group)
        # 2. cross-pod combine on the shard
        if n_pods > 1:
            if mode == "sum" and not deterministic:
                dist.all_reduce(shard, group=xpod_group)
            else:
                shard = combine_stack(_gather(shard, n_pods, xpod_group), mode,
                                      group=inpod_group if pod_size > 1 else None)
        # 3. in-pod all-gather
        full = _gather(shard, pod_size, inpod_group).view(-1) if pod_size > 1 else shard
        out.append(full[:length])
    return out


class GradReducer:
    """The trainer's gradient reduction over the data-parallel tier: flat,
    or two-level when :func:`engaged`.  :meth:`reduce_` rewrites flat
    buffers in place (the ``--fused-adam`` parameters' views alias them),
    :meth:`reduce_grads` reduces a name -> gradient dict through one fp32
    flat buffer.  Each reduction's milliseconds (CUDA events on the card,
    the host clock on the CPU) and its bytes per buffer are recorded."""

    def __init__(self, plan: ParallelPlan):
        self.plan = plan
        self.two_level, reason = engaged(plan)
        if reason:
            groups.warn_once(logger, reason)
        if self.two_level:
            logger.info(
                f"two-level gradient reduction engaged: pods={plan.pods} x "
                f"pod_size={plan.pod_size}, xpod-combine={plan.xpod_combine}, "
                f"deterministic={plan.deterministic_reductions} (cross-pod bytes = "
                f"1/{plan.pod_size} of the flat-buffer bytes)")
        self._flat_plan = None
        #: per reduction: (start, end) CUDA events or host milliseconds
        self._timings: list = []
        #: per flat buffer of the last reduction: its bytes and the bytes
        #: of it the cross-pod tier carries
        self.buffer_bytes: List[int] = []
        self.dcn_bytes: List[int] = []

    def _timed(self, bufs):
        """Start the timing of a reduction of ``bufs``; returns its stop."""
        if bufs[0].is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()

            def stop():
                end.record()
                self._timings.append((start, end))
        else:
            t0 = time.perf_counter()

            def stop():
                self._timings.append((time.perf_counter() - t0) * 1e3)
        return stop

    def reduce_(self, bufs: Sequence[torch.Tensor]) -> None:
        import torch.distributed as dist

        stop = self._timed(bufs)
        plan = self.plan
        if self.two_level:
            reduced = two_level_reduce(
                bufs, n_pods=plan.pods, pod_size=plan.pod_size, mode=plan.xpod_combine,
                deterministic=plan.deterministic_reductions,
                inpod_group=groups.inpod_group(), xpod_group=groups.xpod_group(),
                data_index=groups.data_index())
            for b, r in zip(bufs, reduced):
                b.view(-1).copy_(r)
        else:
            for b in bufs:
                dist.all_reduce(b)
        stop()
        self.buffer_bytes = [b.numel() * b.element_size() for b in bufs]
        self.dcn_bytes = [
            (-(-b.numel() // plan.pod_size)) * b.element_size() if self.two_level else 0
            for b in bufs]

    def reduce_scatter_(self, bufs: Sequence[torch.Tensor],
                        segs: Sequence[torch.Tensor]) -> None:
        """ZeRO stages 2/3: each flat buffer (``world`` equal segments)
        summed over the ranks into this rank's segment in ``segs`` (a view
        of the buffer's own segment: the sum is written in place, which
        NCCL and gloo take); the backend's reduce-scatter, or under
        ``--deterministic-reductions`` every rank's buffer gathered and
        folded in rank order."""
        stop = self._timed(bufs)
        world, rank = groups.dp_world_size(), groups.dp_rank()
        for b, s in zip(bufs, segs):
            if self.plan.deterministic_reductions:
                total = _ordered_fold_sum(_gather(b, world, None))
                s.copy_(total[rank * s.numel():(rank + 1) * s.numel()])
            else:
                _collective("reduce_scatter_single", "reduce_scatter_tensor")(s, b)
        stop()
        self.buffer_bytes = [b.numel() * b.element_size() for b in bufs]
        self.dcn_bytes = [0 for _ in bufs]

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``grads`` (name -> fp32 gradient) summed over the ranks: views
        into one flat buffer, the names in ``grads``' order."""
        from unicore_tpu_torch.optim.multi_tensor import FlatPlan

        if self._flat_plan is None or self._flat_plan.names != tuple(grads):
            self._flat_plan = FlatPlan.build(grads)
        bufs = self._flat_plan.flatten(grads)
        self.reduce_(bufs)
        return self._flat_plan.unflatten(bufs)

    def timings_ms(self) -> List[float]:
        """Each reduction's milliseconds (waits for the card's events)."""
        out = []
        for t in self._timings:
            if isinstance(t, tuple):
                t[1].synchronize()
                out.append(t[0].elapsed_time(t[1]))
            else:
                out.append(t)
        return out
