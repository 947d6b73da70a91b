"""One declarative parallelism plan (counterpart of
``unicore_tpu/parallel/plan.py``, kept as the port's own copy).

Every data-parallel flag resolves into one :class:`ParallelPlan`: axis
names, per-axis sizes, the topology tier each axis rides and the legality
rules, with the JAX plan's rule names and messages.  The port runs the
data-parallel tier only -- ``pod x data`` ranks, one process each
(``parallel/groups.py`` forms their process groups in the JAX mesh's
order, rank = pod * pod_size + data index).  When ``pods > 1`` the
gradient reduction is two-level (``parallel/hierarchy.py``).  The model,
expert, pipe and seq axes are declared so a plan describes itself as the
JAX plan does; :func:`refuse_unported` raises for any of them above 1
(ROADMAP queue A item 4).  ``--zero-stage`` shards the optimizer state
over the data-parallel tier (``parallel/zero.py``).

Axis order (outermost first)::

    ('pod', 'data', 'expert', 'pipe', 'seq', 'model')
"""

import dataclasses
import logging
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

ALL_AXES = (POD_AXIS, DATA_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS)

#: axis order, outermost first: the ranks of the data-parallel tier are
#: laid pod-major, so one pod's ranks are contiguous (``parallel/groups.py``)
MESH_AXIS_ORDER = (
    POD_AXIS, DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, SEQ_AXIS, MODEL_AXIS,
)

#: topology tier per axis: 'dcn' (between pods, ~25 GB/s) or 'ici'
#: (inside a pod, ~200 GB/s).  Only the pod axis may cross DCN.
ICI_TIER = "ici"
DCN_TIER = "dcn"
AXIS_TIERS: Dict[str, str] = {
    POD_AXIS: DCN_TIER,
    DATA_AXIS: ICI_TIER,
    EXPERT_AXIS: ICI_TIER,
    PIPE_AXIS: ICI_TIER,
    SEQ_AXIS: ICI_TIER,
    MODEL_AXIS: ICI_TIER,
}

#: cross-pod gradient-combine modes (parallel/hierarchy.py)
XPOD_COMBINE_CHOICES = ("sum", "adasum")


class PlanLegalityError(ValueError):
    """A plan violated a named composition rule.  Raised at plan
    validation, before any process group exists, so the operator sees the
    rule, not a collective's shape error.  ``rule`` is the stable
    machine-readable name (the composition-matrix tests key on it)."""

    def __init__(self, rule: str, message: str):
        super().__init__(f"[{rule}] {message}")
        self.rule = rule


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The declarative composition of every parallelism dimension.

    Sizes are per-axis rank counts; ``data=-1`` absorbs all remaining
    ranks when the world size is known (the one late-bound size).
    ``pods`` splits the data-parallel tier across the DCN boundary:
    total dp = ``pods * data``, with ``data`` ranks inside each pod.
    """

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    pods: int = 1
    #: cross-pod gradient combine: 'sum' (bit-identical to the flat
    #: all-reduce at pods=2, data=1) or 'adasum' (arXiv 2006.02924 —
    #: scale-adaptive, stabilizes the large effective batches multi-pod
    #: creates)
    xpod_combine: str = "sum"
    #: fixed f32 reduction order everywhere a reduction order is ours to
    #: choose: the cross-pod combine gathers and folds in pod-index
    #: order, the in-pod reduction gathers and folds in rank order, and
    #: the MoE expert combine replicates its token stream (the retired
    #: --moe-deterministic-reduction special case, now a plan property)
    deterministic_reductions: bool = False
    #: sequence-parallel strategy for the bert family ('ring'/'ulysses')
    seq_impl: str = "ring"

    # -- derived views ------------------------------------------------------

    @property
    def pod_size(self) -> int:
        """In-pod data-parallel size (the ICI half of the dp tier)."""
        return self.data

    @property
    def has_dcn(self) -> bool:
        """True when the plan declares a live DCN tier over dp."""
        return self.pods > 1

    def dp_axes(self) -> Tuple[str, ...]:
        """The mesh axes that together form the data-parallel tier, in
        mesh order — batch arrays shard over these."""
        return (POD_AXIS, DATA_AXIS)

    def axis_sizes(self) -> Dict[str, int]:
        return {
            POD_AXIS: self.pods,
            DATA_AXIS: self.data,
            EXPERT_AXIS: self.expert,
            PIPE_AXIS: self.pipe,
            SEQ_AXIS: self.seq,
            MODEL_AXIS: self.model,
        }

    def mesh_shape(self) -> Tuple[int, ...]:
        """Sizes in :data:`MESH_AXIS_ORDER` (``data`` may still be -1)."""
        sizes = self.axis_sizes()
        return tuple(sizes[a] for a in MESH_AXIS_ORDER)

    def tiers(self) -> Dict[str, str]:
        """axis name -> topology tier for the LIVE axes of this plan."""
        return {
            a: AXIS_TIERS[a]
            for a, n in self.axis_sizes().items()
            if n > 1 or (a == DATA_AXIS and n == -1)
        }

    def fixed_product(self) -> int:
        """Product of every axis size except ``data`` (the -1 absorber)."""
        return self.pods * self.model * self.seq * self.pipe * self.expert

    # -- legality -----------------------------------------------------------

    def validate(self, n_devices: Optional[int] = None) -> "ParallelPlan":
        """Check the composition rules; returns a plan with ``data``
        resolved when ``n_devices`` is given.  Every rejection is a
        :class:`PlanLegalityError` with a stable rule name."""
        for name, size in self.axis_sizes().items():
            if name == DATA_AXIS and size == -1:
                continue
            if size < 1:
                raise PlanLegalityError(
                    "non-positive-axis",
                    f"axis '{name}' has size {size}; every axis size must "
                    "be >= 1 (or data=-1 to absorb remaining devices)",
                )
        if self.xpod_combine not in XPOD_COMBINE_CHOICES:
            raise PlanLegalityError(
                "unknown-xpod-combine",
                f"--xpod-combine {self.xpod_combine!r} is not one of "
                f"{'/'.join(XPOD_COMBINE_CHOICES)}",
            )
        if self.seq_impl not in ("ring", "ulysses"):
            raise PlanLegalityError(
                "unknown-seq-impl",
                f"--seq-parallel-impl {self.seq_impl!r} is not one of "
                "ring/ulysses",
            )
        if self.seq > 1 and self.pipe > 1 and self.seq_impl == "ulysses":
            raise PlanLegalityError(
                "ulysses-pipeline-compose",
                "the ulysses (all-to-all) sequence-parallel strategy does "
                "not compose with the pipeline (docs/PARALLELISM.md); use "
                "--seq-parallel-impl ring for pp x sp",
            )
        plan = self
        if n_devices is not None:
            fixed = self.fixed_product()
            if self.data == -1:
                if n_devices % fixed != 0:
                    raise PlanLegalityError(
                        "indivisible-device-count",
                        f"device count {n_devices} is not divisible by "
                        f"pods*model*seq*pipe*expert={fixed}, so no 'data' "
                        "size can absorb the remainder",
                    )
                plan = dataclasses.replace(self, data=n_devices // fixed)
            elif self.data * fixed != n_devices:
                raise PlanLegalityError(
                    "device-count-mismatch",
                    f"plan {self.describe()} needs {self.data * fixed} "
                    f"devices but {n_devices} are visible",
                )
        return plan

    # -- presentation -------------------------------------------------------

    def describe(self) -> str:
        live = {
            a: n for a, n in self.axis_sizes().items()
            if n != 1
        }
        body = " ".join(f"{a}={n}" for a, n in live.items()) or "single-device"
        extras = []
        if self.has_dcn:
            extras.append(f"xpod={self.xpod_combine}")
        if self.deterministic_reductions:
            extras.append("deterministic")
        return f"ParallelPlan({body}{(' ' + ' '.join(extras)) if extras else ''})"

    def to_json(self) -> Dict:
        """The journal/bench-facing form (telemetry kind ``comm-plan``)."""
        return {
            "axes": {a: n for a, n in self.axis_sizes().items()},
            "tiers": self.tiers(),
            "pods": self.pods,
            "pod_size": self.pod_size,
            "xpod_combine": self.xpod_combine,
            "deterministic_reductions": bool(self.deterministic_reductions),
        }


# ---------------------------------------------------------------------------
# CLI resolution — every flag funnels through here
# ---------------------------------------------------------------------------

_deterministic_shim_warned = False


def resolve_deterministic_reductions(args) -> bool:
    """``--deterministic-reductions`` is the plan property; the old
    MoE-only spelling ``--moe-deterministic-reduction`` is a deprecated
    alias that warns once and folds in."""
    global _deterministic_shim_warned
    det = bool(getattr(args, "deterministic_reductions", False))
    if getattr(args, "moe_deterministic_reduction", False):
        if not _deterministic_shim_warned:
            _deterministic_shim_warned = True
            logger.warning(
                "--moe-deterministic-reduction is deprecated; use "
                "--deterministic-reductions (a plan-wide property: fixed "
                "reduction order for the expert combine AND the two-level "
                "gradient reduction — docs/PARALLELISM.md, 'The plan')"
            )
        det = True
    return det


def plan_from_args(args) -> ParallelPlan:
    """Resolve the CLI flags into one validated (device-count-free)
    :class:`ParallelPlan`: the process groups and the trainer read the
    plan, never the flags."""
    plan = ParallelPlan(
        data=getattr(args, "data_parallel_size", -1) or -1,
        model=getattr(args, "model_parallel_size", 1) or 1,
        seq=getattr(args, "seq_parallel_size", 1) or 1,
        pipe=getattr(args, "pipeline_parallel_size", 1) or 1,
        expert=getattr(args, "expert_parallel_size", 1) or 1,
        pods=getattr(args, "num_pods", 1) or 1,
        xpod_combine=getattr(args, "xpod_combine", "sum") or "sum",
        deterministic_reductions=resolve_deterministic_reductions(args),
        seq_impl=getattr(args, "seq_parallel_impl", "ring") or "ring",
    )
    return plan.validate()


# ---------------------------------------------------------------------------
# the process-global plan (set with the process groups)
# ---------------------------------------------------------------------------

_global_plan: Optional[ParallelPlan] = None


def set_global_plan(plan: Optional[ParallelPlan]) -> None:
    global _global_plan
    _global_plan = plan


def get_global_plan() -> Optional[ParallelPlan]:
    return _global_plan


# ---------------------------------------------------------------------------
# what the port runs of a plan
# ---------------------------------------------------------------------------

def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for what the port does not run: a
    model, expert, pipe or seq axis above 1."""
    for flag, name in (("model_parallel_size", "--model-parallel-size"),
                       ("expert_parallel_size", "--expert-parallel-size"),
                       ("pipeline_parallel_size", "--pipeline-parallel-size"),
                       ("seq_parallel_size", "--seq-parallel-size")):
        if (getattr(args, flag, 1) or 1) > 1:
            raise NotImplementedError(
                f"{name} {getattr(args, flag)}: tensor, expert, pipeline and "
                "sequence parallelism are not ported (ROADMAP queue A item 4); "
                "the port runs the data-parallel tier only")
