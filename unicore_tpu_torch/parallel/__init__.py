"""Data parallelism (counterpart of ``unicore_tpu/parallel/``): the plan
(``plan.py``), the process groups of its two tiers (``groups.py``) and the
flat and two-level gradient reductions (``hierarchy.py``) and ZeRO's
share of the optimizer state (``zero.py``).  Tensor,
expert, pipeline and sequence parallelism are not ported (ROADMAP queue A
item 4)."""

from .plan import (  # noqa: F401
    ALL_AXES,
    DATA_AXIS,
    EXPERT_AXIS,
    MESH_AXIS_ORDER,
    MODEL_AXIS,
    PIPE_AXIS,
    POD_AXIS,
    SEQ_AXIS,
    ParallelPlan,
    PlanLegalityError,
    get_global_plan,
    plan_from_args,
    refuse_unported,
    resolve_deterministic_reductions,
    set_global_plan,
)
from .zero import resolve_zero_stage  # noqa: F401
