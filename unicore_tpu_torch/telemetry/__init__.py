"""The telemetry plane (counterpart of ``unicore_tpu/telemetry``): the
per-process JSONL event journal (:mod:`.journal`) and the Prometheus
exposition (:mod:`.prometheus`).

``configure(args, rank=..., role=...)`` wires the journal for one process;
``emit`` is importable and safe everywhere (a no-op until configured), so
subsystems never need a configured-or-not branch.  The JAX package's
step-time spans, profiler windows and ``unicore-tpu-trace`` CLI are not
ported (ROADMAP queue A item 5): this ``configure`` takes no span or
profiler flag.  A journal this package writes has the JAX schema, so that
CLI merges it.
"""

from unicore_tpu_torch.telemetry import journal as _journal_mod
from unicore_tpu_torch.telemetry import prometheus
from unicore_tpu_torch.telemetry.journal import (
    ENV_RUN_ID,
    Journal,
    attempt,
    emit,
    ensure_run_id,
    journal_dir,
    journal_file,
    journal_path,
    mint_run_id,
    run_id,
    sync_run_id,
)

__all__ = [
    "ENV_RUN_ID",
    "Journal",
    "attempt",
    "configure",
    "emit",
    "ensure_run_id",
    "journal_dir",
    "journal_file",
    "journal_path",
    "mint_run_id",
    "prometheus",
    "reset",
    "run_id",
    "sync_run_id",
]


def configure(args, *, rank: int, step_provider=None, role: str = "trainer"):
    """Install this process's journal (idempotent); returns it."""
    if role == "trainer":
        _journal_mod.sync_run_id()
    return _journal_mod.configure(args, rank=rank, step_provider=step_provider, role=role)


def reset() -> None:
    """Clear all process-global telemetry state (tests)."""
    _journal_mod.reset()
    prometheus.reset()
