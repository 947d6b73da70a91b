"""The telemetry plane (counterpart of ``unicore_tpu/telemetry``):

* :mod:`.journal` -- the per-process JSONL event journal every verdict-class
  event lands in (``emit(kind, **fields)``), in the JAX package's schema;
* :mod:`.spans` -- step-time spans for the training loop (data_wait / h2d /
  dispatch, plus the lag-1 sampled ``device_busy``) feeding the
  ``host_blocked`` / ``device_busy`` metrics;
* :mod:`.prometheus` -- text-format ``/metrics`` exposition for the serve
  plane, the fleet router and the trainer's ``--metrics-port``;
* :mod:`.profiler` -- ``--profile-steps START:END`` windows on
  ``torch.profiler``;
* :mod:`.trace` -- ``unicore-tpu-torch-trace``, which merges journals into
  one timeline, a Chrome trace and a post-mortem summary.

``configure(args, rank=..., step_provider=..., role=...)`` wires the plane
for one process (the trainer's: journal, spans and profiler window; the
serve plane's and the router's: the journal); ``emit`` is importable and
safe everywhere (a no-op until configured), so subsystems never need a
configured-or-not branch.
"""

from unicore_tpu_torch.telemetry import journal as _journal_mod
from unicore_tpu_torch.telemetry import profiler, prometheus, spans
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
    "log_config_payload",
    "mint_run_id",
    "profiler",
    "prometheus",
    "reset",
    "run_id",
    "spans",
    "sync_run_id",
]


def configure(args, *, rank: int, step_provider=None, role: str = "trainer"):
    """Install this process's journal (idempotent); for the trainer also
    the step spans and the ``--profile-steps`` window.  Returns the
    journal."""
    if role == "trainer":
        # one run_id per multi-rank run: every rank adopts rank 0's before
        # the journal bakes it into every record
        _journal_mod.sync_run_id()
    j = _journal_mod.configure(args, rank=rank, step_provider=step_provider, role=role)
    if role == "trainer":
        spans.configure(args)
        profiler.configure(args, journal_dir(args), rank)
    return j


def log_config_payload(args) -> dict:
    """The run-identity dict threaded through the progress bar's
    ``log_config``, so a TensorBoard run is joinable with its journals."""
    return {
        "run_id": run_id() or "",
        "attempt": attempt(),
        "telemetry_journal": journal_path() or "",
    }


def reset() -> None:
    """Clear all process-global telemetry state."""
    _journal_mod.reset()
    spans.reset()
    profiler.reset()
    prometheus.reset()
