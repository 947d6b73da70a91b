"""Structured per-process JSONL event journal (counterpart of
``unicore_tpu/telemetry/journal.py``): the one stream every subsystem's
verdicts land in, one record a line::

    {"run_id": ..., "attempt": 0, "rank": 0, "membership_epoch": 0,
     "update": -1, "mono": 812.031, "wall": 1754300000.12,
     "kind": "serve-shed", ...event fields...}

The schema is the JAX package's field for field, so its
``unicore-tpu-trace`` (``unicore_tpu/telemetry/trace.py``) loads and merges
a journal this package wrote:

* every record carries ``run_id`` / ``attempt`` / ``rank`` /
  ``membership_epoch`` / ``update`` / ``mono`` / ``wall`` / ``kind``;
* ``mono`` is ``time.monotonic()`` (comparable within one process only),
  ``wall`` is ``time.time()``;
* ``update`` is the trainer's update counter at emission time, -1 where no
  trainer context exists (the serve plane);
* event fields never collide with the envelope.

Each process writes its own file and stamps its rank on every record
(:func:`configure`); :func:`sync_run_id` adopts rank 0's run id on every
rank of a process group, as the JAX journal does.  ``membership_epoch`` is
0 and ``attempt`` too: the elastic restarts that count them are not ported
(ROADMAP queue A item 4).

``emit()`` is safe everywhere: before :func:`configure` it drops the record
(debug-logged), and a failed write is warned about once.  Writes are
line-buffered under a lock and flushed per record, so a process killed
mid-incident loses at most the record being written.
"""

import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

#: the run identity's environment contract (the JAX package's name): minted
#: once at the entry point and inherited by child processes
ENV_RUN_ID = "UNICORE_TPU_RUN_ID"

_JOURNAL_DIRNAME = "telemetry"


def mint_run_id() -> str:
    """A new run id: sortable wall stamp + random tail."""
    return time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:8]


def ensure_run_id() -> str:
    """The run id from the environment, minting (and exporting) one if
    absent."""
    rid = os.environ.get(ENV_RUN_ID)
    if not rid:
        rid = mint_run_id()
        os.environ[ENV_RUN_ID] = rid
    return rid


def sync_run_id(timeout: float = 30.0) -> str:
    """The run id every rank shares: rank 0's, broadcast over the process
    group (a collective: every rank calls it) and exported; without a
    group, the process's own (:func:`ensure_run_id`)."""
    from unicore_tpu_torch.distributed import utils as distributed_utils

    rid = ensure_run_id()
    if distributed_utils.get_world_size() > 1:
        rid = distributed_utils.broadcast_object(rid, 0)
        os.environ[ENV_RUN_ID] = rid
        if _journal is not None:
            _journal.run_id = rid
    return rid


def run_id() -> Optional[str]:
    """The configured (or environment) run id, else None."""
    j = _journal
    if j is not None:
        return j.run_id
    return os.environ.get(ENV_RUN_ID)


def attempt() -> int:
    """Elastic incarnation counter: 0, the port has no elastic restarts
    (ROADMAP queue A item 4)."""
    return 0


def membership_epoch() -> int:
    """The elastic membership epoch: 0 at one process."""
    return 0


class Journal:
    """One per-process append-only JSONL event stream."""

    def __init__(self, path: str, *, run_id: str, rank: int,
                 attempt: int = 0,
                 step_provider: Optional[Callable[[], int]] = None):
        self.path = path
        self.run_id = run_id
        self.rank = int(rank)
        self.attempt = int(attempt)
        self._step_provider = step_provider
        self._lock = threading.Lock()
        self._file = None
        self._dropped = 0

    def _ensure_open(self):
        if self._file is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._file = open(self.path, "a", encoding="utf-8")
        return self._file

    def _update(self) -> int:
        if self._step_provider is None:
            return -1
        try:
            return int(self._step_provider())
        except Exception:
            return -1

    def record(self, kind: str, fields: Dict[str, Any]) -> Dict[str, Any]:
        rec = {
            "run_id": self.run_id,
            "attempt": self.attempt,
            "rank": self.rank,
            "membership_epoch": membership_epoch(),
            "update": fields.pop("update", None)
            if "update" in fields
            else self._update(),
            "mono": round(time.monotonic(), 6),
            "wall": round(time.time(), 6),
            "kind": str(kind),
        }
        rec.update(fields)
        return rec

    def emit(self, kind: str, **fields) -> None:
        rec = self.record(kind, fields)
        try:
            line = json.dumps(rec, default=_json_safe)
        except (TypeError, ValueError) as err:
            logger.debug(f"journal record for {kind!r} not serializable: {err}")
            return
        with self._lock:
            try:
                f = self._ensure_open()
                f.write(line + "\n")
                f.flush()
            except OSError as err:
                # telemetry never kills the path it narrates: say so once
                self._dropped += 1
                if self._dropped == 1:
                    logger.warning(
                        f"event journal write to {self.path} failed "
                        f"({err}); further failures drop silently"
                    )

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


def _json_safe(obj):
    """Last-resort coercion for event fields (numpy scalars, 0-d tensors,
    paths, exceptions): a stringy record beats a lost one."""
    try:
        import numpy as np

        if isinstance(obj, np.generic):
            return obj.item()
    except ImportError:
        pass
    item = getattr(obj, "item", None)
    if callable(item) and getattr(obj, "ndim", None) == 0:
        try:
            return item()
        except Exception:
            pass
    return repr(obj)


# ---------------------------------------------------------------------------
# module-level journal (one per process)
# ---------------------------------------------------------------------------

_journal: Optional[Journal] = None


def journal_dir(args) -> str:
    """Where this run's journals live: ``--telemetry-dir`` when set, else
    ``<save_dir>/telemetry``."""
    explicit = getattr(args, "telemetry_dir", None)
    if explicit:
        return explicit
    save_dir = getattr(args, "save_dir", None) or "."
    return os.path.join(save_dir, _JOURNAL_DIRNAME)


def journal_file(directory: str, rank: int, role: str = "") -> str:
    """Per-process journal path; a role other than the trainer's gets its
    own file (two processes appending one file can tear lines)."""
    suffix = f"_{role}" if role and role != "trainer" else ""
    return os.path.join(directory, f"events_rank{int(rank)}{suffix}.jsonl")


def configure(args, *, rank: int,
              step_provider: Optional[Callable[[], int]] = None,
              role: Optional[str] = None) -> Journal:
    """Install the per-process journal (idempotent per (path, attempt)).
    ``role`` lands in a ``run-start`` record, so merged timelines show which
    plane wrote each file."""
    global _journal
    path = journal_file(journal_dir(args), rank, role or "")
    att = attempt()
    if _journal is not None and _journal.path == path and _journal.attempt == att:
        return _journal
    _journal = Journal(path, run_id=ensure_run_id(), rank=rank, attempt=att,
                       step_provider=step_provider)
    if role is not None:
        _journal.emit("run-start", role=role)
    return _journal


def active() -> Optional[Journal]:
    return _journal


def journal_path() -> Optional[str]:
    return _journal.path if _journal is not None else None


def reset() -> None:
    """Drop the process journal (tests)."""
    global _journal
    if _journal is not None:
        _journal.close()
    _journal = None


def emit(kind: str, **fields) -> None:
    """Append one event to the process journal.  Safe before
    :func:`configure` (the record is dropped) and on any thread."""
    j = _journal
    if j is None:
        logger.debug(f"journal not configured; dropping event {kind!r}")
        return
    try:
        j.emit(kind, **fields)
    except Exception as err:  # pragma: no cover - defensive
        logger.debug(f"journal emit({kind!r}) failed: {err}")
