"""Durable writes (counterpart of ``unicore_tpu/checkpoint/durable.py``):
fsync discipline, the ENOSPC preflight, read-back verification and the
save-failure escalation ladder.

``checkpoint_utils.persistent_save`` consults the process-global
:class:`SavePolicy` configured from the parsed args.  A terminal save
failure is not fire-and-forget: each feeds the
:class:`SaveFailureTracker`'s consecutive-failure counter, and
``--on-save-failure abort`` turns it into a raised
:class:`CheckpointWriteError`, so a run whose checkpoints have stopped
landing does not finish looking healthy.
"""

import dataclasses
import errno
import logging
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class CheckpointWriteError(RuntimeError):
    """A checkpoint write failed terminally and ``--on-save-failure
    abort`` escalated it (or the ENOSPC preflight refused to start a write
    that could not finish)."""


@dataclasses.dataclass
class SavePolicy:
    #: 2 = the manifest-verified envelope (checkpoint/format.py); 1 = a
    #: bare ``torch.save`` file.  Both read back.
    write_version: int = 2
    #: re-open and CRC-verify every staged write before it is trusted
    #: (--verify-checkpoint-writes)
    verify_writes: bool = False
    #: what a TERMINAL save failure does: "warn" logs and trains on,
    #: "abort" raises CheckpointWriteError into the training loop
    on_save_failure: str = "warn"


_policy = SavePolicy()


def save_policy() -> SavePolicy:
    return _policy


def configure(args) -> SavePolicy:
    """Install the write policy from parsed args (idempotent)."""
    global _policy
    _policy = SavePolicy(
        write_version=int(getattr(args, "checkpoint_write_version", 2) or 2),
        verify_writes=bool(getattr(args, "verify_checkpoint_writes", False)),
        on_save_failure=str(getattr(args, "on_save_failure", "warn") or "warn"),
    )
    if _policy.verify_writes and _policy.write_version < 2:
        logger.warning(
            "--verify-checkpoint-writes has NOTHING to verify under "
            "--checkpoint-write-version 1: a bare torch.save file carries no "
            "integrity manifest, so every read-back pass is skipped — drop "
            "one of the two flags")
    return _policy


def reset() -> None:
    """Clear the process-global policy and tracker (tests)."""
    global _policy, _tracker
    _policy = SavePolicy()
    _tracker = SaveFailureTracker()


# ---------------------------------------------------------------------------
# fsync discipline
# ---------------------------------------------------------------------------

def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a just-renamed entry survives power loss (the
    rename lives in the directory's metadata).  Best effort: filesystems
    that refuse directory descriptors degrade to no fsync."""
    if os.name != "posix":
        return
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_publish_file(src: str, dst: str) -> None:
    """Copy ``src`` to the final name ``dst`` through a fsync'd sibling
    ``.tmp`` and a rename, so a crash mid-copy never leaves a torn file
    where the previous good checkpoint was."""
    staging = dst + ".tmp"
    shutil.copyfile(src, staging)
    with open(staging, "rb") as f:
        try:
            os.fsync(f.fileno())
        except OSError:
            pass
    os.replace(staging, dst)
    fsync_dir(os.path.dirname(dst))


# ---------------------------------------------------------------------------
# ENOSPC preflight
# ---------------------------------------------------------------------------

def estimate_state_nbytes(obj: Any) -> int:
    """Lower-bound estimate of a checkpoint's serialized size: tensors
    and arrays dominate and serialize about 1:1 (a tensor counts its own
    elements, not a larger storage it views); containers and scalars ride
    a per-node fudge."""
    total = 0
    stack = [obj]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()
        elif isinstance(node, np.ndarray):
            total += int(node.nbytes)
        elif isinstance(node, memoryview):
            total += node.nbytes  # len() counts ELEMENTS on typed views
        elif isinstance(node, (bytes, bytearray)):
            total += len(node)
        elif isinstance(node, str):
            total += len(node.encode("utf-8", "surrogatepass"))
        elif isinstance(node, dict):
            stack.extend(node.keys())
            stack.extend(node.values())
            total += 64
        elif isinstance(node, (list, tuple, set, frozenset)):
            stack.extend(node)
            total += 64
        else:
            total += 64
    return total


def preflight_free_space(directory: str, need_bytes: int) -> None:
    """Refuse to START a write the filesystem cannot finish (5% + 1 MiB of
    headroom for framing and the envelope).  An unstat-able filesystem
    skips the preflight (the write reports honestly)."""
    try:
        free = shutil.disk_usage(directory or ".").free
    except OSError:
        return
    margin = int(need_bytes * 1.05) + (1 << 20)
    if free < margin:
        raise CheckpointWriteError(
            f"ENOSPC preflight: ~{margin} bytes needed for the checkpoint "
            f"but only {free} free in {directory or '.'} — refusing to "
            "start a write that cannot finish (free disk or lower the "
            "checkpoint cadence/retention)")


def is_enospc(err: BaseException) -> bool:
    return isinstance(err, OSError) and err.errno == errno.ENOSPC


def drop_page_cache(path: str) -> None:
    """Best-effort eviction of ``path`` from the page cache, so a
    read-back verification reads the media, not the kernel's copy of what
    was just written."""
    if not hasattr(os, "posix_fadvise"):
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# save-failure escalation
# ---------------------------------------------------------------------------

class SaveFailureTracker:
    """Counts terminal save failures: ``consecutive`` resets on the next
    successful save, ``total`` never does.  Failures noted from the async
    publish pool (which must never raise) are parked and escalated at the
    next save on the training thread.  The counters are lock-guarded: the
    pool thread's ``note_failure`` races the training thread's
    ``escalate_pending``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.consecutive = 0
        self.total = 0
        self.last_error: Optional[str] = None
        self.last_path: Optional[str] = None
        self._async_pending = 0

    def note_failure(self, path: str, err: BaseException, from_async: bool = False) -> None:
        with self._lock:
            self.consecutive += 1
            self.total += 1
            self.last_error = f"{type(err).__name__}: {err}"
            self.last_path = path
            if from_async:
                self._async_pending += 1
            consecutive, total = self.consecutive, self.total
        logger.error(f"CHECKPOINT SAVE FAILED ({consecutive} consecutive, {total} total "
                     f"this run): {path} ({self.last_error})")

    def note_success(self) -> None:
        with self._lock:
            self.consecutive = 0

    def token(self) -> Optional[Tuple[int, int]]:
        """(consecutive, total) once any save has failed, else None."""
        with self._lock:
            if self.total == 0:
                return None
            return (self.consecutive, self.total)

    def escalate_pending(self) -> None:
        """Raise for failures parked by the async publish pool when the
        policy says abort (called on the training thread at every save)."""
        with self._lock:
            pending = self._async_pending
            self._async_pending = 0
        if pending and _policy.on_save_failure == "abort":
            raise CheckpointWriteError(
                f"{pending} checkpoint publish(es) failed on the async copy pool "
                f"(last: {self.last_path}: {self.last_error}) and "
                "--on-save-failure abort is set")


_tracker = SaveFailureTracker()


def tracker() -> SaveFailureTracker:
    return _tracker


def save_failure_token() -> Optional[Tuple[int, int]]:
    """The tracker's (consecutive, total) token.  The JAX package folds it
    into its cross-host consistency fingerprint (``save_health``); the
    port has no such fingerprint yet (one process), so nothing reads it
    here so far."""
    return _tracker.token()
