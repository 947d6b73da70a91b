"""Checkpoints of the port (counterpart of ``unicore_tpu/checkpoint_utils.py``):
the save-name matrix and retention, the best score, the restore decision
with its corrupt-file fallback, durable save/load, and the JAX <-> port
weight-name map.

A port checkpoint is the dict ``{"args": Namespace, "model": state_dict,
...}``; the trainer's adds the JAX package's groups: ``optimizer_state``,
``optimizer_history`` (lr scheduler, update count), ``extra_state``
(iterator position, validation loss, best score, meters, training time,
the health sentinel's history) and ``ema``; the server reads only
``args`` and ``model``.  On disk it is, by default, the ``torch.save``
stream of that dict in the format v2 envelope
(``checkpoint/format.py``: a header and a CRC32 manifest verified before
the payload is loaded), or under ``--checkpoint-write-version 1`` a bare
``torch.save`` file; both load, with ``torch.load(weights_only=True)`` and
``argparse.Namespace`` as the one extra type, so loading runs no pickled
code.  Checkpoints written by ``unicore-tpu-train`` may hold objects of
the JAX stack and are not read; :func:`from_jax_params` carries weights
across.

Writes are durable (:func:`persistent_save`): a staged ``.tmp``, fsync of
the file and its directory, a rename, retries with backoff, an ENOSPC
preflight, ``--verify-checkpoint-writes`` and the ``--on-save-failure``
ladder.  :func:`save_checkpoint` writes the checkpoint under its first
name in ``--tmp-save-dir`` (the port's default: ``--save-dir``) and
publishes it under the others on a copy thread (``--async-checkpoint``),
then prunes; a SIGTERM under ``--preemption-save-deadline`` and a fatal
error under ``--emergency-save-on-error`` take the minimal path
(:func:`_emergency_save_checkpoint`).  :func:`load_checkpoint` falls back
to the newest retained checkpoint when the ``checkpoint_last`` it resumes
is corrupt.

Under data parallelism every rank calls both: rank 0 alone stages, writes
and publishes (the ranks hold the same state), and a barrier follows
before any rank goes on; every rank loads the same file, and a torn file on
one rank sends every rank to the fallback rank 0 names.

Each outcome is journaled with the JAX package's fields:
``checkpoint-save``, ``checkpoint-publish``, ``checkpoint-emergency`` and
``checkpoint-fallback``.
"""

import argparse
import ast
import logging
import os
import re
import time
import traceback
from collections import OrderedDict
from multiprocessing.pool import ThreadPool
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.checkpoint import durable as _durable
from unicore_tpu_torch.checkpoint import emergency as _emergency
from unicore_tpu_torch.checkpoint import format as _format
from unicore_tpu_torch.checkpoint.durable import CheckpointWriteError  # noqa: F401
from unicore_tpu_torch.checkpoint.format import CorruptCheckpointError
from unicore_tpu_torch.utils import retry

logger = logging.getLogger(__name__)


def write_checkpoint(path: str, args: argparse.Namespace,
                     state_dict: Mapping[str, torch.Tensor], **extra) -> bool:
    """Write ``{"args", "model", **extra}`` through :func:`persistent_save`
    (returns its result); tensors in ``extra`` are saved from the CPU too,
    each in its own storage (a ``--fused-adam`` parameter is a view into a
    flat buffer, which ``torch.save`` would store whole).  The v2 header
    records the update count and the checkpoint suffix."""
    state = {
        "args": args,
        "model": OrderedDict(
            (k, _to_cpu(v)) for k, v in state_dict.items()
        ),
        **{k: _to_cpu(v) for k, v in extra.items()},
    }
    history = extra.get("optimizer_history") or [{}]
    meta = {"step": history[-1].get("num_updates"),
            "suffix": getattr(args, "checkpoint_suffix", "")}
    return persistent_save(state, path, meta=meta)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        return t
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def load_checkpoint_to_cpu(path: str) -> Dict[str, Any]:
    """Load a port checkpoint onto the CPU without running pickled code: a
    v2 file after its manifest is verified, any other file as a bare
    ``torch.save`` one (today's legacy checkpoints and those written with
    :func:`from_jax_params`).  ANY failure to read or decode the file
    (a flipped byte in a zip raises ``RuntimeError``,
    ``pickle.UnpicklingError`` and more) raises
    :class:`CorruptCheckpointError`, so the resume fallback keys on the file
    layer."""
    try:
        if _format.is_v2(path):
            header, state = _format.read(path, verify_payload=True)
            logger.info(f"checkpoint manifest verified: {path} (v2, step "
                        f"{header.get('step', '?')})")
        else:
            state = _format.load_payload(path)
        if not isinstance(state, dict):
            raise ValueError(f"not a checkpoint dict: {type(state).__name__}")
    except CorruptCheckpointError:
        raise  # the verifier's diagnosis, as it is
    except Exception as e:
        raise CorruptCheckpointError(
            f"could not read/decode checkpoint {path} ({type(e).__name__}: {e})") from e
    return state


def persistent_save(obj, filename: str, attempts: int = 3, backoff: float = 0.5,
                    meta: Optional[Dict[str, Any]] = None) -> bool:
    """Durable atomic save, the one checkpoint write path.

    Stages a sibling ``.tmp``, fsyncs the file AND its directory, then
    renames it over the target, so readers never see a torn file and a
    power loss cannot forget the rename.  The payload is the ``torch.save``
    stream in the v2 envelope (``meta`` joins its header), or a bare
    ``torch.save`` file under ``--checkpoint-write-version 1``.  An ENOSPC
    preflight refuses a write the disk cannot finish, and
    ``--verify-checkpoint-writes`` re-reads the staged file and checks its
    CRCs before the rename.

    Transient errors get ``attempts`` tries with exponential backoff
    (``backoff * 2**attempt`` s, :func:`~unicore_tpu_torch.utils.retry.retry_call`);
    ENOSPC is not retried.  A TERMINAL failure feeds the save-failure
    tracker and then follows ``--on-save-failure``: ``warn`` logs and
    returns False, ``abort`` raises :class:`CheckpointWriteError`.  Returns
    True once the write landed.  Inside an emergency deadline scope
    (``--preemption-save-deadline``) there is one attempt and no read-back:
    retries eat a budget that exists once."""
    from unicore_tpu_torch.distributed import chaos

    policy = _durable.save_policy()
    deadline = _emergency.active_deadline()
    if deadline is not None:
        attempts = 1
    scratch = filename + ".tmp"
    directory = os.path.dirname(filename)

    def _terminal_failure(err):
        _durable.tracker().note_failure(filename, err)
        try:
            if os.path.lexists(scratch):
                os.remove(scratch)  # never leave a torn .tmp eating disk
        except OSError:
            pass
        if policy.on_save_failure == "abort":
            raise CheckpointWriteError(
                f"checkpoint save to {filename} failed terminally "
                f"({type(err).__name__}: {err}) and --on-save-failure abort is set"
            ) from err
        logger.error(f"checkpoint save to {filename} failed terminally; training "
                     "continues WITHOUT a fresh checkpoint (--on-save-failure warn):\n"
                     + traceback.format_exc())
        return False

    try:
        _durable.preflight_free_space(directory, _durable.estimate_state_nbytes(obj))
    except CheckpointWriteError as e:
        if policy.on_save_failure == "abort":
            _durable.tracker().note_failure(filename, e)
            raise
        return _terminal_failure(e)

    def _write_once():
        chaos.maybe_slow_disk(filename)
        chaos.maybe_disk_full(filename)
        if policy.write_version >= 2:
            _format.write(obj, scratch, meta=meta)
        else:
            with open(scratch, "wb") as f:
                torch.save(obj, f)
                f.flush()
                os.fsync(f.fileno())
        if policy.verify_writes and deadline is None and _format.is_v2(scratch):
            # read back the STAGED file before the rename publishes it, from
            # the media (page cache dropped), while the previous good file
            # still stands under the final name
            _durable.drop_page_cache(scratch)
            _format.verify(scratch)
        os.rename(scratch, filename)
        _durable.fsync_dir(directory)
        # chaos at-rest damage LAST: it must slip past every write-side
        # check, as real bit rot does
        chaos.maybe_truncate_checkpoint(filename)
        chaos.maybe_bit_flip_checkpoint(filename)

    def _warn_retry(err, attempt, delay):
        logger.warning(f"checkpoint write to {filename} failed (attempt {attempt + 1}/"
                       f"{attempts}); retrying in {delay:.1f}s:\n"
                       + traceback.format_exc(limit=2))

    try:
        retry.retry_call(_write_once, retry.RetryPolicy(attempts=attempts, backoff=backoff),
                         giveup=_durable.is_enospc, on_retry=_warn_retry)
    except Exception as e:
        return _terminal_failure(e)
    _durable.tracker().note_success()
    return True


def upgrade_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A checkpoint of the earlier port layout (``optimizer``,
    ``lr_scheduler``, ``num_updates``, ``epoch_itr`` beside ``args`` and
    ``model``) in the current one; any other dict as it is."""
    if "num_updates" not in state or "optimizer_history" in state:
        return state
    return {
        "args": state["args"],
        "model": state["model"],
        "optimizer_state": state.get("optimizer"),
        "optimizer_history": [{"optimizer_name": None,
                               "lr_scheduler_state": state.get("lr_scheduler", {}),
                               "num_updates": state["num_updates"]}],
        "extra_state": ({"train_iterator": state["epoch_itr"]}
                        if "epoch_itr" in state else None),
    }


# ---------------------------------------------------------------------------
# best-metric tracking
# ---------------------------------------------------------------------------

_best_score: Optional[float] = None


def best_score() -> Optional[float]:
    return _best_score


def set_best_score(value: Optional[float]) -> None:
    global _best_score
    _best_score = value


def _track_best(args, val_loss) -> bool:
    """Fold a new validation score into the running best; True when it
    ties or beats the best so far (the checkpoint earns the 'best'
    name)."""
    global _best_score
    if val_loss is None:
        return False
    if args.maximize_best_checkpoint_metric:
        tied_or_better = _best_score is None or val_loss >= _best_score
    else:
        tied_or_better = _best_score is None or val_loss <= _best_score
    if tied_or_better:
        _best_score = val_loss
    return tied_or_better


# ---------------------------------------------------------------------------
# names, publish and retention
# ---------------------------------------------------------------------------

def checkpoint_paths(path, pattern=r"checkpoint(\d+)\.pt"):
    """Every file in ``path`` matching ``pattern``, sorted descending by
    the first regex group."""
    if not os.path.isdir(path):
        return []
    rx = re.compile(pattern)

    def rank(match, fallback):
        return float(match.group(1)) if match.groups() else fallback

    hits = [(rank(m, i), name) for i, name in enumerate(os.listdir(path))
            if (m := rx.fullmatch(name))]
    hits.sort(reverse=True)
    return [os.path.join(path, name) for _, name in hits]


def _remove_checkpoint(path):
    if os.path.lexists(path):
        os.remove(path)
        logger.info(f"removed {path}")


def _publish_one(src, dst):
    """``src`` under the final name ``dst`` through a fsync'd sibling
    ``.tmp`` and a rename, so a crash mid-copy never destroys the previous
    checkpoint under ``dst``."""
    _durable.atomic_publish_file(src, dst)


def _staging_dir(args) -> str:
    """Where a checkpoint is written before it is published: ``--tmp-save-dir``,
    or ``--save-dir`` when that is unset (the port's default: the JAX
    CLI's ``./`` would stage into the working directory, where two runs
    collide)."""
    return getattr(args, "tmp_save_dir", None) or args.save_dir


#: seconds of each staged write and each publish of this process (the
#: train CLI's stats line reports them)
_save_seconds = {"write": [], "publish": []}


def save_seconds() -> Dict[str, list]:
    return {k: list(v) for k, v in _save_seconds.items()}


def reset_save_seconds() -> None:
    for v in _save_seconds.values():
        v.clear()


class CopyPool:
    """The one publish thread of ``--async-checkpoint``.  It keeps the last
    publish it queued, so a write staged under a final name can wait for
    the older publishes that still target that name."""

    def __init__(self):
        self._pool = ThreadPool(processes=1)
        self._last = None

    def apply_async(self, fn, args):
        self._last = self._pool.apply_async(fn, args)
        return self._last

    def wait(self):
        if self._last is not None:
            self._last.wait()

    def close(self):
        self._pool.close()

    def join(self):
        self._pool.join()


def make_copy_pool() -> CopyPool:
    return CopyPool()


def _retention_rules(args, end_of_epoch):
    """The pruning policy as (pattern, how many to keep, best first?)
    rows.  Update-interval pruning waits at epoch boundaries, so an epoch
    save never evicts the freshest mid-epoch checkpoints."""
    rules = []
    if args.keep_interval_updates > 0 and not end_of_epoch:
        rules.append((r"checkpoint_\d+_(\d+)\.pt", args.keep_interval_updates, True))
    if args.keep_last_epochs >= 0:
        rules.append((r"checkpoint(\d+)\.pt", args.keep_last_epochs, True))
    if args.keep_best_checkpoints > 0:
        metric_pat = r"checkpoint\.best_{}_(-?\d+\.?\d*)(?:_\d+)?\.pt".format(
            args.best_checkpoint_metric)
        rules.append((metric_pat, args.keep_best_checkpoints,
                      args.maximize_best_checkpoint_metric))
    return rules


def ckp_copy_fun(src, checkpoints, end_of_epoch, args):
    """Publish the staged checkpoint ``src`` under every other name in
    ``checkpoints`` (:func:`_publish_one`), drop the staged file when it was
    staged apart, then prune by :func:`_retention_rules`.  It runs on the
    copy thread under ``--async-checkpoint``, so it never raises: a failed
    publish is parked in the save-failure tracker and escalated at the next
    save on the training thread."""
    t0 = time.monotonic()
    published = 0
    for dst in checkpoints:
        if dst == src:
            continue
        try:
            _publish_one(src, dst)
            published += 1
            logger.info(f"copied {src} to {dst}")
        except Exception as e:
            _durable.tracker().note_failure(dst, e, from_async=True)
            logger.info("copy failed, please copy it manually")
    telemetry.emit("checkpoint-publish", staged=src, published=published,
                   names=[str(p) for p in checkpoints])
    try:
        staged_apart = (os.path.abspath(os.path.dirname(src))
                        != os.path.abspath(args.save_dir))
        if staged_apart and published and os.path.lexists(src):
            _remove_checkpoint(src)
        for pattern, keep, best_first in _retention_rules(args, end_of_epoch):
            ranked = checkpoint_paths(args.save_dir, pattern=pattern)
            if not best_first:
                ranked.reverse()
            for stale in ranked[keep:]:
                _remove_checkpoint(stale)
    except Exception:
        logger.info("remove old ckps error")
    seconds = time.monotonic() - t0
    _save_seconds["publish"].append(seconds)
    logger.info(f"published {src} under {published} more name(s) in {seconds:.3f}s")


def _checkpoint_names(args, suffix, epoch, updates, end_of_epoch, val_loss,
                      is_new_best):
    """Every name the current checkpoint is published under; the first is
    the one written, the rest are copies."""
    names = []
    if (end_of_epoch and not args.no_epoch_checkpoints
            and epoch % args.save_interval == 0):
        names.append(f"checkpoint{epoch}{suffix}.pt")
    if (not end_of_epoch and args.save_interval_updates > 0
            and updates % args.save_interval_updates == 0):
        names.append(f"checkpoint_{epoch}_{updates}{suffix}.pt")
    if is_new_best:
        names.append(f"checkpoint_best{suffix}.pt")
        if args.keep_best_checkpoints > 0:
            names.append("checkpoint.best_{}_{:.2f}_{}.pt".format(
                args.best_checkpoint_metric, val_loss, updates))
    if not args.no_last_checkpoints:
        names.append(f"checkpoint_last{suffix}.pt")
    return names


def save_checkpoint(args, trainer, epoch_itr, val_loss, ckp_copy_thread=None,
                    do_save=True, emergency=None):
    """:func:`_save_checkpoint` on rank 0, the best score on every rank,
    then a barrier (none after the ``"error"`` emergency save: the failing
    rank may be alone).  Under ZeRO every rank first gathers the sharded
    state whole for rank 0 (``trainer.consolidate_state``; not on the
    ``"error"`` path, which then saves the weights without it).  Other
    ranks return None."""
    from unicore_tpu_torch.distributed import utils as distributed_utils

    consolidate = getattr(trainer, "consolidate_state", None)
    if consolidate is not None and emergency != "error" and do_save and not args.no_save:
        consolidate()
    try:
        if distributed_utils.is_master():
            names = _save_checkpoint(args, trainer, epoch_itr, val_loss, ckp_copy_thread,
                                     do_save, emergency)
        else:
            names = None
            if emergency is None:
                _track_best(args, val_loss)
    finally:
        release = getattr(trainer, "release_consolidated", None)
        if release is not None:
            release()
    if emergency != "error":
        distributed_utils.barrier("save_checkpoint")
    return names


def _save_checkpoint(args, trainer, epoch_itr, val_loss, ckp_copy_thread=None,
                     do_save=True, emergency=None):
    """Fold ``val_loss`` into the best score, write the checkpoint under
    the first of its names in the staging directory (:func:`_staging_dir`),
    and publish it under the others and prune (:func:`ckp_copy_fun`), on
    ``ckp_copy_thread`` when one is given.  A staged write that did not
    land is not published.

    ``emergency`` takes the minimal path (:func:`_emergency_save_checkpoint`):
    ``"preempt"`` (a SIGTERM under ``--preemption-save-deadline``) writes a
    ``checkpoint_last`` straight into ``--save-dir``; ``"error"``
    (``--emergency-save-on-error``) writes ``checkpoint_emergency``, a name
    the resume never picks."""
    if emergency is not None:
        # no escalation of parked publish failures here: this save's loss
        # is the one that cannot be recovered (the process is exiting)
        if args.no_save or not do_save:
            return None
        return _emergency_save_checkpoint(args, trainer, epoch_itr, val_loss, emergency,
                                          ckp_copy_thread)
    _durable.tracker().escalate_pending()
    is_new_best = _track_best(args, val_loss)
    if args.no_save or not do_save:
        return None
    staging = _staging_dir(args)
    os.makedirs(args.save_dir, exist_ok=True)
    os.makedirs(staging, exist_ok=True)
    epoch, updates = epoch_itr.epoch, trainer.get_num_updates()
    end_of_epoch = epoch_itr.end_of_epoch()
    names = _checkpoint_names(args, args.checkpoint_suffix, epoch, updates,
                              end_of_epoch, val_loss, is_new_best)
    if not names:
        return None
    extra_state = {"train_iterator": epoch_itr.state_dict(), "val_loss": val_loss}
    if _best_score is not None:
        extra_state["best"] = _best_score
    staged = os.path.join(staging, names[0])
    final = [os.path.join(args.save_dir, n) for n in names]
    if ckp_copy_thread is not None and os.path.abspath(staged) == os.path.abspath(final[0]):
        # staged under its final name (--tmp-save-dir is --save-dir): an
        # older publish still queued must not land on a name after this write
        ckp_copy_thread.wait()
    t0 = time.monotonic()
    saved = trainer.save_checkpoint(staged, extra_state)
    seconds = time.monotonic() - t0
    if saved is False:
        # the staged file was cleaned up: publishing would fail on every
        # name, or re-publish a stale staged file of the same name
        logger.error(f"skipping checkpoint publish for epoch {epoch} @ {updates} updates: "
                     f"the staged write {staged} did not land")
        return None
    _save_seconds["write"].append(seconds)
    publish = (staged, final, end_of_epoch, args)
    if ckp_copy_thread is not None:
        ckp_copy_thread.apply_async(ckp_copy_fun, publish)
    else:
        ckp_copy_fun(*publish)
    logger.info(f"saved checkpoint {staged} (epoch {epoch} @ {updates} updates, score "
                f"{val_loss}) (writing took {seconds} seconds)")
    telemetry.emit("checkpoint-save", update=int(updates), epoch=int(epoch), path=staged,
                   names=list(names), val_loss=val_loss, write_seconds=round(seconds, 3))
    return final


def _emergency_save_checkpoint(args, trainer, epoch_itr, val_loss, kind,
                               ckp_copy_thread=None):
    """The deadline-bounded minimal save: ONE fsync'd atomic write of
    ``checkpoint_last`` (``kind="preempt"``) or ``checkpoint_emergency``
    (``kind="error"``) straight into ``--save-dir``, with no staging hop,
    no publish copies, no best-score bookkeeping, no pruning, no read-back
    and no retries.

    The state is written to a staged sibling (``.emg``) first, inside the
    budget; only then is the publish thread drained (a queued publish of
    an OLDER checkpoint must not land on ``checkpoint_last`` after this
    one, but draining first could spend the whole grace period on a slow
    copy); ``os.replace`` publishes last, so a kill at any point leaves
    the previous ``checkpoint_last`` or the new one.  The deadline is
    advisory once the write has started: an over-budget finish logs a
    warning."""
    budget = float(getattr(args, "preemption_save_deadline", 0) or 0)
    deadline = _emergency.Deadline(budget if (kind == "preempt" and budget > 0) else None)
    base = "checkpoint_last" if kind == "preempt" else "checkpoint_emergency"
    name = f"{base}{args.checkpoint_suffix}.pt"
    os.makedirs(args.save_dir, exist_ok=True)
    dest = os.path.join(args.save_dir, name)
    staged = dest + ".emg"
    extra_state = {
        "train_iterator": epoch_itr.state_dict(),
        "val_loss": val_loss,
        "emergency_save": {"kind": kind, "deadline": budget or None},
    }
    if _best_score is not None:
        extra_state["best"] = _best_score
    logger.warning(f"EMERGENCY SAVE ({kind}): writing minimal {name}"
                   + (f" inside a {budget:.1f}s budget" if deadline.budget else ""))
    with _emergency.deadline_scope(deadline):
        saved = trainer.save_checkpoint(staged, extra_state)
    elapsed = deadline.elapsed()
    if saved is not False:
        if ckp_copy_thread is not None:
            ckp_copy_thread.close()
            ckp_copy_thread.join()
        os.replace(staged, dest)  # the previous file stays until this one lands
        _durable.fsync_dir(args.save_dir)
    telemetry.emit("checkpoint-emergency", save_kind=kind, path=dest,
                   landed=saved is not False, seconds=round(elapsed, 3),
                   budget=deadline.budget)
    if saved is False:
        logger.error(f"EMERGENCY SAVE FAILED: {name} did not land after {elapsed:.1f}s — "
                     "exiting WITHOUT a final checkpoint")
    elif deadline.budget and elapsed > deadline.budget:
        logger.warning(
            f"EMERGENCY SAVE over budget: {name} took {elapsed:.1f}s against "
            f"--preemption-save-deadline {deadline.budget:.1f}s — the checkpoint landed, "
            "but raise the deadline (or shrink the state) before the next preemption "
            "cuts it off for real")
    else:
        logger.info(f"EMERGENCY SAVE: wrote minimal {name} in {elapsed:.1f}s (skipped "
                    "publish copies, best-score bookkeeping, retention, and read-back "
                    "verification)")
    return [dest] if saved is not False else None


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

_RESET_KINDS = ("optimizer", "lr_scheduler", "meters", "dataloader")


def _resolve_restore(args, suffix):
    """The file to restore from and which state groups to reset, as the
    JAX package decides: ``(path, {kind: reset?})``.

    * the default ``--restore-file`` resumes ``--save-dir``'s
      ``checkpoint_last``, or, with ``--finetune-from-model`` and no last
      checkpoint yet, starts from the pretrained file with every group
      reset;
    * an explicit ``--restore-file`` loads that file; it conflicts with
      ``--finetune-from-model``;
    * ``--reset-*`` flags conflict with ``--finetune-from-model``, which
      resets everything already."""
    resets = {kind: getattr(args, f"reset_{kind}") for kind in _RESET_KINDS}
    finetune = args.finetune_from_model
    if finetune is not None and any(resets.values()):
        raise ValueError(
            "finetune mode already resets optimizer/lr-scheduler/meters/"
            "dataloader state; drop the explicit --reset-* flags when "
            "using --finetune-from-model"
        )
    if args.restore_file != "checkpoint_last.pt":
        if finetune:
            raise ValueError(
                "a non-default --restore-file conflicts with "
                "--finetune-from-model; pick one starting point: " + str(args)
            )
        path = args.restore_file
        if suffix:
            path = path.replace(".pt", suffix + ".pt")
        return path, resets
    path = os.path.join(args.save_dir, f"checkpoint_last{suffix}.pt")
    if finetune is not None and not os.path.exists(path):
        if not os.path.exists(finetune):
            raise ValueError(
                f"pretrained checkpoint not found at --finetune-from-model "
                f"path: {finetune}"
            )
        path = finetune
        resets = {kind: True for kind in _RESET_KINDS}
        logger.info(f"finetune first launch: initializing weights from {path} with "
                    "fresh optimizer, lr-scheduler, meter, and dataloader state")
    return path, resets


#: what a damaged checkpoint raises to :func:`load_checkpoint`'s fallback:
#: the parse layer's wrapper (:func:`load_checkpoint_to_cpu`) and read I/O
#: failures
CORRUPT_CHECKPOINT_ERRORS = (CorruptCheckpointError, OSError)


def _fallback_checkpoints(save_dir, suffix):
    """The retained checkpoints in ``save_dir`` a resume may fall back to
    (interval, epoch and best; never ``checkpoint_emergency``), newest
    first by mtime."""
    suffix_re = re.escape(suffix or "")
    patterns = (
        rf"checkpoint_\d+_(\d+){suffix_re}\.pt",   # --save-interval-updates
        rf"checkpoint(\d+){suffix_re}\.pt",        # epoch checkpoints
        rf"checkpoint_best{suffix_re}\.pt",
    )
    candidates = []
    seen = set()
    for pattern in patterns:
        for p in checkpoint_paths(save_dir, pattern=pattern):
            ap = os.path.abspath(p)
            if ap not in seen:
                seen.add(ap)
                candidates.append(p)
    candidates.sort(key=os.path.getmtime, reverse=True)
    return candidates


def _gather_load_outcomes(outcome: str):
    """Every rank's load outcome ("loaded" / "missing" / "corrupt"): a file
    torn on one rank must send every rank to the same fallback."""
    from unicore_tpu_torch.distributed import utils as distributed_utils

    return distributed_utils.all_gather_list(outcome)


def _agree_fallback_name(basename):
    """Rank 0's fallback choice binds every rank."""
    from unicore_tpu_torch.distributed import utils as distributed_utils

    return distributed_utils.broadcast_object(basename, 0)


def load_checkpoint(args, trainer):
    """Load the checkpoint :func:`_resolve_restore` names into ``trainer``
    and return its ``extra_state`` (None when there is none): the best
    score is restored unless the optimizer or the meters are reset, and
    the iterator position dropped with ``--reset-dataloader``.

    A corrupt or torn ``checkpoint_last`` (a write torn by a crash, bit rot
    the v2 manifest caught) falls back to the newest retained checkpoint of
    :func:`_fallback_checkpoints` with a warning, then the next, instead of
    ending the run.  Only the implicit ``checkpoint_last`` falls back, as
    in the JAX package: the retained files in ``--save-dir`` belong to this
    run, while a named ``--restore-file`` or a fine-tune's pretrained model
    has no substitute."""
    suffix = args.checkpoint_suffix
    path, resets = _resolve_restore(args, suffix)
    allow_fallback = path == os.path.join(args.save_dir, f"checkpoint_last{suffix}.pt")
    tried = set()
    current = path
    while True:
        err = None
        extra_state = None
        exists = os.path.exists(current)
        try:
            extra_state = trainer.load_checkpoint(
                current, resets["optimizer"], resets["lr_scheduler"], resets["dataloader"],
                ast.literal_eval(args.optimizer_overrides), reset_meters=resets["meters"])
        except CORRUPT_CHECKPOINT_ERRORS as e:
            err = e
        outcome = "corrupt" if err is not None else ("loaded" if exists else "missing")
        outcomes = _gather_load_outcomes(outcome)
        if all(o == "loaded" for o in outcomes) or all(o == "missing" for o in outcomes):
            break
        tried.add(os.path.basename(current))
        candidates = ([p for p in _fallback_checkpoints(args.save_dir, suffix)
                       if os.path.basename(p) not in tried] if allow_fallback else [])
        choice = _agree_fallback_name(os.path.basename(candidates[0]) if candidates else None)
        if choice is None:
            logger.error(f"checkpoint {current} is corrupt/truncated "
                         f"({type(err).__name__}: {err}) and no retained fallback "
                         f"checkpoint exists in {args.save_dir}")
            raise err
        nxt = os.path.join(args.save_dir, choice)
        if err is not None:
            detail = f"failed to load ({type(err).__name__}: {err})"
        elif outcome == "missing":
            detail = "is missing on this host while peers have a checkpoint"
        else:
            detail = "was reported corrupt/missing by a peer host"
        logger.warning(
            f"CHECKPOINT CORRUPT: {current} {detail}; "
            f"falling back to the next-newest retained checkpoint {nxt} — training "
            "resumes from an OLDER state than the torn file recorded")
        telemetry.emit("checkpoint-fallback", corrupt=current, fallback=nxt, detail=detail)
        current = nxt
    if extra_state is None:
        return None
    if "best" in extra_state and not (resets["optimizer"] or resets["meters"]):
        set_best_score(extra_state["best"])
    if resets["dataloader"]:
        extra_state.pop("train_iterator", None)
    return extra_state


_LAYER = re.compile(r"^layers_(\d+)$")


def from_jax_params(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """The port's ``state_dict`` for a JAX variables tree of numpy arrays
    (``jax.device_get(model.init(...))`` or a checkpoint's ``model``).

    - a dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
    - an embedding table ``embedding`` becomes ``weight``;
    - ``layers_{i}`` becomes ``layers.{i}``;
    - every other leaf (LayerNorm ``weight``/``bias``, dense ``bias``,
      ``lm_head.bias``, Uni-Mol's ``gbf.means``/``gbf.stds``) keeps its
      name; Uni-Mol's ``gbf.mul``/``gbf.bias`` are embeddings (one column
      per edge type), so their ``embedding`` becomes ``weight``;
    - the Evoformer's ``block_{i}`` modules keep their names (the port
      names its blocks so), as do its ``nn.Embed`` tables' owners;
    - a quantized serving tree (``calibrate.prepare`` of the JAX package):
      ``kernel_q`` (K, N) becomes ``weight_q`` (N, K) in its own type (int8,
      or ``float8_e4m3fn`` carried as its bytes), ``kernel_scale`` becomes
      ``weight_scale``, and ``act_scale``/``out_scale`` keep their names;
    - ``transformer_lm``: ``embed_tokens``, ``embed_positions``,
      ``decoder.{emb_layer_norm, final_layer_norm, relative_attention_bias}``,
      ``decoder.layers_{i}.{self_attn, self_attn_layer_norm,
      final_layer_norm, fc1, fc2}`` and the top-level ``out_bias`` map by
      the rules above (a JAX ``transformer_lm`` has no cross-attention
      parameters, and the port's decoder layer creates none), so the
      result loads with ``load_state_dict(strict=True)``;
    - float leaves keep their type where torch has it: a bf16 leaf (a JAX
      ``--bf16`` run's) is a bf16 tensor of the same bits, read without
      ``ml_dtypes``; fp16 stays fp16; the rest is fp32.
    """
    params = variables["params"] if "params" in variables else variables
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(tree, prefix):
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, Mapping):
                m = _LAYER.match(key)
                walk(val, prefix + [f"layers.{m.group(1)}" if m else key])
                continue
            arr = np.asarray(val)
            if key == "kernel_q":
                out[".".join(prefix + ["weight_q"])] = _quantized_kernel(arr)
                continue
            if key == "kernel_scale":
                key = "weight_scale"
            elif key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(
                        f"{'.'.join(prefix)}.kernel has shape {arr.shape}; "
                        "only 2-D dense kernels are mapped"
                    )
                key, arr = "weight", arr.T
            elif key == "embedding":
                key = "weight"
            out[".".join(prefix + [key])] = _float_tensor(arr)

    walk(params, [])
    return out


def _float_tensor(arr: np.ndarray) -> torch.Tensor:
    """A JAX float leaf as a torch tensor of its own type: bf16 (an
    ``ml_dtypes`` array, which ``torch.from_numpy`` does not take) through
    its 16-bit pattern, fp16 as is, anything else as fp32; always a copy."""
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    if arr.dtype == np.float16:
        return torch.from_numpy(np.array(arr, dtype=np.float16))
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _quantized_kernel(arr: np.ndarray) -> torch.Tensor:
    """A prepared (K, N) ``kernel_q`` as the port's (N, K) ``weight_q``:
    int8 as is; float8 (an ``ml_dtypes`` array, which ``torch.from_numpy``
    does not take) through its bytes."""
    w = np.ascontiguousarray(arr.T)
    if w.dtype == np.int8:
        return torch.from_numpy(w)
    if w.dtype.name != "float8_e4m3fn":
        raise ValueError(f"kernel_q of type {w.dtype} is neither int8 nor float8_e4m3fn")
    return torch.from_numpy(w.view(np.uint8)).view(torch.float8_e4m3fn)


def flax_path(name: str) -> str:
    """A port module path as the JAX package's Flax path (dotted):
    ``layers.{i}`` is ``layers_{i}``."""
    return re.sub(r"(^|\.)layers\.(\d+)(?=\.|$)", r"\1layers_\2", name)


def jax_param_names(model: torch.nn.Module) -> Dict[str, str]:
    """Each parameter's Flax name (dotted path) in the JAX package: the
    inverse of :func:`from_jax_params` — ``layers.{i}`` is ``layers_{i}``,
    a Linear ``weight`` is ``kernel`` and an Embedding ``weight`` is
    ``embedding``."""
    modules = dict(model.named_modules())
    names = {}
    for name, _ in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = modules[owner]
        if leaf == "weight" and isinstance(mod, torch.nn.Linear):
            leaf = "kernel"
        elif leaf == "weight" and isinstance(mod, torch.nn.Embedding):
            leaf = "embedding"
        path = flax_path(owner)
        names[name] = f"{path}.{leaf}" if path else leaf
    return names
