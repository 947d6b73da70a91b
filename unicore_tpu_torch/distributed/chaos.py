"""Fault injection for training, checkpoint storage and the serving plane
(counterpart of ``unicore_tpu/distributed/chaos.py``):
``--fault-inject KIND[:PARAM]@STEP[@RANK]``.

The robustness plane exists to survive loss spikes and torn or rotten
checkpoints, which never happen in a healthy test run; these hooks make
them on demand, so a test or ``chip_smoke.py`` proves each guard fires.

Kinds (persistent from STEP onward unless noted):

``truncate-checkpoint``
    Checkpoint files written from STEP on are cut to half their size after
    the atomic rename: the torn file the resume fallback must survive.
``bit-flip-checkpoint[:NBYTES]``
    NBYTES (default 1) payload bytes of each checkpoint are flipped after
    every write-side check: bit rot at rest.  A bare ``torch.save`` file
    may still load (into wrong weights); the v2 manifest must reject it.
``disk-full``
    Checkpoint write attempts raise ENOSPC (the ``--on-save-failure``
    ladder).
``slow-disk[:SECS]``
    Checkpoint writes stall SECS (default 5) first (the
    ``--preemption-save-deadline`` over-budget diagnosis).
``raise``
    :class:`ChaosError` out of ``train_step`` at exactly STEP (one-shot).
``loss-spike[:MAGNITUDE]``
    At exactly STEP the update's gradients AND its reported loss are
    scaled by MAGNITUDE (default 100), through the update's normalisation
    denominator (so under ``--fused-adam`` through the ``multi_tensor_l2norm``
    and ``fused_adam`` kernels): the divergence the health sentinel must
    detect, rewind and skip past.  Consumed once the update counter moves
    past STEP, so a rewind that replays the counter cannot refire it.
``grad-explosion[:SCALE]``
    The same, the gradients only: the loss stays healthy and the grad-norm
    detector must fire on its own.
``request-flood[:QPS]@STEP``
    Serving plane: from serve batch STEP on, the serve CLI's synthetic
    traffic generator offers QPS (default 200) requests a second for a
    fixed 10 s window: the admission queue must shed with named reasons
    while admitted requests keep their deadlines.
``slow-client[:SECS]@STEP``
    Serving plane: ONE request after serve batch STEP arrives from a client
    that stalls SECS (default 5) mid-body; the bounded read must answer it
    408 with a named reason instead of wedging a worker.  Consumed after
    one request.
``corrupt-reload@STEP``
    Serving plane: the NEXT hot-reload candidate picked up after serve
    batch STEP gets payload bytes flipped before the verified load reads it
    (the ``bit-flip-checkpoint`` machinery); verify-then-swap must roll back
    and keep serving the old snapshot.  Consumed after one candidate.
``replica-loss@BATCH[@IDX]``
    Serving fleet: the replica whose ``--replica-index`` is IDX (any
    replica when omitted) hard-exits (``os._exit(74)``: no drain, no lease
    goodbye, its key left in the store) once its BATCH-th serve batch has
    dispatched.  The router must shed around it and name it with a
    replica-loss verdict within the lease timeout.  One-shot.
``replica-stall[:SECS]@BATCH[@IDX]``
    Serving fleet: the targeted replica's ``/v1/infer`` handler wedges for
    SECS (default 3600) from batch BATCH on while its lease keeps
    publishing: the zombie whose lease looks healthy.  Only the router's
    deadline-bounded proxy leg sheds around it.

STEP counts updates: the hooks of an update read the counter before it
(``fault_multipliers``, ``maybe_raise``), those of a checkpoint write the
counter after the last update (:func:`note_step`).  The serving kinds count
dispatched serve batches instead (:func:`note_serve_batch`; ``@0`` = from
start-up); the single-process ones take no RANK, and the fleet ones take a
replica index IDX, matched against :func:`set_replica_index` (the serve
CLI's ``--replica-index``).  RANK is a data-parallel rank (:func:`set_rank`):
``raise`` fires on the last rank by default, the storage kinds on rank 0,
which writes the checkpoints.

The JAX package's other kinds raise ``NotImplementedError`` naming where
they are queued: the host-desync, collective and elastic kinds
(``seed-skew``, ``geometry-skew``, ``collective-delay``,
``collective-order-skew``, ``host-loss``, ``heartbeat-stall``,
``kv-outage``) wait for the rest of the parallelism queue (ROADMAP queue A
item 4: the collective watchdog and the elastic run control).  A
plan is process-global (:func:`configure`); :func:`reset` clears it.  With
no ``--fault-inject`` every hook is a cheap no-op.
"""

import errno
import logging
import os
import sys
import time
from typing import Optional

logger = logging.getLogger(__name__)

KINDS = (
    "seed-skew",
    "geometry-skew",
    "collective-delay",
    "truncate-checkpoint",
    "bit-flip-checkpoint",
    "disk-full",
    "slow-disk",
    "raise",
    "loss-spike",
    "grad-explosion",
    "host-loss",
    "heartbeat-stall",
    "kv-outage",
    "collective-order-skew",
    "request-flood",
    "slow-client",
    "corrupt-reload",
    "replica-loss",
    "replica-stall",
)

#: the kinds this port runs
PORTED_KINDS = (
    "truncate-checkpoint",
    "bit-flip-checkpoint",
    "disk-full",
    "slow-disk",
    "raise",
    "loss-spike",
    "grad-explosion",
    "request-flood",
    "slow-client",
    "corrupt-reload",
    "replica-loss",
    "replica-stall",
)

#: where each kind that is not ported waits
_QUEUED = {
    k: "the rest of the parallelism queue (ROADMAP queue A item 4: the collective "
       "watchdog, the consistency guard and the elastic run control)"
    for k in ("seed-skew", "geometry-skew", "collective-delay", "collective-order-skew",
              "host-loss", "heartbeat-stall", "kv-outage")
}

# serving-plane kinds: serving is one process, so they fire on "this" rank
# and @RANK is refused
_SERVE_KINDS = ("request-flood", "slow-client", "corrupt-reload")

# serving-fleet kinds: the third field is a replica index, matched against
# set_replica_index, never a process rank
_REPLICA_KINDS = ("replica-loss", "replica-stall")

# metric faults feed every rank's update identically: @RANK is refused
_ALL_RANK_KINDS = ("loss-spike", "grad-explosion")

# checkpoint-storage kinds act where checkpoints are written (rank 0)
_CKPT_WRITER_KINDS = ("truncate-checkpoint", "bit-flip-checkpoint", "disk-full", "slow-disk")

_DEFAULT_FAULT_MAGNITUDE = 100.0
_DEFAULT_FLIP_BYTES = 1
_DEFAULT_SLOW_DISK_SECONDS = 5.0

#: this process's rank and the world's size (``set_rank``, from the
#: process group)
_RANK = 0
_WORLD_SIZE = 1


def set_rank(rank: int, world_size: int) -> None:
    """This process's data-parallel rank and the world size: a fault
    without ``@RANK`` fires on the last rank, a storage fault on rank 0."""
    global _RANK, _WORLD_SIZE
    _RANK, _WORLD_SIZE = int(rank), int(world_size)


class ChaosError(RuntimeError):
    """The injected mid-update failure (``raise`` kind)."""


class FaultPlan:
    """One parsed ``KIND[:PARAM]@STEP[@RANK]`` spec."""

    def __init__(self, kind: str, step: int, rank: Optional[int] = None,
                 param: Optional[float] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind '{kind}' (choose from {', '.join(KINDS)})")
        if kind in _QUEUED:
            raise NotImplementedError(
                f"--fault-inject '{kind}' is not ported to unicore_tpu_torch; it waits "
                f"for {_QUEUED[kind]}.  Ported kinds: {', '.join(PORTED_KINDS)}")
        if kind in _ALL_RANK_KINDS and rank is not None:
            raise ValueError(
                f"'{kind}' fires on every rank (its multipliers feed every rank's "
                "update alike — a per-rank value would desync the ranks); drop the "
                "@RANK part")
        if kind in _SERVE_KINDS and rank is not None:
            raise ValueError(
                f"'{kind}' targets the single-process serving plane; drop the @RANK part")
        self.kind = kind
        self.step = step
        # for _REPLICA_KINDS: the replica index (None = any replica)
        self._rank = rank
        self.param = param
        #: one-shot metric faults never refire after the counter has moved
        #: past STEP (a sentinel rewind replays the counter through it)
        self.consumed = False

    @property
    def rank(self) -> int:
        if self._rank is not None:
            return self._rank
        if self.kind in _CKPT_WRITER_KINDS:
            return 0
        return _WORLD_SIZE - 1

    def on_this_rank(self) -> bool:
        if self.kind in _REPLICA_KINDS:
            return self._rank is None or self._rank == _replica_index
        return self.kind in _ALL_RANK_KINDS or self.kind in _SERVE_KINDS or _RANK == self.rank

    def active(self, step: int) -> bool:
        """Persistent kinds stay on from ``self.step`` onward."""
        return step >= self.step and self.on_this_rank()

    def __repr__(self):
        if self.kind in _REPLICA_KINDS:
            idx = self._rank if self._rank is not None else "<any>"
            return f"FaultPlan({self.kind}@{self.step}@replica{idx})"
        if self.kind in _SERVE_KINDS:
            return f"FaultPlan({self.kind}@{self.step}@serve)"
        if self.kind in _ALL_RANK_KINDS:
            return f"FaultPlan({self.kind}@{self.step}@all-ranks)"
        if self._rank is not None:
            rank = self._rank
        elif self.kind in _CKPT_WRITER_KINDS:
            rank = "<writer:0>"
        else:
            rank = "<last>"
        return f"FaultPlan({self.kind}@{self.step}@rank{rank})"


def parse_fault_spec(spec: str) -> FaultPlan:
    """``KIND[:PARAM]@STEP[@RANK]`` -> :class:`FaultPlan`."""
    parts = spec.split("@")
    if len(parts) not in (2, 3):
        raise ValueError(f"--fault-inject expects KIND[:PARAM]@STEP[@RANK], got '{spec}'")
    kind = parts[0]
    param = None
    if ":" in kind:
        kind, raw = kind.split(":", 1)
        param = float(raw)
    step = int(parts[1])
    rank = int(parts[2]) if len(parts) == 3 else None
    return FaultPlan(kind, step, rank, param)


_plan: Optional[FaultPlan] = None
_last_step: int = 0
# the monotonic clock when the request-flood window opened
_window_started: Optional[float] = None
# which fleet replica this process is (the serve CLI's --replica-index): the
# @IDX of the fleet kinds matches against it
_replica_index: int = 0


def configure(args) -> Optional[FaultPlan]:
    """Install the process-global plan from ``--fault-inject``, or disarm
    a stale one when the flag is unset (an in-process caller running two
    trainers in a row must not leak the first one's fault)."""
    global _plan
    spec = getattr(args, "fault_inject", None)
    if not spec:
        _plan = None
        return None
    _plan = parse_fault_spec(spec)
    logger.warning(f"fault injection ARMED: {_plan} (this is a chaos run)")
    return _plan


def reset() -> None:
    global _plan, _last_step, _window_started, _replica_index
    _plan = None
    _last_step = 0
    _window_started = None
    _replica_index = 0


def set_replica_index(index: int) -> None:
    """Record which fleet replica this process is (the serve CLI's
    ``--replica-index``), so the ``@IDX``-targeted fleet kinds know whether
    they fire here."""
    global _replica_index
    _replica_index = int(index)


def note_step(step: int) -> None:
    """Record the update counter for the hooks outside the update proper
    (the checkpoint writes), and consume a one-shot metric fault once the
    counter has moved past its step."""
    global _last_step
    _last_step = step
    if _plan is not None and _plan.kind in _ALL_RANK_KINDS and step > _plan.step:
        _plan.consumed = True


def fault_multipliers(step: int):
    """``(loss_mul, grad_mul)`` of the update that starts at counter
    ``step``: both 1.0 except at exactly the armed ``loss-spike`` /
    ``grad-explosion`` step, and never again once it is consumed."""
    if (_plan is None or _plan.kind not in _ALL_RANK_KINDS or _plan.consumed
            or step != _plan.step):
        return 1.0, 1.0
    mag = float(_plan.param if _plan.param is not None else _DEFAULT_FAULT_MAGNITUDE)
    logger.warning(f"chaos: injecting {_plan.kind} x{mag:g} into update {step}")
    if _plan.kind == "loss-spike":
        return mag, 1.0
    return 1.0, mag


def maybe_truncate_checkpoint(path: str) -> None:
    """Cut a just-written checkpoint to half its size (a torn write that
    survived the rename)."""
    if _plan is None or _plan.kind != "truncate-checkpoint" or not _plan.active(_last_step):
        return
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        logger.warning(f"chaos: truncated checkpoint {path} from {size} to {size // 2} bytes")
    except OSError as e:
        logger.warning(f"chaos: could not truncate {path}: {e}")


def maybe_bit_flip_checkpoint(path: str) -> None:
    """Flip payload bytes of a just-written checkpoint, after every
    write-side check (fsync, rename, read-back), as real rot would: only
    the verified load can catch it."""
    if _plan is None or _plan.kind != "bit-flip-checkpoint" or not _plan.active(_last_step):
        return
    nbytes = int(_plan.param) if _plan.param is not None else _DEFAULT_FLIP_BYTES
    try:
        _flip_payload_bytes(path, nbytes)
        logger.warning(
            f"chaos: flipped {nbytes} payload byte(s) of checkpoint {path} (silent bit "
            "rot at rest; a bare torch.save file might load it — the v2 manifest must "
            "reject it)")
    except OSError as e:
        logger.warning(f"chaos: could not bit-flip {path}: {e}")


def _flip_payload_bytes(path: str, nbytes: int) -> None:
    """Flip ``nbytes`` bytes, spread evenly (the midpoints of ``nbytes``
    equal slices), inside the manifested payload of a v2 file, or inside
    the last three quarters of any other file."""
    from unicore_tpu_torch.checkpoint import format as ckpt_format

    size = os.path.getsize(path)
    bounds = ckpt_format.payload_bounds(path)
    lo, hi = bounds if bounds is not None else (size // 4, size)
    span = max(1, hi - lo)
    with open(path, "r+b") as f:
        for i in range(nbytes):
            off = lo + (span * (2 * i + 1)) // (2 * nbytes)
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0x01]))


def maybe_disk_full(path: str) -> None:
    """Raise ENOSPC out of a checkpoint write attempt."""
    if _plan is None or _plan.kind != "disk-full" or not _plan.active(_last_step):
        return
    logger.warning(f"chaos: injecting ENOSPC into checkpoint write {path}")
    raise OSError(errno.ENOSPC, f"chaos: injected disk-full writing {path}")


def maybe_slow_disk(path: str) -> None:
    """Stall a checkpoint write (default 5 s)."""
    if _plan is None or _plan.kind != "slow-disk" or not _plan.active(_last_step):
        return
    delay = float(_plan.param) if _plan.param is not None else _DEFAULT_SLOW_DISK_SECONDS
    logger.warning(f"chaos: slow disk — delaying checkpoint write {path} by {delay:.1f}s")
    time.sleep(delay)


def maybe_raise(step: int) -> None:
    if (_plan is not None and _plan.kind == "raise" and _plan.on_this_rank()
            and step == _plan.step):
        raise ChaosError(f"injected mid-update failure at step {step} (--fault-inject)")


# ---------------------------------------------------------------------------
# serving-plane kinds (serve/, cli/serve.py)
# ---------------------------------------------------------------------------

_DEFAULT_FLOOD_QPS = 200.0
_FLOOD_WINDOW_SECONDS = 10.0
_DEFAULT_SLOW_CLIENT_SECONDS = 5.0


def note_serve_batch(seq: int) -> None:
    """Record serving progress: the serving kinds' STEP counts dispatched
    serve batches."""
    global _last_step
    _last_step = seq
    maybe_replica_loss(seq)


#: the hard-exit status of a ``replica-loss`` kill (the JAX package's
#: ``host-loss`` status, elastic.EXIT_WORKER_KILLED there)
HOST_LOSS_EXIT_CODE = 74
_DEFAULT_REPLICA_STALL_SECONDS = 3600.0


def maybe_replica_loss(seq: int) -> None:
    """``replica-loss``: hard-exit the targeted replica: ``os._exit``, no
    drain, no lease goodbye, the key left in the store.  The router learns
    of it only from connect failures and the silent lease."""
    if (_plan is None or _plan.kind != "replica-loss" or _plan.consumed
            or not _plan.active(seq)):
        return
    _plan.consumed = True
    logger.warning(
        f"chaos: REPLICA LOSS — replica {_replica_index} hard-exiting after serve "
        f"batch {seq} (no drain, no lease goodbye; the router must shed around "
        "the silence)")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(HOST_LOSS_EXIT_CODE)


def _windowed_active(kind: str, default_secs: float) -> bool:
    """True while a wall-clock-windowed fault is live: from the first call
    at or after STEP, for [:SECS] (default ``default_secs``) seconds."""
    global _window_started
    if _plan is None or _plan.kind != kind or not _plan.active(_last_step):
        return False
    window = float(_plan.param if _plan.param is not None else default_secs)
    if _window_started is None:
        _window_started = time.monotonic()
        logger.warning(f"chaos: {kind} window OPEN at step {_last_step} (for {window:g}s)")
    return time.monotonic() - _window_started < window


def replica_stall_active() -> bool:
    """``replica-stall``: True while the targeted replica's ``/v1/infer``
    handler must wedge, its lease publisher beating all the while."""
    return _windowed_active("replica-stall", _DEFAULT_REPLICA_STALL_SECONDS)


def serve_flood_qps() -> float:
    """``request-flood``: the synthetic request rate while the flood window
    is open, else 0.0.  The [:QPS] param is the rate (default 200/s); the
    window is a fixed 10 s from the first call at or after STEP."""
    global _window_started
    if _plan is None or _plan.kind != "request-flood" or not _plan.active(_last_step):
        return 0.0
    qps = float(_plan.param if _plan.param is not None else _DEFAULT_FLOOD_QPS)
    if _window_started is None:
        _window_started = time.monotonic()
        logger.warning(
            f"chaos: request-flood window OPEN at serve batch {_last_step} "
            f"({qps:g} req/s for {_FLOOD_WINDOW_SECONDS:g}s)")
    if time.monotonic() - _window_started >= _FLOOD_WINDOW_SECONDS:
        return 0.0
    return qps


def take_slow_client_delay() -> float:
    """``slow-client``: the stall (seconds) to inject into the NEXT
    request's body read, else 0.0.  Consumed once."""
    if (_plan is None or _plan.kind != "slow-client" or _plan.consumed
            or not _plan.active(_last_step)):
        return 0.0
    _plan.consumed = True
    delay = float(_plan.param if _plan.param is not None else _DEFAULT_SLOW_CLIENT_SECONDS)
    logger.warning(
        f"chaos: slow-client — the next request's body stalls {delay:.1f}s mid-read "
        "(the bounded read path must 408 it, not wedge a worker)")
    return delay


def maybe_corrupt_reload(path: str) -> bool:
    """``corrupt-reload``: flip payload bytes of a hot-reload candidate
    before the verified load reads it; True when the flip happened.
    Consumed once: the reload must reject THIS candidate, roll back and
    keep serving."""
    if (_plan is None or _plan.kind != "corrupt-reload" or _plan.consumed
            or not _plan.active(_last_step)):
        return False
    _plan.consumed = True
    try:
        _flip_payload_bytes(path, _DEFAULT_FLIP_BYTES)
    except OSError as e:
        logger.warning(f"chaos: could not corrupt reload candidate {path}: {e}")
        return False
    logger.warning(
        f"chaos: corrupt-reload — flipped payload byte(s) of reload candidate {path}; "
        "the verified load must reject it and the server must keep serving the old "
        "snapshot")
    return True
