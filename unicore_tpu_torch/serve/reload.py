"""Hot checkpoint reload: poll, verify, probe, swap — or roll back
(counterpart of ``unicore_tpu/serve/reload.py``).

Training keeps publishing checkpoints while the server runs; the server
picks them up without a restart, and a bad checkpoint never takes down a
healthy server.  The protocol, in order:

1. **Poll** (:class:`CheckpointWatcher`): watch the published file
   (``--path``) for a new signature (mtime, size, inode); each version is
   considered exactly once.
2. **Verify** (:class:`HotReloader`): read the candidate only through
   ``checkpoint_utils.load_checkpoint_to_cpu``, which checks every payload
   chunk's CRC against the v2 manifest BEFORE unpickling: rot raises
   ``CorruptCheckpointError`` here, not NaNs in traffic.  Its state dict's
   names and shapes must match the served model's (``structure_ref``): a
   checkpoint of another arch is refused by name.
3. **Stage**: ``make_model`` (the serve CLI's) makes a second instance of
   the served arch on the device, the candidate's tensors assigned in their
   own types (a bf16 candidate of an fp32 server serves in bf16, as the
   JAX engine serves whatever tree it is handed).  Quantized serving adds
   ``preparer`` here: the candidate's scales are reused when its weights
   digest matches the sidecar, else re-derived on the card while the old
   twin keeps serving.
4. **Probe**: one dummy batch through the candidate; an ill-shaped output
   or a non-finite score rejects it.
5. **Swap on a batch boundary**: the candidate goes to
   ``engine.request_swap``; the engine loop applies it between batches.

Any failure in 2-4 is a **rollback**: the serving model stays, readiness
returns to true and a loud ``RELOAD ROLLBACK (<outcome>)`` line names the
stage and cause.  Readiness is false only during verify → swap; requests
already admitted keep being served by the old model throughout.  The
reload thread's kernel launches (probe, calibration) are counted apart
(``engine.reload_launches``).

The decision logic takes ``loader`` / ``prober`` / ``make_model`` callables, so
the state machine is tested without a card or real checkpoints.
"""

import logging
import os
import threading
from typing import Callable, Mapping, Optional, Tuple

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.serve.engine import PHASE_RELOADING, PHASE_SERVING

logger = logging.getLogger(__name__)

OUTCOME_SWAPPED = "swapped"
OUTCOME_REJECTED_VERIFY = "rejected:verify"
OUTCOME_REJECTED_STRUCTURE = "rejected:structure"
OUTCOME_REJECTED_PROBE = "rejected:probe"
OUTCOME_REJECTED_CALIBRATION = "rejected:calibration"


class CheckpointWatcher:
    """Tracks the publish signature of one checkpoint path.  ``poll()``
    returns the path when a NEW (not yet considered) version is on disk,
    else None."""

    def __init__(self, path: str):
        self.path = path
        self._last_sig: Optional[Tuple] = self._sig()

    def _sig(self) -> Optional[Tuple]:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def poll(self) -> Optional[str]:
        sig = self._sig()
        if sig is None or sig == self._last_sig:
            return None
        # remember BEFORE the verdict: whether this version swaps or rolls
        # back, it is considered exactly once
        self._last_sig = sig
        return self.path


class HotReloader:
    """verify → [stage] → [calibrate] → probe → swap-or-rollback for one
    candidate at a time.

    ``loader(path)`` returns the checkpoint dict (its ``model`` the state
    dict); ``make_model(weights)`` stages the candidate model (None hands the
    state dict on as it is);
    ``preparer(candidate)`` (quantized serving) returns the candidate's
    quantized twin, and any failure there is a named
    ``rejected:calibration``; ``preparer_abort()`` releases what the
    preparer staged when the probe then rejects the candidate;
    ``prober(candidate)`` (default: the engine's ``probe``) raises to
    reject.  The structure check runs against ``structure_ref`` (a state
    dict; default: the served model's), the fp32 model's under quantized
    serving, whose served twin holds ``weight_q`` / ``weight_scale``."""

    def __init__(
        self,
        engine,
        loader: Callable[[str], dict],
        prober: Optional[Callable] = None,
        preparer: Optional[Callable] = None,
        preparer_abort: Optional[Callable] = None,
        structure_ref: Optional[Mapping] = None,
        make_model: Optional[Callable] = None,
    ):
        self.engine = engine
        self.loader = loader
        self.prober = prober if prober is not None else engine.probe
        self.preparer = preparer
        self.preparer_abort = preparer_abort
        self.structure_ref = structure_ref
        self.make_model = make_model
        self.swapped = 0
        self.rolled_back = 0
        self.last_outcome: Optional[str] = None

    def consider(self, path: str) -> str:
        """Run the full protocol on ``path``; returns an OUTCOME_*."""
        # chaos 'corrupt-reload': rot the candidate after it was picked up,
        # before the verified load, where real rot at rest would sit
        chaos.maybe_corrupt_reload(path)
        self.engine.set_ready(False, PHASE_RELOADING)
        sink = getattr(self.engine, "reload_launches", {})
        try:
            with _kernels.counted_apart(sink):
                return self._consider(path)
        finally:
            # readiness returns whatever the verdict: after a swap the new
            # model serves, after a rollback the old one
            self.engine.set_ready(True, PHASE_SERVING)

    def _consider(self, path: str) -> str:
        try:
            state = self.loader(path)
        except Exception as err:
            return self._rollback(
                path, OUTCOME_REJECTED_VERIFY,
                f"verified load rejected the candidate ({type(err).__name__}: {err})",
            )
        weights = state.get("model") if isinstance(state, dict) else None
        if weights is None:
            return self._rollback(path, OUTCOME_REJECTED_STRUCTURE,
                                  "candidate holds no model weights")
        ref = (self.structure_ref if self.structure_ref is not None
               else self.engine.model.state_dict())
        if not _same_structure(ref, weights):
            return self._rollback(
                path, OUTCOME_REJECTED_STRUCTURE,
                "candidate parameter names/shapes do not match the serving model "
                "(different arch/config?)",
            )
        candidate = weights
        if self.make_model is not None:
            try:
                candidate = self.make_model(weights)
            except Exception as err:
                return self._rollback(
                    path, OUTCOME_REJECTED_PROBE,
                    f"candidate could not be staged on the device "
                    f"({type(err).__name__}: {err})",
                )
        if self.preparer is not None:
            try:
                candidate = self.preparer(candidate)
            except Exception as err:
                return self._rollback(
                    path, OUTCOME_REJECTED_CALIBRATION,
                    f"quant scale re-verification/calibration failed "
                    f"({type(err).__name__}: {err})",
                )
        try:
            self.prober(candidate)
        except Exception as err:
            if self.preparer is not None and self.preparer_abort is not None:
                try:
                    self.preparer_abort()
                except Exception:
                    logger.exception("preparer_abort failed (rollback stands)")
            return self._rollback(
                path, OUTCOME_REJECTED_PROBE,
                f"probe batch failed ({type(err).__name__}: {err})",
            )
        step = _checkpoint_step(state)
        self.engine.request_swap(candidate, tag=f"{os.path.basename(path)} @ step {step}")
        self.swapped += 1
        self.last_outcome = OUTCOME_SWAPPED
        logger.info(
            f"RELOAD VERIFIED: {path} (step {step}) verified + probed; "
            "swap queued for the next batch boundary"
        )
        telemetry.emit("serve-reload", outcome=OUTCOME_SWAPPED, path=path, step=step)
        return OUTCOME_SWAPPED

    def _rollback(self, path: str, outcome: str, why: str) -> str:
        self.rolled_back += 1
        self.last_outcome = outcome
        logger.error(
            f"RELOAD ROLLBACK ({outcome}): {why} — keeping the serving "
            f"snapshot; candidate {path} will not be retried until it is "
            "re-published"
        )
        telemetry.emit("serve-reload", outcome=outcome, path=path, message=why)
        return outcome


class ReloadRunner:
    """Background thread tying watcher and reloader together on a poll
    interval; its sleeps are sliced so ``stop()`` returns promptly."""

    def __init__(self, watcher: CheckpointWatcher, reloader: HotReloader,
                 interval_s: float):
        self.watcher = watcher
        self.reloader = reloader
        self.interval_s = max(0.1, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="serve-reload", daemon=True)
        self._thread.start()
        logger.info(
            f"hot reload armed: watching {self.watcher.path} every "
            f"{self.interval_s:g}s"
        )

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                candidate = self.watcher.poll()
                if candidate is not None:
                    self.reloader.consider(candidate)
            except Exception:
                # the reload plane never takes the server down
                logger.exception("reload poll failed; serving continues")
            self._stop.wait(timeout=self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)


def _same_structure(a, b) -> bool:
    """The same names and the same shapes, nested mappings compared key by
    key (dtypes are not compared: the JAX package compares shapes only, and
    a bf16 candidate of an fp32 server is one it swaps in)."""
    if isinstance(a, Mapping) and isinstance(b, Mapping):
        if set(a.keys()) != set(b.keys()):
            return False
        return all(_same_structure(a[k], b[k]) for k in a)
    if isinstance(a, Mapping) != isinstance(b, Mapping):
        return False
    sa = getattr(a, "shape", None)
    sb = getattr(b, "shape", None)
    return tuple(sa or ()) == tuple(sb or ())


def _checkpoint_step(state: dict):
    hist = state.get("optimizer_history") or []
    if hist and isinstance(hist[-1], dict):
        return hist[-1].get("num_updates", "?")
    return "?"
