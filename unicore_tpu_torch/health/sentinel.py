"""Training-health sentinel: the detect-rewind-skip recovery policy
(counterpart of ``unicore_tpu/health/sentinel.py``).

It ties together the per-update observation (a lag-1 read of the
trainer's running metric sums ``_macc``: the sums held after update N are
judged after update N+1, as the JAX sentinel reads device values one
update late so the loop never waits on a fresh one), the streaming
detectors (:mod:`unicore_tpu_torch.health.detectors`), the host-RAM
snapshot ring (:mod:`unicore_tpu_torch.health.snapshot`) and the
escalation ladder applied when an anomaly is confirmed:

  level 0 (implicit)  the overflow skip: a non-finite gradient norm
                      already skips the update; the sentinel counts these
                      and never rewinds for them.
  level 1             restore the newest pre-anomaly snapshot and skip
                      the data iterator ``--spike-skip-updates`` update
                      chunks past the offending window.
  level 2             (a repeat anomaly within ``--spike-cooldown-
                      updates`` of the last rewind) rewind and skip as
                      above, and scale the lr by ``--spike-cooldown-
                      factor`` until the cooldown ends.
  level 3             (``--max-rewinds`` spent, or no pre-anomaly
                      snapshot kept) abort with :class:`TrainingHealthError`
                      naming the detector, step and statistic.

The recovery history is saved in the checkpoint's ``extra_state`` and
restored on resume.  As in the JAX sentinel, every rank's recovery
proposal is all-gathered before any rank applies it
(:meth:`TrainingHealthSentinel._agree`), and a divergent one aborts with
:class:`ConsistencyError`; the snapshot ring stays per rank.  Its verdicts are
logger lines and journal events (``sentinel-rewind``, ``sentinel-abort``,
with the JAX package's fields).
"""

import logging
import math
from typing import Any, Dict, List, Optional

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.health.detectors import (
    Anomaly,
    GradNormExplosionDetector,
    LossScaleCollapseDetector,
    LossSpikeDetector,
)
from unicore_tpu_torch.health.snapshot import SnapshotRing

logger = logging.getLogger(__name__)

#: tags a recovery proposal in the agreement's all-gather (the JAX tag)
_AGREEMENT_TAG = "unicore-tpu-sentinel-recovery-v1"

# _macc keys the sentinel reads (the trainer's running sums since the last
# flush: update count, loss in the loss's own units, gradient norm, loss
# scale, overflows, sample size)
_METRIC_KEYS = ("_n", "loss", "gnorm", "loss_scale", "overflow", "sample_size")


class TrainingHealthError(RuntimeError):
    """The escalation ladder's terminal level: recovery is not possible
    (or no longer credible) and the run aborts with a diagnosis."""


class ConsistencyError(RuntimeError):
    """The ranks proposed different recoveries (the JAX guard's
    ``ConsistencyError``), with the divergent ranks named."""


def build_sentinel(args) -> Optional["TrainingHealthSentinel"]:
    """A sentinel when ``--sentinel-interval`` > 0, else None."""
    if int(getattr(args, "sentinel_interval", 0) or 0) <= 0:
        return None
    return TrainingHealthSentinel(args)


class TrainingHealthSentinel:
    def __init__(self, args):
        self.interval = int(getattr(args, "sentinel_interval", 1) or 1)
        self.snapshot_interval = int(
            getattr(args, "snapshot_interval", 200) or 0
        )
        warmup = int(getattr(args, "sentinel_warmup", 50) or 0)
        self.warmup = warmup
        window = int(getattr(args, "loss_spike_window", 64) or 64)
        self.detectors = [
            LossSpikeDetector(
                zmax=float(getattr(args, "loss_spike_zmax", 6.0) or 6.0),
                window=window,
                warmup=warmup,
            ),
            GradNormExplosionDetector(
                factor=float(
                    getattr(args, "gnorm_explosion_factor", 10.0) or 10.0
                ),
                window=window,
                warmup=warmup,
            ),
        ]
        if getattr(args, "fp16", False):
            self.detectors.append(
                LossScaleCollapseDetector(
                    halvings=int(
                        getattr(args, "scale_collapse_halvings", 8) or 8
                    ),
                    warmup=warmup,
                )
            )
        self.ring = SnapshotRing(int(getattr(args, "snapshot_keep", 2) or 2))
        self.skip_updates = int(getattr(args, "spike_skip_updates", 2) or 0)
        self.cooldown_updates = int(
            getattr(args, "spike_cooldown_updates", 100) or 0
        )
        self.cooldown_factor = float(
            getattr(args, "spike_cooldown_factor", 0.1) or 0.1
        )
        self.max_rewinds = int(getattr(args, "max_rewinds", 3) or 3)

        # recovery state (persisted via state_dict into checkpoints)
        self.events: List[Dict[str, Any]] = []
        self.rewind_count = 0
        self.overflow_skips = 0.0
        self._last_rewind_at: Optional[int] = None
        self._cooldown_until = -1

        # lag-1 observation state (never persisted)
        self._held = None  # (step, {key: device array ref})
        self._baseline: Dict[str, float] = {}
        self._last_observed_step = 0

    # ------------------------------------------------------------------
    # hot-loop entry point (called by the CLI right after each update)
    # ------------------------------------------------------------------

    def after_update(self, trainer, epoch_itr=None, update_itr=None) -> None:
        """Observe the finished update, recover if an anomaly confirmed,
        else maybe take a snapshot.  ``update_itr`` is the grouped batch
        iterator recovery fast-forwards; ``epoch_itr`` supplies the
        iterator position recorded in snapshots."""
        step = trainer.get_num_updates()
        anomaly, clean_step = self._observe(trainer, step)
        if anomaly is not None:
            self._recover(trainer, anomaly, clean_step, update_itr)
            return
        if (
            self.rewind_count > 0
            and self._last_rewind_at is not None
            and step - self._last_rewind_at > max(self.cooldown_updates, 1)
        ):
            # a full cooldown passed clean: de-escalate the ladder
            self.rewind_count = 0
        self._maybe_snapshot(trainer, epoch_itr, step)

    def lr_scale(self, step: int) -> float:
        """Multiplier the trainer applies to the scheduler lr (1.0 unless
        a post-rewind cooldown is active)."""
        return self.cooldown_factor if step < self._cooldown_until else 1.0

    # ------------------------------------------------------------------
    # observation (lag-1: judge the sums held LAST update, then hold this
    # update's for the next call)
    # ------------------------------------------------------------------

    def _observe(self, trainer, step: int):
        anomaly = None
        clean_step = self._last_observed_step
        if self._held is not None:
            held_step, refs = self._held
            self._held = None
            vals = {k: float(v) for k, v in refs.items()}
            base = self._baseline
            gap = float(held_step - self._last_observed_step)
            if base and vals.get("_n", 0.0) == base.get("_n", 0.0) + gap:
                # no flush between holds: the baseline subtraction gives
                # exactly this window's sums
                delta = {k: vals.get(k, 0.0) - base.get(k, 0.0) for k in vals}
                dn = gap
            else:
                # the sums were flushed (at a log / validation boundary)
                # between holds and restarted: subtracting the stale
                # baseline would difference DISJOINT windows.  The fresh
                # sums cover exactly the post-flush tail of the window.
                delta = dict(vals)
                dn = vals.get("_n", 0.0)
            if dn > 0:
                anomaly = self._feed_detectors(trainer, held_step, delta, dn)
            self._baseline = vals
            self._last_observed_step = held_step
        macc = getattr(trainer, "_macc", None)
        if anomaly is None and macc is not None and step % self.interval == 0:
            # the trainer replaces its sums with a new dict each update, so
            # a held reference keeps this update's values
            self._held = (step, {k: macc[k] for k in _METRIC_KEYS if k in macc})
        return anomaly, clean_step

    def _feed_detectors(self, trainer, step, delta, dn) -> Optional[Anomaly]:
        per_update: Dict[str, float] = {}
        overflowed = delta.get("overflow", 0.0) > 0
        if overflowed:
            # level 0: the in-jit skip already neutralized these updates;
            # their inf gnorm / garbage stats must not pollute the bands
            self.overflow_skips += delta.get("overflow", 0.0)
        else:
            # a past overflow poisons the RUNNING sums (inf enters once,
            # every later delta is inf - inf = nan until the next flush
            # resets the accumulator) — those windows are unobservable,
            # not anomalous; the overflowed window itself was gated above
            ss = delta.get("sample_size", 0.0)
            if "loss" in delta and ss > 0 and math.isfinite(delta["loss"]):
                per_update["loss"] = delta["loss"] / ss
            if "gnorm" in delta and math.isfinite(delta["gnorm"]):
                per_update["gnorm"] = delta["gnorm"] / dn
        if (
            "loss_scale" in delta
            and getattr(trainer, "use_loss_scale", False)
            and math.isfinite(delta["loss_scale"])
        ):
            # fed even on overflow updates — rescales ARE the signal here
            per_update["loss_scale"] = delta["loss_scale"] / dn

        # two-phase: judge everything first, fold only if the WHOLE window
        # is clean — a loss spike usually drags the grad norm up too
        # (sub-threshold), and folding that into the grad-norm EMA would
        # raise its bar against the next genuine explosion
        hits = [
            hit
            for det in self.detectors
            if det.stat in per_update
            and (hit := det.check(step, per_update[det.stat])) is not None
        ]
        if hits:
            return hits[0]
        for det in self.detectors:
            if det.stat in per_update:
                det.update(step, per_update[det.stat])
        return None

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------

    def _maybe_snapshot(self, trainer, epoch_itr, step: int) -> None:
        if self.snapshot_interval <= 0 or step <= 0:
            return
        if step % self.snapshot_interval != 0:
            return
        if self.ring.steps() and self.ring.steps()[-1] == step:
            return  # already captured this update
        snap = trainer.capture_health_snapshot(epoch_itr)
        if snap is None:
            return
        self.ring.add(snap)
        logger.debug(
            f"sentinel: captured rewind snapshot @update {step} "
            f"({snap.nbytes / 1024 ** 2:.1f} MiB host RAM, "
            f"ring {self.ring.steps()})"
        )

    # ------------------------------------------------------------------
    # recovery (the escalation ladder)
    # ------------------------------------------------------------------

    def _recover(self, trainer, anomaly: Anomaly, clean_step: int,
                 update_itr) -> None:
        target = self.ring.newest_at_or_before(clean_step)
        if self.rewind_count >= self.max_rewinds:
            action = "abort"
            why = (
                f"{self.rewind_count} rewind(s) already spent "
                f"(--max-rewinds {self.max_rewinds}) and the run is still "
                "diverging"
            )
        elif target is None:
            action = "abort"
            why = (
                f"no pre-anomaly snapshot retained at or before update "
                f"{clean_step} (ring holds {self.ring.steps() or 'nothing'}; "
                "lower --snapshot-interval or raise --snapshot-keep)"
            )
        elif self.rewind_count >= 1:
            action = "rewind+cooldown"
            why = None
        else:
            action = "rewind"
            why = None

        target_step = target.step if target is not None else -1
        self._agree(anomaly, target_step, action)

        event = {
            "step": int(anomaly.step),
            "detector": anomaly.detector,
            "stat": anomaly.stat,
            "value": float(anomaly.value),
            "threshold": float(anomaly.threshold),
            "action": action,
            "target_step": int(target_step),
        }
        self.events.append(event)

        if action == "abort":
            logger.error(f"SENTINEL ABORT: {anomaly.describe()}; {why}")
            telemetry.emit(
                "sentinel-abort", update=int(anomaly.step),
                detector=anomaly.detector, stat=anomaly.stat,
                value=float(anomaly.value), message=str(why),
            )
            raise TrainingHealthError(
                f"training-health sentinel ABORT: {anomaly.describe()}; "
                f"{why}.  Recovery history: "
                f"{[e['action'] for e in self.events]}"
            )

        trainer.restore_health_snapshot(target)
        dropped = self.ring.drop_newer_than(target.step)
        skipped = 0
        if update_itr is not None and self.skip_updates > 0:
            before = getattr(update_itr, "n", None)
            update_itr.skip(self.skip_updates)
            after = getattr(update_itr, "n", None)
            skipped = (
                after - before
                if before is not None and after is not None
                else self.skip_updates
            )
        if action == "rewind+cooldown":
            self._cooldown_until = target.step + self.cooldown_updates
        self.rewind_count += 1
        self._last_rewind_at = target.step
        # the lag-1 refs and baselines describe the abandoned trajectory
        self._held = None
        self._baseline = {}
        self._last_observed_step = target.step

        cooldown_note = (
            f", lr x{self.cooldown_factor} until update "
            f"{self._cooldown_until}"
            if action == "rewind+cooldown"
            else ""
        )
        logger.warning(
            f"SENTINEL REWIND: {anomaly.describe()} -> restored snapshot "
            f"@update {target.step}, skipped {skipped} data "
            f"chunk(s) past the offending window{cooldown_note} "
            f"(rewind {self.rewind_count}/{self.max_rewinds}"
            f"{', dropped ' + str(dropped) + ' stale snapshot(s)' if dropped else ''})"
        )
        telemetry.emit(
            "sentinel-rewind", update=int(anomaly.step),
            detector=anomaly.detector, stat=anomaly.stat,
            value=float(anomaly.value), threshold=float(anomaly.threshold),
            action=action, target_step=int(target.step),
            skipped_chunks=int(skipped),
            rewind_count=int(self.rewind_count),
        )

    def _agree(self, anomaly: Anomaly, target_step: int, action: str) -> None:
        """Every rank must propose the SAME recovery before any applies it
        (the JAX sentinel's agreement).  Detection runs on the sums reduced
        over the ranks, so proposals agree by construction; this all-gather
        (on the rare anomaly path only) turns a violation of that into an
        abort that names the ranks, instead of rewinds to different
        states.  Without a process group there is nothing to agree."""
        from unicore_tpu_torch.distributed import utils as distributed_utils

        if distributed_utils.get_world_size() <= 1:
            return
        proposal = (anomaly.detector, int(anomaly.step), int(target_step), action)
        mine = (_AGREEMENT_TAG, proposal)
        gathered = distributed_utils.all_gather_list(mine)
        divergent = [(rank, row) for rank, row in enumerate(gathered) if row != mine]
        if divergent:
            detail = "; ".join(f"rank {rank} proposed {row!r}" for rank, row in divergent)
            raise ConsistencyError(
                f"sentinel recovery proposals DIVERGED across ranks at anomaly step "
                f"{anomaly.step}: this rank proposed {proposal!r} but {detail}.  Ranks "
                "are observing different metrics: aborting instead of rewinding to "
                "different states.")
        logger.info(f"sentinel: all {len(gathered)} rank(s) agreed on {action} -> "
                    f"snapshot @update {target_step}")

    # ------------------------------------------------------------------
    # persistence + fingerprint
    # ------------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "events": list(self.events),
            "rewind_count": self.rewind_count,
            "overflow_skips": self.overflow_skips,
            "last_rewind_at": self._last_rewind_at,
            "cooldown_until": self._cooldown_until,
        }

    def load_state_dict(self, state: Optional[Dict[str, Any]]) -> None:
        if not state:
            return
        self.events = list(state.get("events", []))
        self.rewind_count = int(state.get("rewind_count", 0))
        self.overflow_skips = float(state.get("overflow_skips", 0.0))
        self._last_rewind_at = state.get("last_rewind_at")
        self._cooldown_until = int(state.get("cooldown_until", -1))

    def fingerprint_token(self):
        """Compact recovery-history token: the JAX consistency guard
        fingerprints it so hosts whose sentinels disagree are named (the
        port has no guard yet: one process)."""
        return (len(self.events), self.rewind_count, self._last_rewind_at)
