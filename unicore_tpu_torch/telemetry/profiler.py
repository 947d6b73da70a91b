"""On-demand profiling (counterpart of ``unicore_tpu/telemetry/profiler.py``):
``--profile-steps START:END``.

The whole-run ``--profile`` flag traces every update of a run; this window
arms a ``torch.profiler`` capture per process instead: it starts when the
update counter first reaches START (the trainer's pre-update tick) and stops
at END (its post-update tick) or at run end, whichever comes first.  The
capture records CPU activity, plus the CUDA kernels on a card, and is
written as one Chrome trace (``updates_<start>_<end>.pt.trace.json``, which
``chrome://tracing``, Perfetto and TensorBoard's profiler plugin load) into
``<telemetry-dir>/profile_rank<r>/``; ``profile-start`` / ``profile-stop``
journal events with the JAX package's fields show which updates it covers.

The tick is two integer compares per update when armed, nothing when not;
the capture costs what ``torch.profiler`` costs, which is why it is bounded
to a window.  A capture that cannot start warns and disarms, as in the JAX
package; one that fails to stop or to write its trace raises, so a failed
sink shows."""

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def parse_profile_steps(spec: Optional[str]):
    """``"START:END"`` -> (start, end) with 0 <= START < END, or None for
    an empty/absent spec.  Malformed specs raise ValueError at parse time
    (flag errors must fail the launch, not update 1200)."""
    if not spec:
        return None
    parts = str(spec).split(":")
    if len(parts) != 2:
        raise ValueError(
            f"--profile-steps wants START:END, got {spec!r}"
        )
    try:
        start, end = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"--profile-steps wants integer START:END, got {spec!r}"
        ) from None
    if start < 0 or end <= start:
        raise ValueError(
            f"--profile-steps wants 0 <= START < END, got {spec!r}"
        )
    return start, end


def start_profiler(cuda: bool):
    """A started ``torch.profiler.profile`` recording CPU activity, and the
    CUDA kernels when ``cuda``."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof, path: str) -> str:
    """Stop ``prof`` and write its Chrome trace to ``path``."""
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


class ProfileWindow:
    """Per-process profiling window driven by ``tick(update)``."""

    def __init__(self, start: int, end: int, out_dir: str, rank: int = 0,
                 cuda: bool = False):
        self.start = int(start)
        self.end = int(end)
        self.out_dir = os.path.join(out_dir, f"profile_rank{int(rank)}")
        self.cuda = bool(cuda)
        self.active = False
        self.done = False
        self.trace_path: Optional[str] = None
        self._prof = None
        self._first = self.start

    def tick(self, update: int) -> None:
        if self.done:
            return
        if not self.active and self.start <= update < self.end:
            self._begin(update)
        elif self.active and update >= self.end:
            self._finish(update)

    def close(self, update: Optional[int] = None) -> None:
        """Stop a still-open capture at run end (a window past the last
        update must still produce a trace, not a corrupt half-file)."""
        if self.active:
            self._finish(update if update is not None else self.end)

    def _begin(self, update: int) -> None:
        from unicore_tpu_torch.telemetry import journal

        os.makedirs(self.out_dir, exist_ok=True)
        try:
            self._prof = start_profiler(self.cuda)
        except Exception as err:
            logger.warning(
                f"--profile-steps capture could not start ({err}); "
                "profiling disabled for this run"
            )
            self.done = True
            return
        self._first = int(update)
        self.active = True
        logger.info(
            f"PROFILE capture started at update {update} "
            f"(window {self.start}:{self.end}) -> {self.out_dir}"
        )
        journal.emit("profile-start", update=int(update),
                     window=[self.start, self.end], dir=self.out_dir)

    def _finish(self, update: int) -> None:
        from unicore_tpu_torch.telemetry import journal

        self.active = False
        self.done = True
        prof, self._prof = self._prof, None
        self.trace_path = stop_profiler(prof, os.path.join(
            self.out_dir, f"updates_{self._first}_{int(update)}.pt.trace.json"))
        logger.info(
            f"PROFILE capture stopped at update {update}; trace in "
            f"{self.trace_path} (load with chrome://tracing, Perfetto or "
            "TensorBoard)"
        )
        journal.emit("profile-stop", update=int(update), dir=self.out_dir)


_window: Optional[ProfileWindow] = None


def configure(args, out_dir: str, rank: int) -> Optional[ProfileWindow]:
    """Arm the window from ``--profile-steps`` (None = unarmed); the
    capture records CUDA kernels when the run's ``--device`` is ``cuda``."""
    global _window
    parsed = parse_profile_steps(getattr(args, "profile_steps", None))
    if parsed is None:
        _window = None
        return None
    _window = ProfileWindow(parsed[0], parsed[1], out_dir, rank,
                            cuda=getattr(args, "device", "cpu") == "cuda")
    return _window


def window() -> Optional[ProfileWindow]:
    return _window


def tick(update: int) -> None:
    if _window is not None:
        _window.tick(update)


def close(update: Optional[int] = None) -> None:
    if _window is not None:
        _window.close(update)


def reset() -> None:
    global _window
    _window = None
