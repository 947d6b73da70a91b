"""Host-RAM rewind snapshots (counterpart of ``unicore_tpu/health/snapshot.py``):
a device->host copy of the trainer's state and a bounded ring of them.

The sentinel's rewind needs a recent, CLEAN copy of the whole training
state (parameters, optimizer state, EMA, scalars) that survives the
anomalous updates after it, without a round trip through a checkpoint.

- :func:`host_copy_tree` copies a name -> tensor map into pinned host
  buffers that a ring slot allocates once and reuses.  On the card the
  copies are enqueued ``non_blocking`` on a side CUDA stream that first
  waits for the compute stream (so they read the finished update), and an
  event is recorded after them; the trainer makes its compute stream wait
  on that event before the next optimizer step writes the state, so the
  copy overlaps the next update's forward and backward instead of
  blocking the host.  On the CPU it is a plain copy.
- :func:`device_restore_tree` copies a snapshot back IN PLACE
  (``copy_``): under ``--fused-adam`` every parameter is a view into a
  flat buffer that the ``fused_adam`` kernel writes, and swapping tensors
  would cut those views.
- :class:`SnapshotRing` keeps the last ``keep`` snapshots, oldest evicted
  first; ``newest_at_or_before(step)`` picks the rewind target and
  ``drop_newer_than(step)`` drops the abandoned trajectory's snapshots.
"""

import logging
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def host_copy_tree(tree: Mapping[str, torch.Tensor],
                   slot: Optional[Dict[str, torch.Tensor]] = None,
                   stream: Optional["torch.cuda.Stream"] = None,
                   start: Optional["torch.cuda.Event"] = None,
                   ) -> Tuple[Dict[str, torch.Tensor], Optional["torch.cuda.Event"]]:
    """Copy ``tree`` (name -> tensor, on one device) to host memory.

    ``slot`` is the host map of an earlier call, filled in place where the
    names, shapes and types match (the rest are allocated, pinned for card
    tensors) and returned.  Card tensors are copied on ``stream`` (required then),
    which first waits for the current stream; ``start`` (a timing event)
    is recorded on it just before the copies.  Returns the host map and the
    timing event recorded after the copies (None on the CPU)."""
    out: Dict[str, torch.Tensor] = slot if slot is not None else OrderedDict()
    on_card = any(t.is_cuda for t in tree.values())
    for name in [n for n in out if n not in tree]:
        del out[name]
    for name, t in tree.items():
        buf = out.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            out[name] = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=on_card)
    if not on_card:
        with torch.no_grad():
            for name, t in tree.items():
                out[name].copy_(t)
        return out, None
    if stream is None:
        raise ValueError("host_copy_tree: card tensors need a side stream")
    device = next(iter(tree.values())).device
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.no_grad(), torch.cuda.stream(stream):
        if start is not None:
            start.record(stream)
        for name, t in tree.items():
            out[name].copy_(t, non_blocking=True)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
    return out, event


def device_restore_tree(host_tree: Mapping[str, torch.Tensor],
                        live: Mapping[str, torch.Tensor]) -> None:
    """Copy a :func:`host_copy_tree` result back into the live tensors in
    place, on the current stream (the inverse operation); the names must
    match."""
    if host_tree.keys() != live.keys():
        missing = sorted(set(live) ^ set(host_tree))
        raise ValueError(f"snapshot and live state differ in {missing[:5]}")
    with torch.no_grad():
        for name, t in live.items():
            t.copy_(host_tree[name], non_blocking=True)


def tree_nbytes(host_tree) -> int:
    if isinstance(host_tree, Mapping):
        return sum(tree_nbytes(v) for v in host_tree.values())
    if isinstance(host_tree, torch.Tensor):
        return host_tree.numel() * host_tree.element_size()
    return 0


@dataclass
class HealthSnapshot:
    """One rewind point: everything needed to put the run back at ``step``
    in memory.  The data iterator is NOT rewound: recovery skips FORWARD
    past the offending window, so ``iterator_state`` is a record."""

    step: int                      # num_updates the state corresponds to
    state: Any                     # host copy of the training state
    lr_sched_state: Optional[dict] = None
    iterator_state: Optional[dict] = None
    extra: dict = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return tree_nbytes(self.state)


class SnapshotRing:
    """Bounded ring of :class:`HealthSnapshot`, oldest evicted first."""

    def __init__(self, keep: int):
        self.keep = max(int(keep), 1)
        self._ring: deque = deque()

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self):
        return iter(self._ring)

    def steps(self) -> List[int]:
        return [s.step for s in self._ring]

    def add(self, snap: HealthSnapshot) -> None:
        while len(self._ring) >= self.keep:
            evicted = self._ring.popleft()  # oldest first
            logger.debug(f"snapshot ring: evicted rewind point @{evicted.step}")
        self._ring.append(snap)

    def newest_at_or_before(self, step: int) -> Optional[HealthSnapshot]:
        """The rewind target: the newest snapshot taken at or before
        ``step`` (before the anomaly window opened)."""
        best = None
        for snap in self._ring:
            if snap.step <= step and (best is None or snap.step > best.step):
                best = snap
        return best

    def drop_newer_than(self, step: int) -> int:
        """Drop the abandoned trajectory's snapshots after a rewind to
        ``step``; returns how many went."""
        before = len(self._ring)
        self._ring = deque(s for s in self._ring if s.step <= step)
        return before - len(self._ring)

    def clear(self) -> None:
        self._ring.clear()
