"""The heartbeat-lease plane (counterpart of the lease half of
``unicore_tpu/distributed/elastic.py``): :class:`Lease` and its wire form
(:func:`encode_lease` / :func:`decode_lease`, byte-equal to the JAX
package's), the :class:`Verdict` a silence ripens into, and
:class:`LeaseTable`, the pure state machine that classifies silence.

The serving fleet rides it (``serve/fleet/membership.py``): a replica's
lease that the store answers about but that stops advancing is evidence
against the REPLICA; a store that does not answer is evidence against the
CONTROL PLANE and ages no lease.  The training side of the JAX module (the
heartbeat runtime, the supervised restart loop, the membership state file)
waits for the rest of the parallelism queue (ROADMAP queue A item 4).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

_LEASE_TAG = "uctp-hb1"


@dataclasses.dataclass
class Lease:
    """One heartbeat: who is alive, in which incarnation, how far along.
    ``step_wall`` is the smoothed seconds per update (< 0 = unknown)."""

    epoch: int
    seq: int
    step: int
    wall: float
    step_wall: float = -1.0


def encode_lease(lease: Lease) -> str:
    # the wall stamp keeps the JAX package's millisecond format: the wire
    # is shared with its routers and registrars
    return (
        f"{_LEASE_TAG}|{lease.epoch}|{lease.seq}|{lease.step}|"
        f"{lease.wall:.3f}|{lease.step_wall:.6f}"
    )


def decode_lease(raw: str) -> Lease:
    parts = str(raw).split("|")
    # 5 fields: a lease without step_wall is still a valid beat
    if len(parts) not in (5, 6) or parts[0] != _LEASE_TAG:
        raise ValueError(f"not a heartbeat lease: {raw!r}")
    return Lease(
        epoch=int(parts[1]), seq=int(parts[2]), step=int(parts[3]),
        wall=float(parts[4]),
        step_wall=float(parts[5]) if len(parts) == 6 else -1.0,
    )


@dataclasses.dataclass
class Verdict:
    """The table's diagnosis: which peers are lost or stale, and why."""

    kind: str          # "host-loss" | "stale-host" | "self-stale" | "control-plane"
    ranks: List[int]   # the peers named (empty for the control plane)
    message: str


class LeaseTable:
    """Tracks every peer's lease and classifies silence, driven by
    ``observe`` / ``sweep`` with an injected clock (no threads, no store).

    Silence is measured confirmed-minus-advance: the clock of the last
    service-CONFIRMED look at a peer minus the clock of its last lease
    ADVANCE.  Time spent with the store unreachable therefore never counts
    against a peer; past the timeout it becomes a control-plane verdict."""

    def __init__(self, peers: Sequence[int], epoch: int, timeout: float,
                 now: float):
        self.epoch = int(epoch)
        self.timeout = float(timeout)
        # rank -> [last seq seen (None = never), clock of the last lease
        # advance, clock of the last service-confirmed observation]
        self._last: Dict[int, List[Any]] = {
            int(r): [None, now, now] for r in peers
        }
        self._kv_ok = now

    def add_peer(self, rank: int, now: float) -> None:
        """Start tracking a peer first seen after construction (a fleet's
        membership is dynamic).  Idempotent; a just-joined peer owes no
        silence."""
        self._last.setdefault(int(rank), [None, now, now])

    def remove_peer(self, rank: int) -> None:
        """Stop tracking a peer (deregistered, or already declared lost:
        keeping it would re-mint the same verdict every sweep)."""
        self._last.pop(int(rank), None)

    def note_service_ok(self, now: float) -> None:
        """The store answered, even about nothing (an empty listing):
        re-arm the control-plane outage clock."""
        self._kv_ok = now

    def observe(self, rank: int, result: Any, now: float) -> Optional[Verdict]:
        """Feed one probe outcome for ``rank``: a :class:`Lease`,
        ``retry.ABSENT`` (the service answered: no key) or
        ``retry.UNREACHABLE`` (the service did not answer)."""
        from unicore_tpu_torch.utils import retry

        if result is retry.UNREACHABLE:
            return None  # no evidence about the peer; _kv_ok not advanced
        self._kv_ok = now
        if result is retry.ABSENT:
            self._last[int(rank)][2] = now
            return None
        lease: Lease = result
        if lease.epoch < self.epoch:
            return Verdict(
                "stale-host",
                [rank],
                f"rank {rank} is publishing heartbeats for STALE membership "
                f"epoch {lease.epoch} while the cluster is at epoch "
                f"{self.epoch} — a host relaunched from an old incarnation "
                "must not rejoin a newer one",
            )
        if lease.epoch > self.epoch:
            # the newer-epoch peer is the healthy one: name nobody
            return Verdict(
                "self-stale",
                [],
                f"rank {rank} heartbeats carry membership epoch "
                f"{lease.epoch}, NEWER than this host's ({self.epoch}) — "
                "THIS host is the stale one (relaunched with an old "
                "incarnation's environment) and must not rejoin",
            )
        entry = self._last[int(rank)]
        entry[2] = now
        if entry[0] is None or lease.seq > entry[0]:
            entry[0] = lease.seq
            entry[1] = now
        return None

    def sweep(self, now: float) -> Optional[Verdict]:
        """Expire leases: called after each observation round."""
        if now - self._kv_ok > self.timeout:
            return Verdict(
                "control-plane",
                [],
                f"coordination-service KV store unreachable for "
                f"{now - self._kv_ok:.1f}s (> --heartbeat-timeout "
                f"{self.timeout:g}s) — peer liveness cannot be observed; "
                "restarting re-hosts the coordination service",
            )
        silent = [
            (rank, entry[2] - entry[1])
            for rank, entry in sorted(self._last.items())
            if entry[2] - entry[1] > self.timeout
        ]
        if not silent:
            return None
        if len(silent) == len(self._last) >= 2:
            # every peer silent at once cannot be told from a partition of
            # the store: a mass loss verdict would split the brain
            return Verdict(
                "control-plane",
                [],
                f"ALL {len(silent)} peer leases went silent at once — "
                "simultaneous mass host loss is indistinguishable from a "
                "coordination-service partition; restarting with the "
                "membership UNCHANGED so survivors re-form together "
                "instead of splitting the brain",
            )
        detail = "; ".join(
            f"rank {rank} heartbeat lease expired (silent for {age:.1f}s "
            f"> --heartbeat-timeout {self.timeout:g}s)"
            for rank, age in silent
        )
        return Verdict("host-loss", [rank for rank, _ in silent], detail)

    def silences(self) -> Dict[int, float]:
        """Confirmed silence per peer right now."""
        return {
            rank: entry[2] - entry[1] for rank, entry in self._last.items()
        }
