"""Service-confirmed fleet membership: who is routable, who is lost
(counterpart of ``unicore_tpu/serve/fleet/membership.py``).

The router's replica table is :class:`elastic.LeaseTable` driven by serve
leases: **KV silence is never peer evidence**.  A lease that the store
answered about but that stopped advancing ripens into a named
replica-loss verdict after the timeout; a store that did not answer
FREEZES the confirmed-silence clocks (and, past the timeout, the whole
verdict plane) instead of aging every lease at once, so an outage can
never mint a verdict.

Two faster signals act on the balance set at once, not at the next lease
round:

* a **down-mark** (``mark_unready``) from the data path: a replica that
  answered 503 or refused a connection leaves the balance set now and
  returns only on a FRESH ready lease (seq past the mark);
* a **deregistration**: a cleanly drained replica deletes its lease key
  (the registrar's goodbye), which the next listing turns into a silent
  removal rather than a loss verdict.
"""

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.distributed import elastic
from unicore_tpu_torch.serve.fleet import kv as fleet_kv
from unicore_tpu_torch.serve.fleet import registry
from unicore_tpu_torch.utils import retry

logger = logging.getLogger(__name__)


def host_port(address: str):
    """``http://host:port[/]`` (or ``host:port``) -> ``(host, port)``;
    ValueError for an address without a port."""
    addr = str(address)
    if "//" in addr:
        addr = addr.split("//", 1)[1]
    addr = addr.rstrip("/")
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


@dataclass
class ReplicaInfo:
    """The router's live view of one registered replica."""

    name: str
    slot: int
    address: str
    ready: bool = False
    digest: str = ""
    est_delay_s: float = 0.0
    seq: int = -1
    #: with seq, the lease's wall stamp identifies an INCARNATION: a
    #: restarted replica re-counts seq from 1 but stamps a new wall
    wall: float = 0.0
    served: int = 0
    #: down-mark: (reason, seq at mark time), cleared only by a FRESH ready
    #: lease, so a stale pre-drain beat cannot resurrect a replica
    down: Optional[tuple] = None
    reloading: bool = False
    inflight: int = 0
    joined_at: float = field(default_factory=time.monotonic)

    def routable(self) -> bool:
        return self.ready and self.down is None and not self.reloading


class FleetView:
    """Membership and balance set of one router process.

    ``poll_once`` is the lease round (membership thread); ``mark_*`` and
    the in-flight accounting are data-path calls (request threads).  One
    lock guards the maps; the LeaseTable is touched from the poll thread
    only."""

    def __init__(self, client, *, timeout: float, clock=time.monotonic):
        self.client = client
        self.timeout = float(timeout)
        self._clock = clock
        self._table = elastic.LeaseTable([], epoch=0, timeout=self.timeout, now=clock())
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaInfo] = {}
        self._slots: Dict[int, str] = {}
        self._next_slot = 0
        #: name -> (seq, wall) of the last beat before the loss verdict: a
        #: key carrying exactly that beat is the corpse's lease still in the
        #: store, not a rejoin; a restart stamps a new wall and rejoins on
        #: its first beat
        self._lost: Dict[str, tuple] = {}
        self.frozen_since: Optional[float] = None
        self.rounds = 0
        self.verdicts = 0
        #: monotone replica-loss count (the Prometheus counter; the ``lost``
        #: list shrinks on a rejoin)
        self.losses = 0
        self._bad_address_warned: set = set()

    # -- data path (request threads) --------------------------------------

    def balance_set(self) -> List[ReplicaInfo]:
        with self._lock:
            return [r for r in self._replicas.values() if r.routable()]

    def get(self, name: str) -> Optional[ReplicaInfo]:
        with self._lock:
            return self._replicas.get(name)

    def mark_unready(self, name: str, reason: str) -> None:
        """Take a replica out of the balance set now: a 503 or a refused
        connection is fresher evidence than its last lease."""
        with self._lock:
            info = self._replicas.get(name)
            if info is None or info.down is not None:
                return
            info.down = (str(reason), info.seq)
        logger.warning(
            f"FLEET DOWN-MARK: replica {name} out of the balance set "
            f"({reason}); a fresh ready lease re-admits it"
        )
        telemetry.emit("fleet-verdict", verdict="down-mark", replica=str(name),
                       reason=str(reason))

    def set_reloading(self, name: str, on: bool) -> None:
        with self._lock:
            info = self._replicas.get(name)
            if info is not None:
                info.reloading = bool(on)

    def note_dispatch(self, name: str) -> None:
        with self._lock:
            info = self._replicas.get(name)
            if info is not None:
                info.inflight += 1

    def note_done(self, name: str) -> None:
        with self._lock:
            info = self._replicas.get(name)
            if info is not None and info.inflight > 0:
                info.inflight -= 1

    # -- the lease round (membership thread) -------------------------------

    def poll_once(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        listing = fleet_kv.kv_list(self.client, registry.HB_PREFIX)
        if listing is retry.UNREACHABLE:
            # no evidence about any replica: advance no clock
            self._sweep(now)
            return
        # the store answered (even about an empty fleet)
        self._table.note_service_ok(now)
        seen = set()
        for key, raw in listing:
            name = registry.name_of_key(key)
            try:
                lease = registry.decode_replica_lease(raw)
            except (ValueError, KeyError) as err:
                logger.warning(f"undecodable replica lease {key}: {err}")
                continue
            # an address the router cannot dial never enters the balance set
            try:
                host_port(lease.address)
            except (TypeError, ValueError):
                if name not in self._bad_address_warned:
                    self._bad_address_warned.add(name)
                    logger.error(
                        f"FLEET BAD-ADDRESS: replica {name} advertises "
                        f"unroutable address {lease.address!r} "
                        "(need host:port); ignoring its lease"
                    )
                continue
            seen.add(name)
            self._observe(name, lease, now)
        # the service-confirmed absence of a known replica is a goodbye
        with self._lock:
            gone = [n for n in self._replicas if n not in seen]
        for name in gone:
            self._remove(name, "deregistered", "lease key deleted (clean goodbye)")
        self._sweep(now)
        self.rounds += 1

    def _observe(self, name: str, lease: registry.ReplicaLease, now: float) -> None:
        corpse = self._lost.get(name)
        if corpse is not None and lease.hb.seq <= corpse[0] and lease.hb.wall <= corpse[1]:
            return  # the corpse's last beat, still on disk
        with self._lock:
            info = self._replicas.get(name)
            if info is None:
                slot = self._next_slot
                self._next_slot += 1
                info = ReplicaInfo(name=name, slot=slot, address=lease.address)
                self._replicas[name] = info
                self._slots[slot] = name
                self._table.add_peer(slot, now)
                rejoin = self._lost.pop(name, None) is not None
                logger.info(
                    f"FLEET {'REJOIN' if rejoin else 'JOIN'}: replica "
                    f"{name} at {lease.address}"
                )
                telemetry.emit("fleet-replica", event="rejoined" if rejoin else "joined",
                               replica=name, address=lease.address)
            advanced = lease.hb.seq > info.seq
            info.address = lease.address
            info.ready = lease.ready
            info.digest = lease.digest
            info.est_delay_s = lease.est_delay_s
            info.served = lease.hb.step
            info.seq = max(info.seq, lease.hb.seq)
            info.wall = max(info.wall, lease.hb.wall)
            # a down-mark clears only on a FRESH ready beat that postdates it
            if (info.down is not None and lease.ready and advanced
                    and lease.hb.seq > info.down[1]):
                logger.info(
                    f"FLEET RE-ADMIT: replica {name} ready again "
                    f"(fresh lease seq {lease.hb.seq} clears '{info.down[0]}')"
                )
                info.down = None
            slot = info.slot
        self._table.observe(slot, lease.hb, now)

    def _sweep(self, now: float) -> None:
        verdict = self._table.sweep(now)
        if verdict is None:
            if self.frozen_since is not None:
                logger.warning(
                    "FLEET UNFREEZE: the fleet store answers again; "
                    "verdicts resume from service-confirmed clocks"
                )
                self.frozen_since = None
            return
        if verdict.kind == "control-plane":
            # the store is dark (or every lease went silent at once, which
            # cannot be told from a partition): freeze, never mint
            if self.frozen_since is None:
                self.frozen_since = now
                logger.error(
                    f"FLEET FREEZE: {verdict.message} — membership verdicts "
                    "are FROZEN (an outage is evidence about the store, not "
                    "about any replica); routing continues over the last "
                    "confirmed view"
                )
                telemetry.emit("fleet-verdict", verdict="control-plane-freeze",
                               message=verdict.message)
            return
        silences = self._table.silences()
        for slot in verdict.ranks:
            name = self._slots.get(slot)
            if name is None:
                continue
            age = silences.get(slot, self.timeout)
            self._remove(
                name, "replica-loss",
                f"heartbeat lease silent for {age:.1f}s "
                f"(> fleet timeout {self.timeout:g}s, service-confirmed)",
            )

    def _remove(self, name: str, verdict: str, why: str) -> None:
        with self._lock:
            info = self._replicas.pop(name, None)
            if info is None:
                return
            self._slots.pop(info.slot, None)
            self._table.remove_peer(info.slot)
            if verdict == "replica-loss":
                self._lost[name] = (info.seq, info.wall)
                self.losses += 1
        self.verdicts += 1
        log = logger.error if verdict == "replica-loss" else logger.info
        log(
            f"FLEET {verdict.upper().replace('_', '-')}: replica {name} "
            f"removed from the fleet — {why}"
        )
        telemetry.emit("fleet-verdict", verdict=str(verdict), replica=str(name),
                       message=str(why))

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            replicas = {
                name: {
                    "address": r.address,
                    "ready": r.ready,
                    "routable": r.routable(),
                    "down": r.down[0] if r.down else None,
                    "reloading": r.reloading,
                    "est_delay_s": round(r.est_delay_s, 4),
                    "inflight": r.inflight,
                    "digest": r.digest,
                    "served": r.served,
                }
                for name, r in sorted(self._replicas.items())
            }
        return {
            "replicas": replicas,
            "routable": sum(1 for r in replicas.values() if r["routable"]),
            "lost": sorted(self._lost),
            "losses": self.losses,
            "frozen": self.frozen_since is not None,
            "rounds": self.rounds,
            "verdicts": self.verdicts,
        }


class MembershipRunner:
    """Background lease-round thread (sliced sleeps; prompt stop)."""

    def __init__(self, view: FleetView, interval_s: float):
        self.view = view
        self.interval_s = max(0.1, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MembershipRunner":
        self._thread = threading.Thread(target=self._run, name="router-membership",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.view.poll_once()
            except Exception:
                # the membership plane never takes the router down
                logger.exception("fleet lease round failed; routing continues "
                                 "over the last view")
            self._stop.wait(timeout=self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
