"""Rolling fleet reload: one replica at a time, a blast radius of one
(counterpart of ``unicore_tpu/serve/fleet/rolling.py``).

A single replica's reload is already safe (``serve/reload.py``: verified
load, probe batch, swap on a batch boundary, or a named ``RELOAD
ROLLBACK`` that keeps the serving snapshot).  The router watches the
published checkpoint with the same :class:`CheckpointWatcher` and, on a new
candidate, walks the routable replicas in name order, asking each through
its ``POST /v1/reload`` to run its OWN verify -> probe -> swap:

* **one at a time**: the next replica is asked only after the previous one
  answered ``swapped`` and a lease it published after that answer says it
  is ready (a beat and a membership round, ~2 intervals; the JAX roll asks
  the next one at once, while the view still holds the reloading
  replica's ready=false lease, so both can be out of the balance set for a
  beat); the one mid-reload is out of the balance set;
* **halt on the first non-swap**: a ``rejected:*`` rollback, a replica that
  cannot be asked (``unreachable``), or a reload past its budget halts the
  roll; every replica after it is never asked, and the fleet keeps serving
  the old snapshot.

A halted candidate is consumed like any other: it is retried only once it
is re-published.
"""

import json
import logging
import threading
import time
from http.client import HTTPConnection
from typing import List, Optional

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.serve.fleet.membership import FleetView, host_port
from unicore_tpu_torch.serve.reload import OUTCOME_SWAPPED, CheckpointWatcher

logger = logging.getLogger(__name__)


class RollingReload:
    """Watcher plus one-at-a-time orchestration, in the router process."""

    def __init__(self, watcher: CheckpointWatcher, view: FleetView, *,
                 interval_s: float, reload_timeout_s: float = 300.0):
        self.watcher = watcher
        self.view = view
        self.interval_s = max(0.1, float(interval_s))
        self.reload_timeout_s = float(reload_timeout_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rolled = 0
        self.halted = 0
        self.last_outcome: Optional[str] = None

    def _ask_replica(self, address: str, path: str) -> str:
        """One replica's verdict on the candidate, answered synchronously.
        A replica that cannot even be asked answers ``unreachable (...)``,
        which halts the roll like a rollback."""
        host, port = host_port(address)
        conn = HTTPConnection(host, port, timeout=self.reload_timeout_s)
        try:
            body = json.dumps({"path": path}).encode("utf-8")
            conn.request("POST", "/v1/reload", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            doc = json.loads(resp.read().decode("utf-8"))
            if resp.status != 200:
                return str(doc.get("outcome") or f"http-{resp.status}")
            return str(doc.get("outcome", "unparseable"))
        except Exception as err:
            return f"unreachable ({type(err).__name__}: {err})"
        finally:
            conn.close()

    def _readmitted(self, name: str, answered_seq: int) -> bool:
        """Wait (up to the reload budget) until a lease past
        ``answered_seq`` puts the swapped replica back in the balance set;
        False when none does, or the replica left the fleet."""
        deadline = time.monotonic() + self.reload_timeout_s
        while not self._stop.is_set():
            info = self.view.get(name)
            if info is None:
                return False
            if info.seq > answered_seq and info.routable():
                return True
            if time.monotonic() >= deadline:
                return False
            self._stop.wait(0.02)
        return False

    def roll(self, path: str) -> List[tuple]:
        """Walk the fleet for one candidate; the per-replica ``(name,
        outcome)`` history, which stops at the first non-swap."""
        replicas = sorted(self.view.balance_set(), key=lambda r: r.name)
        if not replicas:
            logger.warning(
                f"ROLLING RELOAD SKIPPED: no routable replica to offer {path} "
                "to (it stays pending re-publish)"
            )
            return []
        logger.info(
            f"ROLLING RELOAD: candidate {path} across {len(replicas)} "
            "replica(s), one at a time"
        )
        telemetry.emit("fleet-reload", event="start", path=path,
                       replicas=[r.name for r in replicas])
        history: List[tuple] = []
        for info in replicas:
            if self._stop.is_set():
                break
            # out of the balance set for its own reload (its /readyz flips
            # too; this closes the races in between)
            self.view.set_reloading(info.name, True)
            try:
                outcome = self._ask_replica(info.address, path)
                answered = self.view.get(info.name)
            finally:
                self.view.set_reloading(info.name, False)
            history.append((info.name, outcome))
            self.last_outcome = outcome
            telemetry.emit("fleet-reload", event="replica-outcome", replica=info.name,
                           outcome=outcome, path=path)
            if outcome == OUTCOME_SWAPPED and not self._readmitted(
                    info.name, answered.seq if answered is not None else info.seq):
                outcome = "not-readmitted"
                self.last_outcome = outcome
            if outcome != OUTCOME_SWAPPED:
                self.halted += 1
                never_asked = len(replicas) - len(history)
                logger.error(
                    f"ROLLING RELOAD HALT: replica {info.name}: '{outcome}' for "
                    f"{path} — the {never_asked} remaining replica(s) were never "
                    "asked and keep serving the old snapshot (a rolled-back "
                    "replica serves it too).  Blast radius: one replica."
                )
                telemetry.emit("fleet-reload", event="halt", replica=info.name,
                               outcome=outcome, path=path, never_asked=never_asked)
                return history
            logger.info(
                f"ROLLING RELOAD: replica {info.name} swapped "
                f"({len(history)}/{len(replicas)})"
            )
        self.rolled += 1
        logger.info(
            f"ROLLING RELOAD COMPLETE: {len(history)}/{len(replicas)} "
            f"replica(s) swapped to {path}"
        )
        telemetry.emit("fleet-reload", event="complete", path=path, swapped=len(history))
        return history

    def start(self) -> "RollingReload":
        self._thread = threading.Thread(target=self._run, name="router-rolling-reload",
                                        daemon=True)
        self._thread.start()
        logger.info(
            f"rolling reload armed: watching {self.watcher.path} every "
            f"{self.interval_s:g}s, one replica at a time"
        )
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                candidate = self.watcher.poll()
                if candidate is not None:
                    self.roll(candidate)
            except Exception:
                # the reload plane never takes the router down
                logger.exception("rolling reload poll failed; routing continues")
            self._stop.wait(timeout=self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
