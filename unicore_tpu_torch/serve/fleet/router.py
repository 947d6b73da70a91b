"""The shedding router: spread, bound, retry — never buffer (counterpart of
``unicore_tpu/serve/fleet/router.py``).

``unicore-tpu-torch-router`` fronts a fleet of serve replicas with the
replicas' own first rule: overload and failure resolve to an immediate
NAMED outcome, never an unbounded wait.

* **Spread**: power-of-two-choices over the balance set: two random
  routable replicas, the lower score wins (the replica's lease-published
  admission estimate, plus the router's own in-flight count at a per-request
  cost, so the herd self-limits between lease rounds); a tie is a coin flip.
* **Bound**: every proxy leg carries the request's ``Deadline``: the
  downstream ``deadline_ms`` is rewritten to the REMAINING budget, and the
  leg's socket timeout is the same budget.  A wedged replica (chaos
  ``replica-stall``) costs one deadline and is down-marked.
* **Retry**: connect failures and replica 5xx re-route to a DIFFERENT
  replica under a per-request budget (``utils/retry.retry_call``), never
  once the request body has streamed to a replica (it may have run it).
* **Shed**: an empty balance set is an immediate 503 ``no-ready-replica``
  (the transport adds ``Retry-After``); the router holds no queue.
"""

import json
import logging
import random
import socket
import threading
import time
from http.client import HTTPConnection, HTTPException
from typing import Dict, List, Optional, Tuple

import numpy as np

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.serve.fleet.membership import FleetView, ReplicaInfo, host_port
from unicore_tpu_torch.utils import retry

__all__ = ["RouterEngine", "host_port"]

logger = logging.getLogger(__name__)

# the router's own shed reasons (a replica's sheds pass through untouched)
SHED_NO_REPLICA = "no-ready-replica"
SHED_RETRY_BUDGET = "retry-budget-exhausted"
SHED_DEADLINE = "deadline-expired"
UPSTREAM_INCOMPLETE = "upstream-incomplete"
UPSTREAM_TIMEOUT = "upstream-timeout"


def _body_reason(data: bytes) -> str:
    """The named reason out of a replica's JSON body, '' when unparseable."""
    try:
        doc = json.loads(data.decode("utf-8"))
        return str(doc.get("reason") or "")
    except (ValueError, AttributeError):
        return ""


class _Attempt(RuntimeError):
    """One proxy leg's terminal failure, classified for the retry policy:
    ``retryable`` re-routes to another replica, anything else is the
    request's final answer."""

    def __init__(self, code: int, reason: str, *, retryable: bool,
                 replica: str = "", detail: str = ""):
        super().__init__(f"{reason} (replica {replica or '?'})")
        self.code = int(code)
        #: the bare reason keys counters and Prometheus labels; errno text
        #: rides ``detail``
        self.reason = str(reason)
        self.retryable = bool(retryable)
        self.replica = str(replica)
        self.detail = str(detail)


class RouterEngine:
    """Replica choice, the deadline-bounded proxy and retry accounting for
    one router process; transport-free (``serve/fleet/http.py`` is the
    shell)."""

    #: score gap below which two replicas tie and the choice is a coin flip
    _TIE_EPS = 1e-6
    #: a proxy leg's socket timeout past the request's remaining budget: the
    #: replica's own response marshalling
    _LEG_GRACE_S = 0.25
    #: client latencies kept for the percentiles
    _LATENCY_WINDOW = 2048

    def __init__(self, view: FleetView, *, retry_budget: int = 2,
                 rng: Optional[random.Random] = None):
        self.view = view
        self.retry_budget = max(0, int(retry_budget))
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self.proxied = 0
        self.ok = 0
        self.retries = 0
        self.shed_counts: Dict[str, int] = {}
        self.by_code: Dict[int, int] = {}
        self.by_replica: Dict[str, int] = {}
        self._latencies_ms: List[float] = []

    # -- replica choice ---------------------------------------------------

    def _score(self, info: ReplicaInfo, cost_s: float) -> float:
        # the lease estimate is stale between rounds (and an idle replica
        # never refreshes it): cost each in-flight request forward
        return info.est_delay_s + info.inflight * cost_s

    def pick_replica(self, exclude=()) -> Optional[ReplicaInfo]:
        candidates = [r for r in self.view.balance_set() if r.name not in exclude]
        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        # one request's worth of delay: the pair's own estimates, floored so
        # a cold fleet publishing 0.0 still pays a congestion cost
        cost_s = max(a.est_delay_s, b.est_delay_s, 0.001)
        sa, sb = self._score(a, cost_s), self._score(b, cost_s)
        if abs(sa - sb) <= self._TIE_EPS:
            return a if self._rng.random() < 0.5 else b
        return a if sa < sb else b

    # -- the proxy --------------------------------------------------------

    def handle_infer(self, payload: dict, deadline: Deadline) -> Tuple[int, dict]:
        """Route one request; ``(http_code, response_json)``.  Every
        terminal outcome is named: nothing raises into the transport."""
        with self._lock:
            self.proxied += 1
        attempted: List[str] = []
        t0 = time.monotonic()

        def attempt_once():
            if deadline.exceeded():
                raise _Attempt(504, SHED_DEADLINE, retryable=False)
            pick = self.pick_replica(exclude=attempted)
            if pick is None:
                raise _Attempt(503, SHED_NO_REPLICA, retryable=False)
            attempted.append(pick.name)
            return self._proxy_leg(pick, payload, deadline)

        def on_retry(err, attempt, delay):
            with self._lock:
                self.retries += 1
            logger.warning(
                f"ROUTER RETRY: {err.reason} on replica {err.replica}; "
                f"re-routing (attempt {attempt + 1}, budget {self.retry_budget})"
            )
            telemetry.emit("router-retry", reason=err.reason, replica=err.replica,
                           attempt=int(attempt + 1))

        try:
            code, body = retry.retry_call(
                attempt_once,
                retry.RetryPolicy(
                    attempts=1 + self.retry_budget,
                    backoff=0.02, multiplier=2.0, jitter=0.25,
                    deadline=max(deadline.remaining(), 0.001),
                ),
                giveup=lambda err: not getattr(err, "retryable", False),
                on_retry=on_retry,
            )
        except Exception as err:
            if not isinstance(err, _Attempt):
                logger.exception("router proxy failed unexpectedly")
                self._count_shed("router-internal-error", 500)
                return 500, {"status": "error", "reason": "router-internal-error",
                             "detail": f"{type(err).__name__}: {err}"}
            reason = err.reason
            if err.retryable:
                # the budget (or the deadline) ran out mid-retry: the outcome
                # is the router's, the last leg's failure rides along
                code, body = 503, {
                    "status": "shed", "reason": SHED_RETRY_BUDGET,
                    "last_error": err.reason, "replicas_tried": attempted,
                }
                reason = SHED_RETRY_BUDGET
            else:
                code = err.code
                body = {"status": "shed" if code == 503 else "error", "reason": err.reason}
                if err.detail:
                    body["detail"] = err.detail
                if code == 504:
                    body["status"] = "expired"
            self._count_shed(reason, code)
            return code, body
        with self._lock:
            self.by_code[code] = self.by_code.get(code, 0) + 1
            if code == 200:
                self.ok += 1
                self._latencies_ms.append((time.monotonic() - t0) * 1000.0)
                if len(self._latencies_ms) > self._LATENCY_WINDOW:
                    del self._latencies_ms[: self._LATENCY_WINDOW // 4]
        return code, body

    def _proxy_leg(self, info: ReplicaInfo, payload: dict,
                   deadline: Deadline) -> Tuple[int, dict]:
        remaining = deadline.remaining()
        if remaining <= 0:
            raise _Attempt(504, SHED_DEADLINE, retryable=False)
        host, port = host_port(info.address)
        # the leg is bounded by the request's remaining budget plus a grace
        # for the replica's marshalling: a stalled replica costs one deadline
        conn = HTTPConnection(host, port, timeout=remaining + self._LEG_GRACE_S)
        try:
            try:
                conn.connect()
            except OSError as err:
                # nothing streamed: safe to re-route
                self.view.mark_unready(info.name, "connect-failure")
                raise _Attempt(502, "connect-failure", retryable=True,
                               replica=info.name, detail=str(err)) from None
            # downstream sees what is LEFT of the deadline
            body = json.dumps(
                {**payload, "deadline_ms": round(remaining * 1000.0, 1)}
            ).encode("utf-8")
            self.view.note_dispatch(info.name)
            try:
                try:
                    conn.request("POST", "/v1/infer", body,
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                    status = resp.status
                except (socket.timeout, TimeoutError) as err:
                    # streamed, never answered (the replica-stall zombie):
                    # down-mark and answer 504, never retried
                    self.view.mark_unready(info.name, UPSTREAM_TIMEOUT)
                    raise _Attempt(504, UPSTREAM_TIMEOUT, retryable=False,
                                   replica=info.name) from err
                except (HTTPException, OSError) as err:
                    # the body streamed: the replica may have run it -- a
                    # named 502, never a recompute elsewhere
                    self.view.mark_unready(info.name, UPSTREAM_INCOMPLETE)
                    raise _Attempt(502, UPSTREAM_INCOMPLETE, retryable=False,
                                   replica=info.name, detail=str(err)) from None
            finally:
                self.view.note_done(info.name)
        finally:
            conn.close()
        if status == 503:
            # the replica's /readyz flipped (draining, reloading): leave the
            # balance set now and re-route -- a whole 503 is a definitive
            # "not me", safe to retry
            reason = _body_reason(data) or "not-ready"
            self.view.mark_unready(info.name, f"503:{reason}")
            raise _Attempt(503, f"replica-503:{reason}", retryable=True,
                           replica=info.name)
        if status in (500, 502):
            raise _Attempt(status, f"replica-{status}", retryable=True, replica=info.name)
        with self._lock:
            self.by_replica[info.name] = self.by_replica.get(info.name, 0) + 1
        try:
            doc = json.loads(data.decode("utf-8"))
        except ValueError:
            doc = {"status": "error", "reason": "unparseable-upstream",
                   "replica": info.name}
        return status, doc

    # -- accounting --------------------------------------------------------

    def _count_shed(self, reason: str, code: int) -> None:
        with self._lock:
            self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
            self.by_code[code] = self.by_code.get(code, 0) + 1
            count = self.shed_counts[reason]
        logger.warning(f"ROUTER SHED: {reason} #{count} -> {code}")
        if count <= 5 or count % 100 == 0:
            telemetry.emit("router-shed", reason=str(reason), count=int(count),
                           code=int(code))

    def ready(self) -> bool:
        return bool(self.view.balance_set())

    def latency_percentiles(self) -> dict:
        with self._lock:
            lat = list(self._latencies_ms)
        if not lat:
            return {}
        arr = np.asarray(lat)
        return {f"p{p}_ms": round(float(np.percentile(arr, p)), 3) for p in (50, 90, 99)}

    def stats(self) -> dict:
        with self._lock:
            counters = {
                "proxied": self.proxied,
                "ok": self.ok,
                "retries": self.retries,
                "shed": dict(self.shed_counts),
                "by_code": {str(k): v for k, v in self.by_code.items()},
                "by_replica": dict(self.by_replica),
            }
        return {
            "ready": self.ready(),
            **counters,
            **self.latency_percentiles(),
            "fleet": self.view.stats(),
        }
