"""Request/response contract of the serving plane (counterpart of
``unicore_tpu/serve/request.py``).

A :class:`ServeRequest` is one admitted-or-shed unit of work: a token
sequence, a per-request :class:`~unicore_tpu_torch.checkpoint.emergency.Deadline`,
and a completion event the transport waits on through
``utils/retry.bounded_wait``.  Every terminal outcome — served, shed,
expired — is a :class:`ServeResponse` with a NAMED reason; the reason
strings below are the same vocabulary as the JAX package's.
"""

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from unicore_tpu_torch.checkpoint.emergency import Deadline

# -- shed reasons (request rejected before any compute) ---------------------
SHED_QUEUE_FULL = "queue-full"
SHED_DEADLINE_UNMEETABLE = "deadline-unmeetable"
SHED_DRAINING = "draining"
SHED_NOT_READY = "not-ready"
SHED_TOO_LONG = "too-long"
#: admission-time page exhaustion on the decode plane (kept for vocabulary
#: parity; the decode plane is not ported yet)
SHED_CACHE_OOM = "cache-oom"

# -- expiry stages (request admitted, deadline ran out) ---------------------
EXPIRED_AT_ADMISSION = "expired-at-admission"
EXPIRED_IN_QUEUE = "expired-in-queue"
EXPIRED_AT_RESPONSE = "expired-at-response"

STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_EXPIRED = "expired"
STATUS_ERROR = "error"

_req_counter = itertools.count(1)


@dataclass
class ServeResponse:
    request_id: str
    status: str
    reason: Optional[str] = None
    #: predicted token ids for the request's (unpadded) length
    output: Optional[List[int]] = None
    #: model confidence proxy (mean best-logit over the padded row)
    score: Optional[float] = None
    latency_ms: Optional[float] = None
    bucket: Optional[int] = None

    def to_json(self) -> dict:
        out = {"id": self.request_id, "status": self.status}
        for k in ("reason", "output", "score", "latency_ms", "bucket"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


@dataclass
class ServeRequest:
    tokens: np.ndarray
    deadline: Deadline
    request_id: str = field(default_factory=lambda: f"r{next(_req_counter)}")
    arrival: float = field(default_factory=time.monotonic)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, dtype=np.int32).reshape(-1)
        self._done = threading.Event()
        self.response: Optional[ServeResponse] = None

    @classmethod
    def make(cls, tokens, deadline_s: float, request_id: Optional[str] = None):
        req = cls(tokens=tokens, deadline=Deadline(float(deadline_s)))
        if request_id:
            req.request_id = str(request_id)
        return req

    def __len__(self) -> int:
        return int(self.tokens.shape[0])

    def done(self) -> bool:
        return self._done.is_set()

    def respond(self, response: ServeResponse) -> None:
        """First responder wins: a request that expired in the queue must
        not be re-resolved by a racing engine batch (and vice versa)."""
        if self._done.is_set():
            return
        response.latency_ms = (
            response.latency_ms
            if response.latency_ms is not None
            else (time.monotonic() - self.arrival) * 1000.0
        )
        self.response = response
        self._done.set()

    # -- terse terminal helpers (admission/engine call these) ------------

    def shed(self, reason: str) -> None:
        self.respond(
            ServeResponse(self.request_id, STATUS_SHED, reason=reason)
        )

    def expire(self, stage: str) -> None:
        self.respond(
            ServeResponse(self.request_id, STATUS_EXPIRED, reason=stage)
        )

    def error(self, reason: str) -> None:
        self.respond(
            ServeResponse(self.request_id, STATUS_ERROR, reason=reason)
        )
