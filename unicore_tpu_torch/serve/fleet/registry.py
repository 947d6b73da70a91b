"""Replica registration: serve-namespaced heartbeat leases (counterpart of
``unicore_tpu/serve/fleet/registry.py``).

A replica's liveness rides the elastic lease core (epoch / monotone seq /
progress / wall stamp), published every interval; the serve lease wraps it
with what a router balances and verifies on: ``addr`` (where the replica's
HTTP plane answers), ``ready`` (its ``/readyz`` truth at publish time),
``digest`` (the serving snapshot's weights) and ``est_delay_s`` (its
admission estimate).  The JSON and the keys (``FLEET_PREFIX/hb/<name>``)
are the JAX package's, so either package's router reads either package's
replicas.
"""

import hashlib
import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.distributed import elastic
from unicore_tpu_torch.serve.fleet.kv import FLEET_PREFIX, check_name

logger = logging.getLogger(__name__)

_SERVE_LEASE_TAG = "uctp-serve1"

HB_PREFIX = f"{FLEET_PREFIX}/hb"


def lease_key(name: str) -> str:
    return f"{HB_PREFIX}/{check_name(name)}"


def name_of_key(key: str) -> str:
    return str(key).rsplit("/", 1)[-1]


@dataclass
class ReplicaLease:
    """One replica heartbeat: the elastic lease core plus the serve
    fields."""

    name: str
    address: str
    ready: bool
    digest: str
    est_delay_s: float
    hb: elastic.Lease

    def encode(self) -> str:
        return json.dumps({
            "tag": _SERVE_LEASE_TAG,
            "name": self.name,
            "addr": self.address,
            "ready": bool(self.ready),
            "digest": self.digest,
            "est_delay_s": round(float(self.est_delay_s), 6),
            "hb": elastic.encode_lease(self.hb),
        })


def decode_replica_lease(raw: str) -> ReplicaLease:
    doc = json.loads(str(raw))
    if not isinstance(doc, dict) or doc.get("tag") != _SERVE_LEASE_TAG:
        raise ValueError(f"not a serve replica lease: {raw!r}")
    return ReplicaLease(
        name=str(doc["name"]),
        address=str(doc["addr"]),
        ready=bool(doc.get("ready", False)),
        digest=str(doc.get("digest", "")),
        est_delay_s=float(doc.get("est_delay_s", 0.0)),
        hb=elastic.decode_lease(doc["hb"]),
    )


def model_digest(state_dict) -> str:
    """Content digest of a serving snapshot: sha256 over the state dict's
    sorted names, each tensor's shape, dtype name and raw bytes (bf16
    included: the bytes are hashed as they are, with no numpy dtype in
    between), cut to 16 hex digits as the JAX package cuts its own.  The
    JAX digest walks a flax tree, so the two never agree on one model.

    A card-resident model is copied to the host tensor by tensor: call it
    once at start-up and once per swap, never per beat."""
    h = hashlib.sha256()
    for name in sorted(state_dict):
        t = state_dict[name].detach().to("cpu").contiguous()
        h.update(str(name).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).replace("torch.", "").encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()[:16]


class ReplicaRegistrar:
    """Publisher thread: one serve lease per interval, plus two forced
    beats -- ``publish_now`` when readiness flips (the drain handshake must
    not wait out the interval) -- and a deletion goodbye on a clean stop, so
    the router DEREGISTERS the replica instead of waiting out the lease
    timeout to declare it lost."""

    def __init__(self, client, name: str, address: str, *,
                 interval_s: float,
                 ready_fn: Callable[[], bool],
                 est_delay_fn: Callable[[], float],
                 digest_fn: Callable[[], str],
                 served_fn: Optional[Callable[[], int]] = None):
        self.client = client
        self.name = check_name(name)
        self.address = str(address)
        self.interval_s = max(0.1, float(interval_s))
        self._ready_fn = ready_fn
        self._est_delay_fn = est_delay_fn
        self._digest_fn = digest_fn
        self._served_fn = served_fn or (lambda: 0)
        self._seq = 0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.publish_errors = 0

    def _lease(self) -> ReplicaLease:
        self._seq += 1
        return ReplicaLease(
            name=self.name,
            address=self.address,
            ready=bool(self._ready_fn()),
            digest=str(self._digest_fn()),
            est_delay_s=float(self._est_delay_fn()),
            hb=elastic.Lease(epoch=0, seq=self._seq, step=int(self._served_fn()),
                             wall=time.time()),
        )

    def publish_now(self) -> None:
        """One immediate beat.  A failed publish is counted, never raised:
        the replica keeps serving through a KV blip, and the router's
        freeze rule covers the gap."""
        with self._lock:
            try:
                self.client.key_value_set(lease_key(self.name), self._lease().encode(),
                                          allow_overwrite=True)
            except Exception as err:
                self.publish_errors += 1
                if self.publish_errors <= 3:
                    logger.warning(
                        f"replica lease publish failed ({err}); the fleet store may "
                        "be dark — serving continues, the router freezes rather "
                        "than minting verdicts"
                    )

    def start(self) -> "ReplicaRegistrar":
        self.publish_now()  # registered before the first interval elapses
        self._thread = threading.Thread(target=self._run, name="serve-fleet-registrar",
                                        daemon=True)
        self._thread.start()
        logger.info(
            f"FLEET REGISTERED: replica {self.name} at {self.address} "
            f"(lease every {self.interval_s:g}s)"
        )
        telemetry.emit("fleet-replica", event="registered", replica=self.name,
                       address=self.address)
        return self

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            self.publish_now()

    def stop(self, goodbye: bool = True) -> None:
        """Stop publishing; with ``goodbye`` the lease key is deleted, a
        service-confirmed deregistration instead of a silence that ripens
        into a replica-loss verdict."""
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if not goodbye:
            return
        try:
            self.client.key_value_delete(lease_key(self.name))
        except Exception as err:
            logger.warning(
                f"lease goodbye failed ({err}); the router will deregister on "
                "the missing key or expire the lease"
            )
            return
        logger.info(f"FLEET DEREGISTERED: replica {self.name} said goodbye")
        telemetry.emit("fleet-replica", event="deregistered", replica=self.name)
