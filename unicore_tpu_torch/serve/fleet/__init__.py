"""The replica tier (counterpart of ``unicore_tpu/serve/fleet``): from one
serving process to a fleet behind a shedding router.

* **registration and liveness** ride the heartbeat-lease plane
  (``distributed/elastic.py``): serve-namespaced keys in a shared fleet KV
  directory (``kv.py``), the service-confirmed silence rule (an outage
  freezes verdicts, it never mints one) in ``membership.py``;
* **balancing**: each replica's lease publishes its admission estimate,
  and the router spreads by power-of-two-choices over it (``router.py``);
* **deadlines**: the proxy leg's socket timeout and the downstream
  ``deadline_ms`` are both the request's REMAINING budget;
* **retries** ride ``utils/retry.py``: connect failures and replica 5xx
  re-route to a different replica, never after the request body streamed;
* **rolling reload** (``rolling.py``) runs each replica's own
  verify -> probe -> swap, one replica at a time, halting on the first
  rollback;
* **observability**: the ``fleet-replica`` / ``fleet-verdict`` /
  ``router-shed`` / ``router-retry`` / ``fleet-reload`` journal events and
  ``telemetry/prometheus.render_router``.

Leases, keys and events are the JAX package's, so either package's router
routes to either package's replicas.  ``unicore_tpu_torch/cli/router.py``
(``unicore-tpu-torch-router``) is the operator entry point.
"""

from unicore_tpu_torch.serve.fleet.http import RouterHTTPServer, bind_router
from unicore_tpu_torch.serve.fleet.kv import FileKVClient, FleetKVError, open_fleet_kv
from unicore_tpu_torch.serve.fleet.membership import FleetView, MembershipRunner, ReplicaInfo
from unicore_tpu_torch.serve.fleet.registry import (
    ReplicaLease,
    ReplicaRegistrar,
    decode_replica_lease,
    model_digest,
)
from unicore_tpu_torch.serve.fleet.rolling import RollingReload
from unicore_tpu_torch.serve.fleet.router import RouterEngine

__all__ = [
    "FileKVClient",
    "FleetKVError",
    "FleetView",
    "MembershipRunner",
    "ReplicaInfo",
    "ReplicaLease",
    "ReplicaRegistrar",
    "RollingReload",
    "RouterEngine",
    "RouterHTTPServer",
    "bind_router",
    "decode_replica_lease",
    "model_digest",
    "open_fleet_kv",
]
