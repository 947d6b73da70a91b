"""Prometheus text-format exposition, version 0.0.4 (counterpart of
``unicore_tpu/telemetry/prometheus.py``), without the client library: the
subset a scrape needs (gauges and counters with labels, ``# HELP`` /
``# TYPE`` lines, escaped label values).

The serve HTTP plane's ``GET /metrics`` renders the engine's live stats
(:func:`render_engine`) plus anything in the process registry, the fleet
router's renders its counters and the fleet view (:func:`render_router`);
the trainer refreshes the registry once per metrics flush
(:func:`export_trainer`), and :func:`start_metrics_server` serves the
registry alone on a port of its own (the train CLI's ``--metrics-port``).
Names follow the Prometheus conventions: ``unicore_tpu_`` prefix,
``_total`` suffix for counters, base units (seconds).
"""

import logging
import re
import threading
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", str(name))
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _format_value(value: float) -> str:
    """Full-precision sample rendering: ``%g`` would quantize counters to
    6 significant digits (updates_total 1234567 -> '1.23457e+06'),
    making rate()/increase() over the exposition wrong past 1e6.
    Integral values render as integers, everything else as Python's
    shortest round-trip repr."""
    f = float(value)
    if f.is_integer() and abs(f) < 1e15:  # exactly representable range
        return str(int(f))
    return repr(f)


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r"\"")
    )


class Registry:
    """Metric families -> labeled samples.  ``set`` overwrites (gauge
    semantics); counters are values the CALLER keeps monotone (the
    subsystems already own their counts — re-counting here would drift)."""

    def __init__(self):
        self._lock = threading.Lock()
        # family -> (help, type, {labels-tuple: value})
        self._families: Dict[str, Tuple[str, str, Dict[tuple, float]]] = {}

    def set(self, name: str, value: float,
            labels: Optional[Dict[str, str]] = None,
            help: str = "", type: str = "gauge") -> None:
        name = _sanitize(name)
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            fam = self._families.setdefault(name, (help, type, {}))
            if (help and help != fam[0]) or (type != fam[1]):
                fam = (help or fam[0], type, fam[2])
                self._families[name] = fam
            fam[2][key] = float(value)

    def render(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self._families):
                help_, type_, samples = self._families[name]
                if help_:
                    lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {type_}")
                for key, value in sorted(samples.items()):
                    rendered = _format_value(value)
                    if key:
                        labels = ",".join(
                            f'{_sanitize(k)}="{_escape_label(v)}"'
                            for k, v in key
                        )
                        lines.append(f"{name}{{{labels}}} {rendered}")
                    else:
                        lines.append(f"{name} {rendered}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._families = {}


_registry = Registry()


def registry() -> Registry:
    return _registry


def set_gauge(name: str, value: float,
              labels: Optional[Dict[str, str]] = None,
              help: str = "") -> None:
    _registry.set(name, value, labels=labels, help=help, type="gauge")


def set_counter(name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                help: str = "") -> None:
    """Expose a caller-owned monotone count (the subsystem keeps the
    authoritative counter; this just publishes its current value)."""
    _registry.set(name, value, labels=labels, help=help, type="counter")


def reset() -> None:
    _registry.clear()


# ---------------------------------------------------------------------------
# serve-plane rendering
# ---------------------------------------------------------------------------

def render_engine(engine) -> str:
    """Exposition for one :class:`~unicore_tpu_torch.serve.engine.ServeEngine`
    (or its decode subclass): a fresh registry built from ``engine.stats()``
    (always current, no scrape-cadence staleness) merged with the process
    registry.  The metric names, labels and help texts are the JAX
    package's."""
    stats = engine.stats()
    reg = Registry()
    reg.set("unicore_tpu_serve_ready", 1.0 if stats.get("ready") else 0.0,
            help="1 while the engine is warmed and accepting")
    reg.set("unicore_tpu_serve_served_total", stats.get("served", 0),
            help="requests answered OK", type="counter")
    reg.set("unicore_tpu_serve_admitted_total", stats.get("admitted", 0),
            help="requests past admission", type="counter")
    reg.set("unicore_tpu_serve_batches_total", stats.get("batches", 0),
            help="dispatched batches", type="counter")
    reg.set("unicore_tpu_serve_queue_depth", stats.get("depth", 0),
            help="admission queue depth now")
    reg.set("unicore_tpu_serve_estimated_delay_seconds",
            stats.get("estimated_delay_s", 0.0),
            help="queue-delay estimate admission sheds on")
    reg.set("unicore_tpu_serve_recompiles_after_warmup_total",
            stats.get("recompiles_after_warmup", 0),
            help="post-warm-up serve recompiles (should stay 0)",
            type="counter")
    reg.set("unicore_tpu_serve_reloads_applied_total",
            stats.get("reloads_applied", 0),
            help="hot reloads swapped in", type="counter")
    for reason, count in (stats.get("shed") or {}).items():
        reg.set("unicore_tpu_serve_shed_total", count,
                labels={"reason": str(reason)},
                help="requests shed, by named reason", type="counter")
    for pct in ("p50_ms", "p90_ms", "p99_ms"):
        if pct in stats:
            reg.set("unicore_tpu_serve_latency_seconds",
                    float(stats[pct]) / 1000.0,
                    labels={"quantile": "0." + pct[1:-3]},
                    help="request latency percentiles over a sliding window")
    if stats.get("mode") == "decode":
        # the decode plane (serve/decode.py): generation throughput, paged
        # KV-cache pressure + the continuous-batching churn counters
        reg.set("unicore_tpu_serve_tokens_generated_total",
                stats.get("tokens_generated", 0),
                help="tokens sampled across all generations",
                type="counter")
        reg.set("unicore_tpu_serve_tokens_per_second",
                stats.get("tokens_per_s", 0.0),
                help="generation throughput since readiness")
        reg.set("unicore_tpu_serve_cache_page_occupancy",
                stats.get("cache_page_occupancy", 0.0),
                help="fraction of KV-cache pages in use")
        reg.set("unicore_tpu_serve_cache_pages_free",
                stats.get("cache_pages_free", 0),
                help="KV-cache pages on the free list")
        reg.set("unicore_tpu_serve_active_sequences",
                stats.get("active_sequences", 0),
                help="generations currently holding cache pages")
        reg.set("unicore_tpu_serve_preempted_total",
                stats.get("preempted", 0),
                help="sequences preempted by cache-page exhaustion",
                type="counter")
        reg.set("unicore_tpu_serve_requeued_total",
                stats.get("requeued", 0),
                help="step-level scheduler re-entries (continuous "
                     "batching churn)", type="counter")
        reg.set("unicore_tpu_serve_decode_steps_total",
                stats.get("decode_steps", 0),
                help="decode step batches dispatched", type="counter")
        reg.set("unicore_tpu_serve_prefill_batches_total",
                stats.get("prefill_batches", 0),
                help="prefill batches dispatched", type="counter")
        for pct in ("token_p50_ms", "token_p90_ms", "token_p99_ms"):
            if pct in stats:
                reg.set("unicore_tpu_serve_token_latency_seconds",
                        float(stats[pct]) / 1000.0,
                        labels={"quantile": "0." + pct.split("_")[1].lstrip("p")},
                        help="per-token decode-step latency percentiles")
    return reg.render() + _registry.render()


# ---------------------------------------------------------------------------
# router-plane rendering
# ---------------------------------------------------------------------------

def render_router(engine) -> str:
    """Exposition for one
    :class:`~unicore_tpu_torch.serve.fleet.router.RouterEngine`: the router's
    counters and the per-replica fleet view, under the JAX package's names,
    labels and help texts."""
    stats = engine.stats()
    fleet = stats.get("fleet") or {}
    reg = Registry()
    reg.set("unicore_tpu_router_ready", 1.0 if stats.get("ready") else 0.0,
            help="1 while >=1 replica is routable")
    reg.set("unicore_tpu_router_proxied_total", stats.get("proxied", 0),
            help="requests accepted for routing", type="counter")
    reg.set("unicore_tpu_router_ok_total", stats.get("ok", 0),
            help="requests answered 200 through a replica", type="counter")
    reg.set("unicore_tpu_router_retries_total", stats.get("retries", 0),
            help="proxy legs re-routed to a different replica",
            type="counter")
    for reason, count in (stats.get("shed") or {}).items():
        reg.set("unicore_tpu_router_shed_total", count,
                labels={"reason": str(reason)},
                help="router-level sheds, by named reason", type="counter")
    for code, count in (stats.get("by_code") or {}).items():
        reg.set("unicore_tpu_router_responses_total", count,
                labels={"code": str(code)},
                help="responses by final HTTP code", type="counter")
    reg.set("unicore_tpu_router_replicas_routable",
            fleet.get("routable", 0),
            help="replicas currently in the balance set")
    reg.set("unicore_tpu_router_replicas_lost_total",
            fleet.get("losses", 0),
            help="replica-loss verdicts minted (monotone; the lost LIST "
                 "shrinks on rejoin)", type="counter")
    reg.set("unicore_tpu_router_membership_frozen",
            1.0 if fleet.get("frozen") else 0.0,
            help="1 while a KV outage freezes the verdict plane")
    for name, rep in (fleet.get("replicas") or {}).items():
        labels = {"replica": str(name)}
        reg.set("unicore_tpu_router_replica_routable",
                1.0 if rep.get("routable") else 0.0, labels=labels,
                help="1 while this replica is in the balance set")
        reg.set("unicore_tpu_router_replica_est_delay_seconds",
                rep.get("est_delay_s", 0.0), labels=labels,
                help="the replica's lease-published admission estimate")
        reg.set("unicore_tpu_router_replica_inflight",
                rep.get("inflight", 0), labels=labels,
                help="router-local in-flight legs at this replica")
    for name, count in (stats.get("by_replica") or {}).items():
        reg.set("unicore_tpu_router_replica_proxied_total", count,
                labels={"replica": str(name)},
                help="requests answered by this replica", type="counter")
    for pct in ("p50_ms", "p90_ms", "p99_ms"):
        if pct in stats:
            reg.set("unicore_tpu_router_latency_seconds",
                    float(stats[pct]) / 1000.0,
                    labels={"quantile": "0." + pct[1:-3]},
                    help="router-side request latency percentiles")
    return reg.render() + _registry.render()


# ---------------------------------------------------------------------------
# the trainer's exposition
# ---------------------------------------------------------------------------

#: the step-span totals the trainer exports, one gauge each
TRAIN_SPAN_GAUGES = ("host_blocked", "device_busy", "data_wait", "plan_exchange", "h2d",
                     "dispatch")


def export_trainer(updates: int, interval_updates: float, span_totals: Dict[str, float],
                   step_wall: float) -> None:
    """Refresh the process registry with the trainer's metrics (the JAX
    trainer's ``_export_prometheus``: its names and help texts), once per
    metrics flush -- a scrape reads host memory only, never the device.
    The JAX trainer's ``unicore_tpu_train_recompiles_total`` has no
    counterpart: eager PyTorch compiles no step programs."""
    set_counter("unicore_tpu_train_updates_total", float(updates),
                help="trainer update counter")
    set_gauge("unicore_tpu_train_interval_updates", float(interval_updates),
              help="updates folded into the last metrics flush")
    for name in TRAIN_SPAN_GAUGES:
        set_gauge(f"unicore_tpu_train_{name}_seconds", float(span_totals.get(name, 0.0)),
                  help=f"interval seconds in the {name} phase "
                  "(device_busy is lag-1 sampled)")
    if step_wall > 0:
        set_gauge("unicore_tpu_train_step_wall_seconds", step_wall,
                  help="smoothed wall seconds per update (the value "
                  "heartbeat leases publish for straggler attribution)")


# ---------------------------------------------------------------------------
# standalone metrics port
# ---------------------------------------------------------------------------

def start_metrics_server(port: int, host: str = "0.0.0.0",
                         render: Optional[Callable[[], str]] = None):
    """Serve ``GET /metrics`` (the process registry by default) on a daemon
    thread; returns the server (``server_address`` carries the bound port)
    or None when ``port`` is 0/negative or the bind fails: a telemetry port
    never kills the process it observes."""
    if not port or int(port) <= 0:
        return None
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    render = render or (lambda: _registry.render())

    class _Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # scrape spam -> debug
            logger.debug("metrics: " + fmt % args)

        def do_GET(self):
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = render().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    try:
        server = ThreadingHTTPServer((host, int(port)), _Handler)
    except OSError as err:
        logger.warning(
            f"metrics port {host}:{port} could not bind ({err}); "
            "the process continues without the Prometheus endpoint"
        )
        return None
    server.daemon_threads = True
    threading.Thread(
        target=server.serve_forever, name="telemetry-metrics", daemon=True
    ).start()
    logger.info(
        f"Prometheus metrics on http://{server.server_address[0]}:"
        f"{server.server_address[1]}/metrics"
    )
    return server
