"""Router HTTP transport (counterpart of ``unicore_tpu/serve/fleet/http.py``):
every routing decision lives in
:class:`~unicore_tpu_torch.serve.fleet.router.RouterEngine`; this module maps
outcomes onto HTTP.

* ``GET /healthz``  -> 200 while the router process lives;
* ``GET /readyz``   -> 200 while at least one replica is routable, else 503
  with ``Retry-After``;
* ``GET /stats``    -> the router's counters and the fleet's membership;
* ``GET /metrics``  -> the Prometheus exposition of the same;
* ``POST /v1/infer`` -> proxied with the deadline carried end to end.

Nothing else (``/v1/generate`` is not routed, as in the JAX package).  The
body read is the replica's deadline-bounded one (a slow client gets a 408,
never a wedged worker), and every 503 carries ``Retry-After``.
"""

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from unicore_tpu_torch.checkpoint.emergency import Deadline
from unicore_tpu_torch.serve.http import SlowClientError, read_bounded_body
from unicore_tpu_torch.telemetry import prometheus

logger = logging.getLogger(__name__)

RETRY_AFTER_S = "1"


class RouterHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, engine, *, read_timeout_s: float = 10.0,
                 max_body_bytes: int = 1 << 20,
                 default_deadline_ms: float = 1000.0,
                 max_deadline_ms: float = 60000.0):
        self.engine = engine
        self.read_timeout_s = float(read_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.default_deadline_ms = float(default_deadline_ms)
        self.max_deadline_ms = float(max_deadline_ms)
        super().__init__(addr, RouterHandler)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, name="router-http", daemon=True)
        t.start()
        return t


class RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def setup(self):
        super().setup()
        self.connection.settimeout(self.server.read_timeout_s)

    def log_message(self, format, *args):
        logger.debug("router-http: " + format % args)

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code == 503:
            # tell clients when to come back
            self.send_header("Retry-After", RETRY_AFTER_S)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        engine = self.server.engine
        if self.path == "/healthz":
            self._send_json(200, {"live": True})
        elif self.path == "/readyz":
            ready = engine.ready()
            self._send_json(200 if ready else 503,
                            {"ready": ready, "routable": len(engine.view.balance_set())})
        elif self.path == "/stats":
            self._send_json(200, engine.stats())
        elif self.path == "/metrics":
            body = prometheus.render_router(engine).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", prometheus.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/v1/infer":
            # the body stays unread: close rather than desync keep-alive
            self.close_connection = True
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        server = self.server
        try:
            body = read_bounded_body(self, max_body_bytes=server.max_body_bytes,
                                     read_timeout_s=server.read_timeout_s)
            payload = json.loads(body.decode("utf-8"))
            if not isinstance(payload, dict):
                raise ValueError("request body must be a JSON object")
            raw_deadline = payload.get("deadline_ms")
            deadline_ms = min(
                float(server.default_deadline_ms if raw_deadline is None else raw_deadline),
                server.max_deadline_ms,
            )
        except SlowClientError as err:
            self.close_connection = True
            self._send_json(408, {"status": "shed", "reason": "slow-client",
                                  "detail": str(err)})
            return
        except (TypeError, ValueError, KeyError) as err:
            self._send_json(400, {"status": "error", "reason": str(err)})
            return
        code, body = server.engine.handle_infer(payload, Deadline(deadline_ms / 1000.0))
        self._send_json(code, body)


def bind_router(host: str, port: int, engine, **kw) -> RouterHTTPServer:
    """Bind (OSError -> the CLI's exit 75).  ``port=0`` picks an ephemeral
    port; the bound address is logged on the ``ROUTER listening`` line."""
    server = RouterHTTPServer((host, port), engine, **kw)
    logger.info(
        f"ROUTER listening on http://{server.server_address[0]}:"
        f"{server.server_address[1]} (/healthz /readyz /stats /metrics /v1/infer)"
    )
    return server
