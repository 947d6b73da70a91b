"""HTTP transport: liveness/readiness probes + the inference endpoint
(counterpart of ``unicore_tpu/serve/http.py``).

Thin by design — every serving decision (shed, deadline, batching) lives
in the engine/admission layer; this module only maps outcomes onto HTTP:

* ``GET /healthz``  → 200 while the process lives (liveness);
* ``GET /readyz``   → 200 only when the engine is warmed and not draining;
* ``GET /stats``    → JSON counters, latency percentiles, kernel launches;
* ``GET /metrics``  → Prometheus text exposition of the same counters
  (``telemetry/prometheus.py``, the JAX package's metric names);
* ``POST /v1/infer`` → ``{"tokens": [...], "deadline_ms": N, "id": "..."}``
  → 200 ok / 429 shed (named reason) / 400 too long or malformed /
  503 not-ready-or-draining / 504 expired / 408 slow client;
* ``POST /v1/generate`` → the same envelope plus an optional
  ``max_new_tokens`` (anything ``int()`` takes that comes out positive, as
  the JAX server takes it; else 400) → the generated ids,
  on an engine that declares ``supports_generate`` (``serve/decode.py``);
  404 on any other engine.  ``/v1/infer`` on a decode engine generates
  with the engine's default budget;
* ``POST /v1/reload`` → run this server's own verify→probe→swap on its
  served checkpoint now and answer the named outcome (200), 409 while
  another one is in flight; 404 unless a reloader is set (as in the JAX
  server, only a fleet replica sets one: the router's rolling reload).

Every 503 carries ``Retry-After``.  The body read is deadline-bounded (a
client that trickles its request, chaos ``slow-client``, gets a 408 with
the named reason instead of wedging a worker), the response wait goes
through ``utils/retry.bounded_wait``, and each connection carries a socket
timeout as the OS-level backstop.
"""

import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from unicore_tpu_torch import telemetry
from unicore_tpu_torch.distributed import chaos
from unicore_tpu_torch.serve import request as rq
from unicore_tpu_torch.serve.engine import PHASE_DRAINING, PHASE_STOPPED
from unicore_tpu_torch.telemetry import prometheus
from unicore_tpu_torch.utils import retry

logger = logging.getLogger(__name__)

#: shed reason → HTTP code: "try another replica" maps to 503, capacity
#: sheds to 429
_SHED_CODES = {
    rq.SHED_QUEUE_FULL: 429,
    rq.SHED_DEADLINE_UNMEETABLE: 429,
    rq.SHED_TOO_LONG: 400,
    rq.SHED_DRAINING: 503,
    rq.SHED_NOT_READY: 503,
    rq.SHED_CACHE_OOM: 429,
}


class ServeHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, engine, *, read_timeout_s: float = 10.0,
                 max_body_bytes: int = 1 << 20,
                 default_deadline_ms: float = 1000.0,
                 max_deadline_ms: float = 60000.0,
                 reloader=None, reload_path: Optional[str] = None):
        self.engine = engine
        self.read_timeout_s = float(read_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.default_deadline_ms = float(default_deadline_ms)
        self.max_deadline_ms = float(max_deadline_ms)
        #: POST /v1/reload runs this reloader on reload_path, one at a time
        #: (the lock: a second request mid-reload answers 409)
        self.reloader = reloader
        self.reload_path = reload_path
        self.reload_lock = threading.Lock()
        super().__init__(addr, ServeHandler)

    def start(self) -> threading.Thread:
        t = threading.Thread(
            target=self.serve_forever, name="serve-http", daemon=True
        )
        t.start()
        return t


class SlowClientError(RuntimeError):
    """The request body did not arrive within the read budget."""


def read_bounded_body(handler, *, max_body_bytes: int,
                      read_timeout_s: float) -> bytes:
    """Content-Length-framed body read under ONE deadline across chunked
    reads (a per-recv socket timeout alone resets on every trickled byte).

    Raises ``ValueError`` for framing errors (callers map to 400) and
    :class:`SlowClientError` when the budget expires (callers map to
    408); both leave the connection marked for close."""
    length = int(handler.headers.get("Content-Length") or 0)
    if length <= 0:
        handler.close_connection = True
        raise ValueError("missing/empty body (Content-Length required)")
    if length > max_body_bytes:
        handler.close_connection = True
        raise ValueError(
            f"body of {length} bytes exceeds the "
            f"{max_body_bytes}-byte limit"
        )
    deadline = time.monotonic() + read_timeout_s
    buf = bytearray()
    try:
        while len(buf) < length:
            left = deadline - time.monotonic()
            if left <= 0:
                raise SlowClientError(
                    f"body incomplete ({len(buf)}/{length} bytes) after "
                    f"{read_timeout_s:g}s"
                )
            handler.connection.settimeout(min(left, read_timeout_s))
            chunk = handler.rfile.read1(length - len(buf))
            if not chunk:
                raise ValueError(
                    f"client closed mid-body ({len(buf)}/{length} bytes)"
                )
            buf.extend(chunk)
    except socket.timeout as err:
        raise SlowClientError(
            f"socket read timed out after {read_timeout_s:g}s"
        ) from err
    finally:
        handler.connection.settimeout(read_timeout_s)
    return bytes(buf)


class ServeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def setup(self):
        super().setup()
        self.connection.settimeout(self.server.read_timeout_s)

    # stdlib logs one stderr line per request: route to debug
    def log_message(self, format, *args):
        logger.debug("http: " + format % args)

    def _send_json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code == 503:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    # -- probes ----------------------------------------------------------

    def do_GET(self):
        engine = self.server.engine
        if self.path == "/healthz":
            self._send_json(200, {"live": True, "phase": engine.phase})
        elif self.path == "/readyz":
            ready = engine.ready()
            self._send_json(
                200 if ready else 503,
                {"ready": ready, "phase": engine.phase},
            )
        elif self.path == "/stats":
            self._send_json(200, engine.stats())
        elif self.path == "/metrics":
            body = prometheus.render_engine(engine).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", prometheus.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    # -- inference -------------------------------------------------------

    def _read_body(self) -> bytes:
        # chaos 'slow-client': the bytes "arrive" only after the injected
        # stall; the bounded wait must 408 a stall longer than the read
        # budget instead of blocking a worker for its length
        stall = chaos.take_slow_client_delay()
        if stall > 0:
            arrive_at = time.monotonic() + stall
            try:
                retry.bounded_wait(
                    lambda: time.monotonic() >= arrive_at,
                    timeout=self.server.read_timeout_s,
                    poll_s=0.05,
                    describe="request body read (slow client)",
                )
            except retry.WaitTimeoutError as err:
                raise SlowClientError(str(err)) from None
        return read_bounded_body(
            self,
            max_body_bytes=self.server.max_body_bytes,
            read_timeout_s=self.server.read_timeout_s,
        )

    def _parse_infer(self):
        """(tokens, deadline_ms, id, max_new_tokens) from the body;
        ValueError/KeyError for anything malformed."""
        server = self.server
        body = self._read_body()
        payload = json.loads(body.decode("utf-8"))
        tokens = payload["tokens"]
        if not isinstance(tokens, list) or not tokens:
            raise ValueError("'tokens' must be a non-empty list of ids")
        try:
            tokens = np.asarray(tokens, dtype=np.int32)
        except (TypeError, ValueError, OverflowError) as err:
            raise ValueError(
                f"'tokens' must be a flat list of int32 ids ({err})"
            ) from None
        if tokens.ndim != 1:
            raise ValueError("'tokens' must be a FLAT list of ids")
        # explicit None check: a client deadline of 0 means "already
        # expired", not "use the default"
        raw_deadline = payload.get("deadline_ms")
        try:
            deadline_ms = min(
                float(
                    server.default_deadline_ms
                    if raw_deadline is None
                    else raw_deadline
                ),
                server.max_deadline_ms,
            )
        except (TypeError, ValueError):
            raise ValueError(
                f"'deadline_ms' must be a number, got {raw_deadline!r}"
            ) from None
        max_new = payload.get("max_new_tokens")
        # the JAX server's rule: whatever int() takes ("16", 2.5, true),
        # then positive
        if max_new is not None:
            try:
                max_new = int(max_new)
            except (TypeError, ValueError):
                raise ValueError(
                    f"'max_new_tokens' must be an integer, got {max_new!r}"
                ) from None
            if max_new <= 0:
                raise ValueError("'max_new_tokens' must be positive")
        return tokens, deadline_ms, payload.get("id"), max_new

    def do_POST(self):
        if self.path == "/v1/reload":
            self._handle_reload()
            return
        if self.path not in ("/v1/infer", "/v1/generate"):
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        engine = self.server.engine
        generate = self.path == "/v1/generate"
        if generate and not getattr(engine, "supports_generate", False):
            # the body stays unread: close rather than desync keep-alive
            self.close_connection = True
            self._send_json(
                404,
                {"error": "this engine does not generate (serve a "
                          "decoder-only checkpoint, e.g. transformer_lm)"},
            )
            return
        # chaos 'replica-stall': wedge the inference plane while the lease
        # keeps beating (the zombie replica).  The wait is sliced, so a
        # closed window or a drain releases the worker.
        if chaos.replica_stall_active():
            logger.warning(
                "chaos: replica-stall — /v1/infer handler WEDGED (lease stays "
                "healthy; the router's deadline-bounded proxy leg must shed "
                "around this replica)"
            )
            while (chaos.replica_stall_active()
                   and engine.phase not in (PHASE_DRAINING, PHASE_STOPPED)):
                time.sleep(0.1)
        try:
            tokens, deadline_ms, request_id, max_new = self._parse_infer()
            if generate:
                req = engine.submit(tokens, deadline_ms / 1000.0, request_id,
                                    max_new_tokens=max_new)
            else:
                req = engine.submit(tokens, deadline_ms / 1000.0, request_id)
        except SlowClientError as err:
            # leftover body bytes would desync the keep-alive stream
            self.close_connection = True
            logger.warning(f"SHED request: slow-client ({err})")
            telemetry.emit("serve-shed", reason="slow-client", message=str(err))
            self._send_json(
                408, {"status": rq.STATUS_SHED, "reason": "slow-client"}
            )
            return
        except (ValueError, KeyError, json.JSONDecodeError) as err:
            self._send_json(400, {"status": "error", "reason": str(err)})
            return
        try:
            # the engine resolves every admitted request by its deadline,
            # so the grace only covers scheduling slop
            retry.bounded_wait(
                req.done,
                timeout=deadline_ms / 1000.0 + 2.0,
                poll_s=0.01,
                describe=f"response for {req.request_id}",
            )
        except retry.WaitTimeoutError:
            self._send_json(
                504,
                {
                    "id": req.request_id,
                    "status": rq.STATUS_EXPIRED,
                    "reason": "response-timeout",
                },
            )
            return
        resp = req.response
        if resp.status == rq.STATUS_OK:
            code = 200
        elif resp.status == rq.STATUS_EXPIRED:
            code = 504
        elif resp.status == rq.STATUS_SHED:
            code = _SHED_CODES.get(resp.reason, 429)
        else:
            code = 500
        self._send_json(code, resp.to_json())

    # -- reload on request -----------------------------------------------

    def _handle_reload(self):
        """One synchronous verify→probe→swap on this server's own
        checkpoint, answered with the named outcome."""
        server = self.server
        if server.reloader is None or server.reload_path is None:
            # the body stays unread: close rather than desync keep-alive
            self.close_connection = True
            self._send_json(
                404, {"error": "this server is not reloadable on request "
                               "(only a fleet replica is: --advertise)"},
            )
            return
        try:
            # the body is advisory (the server reloads its OWN path); read
            # it to keep the connection in sync
            self._read_body()
        except (SlowClientError, ValueError):
            self.close_connection = True
        if not server.reload_lock.acquire(blocking=False):
            self._send_json(
                409, {"outcome": "reload-in-progress",
                      "error": "another reload is mid-flight"},
            )
            return
        try:
            outcome = server.reloader.consider(server.reload_path)
        except Exception as err:  # the reload plane answers, never raises
            logger.exception("reload request failed")
            self._send_json(
                500, {"outcome": "error", "error": f"{type(err).__name__}: {err}"},
            )
            return
        finally:
            server.reload_lock.release()
        self._send_json(200, {"outcome": outcome})


def bind_server(host: str, port: int, engine, **kw) -> ServeHTTPServer:
    """Bind (raises OSError on an unbindable host/port — the CLI maps it
    to exit 75).  ``port=0`` picks an ephemeral port; the bound address is
    logged either way."""
    server = ServeHTTPServer((host, port), engine, **kw)
    logger.info(
        f"SERVE listening on http://{server.server_address[0]}:"
        f"{server.server_address[1]} (/healthz /readyz /stats /metrics /v1/infer"
        f"{' /v1/generate' if getattr(engine, 'supports_generate', False) else ''})"
    )
    return server
