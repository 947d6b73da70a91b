"""HTTP transport: liveness/readiness probes + the inference endpoint
(counterpart of ``unicore_tpu/serve/http.py``).

Thin by design — every serving decision (shed, deadline, batching) lives
in the engine/admission layer; this module only maps outcomes onto HTTP:

* ``GET /healthz``  → 200 while the process lives (liveness);
* ``GET /readyz``   → 200 only when the engine is warmed and not draining;
* ``GET /stats``    → JSON counters, latency percentiles, kernel launches;
* ``POST /v1/infer`` → ``{"tokens": [...], "deadline_ms": N, "id": "..."}``
  → 200 ok / 429 shed (named reason) / 400 too long or malformed /
  503 not-ready-or-draining / 504 expired / 408 slow client;
* ``POST /v1/generate`` → the same envelope plus an optional
  ``max_new_tokens`` (anything ``int()`` takes that comes out positive, as
  the JAX server takes it; else 400) → the generated ids,
  on an engine that declares ``supports_generate`` (``serve/decode.py``);
  404 on any other engine.  ``/v1/infer`` on a decode engine generates
  with the engine's default budget.

Every 503 carries ``Retry-After``.  The body read is deadline-bounded (a
client that trickles its request gets a 408 instead of wedging a worker),
the response wait goes through ``utils/retry.bounded_wait``, and each
connection carries a socket timeout as the OS-level backstop.  The JAX
package's ``/metrics``, ``/v1/reload`` and chaos hooks are not ported yet.
"""

import json
import logging
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from unicore_tpu_torch.serve import request as rq
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
                 max_deadline_ms: float = 60000.0):
        self.engine = engine
        self.read_timeout_s = float(read_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.default_deadline_ms = float(default_deadline_ms)
        self.max_deadline_ms = float(max_deadline_ms)
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
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    # -- inference -------------------------------------------------------

    def _parse_infer(self):
        """(tokens, deadline_ms, id, max_new_tokens) from the body;
        ValueError/KeyError for anything malformed."""
        server = self.server
        body = read_bounded_body(
            self,
            max_body_bytes=server.max_body_bytes,
            read_timeout_s=server.read_timeout_s,
        )
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


def bind_server(host: str, port: int, engine, **kw) -> ServeHTTPServer:
    """Bind (raises OSError on an unbindable host/port — the CLI maps it
    to exit 75).  ``port=0`` picks an ephemeral port; the bound address is
    logged either way."""
    server = ServeHTTPServer((host, port), engine, **kw)
    logger.info(
        f"SERVE listening on http://{server.server_address[0]}:"
        f"{server.server_address[1]} (/healthz /readyz /stats /v1/infer"
        f"{' /v1/generate' if getattr(engine, 'supports_generate', False) else ''})"
    )
    return server
