"""The PDP listener: a stdlib HTTP front end for ext_authz and batch (a
copy of the JAX package's pdp/listener.py).

One ThreadingHTTPServer (HTTP/1.1, no new dependency) bound by
``--pdp-listen``, set up as the port's webhook listener is (a listen
backlog of 1024, Nagle's algorithm off):

- ``POST /v1/batch-authorize`` is the AVP-style batch API;
- EVERY other request is an Envoy ext_authz check of its own method,
  path and headers (HTTP-service mode: Envoy forwards the original
  request, optionally under a path prefix).

The listener owns no evaluation machinery. Each mapped body goes to the
bound WebhookServer's ``serve_authorize``, the same gated entry the
webhook's do_POST runs, so PDP traffic shares the admission gate, the
decision cache, the batcher's claims, audit, traces and metrics with SAR
traffic, and coalesces with it into single card launches. In-process
callers (tests, chip_smoke.py) may call ``check()`` / ``batch()``
directly.
"""

from __future__ import annotations

import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler
from typing import Optional, Tuple

from .batch import handle_batch
from .config import PdpConfig
from .extauthz import check_body, render_check_response, render_malformed
from .mapper import PdpMappingError

log = logging.getLogger(__name__)

BATCH_PATH = "/v1/batch-authorize"


class PdpListener:
    def __init__(
        self,
        config: Optional[PdpConfig] = None,
        address: str = "127.0.0.1",
        port: int = 0,
        max_workers: int = 16,
    ):
        self.config = config or PdpConfig()
        self.address = address
        self.port = port
        self._server = None  # the WebhookServer, set by bind()
        self._httpd = None
        # the batch fan-out's executor, shared across requests: the tuples
        # of one POST submit concurrently so they share batcher claims;
        # bounded, so one hostile batch cannot multiply threads
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(max_workers)), thread_name_prefix="pdp-batch"
        )

    def bind(self, server) -> None:
        """Attach the serving stack (WebhookServer calls this when it is
        built with ``pdp=``)."""
        self._server = server

    # ------------------------------------------------- in-process entries

    def check(self, method: str, path: str, headers: dict) -> Tuple[int, dict]:
        """One ext_authz check -> (http status, response document)."""
        try:
            body = check_body(method, path, headers, self.config)
        except PdpMappingError as e:
            return render_malformed(e)
        return render_check_response(self._serve(body), self.config)

    def batch(self, raw: bytes) -> Tuple[int, dict]:
        """One batch-authorize POST body -> (http status, response
        document)."""
        return handle_batch(self._serve, raw, self.config, self._pool)

    def _serve(self, body) -> dict:
        if self._server is None:
            raise RuntimeError("PdpListener is not bound to a server")
        return self._server.serve_authorize(body)

    # ------------------------------------------------------ HTTP lifecycle

    def start(self) -> None:
        from ..server.http import _HTTPServer

        self._httpd = _HTTPServer((self.address, self.port), self._make_handler())
        threading.Thread(
            target=self._httpd.serve_forever, name="pdp-server", daemon=True
        ).start()
        log.info(
            "pdp front end serving on http://%s:%d (ext_authz on every path, batch on %s)",
            self.address,
            self.bound_port,
            BATCH_PATH,
        )

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self._pool.shutdown(wait=True)

    @property
    def bound_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def _make_handler(self):
        listener = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # headers and body go out in two writes: with Nagle's
            # algorithm on, the body would wait for the client's delayed
            # ACK of the headers
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
                log.debug("pdp %s", fmt % args)

            def _reply(self, status: int, doc: dict) -> None:
                payload = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(payload)

            def _handle(self) -> None:
                try:
                    if self.command == "POST" and self.path.split("?", 1)[0] == BATCH_PATH:
                        from ..server.http import MAX_BODY_BYTES

                        length = int(self.headers.get("Content-Length") or 0)
                        if length > MAX_BODY_BYTES:
                            self._reply(413, {"error": "body too large"})
                            return
                        raw = self.rfile.read(length)
                        status, doc = listener.batch(raw)
                    else:
                        headers = {k.lower(): v for k, v in self.headers.items()}
                        status, doc = listener.check(self.command, self.path, headers)
                    self._reply(status, doc)
                except Exception:  # noqa: BLE001 — always answer the peer
                    log.exception("pdp request failed")
                    try:
                        self._reply(500, {"error": "internal error"})
                    except Exception:  # noqa: BLE001 — the peer went away
                        pass

            do_GET = _handle
            do_POST = _handle
            do_PUT = _handle
            do_PATCH = _handle
            do_DELETE = _handle
            do_HEAD = _handle
            do_OPTIONS = _handle

        return Handler


__all__ = ["BATCH_PATH", "PdpListener"]
