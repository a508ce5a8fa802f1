"""The webhook HTTP servers of the port.

Behavior parity with the JAX package's server/http.py (itself the
reference's internal/server/server.go + health.go), for two entry points:

  * a webhook server (TLS unless insecure; default 127.0.0.1:10288)
    serving ``POST /v1/authorize``: SubjectAccessReview -> decision. A body
    that does not decode answers NoOpinion with an evaluationError; an
    evaluation that fails or outlives the request deadline answers
    NoOpinion with an evaluationError too;
  * and, when an admission handler is wired, ``POST /v1/admit``:
    AdmissionReview -> allowed / denied (a ValidatingWebhook). A body that
    does not decode answers ``allowed: false`` with the parse error; an
    evaluation that fails or outlives the deadline answers the admission
    fail-mode (``admission_fail_open``: allowed or denied, with the error).
    Every errored answer carries status code 500, as in the JAX package.
    Any other path answers 404;
  * per-request metrics of /v1/authorize: the decision-labelled counter
    and latency histogram, with ``<error>`` as the label on errors;
  * a plain-HTTP health and metrics server (default 127.0.0.1:10289):
    ``/healthz``, ``/readyz`` (503 while draining or before every store's
    initial load), ``/metrics`` and ``/debug/engine``.

Requests reach the device through each path's micro-batcher
(engine/batcher.py, pipelined when ``pipeline_depth`` > 0) in front of its
fast path: concurrent single requests coalesce into one batch and one
launch. Without a fast path (``--backend interpreter``, or
``--no-native``) the request thread answers through the authorizer, and
admission reviews through the handler (batched over the engine when the
handler has a batched backend). A failed batch is never re-run on another
path: its requests answer the error. The server starts the policy
reloader (cli/webhook.py TorchReloader) with its listeners; stop() stops
it and the stores' reload tickers.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..engine.batcher import DeadlineExceeded, MicroBatcher, PipelinedBatcher
from ..entities.admission import AdmissionRequest, review_request_uid
from .admission import AdmissionResponse, CedarAdmissionHandler
from .authorizer import (
    DECISION_ALLOW,
    DECISION_DENY,
    DECISION_NO_OPINION,
    CedarWebhookAuthorizer,
)
from .metrics import WebhookMetrics
from .sar import get_authorizer_attributes, sar_response

log = logging.getLogger(__name__)

DEFAULT_ADDRESS = "127.0.0.1"
DEFAULT_PORT = 10288
METRICS_PORT = 10289
# accepted POST body cap: the apiserver caps its own request payloads at
# about 3 MiB, so 8 MiB leaves headroom while bounding hostile bodies
MAX_BODY_BYTES = 8 * 1024 * 1024

_DECISION_LABEL = {
    DECISION_ALLOW: "Allow",
    DECISION_DENY: "Deny",
    DECISION_NO_OPINION: "NoOpinion",
}


def _loads_or_none(body: bytes):
    """The decoded review for a best-effort uid, or None."""
    try:
        return json.loads(body)
    except Exception:  # noqa: BLE001 — the uid is best-effort here
        return None


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # listen backlog: concurrent clients connect in bursts, and the
    # standard library's 5 resets the connections past it
    request_queue_size = 1024


def _engine_doc(engine) -> dict:
    """The engine's /debug/engine entry: load generation, the loaded
    set's shape, staging and the kernels' launch counts (engine.stats),
    and the interpreter-fallback policies the plane carries."""
    doc = {"load_generation": engine.load_generation, **engine.stats}
    cs = engine.compiled_set
    packed = cs.packed if cs is not None else None
    if packed is not None:
        by_code: dict = {}
        for fp in packed.fallback:
            code = getattr(fp, "code", "unlowerable") or "unlowerable"
            by_code[code] = by_code.get(code, 0) + 1
        doc["fallback"] = {"policies": len(packed.fallback), "codes": dict(sorted(by_code.items()))}
    return doc


class WebhookServer:
    """Owns the webhook server, the health/metrics server and the two
    paths' batchers."""

    def __init__(
        self,
        authorizer: CedarWebhookAuthorizer,
        address: str = DEFAULT_ADDRESS,
        port: int = DEFAULT_PORT,
        metrics_port: int = METRICS_PORT,
        certfile: Optional[str] = None,
        keyfile: Optional[str] = None,
        fastpath=None,
        batch_window_s: float = 0.0002,
        max_batch: int = 8192,
        request_timeout_s: Optional[float] = None,
        drain_grace_s: float = 0.0,
        pipeline_depth: int = 0,
        encode_workers: int = 2,
        admission_handler: Optional[CedarAdmissionHandler] = None,
        admission_fastpath=None,
        admission_fail_open: Optional[bool] = None,
        metrics: Optional[WebhookMetrics] = None,
        reloader=None,
    ):
        self.authorizer = authorizer
        self.metrics = metrics or WebhookMetrics()
        # recompiles the engines when the stores change (cli/webhook.py
        # TorchReloader): started with the listeners, stopped with them
        self.reloader = reloader

        def eval_batcher(fast, serial_fn, path):
            """pipeline_depth > 0: the three-stage PipelinedBatcher over
            the fast path (encode of batch N+1 overlaps the device work of
            batch N); 0: the serial MicroBatcher over serial_fn. Both give
            the same answers."""
            self.metrics.add_fastpath(path, fast)
            if pipeline_depth > 0:
                return PipelinedBatcher(
                    fast,
                    max_batch=max_batch,
                    window_s=batch_window_s,
                    depth=pipeline_depth,
                    encode_workers=encode_workers,
                    metrics=self.metrics,
                    metrics_path=path,
                )
            return MicroBatcher(
                serial_fn,
                max_batch=max_batch,
                window_s=batch_window_s,
                metrics=self.metrics,
                metrics_path=path,
            )

        # the native SAR fast path (engine/fastpath.py): request threads
        # funnel raw bodies through the batcher into the C++ encoder and
        # the device match
        self.fastpath = fastpath
        self._batcher = None
        if fastpath is not None:
            self._batcher = eval_batcher(fastpath, fastpath.authorize_raw, "authorization")
        # the admission path: raw AdmissionReview bodies through the native
        # admission fast path's batcher; without one, parsed requests
        # micro-batch into the handler when it has a batched backend (one
        # engine call per batch), else each request thread asks the handler
        self.admission_handler = admission_handler
        self.admission_fastpath = admission_fastpath
        self._adm_raw_batcher = None
        self._admission_batcher = None
        if admission_fastpath is not None:
            self._adm_raw_batcher = eval_batcher(
                admission_fastpath, admission_fastpath.handle_raw, "admission"
            )
        elif admission_handler is not None and admission_handler.supports_batch:
            self._admission_batcher = MicroBatcher(
                functools.partial(admission_handler.handle_batch, raise_errors=True),
                max_batch=max_batch,
                window_s=batch_window_s,
                metrics=self.metrics,
                metrics_path="admission",
            )
        # the /v1/admit answer when an evaluation fails or outlives its
        # deadline: allowed (fail-open, the reference's allowOnError=true)
        # or denied; defaults to the handler's allow_on_error
        if admission_fail_open is None:
            admission_fail_open = bool(getattr(admission_handler, "allow_on_error", True))
        self.admission_fail_open = admission_fail_open
        self.address = address
        self.port = port
        self.metrics_port = metrics_port
        self.certfile = certfile
        self.keyfile = keyfile
        # per-request deadline budget (None disables): an evaluation that
        # outlives it answers NoOpinion (/v1/authorize) or the admission
        # fail-mode (/v1/admit) instead of holding the apiserver
        self.request_timeout_s = request_timeout_s
        self.drain_grace_s = drain_grace_s
        self._draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._httpd: Optional[_HTTPServer] = None
        self._metrics_httpd: Optional[_HTTPServer] = None

    # ------------------------------------------------------------- handlers

    def ready(self) -> bool:
        """The /readyz verdict: not draining, and every policy store's
        initial load complete."""
        if self._draining:
            return False
        try:
            return self.authorizer.ready()
        except Exception:  # noqa: BLE001 — a raising store reads as unready
            log.exception("readiness check failed")
            return False

    def handle_authorize(self, body: bytes) -> dict:
        """One SubjectAccessReview body -> the SubjectAccessReview response
        document, with the request metrics and the log line."""
        start = time.monotonic()
        request_id = os.urandom(16).hex()
        decision, reason, error = DECISION_NO_OPINION, "", None
        try:
            decision, reason, error = self._authorize(body, request_id, start)
            return sar_response(decision, reason, error)
        finally:
            label = "<error>" if error else _DECISION_LABEL[decision]
            latency = time.monotonic() - start
            self.metrics.record_request(label, latency)
            log.info(
                "authorize requestId=%s decision=%s latency=%.6fs", request_id, label, latency
            )

    def _authorize(self, body: bytes, request_id: str, start: float):
        """(decision, reason, error) through the fast path's batcher, or,
        without a fast path, through the authorizer in this thread. The
        batcher gets what remains of the request's budget since ``start``."""
        if self._batcher is not None:
            timeout = None
            if self.request_timeout_s is not None:
                timeout = self.request_timeout_s - (time.monotonic() - start)
            try:
                return self._batcher.submit(body, timeout=timeout)
            except DeadlineExceeded as e:
                self.metrics.record_deadline_exceeded("authorization")
                return DECISION_NO_OPINION, "", f"evaluation error: {e}"
            except Exception as e:  # noqa: BLE001 — always answer the apiserver
                log.exception("fastpath authorize requestId=%s failed", request_id)
                return DECISION_NO_OPINION, "", f"evaluation error: {e}"
        try:
            sar = json.loads(body)
        except (ValueError, TypeError, RecursionError) as e:
            return (
                DECISION_NO_OPINION,
                "Encountered decoding error",
                f"failed parsing request body: {e}",
            )
        try:
            decision, reason = self.authorizer.authorize(get_authorizer_attributes(sar))
        except Exception as e:  # noqa: BLE001 — always answer the apiserver
            log.exception("authorize requestId=%s failed", request_id)
            return DECISION_NO_OPINION, "", f"evaluation error: {e}"
        return decision, reason, None

    def handle_admit(self, body: bytes) -> dict:
        """One AdmissionReview body -> the AdmissionReview response
        document, with the log line (the request metrics count
        /v1/authorize only, as in the JAX package)."""
        start = time.monotonic()
        request_id = os.urandom(16).hex()
        doc = self._handle_admit(body, start)
        resp = doc["response"]
        log.info(
            "admit requestId=%s allowed=%s code=%d latency=%.6fs",
            request_id, resp["allowed"], resp["status"]["code"], time.monotonic() - start,
        )
        return doc

    def _handle_admit(self, body: bytes, start: float) -> dict:
        """The response document through the admission fast path's
        batcher, or, without one, through the handler (its batcher when
        it has one). Every batcher gets what remains of the request's
        budget since ``start``. A failure answers the fail-mode; nothing
        re-runs the request on another path."""

        def remaining():
            if self.request_timeout_s is None:
                return None
            return self.request_timeout_s - (time.monotonic() - start)

        if self._adm_raw_batcher is not None:
            try:
                return self._adm_raw_batcher.submit(body, timeout=remaining()).to_admission_review()
            except DeadlineExceeded as e:
                return self._admission_deadline(body, e)
            except Exception as e:  # noqa: BLE001 — always answer the apiserver
                log.exception("admission fastpath failed")
                return self._admission_fail_mode(_loads_or_none(body), e)
        try:
            review = json.loads(body)
        except (ValueError, TypeError, RecursionError) as e:
            return AdmissionResponse(
                uid="", allowed=False, code=400, error=f"failed parsing body: {e}"
            ).to_admission_review()
        try:
            req = AdmissionRequest.from_admission_review(review)
            if self._admission_batcher is not None:
                return self._admission_batcher.submit(
                    req, timeout=remaining()
                ).to_admission_review()
            return self.admission_handler.handle(req, raise_errors=True).to_admission_review()
        except DeadlineExceeded as e:
            self.metrics.record_deadline_exceeded("admission")
            return self._admission_fail_mode(review, e)
        except Exception as e:  # noqa: BLE001 — fail-open like the reference
            # allow-on-error posture (reference
            # internal/server/admission/handler.go:90-104 with
            # allowOnError=true): a conversion or evaluation crash must
            # not block the cluster's write path unless configured closed
            log.exception("admit failed")
            return self._admission_fail_mode(review, e)

    def _admission_fail_mode(self, review, e) -> dict:
        """The configured fail-open/fail-closed answer for a review whose
        evaluation crashed or ran out of deadline budget: allowed or
        denied, code 500, the error as the message."""
        uid = review_request_uid(review) if review is not None else ""
        allowed = self.admission_fail_open
        return AdmissionResponse(
            uid=uid,
            allowed=allowed,
            code=200,
            error=f"evaluation error ({'allowed' if allowed else 'denied'} on error): {e}",
        ).to_admission_review()

    def _admission_deadline(self, body: bytes, e) -> dict:
        self.metrics.record_deadline_exceeded("admission")
        return self._admission_fail_mode(_loads_or_none(body), e)

    def debug_engine(self) -> dict:
        """The /debug/engine document: per path with a fast path
        (``authorization``, ``admission``), the batcher's pipeline
        snapshot and the engine's entry; {} without a fast path."""
        doc = {}
        for path, batcher, fast in (
            ("authorization", self._batcher, self.fastpath),
            ("admission", self._adm_raw_batcher, self.admission_fastpath),
        ):
            if batcher is not None:
                doc[path] = {"pipeline": batcher.debug_stats(), "engine": _engine_doc(fast.engine)}
        return doc

    def _make_handler(server):  # noqa: N805 — bound as a class closure
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _write_json(self, doc: dict, code: int = 200):
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                # the drain check and the in-flight increment are one
                # atomic step: once stop() sets _draining and sees no
                # request in flight under this lock, no request can slip
                # past the check and reach a batcher stop() has joined
                path = self.path.partition("?")[0]
                with server._inflight_cv:
                    draining = server._draining
                    if not draining:
                        server._inflight += 1
                if draining:
                    server.metrics.record_shed(
                        "admission" if path == "/v1/admit" else "authorization"
                    )
                    self.send_error(503, "server is draining")
                    return
                try:
                    try:
                        length = int(self.headers.get("Content-Length") or 0)
                    except ValueError:
                        self.send_error(400, "bad Content-Length")
                        return
                    if length < 0 or length > MAX_BODY_BYTES:
                        self.send_error(413, "request body too large")
                        return
                    body = self.rfile.read(length) if length else b""
                    if path == "/v1/authorize":
                        self._write_json(server.handle_authorize(body))
                    elif path == "/v1/admit" and server.admission_handler is not None:
                        self._write_json(server.handle_admit(body))
                    else:
                        self.send_error(404)
                finally:
                    with server._inflight_cv:
                        server._inflight -= 1
                        server._inflight_cv.notify_all()

            def do_GET(self):
                self.send_error(404)

        return Handler

    def _make_metrics_handler(server):  # noqa: N805
        class MetricsHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _send(self, data: bytes, content_type: str, code: int = 200):
                self.send_response(code)
                if data:
                    self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if data:
                    self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(b"", "")
                elif self.path == "/readyz":
                    self._send(b"", "", 200 if server.ready() else 503)
                elif self.path == "/metrics":
                    self._send(server.metrics.expose().encode(), "text/plain; version=0.0.4")
                elif self.path == "/debug/engine":
                    try:
                        doc = server.debug_engine()
                    except Exception:  # noqa: BLE001 — debug must not 500
                        log.exception("engine stats failed")
                        doc = {"error": "engine stats failed"}
                    self._send(json.dumps(doc).encode(), "application/json")
                else:
                    self.send_error(404)

        return MetricsHandler

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Start both servers on background threads."""
        self._httpd = _HTTPServer((self.address, self.port), self._make_handler())
        if self.certfile and self.keyfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.certfile, self.keyfile)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True)
        threading.Thread(
            target=self._httpd.serve_forever, name="webhook-server", daemon=True
        ).start()
        self._metrics_httpd = _HTTPServer(
            (self.address, self.metrics_port), self._make_metrics_handler()
        )
        threading.Thread(
            target=self._metrics_httpd.serve_forever, name="metrics-server", daemon=True
        ).start()
        if self.reloader is not None:
            self.reloader.start()
        log.info(
            "serving on %s://%s:%d (metrics http://%s:%d)",
            "https" if self.certfile else "http",
            self.address,
            self.bound_port,
            self.address,
            self.bound_metrics_port,
        )

    def begin_drain(self) -> None:
        """Flip into draining: /readyz answers 503, new POSTs are shed
        with 503, in-flight requests finish."""
        with self._inflight_cv:
            self._draining = True

    def stop(self, drain_grace_s: Optional[float] = None) -> None:
        """Graceful shutdown: drain, wait up to the grace period for
        in-flight requests, stop the listeners, then drain and join the
        batcher (every accepted request still gets its answer)."""
        grace = self.drain_grace_s if drain_grace_s is None else drain_grace_s
        self.begin_drain()
        deadline = time.monotonic() + grace
        with self._inflight_cv:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.warning(
                        "drain grace elapsed with %d request(s) in flight", self._inflight
                    )
                    break
                self._inflight_cv.wait(timeout=remaining)
        for httpd in (self._httpd, self._metrics_httpd):
            if httpd is not None:
                httpd.shutdown()
                httpd.server_close()
        self._httpd = None
        self._metrics_httpd = None
        if self.reloader is not None:
            self.reloader.stop()
        self.stop_batchers()
        self.close_stores()

    def close_stores(self) -> None:
        """Stop the reload tickers of both paths' stores."""
        stacks = [self.authorizer.stores]
        if self.admission_handler is not None:
            stacks.append(self.admission_handler.stores)
        for stores in stacks:
            for store in stores:
                close = getattr(store, "close", None)
                if close is not None:
                    close()

    def stop_batchers(self) -> None:
        """Drain and stop the batchers without touching the listeners (for
        a server used as a serving core without start())."""
        for batcher in (self._batcher, self._adm_raw_batcher, self._admission_batcher):
            if batcher is not None:
                batcher.stop()

    @property
    def bound_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def bound_metrics_port(self) -> Optional[int]:
        return self._metrics_httpd.server_address[1] if self._metrics_httpd else None
