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
    initial load), ``/metrics``, ``/debug/engine``, ``/debug/cache`` (the
    decision caches' stats per path), ``/debug/supervisor``
    (the watchdog's components, the device recoveries, the quarantine),
    ``/debug/chaos`` (the chaos registry), ``/debug/analysis`` (the
    last load-time analysis report per engine, when the server has an
    ``analysis_provider``), ``/debug/traces`` and ``/debug/traces/<id>``
    (the tracer's ring and one kept trace, prefixes accepted) and
    ``/debug/slo`` (the SLO tracker's burn rates); and the game-day control
    ``POST /chaos/{configure,arm,disarm,reset}``, which answers 403
    unless the server was built with ``chaos_control_enabled`` (the CLI's
    ``--confirm-non-prod-inject-errors``);
  * with a rollout controller (rollout/, ``rollout``): ``GET
    /debug/rollout`` (its status and diff report) and ``POST
    /rollout/{stage,promote,rollback}``, which answer 403 unless
    ``rollout_control_enabled`` and, when ``rollout_control_token`` is
    set, need ``Authorization: Bearer <token>``; a refused lifecycle step
    answers 409 with the error (and its detail). Every clean live answer
    of both endpoints (the real one, before the injector) is offered to
    the controller's shadow evaluator once the stores are ready: a
    sampling draw and a non-blocking enqueue that never raises into the
    request;
  * with a declarative lifecycle controller (lifecycle/, ``lifecycle``):
    ``GET /debug/lifecycle`` (its per-tenant status) and ``POST
    /lifecycle/approve`` with ``{"tenant": ...}`` (manual-promotion
    consent), behind the same 403 / bearer gate as ``/rollout/*``; an
    unknown tenant answers 409. stop() stops its reconcile loop before the
    rollout controller;
  * with ``enable_profiling`` (the CLI's ``--profiling``), on the webhook
    listener: ``GET /debug/pprof/profile`` samples every thread's stack
    every 10 ms for one second and answers the 50 most frequent stacks;
    any other ``/debug/pprof/*`` answers a dump of every thread's stack.
    Without it every GET there answers 404.

Requests reach the device through each path's micro-batcher
(engine/batcher.py, pipelined when ``pipeline_depth`` > 0) in front of its
fast path: concurrent single requests coalesce into one batch and one
launch. Without a fast path (``--backend interpreter``, or
``--no-native``) the request thread answers through the authorizer, and
admission reviews through the handler (batched over the engine when the
handler has a batched backend). A failed batch is never re-run on another
path: its requests answer the error.

A decision cache (cache/, ``decision_cache``) sits in front of both
/v1/authorize paths, as in the JAX server: the raw body maps to its
canonical fingerprint through a memo sized like the cache, and once every
store's initial load is complete (the ready latch) a hit answers without
touching the batcher, the breaker or the engine. A miss leads a
singleflight (cache/singleflight.py), so concurrent identical misses
evaluate once, and submits with the key as the batcher's
``coalesce_key``; its clean answer is stored under the serving plane's
generation snapshot taken before the evaluation, scoped to the shards of
the policies its reason names (cache/generation.py). An answer with an
error (a failed batch, a deadline, the breaker's posture, a body that
does not decode) is never cached, and a cache that raises is a miss that
goes on to the device path. ``/debug/cache`` on the metrics port serves
each cache's stats() per path (the admission handler's cache too).

Each fast path may sit behind a circuit breaker (engine/breaker.py). While
it is open a request answers the failure posture before it is submitted
(it neither queues nor launches): NoOpinion with the evaluationError
"evaluation error: device breaker open" on /v1/authorize, the admission
fail-mode (code 500) on /v1/admit; the JAX server re-runs it on the
interpreter instead. A deadline expiry whose batch held the request on
the device (not ``DeadlineExceeded.queued``) feeds the breaker: a hung
device never returns a batch to feed it otherwise. The ``response`` chaos
seam (chaos/registry.py) sees every clean /v1/authorize answer.

The observability plane (obs/) wraps both endpoints as in the JAX
server. do_POST records the body (server/recorder.py, when wired), takes
the request id from a W3C ``traceparent`` header (or makes a fresh one)
and answers it as ``X-Cedar-Trace-Id``, with a ``traceparent`` of its own
when a tracer is wired. The handlers open the request's trace
(``cache.lookup``, ``coalesce.wait`` and the batcher's ``batch.*`` spans
land in it; a deadline expiry is a ``deadline_exceeded`` event), feed the
SLO tracker the latency the request histogram observes, and append one
audit line (obs/audit.py) keyed by the canonical fingerprint the recorder
stamps into its file name. An answer made by the failure posture (an
open breaker, a failed batch) is marked ``fallback``, which the tracer
tail-keeps. A raising trace, SLO or audit hook is logged and never
changes an answer. /v1/authorize's clean answers then pass the artificial
error/deny injector (server/error_injector.py, after the cache, so an
injected answer is never cached) and the ``response`` chaos seam.

The overload-control plane (load/, ``load``) gates both endpoints as in
the JAX server. do_POST classifies each body after the drain check and
before the recorder and the trace (load.admit): a refused request answers
the honest shed with ``Retry-After`` (``render_shed``: NoOpinion with the
evaluationError "request shed under overload (<reason>); retry after
<n>s" on /v1/authorize, the admission fail-mode with code 500 on
/v1/admit) and is never recorded, traced or seen by an SLO ring; an
admitted one runs inside ``load.track(path, priority)`` until its answer
is written, so the in-flight count is the load signal. A cache miss meets
the evaluation-stage gate (load.check_eval) before the breaker and the
batcher: a RequestShed never feeds the breaker and is never cached, and a
follower coalesced behind a shed leader gets the same shed at once.
``serve_authorize`` / ``serve_admit`` run the same gate without HTTP.
With a plane wired, /readyz carries the load state in its body and the
``X-Cedar-Load-State`` header (``saturated`` answers 503), and
``/debug/load`` serves the controller's stats and the adaptive batch
tuners' status (``tuners``, appended by the CLI); without one, /readyz is
unchanged and /debug/load answers 404.

``?explain=1`` (explain/, as in the JAX server): do_POST splits the
query off the path and reads ``explain`` by the JAX rule (``0``,
``false`` and an empty value keep the bare path). An explain request
passes the ingress gate as ``sheddable`` (the first class shed under
pressure), is recorded and answers ``X-Cedar-Trace-Id``, then branches
before the tracer, the cache, the breaker check and the batcher: the
Explainer (built at the first explain request, from each path's fast
path or its authorizer's bound engine) answers it with the decision and
an ``explanation`` document. It counts on
``cedar_explain_requests_total{path}`` only: never on the serving
request counter and histogram, the SLO rings or the audit log, never
traced, never cached and never seen by the error injector.

A tenant front end (tenancy/ TenantResolver, ``tenancy``; the CLI's
``--tenant`` flags), as in the JAX server: do_POST resolves every POST's
tenant (path prefix ``/t/<id>/...``, which it strips, the tenant header,
the host map, the default) before the ingress gate, the recorder and the
cache, and wraps the body in a TenantBody, so every layer below sees the
stamp: the fast paths' discriminator column, the interpreter paths'
``context.tenantId``, the cache keys and stamps, the audit line's
``tenant`` and the trace root's ``tenant`` attribute. A request it cannot
attribute (``unknown``, ``missing``, ``conflict``) is refused before any
evaluation: NoOpinion with the evaluationError "tenant rejected: ..." on
/v1/authorize, a denied review (code 403) on /v1/admit, counted on
``cedar_tenant_rejected_total{reason}``. Every answer of a resolved tenant
counts on ``cedar_tenant_requests_total`` and
``cedar_tenant_request_duration_seconds``; ``GET /debug/tenancy`` on the
metrics listener serves the resolver's configuration and the registry's
per-tenant policy counts (404 without a front end).

A PDP front end (pdp/ PdpListener, ``pdp``; the CLI's ``--pdp-listen``),
as in the JAX server: its plain-HTTP listener maps each Envoy ext_authz
check and each batch-authorize tuple into a synthetic SAR body stamped
with its protocol (a PdpBody, and the configured tenant) and hands it to
``serve_authorize``. PDP bodies therefore bypass do_POST's tenant front end and
share the ingress gate (never classed high), the decision cache (keys
split by protocol), the batcher and the card launches with SAR traffic.
The protocol joins the trace root (``protocol``), the request families'
bounded ``protocol`` label, the audit line and, on the interpreter
paths, the attributes.

The server starts the policy reloader (cli/webhook.py TorchReloader), the
PDP listener and the supervisor (server/supervisor.py) with its
listeners; stop() stops the supervisor first, then the listeners (the
PDP's after the webhook's), the reloader, the tuners, the batchers and
the stores' reload tickers.
"""

from __future__ import annotations

import contextlib
import functools
import hmac
import json
import logging
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..chaos.registry import chaos_fire, default_registry
from ..chaos.scenario import ScenarioError, load_scenario
from ..engine.batcher import DeadlineExceeded, MicroBatcher, PipelinedBatcher
from ..engine.breaker import BreakerOpen
from ..entities.admission import AdmissionRequest, review_request_uid
from ..lang.values import EntityUID
from ..load.admission import STATE_SATURATED, RequestShed
from ..obs.audit import audit_entry
from ..obs.trace import (
    current_trace,
    format_traceparent,
    ingest_request_id,
    new_span_id,
    new_trace_id,
    set_current,
)
from ..obs.trace import span as trace_span
from ..schema.consts import AUTHORIZATION_ACTION_ENTITY_TYPE
from ..stores.quarantine import quarantine_registry
from ..tenancy.frontend import TenantBody
from .admission import AdmissionResponse, CedarAdmissionHandler
from .authorizer import (
    DECISION_ALLOW,
    DECISION_DENY,
    DECISION_NO_OPINION,
    CedarWebhookAuthorizer,
)
from .error_injector import ErrorInjector
from .metrics import (
    WebhookMetrics,
    fallback_decision_counts,
    record_audit_record,
    record_explain_request,
)
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


def _sar_action(body: bytes) -> Optional[str]:
    """The Cedar action uid of a SubjectAccessReview body as it renders
    (``k8s::Action::"get"``), the key a shard-scoped cache stamp checks
    added policies against (cache/generation.py); None when the body does
    not parse."""
    try:
        verb = get_authorizer_attributes(json.loads(body)).verb
    except Exception:  # noqa: BLE001 — None: the stamp dies at any change
        return None
    return repr(EntityUID(AUTHORIZATION_ACTION_ENTITY_TYPE, verb))


# per-request observation context: the serving layers report the cached
# and fallback facts UPWARD to the request handler's trace tail-keep and
# audit line without changing any layer's call contract; a thread-local,
# like the active trace, because a request owns its thread end to end
# (a singleflight leader runs in the requesting thread)
_obs_local = threading.local()


def _octx_set(ctx: Optional[dict]) -> None:
    _obs_local.ctx = ctx


def _octx_mark(key: str) -> None:
    ctx = getattr(_obs_local, "ctx", None)
    if ctx is not None:
        ctx[key] = True


def _trace_event(name: str) -> None:
    """A zero-duration marker on the calling thread's trace, if any."""
    tr = current_trace()
    if tr is not None:
        tr.event(name)


def _admit_outcome(review) -> tuple:
    """(label, error or None) of a rendered AdmissionReview: the decision
    facts read back out of the response the caller is already returning,
    so this can never change an answer."""
    resp = (review or {}).get("response") or {}
    status = resp.get("status") or {}
    error = (
        None
        if review is not None and status.get("code") in (None, 200)
        else (status.get("message") or "no response")
    )
    label = "<error>" if error else ("allowed" if resp.get("allowed") else "denied")
    return label, error


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
    the serving plane's shard lineage (``shards``: shard count and
    hashes, the last load's scope and dirty set), and the
    interpreter-fallback policies the plane carries with the served
    decisions they were merged into (the fallback burn-down:
    cedar_fallback_decisions_total{code} of this engine)."""
    doc = {
        "name": engine.name,
        "load_generation": engine.load_generation,
        **engine.stats,
        "shards": engine.shard_status(),
    }
    cs = engine.compiled_set
    packed = cs.packed if cs is not None else None
    if packed is not None:
        by_code: dict = {}
        for fp in packed.fallback:
            code = getattr(fp, "code", "unlowerable") or "unlowerable"
            by_code[code] = by_code.get(code, 0) + 1
        doc["fallback"] = {
            "policies": len(packed.fallback),
            "codes": dict(sorted(by_code.items())),
            "served_decisions": fallback_decision_counts(engine.name),
        }
    return doc


def _analysis_doc(doc: dict) -> dict:
    """/debug/analysis: the provider's per-engine reports ({engine name:
    AnalysisReport.to_dict()}), each coverage rollup joined with its own
    engine's served fallback tally (``served_decisions``), so one plane's
    fallback traffic never reads as another's burn-down signal."""
    return {
        engine: {**rep, "coverage": {**rep["coverage"],
                                     "served_decisions": fallback_decision_counts(engine)}}
        for engine, rep in doc.items()
    }


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
        supervisor=None,
        chaos_control_enabled: bool = False,
        analysis_provider=None,
        decision_cache=None,
        tracer=None,
        audit_log=None,
        slo=None,
        error_injector: Optional[ErrorInjector] = None,
        recorder=None,
        load=None,
        rollout=None,
        rollout_control_enabled: bool = True,
        rollout_control_token: Optional[str] = None,
        lifecycle=None,
        enable_profiling: bool = False,
        tenancy=None,
        pdp=None,
    ):
        self.authorizer = authorizer
        # the PDP front end (pdp/ PdpListener): Envoy ext_authz checks and
        # batch-authorize tuples mapped into serve_authorize; start() and
        # stop() bring its listener up and down with the webhook's
        self.pdp = pdp
        if pdp is not None:
            pdp.bind(self)
        # the tenant front end (tenancy/ TenantResolver): every POST
        # resolves a tenant before the gate and the cache, and the body
        # rides the stack as a TenantBody; an unattributable request is
        # refused before evaluation. None keeps the single-tenant path
        self.tenancy = tenancy
        # the declarative lifecycle controller (lifecycle/
        # LifecycleController): the metrics listener serves
        # /debug/lifecycle and POST /lifecycle/approve (behind the rollout
        # control gate); stop() stops its reconcile loop first
        self.lifecycle = lifecycle
        # GET /debug/pprof/* on the webhook listener (the CLI's
        # --profiling); 404 without it
        self.enable_profiling = enable_profiling
        # the shadow-rollout controller (rollout/ RolloutController): live
        # answers are offered to it, the metrics listener serves
        # /debug/rollout and the lifecycle POSTs. The POSTs answer 403
        # unless control is enabled (a staged allow-all and a promote take
        # over the cluster's authorization, and the metrics listener is
        # plain HTTP); with a token they need it as a bearer
        self.rollout = rollout
        self.rollout_control_enabled = rollout_control_enabled
        self.rollout_control_token = rollout_control_token
        # the overload-control plane (load/admission.py
        # AdmissionController): every POST is gated at ingress, before the
        # recorder and the trace; None keeps the gate-free path byte for
        # byte
        self.load = load
        # SLO-adaptive batch tuners (load/tuner.py), appended by the CLI
        # after construction: stopped with the server, their status on
        # /debug/load
        self.tuners: list = []
        # the /v1/authorize decision cache (cache/decision_cache.py), read
        # before the breaker and the batcher; None serves every request
        # from the engines
        self.decision_cache = decision_cache
        self._sar_memo = None
        self._sar_flights = None
        if decision_cache is not None:
            from ..cache import FingerprintMemo, SingleFlight

            # sized with the cache: a working set that fits the cache must
            # also fit the body -> fingerprint memo, or every hit pays a
            # JSON parse
            self._sar_memo = FingerprintMemo(capacity=decision_cache.max_entries)
            self._sar_flights = SingleFlight("authorization")
        # the last load-time analysis reports per engine (cli/webhook.py);
        # /debug/analysis answers 404 without one
        self.analysis_provider = analysis_provider
        self.metrics = metrics or WebhookMetrics()
        # recompiles the engines when the stores change (cli/webhook.py
        # TorchReloader): started with the listeners, stopped with them
        self.reloader = reloader
        # the watchdog (server/supervisor.py Supervisor): started with the
        # listeners, stopped first; /debug/supervisor serves its status
        self.supervisor = supervisor
        # POST /chaos/* answers 403 unless set (the non-prod gate)
        self.chaos_control_enabled = chaos_control_enabled
        # the observability plane (obs/): the tracer behind /debug/traces,
        # the decision audit log and the SLO tracker behind /debug/slo;
        # each is optional, and None costs a thread-local read per
        # annotation site. The recorder (server/recorder.py) writes each
        # POST body; the error injector swaps /v1/authorize answers at its
        # rates (disabled unless configured)
        self.tracer = tracer
        self.audit_log = audit_log
        self.slo = slo
        self.error_injector = error_injector or ErrorInjector(None)
        self.recorder = recorder
        # ?explain=1 (explain/): the Explainer is built at the first
        # explain request, so the serving path never imports the package
        self._explainer = None
        self._explainer_lock = threading.Lock()
        # canonical-fingerprint memos for the audit lines, joinable with
        # the recorder's file names and the cache's keys; the
        # authorization side shares the cache's memo when there is one
        self._audit_memo = self._adm_audit_memo = None
        if audit_log is not None:
            from ..cache import FingerprintMemo

            self._audit_memo = self._sar_memo or FingerprintMemo(4096)
            self._adm_audit_memo = FingerprintMemo(4096)

        def eval_batcher(fast, serial_fn, path):
            """pipeline_depth > 0: the three-stage PipelinedBatcher over
            the fast path (encode of batch N+1 overlaps the device work of
            batch N); 0: the serial MicroBatcher over serial_fn. Both give
            the same answers."""
            self.metrics.add_fastpath(path, fast)
            # the fast path counts its fallback batches into this server
            fast.metrics = self.metrics
            fast.metrics_path = path
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

    # ----------------------------------------------------- overload control

    def render_shed(self, path_label: str, body: bytes, shed) -> dict:
        """The honest answer to a request the overload gate refused without
        evaluating it (``shed`` a Shed or a RequestShed): on /v1/authorize
        NoOpinion with an evaluationError naming the shed and the retry
        hint (the apiserver falls through its authorizer chain), on
        /v1/admit the configured fail-open/closed review, code 500, as a
        deadline expiry answers."""
        msg = f"request shed under overload ({shed.reason}); retry after {shed.retry_after_s:g}s"
        if path_label != "admission":
            return sar_response(DECISION_NO_OPINION, "", msg)
        uid = ""
        try:
            uid = review_request_uid(json.loads(body)) or ""
        except Exception:  # noqa: BLE001 — the uid is best-effort on a shed
            pass
        allowed = self.admission_fail_open
        return AdmissionResponse(
            uid=uid, allowed=allowed,
            error=f"{msg} ({'allowed' if allowed else 'denied'} on shed)",
        ).to_admission_review()

    def ingress(self, path_label: str, body: bytes, explain: bool = False):
        """The ingress gate on one body (a plane wired) -> (priority,
        None) for an admitted request, or (priority, (shed answer,
        Retry-After value)) for a shed one; an explain request classifies
        ``sheddable``. do_POST and the serve_* wrappers both gate through
        here."""
        priority, shed = self.load.admit(path_label, body, explain)
        if shed is None:
            return priority, None
        return priority, (self.render_shed(path_label, body, shed),
                          str(max(1, round(shed.retry_after_s))))

    def _serve(self, path_label: str, body: bytes, handle, explain: bool) -> dict:
        """The gate, track and handle sequence do_POST runs, without HTTP;
        with no plane wired this is ``handle(body, explain=explain)``."""
        if self.load is None:
            return handle(body, explain=explain)
        priority, shed = self.ingress(path_label, body, explain)
        if shed is not None:
            return shed[0]
        with self.load.track(path_label, priority):
            return handle(body, explain=explain, priority=priority)

    def serve_authorize(self, body: bytes, explain: bool = False) -> dict:
        """One /v1/authorize body through the gate, without HTTP."""
        return self._serve("authorization", body, self.handle_authorize, explain)

    def serve_admit(self, body: bytes, explain: bool = False) -> dict:
        """One /v1/admit body through the gate, without HTTP."""
        return self._serve("admission", body, self.handle_admit, explain)

    def debug_load(self) -> dict:
        """The /debug/load document: the admission controller's stats
        (``admission_control``) and each tuner's status by path
        (``tuning``), each when wired."""
        doc = {}
        if self.load is not None:
            doc["admission_control"] = self.load.stats()
        if self.tuners:
            doc["tuning"] = {t.path: t.status() for t in self.tuners}
        return doc

    def _begin_obs(self, path: str, request_id, parent_span_id, root_span_id, sampled):
        """Open the request's trace (when a tracer is wired) as the calling
        thread's current one, and its observation context -> (trace or
        None, context)."""
        trace = None
        if self.tracer is not None:
            trace = self.tracer.begin(
                path, trace_id=request_id, parent_span_id=parent_span_id,
                root_span_id=root_span_id, sampled=sampled,
            )
            set_current(trace)
        octx: dict = {}
        if trace is not None or self.audit_log is not None:
            _octx_set(octx)
        return trace, octx

    def _finish_obs(self, path: str, endpoint: str, body: bytes, request_id: str, trace,
                    octx: dict, label: str, reason: str, error, latency: float) -> None:
        """Close the request's observability surfaces: the SLO record (the
        latency the request histogram observes), the trace's finish and
        tail-keep, the audit line. A raising hook is logged; the answer is
        already made."""
        _octx_set(None)
        if self.slo is not None:
            try:
                self.slo.record(path, latency, error is not None)
            except Exception:  # noqa: BLE001 — never break serving
                log.exception("slo record failed")
        if trace is not None:
            set_current(None)
            trace.fallback = trace.fallback or bool(octx.get("fallback"))
            try:
                self.tracer.finish(trace, decision=label, error=error is not None)
            except Exception:  # noqa: BLE001 — never break serving
                log.exception("trace finish failed")
        if self.audit_log is not None:
            self._audit(path, endpoint, body, request_id, label, reason, error, latency, octx)

    def _get_explainer(self):
        """The Explainer, built at the first explain request under a lock
        (no explain import before). Each path's engine and breaker come
        from its fast path, else from the engine bound into its stack's
        evaluate backend (engine_of), so an open breaker sends explain to
        the host plane. The JAX server's fleet branch waits for the port's
        fleet."""
        exp = self._explainer
        if exp is not None:
            return exp
        with self._explainer_lock:
            if self._explainer is None:
                from ..explain import Explainer, engine_of

                def stack_engine(stack):
                    if stack is None:
                        return None
                    return (engine_of(getattr(stack, "_evaluate_batch", None))
                            or engine_of(stack._evaluate))

                engines = {}
                for path, fast, stack in (
                    ("authorization", self.fastpath, self.authorizer),
                    ("admission", self.admission_fastpath, self.admission_handler),
                ):
                    if fast is not None:
                        engines[path] = (fast.engine, fast.breaker)
                    else:
                        engines[path] = (stack_engine(stack), None)
                self._explainer = Explainer(
                    authorizer=self.authorizer,
                    admission_handler=self.admission_handler,
                    authz_engine=engines["authorization"][0],
                    admission_engine=engines["admission"][0],
                    authz_breaker=engines["authorization"][1],
                    admission_breaker=engines["admission"][1],
                )
        return self._explainer

    def _handle_authorize_explain(self, body: bytes, request_id: Optional[str] = None) -> dict:
        """?explain=1 on /v1/authorize: the decision plus the attribution
        payload, bypassing the decision cache (never read, never filled),
        the batcher, the tracer, the SLO rings, the audit log and the
        error injector (an operator surface, not serving traffic)."""
        start = time.monotonic()
        if request_id is None:
            request_id = new_trace_id()
        decision, error = DECISION_NO_OPINION, None
        try:
            record_explain_request("authorization")
            decision, reason, error, explanation = self._get_explainer().explain_authorize(body)
            resp = sar_response(decision, reason, error)
            resp["explanation"] = explanation
            return resp
        except Exception as e:  # noqa: BLE001 — always answer the operator
            log.exception("explain authorize requestId=%s failed", request_id)
            error = f"evaluation error: {e}"
            return sar_response(DECISION_NO_OPINION, "", error)
        finally:
            # not on the serving request counter and histogram:
            # cedar_explain_requests_total is the explain-traffic signal
            label = "<error>" if error else _DECISION_LABEL[decision]
            log.info(
                "authorize(explain) requestId=%s decision=%s latency=%.6fs",
                request_id, label, time.monotonic() - start,
            )

    def handle_authorize(self, body: bytes, explain: bool = False,
                         request_id: Optional[str] = None,
                         parent_span_id: Optional[str] = None,
                         root_span_id: Optional[str] = None,
                         sampled: Optional[bool] = None, priority: str = "") -> dict:
        """One SubjectAccessReview body -> the SubjectAccessReview response
        document, with the request metrics, the observability plane and
        the log line; with ``explain`` the explain answer instead
        (_handle_authorize_explain). ``request_id`` is the end-to-end trace
        id (do_POST's ingested traceparent, else fresh); ``sampled`` a
        head-sampling decision drawn before (None draws here);
        ``priority`` the ingress gate's class of an admitted request
        (empty without a plane), which arms the evaluation-stage gate on a
        miss."""
        if explain:
            return self._handle_authorize_explain(body, request_id)
        start = time.monotonic()
        if request_id is None:
            request_id = new_trace_id()
        trace, octx = self._begin_obs(
            "authorization", request_id, parent_span_id, root_span_id, sampled)
        tenant = getattr(body, "tenant", "")
        if tenant and trace is not None:
            trace.root.set_attr("tenant", tenant)
        # the wire protocol of a PDP-mapped body (pdp/), empty for a SAR:
        # the trace root, the request families' bounded label and the
        # audit line carry it
        protocol = getattr(body, "protocol", "")
        if protocol and trace is not None:
            trace.root.set_attr("protocol", protocol)
        decision, reason, error = DECISION_NO_OPINION, "", None
        try:
            try:
                decision, reason, error = self._authorize_cached(
                    body, request_id, start, priority=priority)
            except RequestShed as e:
                # the evaluation-stage gate refused an admitted request:
                # the honest shed, the breaker untouched
                decision, reason, error = DECISION_NO_OPINION, "", str(e)
            if error is None:
                if self.rollout is not None and self._cache_usable():
                    # shadow the real answer (before the injector): a
                    # sampling draw and a non-blocking enqueue. Gated on
                    # the ready latch: a pre-ready NoOpinion would diff
                    # against the always-ready candidate as noise
                    self.rollout.offer("authorize", body, (decision, reason))
                # after the cache: an injected answer is never cached
                decision, reason, error = self.error_injector.inject_if_enabled(
                    decision, reason)
                # the registry's `response` seam: one attribute read
                # unless a game day armed it
                decision, reason, error = chaos_fire("response", (decision, reason, error))
            return sar_response(decision, reason, error)
        finally:
            label = "<error>" if error else _DECISION_LABEL[decision]
            latency = time.monotonic() - start
            self.metrics.record_request(label, latency, protocol=protocol)
            if tenant:
                self.metrics.record_tenant_request("authorization", tenant, label, latency)
            self._finish_obs("authorization", "authorize", body, request_id, trace, octx,
                             label, reason, error, latency)
            log.info(
                "authorize requestId=%s decision=%s latency=%.6fs", request_id, label, latency
            )

    def _authorize_cached(self, body: bytes, request_id: str, start: float,
                          priority: str = ""):
        """(decision, reason, error) through the decision cache: a hit
        answers without touching the breaker, the batcher or the engine; a
        miss leads (or follows) one singleflight evaluation whose clean
        answer is stored for the next arrival. An answer with an error is
        never stored. One budget for the whole request, since ``start``:
        the lookup, the coalesced wait and the submit spend it. Raises
        RequestShed when the evaluation-stage gate sheds the leader, to its
        followers too."""
        cache = self.decision_cache
        if cache is None or not self._cache_usable():
            return self._authorize_uncached(body, request_id, start, priority=priority)
        key = self._sar_memo.fingerprint("authorize", body)
        if key is None:
            # a body that does not parse: the uncached path gives its
            # decode-error answer (never cached: no parse, no key)
            return self._authorize_uncached(body, request_id, start, priority=priority)
        # the generation snapshot comes BEFORE the evaluation: a reload
        # landing while the leader evaluates leaves the entry stamped
        # pre-reload, so it dies at its first lookup after the swap. A
        # raising cache is a miss on the device path, never an answer
        try:
            with trace_span("cache.lookup") as sp:
                gen = cache.current_generation()
                hit = cache.get(key)
                if sp is not None:
                    sp.set_attr("hit", hit is not None)
        except Exception:  # noqa: BLE001 — a sick cache is a miss
            log.exception("decision cache lookup failed; evaluating")
            return self._authorize_uncached(body, request_id, start, priority=priority)
        if hit is not None:
            _octx_mark("cached")
            return hit[0], hit[1], None

        def _leader():
            res = self._authorize_uncached(body, request_id, start, coalesce_key=key,
                                           priority=priority)
            if res[2] is None:
                try:
                    # scoped to the shards of the policies the reason
                    # names and to the request's action
                    # (cache/generation.py): an incremental reload then
                    # kills the entries whose shard changed or that a
                    # policy it added could decide; on a fused plane the
                    # request's tenant qualifies the policy ids (bare ids
                    # collide across tenants) and the added-policy check
                    scoped = getattr(gen, "scoped", None)
                    g = gen if scoped is None else scoped(
                        res[1], tenant=getattr(body, "tenant", ""), action=_sar_action(body))
                    cache.put(key, (res[0], res[1]), res[0], generation=g)
                except Exception:  # noqa: BLE001 — the answer still serves
                    log.exception("decision cache insert failed")
            return res

        try:
            result, _ = self._sar_flights.do(key, _leader, timeout=self._remaining(start))
        except RequestShed:
            raise  # the leader was shed: handle_authorize renders it
        except DeadlineExceeded as e:
            # a FOLLOWER's budget ran out waiting on its leader, which
            # keeps running; its answer still warms the cache
            self.metrics.record_deadline_exceeded("authorization")
            return DECISION_NO_OPINION, "", f"evaluation error: {e}"
        except Exception as e:  # noqa: BLE001 — always answer the apiserver
            if isinstance(e.__cause__, RequestShed):
                # a follower coalesced behind a shed leader: the same
                # honest shed, at once, not an opaque coalesced failure
                raise e.__cause__
            log.exception("coalesced authorize requestId=%s failed", request_id)
            return DECISION_NO_OPINION, "", f"evaluation error: {e}"
        return result

    def _cache_usable(self) -> bool:
        """No caching until every store's initial load is complete: a
        pre-ready NoOpinion is a start-up artifact, not a decision (the
        authorizer's ready() latch makes this cheap at steady state)."""
        try:
            return self.authorizer is None or self.authorizer.ready()
        except Exception:  # noqa: BLE001 — unready reads as uncacheable
            return False

    def _admission_shadowable(self) -> bool:
        """The admission stores are ready (latched, like _cache_usable):
        the unready allow is a start-up artifact, not a decision to diff."""
        try:
            return self.admission_handler is None or self.admission_handler._ready()
        except Exception:  # noqa: BLE001 — unready reads as unshadowable
            return False

    def _remaining(self, start: float) -> Optional[float]:
        """What is left of the request's budget since ``start`` (None
        without one)."""
        if self.request_timeout_s is None:
            return None
        return self.request_timeout_s - (time.monotonic() - start)

    def _authorize_uncached(self, body: bytes, request_id: str, start: float,
                            coalesce_key: Optional[str] = None, priority: str = ""):
        """(decision, reason, error) through the fast path's batcher (the
        breaker first), or, without a fast path, through the authorizer in
        this thread. The batcher gets what remains of the request's budget
        since ``start``; ``coalesce_key`` lets concurrent identical
        submits share one batch row. An admitted request (``priority``
        set) meets the evaluation-stage gate first, which raises
        RequestShed on a saturated server."""
        if self.load is not None and priority:
            # before the breaker and any submit: a shed neither burns a
            # batcher slot nor reads as a device failure
            self.load.check_eval(priority)
        if self._batcher is not None:
            if not self._breaker_admits(self.fastpath, "authorization"):
                return DECISION_NO_OPINION, "", f"evaluation error: {BreakerOpen.MESSAGE}"
            try:
                return self._batcher.submit(
                    body, timeout=self._remaining(start), coalesce_key=coalesce_key
                )
            except DeadlineExceeded as e:
                self.metrics.record_deadline_exceeded("authorization")
                if not e.queued:
                    # the device held the request: feed the breaker. An
                    # expiry that burned in the submit queue is overload,
                    # not a sick device, and spares it
                    self._record_breaker_timeout(self.fastpath)
                _trace_event("deadline_exceeded")
                return DECISION_NO_OPINION, "", f"evaluation error: {e}"
            except Exception as e:  # noqa: BLE001 — always answer the apiserver
                # a failed batch: answered with the posture
                _octx_mark("fallback")
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
            attributes = get_authorizer_attributes(sar)
            # tenant stamp: the interpreter walk over a fused stack relies
            # on the guard conditions reading context.tenantId
            attributes.tenant = getattr(body, "tenant", "")
            # protocol stamp (pdp/): keeps the authorizer's own cache key
            # split by protocol, as the server's fingerprint is
            attributes.protocol = getattr(body, "protocol", "")
            # the authorizer's own cache only when the server has none:
            # the server's already missed on this canonical key
            decision, reason = self.authorizer.authorize(
                attributes, use_cache=self.decision_cache is None
            )
        except Exception as e:  # noqa: BLE001 — always answer the apiserver
            log.exception("authorize requestId=%s failed", request_id)
            return DECISION_NO_OPINION, "", f"evaluation error: {e}"
        return decision, reason, None

    def _handle_admit_explain(self, body: bytes, request_id: Optional[str] = None) -> dict:
        """?explain=1 on /v1/admit: the admission twin of
        _handle_authorize_explain (the same bypasses). The request id is
        logged so the answered X-Cedar-Trace-Id joins the log."""
        if request_id is None:
            request_id = new_trace_id()
        try:
            record_explain_request("admission")
            response, explanation = self._get_explainer().explain_admit(body)
            review = response.to_admission_review()
            review["explanation"] = explanation
            log.info("admit(explain) requestId=%s answered", request_id)
            return review
        except Exception as e:  # noqa: BLE001 — always answer the operator
            log.exception("explain admit requestId=%s failed", request_id)
            return self._admission_fail_mode(_loads_or_none(body), e)

    def handle_admit(self, body: bytes, explain: bool = False,
                     request_id: Optional[str] = None,
                     parent_span_id: Optional[str] = None,
                     root_span_id: Optional[str] = None,
                     sampled: Optional[bool] = None, priority: str = "") -> dict:
        """One AdmissionReview body -> the AdmissionReview response
        document, with the observability plane and the log line (the
        request metrics count /v1/authorize only, as in the JAX package).
        The arguments are handle_authorize's."""
        if request_id is None:
            request_id = new_trace_id()
        if explain:
            return self._handle_admit_explain(body, request_id)
        start = time.monotonic()
        trace, octx = self._begin_obs(
            "admission", request_id, parent_span_id, root_span_id, sampled)
        tenant = getattr(body, "tenant", "")
        if tenant and trace is not None:
            trace.root.set_attr("tenant", tenant)
        doc = None
        try:
            doc = self._handle_admit(body, start, priority=priority)
            if self.rollout is not None and self._admission_shadowable():
                # the shadow worker skips error and fail-mode answers (code
                # other than 200), but the pre-ready allow is a clean 200:
                # gated here
                self.rollout.offer("admit", body, doc)
            return doc
        finally:
            latency = time.monotonic() - start
            label, error = _admit_outcome(doc)
            if tenant:
                self.metrics.record_tenant_request("admission", tenant, label, latency)
            status = ((doc or {}).get("response") or {}).get("status") or {}
            reason = status.get("message") or ""
            self._finish_obs("admission", "admit", body, request_id, trace, octx,
                             label, reason, error, latency)
            if doc is not None:
                resp = doc["response"]
                log.info(
                    "admit requestId=%s allowed=%s code=%d latency=%.6fs",
                    request_id, resp["allowed"], resp["status"]["code"], latency,
                )

    def _audit(self, path, endpoint, body, request_id, label, reason, error,
               latency, octx) -> None:
        """Append one decision audit line: the end-to-end trace id, the
        canonical fingerprint shared with the recorder and the cache
        (memoized: repeat traffic pays one digest), the decision with the
        determining policies its rendered reason names, the latency, and
        the breaker state and posture it was answered under. Best-effort:
        a failing audit plane logs and serves."""
        try:
            memo = self._audit_memo if endpoint == "authorize" else self._adm_audit_memo
            self.audit_log.record(audit_entry(
                path, request_id, memo.fingerprint(endpoint, body), label,
                reason=reason, error=error, latency_s=latency,
                breaker_state=self._breaker_state_label(path),
                fallback=bool(octx.get("fallback")), cached=bool(octx.get("cached")),
                tenant=getattr(body, "tenant", ""),
                protocol=getattr(body, "protocol", ""),
            ))
            record_audit_record(path)
        except Exception:  # noqa: BLE001 — audit must never break serving
            log.exception("audit append failed")

    def _breaker_state_label(self, path: str) -> str:
        """The path's breaker state at answer time ("" without one)."""
        fast = self.fastpath if path == "authorization" else self.admission_fastpath
        breaker = getattr(fast, "breaker", None)
        return breaker.state if breaker is not None else ""

    def _handle_admit(self, body: bytes, start: float, priority: str = "") -> dict:
        """The response document through the admission fast path's
        batcher, or, without one, through the handler (its batcher when
        it has one). Every batcher gets what remains of the request's
        budget since ``start``. A failure answers the fail-mode; nothing
        re-runs the request on another path. An admitted request
        (``priority`` set) meets the evaluation-stage gate first: on a
        saturated server it answers the shed."""
        if self.load is not None and priority:
            try:
                self.load.check_eval(priority)
            except RequestShed as e:
                return self.render_shed("admission", body, e)

        def remaining():
            if self.request_timeout_s is None:
                return None
            return self.request_timeout_s - (time.monotonic() - start)

        if self._adm_raw_batcher is not None:
            if not self._breaker_admits(self.admission_fastpath, "admission"):
                return self._admission_fail_mode(
                    _loads_or_none(body), BreakerOpen(BreakerOpen.MESSAGE)
                )
            try:
                return self._adm_raw_batcher.submit(body, timeout=remaining()).to_admission_review()
            except DeadlineExceeded as e:
                if not e.queued:
                    self._record_breaker_timeout(self.admission_fastpath)
                _trace_event("deadline_exceeded")
                return self._admission_deadline(body, e)
            except Exception as e:  # noqa: BLE001 — always answer the apiserver
                _octx_mark("fallback")
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
            # tenant stamp: the interpreter path's context carries the
            # tenant the device plane masks by
            req.tenant = getattr(body, "tenant", "")
            if self._admission_batcher is not None:
                return self._admission_batcher.submit(
                    req, timeout=remaining()
                ).to_admission_review()
            return self.admission_handler.handle(req, raise_errors=True).to_admission_review()
        except DeadlineExceeded as e:
            self.metrics.record_deadline_exceeded("admission")
            _trace_event("deadline_exceeded")
            return self._admission_fail_mode(review, e)
        except Exception as e:  # noqa: BLE001 — fail-open like the reference
            # allow-on-error posture (reference
            # internal/server/admission/handler.go:90-104 with
            # allowOnError=true): a conversion or evaluation crash must
            # not block the cluster's write path unless configured closed
            log.exception("admit failed")
            return self._admission_fail_mode(review, e)

    def _breaker_admits(self, fastpath, path: str) -> bool:
        """False when the fast path's circuit breaker is open: the request
        then answers the posture without being submitted (the batcher's
        stages may be wedged inside a hung device call, and queueing
        behind them would burn the request's budget), counted as one
        breaker_open fallback."""
        breaker = getattr(fastpath, "breaker", None)
        if breaker is None or breaker.allow():
            return True
        self.metrics.record_fallback_batch(path, "breaker_open")
        _octx_mark("fallback")
        return False

    def _record_breaker_timeout(self, fastpath) -> None:
        """A deadline expiry the device held is a failure signal: a wedged
        evaluator never returns, so the fast path's own accounting never
        feeds the breaker. Consecutive expiries trip it, which stops
        requests queueing behind the stuck batcher (_breaker_admits) until
        half-open probes find the device answering again. On the card the
        card itself says whether it held the request: an expiry while it
        holds no batch for half the budget or longer
        (``fastpath.device_held_s``) burned on a starved host, and spares
        the breaker; its requests answer the deadline, not the posture."""
        breaker = getattr(fastpath, "breaker", None)
        if breaker is None:
            return
        held = getattr(fastpath, "device_held_s", None)
        held = held() if held is not None else None
        if held is not None and self.request_timeout_s is not None \
                and held < self.request_timeout_s / 2:
            return
        breaker.record_failure()

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
        snapshot, the engine's entry, the breaker's state and the native
        encoders the fast path built; {} without a fast path."""
        doc = {}
        for path, batcher, fast in (
            ("authorization", self._batcher, self.fastpath),
            ("admission", self._adm_raw_batcher, self.admission_fastpath),
        ):
            if batcher is not None:
                breaker = fast.breaker
                doc[path] = {
                    "pipeline": batcher.debug_stats(),
                    "engine": _engine_doc(fast.engine),
                    "breaker": None if breaker is None else breaker.state,
                    "encoder_builds": fast.encoder_builds,
                }
        return doc

    def debug_tenancy(self) -> dict:
        """The /debug/tenancy document: the resolver's configuration
        (``resolver``) and the registry's stats (``registry``)."""
        doc = {"resolver": self.tenancy.describe()}
        reg = getattr(self.tenancy, "registry", None)
        if reg is not None:
            doc["registry"] = reg.stats()
        return doc

    def debug_supervisor(self) -> dict:
        """The /debug/supervisor document: the watchdog's status ({} when
        the server has none) and the poison-object quarantine."""
        doc = self.supervisor.status() if self.supervisor is not None else {}
        doc["quarantine"] = quarantine_registry().snapshot()
        return doc

    def debug_cache(self) -> dict:
        """The /debug/cache document: each decision cache's stats() by
        path (``authorization``, and ``admission`` when the admission
        handler has one); {} with no cache."""
        doc = {}
        if self.decision_cache is not None:
            doc["authorization"] = self.decision_cache.stats()
        adm_cache = getattr(self.admission_handler, "cache", None)
        if adm_cache is not None:
            doc["admission"] = adm_cache.stats()
        return doc

    def debug_traces(self) -> dict:
        """The /debug/traces document: the tracer's stats and its ring's
        summaries, newest first."""
        doc = self.tracer.stats()
        doc["traces"] = self.tracer.list_traces()
        return doc

    def _make_handler(server):  # noqa: N805 — bound as a class closure
        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # the status line and headers go out in one write and the body
            # in another: with Nagle's algorithm on, the body then waits
            # for the client's delayed ACK of the headers (about 40 ms on
            # Linux loopback) before it is sent
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):
                log.debug("%s %s", self.address_string(), fmt % args)

            def _write_json(self, doc: dict, code: int = 200, headers: Optional[dict] = None):
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                # the drain check and the in-flight increment are one
                # atomic step: once stop() sets _draining and sees no
                # request in flight under this lock, no request can slip
                # past the check and reach a batcher stop() has joined.
                # ?explain=1 splits off the query here; the bare-path
                # requests the apiserver sends take the path they always did
                path, _, query = self.path.partition("?")
                explain = False
                if query:
                    from urllib.parse import parse_qs

                    vals = parse_qs(query).get("explain")
                    explain = bool(vals) and vals[-1] not in ("0", "false", "")
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
                    if server.tenancy is not None:
                        # the tenant front end, before the gate, the
                        # recorder and the cache: resolve path prefix /
                        # header / host, dispatch on the stripped path and
                        # wrap the body, so every layer below sees the
                        # stamp. An unattributable request is refused, never
                        # evaluated against a plane with no slice for it
                        tenant, path, why = server.tenancy.resolve(
                            path, self.headers, host=self.headers.get("Host"))
                        if tenant is None:
                            server.metrics.record_tenant_rejected(why)
                            self._reject_tenant(path, body, why)
                            return
                        body = TenantBody(body, tenant)
                    path_label = (
                        "authorization" if path == "/v1/authorize"
                        else "admission" if path == "/v1/admit"
                        and server.admission_handler is not None
                        else None
                    )
                    priority = ""
                    if server.load is not None and path_label is not None:
                        # the ingress gate, before the recorder, the trace
                        # and the serving path: a shed is never served,
                        # recorded or traced, and no SLO ring sees it
                        priority, shed = server.ingress(path_label, body, explain)
                        if shed is not None:
                            self._write_json(shed[0], headers={"Retry-After": shed[1]})
                            return
                    if server.recorder is not None:
                        server.recorder.record(path, body)
                    # one request id end to end: the ingested W3C
                    # traceparent's trace id (or a fresh one) is the logged
                    # requestId, the trace's id in /debug/traces and the
                    # audit log, and the X-Cedar-Trace-Id response header
                    request_id, parent_span = ingest_request_id(self.headers.get("traceparent"))
                    headers = {"X-Cedar-Trace-Id": request_id}
                    root_span = sampled = None
                    if server.tracer is not None:
                        # our root span is the downstream parent; the
                        # recorded flag is the HEAD sampling decision
                        # (drawn here, honored by the handler's trace):
                        # tail-keep is not knowable at response time
                        root_span = new_span_id()
                        sampled = server.tracer.head_sample()
                        headers["traceparent"] = format_traceparent(request_id, root_span, sampled)
                    ids = dict(explain=explain, request_id=request_id,
                               parent_span_id=parent_span, root_span_id=root_span,
                               sampled=sampled, priority=priority)
                    # an admitted request is tracked until its answer is
                    # written: queue wait and evaluation are the load
                    tracked = (
                        server.load.track(path_label, priority) if priority
                        else contextlib.nullcontext()
                    )
                    with tracked:
                        if path_label == "authorization":
                            self._write_json(server.handle_authorize(body, **ids),
                                             headers=headers)
                        elif path_label == "admission":
                            self._write_json(server.handle_admit(body, **ids), headers=headers)
                        else:
                            self.send_error(404)
                finally:
                    with server._inflight_cv:
                        server._inflight -= 1
                        server._inflight_cv.notify_all()

            def _reject_tenant(self, path: str, body: bytes, why: str):
                """The refusal of a request the tenant front end could not
                attribute: NoOpinion + evaluationError on /v1/authorize
                (the apiserver reads an abstain), a denied review (code
                403) on /v1/admit: fail-closed, a write must not slip
                through a misrouted tenant."""
                msg = {
                    "unknown": "unknown tenant",
                    "conflict": "conflicting tenant sources",
                }.get(why, "no tenant resolved")
                if path == "/v1/admit":
                    uid = ""
                    try:
                        uid = (json.loads(body).get("request") or {}).get("uid", "")
                    except Exception:  # noqa: BLE001 — refused regardless
                        pass
                    self._write_json(AdmissionResponse(
                        uid=uid, allowed=False, code=403, message=f"tenant rejected: {msg}",
                    ).to_admission_review())
                else:
                    self._write_json(sar_response(DECISION_NO_OPINION, "",
                                                  f"tenant rejected: {msg}"))

            def do_GET(self):
                if server.enable_profiling and self.path.startswith("/debug/pprof"):
                    self._debug(self.path)
                else:
                    self.send_error(404)

            def _debug(self, path: str):
                import io
                import sys
                import traceback

                if path.startswith("/debug/pprof/profile"):
                    # a statistical whole-process sampler: every thread's
                    # stack every 10 ms for one second (a profiler of this
                    # thread would see only this handler sleeping).
                    # walk_stack yields (frame, line) pairs: the names come
                    # from the frame's code object (the JAX server reads
                    # FrameSummary fields off the frame and raises)
                    import collections

                    me = threading.get_ident()
                    counts: collections.Counter = collections.Counter()
                    deadline = time.monotonic() + 1.0
                    samples = 0
                    while time.monotonic() < deadline:
                        for tid, frame in sys._current_frames().items():
                            if tid == me:
                                continue
                            stack = tuple(
                                f"{fr.f_code.co_filename.rsplit('/', 1)[-1]}:{line} "
                                f"{fr.f_code.co_name}"
                                for fr, line in traceback.walk_stack(frame)
                            )[::-1]
                            counts[stack] += 1
                        samples += 1
                        time.sleep(0.01)
                    buf = io.StringIO()
                    buf.write(f"# {samples} samples over 1s, 10ms interval\n")
                    for stack, n in counts.most_common(50):
                        buf.write(f"\n{n} samples:\n")
                        for line in stack:
                            buf.write(f"  {line}\n")
                    data = buf.getvalue().encode()
                else:
                    buf = io.StringIO()
                    for tid, frame in sys._current_frames().items():
                        buf.write(f"--- thread {tid}\n")
                        traceback.print_stack(frame, file=buf)
                    data = buf.getvalue().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

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

            def _send_json(self, doc: dict, code: int = 200):
                self._send(json.dumps(doc).encode(), "application/json", code)

            def _debug(self, name: str, fn):
                try:
                    doc = fn()
                except Exception:  # noqa: BLE001 — debug must not 500
                    log.exception("%s failed", name)
                    doc = {"error": f"{name} failed"}
                self._send_json(doc)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(b"", "")
                elif self.path == "/readyz":
                    if server.load is None:
                        self._send(b"", "", 200 if server.ready() else 503)
                        return
                    # graduated: the body and X-Cedar-Load-State carry the
                    # load state, and saturated reads 503 so an apiserver
                    # honoring readiness steers new traffic elsewhere
                    state = server.load.load_state()
                    ready = server.ready() and state != STATE_SATURATED
                    self.send_response(200 if ready else 503)
                    self.send_header("X-Cedar-Load-State", state)
                    self.send_header("Content-Length", str(len(state)))
                    self.end_headers()
                    self.wfile.write(state.encode())
                elif self.path == "/metrics":
                    if server.slo is not None:
                        try:
                            # burn rates are window functions of time, not
                            # of events: refreshed at scrape, so a quiet
                            # window decays the gauges
                            server.slo.publish()
                        except Exception:  # noqa: BLE001 — scrape must serve
                            log.exception("slo publish failed")
                    self._send(server.metrics.expose().encode(), "text/plain; version=0.0.4")
                elif self.path == "/debug/engine":
                    self._debug("engine stats", server.debug_engine)
                elif self.path == "/debug/supervisor":
                    self._debug("supervisor status", server.debug_supervisor)
                elif self.path == "/debug/cache":
                    self._debug("cache stats", server.debug_cache)
                elif self.path == "/debug/chaos":
                    self._debug("chaos stats", default_registry().stats)
                elif self.path == "/debug/load":
                    if server.load is None and not server.tuners:
                        self.send_error(404)
                        return
                    self._debug("load status", server.debug_load)
                elif self.path == "/debug/slo":
                    if server.slo is None:
                        self.send_error(404)
                        return
                    self._debug("slo status", server.slo.status)
                elif self.path == "/debug/traces" or self.path.startswith("/debug/traces/"):
                    # the bare path lists the ring newest first; /<id>
                    # (a prefix will do) one kept span tree
                    if server.tracer is None:
                        self.send_error(404)
                        return
                    trace_id = self.path[len("/debug/traces/"):].strip("/")
                    if trace_id:
                        doc = server.tracer.get(trace_id)
                        if doc is None:
                            self.send_error(404)
                            return
                        self._send_json(doc)
                    else:
                        self._debug("trace listing", server.debug_traces)
                elif self.path == "/debug/rollout":
                    if server.rollout is None:
                        self.send_error(404)
                        return
                    self._debug("rollout status", server.rollout.status)
                elif self.path == "/debug/lifecycle":
                    if server.lifecycle is None:
                        self.send_error(404)
                        return
                    self._debug("lifecycle status", server.lifecycle.status)
                elif self.path == "/debug/tenancy":
                    # the front end's configuration and the registry's
                    # per-tenant policy counts (the serving plane's shard
                    # rollup is /debug/engine's shards.tenants)
                    if server.tenancy is None:
                        self.send_error(404)
                        return
                    self._debug("tenancy status", server.debug_tenancy)
                elif self.path == "/debug/analysis":
                    if server.analysis_provider is None:
                        self.send_error(404)
                        return
                    self._debug(
                        "analysis provider",
                        lambda: _analysis_doc(server.analysis_provider() or {}),
                    )
                else:
                    self.send_error(404)

            def _body(self):
                """The POST body, or None after answering 400 / 413."""
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                except ValueError:
                    self.send_error(400, "bad Content-Length")
                    return None
                if length < 0 or length > MAX_BODY_BYTES:
                    self.send_error(413, "request body too large")
                    return None
                return self.rfile.read(length) if length else b""

            def do_POST(self):
                if self.path.startswith(("/rollout/", "/lifecycle/")):
                    self._rollout_control()
                elif self.path.startswith("/chaos/"):
                    self._chaos_control()
                else:
                    self.send_error(404)

            def _rollout_control(self):
                """Rollout lifecycle: POST /rollout/stage with
                {"directory": ...}, {"source": ...} or {"crd": true} (and
                optionally "description", "warm", "sampleRate"),
                /rollout/promote with an optional {"force": true},
                /rollout/rollback; and POST /lifecycle/approve with
                {"tenant": ...}. Each answers the controller's status; a
                refusal answers 409. 403 unless control is enabled, and
                without the bearer token when one is set."""
                if server.rollout is None and server.lifecycle is None:
                    self.send_error(404)
                    return
                if not server.rollout_control_enabled:
                    self._send_json(
                        {"error": "rollout control is disabled on this listener; start "
                                  "the webhook with --rollout-control-token-file (bearer "
                                  "auth) or --rollout-insecure-control (docs/rollout.md)"},
                        403,
                    )
                    return
                if server.rollout_control_token:
                    auth = self.headers.get("Authorization") or ""
                    expected = f"Bearer {server.rollout_control_token}"
                    # bytes compare: compare_digest raises on non-ASCII str,
                    # and a stray header byte must answer 403
                    if not hmac.compare_digest(
                        auth.encode("utf-8", "surrogateescape"),
                        expected.encode("utf-8", "surrogateescape"),
                    ):
                        self._send_json({"error": "missing or invalid bearer token"}, 403)
                        return
                raw = self._body()
                if raw is None:
                    return
                try:
                    doc = json.loads(raw) if raw else {}
                except (ValueError, TypeError) as e:
                    self._send_json({"error": f"bad JSON body: {e}"}, 400)
                    return
                from ..lifecycle import LifecycleError
                from ..rollout import RolloutError
                from ..rollout.source import CandidateSourceError

                try:
                    if self.path.startswith("/rollout/") and server.rollout is None:
                        self.send_error(404)
                        return
                    if self.path == "/rollout/stage":
                        out = server.rollout.stage(
                            directory=doc.get("directory"),
                            source=doc.get("source"),
                            crd=bool(doc.get("crd")),
                            description=doc.get("description", ""),
                            warm=doc.get("warm", "async"),
                            sample_rate=doc.get("sampleRate"),
                        )
                    elif self.path == "/rollout/promote":
                        out = server.rollout.promote(force=bool(doc.get("force")))
                    elif self.path == "/rollout/rollback":
                        out = server.rollout.rollback()
                    elif self.path == "/lifecycle/approve":
                        # manual-promotion consent for a declarative
                        # rollout holding for approval
                        if server.lifecycle is None:
                            self.send_error(404)
                            return
                        out = server.lifecycle.approve(doc.get("tenant") or "")
                    else:
                        self.send_error(404)
                        return
                except (RolloutError, CandidateSourceError, LifecycleError) as e:
                    # a structured refusal (a refused rollback's lineage
                    # breakdown) rides the body
                    body = {"error": str(e)}
                    detail = getattr(e, "detail", None)
                    if detail:
                        body["detail"] = detail
                    self._send_json(body, 409)
                    return
                except Exception as e:  # noqa: BLE001 — report, never crash
                    log.exception("rollout control %s failed", self.path)
                    self._send_json({"error": str(e)}, 500)
                    return
                self._send_json(out)

            def _chaos_control(self):
                """Game-day control: POST /chaos/configure with a scenario
                JSON body, then /chaos/arm; /chaos/disarm stops injection at
                once; /chaos/reset also drops the scenario. Each answers the
                registry's stats. 403 without the non-prod gate."""
                if not server.chaos_control_enabled:
                    self._send_json(
                        {"error": "chaos control is disabled; start the webhook "
                                  "with --confirm-non-prod-inject-errors"},
                        403,
                    )
                    return
                raw = self._body()
                if raw is None:
                    return
                registry = default_registry()
                try:
                    if self.path == "/chaos/configure":
                        registry.configure(load_scenario(raw or b"{}"))
                    elif self.path == "/chaos/arm":
                        registry.arm()
                    elif self.path == "/chaos/disarm":
                        registry.disarm()
                    elif self.path == "/chaos/reset":
                        registry.reset()
                    else:
                        self.send_error(404)
                        return
                except (ScenarioError, ValueError) as e:
                    self._send_json({"error": str(e)}, 400)
                    return
                except Exception as e:  # noqa: BLE001 — report, never crash
                    log.exception("chaos control %s failed", self.path)
                    self._send_json({"error": str(e)}, 500)
                    return
                self._send_json(registry.stats())

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
        if self.pdp is not None:
            self.pdp.start()
        if self.reloader is not None:
            self.reloader.start()
        if self.supervisor is not None:
            self.supervisor.start()
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
        if self.supervisor is not None:
            # first: reviving a stage mid-teardown would race the joins
            self.supervisor.stop()
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
        if self.pdp is not None:
            try:
                # after the webhook listeners (the drain covered both
                # fronts: PDP requests enter through serve_authorize and
                # count in the same in-flight picture), before the
                # batchers, so no PDP submit races a joining worker
                self.pdp.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("pdp listener stop failed")
        if self.reloader is not None:
            self.reloader.stop()
        self.stop_batchers()
        self.close_stores()
        if self.lifecycle is not None:
            try:
                # the reconcile loop before the rollout controller: a tick
                # landing mid-teardown would drive stage / promote against
                # a stack being dismantled
                self.lifecycle.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("lifecycle stop failed")
        if self.rollout is not None:
            try:
                self.rollout.stop()  # the shadow worker
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("rollout stop failed")
        for closer in (self.tracer, self.audit_log):
            if closer is not None:
                closer.close()  # the trace log's and the audit log's files

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
        a server used as a serving core without start()); the tuners
        first, since a control loop moving a batcher's knobs would race
        its join."""
        for tuner in self.tuners:
            try:
                tuner.stop()
            except Exception:  # noqa: BLE001 — teardown must finish
                log.exception("batch tuner stop failed")
        for batcher in (self._batcher, self._adm_raw_batcher, self._admission_batcher):
            if batcher is not None:
                batcher.stop()

    @property
    def bound_port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def bound_metrics_port(self) -> Optional[int]:
        return self._metrics_httpd.server_address[1] if self._metrics_httpd else None
