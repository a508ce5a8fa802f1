"""Request tracing: monotonic-clock span trees over the serving pipeline (a
copy of the JAX package's obs/trace.py).

The port's serving path is cache -> single-flight -> breaker -> pipelined
batcher (encode / dispatch / decode) -> the card; aggregate counters say
*that* it was slow, never *where one request* spent its budget. This
module is the zero-dependency recorder behind that question:

  * ``Span``/``Trace``: monotonic-clock spans with a bounded attribute
    set, parented into one tree per request. The request thread builds the
    tree; batch-level stages (engine/batcher.py) contribute their windows
    retroactively from the timestamps they stamp per batch anyway, so the
    worker loops never run tracing code.
  * W3C ``traceparent`` ingestion: the apiserver's trace id (when present)
    becomes the request's trace id AND its logged ``requestId``, echoed in
    the ``X-Cedar-Trace-Id`` response header: one id joins the apiserver
    audit log, the serving log, the decision audit log and /debug/traces.
  * ``Tracer``: head-samples at a configurable rate and TAIL-KEEPS
    unsampled requests that turn out slow (> the tail latency budget),
    errored, or answered with the failure posture (``fallback``), into a
    bounded in-memory ring served at ``/debug/traces`` and (optionally)
    appended as JSONL to a trace log that ``cedar-trace``
    (cli/trace.py) reads offline.

Pay-for-use contract: with no tracer wired, the serving path's only cost
is a thread-local read per annotation site; with a tracer armed but the
request unsampled, the cost is the span bookkeeping. The recorder never
touches the device.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import uuid
from collections import deque
from typing import Optional, Tuple

log = logging.getLogger(__name__)


def _process_worker_id() -> str:
    """This process's fanout worker id: always empty, since the port has no
    multi-process tier yet, so a record carries no ``worker`` key and stays
    byte-identical to the JAX package's single-process output."""
    return ""


def _process_pod_id():
    """This process's pod process index: None, since the port has no pod
    tier yet, so a record carries no ``podProcess`` / ``pod_process``
    key."""
    return None


# bounded per-span attribute set: traces are a debugging surface, not a
# logging pipeline — unbounded attributes would turn the ring into one
MAX_SPAN_ATTRS = 16
MAX_ATTR_CHARS = 200


def new_trace_id() -> str:
    """Fresh 32-hex-char W3C trace id."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """Fresh 16-hex-char W3C span id."""
    return uuid.uuid4().hex[:16]


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """W3C ``traceparent`` → ``(trace_id, parent_span_id)``; None when the
    header is absent or malformed (version-format check only — future
    versions with extra fields still yield their first four). All-zero
    trace/span ids are invalid per spec."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def ingest_request_id(traceparent: Optional[str]) -> Tuple[str, Optional[str]]:
    """(request id, upstream parent span id) for one HTTP request: the
    ingested traceparent's trace id when present, a fresh trace id
    otherwise — the ONE id the serving log, response header, audit log,
    and trace ring all share (server/http.py)."""
    parsed = parse_traceparent(traceparent)
    if parsed is None:
        return new_trace_id(), None
    return parsed


class Span:
    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs")

    def __init__(self, name: str, span_id: str, parent_id: Optional[str]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.monotonic()
        self.t1: Optional[float] = None
        self.attrs: dict = {}

    def set_attr(self, key: str, value) -> None:
        if len(self.attrs) >= MAX_SPAN_ATTRS and key not in self.attrs:
            return
        if isinstance(value, str) and len(value) > MAX_ATTR_CHARS:
            value = value[:MAX_ATTR_CHARS]
        self.attrs[key] = value

    def end(self) -> None:
        if self.t1 is None:
            self.t1 = time.monotonic()


class _SpanCtx:
    """Context manager binding one span into the trace's open-span stack."""

    __slots__ = ("_trace", "span")

    def __init__(self, trace: "Trace", span: Span):
        self._trace = trace
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        self._trace.end_span(self.span)


class _NullCtx:
    """No-trace stand-in: span() sites cost one thread-local read plus
    this shared context manager when tracing is disarmed."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NULL_CTX = _NullCtx()


class Trace:
    """One request's span tree. Built by the request thread (plus
    retroactive batch-stage windows via ``add_span``); not a general
    concurrent structure — exactly the serving path's shape."""

    __slots__ = (
        "trace_id",
        "path",
        "root",
        "spans",
        "sampled",
        "parent_span_id",
        "started_unix",
        "decision",
        "error",
        "fallback",
        "_stack",
        "_n",
    )

    def __init__(
        self,
        path: str,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        root_span_id: Optional[str] = None,
        sampled: bool = False,
    ):
        self.trace_id = trace_id or new_trace_id()
        self.path = path
        self.parent_span_id = parent_span_id
        self.started_unix = time.time()
        self.sampled = sampled
        self.decision: Optional[str] = None
        self.error = False
        # answered with the failure posture (an open breaker, a failed
        # batch): a tail-keep trigger independent of latency
        self.fallback = False
        self.root = Span(path, root_span_id or new_span_id(), parent_span_id)
        self.spans = [self.root]
        self._stack = [self.root]
        self._n = 0

    # ------------------------------------------------------------- recording

    def _next_id(self) -> str:
        self._n += 1
        return f"{self._n:x}"

    def begin_span(self, name: str) -> Span:
        span = Span(name, self._next_id(), self._stack[-1].span_id)
        self.spans.append(span)
        self._stack.append(span)
        return span

    def end_span(self, span: Span) -> None:
        span.end()
        if self._stack and self._stack[-1] is span:
            self._stack.pop()

    def span(self, name: str) -> _SpanCtx:
        return _SpanCtx(self, self.begin_span(name))

    def add_span(
        self, name: str, t0: float, t1: float, **attrs
    ) -> Optional[Span]:
        """Retroactively add a completed span from externally captured
        monotonic timestamps (the batcher's per-batch stage stamps). The
        span parents onto the innermost open span of the calling thread's
        tree — for the serving path that is the request's evaluation
        span."""
        if t0 is None or t1 is None:
            return None
        span = Span(name, self._next_id(), self._stack[-1].span_id)
        span.t0, span.t1 = t0, t1
        for k, v in attrs.items():
            span.set_attr(k, v)
        self.spans.append(span)
        return span

    def event(self, name: str, **attrs) -> None:
        """Zero-duration marker span (a deadline expiry)."""
        now = time.monotonic()
        self.add_span(name, now, now, **attrs)

    def finish(
        self,
        decision: Optional[str] = None,
        error: bool = False,
    ) -> float:
        """Close the root span; returns the trace's duration (seconds)."""
        self.decision = decision
        self.error = bool(error) or self.error
        while self._stack:
            self._stack.pop().end()
        return self.root.t1 - self.root.t0

    @property
    def duration_s(self) -> float:
        if self.root.t1 is None:
            return 0.0
        return self.root.t1 - self.root.t0

    # ------------------------------------------------------------- rendering

    def to_dict(self, kept: str = "") -> dict:
        t0 = self.root.t0
        spans = []
        for s in self.spans:
            end = s.t1 if s.t1 is not None else t0
            spans.append(
                {
                    "name": s.name,
                    "spanId": s.span_id,
                    "parent": s.parent_id,
                    "start_us": round((s.t0 - t0) * 1e6, 1),
                    "duration_us": round(max(0.0, end - s.t0) * 1e6, 1),
                    "attrs": s.attrs,
                }
            )
        doc = {
            "traceId": self.trace_id,
            "path": self.path,
            "start_unix": round(self.started_unix, 6),
            "duration_us": round(self.duration_s * 1e6, 1),
            "decision": self.decision,
            "error": self.error,
            "fallback": self.fallback,
            "sampled": self.sampled,
            "kept": kept,
            "upstreamParent": self.parent_span_id or "",
            "spans": spans,
        }
        w = _process_worker_id()
        if w:
            # multi-process fanout tier: the serving worker's id, so a
            # trace pulled from any worker's ring joins the tier-wide
            # metrics scrape and audit records instead of colliding
            doc["worker"] = w
        p = _process_pod_id()
        if p is not None:
            # pod tier: which host of the one logical engine served this
            # request (the collective ran everywhere; the REQUEST lived
            # here) — joins cedar_pod_partition_reuploads_total{host}
            doc["podProcess"] = p
        return doc


# ------------------------------------------------------- thread-local current

_current = threading.local()


def current_trace() -> Optional[Trace]:
    """The calling thread's active trace, or None — the ONE check every
    annotation site pays when tracing is disarmed."""
    return getattr(_current, "trace", None)


def set_current(trace: Optional[Trace]) -> None:
    _current.trace = trace


def span(name: str):
    """Context manager opening ``name`` on the calling thread's active
    trace; a shared no-op when there is none (disarmed cost: one
    thread-local read)."""
    tr = current_trace()
    if tr is None:
        return _NULL_CTX
    return tr.span(name)


def annotate(fn) -> None:
    """Run ``fn(trace)`` against the active trace, if any — for sites
    that want more than one span call without re-reading the local."""
    tr = current_trace()
    if tr is not None:
        fn(tr)


class Tracer:
    """Head-sampling + tail-keep trace collector (module docstring).

    ``sample_rate`` ∈ [0, 1] head-samples; independent of that, finished
    traces that were slow (duration > ``tail_latency_s``), errored, or
    posture-answered are kept too — the requests an operator actually goes
    looking for are exactly the ones head sampling misses. Kept traces
    land in a bounded ring (``/debug/traces``) and, when ``log_file`` is
    set, append as one JSON line each (``cedar-trace --log``)."""

    def __init__(
        self,
        sample_rate: float = 0.0,
        ring_capacity: int = 256,
        tail_latency_s: Optional[float] = 1.0,
        log_file: Optional[str] = None,
        rng: Optional[random.Random] = None,
    ):
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.tail_latency_s = tail_latency_s
        self.log_file = log_file
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(ring_capacity)))
        self._log_fh = None
        self._log_lock = threading.Lock()
        self.kept = 0
        self.finished = 0

    # -------------------------------------------------------------- lifecycle

    def head_sample(self) -> bool:
        """Draw one head-sampling decision. Exposed so the HTTP layer can
        draw it BEFORE the handler runs and put the honest recorded flag
        into the response ``traceparent`` (tail-keep recording is not
        knowable at response time — the flag reflects head sampling)."""
        return self.sample_rate >= 1.0 or (
            self.sample_rate > 0.0 and self._rng.random() < self.sample_rate
        )

    def begin(
        self,
        path: str,
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
        root_span_id: Optional[str] = None,
        sampled: Optional[bool] = None,
    ) -> Trace:
        if sampled is None:
            sampled = self.head_sample()
        return Trace(
            path,
            trace_id=trace_id,
            parent_span_id=parent_span_id,
            root_span_id=root_span_id,
            sampled=sampled,
        )

    def finish(
        self,
        trace: Trace,
        decision: Optional[str] = None,
        error: bool = False,
    ) -> Optional[str]:
        """Close the trace and apply the keep policy; returns the keep
        reason (``sampled`` / ``slow`` / ``error`` / ``fallback``) or None
        when the trace is dropped."""
        duration = trace.finish(decision=decision, error=error)
        with self._lock:
            self.finished += 1
        reason = None
        if trace.sampled:
            reason = "sampled"
        elif trace.error:
            reason = "error"
        elif trace.fallback:
            reason = "fallback"
        elif (
            self.tail_latency_s is not None
            and self.tail_latency_s > 0
            and duration > self.tail_latency_s
        ):
            reason = "slow"
        if reason is None:
            return None
        doc = trace.to_dict(kept=reason)
        with self._lock:
            self._ring.append(doc)
            self.kept += 1
        self._export(doc)
        try:
            from ..server.metrics import record_trace_kept

            record_trace_kept(trace.path, reason)
        except Exception:  # noqa: BLE001 — metrics must never break tracing
            pass
        return reason

    def _export(self, doc: dict) -> None:
        if self.log_file is None:
            return
        try:
            with self._log_lock:
                if self._log_fh is None:
                    self._log_fh = open(self.log_file, "a", buffering=1)
                self._log_fh.write(
                    json.dumps(doc, separators=(",", ":")) + "\n"
                )
        except OSError:
            log.exception("trace log append failed; disabling export")
            self.log_file = None

    def close(self) -> None:
        with self._log_lock:
            if self._log_fh is not None:
                try:
                    self._log_fh.close()
                finally:
                    self._log_fh = None

    # ---------------------------------------------------------------- lookup

    def list_traces(self, limit: int = 64) -> list:
        """Newest-first trace summaries for /debug/traces."""
        with self._lock:
            docs = list(self._ring)
        out = []
        for doc in reversed(docs[-limit:] if limit else docs):
            out.append(
                {
                    "traceId": doc["traceId"],
                    "path": doc["path"],
                    "decision": doc["decision"],
                    "duration_us": doc["duration_us"],
                    "kept": doc["kept"],
                    "error": doc["error"],
                    "fallback": doc["fallback"],
                    "start_unix": doc["start_unix"],
                    "spans": len(doc["spans"]),
                }
            )
        return out

    def get(self, trace_id: str) -> Optional[dict]:
        """Full span tree by trace id (unambiguous prefixes accepted),
        newest match first."""
        if not trace_id:
            return None
        with self._lock:
            docs = list(self._ring)
        for doc in reversed(docs):
            if doc["traceId"].startswith(trace_id):
                return doc
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "sample_rate": self.sample_rate,
                "tail_latency_ms": (
                    round(self.tail_latency_s * 1e3, 3)
                    if self.tail_latency_s
                    else None
                ),
                "ring_capacity": self._ring.maxlen,
                "ring_size": len(self._ring),
                "finished": self.finished,
                "kept": self.kept,
                "log_file": self.log_file or "",
            }


def span_tree_coverage(doc: dict) -> float:
    """Fraction of a trace's e2e duration covered by the union of its
    named child spans (interval-merged, so nested/overlapping spans never
    double-count). The acceptance bar for the instrumentation: a slow
    request's tree must account for >= 95% of where the time went."""
    total = doc.get("duration_us", 0.0)
    if total <= 0:
        return 1.0
    root_id = doc["spans"][0]["spanId"] if doc.get("spans") else None
    intervals = sorted(
        (s["start_us"], s["start_us"] + s["duration_us"])
        for s in doc.get("spans", ())
        if s["spanId"] != root_id
    )
    covered = 0.0
    cur_lo = cur_hi = None
    for lo, hi in intervals:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return min(1.0, covered / total)


__all__ = [
    "MAX_SPAN_ATTRS",
    "Span",
    "Trace",
    "Tracer",
    "annotate",
    "current_trace",
    "format_traceparent",
    "ingest_request_id",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
    "set_current",
    "span",
    "span_tree_coverage",
]
