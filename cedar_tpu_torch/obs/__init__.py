"""Request observability plane: tracing, decision audit log, SLO tracking
(a copy of the JAX package's obs/, with its exports).

The package is zero-dependency and pay-for-use: nothing here touches the
device, and with no tracer wired the serving path's only cost is a
thread-local read per annotation site. server/http.py wires it around
both webhook paths; cli/trace.py reads the trace log and /debug/traces.
"""

from .audit import AuditLog, audit_entry
from .slo import SLOTracker
from .trace import (
    Trace,
    Tracer,
    current_trace,
    format_traceparent,
    ingest_request_id,
    parse_traceparent,
    set_current,
    span,
    span_tree_coverage,
)

__all__ = [
    "AuditLog",
    "SLOTracker",
    "Trace",
    "Tracer",
    "audit_entry",
    "current_trace",
    "format_traceparent",
    "ingest_request_id",
    "parse_traceparent",
    "set_current",
    "span",
    "span_tree_coverage",
]
