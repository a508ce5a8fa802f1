"""Decision audit log: one structured JSONL line per answered decision (a
copy of the JAX package's obs/audit.py; ``audit_entry`` takes the
``tenant`` a tenant front end resolved and the ``protocol`` of a request
the PDP front end mapped (pdp/), and leaves out the ``tier`` key, which
no server of either package sets).

Zero-trust authorization treats a durable, joinable decision trail as a
core requirement (PAPERS.md, arXiv:2504.14777), and Cedar positions
auditability as a first-class language property (arXiv:2403.04651). This
module is that trail for the webhook: every authorize/admit answer appends
one JSON line carrying

  * ``traceId`` — the request id propagated end to end (obs/trace.py), so
    an audit line joins /debug/traces, the serving log, and the
    apiserver's own audit log;
  * ``fingerprint`` — the canonical request fingerprint
    (cache/fingerprint.py), the SAME key the decision cache used and the
    recorder stamped into its filename (server/recorder.py), so an audit
    line joins a recorded request body (``req-<ep>-<fp>-*.json``);
  * decision/reason facts: decision label, the determining policy ids
    (read from the already-rendered reason diagnostics — no re-evaluation
    and no device work), latency, cache-hit/error flags, and the breaker
    state at answer time (``fallback``: answered with the failure
    posture).

Rotation is size-based: when the live file crosses ``max_bytes`` it shifts
to ``<path>.1`` (existing ``.1``→``.2``, …; the oldest beyond
``max_files`` is dropped), so the log is bounded without an external
rotator. Append failures disable the log and never affect serving.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from .trace import _process_pod_id, _process_worker_id

log = logging.getLogger(__name__)


def determining_policies(reason: str) -> list:
    """Determining policy ids from an already-rendered reason string: the
    authorization diagnostics JSON ``{"reasons":[{"policy": ...}]}`` or
    the admission deny message's bare reason list ``[{"policy": ...}]`` —
    both computed by the serving path anyway. Best-effort: non-JSON
    reasons (gate strings, pre-ready answers) yield []. The decision
    cache's shard-scoped stamps read the same ids (cache/generation.py)."""
    if not reason or reason[0] not in "{[":
        return []
    try:
        doc = json.loads(reason)
        rows = doc.get("reasons", []) if isinstance(doc, dict) else doc
        return [
            r.get("policy", "")
            for r in rows
            if isinstance(r, dict) and r.get("policy")
        ]
    except (ValueError, TypeError):
        return []


class AuditLog:
    def __init__(
        self,
        path: str,
        max_bytes: int = 64 * 1024 * 1024,
        max_files: int = 3,
    ):
        self.path = path
        self.max_bytes = max(4096, int(max_bytes))
        # rotated generations kept BESIDE the live file (<path>.1..N)
        self.max_files = max(1, int(max_files))
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self.records = 0
        self.rotations = 0
        self._disabled = False

    # ------------------------------------------------------------- recording

    def record(self, entry: dict) -> None:
        """Append one audit line; never raises into the serving path."""
        if self._disabled:
            return
        line = json.dumps(entry, separators=(",", ":")) + "\n"
        data = line.encode()
        try:
            with self._lock:
                if self._fh is None:
                    self._open_locked()
                if self._size + len(data) > self.max_bytes and self._size > 0:
                    self._rotate_locked()
                self._fh.write(data)
                self._size += len(data)
                self.records += 1
        except OSError:
            log.exception("audit log append failed; disabling audit")
            self._disabled = True

    def _open_locked(self) -> None:
        self._fh = open(self.path, "ab", buffering=0)
        self._size = os.path.getsize(self.path)

    def _rotate_locked(self) -> None:
        """Shift <path> → <path>.1 → … → <path>.max_files (dropped)."""
        self._fh.close()
        self._fh = None
        for i in range(self.max_files, 0, -1):
            src = self.path if i == 1 else f"{self.path}.{i - 1}"
            dst = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, dst)
        self._open_locked()
        self.rotations += 1
        try:
            from ..server.metrics import record_audit_rotation

            record_audit_rotation()
        except Exception:  # noqa: BLE001 — metrics must never break audit
            pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "max_bytes": self.max_bytes,
                "max_files": self.max_files,
                "size_bytes": self._size,
                "records": self.records,
                "rotations": self.rotations,
                "disabled": self._disabled,
            }


def audit_entry(
    path: str,
    trace_id: str,
    fingerprint: Optional[str],
    decision: str,
    reason: str = "",
    error: Optional[str] = None,
    latency_s: float = 0.0,
    breaker_state: str = "",
    fallback: bool = False,
    cached: bool = False,
    tenant: str = "",
    protocol: str = "",
) -> dict:
    """One decision's audit line. The determining policy ids come from the
    reason diagnostics already in hand: the audit plane never re-evaluates
    and never launches device work."""
    entry = {
        "ts": round(time.time(), 6),
        "path": path,
        "traceId": trace_id,
        "fingerprint": fingerprint or "unkeyed",
        "decision": decision,
        "latency_us": round(latency_s * 1e6, 1),
        "policies": determining_policies(reason),
        "breaker": breaker_state,
        "fallback": bool(fallback),
        "cached": bool(cached),
    }
    # the serving process's identity (none while the port runs one
    # process: the keys are then absent, as in the JAX package's lines)
    w = _process_worker_id()
    if w:
        entry["worker"] = w
    p = _process_pod_id()
    if p is not None:
        entry["pod_process"] = p
    if tenant:
        # multi-tenant serving (tenancy/): the tenant the front end
        # attributed this decision to; joins the per-tenant metric series
        # and the tenant-scoped fingerprint above
        entry["tenant"] = tenant
    if protocol:
        # the PDP front end (pdp/): the wire protocol this decision was
        # served over ("extauthz" / "batch"); absent for the native
        # webhook, whose lines keep their exact shape
        entry["protocol"] = protocol
    if error:
        entry["error"] = error[:500]
    return entry


__all__ = ["AuditLog", "audit_entry", "determining_policies"]
