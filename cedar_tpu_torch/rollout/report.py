"""Decision-diff accounting for shadow evaluation (the JAX package's
rollout/report.py).

One DiffReport gathers what an operator needs to judge a candidate policy
set before promotion: evaluation, shed and skip totals per path, counts
per diff kind, and a capped ring of exemplars of the diffing requests,
keyed by their canonical fingerprint (cache/fingerprint.py: the key the
decision cache, the request recorder and the audit log carry, so an
exemplar joins against recordings and cache entries directly).

Diff kinds:

  * ``allow_to_deny``: live allowed, the candidate denies (promoting
    breaks working callers);
  * ``deny_to_allow``: live denies, the candidate allows (a widening;
    verify it is intended);
  * ``decision_changed``: any other decision change (NoOpinion
    transitions, which change which authorizer of the apiserver's chain
    decides);
  * ``reason_changed``: the same decision with another reason (the
    deciding policies moved).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from ..cache.fingerprint import fingerprint_admission_request, fingerprint_attributes
from ..server import metrics

log = logging.getLogger(__name__)

DIFF_ALLOW_TO_DENY = "allow_to_deny"
DIFF_DENY_TO_ALLOW = "deny_to_allow"
DIFF_DECISION_CHANGED = "decision_changed"
DIFF_REASON_CHANGED = "reason_changed"

DIFF_KINDS = (
    DIFF_ALLOW_TO_DENY,
    DIFF_DENY_TO_ALLOW,
    DIFF_DECISION_CHANGED,
    DIFF_REASON_CHANGED,
)

# exemplar ring default: enough to show every diff class a bad candidate
# makes without letting an all-diffing candidate grow memory
DEFAULT_EXEMPLAR_CAP = 64


def classify_decision_diff(
    live_decision: str, live_reason: str, cand_decision: str, cand_reason: str
) -> Optional[str]:
    """The diff kind of one (live, candidate) result pair, or None when
    the candidate gives the live answer exactly. Decisions are the webhook
    decision strings ("allow" / "deny" / "no_opinion") for authorization
    and "allow" / "deny" for admission."""
    if live_decision != cand_decision:
        if live_decision == "allow" and cand_decision == "deny":
            return DIFF_ALLOW_TO_DENY
        if live_decision == "deny" and cand_decision == "allow":
            return DIFF_DENY_TO_ALLOW
        return DIFF_DECISION_CHANGED
    if live_reason != cand_reason:
        return DIFF_REASON_CHANGED
    return None


def _attribute(attributor, method: str, arg, what: str) -> Optional[dict]:
    """The attributor's {"live": ..., "candidate": ...} summaries for one
    diffing row; best-effort: a raising attributor gives none."""
    if attributor is None:
        return None
    try:
        return getattr(attributor, method)(arg)
    except Exception:  # noqa: BLE001 — attribution is best-effort
        log.exception("%s diff attribution failed", what)
        return None


def compare_authorization(
    report: "DiffReport",
    attributes,
    live,
    cand,
    publish_metrics: bool = False,
    attributor=None,
) -> Optional[str]:
    """Classify one (live, candidate) authorization pair of (decision,
    reason) tuples and record it into the report: the one compare and
    record step of the live shadow worker (rollout/shadow.py) and the
    offline cedar-shadow CLI, so their reports cannot drift.
    ``publish_metrics`` also feeds the cedar_shadow_* counters (live
    serving only: an offline replay leaves the process metrics alone).

    ``attributor`` (explain/ DiffAttributor) runs only on a diff: its
    determining-policy summaries ride the exemplar, so the report says why
    the decision changed. Matching pairs never pay for it."""
    if publish_metrics:
        metrics.record_shadow_evaluation("authorization")
    kind = classify_decision_diff(live[0], live[1], cand[0], cand[1])
    if kind is None:
        report.record_match("authorization")
        return None
    report.record_diff(
        "authorization",
        kind,
        fingerprint_attributes(attributes),
        {"decision": live[0], "reason": live[1]},
        {"decision": cand[0], "reason": cand[1]},
        attribution=_attribute(attributor, "authorization", attributes, "authorization"),
    )
    if publish_metrics:
        metrics.record_shadow_diff(kind)
    return kind


def compare_admission(
    report: "DiffReport",
    req,
    live,
    cand,
    publish_metrics: bool = False,
    attributor=None,
) -> Optional[str]:
    """The admission twin of compare_authorization: live and cand are
    (allowed: bool, message: str) pairs and req the parsed
    AdmissionRequest (its canonical fingerprint keys the exemplar)."""
    if publish_metrics:
        metrics.record_shadow_evaluation("admission")
    kind = classify_decision_diff(
        "allow" if live[0] else "deny", live[1], "allow" if cand[0] else "deny", cand[1]
    )
    if kind is None:
        report.record_match("admission")
        return None
    report.record_diff(
        "admission",
        kind,
        fingerprint_admission_request(req),
        {"allowed": live[0], "message": live[1]},
        {"allowed": cand[0], "message": cand[1]},
        attribution=_attribute(attributor, "admission", req, "admission"),
    )
    if publish_metrics:
        metrics.record_shadow_diff(kind)
    return kind


class DiffReport:
    """Thread-safe shadow-evaluation tallies and exemplar ring. The
    cedar_shadow_* metrics count across rollouts; a report starts afresh
    at each stage."""

    def __init__(self, exemplar_cap: int = DEFAULT_EXEMPLAR_CAP):
        self._lock = threading.Lock()
        self.started_at = time.time()
        self.evaluations: dict = {}  # path -> count
        self.matches: dict = {}  # path -> count
        self.diffs: dict = {}  # kind -> count
        self.shed: dict = {}  # path -> count
        self.skipped: dict = {}  # path -> count (unparseable / live errors)
        self.errors = 0  # candidate-side evaluation failures
        self._exemplars: deque = deque(maxlen=max(1, int(exemplar_cap)))

    # ------------------------------------------------------------ recording

    def record_match(self, path: str) -> None:
        with self._lock:
            self.evaluations[path] = self.evaluations.get(path, 0) + 1
            self.matches[path] = self.matches.get(path, 0) + 1

    def record_diff(self, path: str, kind: str, fingerprint: str, live, candidate,
                    attribution=None) -> None:
        """``attribution`` (optional): {"live": summary, "candidate":
        summary} from the explain plane (explain.attribution_summary), the
        policy that decided each side, joined into the exemplar."""
        with self._lock:
            self.evaluations[path] = self.evaluations.get(path, 0) + 1
            self.diffs[kind] = self.diffs.get(kind, 0) + 1
            exemplar = {
                "fingerprint": fingerprint,
                "path": path,
                "kind": kind,
                "live": live,
                "candidate": candidate,
            }
            if attribution:
                exemplar["attribution"] = attribution
            self._exemplars.append(exemplar)

    def record_shed(self, path: str) -> None:
        with self._lock:
            self.shed[path] = self.shed.get(path, 0) + 1

    def record_skipped(self, path: str) -> None:
        with self._lock:
            self.skipped[path] = self.skipped.get(path, 0) + 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    # ------------------------------------------------------------- reading

    @property
    def total_evaluations(self) -> int:
        with self._lock:
            return sum(self.evaluations.values())

    @property
    def total_diffs(self) -> int:
        with self._lock:
            return sum(self.diffs.values())

    def exemplars(self) -> list:
        with self._lock:
            return list(self._exemplars)

    def diff_fingerprints(self) -> set:
        """Distinct fingerprints of the exemplar ring: the offline join key
        against recordings (req-<endpoint>-<fingerprint>-*.json)."""
        with self._lock:
            return {e["fingerprint"] for e in self._exemplars}

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "started_at": self.started_at,
                "evaluations": dict(self.evaluations),
                "matches": dict(self.matches),
                "diffs": {k: self.diffs.get(k, 0) for k in DIFF_KINDS},
                "total_diffs": sum(self.diffs.values()),
                "shed": dict(self.shed),
                "skipped": dict(self.skipped),
                "candidate_errors": self.errors,
                "exemplars": list(self._exemplars),
            }

    def render_text(self) -> str:
        """Human-readable summary (the cedar-shadow CLI's default output)."""
        d = self.to_dict()
        lines = []
        total = sum(d["evaluations"].values())
        lines.append(
            f"# shadow evaluations: {total} "
            + " ".join(f"{p}={n}" for p, n in sorted(d["evaluations"].items()))
        )
        lines.append(
            "# diffs: " + (" ".join(f"{k}={n}" for k, n in d["diffs"].items() if n) or "none")
        )
        if d["skipped"]:
            lines.append(
                "# skipped: " + " ".join(f"{p}={n}" for p, n in sorted(d["skipped"].items()))
            )
        if d["candidate_errors"]:
            lines.append(f"# candidate errors: {d['candidate_errors']}")

        def _why(s: Optional[dict]) -> str:
            if not s:
                return "?"
            out = f"{s.get('effect') or '?'} {s.get('policyId') or '<none>'}"
            if s.get("clause") is not None:
                out += f"#clause{s['clause']}"
            if s.get("tier") is not None:
                out += f"@tier{s['tier']}"
            if s.get("fallback"):
                out += " (fallback)"
            return out

        for e in d["exemplars"]:
            lines.append(
                f"{e['fingerprint']}\t{e['path']}\t{e['kind']}\t"
                f"live={e['live']}\tcandidate={e['candidate']}"
            )
            attr = e.get("attribution")
            if attr:
                lines.append(
                    "  why: live=" + _why(attr.get("live"))
                    + " -> candidate=" + _why(attr.get("candidate"))
                )
        return "\n".join(lines)
