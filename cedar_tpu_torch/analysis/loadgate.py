"""Load-time enforcement of the static analysis, honoring
CedarConfig.validationMode:

  * ``strict``     — any blocking (error-severity) finding rejects the
                     whole load; the caller keeps serving its previous set
  * ``permissive`` — findings are annotated (logged + metrics) only
  * ``partial``    — only the offending policies are dropped from the
                     tiers handed to the compiler; the rest load

The gate also publishes the analysis metrics
(``cedar_policy_fastpath_lowerable{tier}`` and
``cedar_policy_analysis_findings_total{kind}``, server/metrics.py) so a
deploy's fastpath coverage is visible before the first latency regression.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

from ..apis.v1alpha1 import (
    VALIDATION_MODE_PARTIAL,
    VALIDATION_MODE_PERMISSIVE,
    VALIDATION_MODE_STRICT,
)
from ..compiler.lower import SchemaInfo
from .analyze import analyze_tiers
from .report import AnalysisReport, Finding

log = logging.getLogger(__name__)

VALIDATION_MODES = (
    VALIDATION_MODE_STRICT,
    VALIDATION_MODE_PERMISSIVE,
    VALIDATION_MODE_PARTIAL,
)


class AnalysisRejected(Exception):
    """Strict-mode load rejection; carries the report for diagnostics."""

    def __init__(self, report: AnalysisReport):
        blocking = report.blocking()
        super().__init__(
            f"policy-set analysis rejected the load ({len(blocking)} "
            "blocking finding(s)): "
            + "; ".join(f"[{f.code}] {f.location()}" for f in blocking[:5])
        )
        self.report = report


def publish_metrics(report: AnalysisReport) -> None:
    from ..server import metrics

    for tier, stats in report.tiers.items():
        metrics.set_fastpath_lowerable(tier, stats["lowerable"])
    for kind, n in report.counts().items():
        metrics.record_analysis_findings(kind, n)


def enforce(
    tiers: Sequence,
    mode: str,
    schema: Optional[SchemaInfo] = None,
    publish: bool = True,
) -> Tuple[List, AnalysisReport]:
    """Run the analyzer over the tiers and apply the validation mode.
    Returns (tiers to compile, report); raises AnalysisRejected in strict
    mode when blocking findings exist."""
    report = analyze_tiers(tiers, schema=schema)
    if publish:
        publish_metrics(report)
    for f in report.findings:
        level = {
            "error": logging.ERROR,
            "warning": logging.WARNING,
            "info": logging.DEBUG,
        }[f.severity]
        log.log(level, "analysis %s[%s] %s: %s", f.severity, f.code,
                f.location(), f.message)
    blocking = report.blocking()
    if not blocking or mode == VALIDATION_MODE_PERMISSIVE:
        return list(tiers), report
    if mode == VALIDATION_MODE_STRICT:
        raise AnalysisRejected(report)
    if mode == VALIDATION_MODE_PARTIAL:
        dropped = {(f.tier, f.policy_id) for f in blocking}
        out = []
        for tier_idx, ps in enumerate(tiers):
            keep = [
                p
                for p in ps.policies()
                if (tier_idx, p.policy_id) not in dropped
            ]
            if len(keep) == len(ps.policies()):
                out.append(ps)
            else:
                trimmed = type(ps)()
                for p in keep:
                    trimmed.add(p, policy_id=p.policy_id)
                out.append(trimmed)
        log.warning(
            "partial validation dropped %d policy(ies) from the compiled "
            "set: %s",
            len(dropped),
            ", ".join(sorted(pid for _t, pid in dropped)),
        )
        return out, report
    raise ValueError(f"unknown validation mode {mode!r}")


def check_object_policies(
    policies: Sequence, schema: Optional[SchemaInfo] = None
) -> List[Tuple[object, Optional[Finding]]]:
    """Per-object lowerability check for event-driven stores (the CRD
    store gates each Policy object at admission into the shared set —
    whole-set passes like shadowing need the full tier view and run at
    engine load instead). Returns [(policy, blocking finding | None)]."""
    from ..lang.authorize import PolicySet
    from .analyze import lint_lowerability, lower_all

    ps = PolicySet()
    for i, p in enumerate(policies):
        ps.add(p, policy_id=p.policy_id or f"policy{i}")
    infos = lower_all([ps], schema)
    blocking = {
        f.policy_id: f
        for f in lint_lowerability(infos)
        if f.severity == "error"
    }
    return [(p, blocking.get(p.policy_id)) for p in policies]
