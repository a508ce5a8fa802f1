"""Whole-policy-set static analysis, the JAX package's analysis/ for the
port: the lowerability lint, shadowing, permit/forbid conflicts and the
capacity report over the port's own compiler (analyze.py, with subsume.py
and report.py), the load-time gate that applies
CedarConfig.validationMode (loadgate.py), and the serving-partition prune
checks the incremental compiler imports (partition.py).

Entry points: analyze_tiers (the full report) and loadgate.enforce (the
serving path's gate). The shadowing and conflict passes give the JAX
package's findings, order and truncation exactly, at a fraction of its
cost (analyze.py, "pair passes").
"""

from .analyze import analyze_tiers
from .loadgate import (
    AnalysisRejected,
    check_object_policies,
    enforce,
)
from .partition import (
    PartitionSpec,
    lowered_never_matches,
    partition_report,
    quick_never_matches,
)
from .report import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
    AnalysisReport,
    Finding,
    REASONS,
)

__all__ = [
    "AnalysisRejected",
    "AnalysisReport",
    "Finding",
    "REASONS",
    "SEV_ERROR",
    "SEV_INFO",
    "SEV_WARNING",
    "PartitionSpec",
    "analyze_tiers",
    "check_object_policies",
    "enforce",
    "lowered_never_matches",
    "partition_report",
    "quick_never_matches",
]
