"""Findings, severities, and the reason-code catalog.

Every finding carries a stable machine-readable ``code`` from REASONS so
operators can alert on codes (not message strings) and docs/analysis.md
can document each one once. Severities drive load-time enforcement
(loadgate.enforce): strict rejects on SEV_ERROR, partial drops only the
offending policies, permissive annotates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"

_SEV_RANK = {SEV_INFO: 0, SEV_WARNING: 1, SEV_ERROR: 2}


# code -> (kind, severity, fix hint). The operator-facing catalog; keep in
# sync with docs/analysis.md.
REASONS: Dict[str, Tuple[str, str, str]] = {
    # ---- TPU-lowerability (kind "fastpath") -----------------------------
    "clause_limit": (
        "fastpath",
        SEV_ERROR,
        "the condition's ordered-DNF expansion exceeds even the spillover "
        "ceiling (SPILL_MAX_CLAUSES) — a genuinely exponential alternation "
        "product; split the policy into several narrower policies or "
        "flatten nested ||/&& alternations",
    ),
    "literal_limit": (
        "fastpath",
        SEV_ERROR,
        "one evaluation path conjoins more literals than the spillover "
        "ceiling admits (SPILL_MAX_LITERALS); split the condition across "
        "several policies",
    ),
    "negated_opaque": (
        "fastpath",
        SEV_ERROR,
        "a negated (unless/!=/!) expression outside the host-guardable "
        "class (compiler/dyn.host_guardable) — its evaluation behavior is "
        "unproven; add `has` guards for every attribute it touches, or "
        "rewrite without the negation",
    ),
    "negated_untyped": (
        "fastpath",
        SEV_ERROR,
        "a negated typed test (like/</contains) on an attribute whose "
        "type neither the schema nor clause flow-typing proves, with "
        "TYPE_ERR guards disabled; guard with `is` to pin the entity "
        "type, or move the test out of unless/negation",
    ),
    "unlowerable": (
        "fastpath",
        SEV_ERROR,
        "the compiler could not lower this policy to the tensor IR; it "
        "evaluates on the per-row Python interpreter",
    ),
    "native_opaque": (
        "fastpath",
        SEV_WARNING,
        "a dynamic sub-expression outside the native template class "
        "(compiler/dyn.py); rows matching this policy's scope leave the "
        "native fast path and re-run on the Python path — restrict the "
        "expression to slot/constant contains/==/< forms",
    ),
    "hard_literal": (
        "fastpath",
        SEV_INFO,
        "the policy lowers, but carries host-evaluated sub-expressions "
        "(filled per request at encode time); fine at moderate QPS, "
        "consider constant/slot-template forms for the hottest tiers",
    ),
    "never_matches": (
        "fastpath",
        SEV_WARNING,
        "the condition simplifies to false on every request (contradictory "
        "literals); the policy is dead weight — delete it or fix the "
        "contradiction",
    ),
    # ---- shadowing / unreachability (kind "shadowing") ------------------
    "duplicate": (
        "shadowing",
        SEV_WARNING,
        "another policy with the same effect compiles to the identical "
        "clause set; delete one copy",
    ),
    "shadowed": (
        "shadowing",
        SEV_WARNING,
        "an earlier-tier policy matches every request this one matches, so "
        "the tier walk never reaches it; delete it or reorder tiers",
    ),
    "unreachable_permit": (
        "shadowing",
        SEV_WARNING,
        "a forbid in the same or an earlier tier covers every request this "
        "permit matches, so it can never cause an allow; delete it or "
        "narrow the forbid",
    ),
    "redundant_forbid": (
        "shadowing",
        SEV_WARNING,
        "another forbid in the same tier covers every request this one "
        "matches; delete one of them",
    ),
    "redundant_permit": (
        "shadowing",
        SEV_WARNING,
        "a broader permit in the same tier covers every request this one "
        "matches; delete the narrower policy",
    ),
    # ---- conflicts (kind "conflict") ------------------------------------
    "permit_forbid_overlap": (
        "conflict",
        SEV_INFO,
        "some requests satisfy both policies; the forbid wins there "
        "(forbid-overrides within a tier, tier order across tiers) — "
        "expected for carve-outs, worth reviewing otherwise",
    ),
    # ---- device-exact sweep (kind "coverage") ---------------------------
    # Codes emitted by analysis/semdiff.py. Their findings carry
    # provenance "exact" when the enumerated universe was exhaustive
    # over the encoding quotient (space.py), else "conservative" — the
    # same sampled-hint strength as the host analyzer's passes.
    "dead_rule": (
        "coverage",
        SEV_WARNING,
        "the policy-space sweep found no request in the typed universe "
        "that this policy matches (and none it errors on); it is dead "
        "weight — delete it or fix the condition",
    ),
    "shadowed_exact": (
        "shadowing",
        SEV_WARNING,
        "every universe request this policy matches is also matched by a "
        "policy that pre-empts it in the tier walk (earlier tier, "
        "same-tier forbid-overrides, or a same-effect cover); it never "
        "determines a decision — delete it or narrow the shadower",
    ),
    "oracle_disagreement": (
        "coverage",
        SEV_ERROR,
        "the compiled plane and the interpreter oracle disagreed on a "
        "sampled universe request — a compiler or encoder bug, not a "
        "policy problem; report it with the exemplar request",
    ),
    # ---- capacity (kind "capacity") -------------------------------------
    "clause_heavy": (
        "capacity",
        SEV_INFO,
        "the policy expands to many DNF rules, paying rule-table columns "
        "for each; prefer `in [..]` sets over ==-chains where possible",
    ),
    "spilled": (
        "capacity",
        SEV_INFO,
        "the ordered-DNF expansion exceeded the preferred packing budgets "
        "(MAX_CLAUSES rules or MAX_LITERALS per clause) and lowered via "
        "clause spillover — still device-served, but each extra rule is a "
        "packed matmul column; prefer `in [..]` sets over ==-chains to "
        "shrink the expansion",
    ),
}


@dataclass(frozen=True)
class Finding:
    code: str
    policy_id: str
    filename: str
    position: Tuple[int, int, int]  # offset, line, column
    tier: int
    message: str
    # policy ids this finding relates to (the shadower, the conflicting twin)
    related: Tuple[str, ...] = ()
    # "exact" when backed by a device-exact exhaustive sweep
    # (analysis/semdiff.py), "conservative" for the host analyzer's
    # may-miss/may-over-report passes and sampled sweep hints
    provenance: str = "conservative"

    @property
    def kind(self) -> str:
        return REASONS[self.code][0]

    @property
    def severity(self) -> str:
        return REASONS[self.code][1]

    @property
    def hint(self) -> str:
        return REASONS[self.code][2]

    def location(self) -> str:
        _off, line, col = self.position
        src = f"{self.filename}:{line}:{col}" if self.filename else f":{line}:{col}"
        return f"{src} tier {self.tier} `{self.policy_id}`"

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "kind": self.kind,
            "severity": self.severity,
            "policy": self.policy_id,
            "filename": self.filename,
            "position": {
                "offset": self.position[0],
                "line": self.position[1],
                "column": self.position[2],
            },
            "tier": self.tier,
            "message": self.message,
            "hint": self.hint,
            "related": list(self.related),
            "provenance": self.provenance,
        }


@dataclass
class AnalysisReport:
    findings: List[Finding] = field(default_factory=list)
    # per-tier {tier: {"policies": n, "lowerable": n, "fallback": n}}
    tiers: Dict[int, Dict[str, int]] = field(default_factory=dict)
    # lowerability-coverage rollup (analyze.coverage_summary): overall
    # fully-lowerable %, per-Unlowerable-code fallback counts, spillover
    # count — the burn-down dashboard's source of truth. /debug/analysis
    # joins the served-decision ranking
    # (cedar_fallback_decisions_total{code}) under "served_decisions".
    coverage: dict = field(default_factory=dict)
    capacity: dict = field(default_factory=dict)
    # pair-comparison budget ran out: shadowing/conflict coverage is partial
    truncated: bool = False
    # device-exact sweep summary (semdiff.SweepResult.to_dict) when the
    # CLI ran with --exact; {} otherwise. Always present in to_dict so
    # consumers (lifecycle, dashboards) can key on it unconditionally.
    sweep: dict = field(default_factory=dict)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def blocking(self) -> List[Finding]:
        """Findings that strict mode rejects on / partial mode drops for."""
        return self.by_severity(SEV_ERROR)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.code] = out.get(f.code, 0) + 1
        return out

    def at_or_above(self, severity: str) -> List[Finding]:
        rank = _SEV_RANK[severity]
        return [f for f in self.findings if _SEV_RANK[f.severity] >= rank]

    def to_dict(self) -> dict:
        return {
            "findings": [f.to_dict() for f in self.findings],
            "tiers": {str(t): dict(v) for t, v in sorted(self.tiers.items())},
            "coverage": self.coverage,
            "capacity": self.capacity,
            "truncated": self.truncated,
            "counts": self.counts(),
            "sweep": self.sweep,
        }

    def render_text(self) -> str:
        """Human-readable report (the CLI's default output)."""
        lines: List[str] = []
        order = {SEV_ERROR: 0, SEV_WARNING: 1, SEV_INFO: 2}
        for f in sorted(
            self.findings,
            key=lambda f: (order[f.severity], f.tier, f.filename, f.position),
        ):
            tag = f"{f.code}/exact" if f.provenance == "exact" else f.code
            lines.append(f"{f.severity}[{tag}] {f.location()}")
            lines.append(f"  {f.message}")
            lines.append(f"  hint: {f.hint}")
            if f.related:
                lines.append(f"  related: {', '.join(f.related)}")
        for t, stats in sorted(self.tiers.items()):
            lines.append(
                f"tier {t}: {stats['lowerable']}/{stats['policies']} policies "
                f"fastpath-lowerable, {stats['fallback']} interpreter-fallback"
            )
        cov = self.coverage
        if cov:
            line = (
                f"coverage: {cov['lowerable_pct']}% of {cov['policies']} "
                "policies fully lowerable"
            )
            if cov.get("fallback_codes"):
                served = cov.get("served_decisions") or {}
                per = ", ".join(
                    f"{code} x{n}"
                    + (
                        f" ({served[code]} served decisions)"
                        if code in served
                        else ""
                    )
                    for code, n in sorted(
                        cov["fallback_codes"].items(),
                        key=lambda kv: (-served.get(kv[0], 0), -kv[1], kv[0]),
                    )
                )
                line += f" — fallback by code: {per}"
            if cov.get("spilled"):
                line += f"; {cov['spilled']} spilled past packing budgets"
            lines.append(line)
        cap = self.capacity
        if cap:
            lines.append(
                "capacity: "
                f"{cap['n_rules']} rules in R={cap['R']} "
                f"({cap['rule_occupancy']:.0%} of bucket), "
                f"{cap['n_lits']} literals in L={cap['L']} "
                f"({cap['lit_occupancy']:.0%}), "
                f"{cap['table_rows']} activation-table rows "
                f"({cap['code_dtype']} codes), "
                f"{cap['vocab_entries']} vocab entries"
            )
            if cap.get("rule_headroom", 1) == 0 or cap.get("lit_headroom", 1) == 0:
                lines.append(
                    "  note: a bucket is exactly full — the next policy "
                    "added recompiles the device executables (bucket step)"
                )
        sw = self.sweep
        if sw:
            mode = "exhaustive" if sw.get("exact") else "stratified"
            orc = sw.get("oracle", {})
            lines.append(
                f"sweep: {sw.get('universe', {}).get('size', 0)} requests "
                f"({mode}), {len(sw.get('dead', ()))} dead, "
                f"{len(sw.get('shadowed', ()))} shadowed, "
                f"{len(sw.get('overlaps', ()))} overlapping pairs, oracle "
                f"{orc.get('disagreements', 0)}/{orc.get('sampled', 0)} "
                f"disagreements, {sw.get('seconds', 0)}s"
            )
        if self.truncated:
            lines.append(
                "note: pair-comparison budget exhausted; shadowing/conflict "
                "coverage is PARTIAL (raise --pair-budget for a full pass)"
            )
        if not self.findings:
            lines.insert(0, "no findings")
        return "\n".join(lines)
