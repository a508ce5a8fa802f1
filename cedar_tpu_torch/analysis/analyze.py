"""The whole-policy-set analyzer: lowerability, shadowing, conflicts,
capacity — one pass over the compiler's lowered Clause representation.

analyze_tiers is pure host-side work (lowering + numpy packing, no jax):
safe to run at policy load time inside stores and in the CLI.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..compiler.ir import (
    CMP,
    ENTITY_IN,
    ENTITY_IN_ANY,
    EQ,
    EQ_ENTITY,
    HARD,
    HARD_ERR,
    HARD_OK,
    HAS,
    IN_SET,
    IS,
    Clause,
    ClauseLit,
    FallbackPolicy,
    Literal,
    LoweredPolicy,
    Unlowerable,
)
from ..compiler.lower import AUTHZ_SCHEMA_INFO, SchemaInfo, lower_policy
from ..lang.ast import FORBID, PERMIT, Policy
from ..lang.format import format_expr
from .report import AnalysisReport, Finding
from .subsume import (
    clause_key,
    clause_self_satisfiable,
    contradicts,
    covers,
)

# a policy whose DNF expansion reaches this many rules gets a capacity info
# finding (each rule is a packed matmul column)
CLAUSE_HEAVY = 32

# default cap on clause-pair comparisons for the quadratic passes
# (shadowing + conflicts); at MAX_CLAUSES=96 per policy this covers
# thousand-policy sets while bounding worst-case load-time cost. Exhaustion
# sets report.truncated — never a silent cap.
PAIR_BUDGET = 2_000_000


@dataclass
class PolicyInfo:
    """One policy's lowering outcome, either lowered or fallback."""

    policy: Policy
    tier: int
    lowered: Optional[LoweredPolicy] = None
    fallback: Optional[FallbackPolicy] = None

    @property
    def effect(self) -> str:
        return self.policy.effect


def lower_all(
    tiers: Sequence, schema: Optional[SchemaInfo] = None, opts=None
) -> List[PolicyInfo]:
    """Lower every policy of every tier individually, capturing the
    Unlowerable reason instead of aggregating like lower_tiers does.
    ``opts`` (lower.LowerOptions; None = the full compiler) selects the
    compiler's feature gates — bench.py --coverage measures LEGACY_OPTS
    vs the default compiler on the same corpus through this entry
    point."""
    schema = schema or AUTHZ_SCHEMA_INFO
    infos: List[PolicyInfo] = []
    for tier_idx, ps in enumerate(tiers):
        for policy in ps.policies():
            try:
                lp = lower_policy(policy, tier_idx, schema, opts)
                infos.append(PolicyInfo(policy, tier_idx, lowered=lp))
            except Unlowerable as e:
                infos.append(
                    PolicyInfo(
                        policy,
                        tier_idx,
                        fallback=FallbackPolicy(
                            policy=policy,
                            tier=tier_idx,
                            reason=str(e),
                            code=e.code,
                            construct=e.construct,
                        ),
                    )
                )
    return infos


def _finding(code: str, info: PolicyInfo, message: str, related=()) -> Finding:
    p = info.policy
    return Finding(
        code=code,
        policy_id=p.policy_id,
        filename=p.filename,
        position=p.position,
        tier=info.tier,
        message=message,
        related=tuple(related),
    )


def _hard_exprs(lp: LoweredPolicy) -> List[object]:
    """Distinct interpreter-evaluated sub-expressions in a lowered policy."""
    seen: Dict[int, object] = {}
    for clause in list(lp.clauses) + list(lp.error_clauses):
        for cl in clause:
            if cl.lit.kind in (HARD, HARD_OK, HARD_ERR):
                seen[id(cl.lit.expr)] = cl.lit.expr
    # dedupe by formatted text: one expr may appear as several AST objects
    out: Dict[str, object] = {}
    for e in seen.values():
        out[format_expr(e)] = e
    return list(out.values())


def lint_lowerability(infos: List[PolicyInfo]) -> List[Finding]:
    from ..compiler.dyn import dyn_spec

    findings: List[Finding] = []
    for info in infos:
        if info.fallback is not None:
            fb = info.fallback
            msg = fb.reason
            if fb.construct is not None:
                msg += f" — offending construct: `{format_expr(fb.construct)}`"
            findings.append(_finding(fb.code, info, msg))
            continue
        lp = info.lowered
        # a clause the simplifier kept may still be self-contradictory in
        # ways only the implication engine sees (e.g. two different
        # positive equalities on one slot)
        sat_clauses = [c for c in lp.clauses if clause_self_satisfiable(c)]
        if not sat_clauses and not lp.error_clauses:
            findings.append(
                _finding(
                    "never_matches",
                    info,
                    "every evaluation path is statically contradictory; the "
                    "policy can never match or error",
                )
            )
            continue
        hard = _hard_exprs(lp)
        opaque = [e for e in hard if dyn_spec(e) is None]
        if opaque:
            shown = ", ".join(f"`{format_expr(e)}`" for e in opaque[:3])
            findings.append(
                _finding(
                    "native_opaque",
                    info,
                    f"{len(opaque)} sub-expression(s) outside the native "
                    f"template class: {shown}",
                )
            )
        elif hard:
            shown = ", ".join(f"`{format_expr(e)}`" for e in hard[:3])
            findings.append(
                _finding(
                    "hard_literal",
                    info,
                    f"{len(hard)} host-evaluated sub-expression(s): {shown}",
                )
            )
        if lp.spilled:
            findings.append(
                _finding(
                    "spilled",
                    info,
                    "lowered past the preferred packing budgets "
                    f"({len(lp.clauses)} DNF rules, widest clause "
                    f"{max((len(c) for c in lp.clauses), default=0)} "
                    "literals) via clause spillover — device-served, but "
                    "paying extra rule columns",
                )
            )
        elif len(lp.clauses) >= CLAUSE_HEAVY:
            findings.append(
                _finding(
                    "clause_heavy",
                    info,
                    f"expands to {len(lp.clauses)} DNF rules "
                    f"(+{len(lp.error_clauses)} error rules)",
                )
            )
    return findings


class _Budget:
    def __init__(self, n: int):
        self.left = n
        self.exhausted = False

    def take(self, n: int) -> bool:
        if self.left < n:
            self.exhausted = True
            return False
        self.left -= n
        return True


# ---------------------------------------------------------------- pair passes
#
# find_shadowing and find_conflicts give exactly the findings, order and
# ``truncated`` of the plain quadratic loops they replace (a victim takes
# the first shadower in list order that covers it; every tested pair is
# charged before its test; a failed charge consumes nothing, ends the
# victim in shadowing and the whole pass in conflicts). What changes is
# the cost of getting there:
#
#   * the charges of one victim's eligible shadowers, in list order, are
#     a prefix sum, so the pair where the budget runs out is one binary
#     search, not one charge per pair;
#   * a shadower is tested with subsume.covers only when an index says it
#     can cover: clause_subsumes(s, v) needs every literal of s to be
#     implied by a literal of v, and subsume.implies relates a literal
#     only to literals that share one token with it (_need_token,
#     _give_tokens), so a shadower clause with a token its victim clause
#     lacks cannot subsume it;
#   * clause_pair_satisfiable is split into each clause's own
#     satisfiability (once per clause) and the cross pairs, and a cross
#     pair is tested with subsume.contradicts (once per literal pair) only
#     when the same tokens relate it.

_ENTITY_KINDS = frozenset((IS, EQ_ENTITY, ENTITY_IN, ENTITY_IN_ANY))


def _need_token(lit: Literal, negated: bool) -> tuple:
    """A token that every literal ``a`` with ``implies(a, (lit, negated))``
    gives (_give_tokens), read off subsume.implies rule by rule: a
    positive equality, a negated presence or membership test, and every
    kind implies knows nothing else about, follow only from the identical
    literal; the other value tests follow from a test on the same slot
    (a presence test: on a path it prefixes), the other entity tests from
    a test on the same variable."""
    kind = lit.kind
    if kind == EQ:
        return ("s", lit.slot) if negated else ("k", lit.key())
    if kind in (IN_SET, CMP):
        return ("s", lit.slot)
    if kind == HAS:
        return ("k", lit.key()) if negated else ("s", lit.slot)
    if kind == EQ_ENTITY:
        return ("v", lit.var) if negated else ("k", lit.key())
    if kind == IS:
        return ("v", lit.var)
    if kind in (ENTITY_IN, ENTITY_IN_ANY):
        return ("k", lit.key()) if negated else ("v", lit.var)
    return ("k", lit.key())


def _give_tokens(lit: Literal) -> List[tuple]:
    """The tokens a literal gives, whatever its sign: its identity, its
    slot and every prefix of the slot's path, and its variable when it is
    an entity test."""
    toks = [("k", lit.key()), ("s", lit.slot)]
    if lit.kind in _ENTITY_KINDS:
        toks.append(("v", lit.var))
    if lit.slot is not None:
        root, path = lit.slot
        toks.extend(("s", (root, path[:k])) for k in range(len(path)))
    return toks


class _Tokens:
    """Interns tokens to ints, and memoizes each literal's tokens per
    literal object and per (literal key, sign)."""

    def __init__(self):
        self._ids: Dict[tuple, int] = {}
        self._by_key: Dict[tuple, tuple] = {}
        self._by_obj: Dict[int, tuple] = {}  # id(ClauseLit) -> tokens
        self._keep: list = []  # the ClauseLits keyed by id() stay alive

    def _id(self, tok: tuple) -> int:
        i = self._ids.get(tok)
        if i is None:
            i = self._ids[tok] = len(self._ids)
        return i

    def literal(self, cl: ClauseLit) -> tuple:
        """(needed token, needed token of the negation, given tokens)."""
        got = self._by_obj.get(id(cl))
        if got is None:
            lit = cl.lit
            key = (lit.key(), cl.negated)
            got = self._by_key.get(key)
            if got is None:
                got = self._by_key[key] = (
                    self._id(_need_token(lit, cl.negated)),
                    self._id(_need_token(lit, not cl.negated)),
                    frozenset(self._id(t) for t in _give_tokens(lit)),
                )
            self._by_obj[id(cl)] = got
            self._keep.append(cl)
        return got

    def needs(self, clause: Clause) -> frozenset:
        return frozenset(self.literal(cl)[0] for cl in clause)

    def gives(self, clause: Clause) -> frozenset:
        return frozenset().union(*(self.literal(cl)[2] for cl in clause))


class _CoverIndex:
    """Which policies can cover a victim's clauses. Each shadower clause
    is filed under the one of its needed tokens that the fewest clauses
    give; a victim clause gathers the files of the tokens it gives and
    keeps the clauses whose every needed token it gives."""

    def __init__(self, lowered: List[PolicyInfo]):
        tokens = _Tokens()
        gives = [[tokens.gives(c) for c in i.lowered.clauses] for i in lowered]
        freq: Dict[int, int] = {}
        for per_policy in gives:
            for g in per_policy:
                for t in g:
                    freq[t] = freq.get(t, 0) + 1
        self._gives = gives
        self._files: Dict[int, list] = {}
        self._universal: set = set()  # owners of a clause with no literal
        for si, info in enumerate(lowered):
            for c in info.lowered.clauses:
                need = tokens.needs(c)
                if not need:
                    self._universal.add(si)
                    continue
                rare = min(need, key=lambda t: (freq.get(t, 0), t))
                self._files.setdefault(rare, []).append((si, need))

    def candidates(self, vi: int) -> List[int]:
        """The policies other than ``vi``, in list order, that have for
        every clause of policy ``vi`` a clause the index does not rule
        out: the only ones subsume.covers can accept as its shadower."""
        owners: Optional[set] = None
        for g in self._gives[vi]:
            found = set(self._universal)
            for t in g:
                for si, need in self._files.get(t, ()):
                    if si not in found and need <= g:
                        found.add(si)
            owners = found if owners is None else owners & found
            if not owners:
                return []
        owners.discard(vi)
        return sorted(owners)


def find_shadowing(
    infos: List[PolicyInfo], budget: Optional[_Budget] = None
) -> List[Finding]:
    """Policies that provably never change any decision.

    Soundness (what makes every finding differentially verifiable):
      * only LOWERED policies are eligible, and a victim with error
        clauses requires the shadower to ERROR on every request the
        victim errors on too — an error is an explicit tier-stop signal,
        so removing a policy may only happen when its every signal
        (match AND error) is duplicated by the shadower;
      * the shadower must match every request the victim matches
        (clause-set cover over error-exact hardened clauses);
      * cross-tier: ANY earlier-tier cover makes the victim unreachable
        (the earlier tier emits an explicit signal and the walk stops
        before the victim's tier is consulted);
      * same-tier: a forbid cover silences both forbids (redundant) and
        permits (forbid-overrides); a permit cover only silences permits.

    Budget: each victim charges its eligible shadowers in list order,
    ``|s.clauses|·|v.clauses| + (|s.clauses| + |s.errors|)·|v.errors|``
    before testing each, and stops at its first cover; a charge larger
    than what is left consumes nothing, sets ``exhausted`` and ends the
    victim (the next victim may still afford its own charges)."""
    budget = budget or _Budget(PAIR_BUDGET)
    findings: List[Finding] = []
    lowered = [i for i in infos if i.lowered is not None and i.lowered.clauses]
    if not lowered:
        return findings
    tier = np.array([i.tier for i in lowered], dtype=np.int64)
    forbid = np.array([i.effect == FORBID for i in lowered])
    permit = np.array([i.effect == PERMIT for i in lowered])
    n_cl = np.array([len(i.lowered.clauses) for i in lowered], dtype=np.int64)
    n_all = n_cl + np.array(
        [len(i.lowered.error_clauses) for i in lowered], dtype=np.int64
    )
    classes: dict = {}  # (tier, effect) -> eligible shadowers, prefix sums
    index: Optional[_CoverIndex] = None
    for vi, victim in enumerate(lowered):
        vclauses = victim.lowered.clauses
        verrors = victim.lowered.error_clauses
        cls = classes.get((victim.tier, victim.effect))
        if cls is None:
            same = tier == victim.tier
            if victim.effect == PERMIT:
                same &= forbid | permit
            else:
                same &= forbid
            elig = np.flatnonzero((tier < victim.tier) | same)
            cls = classes[(victim.tier, victim.effect)] = (
                elig, np.cumsum(n_cl[elig]), np.cumsum(n_all[elig]), {},
            )
        elig, cum_cl, cum_all, combs = cls
        nv, ne = len(vclauses), len(verrors)
        comb = combs.get((nv, ne))
        if comb is None:
            # charge of the first k+1 eligible shadowers, victim included
            comb = combs[(nv, ne)] = nv * cum_cl + ne * cum_all
        pos = int(np.searchsorted(elig, vi))
        in_elig = pos < len(elig) and elig[pos] == vi
        own = int(nv * n_cl[vi] + ne * n_all[vi]) if in_elig else 0

        def spent(k: int) -> int:
            """Charged for the eligible shadowers at positions <= k (the
            victim itself is never charged)."""
            if k < 0:
                return 0
            return int(comb[k]) - (own if k >= pos else 0)

        # cut: the first position whose charge no longer fits
        left = budget.left
        m = len(elig)
        if left >= spent(m - 1):
            cut = m
        else:
            cut = int(np.searchsorted(comb, left, side="right"))
            if cut >= pos:
                cut = int(np.searchsorted(comb, left + own, side="right"))
        hit: Optional[tuple] = None
        if cut > (1 if in_elig and pos < cut else 0):  # a pair to test
            if index is None:
                index = _CoverIndex(lowered)
            for si in index.candidates(vi):
                k = int(np.searchsorted(elig, si))
                if k >= cut:
                    break
                if k == len(elig) or elig[k] != si:
                    continue  # not eligible: never tested, never charged
                shadower = lowered[si]
                if not covers(shadower.lowered.clauses, vclauses):
                    continue
                # the victim's ERROR signal must be duplicated too:
                # whenever the victim errors, the shadower must error or
                # match on the same request — otherwise deleting the
                # victim could silently resume a tier descent its error
                # used to stop
                s_all = shadower.lowered.clauses + shadower.lowered.error_clauses
                if verrors and not covers(s_all, verrors):
                    continue
                hit = (k, shadower)
                break
        if hit is None:
            budget.left -= spent(cut - 1)
            if cut < m:
                budget.exhausted = True
            continue
        k, shadower = hit
        budget.left -= spent(k)
        same_tier = shadower.tier == victim.tier
        vkeys = frozenset(clause_key(c) for c in vclauses)
        skeys = frozenset(clause_key(c) for c in shadower.lowered.clauses)
        if skeys == vkeys and shadower.effect == victim.effect:
            code = "duplicate"
        elif not same_tier:
            code = "shadowed"
        elif victim.effect == PERMIT and shadower.effect == FORBID:
            code = "unreachable_permit"
        elif victim.effect == FORBID:
            code = "redundant_forbid"
        else:  # same tier, permit covered by a broader permit
            code = "redundant_permit"
        where = "the same tier" if same_tier else f"tier {shadower.tier}"
        findings.append(
            _finding(
                code,
                victim,
                f"every request this {victim.effect} matches is already "
                f"matched by {shadower.effect} "
                f"`{shadower.policy.policy_id}` in {where}; deleting it "
                "changes no decision",
                related=(shadower.policy.policy_id,),
            )
        )
    return findings


class _PairSat:
    """clause_pair_satisfiable(a, b) as self-satisfiable(a) and
    self-satisfiable(b) and no contradicting cross pair; a cross pair
    (x, y) can contradict only when one of them needs, negated, a token
    the other gives (contradicts(x, y) = implies(x, ¬y) or implies(y,
    ¬x))."""

    def __init__(self):
        self.tokens = _Tokens()
        self._clauses: Dict[int, tuple] = {}
        self._contra: Dict[tuple, bool] = {}
        self._keep: list = []

    def _clause(self, c: Clause) -> tuple:
        got = self._clauses.get(id(c))
        if got is None:
            by_neg: Dict[int, list] = {}  # negated need -> literals
            by_give: Dict[int, list] = {}  # given token -> literals
            for cl in c:
                _need, neg, gives = self.tokens.literal(cl)
                by_neg.setdefault(neg, []).append(cl)
                for t in gives:
                    by_give.setdefault(t, []).append(cl)
            got = (clause_self_satisfiable(c), by_neg, by_give)
            self._clauses[id(c)] = got
            self._keep.append(c)
        return got

    def _contradicts(self, x: ClauseLit, y: ClauseLit) -> bool:
        key = (id(x), id(y))
        got = self._contra.get(key)
        if got is None:
            got = self._contra[key] = contradicts(x, y)
        return got

    def satisfiable(self, a: Clause, b: Clause) -> bool:
        sat_a, neg_a, give_a = self._clause(a)
        if not sat_a:
            return False
        sat_b, neg_b, give_b = self._clause(b)
        if not sat_b:
            return False
        # x of a, y of b: implies(x, ¬y) needs y's negated token among
        # x's, implies(y, ¬x) the other way round
        for t in neg_b.keys() & give_a.keys():
            for y in neg_b[t]:
                for x in give_a[t]:
                    if self._contradicts(x, y):
                        return False
        for t in neg_a.keys() & give_b.keys():
            for x in neg_a[t]:
                for y in give_b[t]:
                    if self._contradicts(x, y):
                        return False
        return True


def find_conflicts(
    infos: List[PolicyInfo],
    budget: Optional[_Budget] = None,
    shadow_ids: Optional[frozenset] = None,
) -> List[Finding]:
    """permit/forbid pairs with a satisfiable clause intersection where the
    forbid decides (same tier: forbid-overrides; earlier tier: the walk
    stops there). Pairs whose permit is already reported unreachable are
    skipped — the shadowing finding subsumes the conflict.

    Budget: each (permit, forbid) pair in order charges
    ``|p.clauses|·|f.clauses|`` before its test; the first charge larger
    than what is left consumes nothing, sets ``exhausted`` and ends the
    pass."""
    budget = budget or _Budget(PAIR_BUDGET)
    shadow_ids = shadow_ids or frozenset()
    findings: List[Finding] = []
    lowered = [i for i in infos if i.lowered is not None and i.lowered.clauses]
    permits = [i for i in lowered if i.effect == PERMIT]
    forbids = [i for i in lowered if i.effect == FORBID]
    if not permits or not forbids:
        return findings
    f_tier = np.array([f.tier for f in forbids], dtype=np.int64)
    f_cl = np.array([len(f.lowered.clauses) for f in forbids], dtype=np.int64)
    by_tier: dict = {}  # permit tier -> eligible forbids, their clause prefix sums
    sat = _PairSat()
    for p in permits:
        if p.policy.policy_id in shadow_ids:
            continue
        got = by_tier.get(p.tier)
        if got is None:
            elig = np.flatnonzero(f_tier <= p.tier)  # later-tier forbids never win
            got = by_tier[p.tier] = (elig, np.cumsum(f_cl[elig]))
        elig, cum_cl = got
        if not len(elig):
            continue
        comb = len(p.lowered.clauses) * cum_cl
        left = budget.left
        cut = len(elig) if left >= int(comb[-1]) else int(
            np.searchsorted(comb, left, side="right"))
        for fi in elig[:cut].tolist():
            f = forbids[fi]
            if not any(
                sat.satisfiable(pc, fc)
                for pc in p.lowered.clauses
                for fc in f.lowered.clauses
            ):
                continue
            where = (
                "the same tier (forbid overrides)"
                if f.tier == p.tier
                else f"earlier tier {f.tier} (the walk stops there)"
            )
            findings.append(
                _finding(
                    "permit_forbid_overlap",
                    p,
                    "requests can satisfy both this permit and forbid "
                    f"`{f.policy.policy_id}` in {where}; those requests "
                    "are denied",
                    related=(f.policy.policy_id,),
                )
            )
        budget.left -= int(comb[cut - 1]) if cut else 0
        if cut < len(elig):
            budget.exhausted = True
            return findings
    return findings


def capacity_report(infos: List[PolicyInfo], n_tiers: int) -> dict:
    """Predicted device-table cost of the set, from the same pack() the
    engine uses — operators see slot-table/vocab growth and packing-bucket
    occupancy BEFORE a deploy, not from a production latency regression."""
    from ..compiler.ir import CompiledPolicies
    from ..compiler.pack import _bucket, pack

    compiled = CompiledPolicies(n_tiers=max(n_tiers, 1))
    for i in infos:
        if i.lowered is not None:
            compiled.lowered.append(i.lowered)
        else:
            compiled.fallback.append(i.fallback)
    packed = pack(compiled)
    vocab_entries = (
        len(packed.table.type_vocab)
        + len(packed.table.uid_vocab)
        + len(packed.table.anc_vocab)
        + sum(len(v) for v in packed.table.scalar_vocab.values())
    )
    per_policy = []
    for i in infos:
        if i.lowered is None:
            continue
        lp = i.lowered
        lits = {
            cl.lit.key() for c in lp.clauses + lp.error_clauses for cl in c
        }
        slots = {
            cl.lit.slot
            for c in lp.clauses + lp.error_clauses
            for cl in c
            if cl.lit.slot is not None
        }
        per_policy.append(
            {
                "policy": i.policy.policy_id,
                "tier": i.tier,
                "rules": len(lp.clauses),
                "error_rules": len(lp.error_clauses),
                "literals": len(lits),
                "slots": len(slots),
                "spilled": lp.spilled,
            }
        )
    return {
        "n_rules": packed.n_rules,
        "n_lits": packed.n_lits,
        "L": packed.L,
        "R": packed.R,
        "rule_occupancy": packed.n_rules / packed.R,
        "lit_occupancy": packed.n_lits / packed.L,
        "rule_headroom": packed.R - packed.n_rules,
        "lit_headroom": packed.L - packed.n_lits,
        "next_rule_bucket": _bucket(packed.R + 1),
        "table_rows": packed.table.n_rows_real,
        "code_dtype": packed.table.code_dtype.__name__,
        "n_slots": packed.table.n_slots,
        "vocab_entries": vocab_entries,
        "gate_rules": int(packed.has_gate),
        "native_opaque_policies": packed.native_opaque,
        "fallback_policies": len(compiled.fallback),
        "per_policy": per_policy,
    }


def coverage_summary(infos: List[PolicyInfo]) -> dict:
    """The lowerability-coverage rollup (ROADMAP item 3 burn-down): %
    of policies fully lowerable, per-Unlowerable-code fallback counts,
    and the spillover count. /debug/analysis joins the served-traffic
    ranking (cedar_fallback_decisions_total{code}) onto this so the next
    burn-down target is one glance away; the CLI prints it standalone."""
    n = len(infos)
    by_code: Dict[str, int] = {}
    spilled = 0
    for i in infos:
        if i.fallback is not None:
            code = i.fallback.code or "unlowerable"
            by_code[code] = by_code.get(code, 0) + 1
        elif i.lowered.spilled:
            spilled += 1
    n_fallback = sum(by_code.values())
    return {
        "policies": n,
        "lowerable": n - n_fallback,
        "lowerable_pct": round(100.0 * (n - n_fallback) / n, 2) if n else 100.0,
        "fallback_codes": dict(sorted(by_code.items())),
        "spilled": spilled,
    }


def analyze_tiers(
    tiers: Sequence,
    schema: Optional[SchemaInfo] = None,
    pair_budget: int = PAIR_BUDGET,
    capacity: bool = True,
    opts=None,
) -> AnalysisReport:
    """Analyze a whole tiered policy set (list of PolicySet, tier order).

    Returns the full report: lowerability findings for every policy,
    shadowing/unreachability, permit/forbid conflicts, per-tier
    lowerability stats, the lowerability-coverage summary, and (unless
    capacity=False) the static capacity report."""
    infos = lower_all(tiers, schema, opts)
    report = AnalysisReport()
    report.coverage = coverage_summary(infos)
    report.findings.extend(lint_lowerability(infos))
    budget = _Budget(pair_budget)
    shadow_findings = find_shadowing(infos, budget)
    report.findings.extend(shadow_findings)
    shadow_ids = frozenset(
        f.policy_id for f in shadow_findings if f.code == "unreachable_permit"
    )
    report.findings.extend(find_conflicts(infos, budget, shadow_ids))
    report.truncated = budget.exhausted
    for tier_idx in range(len(tiers)):
        tier_infos = [i for i in infos if i.tier == tier_idx]
        n_fallback = sum(1 for i in tier_infos if i.fallback is not None)
        report.tiers[tier_idx] = {
            "policies": len(tier_infos),
            "lowerable": len(tier_infos) - n_fallback,
            "fallback": n_fallback,
        }
    if capacity:
        report.capacity = capacity_report(infos, len(tiers))
    return report
