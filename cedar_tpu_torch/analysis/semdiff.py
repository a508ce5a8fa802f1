"""Device-exact policy-space sweep: dead rules, shadowing, overlap maps
and semantic diff, by pushing the enumerated request universe
(analysis/space.py) through the compiled plane (a copy of the JAX
package's analysis/semdiff.py over the port's compiler and engine).

Where analysis/subsume.py is deliberately conservative (its subsumption
may MISS covers and its satisfiability may report True for an empty
intersection), this module brute-forces the question: every request in
the universe is encoded with the production encoder
(compiler/table.encode_request_codes) and scored against the packed
rule matrix, so a verdict is a statement about actual plane behaviour.
When the universe is exhaustive over the encoding quotient the verdict
is **exact**; otherwise it is a sampled refinement and keeps
``conservative`` provenance. Every sweep cross-checks a seeded slice of
its universe against the interpreter oracle (lang/authorize.py).

Pure host-side numpy by default (safe in CLIs and gates); pass a loaded
``TorchPolicyEngine`` (with ``packed=engine._compiled.packed``) to score
the rule bitsets on the engine's device instead, through
``match_bits_arrays`` (the plain float bits product, as the JAX engine's
is XLA): the same integers, byte for byte.
"""

from __future__ import annotations

import fnmatch
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.ir import CompiledPolicies
from ..compiler.lower import AUTHZ_SCHEMA_INFO, SchemaInfo
from ..compiler.pack import (
    ERROR_IDX,
    FORBID_IDX,
    GROUPS_PER_TIER,
    PERMIT_IDX,
    PackedPolicySet,
    pack,
)
from ..compiler.table import encode_request_codes
from ..explain.attribution import _groups_from_sat, fallback_outcomes
from ..lang.authorize import ALLOW, DENY
from ..lang.values import CedarRecord, CedarSet, EntityUID
from .analyze import lower_all
from .space import Universe, enumerate_universe

# cap on reported exemplar-bearing findings; counts are never capped
EXEMPLAR_CAP = 200


# ---------------------------------------------------------------------------
# compile + encode


def pack_tiers(
    tiers: Sequence[Any], schema: Optional[SchemaInfo] = None
) -> PackedPolicySet:
    """Lower + pack ``tiers`` (PolicySets) exactly like the engine load
    path, keeping per-policy fallback outcomes instead of failing."""
    infos = lower_all(tiers, schema or AUTHZ_SCHEMA_INFO)
    compiled = CompiledPolicies(n_tiers=max(len(list(tiers)), 1))
    for i in infos:
        if i.lowered is not None:
            compiled.lowered.append(i.lowered)
        else:
            compiled.fallback.append(i.fallback)
    return pack(compiled)


def encode_universe(
    packed: PackedPolicySet, universe: Universe
) -> Tuple[np.ndarray, List[List[int]]]:
    """Encode every universe request with the production encoder:
    (codes [n, n_slots] int32, extras ragged lists of literal ids)."""
    n = universe.size
    n_slots = packed.table.n_slots
    codes_arr = np.zeros((n, n_slots), dtype=np.int32)
    extras_list: List[List[int]] = []
    for i, (entities, request) in enumerate(universe.items):
        codes, extras = encode_request_codes(
            packed.plan, packed.table, entities, request
        )
        codes_arr[i, : len(codes)] = codes
        extras_list.append(extras)
    return codes_arr, extras_list


def _host_sat_matrix(
    packed: PackedPolicySet, codes_arr: np.ndarray, extras_list: List[List[int]]
) -> np.ndarray:
    """[n, n_rules] bool — numpy twin of the device plane, batched.

    Sparse per-request scoring: a request activates a few dozen
    literals, so the score is the column-sum of those rows of W rather
    than a dense [n, L] x [L, R] matmul."""
    n = codes_arr.shape[0]
    rows = packed.table.rows
    W = packed.W
    thresh = packed.thresh
    sat = np.zeros((n, packed.n_rules), dtype=bool)
    row_lids: Dict[int, np.ndarray] = {}
    for i in range(n):
        parts: List[np.ndarray] = []
        for c in codes_arr[i]:
            c = int(c)
            if not c:
                continue
            lids = row_lids.get(c)
            if lids is None:
                lids = np.nonzero(rows[c])[0]
                row_lids[c] = lids
            parts.append(lids)
        extras = [e for e in extras_list[i] if 0 <= e < packed.L]
        if extras:
            parts.append(np.asarray(extras, dtype=np.int64))
        if not parts:
            continue
        active = np.unique(np.concatenate(parts))
        scores = W[active].sum(axis=0, dtype=np.int32)
        sat[i] = (scores.astype(np.float64) >= thresh)[: packed.n_rules]
    return sat


def _engine_sat_matrix(
    engine: Any,
    packed: PackedPolicySet,
    codes_arr: np.ndarray,
    extras_list: List[List[int]],
) -> np.ndarray:
    """Route scoring through the engine's rule-bitset product on its
    device. ``packed`` is the pack the engine's compiled set was built
    from: the bitsets' columns are its rules. The port has no mesh, so no
    column map: column r is rule r."""
    cs = engine._compiled
    if cs is None:
        raise RuntimeError("sweep: the engine has no policy set loaded")
    n = codes_arr.shape[0]
    max_k = max(1, max((len(e) for e in extras_list), default=1))
    # the plane's own width pads the extras (an index past every literal)
    extras_arr = np.full((n, max_k), cs.L, dtype=np.int32)
    for i, ex in enumerate(extras_list):
        if ex:
            extras_arr[i, : len(ex)] = ex
    bits = engine.match_bits_arrays(codes_arr, extras_arr, cs=cs)
    # whole-matrix decode of the rule-bitset wire format (the per-row
    # twin is attribution.sat_from_bits; a 10k-rule x 4k-request sweep
    # cannot afford n python-level unpack calls)
    unpacked = np.unpackbits(
        np.ascontiguousarray(bits).view(np.uint8).reshape(n, -1),
        axis=1,
        bitorder="little",
    )
    return unpacked[:, : packed.n_rules].astype(bool)


def sat_matrix(
    packed: PackedPolicySet,
    universe: Universe,
    engine: Any = None,
) -> np.ndarray:
    codes_arr, extras_list = encode_universe(packed, universe)
    if engine is not None:
        return _engine_sat_matrix(engine, packed, codes_arr, extras_list)
    return _host_sat_matrix(packed, codes_arr, extras_list)


# ---------------------------------------------------------------------------
# decisions


def plane_decision(
    packed: PackedPolicySet, sat: np.ndarray, entities, request
) -> Tuple[str, Optional[int]]:
    """(decision, deciding tier) — the explain plane's tier walk
    (explain/attribution.build_explanation) without document rendering:
    per tier, deny wins, then allow, then errors stop the walk with a
    deny; fallback policies merge via the interpreter."""
    groups = _groups_from_sat(packed, sat)
    fb_allow, fb_deny, fb_errors = fallback_outcomes(packed, entities, request)
    for t in range(packed.n_tiers):
        base = t * GROUPS_PER_TIER
        deny = bool(groups.get(base + FORBID_IDX)) or bool(fb_deny[t])
        allow = bool(groups.get(base + PERMIT_IDX)) or bool(fb_allow[t])
        errors = bool(groups.get(base + ERROR_IDX)) or bool(fb_errors[t])
        if deny:
            return DENY, t
        if allow:
            return ALLOW, t
        if errors:
            return DENY, t
    return DENY, None


def interpreter_decision(tiers: Sequence[Any], entities, request) -> str:
    """The oracle: per-tier interpreter walk (reasons stop the walk with
    the tier's decision; errors stop it with a deny; default deny)."""
    for ps in tiers:
        decision, diag = ps.is_authorized(entities, request)
        if diag.reasons:
            return decision
        if diag.errors:
            return DENY
    return DENY


# ---------------------------------------------------------------------------
# exemplar rendering


def _value_doc(v: Any) -> Any:
    if isinstance(v, CedarRecord):
        return {k: _value_doc(val) for k, val in v.attrs.items()}
    if isinstance(v, CedarSet):
        return [_value_doc(e) for e in v.elems]
    if isinstance(v, EntityUID):
        return f"{v.type}::{v.id}"
    return v


def request_doc(entities, request) -> Dict[str, Any]:
    """JSON-able exemplar: the concrete request plus the ancestor edges
    that made it match."""
    doc: Dict[str, Any] = {
        "principal": f"{request.principal.type}::{request.principal.id}",
        "action": f"{request.action.type}::{request.action.id}",
        "resource": f"{request.resource.type}::{request.resource.id}",
        "context": _value_doc(request.context),
    }
    attrs = {}
    parents = {}
    for var, uid in (
        ("principal", request.principal),
        ("action", request.action),
        ("resource", request.resource),
    ):
        ent = entities.get(uid)
        if ent is None:
            continue
        if ent.attrs is not None and ent.attrs.attrs:
            attrs[var] = _value_doc(ent.attrs)
        if ent.parents:
            parents[var] = [f"{p.type}::{p.id}" for p in ent.parents]
    if attrs:
        doc["attrs"] = attrs
    if parents:
        doc["parents"] = parents
    return doc


# ---------------------------------------------------------------------------
# sweep


@dataclass
class SweepResult:
    """Exact (or sampled) whole-space verdicts for one policy set."""

    universe: Universe
    exact: bool  # verdicts are exact, not sampled hints
    n_policies: int
    n_rules: int
    match_counts: Dict[str, int]  # policy_id -> universe matches
    dead: List[Dict[str, Any]] = field(default_factory=list)
    shadowed: List[Dict[str, Any]] = field(default_factory=list)
    overlaps: List[Dict[str, Any]] = field(default_factory=list)
    oracle: Dict[str, Any] = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def provenance(self) -> str:
        return "exact" if self.exact else "conservative"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "universe": self.universe.to_dict(),
            "exact": self.exact,
            "policies": self.n_policies,
            "rules": self.n_rules,
            "dead": list(self.dead),
            "shadowed": list(self.shadowed),
            "overlaps": list(self.overlaps),
            "oracle": dict(self.oracle),
            "seconds": round(self.seconds, 3),
        }


def _policy_matrices(
    packed: PackedPolicySet, sat: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Fold rule columns into per-policy match/error row matrices.

    Returns (M [P, n] bool match, E [P, n] bool error, pm indices) for
    the policies that packed any rules (fallback policies pack none)."""
    n = sat.shape[0]
    P = len(packed.policy_meta)
    M = np.zeros((P, n), dtype=bool)
    E = np.zeros((P, n), dtype=bool)
    has_rules = [False] * P
    for r, rc in enumerate(packed.rule_clause):
        if rc.pm_idx < 0 or r >= packed.n_rules:
            continue
        has_rules[rc.pm_idx] = True
        if rc.kind == "match":
            M[rc.pm_idx] |= sat[:, r]
        elif rc.kind == "error":
            E[rc.pm_idx] |= sat[:, r]
    return M, E, [i for i, h in enumerate(has_rules) if h]


def _priority_over(a, b) -> Optional[str]:
    """Why policy ``a`` outranks policy ``b`` when both match a request:
    earlier tier stops the walk, same-tier forbid overrides permit, and
    a same-tier same-effect cover makes ``b`` redundant. None when ``a``
    cannot pre-empt ``b``."""
    if a.tier < b.tier:
        return "earlier tier"
    if a.tier > b.tier:
        return None
    if a.effect == "forbid" and b.effect == "permit":
        return "forbid overrides"
    if a.effect == b.effect:
        return "same effect"
    return None


def sweep(
    tiers: Sequence[Any],
    schema: Optional[SchemaInfo] = None,
    budget: int = 4096,
    seed: int = 0,
    oracle_sample: int = 64,
    engine: Any = None,
    packed: Optional[PackedPolicySet] = None,
) -> SweepResult:
    """Sweep the typed request universe over ``tiers``' compiled plane.

    Produces per-policy exact coverage (zero matches => dead rule),
    exact shadowing (match-set inclusion under walk priority),
    permit/forbid overlap pairs with concrete exemplars, and an
    interpreter-oracle cross-check over a seeded slice.
    """
    t0 = time.perf_counter()
    schema = schema or AUTHZ_SCHEMA_INFO
    tiers = list(tiers)
    if packed is None:
        packed = pack_tiers(tiers, schema)
    universe = enumerate_universe([packed], budget=budget, seed=seed, schema=schema)
    sat = sat_matrix(packed, universe, engine=engine)
    M, E, rule_pms = _policy_matrices(packed, sat)
    n = universe.size
    exact = universe.exhaustive
    provenance = "exact" if exact else "conservative"

    match_counts: Dict[str, int] = {}
    first_match: Dict[int, int] = {}
    for pm in rule_pms:
        meta = packed.policy_meta[pm]
        cnt = int(M[pm].sum())
        match_counts[meta.policy_id] = cnt
        if cnt:
            first_match[pm] = int(np.argmax(M[pm]))

    dead: List[Dict[str, Any]] = []
    for pm in rule_pms:
        meta = packed.policy_meta[pm]
        if not M[pm].any() and not E[pm].any():
            dead.append(
                {
                    "policy": meta.policy_id,
                    "tier": meta.tier,
                    "effect": meta.effect,
                    "provenance": provenance,
                }
            )

    # shadowing: victim's match set contained in one pre-empting policy's.
    # Candidate shadowers are pruned to the policies matching the victim's
    # first exemplar request, so the pass is ~linear in live policies.
    shadowed: List[Dict[str, Any]] = []
    npk = np.packbits(M, axis=1) if n else np.zeros((M.shape[0], 0), np.uint8)
    for pm in rule_pms:
        if pm not in first_match:
            continue
        meta = packed.policy_meta[pm]
        i0 = first_match[pm]
        for cand in np.nonzero(M[:, i0])[0].tolist():
            if cand == pm:
                continue
            cmeta = packed.policy_meta[cand]
            why = _priority_over(cmeta, meta)
            if why is None:
                continue
            if np.any(npk[pm] & ~npk[cand]):
                continue  # counter-witness: victim matches outside cand
            shadowed.append(
                {
                    "policy": meta.policy_id,
                    "tier": meta.tier,
                    "effect": meta.effect,
                    "shadower": cmeta.policy_id,
                    "shadower_tier": cmeta.tier,
                    "shadower_effect": cmeta.effect,
                    "why": why,
                    "provenance": provenance,
                }
            )
            if len(shadowed) >= EXEMPLAR_CAP:
                break
        if len(shadowed) >= EXEMPLAR_CAP:
            break

    # permit/forbid overlap: concrete joint-match exemplars where the
    # forbid pre-empts (same or earlier tier) — always exact findings,
    # each carries the request that witnesses it
    overlaps: List[Dict[str, Any]] = []
    seen_pairs = set()
    pm_effect = [m.effect for m in packed.policy_meta]
    pm_tier = [m.tier for m in packed.policy_meta]
    for i in range(n):
        matched = np.nonzero(M[:, i])[0].tolist()
        if len(matched) < 2:
            continue
        permits = [p for p in matched if pm_effect[p] == "permit"]
        forbids = [p for p in matched if pm_effect[p] == "forbid"]
        for p in permits:
            for f in forbids:
                if pm_tier[f] > pm_tier[p]:
                    continue
                key = (p, f)
                if key in seen_pairs:
                    continue
                seen_pairs.add(key)
                if len(overlaps) < EXEMPLAR_CAP:
                    em, req = universe.items[i]
                    overlaps.append(
                        {
                            "permit": packed.policy_meta[p].policy_id,
                            "forbid": packed.policy_meta[f].policy_id,
                            "provenance": "exact",
                            "exemplar": request_doc(em, req),
                        }
                    )

    oracle = oracle_check(
        tiers, packed, sat, universe, sample=oracle_sample, seed=seed
    )

    res = SweepResult(
        universe=universe,
        exact=exact,
        n_policies=len(packed.policy_meta) + len(packed.fallback),
        n_rules=packed.n_rules,
        match_counts=match_counts,
        dead=dead,
        shadowed=shadowed,
        overlaps=overlaps,
        oracle=oracle,
        seconds=time.perf_counter() - t0,
    )
    _publish_metrics("sweep", res.universe, res.oracle, res.seconds)
    return res


def oracle_check(
    tiers: Sequence[Any],
    packed: PackedPolicySet,
    sat: np.ndarray,
    universe: Universe,
    sample: int = 64,
    seed: int = 0,
) -> Dict[str, Any]:
    """Cross-check plane decisions against the interpreter oracle on a
    seeded slice of the universe."""
    import random as _random

    n = universe.size
    k = min(sample, n)
    idx = sorted(_random.Random(seed + 1).sample(range(n), k)) if k else []
    disagreements: List[Dict[str, Any]] = []
    for i in idx:
        em, req = universe.items[i]
        got, _tier = plane_decision(packed, sat[i], em, req)
        want = interpreter_decision(tiers, em, req)
        if got != want:
            if len(disagreements) < 16:
                disagreements.append(
                    {
                        "request": request_doc(em, req),
                        "plane": got,
                        "oracle": want,
                    }
                )
    return {
        "sampled": k,
        "disagreements": len(disagreements),
        "examples": disagreements,
    }


# ---------------------------------------------------------------------------
# report integration


def apply_sweep(report, res: SweepResult, packed: PackedPolicySet) -> None:
    """Merge a sweep's verdicts into a conservative AnalysisReport:

    - exhaustive sweeps REFUTE conservative ``never_matches`` hints for
      policies the universe proved alive;
    - overlap hints the sweep witnessed with a concrete request upgrade
      to ``exact`` provenance;
    - new ``dead_rule`` findings (exact or sampled provenance) and — on
      exhaustive universes only — ``shadowed_exact`` findings;
    - any oracle disagreement becomes a blocking ``oracle_disagreement``
      finding (that is a compiler bug, not a policy problem);
    - the raw sweep summary lands under ``report.sweep``.
    """
    from dataclasses import replace

    from .report import Finding

    meta_by_id = {m.policy_id: m for m in packed.policy_meta}
    if res.exact:
        alive = {pid for pid, c in res.match_counts.items() if c}
        report.findings = [
            f
            for f in report.findings
            if not (f.code == "never_matches" and f.policy_id in alive)
        ]
    witnessed = {(o["permit"], o["forbid"]) for o in res.overlaps}
    report.findings = [
        replace(f, provenance="exact")
        if (
            f.code == "permit_forbid_overlap"
            and f.related
            and (f.policy_id, f.related[0]) in witnessed
        )
        else f
        for f in report.findings
    ]

    def _mk(code: str, pid: str, tier: int, message: str, related=(), prov="exact"):
        meta = meta_by_id.get(pid)
        return Finding(
            code=code,
            policy_id=pid,
            filename=meta.filename if meta else "",
            position=meta.position if meta else (0, 0, 0),
            tier=tier,
            message=message,
            related=tuple(related),
            provenance=prov,
        )

    mode = (
        "the exhaustive typed universe"
        if res.exact
        else f"a stratified sample of {res.universe.size} requests"
    )
    for d in res.dead:
        report.findings.append(
            _mk(
                "dead_rule",
                d["policy"],
                d["tier"],
                f"matched zero of {mode} (device-exact sweep)",
                prov=d["provenance"],
            )
        )
    if res.exact:
        for s in res.shadowed:
            report.findings.append(
                _mk(
                    "shadowed_exact",
                    s["policy"],
                    s["tier"],
                    f"every matching request is pre-empted by "
                    f"`{s['shadower']}` ({s['why']})",
                    related=(s["shadower"],),
                    prov=s["provenance"],
                )
            )
    for ex in res.oracle.get("examples", ()):
        report.findings.append(
            Finding(
                code="oracle_disagreement",
                policy_id="",
                filename="",
                position=(0, 0, 0),
                tier=0,
                message=(
                    f"plane said {ex['plane']}, interpreter said "
                    f"{ex['oracle']} for {ex['request']}"
                ),
                provenance="exact",
            )
        )
    report.sweep = res.to_dict()


# ---------------------------------------------------------------------------
# semantic diff


@dataclass
class DiffResult:
    """Decision-level diff between a live and a candidate policy set
    over their joint request universe."""

    universe: Universe
    exact: bool
    n_requests: int
    flips: List[Dict[str, Any]]  # exemplars, capped at EXEMPLAR_CAP
    flip_counts: Dict[str, int]  # kind -> total (never capped)
    oracle: Dict[str, Any]
    seconds: float = 0.0

    @property
    def total_flips(self) -> int:
        return sum(self.flip_counts.values())

    def out_of_intent(self, selectors: Sequence[Dict[str, Any]]) -> int:
        """Flips not covered by any allowed-intent selector. Counted on
        the exemplar list when it is complete; extrapolated as 'all out
        of intent' for counted-but-uncapped flips (the gate should fail
        loudly, not silently under-count)."""
        if not selectors:
            return self.total_flips
        out = sum(
            1 for f in self.flips if not any(flip_in_intent(f, s) for s in selectors)
        )
        return out + max(0, self.total_flips - len(self.flips))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "universe": self.universe.to_dict(),
            "exact": self.exact,
            "requests": self.n_requests,
            "flips": list(self.flips),
            "flip_counts": dict(self.flip_counts),
            "total_flips": self.total_flips,
            "oracle": dict(self.oracle),
            "seconds": round(self.seconds, 3),
        }


def flip_in_intent(flip: Dict[str, Any], selector: Dict[str, Any]) -> bool:
    """Does an allowed-intent selector cover this flip? Every present
    selector key must match: ``kind`` exactly, ``principal``/``action``/
    ``resource`` as a glob over the exemplar's ``Type::id`` string."""
    kind = selector.get("kind")
    if kind and kind != flip.get("kind"):
        return False
    req = flip.get("request", {})
    for key in ("principal", "action", "resource"):
        pat = selector.get(key)
        if pat and not fnmatch.fnmatchcase(str(req.get(key, "")), pat):
            return False
    return True


def semantic_diff(
    live_tiers: Sequence[Any],
    cand_tiers: Sequence[Any],
    schema: Optional[SchemaInfo] = None,
    budget: int = 4096,
    seed: int = 0,
    oracle_sample: int = 32,
    live_packed: Optional[PackedPolicySet] = None,
    cand_packed: Optional[PackedPolicySet] = None,
) -> DiffResult:
    """Decision diff between ``live_tiers`` and ``cand_tiers`` over the
    union universe of both compiled vocabularies, with concrete
    flipped-request exemplars and an interpreter-oracle cross-check of
    BOTH planes on a seeded slice."""
    t0 = time.perf_counter()
    schema = schema or AUTHZ_SCHEMA_INFO
    live_tiers = list(live_tiers)
    cand_tiers = list(cand_tiers)
    if live_packed is None:
        live_packed = pack_tiers(live_tiers, schema)
    if cand_packed is None:
        cand_packed = pack_tiers(cand_tiers, schema)
    universe = enumerate_universe(
        [live_packed, cand_packed], budget=budget, seed=seed, schema=schema
    )
    sat_live = sat_matrix(live_packed, universe)
    sat_cand = sat_matrix(cand_packed, universe)

    flips: List[Dict[str, Any]] = []
    flip_counts: Dict[str, int] = {}
    for i, (em, req) in enumerate(universe.items):
        d_live, t_live = plane_decision(live_packed, sat_live[i], em, req)
        d_cand, t_cand = plane_decision(cand_packed, sat_cand[i], em, req)
        if d_live == d_cand:
            continue
        kind = "allow_to_deny" if d_live == ALLOW else "deny_to_allow"
        flip_counts[kind] = flip_counts.get(kind, 0) + 1
        if len(flips) < EXEMPLAR_CAP:
            flips.append(
                {
                    "kind": kind,
                    "request": request_doc(em, req),
                    "live": {"decision": d_live, "tier": t_live},
                    "candidate": {"decision": d_cand, "tier": t_cand},
                }
            )

    oracle_live = oracle_check(
        live_tiers, live_packed, sat_live, universe, sample=oracle_sample, seed=seed
    )
    oracle_cand = oracle_check(
        cand_tiers, cand_packed, sat_cand, universe, sample=oracle_sample, seed=seed
    )
    oracle = {
        "sampled": oracle_live["sampled"] + oracle_cand["sampled"],
        "disagreements": oracle_live["disagreements"]
        + oracle_cand["disagreements"],
        "examples": (oracle_live["examples"] + oracle_cand["examples"])[:16],
    }

    res = DiffResult(
        universe=universe,
        exact=universe.exhaustive,
        n_requests=universe.size,
        flips=flips,
        flip_counts=flip_counts,
        oracle=oracle,
        seconds=time.perf_counter() - t0,
    )
    _publish_metrics("semdiff", res.universe, res.oracle, res.seconds)
    return res


def _publish_metrics(mode, universe, oracle, seconds) -> None:
    """Best-effort server-metric publication — analysis is a library and
    must work without the serving stack importable."""
    try:
        from ..server.metrics import (
            record_analysis_oracle_disagreements,
            record_analysis_sweep,
        )

        record_analysis_sweep(mode, universe.size, universe.exhaustive, seconds)
        record_analysis_oracle_disagreements(oracle.get("disagreements", 0))
    except Exception:  # noqa: BLE001 — metrics never gate analysis
        pass
