"""IR-backed decision attribution: winning rules -> policies, clauses,
and attribute tests with source spans (a copy of the JAX package's
explain/attribution.py over the port's compiler and interpreter).

The compiled clause IR already knows which clause decided every request:
``compiler.pack`` retains a per-rule back-map (``PackedPolicySet.
rule_clause``) from each packed rule column to the (policy, clause
ordinal, literal tests) it lowered from. This module turns a per-rule
satisfaction vector into an operator-facing explanation:

  * ``host_sat`` computes the satisfaction vector ON THE HOST with numpy
    from the Python encoder's (codes, extras): the semantics of the device
    product (lit-vector @ W >= thresh over the same activation table), so
    breaker-open callers explain without touching the device;
  * ``sat_from_bits`` decodes one row of the device bits plane
    (``TorchPolicyEngine.match_bits_arrays``) into the same vector through
    the engine's own decoder (engine/evaluator.py bits_rule_indices);
  * ``build_explanation`` walks tiers over the satisfied groups (merging
    interpreter-fallback verdicts when entities are given: the walk of
    ``TorchPolicyEngine._finalize_sets``), picks the determining policy,
    maps its winning rule back through ``rule_clause``, and renders every
    literal of that clause as an attribute/operator/value test.

Source spans: the AST keeps positions per POLICY (filename, line, column:
``lang.ast.Policy.position``), not per expression, so every test's
``span`` anchors at its owning policy and carries a rendered ``source``
string of the test itself.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
    IN_SLOT,
    IS,
    LIKE,
    SET_HAS,
    TRUE,
    TYPE_ERR,
)
from ..compiler.pack import (
    ERROR_IDX,
    FORBID_IDX,
    GROUPS_PER_TIER,
    PERMIT_IDX,
    PackedPolicySet,
)
from ..lang.authorize import ALLOW, DENY, Diagnostics, Reason
from ..lang.eval import Env, policy_matches
from ..lang.format import format_expr
from ..lang.values import EvalError

# explanation ``source`` values: which plane computed the attribution
SOURCE_DEVICE = "device"  # bits launch through the engine (plane.py)
SOURCE_HOST = "host"  # numpy matching over the retained host-side pack
SOURCE_INTERPRETER = "interpreter"  # per-policy interpreter walk (no pack)
SOURCE_GATE = "gate"  # pre-evaluation short-circuit answered


# --------------------------------------------------------------- rendering


def _render_value(vk) -> object:
    """A ``lang.values.value_key`` tuple -> a JSON-friendly display value
    (strings/longs/bools verbatim, entities as ``Type::"id"``, sets as
    sorted lists, records as dicts)."""
    if not isinstance(vk, tuple) or not vk:
        return vk
    tag = vk[0]
    if tag in ("s", "l", "b"):
        return vk[1]
    if tag == "e":
        return f'{vk[1]}::"{vk[2]}"'
    if tag == "S":
        return [_render_value(x) for x in vk[1]]
    if tag == "R":
        return {k: _render_value(x) for k, x in vk[1]}
    if tag == "d":
        return f"decimal({vk[1]})"
    if tag == "i":
        return f"{vk[1]}/{vk[2]}"
    return str(vk)


def _fmt_value(v) -> str:
    """Display value -> cedar-ish source text."""
    if isinstance(v, str):
        # entity renderings already carry their own quotes
        return v if "::" in v else f'"{v}"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, list):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    return str(v)


def _slot_attr(slot) -> str:
    var, path = slot
    return ".".join((var,) + tuple(path))


def _uid_str(data) -> str:
    t, i = data
    return f'{t}::"{i}"'


# value_key tag byte -> operator-facing Cedar type name (TYPE_ERR tests)
_TAG_NAMES = {
    "s": "string", "l": "long", "b": "bool", "S": "set",
    "R": "record", "e": "entity", "d": "decimal", "i": "ipaddr",
}


def _like_pattern(components) -> str:
    """A ``like`` literal's pattern as Cedar writes it (``*`` the wildcard,
    ``\\*`` a literal star). The JAX package puts the raw components, its
    wildcard object among them, into the payload, which the JSON encoder
    then refuses; the port answers the pattern's text instead."""
    from ..lang.ast import WILDCARD

    return "".join("*" if c is WILDCARD else c.replace("*", "\\*") for c in components)


def literal_test(cl) -> dict:
    """One ClauseLit -> {"attribute", "operator", "value", "negated",
    "source"}: the operator-facing rendering of one attribute test of a
    winning clause. Every positive test of a matched clause held on the
    request; every negated one provably did not."""
    lit = cl.lit
    kind = lit.kind
    attribute = _slot_attr(lit.slot) if lit.slot is not None else lit.var
    operator: str = kind
    value: object = None
    if kind == EQ:
        operator = "=="
        value = _render_value(lit.data)
    elif kind == HAS:
        operator = "has"
    elif kind == LIKE:
        operator = "like"
        value = _like_pattern(lit.data)
    elif kind == CMP:
        operator, value = lit.data
    elif kind == IN_SET:
        operator = "in"
        value = sorted(
            (_render_value(vk) for vk in lit.data), key=str
        )
    elif kind == SET_HAS:
        operator = "contains"
        value = _render_value(lit.data)
    elif kind == IS:
        operator = "is"
        value = lit.data
    elif kind == EQ_ENTITY:
        operator = "=="
        value = _uid_str(lit.data)
    elif kind == ENTITY_IN:
        operator = "in"
        value = _uid_str(lit.data)
    elif kind == ENTITY_IN_ANY:
        operator = "in"
        value = [_uid_str(u) for u in lit.data]
    elif kind == IN_SLOT:
        # ancestor-closure `in` over an attribute-chain entity value
        operator = "in"
        value = sorted(_uid_str(u) for u in lit.data)
    elif kind == TYPE_ERR:
        # positive: a Cedar type error was detected (the slot's runtime
        # value tag differs from what the typed operation needs);
        # negated: the guard proving the operand had the right type
        operator = "type-error"
        value = _TAG_NAMES.get(lit.data, lit.data)
    elif kind in (HARD, HARD_OK, HARD_ERR):
        operator = {
            HARD: "expr",
            HARD_OK: "expr-evaluates",
            HARD_ERR: "expr-errors",
        }[kind]
        value = format_expr(lit.expr) if lit.expr is not None else None
        attribute = attribute or "expr"
    elif kind == TRUE:
        operator = "true"
    if kind == HAS:
        src = f"{attribute} has"
    elif value is None:
        src = f"{attribute} {operator}"
    elif kind in (HARD, HARD_OK, HARD_ERR):
        src = str(value)
    else:
        src = f"{attribute} {operator} {_fmt_value(value)}"
    if cl.negated:
        src = f"!({src})"
    return {
        "attribute": attribute,
        "operator": operator,
        "value": value,
        "negated": bool(cl.negated),
        "source": src,
    }


def clause_tests(clause) -> List[dict]:
    return [literal_test(cl) for cl in clause]


def policy_span(filename: str, position) -> dict:
    off, line, col = position
    return {"file": filename, "line": line, "column": col, "offset": off}


# ------------------------------------------------------------ satisfaction


def host_sat(
    packed: PackedPolicySet, codes, extras
) -> np.ndarray:
    """Per-rule satisfaction vector [n_rules] bool, computed ON HOST from
    the Python encoder's (codes, extras) for one request: the numpy twin
    of the device bits product (same activation table, same W/thresh), so
    the attribution is byte-equal to what the bits plane would report."""
    L = packed.L
    rows = packed.table.rows  # [V, L] uint8
    lit = np.zeros((L,), dtype=np.int32)
    for c in codes:
        c = int(c)
        if c:
            lit |= rows[c].astype(np.int32)
    for e in extras:
        e = int(e)
        if 0 <= e < L:
            lit[e] = 1
    scores = lit @ packed.W.astype(np.int32)  # [R]
    sat = scores.astype(np.float64) >= packed.thresh
    return sat[: packed.n_rules]


def sat_from_bits(packed: PackedPolicySet, bits_row) -> np.ndarray:
    """One device rule-bitset row ([ceil(R / 32)] uint32) -> [n_rules]
    bool, decoded by the engine's diagnostics decoder (bits_rule_indices),
    so the two cannot drift. The JAX package's ``col_map`` argument (its
    partitioned mesh layout) comes with the port's mesh."""
    from ..engine.evaluator import bits_rule_indices

    sat = np.zeros((packed.n_rules,), dtype=bool)
    sat[bits_rule_indices(bits_row, packed.n_rules)] = True
    return sat


def _groups_from_sat(packed: PackedPolicySet, sat: np.ndarray) -> dict:
    """{group: sorted [policy index]} over the satisfied rules (deduped
    across a policy's several DNF rules): the host twin of
    ``TorchPolicyEngine._bits_groups``."""
    idx = np.nonzero(sat)[0]
    out: dict = {}
    for r in idx.tolist():
        rc = packed.rule_clause[r]
        if rc.pm_idx < 0:
            continue  # gate rules carry no policy
        out.setdefault(rc.group, set()).add(rc.pm_idx)
    return {g: sorted(s) for g, s in out.items()}


# ----------------------------------------------------- fallback evaluation


def fallback_outcomes(
    packed: PackedPolicySet, entities, request
) -> Tuple[list, list, list]:
    """Interpreter verdicts for the pack's fallback policies, per tier:
    (allow [tier][(fp, Reason)], deny [tier][(fp, Reason)],
    errors [tier][(fp, message)]): the merge input of the host tier
    walk, mirroring ``TorchPolicyEngine._finalize_sets``."""
    T = packed.n_tiers
    fb_allow: list = [[] for _ in range(T)]
    fb_deny: list = [[] for _ in range(T)]
    fb_errors: list = [[] for _ in range(T)]
    if packed.fallback and entities is not None:
        env = Env(request, entities)
        for fp in packed.fallback:
            p = fp.policy
            try:
                if not policy_matches(p, env):
                    continue
            except EvalError as e:
                fb_errors[fp.tier].append(
                    (fp, f"while evaluating policy `{p.policy_id}`: {e}")
                )
                continue
            reason = Reason(p.policy_id, p.filename, p.position)
            (fb_deny if p.effect == "forbid" else fb_allow)[fp.tier].append(
                (fp, reason)
            )
    return fb_allow, fb_deny, fb_errors


# --------------------------------------------------------------- tier walk


def _clause_counts(packed: PackedPolicySet) -> dict:
    """{(pm_idx, group): clause count} in ONE rule_clause pass — the
    "clause N of M" denominators, computed once per explanation instead
    of an O(R) rescan per winning-policy doc."""
    counts: dict = {}
    for rc in packed.rule_clause:
        key = (rc.pm_idx, rc.group)
        counts[key] = counts.get(key, 0) + 1
    return counts


def _clause_doc(
    packed: PackedPolicySet, pm_idx: int, group: int, sat, counts: dict
) -> Optional[dict]:
    """The winning clause for (policy, group): the LOWEST satisfied rule
    column belonging to it (pack sorts rules by (group, policy), and a
    policy's clauses keep source order within that run), rendered with its
    ordinal and attribute tests. The scan is over SATISFIED rules only
    (a handful); the denominators come from the precomputed counts."""
    win = None
    for r in np.nonzero(sat)[0].tolist():
        rc = packed.rule_clause[r]
        if rc.pm_idx == pm_idx and rc.group == group:
            win = rc
            break
    if win is None or win.clause is None:
        return None
    return {
        "index": win.ordinal,
        "of": counts.get((pm_idx, group), 1),
        "kind": win.kind,
        "tests": clause_tests(win.clause),
    }


def _policy_doc(
    packed: PackedPolicySet, pm_idx: int, group: int, sat, counts: dict
) -> dict:
    meta = packed.policy_meta[pm_idx]
    return {
        "policyId": meta.policy_id,
        "effect": meta.effect,
        "tier": meta.tier,
        "span": policy_span(meta.filename, meta.position),
        "fallback": False,
        "clause": _clause_doc(packed, pm_idx, group, sat, counts),
    }


def _fallback_doc(fp) -> dict:
    p = fp.policy
    return {
        "policyId": p.policy_id,
        "effect": p.effect,
        "tier": fp.tier,
        "span": policy_span(p.filename, p.position),
        "fallback": True,
        "clause": None,
        "unlowerable": {"code": fp.code, "reason": fp.reason},
    }


def build_explanation(
    packed: PackedPolicySet,
    sat: np.ndarray,
    entities=None,
    request=None,
    source: str = SOURCE_HOST,
) -> Tuple[str, Diagnostics, dict]:
    """(cedar decision, Diagnostics, explanation) from one request's rule
    satisfaction vector. The Diagnostics mirror the serving paths'
    ``_finalize_sets`` output exactly (device reasons ascending by policy
    index, then fallback reasons in pack order), so a caller mapping them
    through ``CedarWebhookAuthorizer._map_verdict`` renders the same
    reason bytes the non-explain path would."""
    groups = _groups_from_sat(packed, sat)
    fb_allow, fb_deny, fb_errors = fallback_outcomes(
        packed, entities, request
    )
    counts = _clause_counts(packed)
    T = packed.n_tiers
    for t in range(T):
        base = t * GROUPS_PER_TIER
        deny = [
            ("device", i, base + FORBID_IDX)
            for i in groups.get(base + FORBID_IDX, ())
        ] + [("fallback", fp, None) for fp, _r in fb_deny[t]]
        allow = [
            ("device", i, base + PERMIT_IDX)
            for i in groups.get(base + PERMIT_IDX, ())
        ] + [("fallback", fp, None) for fp, _r in fb_allow[t]]
        err_pols = [
            ("device", i, base + ERROR_IDX)
            for i in groups.get(base + ERROR_IDX, ())
        ] + [("fallback", fp, None) for fp, _m in fb_errors[t]]
        errors = [
            f"while evaluating policy "
            f"`{packed.policy_meta[i].policy_id}`: evaluation error"
            for i in groups.get(base + ERROR_IDX, ())
        ] + [m for _fp, m in fb_errors[t]]
        winners = deny or allow
        if winners:
            decision = DENY if deny else ALLOW
            reasons = []
            for kind, who, _g in winners:
                if kind == "device":
                    m = packed.policy_meta[who]
                    reasons.append(Reason(m.policy_id, m.filename, m.position))
                else:
                    p = who.policy
                    reasons.append(Reason(p.policy_id, p.filename, p.position))
            docs = [
                _policy_doc(packed, who, g, sat, counts)
                if kind == "device"
                else _fallback_doc(who)
                for kind, who, g in winners
            ]
            det = docs[0]
            return (
                decision,
                Diagnostics(reasons=reasons, errors=errors),
                {
                    "decision": decision,
                    "tier": t,
                    "source": source,
                    "fallback": bool(det.get("fallback")),
                    "determining": det,
                    "reasons": docs,
                    "errors": errors,
                },
            )
        if errors:
            docs = [
                _policy_doc(packed, who, g, sat, counts)
                if kind == "device"
                else _fallback_doc(who)
                for kind, who, g in err_pols
            ]
            det = docs[0] if docs else None
            return (
                DENY,
                Diagnostics(reasons=[], errors=errors),
                {
                    "decision": DENY,
                    "tier": t,
                    "source": source,
                    "fallback": bool(det and det.get("fallback")),
                    "determining": det,
                    "reasons": [],
                    "errors": errors,
                },
            )
    return (
        DENY,
        Diagnostics(),
        {
            "decision": DENY,
            "tier": None,
            "source": source,
            "fallback": False,
            "determining": None,
            "reasons": [],
            "errors": [],
        },
    )


# ------------------------------------------------------- interpreter walk


def _reason_policy(ps, r, request):
    """Resolve a reason's Policy on sets where ids may legally collide
    across tenants (tenancy's FusedPolicySet — per-tenant directory
    stores commonly carry the same bare-filename ids): prefer the policy
    whose fused tenant matches the request's stamped ``context.tenantId``
    (a foreign clone's effect would mis-attribute the decision), then an
    exact source-span match, then the first id match."""
    want = None
    try:
        from ..compiler.pack import TENANT_CONTEXT_KEY

        want = request.context.attrs.get(TENANT_CONTEXT_KEY)
    except Exception:  # noqa: BLE001 — single-tenant shapes
        want = None
    first = span = None
    for p in ps.policies():
        if p.policy_id != r.policy:
            continue
        t = p.__dict__.get("_cedar_tenant")
        if want is not None and t == want:
            return p
        if p.filename == r.filename and p.position == r.position:
            span = span or p
        first = first or p
    return span or first


def interpreter_explanation(
    tiers, entities, request
) -> Tuple[str, Diagnostics, dict]:
    """Host-computed explanation with NO compiled pack at all: walk the
    tiers with the interpreter (``PolicySet.is_authorized`` semantics —
    first tier with any explicit signal wins), attributing the decision to
    the first reason's policy. Clause-level attribution needs the lowered
    IR, so ``clause`` is null here; the policy id, effect, tier and span
    are exact."""
    for t, ps in enumerate(tiers):
        decision, diag = ps.is_authorized(entities, request)
        if diag.reasons or diag.errors:
            docs = []
            for r in diag.reasons:
                p = _reason_policy(ps, r, request)
                docs.append(
                    {
                        "policyId": r.policy,
                        "effect": getattr(p, "effect", None),
                        "tier": t,
                        "span": policy_span(r.filename, r.position),
                        "fallback": False,
                        "clause": None,
                    }
                )
            det = docs[0] if docs else None
            return (
                decision,
                diag,
                {
                    "decision": decision,
                    "tier": t,
                    "source": SOURCE_INTERPRETER,
                    "fallback": False,
                    "determining": det,
                    "reasons": docs,
                    "errors": list(diag.errors),
                },
            )
    return (
        DENY,
        Diagnostics(),
        {
            "decision": DENY,
            "tier": None,
            "source": SOURCE_INTERPRETER,
            "fallback": False,
            "determining": None,
            "reasons": [],
            "errors": [],
        },
    )


def attribution_summary(explanation: dict) -> dict:
    """The compact exemplar attribution for rollout diff reports: just
    enough to say WHY a decision flipped (determining policy, effect,
    tier, clause ordinal, source) without the full test payload."""
    det = explanation.get("determining") or {}
    clause = det.get("clause") or {}
    return {
        "decision": explanation.get("decision"),
        "policyId": det.get("policyId"),
        "effect": det.get("effect"),
        "tier": explanation.get("tier"),
        "clause": clause.get("index"),
        "fallback": bool(explanation.get("fallback")),
        "source": explanation.get("source"),
    }
