"""Clause-level subsumption and satisfiability over the lowered IR.

The lowering (compiler/lower.py) turns every policy into ordered-DNF
clauses whose literals test finite slot/vocab domains — equality against
interned constants, membership in constant sets, integer comparisons,
entity identity/type tests. That finiteness makes two questions cheap and
sound to answer statically:

  * ``clause_subsumes(a, b)`` — does clause ``a`` fire on every request
    clause ``b`` fires on?  (single-literal implication: every literal of
    ``a`` is implied by some literal of ``b``)
  * ``clause_pair_satisfiable(a, b)`` — can one request satisfy both
    clauses?  (pairwise contradiction scan — a SAT-lite that never calls
    a solver because the domains are finite and the literals unary)

Both are conservative in the safe direction: subsumption may miss (never
invents) a cover, satisfiability may report True for an actually-empty
intersection (never False for a non-empty one). Error-exactness of the
hardened clauses (a clause fires exactly when Cedar matches the policy on
that evaluation path) is what lets clause facts transfer to policy facts.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..compiler.ir import (
    CMP,
    Clause,
    ClauseLit,
    ENTITY_IN,
    ENTITY_IN_ANY,
    EQ,
    EQ_ENTITY,
    HAS,
    IN_SET,
    IS,
    LIKE,
    Literal,
    SET_HAS,
)

# literal kinds whose positive form proves the slot value was retrieved
# (hence the slot, and every prefix of its access path, is present)
_VALUE_KINDS = (EQ, CMP, IN_SET, SET_HAS, LIKE)

# interval form of an integer constraint: (lo, hi), None = unbounded.
# Cedar longs are i64 but the interval algebra needs no bounds to be sound.
_Interval = Tuple[Optional[int], Optional[int]]


def _cmp_interval(op: str, c: int, negated: bool) -> _Interval:
    """The set of slot values satisfying ``slot <op> c`` (or its negation)
    as one closed interval — every CMP literal and its complement is one."""
    if negated:
        op = {"<": ">=", "<=": ">", ">": "<=", ">=": "<"}[op]
    if op == "<":
        return (None, c - 1)
    if op == "<=":
        return (None, c)
    if op == ">":
        return (c + 1, None)
    return (c, None)


def _interval_subset(a: _Interval, b: _Interval) -> bool:
    alo, ahi = a
    blo, bhi = b
    lo_ok = blo is None or (alo is not None and alo >= blo)
    hi_ok = bhi is None or (ahi is not None and ahi <= bhi)
    return lo_ok and hi_ok


def _interval_disjoint(a: _Interval, b: _Interval) -> bool:
    alo, ahi = a
    blo, bhi = b
    if ahi is not None and blo is not None and ahi < blo:
        return True
    if bhi is not None and alo is not None and bhi < alo:
        return True
    return False


def _int_of_eq(lit: Literal) -> Optional[int]:
    """The integer behind an EQ literal's value_key, if it is a long."""
    d = lit.data
    if isinstance(d, tuple) and len(d) == 2 and d[0] == "l":
        return d[1]
    return None


def implies(a: ClauseLit, b: ClauseLit) -> bool:
    """True when literal ``a`` being satisfied forces ``b`` satisfied, on
    any request. Conservative: False means "could not prove"."""
    la, lb = a.lit, b.lit
    if la.key() == lb.key():
        return a.negated == b.negated
    # positive value test on a slot proves presence of the slot and every
    # prefix of its access path
    if (
        not a.negated
        and la.slot is not None
        and la.kind in _VALUE_KINDS
        and lb.kind == HAS
        and not b.negated
        and lb.slot is not None
        and la.slot[0] == lb.slot[0]
        and la.slot[1][: len(lb.slot[1])] == lb.slot[1]
    ):
        return True
    if la.kind == EQ and not a.negated:
        if lb.kind == EQ and la.slot == lb.slot:
            # x == v proves x != v' and disproves nothing else
            return b.negated and la.data != lb.data
        if lb.kind == IN_SET and la.slot == lb.slot:
            inside = la.data in lb.data
            return inside if not b.negated else not inside
        n = _int_of_eq(la)
        if n is not None and lb.kind == CMP and la.slot == lb.slot:
            return _interval_subset((n, n), _cmp_interval(*lb.data, b.negated))
    if la.kind == IN_SET and not a.negated:
        if lb.kind == IN_SET and la.slot == lb.slot:
            if not b.negated:
                return la.data <= lb.data
            return not (la.data & lb.data)
        if lb.kind == EQ and la.slot == lb.slot and b.negated:
            return lb.data not in la.data
    if la.kind == CMP:
        ia = _cmp_interval(*la.data, a.negated)
        if lb.kind == CMP and la.slot == lb.slot:
            return _interval_subset(ia, _cmp_interval(*lb.data, b.negated))
        if lb.kind == EQ and la.slot == lb.slot and b.negated:
            n = _int_of_eq(lb)
            if n is not None:
                return _interval_disjoint(ia, (n, n))
    if la.kind == EQ_ENTITY and not a.negated:
        t, i = la.data
        if lb.kind == EQ_ENTITY and la.var == lb.var:
            return b.negated and la.data != lb.data
        if lb.kind == IS and la.var == lb.var:
            return (t == lb.data) if not b.negated else (t != lb.data)
        if lb.kind == ENTITY_IN and la.var == lb.var and not b.negated:
            # `in` is reflexive: uid == g implies uid in g
            return la.data == lb.data
        if lb.kind == ENTITY_IN_ANY and la.var == lb.var and not b.negated:
            return la.data in lb.data
    if la.kind == ENTITY_IN and not a.negated:
        if lb.kind == ENTITY_IN_ANY and la.var == lb.var and not b.negated:
            return la.data in lb.data
    if la.kind == ENTITY_IN_ANY and not a.negated:
        if lb.kind == ENTITY_IN_ANY and la.var == lb.var and not b.negated:
            return la.data <= lb.data
    if la.kind == IS and not a.negated:
        if lb.kind == IS and la.var == lb.var and b.negated:
            return la.data != lb.data
        if lb.kind == EQ_ENTITY and la.var == lb.var and b.negated:
            return la.data != lb.data[0]
    if la.kind == HAS and not a.negated:
        # presence of a deeper path proves presence of every prefix
        if (
            lb.kind == HAS
            and not b.negated
            and lb.slot is not None
            and la.slot is not None
            and la.slot[0] == lb.slot[0]
            and la.slot[1][: len(lb.slot[1])] == lb.slot[1]
        ):
            return True
    return False


def _negate(cl: ClauseLit) -> ClauseLit:
    return ClauseLit(cl.lit, not cl.negated)


def contradicts(a: ClauseLit, b: ClauseLit) -> bool:
    """True when no request satisfies both literals."""
    return implies(a, _negate(b)) or implies(b, _negate(a))


def clause_subsumes(a: Clause, b: Clause) -> bool:
    """Clause ``a`` fires whenever clause ``b`` fires: every literal of
    ``a`` is implied by some single literal of ``b``."""
    return all(any(implies(bv, av) for bv in b) for av in a)


def clause_pair_satisfiable(a: Clause, b: Clause) -> bool:
    """Can one request satisfy both clauses? Pairwise contradiction scan
    over the merged literal set (unary literals over finite domains: a
    contradiction, if any, is visible in some pair)."""
    merged = tuple(a) + tuple(b)
    for i, x in enumerate(merged):
        for y in merged[i + 1 :]:
            if contradicts(x, y):
                return False
    return True


def clause_self_satisfiable(c: Clause) -> bool:
    """A clause with an internal contradiction (e.g. two different
    positive equalities on one slot) can never fire."""
    return clause_pair_satisfiable(c, ())


def covers(shadower_clauses, victim_clauses) -> bool:
    """Every clause of the victim is subsumed by some clause of the
    shadower: the shadower matches every request the victim matches."""
    if not victim_clauses:
        return False  # "never fires" is its own finding, not a cover
    return all(
        any(clause_subsumes(sc, vc) for sc in shadower_clauses)
        for vc in victim_clauses
    )


def clause_key(clause: Clause) -> frozenset:
    """Order-insensitive identity of a clause's literal set (for duplicate
    detection)."""
    return frozenset((cl.lit.key(), cl.negated) for cl in clause)
