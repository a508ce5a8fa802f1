"""Serving-partition pruning: prove rules never-matching for a partition.

An org-wide policy store carries rules for every cluster, yet one serving
process answers for exactly one partition of the request universe (one
cluster's API groups, one org unit's namespaces, ...). A
``PartitionSpec`` names that universe as per-slot allowed-value sets; a
policy whose every lowered clause (match AND error) conjunctively
requires ``slot == v`` with ``v`` outside the universe can never match —
or error on — any in-universe request, so dropping it from the compiled
device plane cannot change any in-universe decision. That is what lets a
100k-rule org set serve at ~10k-rule cost: the cold rules page off the
device entirely (they stay host-side in the shard cache,
compiler/shard.py, and page back in when the spec changes).

Soundness has two halves:

  * **Compile side** (``lowered_never_matches``): every clause of the
    lowered policy — including its error-detection clauses — must carry a
    positive EQ literal on a spec-covered slot whose constant is outside
    the allowed set. Positive literals only: a negated out-of-universe EQ
    is *satisfied* by in-universe requests.
  * **Serve side** (``PartitionSpec.conforms``): a request whose value on
    any spec-covered slot falls OUTSIDE the allowed set must not be
    answered from the pruned plane — the JAX engine routes it to the exact
    interpreter walk over the retained (unpruned) tier stack. The port
    serves no spec yet (its ShardCompiler runs with ``spec=None``); it
    keeps this module for the prune checks compiler/shard.py imports. A request *missing* the slot
    entirely conforms: a pruned rule's out-of-universe EQ cannot be
    satisfied by an absent value, and its error clauses require the same
    conjunct, so absence can produce neither a match nor an error from a
    pruned policy.

``quick_never_matches`` is the pre-lowering fast path: it consults only
the first conjunct of the first ``when`` condition, and only when that
conjunct's attribute access is provably error-free (a schema-mandatory
attribute on every possible entity type of the variable). Scope clauses
are total and evaluate first, so a false, error-free first conjunct
kills the policy on every evaluation path — the policy never needs
lowering at all, which is what bounds a 100k-rule FIRST load.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

from ..compiler.ir import EQ, Clause, LoweredPolicy, Slot
from ..lang import ast
from ..lang.values import value_key

__all__ = [
    "PartitionSpec",
    "clause_dead",
    "lowered_never_matches",
    "quick_never_matches",
    "partition_report",
]


def _parse_slot(dotted: str) -> Slot:
    var, _, path = dotted.partition(".")
    if var not in ("principal", "action", "resource", "context") or not path:
        raise ValueError(
            f"partition slot {dotted!r}: expected <var>.<attr>[.<attr>...] "
            "with var in principal/action/resource/context"
        )
    return (var, tuple(path.split(".")))


@dataclass(frozen=True)
class PartitionSpec:
    """The serving partition: per-slot allowed values.

    ``allowed`` maps a slot (var, attr path) to the frozenset of
    ``value_key``s a request in this partition may carry there. Slots not
    named by the spec are unconstrained."""

    name: str
    allowed: Mapping[Slot, frozenset]

    @classmethod
    def from_dict(cls, doc: dict) -> "PartitionSpec":
        """``{"name": ..., "slots": {"resource.apiGroup": ["", "apps"]}}``"""
        allowed: Dict[Slot, frozenset] = {}
        for dotted, values in (doc.get("slots") or {}).items():
            allowed[_parse_slot(dotted)] = frozenset(
                value_key(v) for v in values
            )
        if not allowed:
            raise ValueError("partition spec names no slots")
        return cls(str(doc.get("name", "")), allowed)

    @classmethod
    def from_file(cls, path: str) -> "PartitionSpec":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    def token(self) -> tuple:
        """Hashable identity for shard-cache keys: a spec change must
        invalidate cached prune verdicts."""
        return (
            self.name,
            tuple(sorted((s, frozenset(v)) for s, v in self.allowed.items())),
        )

    def covers(self, slot: Optional[Slot]) -> bool:
        return slot is not None and slot in self.allowed

    def out_of_universe(self, slot: Slot, data) -> bool:
        vals = self.allowed.get(slot)
        return vals is not None and data not in vals

    def conforms(self, entities, request) -> bool:
        """True when the request's value on every spec-covered slot is
        inside the allowed set (or absent — see module docstring). Only
        conforming requests may be answered from a pruned plane."""
        roots = {}
        for var, uid in (
            ("principal", request.principal),
            ("action", request.action),
            ("resource", request.resource),
        ):
            ent = entities.get(uid)
            roots[var] = ent.attrs if ent is not None else None
        for (var, path), vals in self.allowed.items():
            if var == "context":
                node = request.context
            else:
                node = roots.get(var)
            missing = False
            for attr in path:
                attrs = getattr(node, "attrs", None)
                if attrs is None or attr not in attrs:
                    missing = True
                    break
                node = attrs[attr]
            if missing:
                continue
            try:
                vk = value_key(node)
            except Exception:  # noqa: BLE001 — unkeyable value: be safe
                return False
            if vk not in vals:
                return False
        return True


def clause_dead(clause: Clause, spec: PartitionSpec) -> bool:
    """True when the clause conjunctively requires an out-of-universe
    equality: no in-universe request can satisfy it."""
    for cl in clause:
        lit = cl.lit
        if (
            not cl.negated
            and lit.kind == EQ
            and lit.slot is not None
            and spec.out_of_universe(lit.slot, lit.data)
        ):
            return True
    return False


def lowered_never_matches(lp: LoweredPolicy, spec: PartitionSpec) -> bool:
    """True when the lowered policy can neither match nor ERROR on any
    in-universe request — every match clause and every error clause is
    dead under the spec. Only then is dropping it from the compiled plane
    sound (an error is an explicit tier-stop signal, so losing one would
    change decisions, not just diagnostics)."""
    clauses = list(lp.clauses) + list(lp.error_clauses)
    if not clauses:
        return False
    return all(clause_dead(c, spec) for c in clauses)


def _scope_pinned_types(policy: ast.Policy, var: str, schema) -> Tuple[str, ...]:
    """The possible entity types of ``var`` under the policy's scope
    clause — the scope's `is`/`==` pin beats the schema's open set."""
    sc: ast.Scope = getattr(policy, var)
    if sc.op == "eq" and sc.entity is not None:
        return (sc.entity.type,)
    if sc.op in ("is", "is_in") and sc.entity_type:
        return (sc.entity_type,)
    return tuple(schema.var_types.get(var, ()))


def quick_never_matches(policy: ast.Policy, spec: PartitionSpec, schema) -> bool:
    """Pre-lowering never-match check (see module docstring): the first
    conjunct of the first ``when`` condition is an error-free equality on
    a spec-covered slot with an out-of-universe constant. Conservative:
    False just means \"lower it and let lowered_never_matches decide\"."""
    if not policy.conditions or policy.conditions[0].kind != "when":
        return False
    body = policy.conditions[0].body
    while isinstance(body, ast.And):
        body = body.left
    if not (isinstance(body, ast.Binary) and body.op == "=="):
        return False
    for attr_side, const_side in (
        (body.left, body.right),
        (body.right, body.left),
    ):
        if not (
            isinstance(attr_side, ast.GetAttr)
            and isinstance(attr_side.obj, ast.Var)
            and isinstance(const_side, ast.Lit)
        ):
            continue
        var = attr_side.obj.name
        if var == "context":
            continue
        slot: Slot = (var, (attr_side.attr,))
        if not spec.covers(slot):
            continue
        types = _scope_pinned_types(policy, var, schema)
        if not types or not all(
            attr_side.attr in schema.mandatory.get(t, frozenset())
            for t in types
        ):
            continue  # access could error: pruning here would lose the error
        try:
            vk = value_key(const_side.value)
        except Exception:  # noqa: BLE001
            continue
        if spec.out_of_universe(slot, vk):
            return True
    return False


def partition_report(spec: Optional[PartitionSpec], shards: dict) -> dict:
    """Capacity-style summary of what the partition kept resident —
    ``shards`` is ShardCompiler's {shard id: CompiledShard} map. Served on
    /debug/engine and folded into load stats (the paging policy's
    operator surface, docs/performance.md)."""
    resident_rules = sum(
        len(lp.clauses) + len(lp.error_clauses)
        for s in shards.values()
        for lp in s.lowered
    )
    total_policies = sum(s.n_policies for s in shards.values())
    pruned = sum(s.pruned for s in shards.values())
    cold = sum(1 for s in shards.values() if not s.lowered and not s.fallback)
    return {
        "partition": spec.name if spec is not None else None,
        "total_policies": total_policies,
        "resident_policies": total_policies - pruned,
        "pruned_policies": pruned,
        "resident_rules": resident_rules,
        "shards": len(shards),
        "cold_shards": cold,
    }
