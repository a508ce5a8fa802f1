"""Cedar JSON policy format serializer.

Produces the Cedar language's canonical JSON policy representation (the same
format cedar-go's PolicySet.MarshalJSON emits, used by the reference
converter's ``-output json`` mode, cmd/converter/main.go:97-99): a
``staticPolicies`` map of policy ID → {effect, principal, action, resource,
conditions, annotations}, with expressions in the JSON expression encoding.
"""

from __future__ import annotations

from typing import Any, Dict

from .ast import (
    And,
    Binary,
    EntityLit,
    ExtCall,
    GetAttr,
    HasAttr,
    If,
    Is,
    Like,
    Lit,
    MethodCall,
    Or,
    Pattern,
    Policy,
    RecordLit,
    Scope,
    SetLit,
    Unary,
    Var,
    WILDCARD,
)
from .values import EntityUID

_BIN_OP_KEYS = {
    "==": "==",
    "!=": "!=",
    "<": "<",
    "<=": "<=",
    ">": ">",
    ">=": ">=",
    "in": "in",
    "+": "+",
    "-": "-",
    "*": "*",
}


def _entity_json(uid: EntityUID) -> Dict[str, str]:
    return {"type": uid.type, "id": uid.id}


def _pattern_json(p: Pattern) -> list:
    out = []
    for c in p.components:
        if c is WILDCARD:
            out.append("Wildcard")
        else:
            out.append({"Literal": c})
    return out


def expr_to_json(e) -> Any:
    if isinstance(e, Lit):
        return {"Value": e.value}
    if isinstance(e, EntityLit):
        return {"Value": {"__entity": _entity_json(e.uid)}}
    if isinstance(e, Var):
        return {"Var": e.name}
    if isinstance(e, Unary):
        key = "!" if e.op == "!" else "neg"
        return {key: {"arg": expr_to_json(e.arg)}}
    if isinstance(e, And):
        return {"&&": {"left": expr_to_json(e.left), "right": expr_to_json(e.right)}}
    if isinstance(e, Or):
        return {"||": {"left": expr_to_json(e.left), "right": expr_to_json(e.right)}}
    if isinstance(e, Binary):
        key = _BIN_OP_KEYS[e.op]
        return {key: {"left": expr_to_json(e.left), "right": expr_to_json(e.right)}}
    if isinstance(e, If):
        return {
            "if-then-else": {
                "if": expr_to_json(e.cond),
                "then": expr_to_json(e.then),
                "else": expr_to_json(e.els),
            }
        }
    if isinstance(e, GetAttr):
        return {".": {"left": expr_to_json(e.obj), "attr": e.attr}}
    if isinstance(e, HasAttr):
        return {"has": {"left": expr_to_json(e.obj), "attr": e.attr}}
    if isinstance(e, Like):
        return {"like": {"left": expr_to_json(e.obj), "pattern": _pattern_json(e.pattern)}}
    if isinstance(e, Is):
        out = {"left": expr_to_json(e.obj), "entity_type": e.entity_type}
        if e.in_entity is not None:
            out["in"] = expr_to_json(e.in_entity)
        return {"is": out}
    if isinstance(e, SetLit):
        return {"Set": [expr_to_json(x) for x in e.elems]}
    if isinstance(e, RecordLit):
        return {"Record": {k: expr_to_json(v) for k, v in e.pairs}}
    if isinstance(e, MethodCall):
        args = [expr_to_json(a) for a in e.args]
        body = {"left": expr_to_json(e.obj)}
        if len(args) == 1:
            body["right"] = args[0]
        elif args:
            body["args"] = args
        return {e.method: body}
    if isinstance(e, ExtCall):
        return {e.func: [expr_to_json(a) for a in e.args]}
    raise TypeError(f"unknown expression node {type(e).__name__}")


def _scope_json(scope: Scope) -> Dict[str, Any]:
    if scope.op == "all":
        return {"op": "All"}
    if scope.op == "eq":
        return {"op": "==", "entity": _entity_json(scope.entity)}
    if scope.op == "in":
        if scope.entities:
            return {"op": "in", "entities": [_entity_json(u) for u in scope.entities]}
        return {"op": "in", "entity": _entity_json(scope.entity)}
    if scope.op == "is":
        return {"op": "is", "entity_type": scope.entity_type}
    if scope.op == "is_in":
        return {
            "op": "is",
            "entity_type": scope.entity_type,
            "in": {"entity": _entity_json(scope.entity)},
        }
    raise ValueError(f"unknown scope op {scope.op}")


def policy_to_json(p: Policy) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "effect": p.effect,
        "principal": _scope_json(p.principal),
        "action": _scope_json(p.action),
        "resource": _scope_json(p.resource),
        "conditions": [
            {"kind": c.kind, "body": expr_to_json(c.body)} for c in p.conditions
        ],
    }
    if p.annotations:
        out["annotations"] = {k: v for k, v in p.annotations}
    return out


def policy_set_to_json(policies) -> Dict[str, Any]:
    ps = policies.policies() if hasattr(policies, "policies") else list(policies)
    return {"staticPolicies": {p.policy_id: policy_to_json(p) for p in ps}}
