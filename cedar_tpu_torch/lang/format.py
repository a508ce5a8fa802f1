"""Cedar policy serializer: AST → canonical Cedar text.

The layout follows the shape of cedar-go's MarshalCedar output that the
reference's golden corpus is written in (annotations on their own lines, a
parenthesized scope block with one clause per line, when/unless blocks), so
policies produced by the RBAC converter diff cleanly against goldens. Output
is always re-parseable by lang/parser.py.
"""

from __future__ import annotations

from .ast import (
    And,
    Binary,
    Condition,
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
)
from .values import EntityUID

# Precedence levels (higher binds tighter). Mirrors the Cedar grammar:
# || < && < comparison/in/has/like/is < +,- < * < unary < member/primary.
_PREC_OR = 1
_PREC_AND = 2
_PREC_CMP = 3
_PREC_ADD = 4
_PREC_MUL = 5
_PREC_UNARY = 6
_PREC_MEMBER = 7

_BIN_PREC = {
    "==": _PREC_CMP,
    "!=": _PREC_CMP,
    "<": _PREC_CMP,
    "<=": _PREC_CMP,
    ">": _PREC_CMP,
    ">=": _PREC_CMP,
    "in": _PREC_CMP,
    "+": _PREC_ADD,
    "-": _PREC_ADD,
    "*": _PREC_MUL,
}

_IDENT_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")


def quote_string(s: str) -> str:
    out = ['"']
    for ch in s:
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\0":
            out.append("\\0")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _is_ident(s: str) -> bool:
    return bool(s) and not s[0].isdigit() and all(c in _IDENT_OK for c in s)


def format_entity_uid(uid: EntityUID) -> str:
    return f"{uid.type}::{quote_string(uid.id)}"


def format_expr(e, prec: int = 0) -> str:
    text, my_prec = _expr(e)
    if my_prec < prec:
        return f"({text})"
    return text


def _expr(e):
    if isinstance(e, Lit):
        v = e.value
        if v is True:
            return "true", _PREC_MEMBER
        if v is False:
            return "false", _PREC_MEMBER
        if isinstance(v, str):
            return quote_string(v), _PREC_MEMBER
        return str(v), _PREC_MEMBER
    if isinstance(e, EntityLit):
        return format_entity_uid(e.uid), _PREC_MEMBER
    if isinstance(e, Var):
        return e.name, _PREC_MEMBER
    if isinstance(e, Unary):
        if e.op == "!":
            return "!" + format_expr(e.arg, _PREC_UNARY), _PREC_UNARY
        return "-" + format_expr(e.arg, _PREC_UNARY), _PREC_UNARY
    if isinstance(e, And):
        return (
            format_expr(e.left, _PREC_AND)
            + " && "
            + format_expr(e.right, _PREC_AND + 1),
            _PREC_AND,
        )
    if isinstance(e, Or):
        return (
            format_expr(e.left, _PREC_OR)
            + " || "
            + format_expr(e.right, _PREC_OR + 1),
            _PREC_OR,
        )
    if isinstance(e, Binary):
        p = _BIN_PREC[e.op]
        if p == _PREC_CMP:
            # comparison-level ops (== != < <= > >= in) are non-associative
            # in Cedar: parenthesize same-level children on BOTH sides
            lp = rp = p + 1
        else:
            lp, rp = p, p + 1  # left-associative arithmetic
        return (
            format_expr(e.left, lp)
            + f" {e.op} "
            + format_expr(e.right, rp),
            p,
        )
    if isinstance(e, If):
        return (
            "if "
            + format_expr(e.cond, _PREC_OR)
            + " then "
            + format_expr(e.then, _PREC_OR)
            + " else "
            + format_expr(e.els, _PREC_OR),
            0,
        )
    if isinstance(e, GetAttr):
        obj = format_expr(e.obj, _PREC_MEMBER)
        if _is_ident(e.attr):
            return f"{obj}.{e.attr}", _PREC_MEMBER
        return f"{obj}[{quote_string(e.attr)}]", _PREC_MEMBER
    if isinstance(e, HasAttr):
        obj = format_expr(e.obj, _PREC_CMP + 1)
        attr = e.attr if _is_ident(e.attr) else quote_string(e.attr)
        return f"{obj} has {attr}", _PREC_CMP
    if isinstance(e, Like):
        obj = format_expr(e.obj, _PREC_CMP + 1)
        return f'{obj} like "{_pattern_source(e.pattern)}"', _PREC_CMP
    if isinstance(e, Is):
        obj = format_expr(e.obj, _PREC_CMP + 1)
        out = f"{obj} is {e.entity_type}"
        if e.in_entity is not None:
            out += " in " + format_expr(e.in_entity, _PREC_CMP + 1)
        return out, _PREC_CMP
    if isinstance(e, SetLit):
        return (
            "[" + ", ".join(format_expr(x, 0) for x in e.elems) + "]",
            _PREC_MEMBER,
        )
    if isinstance(e, RecordLit):
        pairs = ", ".join(
            f"{quote_string(k)}: {format_expr(v, 0)}" for k, v in e.pairs
        )
        return "{" + pairs + "}", _PREC_MEMBER
    if isinstance(e, MethodCall):
        obj = format_expr(e.obj, _PREC_MEMBER)
        args = ", ".join(format_expr(a, 0) for a in e.args)
        return f"{obj}.{e.method}({args})", _PREC_MEMBER
    if isinstance(e, ExtCall):
        args = ", ".join(format_expr(a, 0) for a in e.args)
        return f"{e.func}({args})", _PREC_MEMBER
    raise TypeError(f"unknown expression node {type(e).__name__}")


def _pattern_source(p: Pattern) -> str:
    # Each literal chunk gets full string-literal escaping (quotes, newlines,
    # backslashes) and then the pattern-level `\*` escape; WILDCARD is `*`.
    out = []
    for c in p.components:
        from .ast import WILDCARD

        if c is WILDCARD:
            out.append("*")
        else:
            out.append(quote_string(c)[1:-1].replace("*", "\\*"))
    return "".join(out)


def _format_scope(var: str, scope: Scope) -> str:
    if scope.op == "all":
        return var
    if scope.op == "eq":
        return f"{var} == {format_entity_uid(scope.entity)}"
    if scope.op == "in":
        if scope.entities:
            inner = ", ".join(format_entity_uid(u) for u in scope.entities)
            return f"{var} in [{inner}]"
        return f"{var} in {format_entity_uid(scope.entity)}"
    if scope.op == "is":
        return f"{var} is {scope.entity_type}"
    if scope.op == "is_in":
        return f"{var} is {scope.entity_type} in {format_entity_uid(scope.entity)}"
    raise ValueError(f"unknown scope op {scope.op}")


def format_policy(p: Policy) -> str:
    lines = []
    for k, v in p.annotations:
        lines.append(f"@{k}({quote_string(v)})")
    lines.append(f"{p.effect} (")
    scopes = [
        "  " + _format_scope("principal", p.principal),
        "  " + _format_scope("action", p.action),
        "  " + _format_scope("resource", p.resource),
    ]
    lines.append(",\n".join(scopes))
    lines.append(")")
    for cond in p.conditions:
        lines.append(f"{cond.kind} {{ {format_expr(cond.body)} }}")
    return "\n".join(lines) + ";"


def format_policy_set(policies) -> str:
    """Serialize an iterable of policies (or a PolicySet) to Cedar text."""
    ps = policies.policies() if hasattr(policies, "policies") else list(policies)
    return "\n\n".join(format_policy(p) for p in ps) + ("\n" if ps else "")
