"""cedar-validator: validate Cedar policies against a generated schema.

Subsumes the CI-side validator role the reference delegates to the Rust
``cedar-policy-cli`` (``make validate-policies``, reference
Makefile:158-163 + .github/workflows/cedar-validation.yaml): every
``*.cedar`` file is parsed with this framework's own parser and checked
against the schema JSON produced by the schema-generator CLI.

Checks performed per policy:
  * syntax (full parse)
  * scope entity types exist in the schema (principal/resource ``is``/``==``
    and ``in`` constraints, action entity ids)
  * action appliesTo compatibility: a principal/resource type pinned by the
    scope must be listed in every scoped action's appliesTo sets
  * attribute accesses rooted at ``principal``/``resource`` whose type the
    scope pins must name attributes that exist in the schema shape
    (best-effort static walk; accesses on untyped vars are skipped, like
    cedar's permissive mode)
  * operand TYPES (schema/typecheck.py): comparisons/arithmetic need Longs,
    ``like`` needs a String, logical operators need Booleans, ``contains``
    needs a Set (with element-type compatibility), equality between
    provably different types is flagged — so ``principal.name < 3`` is a
    finding, like the Rust validator the reference runs in CI
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Set, Tuple

from ..lang import ParseError, ast, parse_policies
from ..schema.model import CedarSchema
from ..schema.typecheck import entity_def, in_feasible


class Finding:
    def __init__(self, filename: str, policy_id: str, message: str):
        self.filename = filename
        self.policy_id = policy_id
        self.message = message

    def __str__(self):
        where = f"{self.filename}:{self.policy_id}" if self.policy_id else self.filename
        return f"{where}: {self.message}"


def _entity_type_exists(schema: CedarSchema, name: str) -> bool:
    return entity_def(schema, name) is not None


def _action_shape(schema: CedarSchema, uid) -> Optional[object]:
    parts = uid.type.split("::")
    if parts[-1] != "Action":
        return None
    ns = "::".join(parts[:-1])
    namespace = schema.namespaces.get(ns)
    if namespace is None:
        return None
    return namespace.actions.get(uid.id)


def _attr_paths(expr: ast.Expr, acc: Set[Tuple[str, Tuple[str, ...]]]) -> None:
    """Collect (var, attr-path) for GetAttr/HasAttr chains rooted at request
    variables; recurse into every subexpression."""
    if isinstance(expr, (ast.GetAttr, ast.HasAttr)):
        path: List[str] = []
        node = expr
        while isinstance(node, (ast.GetAttr, ast.HasAttr)):
            path.append(node.attr)
            node = node.obj
        if isinstance(node, ast.Var) and node.name in ("principal", "resource"):
            acc.add((node.name, tuple(reversed(path))))
        _attr_paths(node, acc)
        return
    for fname in getattr(expr, "__dataclass_fields__", {}):
        v = getattr(expr, fname)
        if isinstance(v, ast.Expr):
            _attr_paths(v, acc)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, ast.Expr):
                    _attr_paths(item, acc)
                elif (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and isinstance(item[1], ast.Expr)
                ):
                    _attr_paths(item[1], acc)


_PRIMITIVE_TYPES = frozenset(
    {"String", "Long", "Boolean", "Bool", "Set", "Record", "Entity",
     "Extension", "ipaddr", "decimal", "__cedar::String", "__cedar::Long",
     "__cedar::Boolean"}
)


def _resolve_type(
    schema: CedarSchema, ns_name: str, ref: str
) -> Tuple[Optional[object], str]:
    """Resolve a type reference (namespace-relative first) to its shape and
    the namespace it was found in."""
    if ns_name:
        qualified = f"{ns_name}::{ref}"
        shape = schema.get_entity_shape(qualified)
        if shape is not None:
            return shape, "::".join(qualified.split("::")[:-1])
    shape = schema.get_entity_shape(ref)
    if shape is not None:
        return shape, "::".join(ref.split("::")[:-1])
    return None, ns_name


def _shape_has_path(schema: CedarSchema, type_name: str, path) -> bool:
    shape = schema.get_entity_shape(type_name)
    if shape is None:
        return True  # unknown shape: cannot tell
    ns_name = "::".join(type_name.split("::")[:-1])
    attrs = shape.attributes
    for i, comp in enumerate(path):
        attr = attrs.get(comp)
        if attr is None:
            return False
        if i == len(path) - 1:
            return True
        if attr.attributes:
            attrs = attr.attributes
            continue
        # `Entity`-typed attributes carry the target in .name; common-type
        # references carry it in .type (namespace-relative)
        ref = attr.name if attr.type == "Entity" else attr.type
        if not ref or attr.type in _PRIMITIVE_TYPES and attr.type != "Entity":
            return True  # sets / primitives / opaque types: stop judging
        inner, inner_ns = _resolve_type(schema, ns_name, ref)
        if inner is None:
            return True
        attrs = inner.attributes
        ns_name = inner_ns
    return True


def _candidate_types(
    schema: CedarSchema, action_uids, which: str, memo: dict
) -> List[str]:
    """Qualified entity types an UNSCOPED principal/resource can take: the
    union of the policy's actions' appliesTo lists (every action's when the
    action scope is bare). Empty = no finite union (unknown action, or an
    action whose appliesTo is unrestricted) — the typechecker then stays
    permissive. appliesTo names are namespace-relative to their action.
    ``memo`` is scoped to one validation pass by the caller (never stored on
    the schema, which could be mutated between passes)."""
    key = (which, tuple((u.type, u.id) for u in action_uids))
    if key in memo:
        return memo[key]
    pairs = []  # (action namespace, action shape)
    if action_uids:
        for uid in action_uids:
            shape = _action_shape(schema, uid)
            if shape is None:
                return []  # unknown action already has its own finding
            pairs.append(("::".join(uid.type.split("::")[:-1]), shape))
    else:
        for ns, namespace in schema.namespaces.items():
            pairs.extend((ns, shape) for shape in namespace.actions.values())
    out = set()
    for ns, shape in pairs:
        listed = (
            shape.applies_to.principal_types
            if which == "principal"
            else shape.applies_to.resource_types
        )
        if not listed:
            memo[key] = []
            return []  # applies to anything: no finite union
        for name in listed:
            qualified = f"{ns}::{name}" if "::" not in name and ns else name
            out.add(
                qualified if _entity_type_exists(schema, qualified) else name
            )
    result = sorted(out)
    memo[key] = result
    return result


def _scope_type(scope: ast.Scope) -> Optional[str]:
    if scope.op in ("is", "is_in"):
        return scope.entity_type
    if scope.op == "eq" and scope.entity is not None:
        return scope.entity.type
    return None


def validate_policy(
    schema: CedarSchema,
    policy: ast.Policy,
    filename: str,
    _memo: Optional[dict] = None,
) -> List[Finding]:
    findings: List[Finding] = []
    memo = _memo if _memo is not None else {}

    def finding(msg: str) -> None:
        findings.append(Finding(filename, policy.policy_id, msg))

    # ---- scope entity types
    for var, scope in (
        ("principal", policy.principal),
        ("resource", policy.resource),
    ):
        t = _scope_type(scope)
        if t is not None and not _entity_type_exists(schema, t):
            finding(f"{var} scope references unknown entity type {t!r}")
        if scope.op in ("in", "is_in") and scope.entity is not None:
            if not _entity_type_exists(schema, scope.entity.type):
                finding(
                    f"{var} scope `in` references unknown entity type "
                    f"{scope.entity.type!r}"
                )

    # ---- actions
    action_uids = ()
    if policy.action.op == "eq" and policy.action.entity is not None:
        action_uids = (policy.action.entity,)
    elif policy.action.op == "in":
        action_uids = policy.action.entities or (
            (policy.action.entity,) if policy.action.entity else ()
        )
    action_shapes = []
    for uid in action_uids:
        shape = _action_shape(schema, uid)
        if shape is None:
            finding(f"unknown action {uid.type}::\"{uid.id}\"")
        else:
            action_shapes.append((uid, shape))

    # ---- appliesTo compatibility. Types in appliesTo lists are written
    # relative to the action's own namespace (qualified only when they live
    # elsewhere), so resolve both spellings of the policy's type.
    p_type = _scope_type(policy.principal)
    r_type = _scope_type(policy.resource)

    def applies(uid, type_name: str, listed: List[str]) -> bool:
        action_ns = "::".join(uid.type.split("::")[:-1])
        candidates = {type_name}
        if action_ns and type_name.startswith(action_ns + "::"):
            candidates.add(type_name[len(action_ns) + 2 :])
        return any(c in listed for c in candidates)

    # `action in [...]` matches if ANY member applies — an inapplicable
    # member is dead code (the reference converter emits such members for
    # mixed impersonate+resource verb lists, converter.go:115-131), so only
    # a set where NO member applies is an error. `action ==` stays strict.
    if action_shapes:
        p_ok = [
            not (p_type and s.applies_to.principal_types)
            or applies(u, p_type, s.applies_to.principal_types)
            for u, s in action_shapes
        ]
        r_ok = [
            not (r_type and s.applies_to.resource_types)
            or applies(u, r_type, s.applies_to.resource_types)
            for u, s in action_shapes
        ]
        strict = policy.action.op == "eq"
        for i, (uid, _) in enumerate(action_shapes):
            if strict and not p_ok[i]:
                finding(
                    f"action \"{uid.id}\" does not apply to principal type {p_type}"
                )
            if strict and not r_ok[i]:
                finding(
                    f"action \"{uid.id}\" does not apply to resource type {r_type}"
                )
        if not strict:
            if not any(p_ok):
                finding(
                    f"no action in the set applies to principal type {p_type}"
                )
            if not any(r_ok):
                finding(
                    f"no action in the set applies to resource type {r_type}"
                )

    # ---- scope `in` feasibility: `principal in T::"x"` can only hold when
    # some possible type of the variable equals T or lists T in its
    # (transitive) memberOfTypes — otherwise the policy is dead, like the
    # Rust validator's impossible-hierarchy findings
    for var, scope in (
        ("principal", policy.principal),
        ("resource", policy.resource),
    ):
        if scope.op not in ("in", "is_in") or scope.entity is None:
            continue
        target = scope.entity.type
        if not _entity_type_exists(schema, target):
            continue  # unknown-type finding already emitted above
        if scope.op == "is_in":
            cands = [scope.entity_type]
        else:
            cands = _candidate_types(schema, action_uids, var, memo)
        if cands and not any(
            in_feasible(schema, c, target) for c in cands
        ):
            finding(
                f"{var} scope `in` {target} can never hold: no possible "
                f"{var} type is a member of {target}"
            )

    # ---- attribute accesses on pinned types
    paths: Set[Tuple[str, Tuple[str, ...]]] = set()
    for cond in policy.conditions:
        _attr_paths(cond.body, paths)
    for var, path in sorted(paths):
        t = p_type if var == "principal" else r_type
        if t is None:
            continue
        if not _shape_has_path(schema, t, path):
            finding(
                f"{var} ({t}) has no attribute path {'.'.join(path)!r}"
            )

    # ---- operand typechecking (schema/typecheck.py). Unscoped variables
    # are typed by the agreement of their possible types (appliesTo union),
    # so `permit (principal, action, resource) when { principal.name < 3 }`
    # is a finding even without a scope constraint.
    from ..schema.typecheck import typecheck_policy

    for msg in typecheck_policy(
        schema,
        policy,
        p_type,
        r_type,
        principal_candidates=(
            None
            if p_type
            else _candidate_types(schema, action_uids, "principal", memo)
        ),
        resource_candidates=(
            None
            if r_type
            else _candidate_types(schema, action_uids, "resource", memo)
        ),
        union_memo=memo,
    ):
        finding(f"type error: {msg}")
    return findings


def validate_file(
    schema: CedarSchema, path: pathlib.Path, _memo: Optional[dict] = None
) -> Tuple[int, List[Finding]]:
    try:
        text = path.read_text()
    except OSError as e:
        return 0, [Finding(str(path), "", f"unreadable: {e}")]
    try:
        policies = parse_policies(text, filename=str(path))
    except ParseError as e:
        return 0, [Finding(str(path), "", f"parse error: {e}")]
    findings: List[Finding] = []
    memo = _memo if _memo is not None else {}
    for p in policies:
        findings.extend(validate_policy(schema, p, str(path), _memo=memo))
    return len(policies), findings


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cedar-validator",
        description="Validate Cedar policies against a generated schema",
    )
    parser.add_argument(
        "--schema",
        required=True,
        help="schema JSON (schema-generator output, e.g. "
        "cedarschema/k8s-full.cedarschema.json)",
    )
    parser.add_argument(
        "paths", nargs="+", help="*.cedar files or directories to validate"
    )
    args = parser.parse_args(argv)

    schema = CedarSchema.from_json(json.loads(pathlib.Path(args.schema).read_text()))

    files: List[pathlib.Path] = []
    for p in args.paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.cedar")))
        else:
            files.append(path)

    total_policies = 0
    all_findings: List[Finding] = []
    memo: dict = {}  # one validation pass, one cache lifetime
    for f in files:
        n, findings = validate_file(schema, f, _memo=memo)
        total_policies += n
        all_findings.extend(findings)

    for finding in all_findings:
        print(finding, file=sys.stderr)
    print(
        f"validated {total_policies} policies in {len(files)} files: "
        f"{len(all_findings)} finding(s)"
    )
    return 1 if all_findings else 0


if __name__ == "__main__":
    sys.exit(main())
