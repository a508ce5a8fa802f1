"""Static operand typechecking of Cedar policies against a generated schema.

Fills the CI role the reference delegates to the Rust ``cedar-policy-cli``
validator (the upstream project's Makefile:158-163,
.github/workflows/cedar-validation.yaml): beyond existence checks, operand
TYPES are verified, so ``principal.name < 3`` (comparing a String to a
Long), ``like`` over a Long, or ``contains`` on a non-set are rejected at
validation time instead of silently never matching (or erroring) at runtime.

The checker is permissive exactly where the schema is silent — attributes
on unpinned variables, ``context``, unknown common types — matching
cedar's permissive validation mode: only provable mismatches are findings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..lang import ast
from .model import Attribute, AttributeElement, CedarSchema, EntityShape

# type kinds
STRING = "String"
LONG = "Long"
BOOL = "Boolean"
SET = "Set"
RECORD = "Record"
ENTITY = "Entity"
EXT = "Extension"
UNKNOWN = "Unknown"

_PRIMITIVES = {
    "String": STRING,
    "__cedar::String": STRING,
    "Long": LONG,
    "__cedar::Long": LONG,
    "Boolean": BOOL,
    "Bool": BOOL,
    "__cedar::Boolean": BOOL,
}


@dataclass
class TC:
    """An inferred static type. UNKNOWN is top: it silences all checks."""

    kind: str
    element: Optional["TC"] = None  # Set element
    attrs: Optional[Dict[str, Attribute]] = None  # Record / entity shape
    entity: str = ""  # Entity type name
    ns: str = ""  # namespace attribute refs resolve against

    def __str__(self):
        if self.kind == SET and self.element is not None:
            return f"Set<{self.element}>"
        if self.kind == ENTITY and self.entity:
            return self.entity
        return self.kind


_UNKNOWN = TC(UNKNOWN)
_STR = TC(STRING)
_LONG = TC(LONG)
_BOOL = TC(BOOL)


def entity_def(schema: CedarSchema, name: str):
    """The schema's Entity definition for a QUALIFIED type name, or None."""
    parts = name.split("::")
    namespace = schema.namespaces.get("::".join(parts[:-1]))
    return namespace.entity_types.get(parts[-1]) if namespace else None


def in_feasible(schema: CedarSchema, var_type: str, target_type: str) -> bool:
    """Can an entity of `var_type` ever satisfy ``in target_type::"..."``?
    Yes iff the types are equal or target is reachable through the
    transitive memberOfTypes closure. PERMISSIVE when either side is
    undeclared in the schema — silence is not evidence of infeasibility.
    Shared by the validator's scope-level check and the typechecker's
    condition-level check so the two surfaces can't drift."""
    if var_type == target_type:
        return True
    if entity_def(schema, var_type) is None or entity_def(schema, target_type) is None:
        return True
    frontier = [var_type]
    seen = {var_type}
    while frontier:
        cur = frontier.pop()
        ent = entity_def(schema, cur)
        if ent is None:
            # an UNDECLARED type one hop into the chain is the same schema
            # silence as an undeclared var/target: its memberships are
            # unknown, so the hierarchy cannot be proven infeasible
            return True
        ns = "::".join(cur.split("::")[:-1])
        for m in ent.member_of_types:
            # resolve the edge the way entity references resolve: the
            # ns-qualified spelling wins when it is declared; compare the
            # target against the RESOLVED spelling only (the raw name may
            # coincide with a different namespace's type)
            q = f"{ns}::{m}" if "::" not in m and ns else m
            nxt = q if entity_def(schema, q) is not None else m
            if nxt == target_type:
                return True
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return False


class TypeChecker:
    def __init__(
        self,
        schema: CedarSchema,
        principal_type: Optional[str],
        resource_type: Optional[str],
        principal_candidates: Optional[List[str]] = None,
        resource_candidates: Optional[List[str]] = None,
        union_memo: Optional[dict] = None,
    ):
        """A pinned scope type takes precedence; otherwise a non-empty
        candidate list (the possible types the request variable can take,
        e.g. from the actions' appliesTo sets) types the variable as the
        AGREEMENT of the candidates — like the Rust validator, which checks
        every request environment, ``principal.name < 3`` is then a finding
        even when the scope is bare ``principal``. ``union_memo`` (optional)
        caches union TCs across policies within one validation pass; it must
        not outlive schema mutations, which is why the caller owns it."""
        self.schema = schema
        self._union_memo = union_memo if union_memo is not None else {}
        self.vars = {
            "principal": (
                self._entity_tc(principal_type)
                if principal_type
                else self._union_entity_tc(principal_candidates or [])
            ),
            "resource": (
                self._entity_tc(resource_type)
                if resource_type
                else self._union_entity_tc(resource_candidates or [])
            ),
            "action": _UNKNOWN,
            "context": _UNKNOWN,
        }
        self.findings: List[str] = []

    # ------------------------------------------------------------- resolve

    def _entity_tc(self, type_name: Optional[str]) -> TC:
        if not type_name:
            return _UNKNOWN
        shape = self.schema.get_entity_shape(type_name)
        ns = "::".join(type_name.split("::")[:-1])
        if shape is None:
            return TC(ENTITY, entity=type_name, ns=ns)
        return TC(ENTITY, attrs=shape.attributes, entity=type_name, ns=ns)

    @staticmethod
    def _prim_sig(t: TC) -> Optional[str]:
        """Namespace-independent type signature, or None when the type can't
        be compared across namespaces (entities, records, unknowns). Union
        attributes are restricted to these so one TC (with a single ``ns``)
        can represent attributes drawn from shapes in many namespaces."""
        if t.kind in (STRING, LONG, BOOL, EXT):
            return t.kind
        if (
            t.kind == SET
            and t.element is not None
            and t.element.kind in (STRING, LONG, BOOL, EXT)
        ):
            return f"Set<{t.element.kind}>"
        return None

    def _union_entity_tc(self, candidates: List[str]) -> TC:
        """TC for a variable that may be ANY of `candidates` at request
        time. An attribute is typed iff every candidate THAT DEFINES IT
        agrees on a primitive signature: a mismatch finding is then sound in
        every request environment — on defining candidates the operand types
        are proven, and on candidates lacking the attribute the access
        errors at runtime (the policy never matches), which is exactly the
        dead code the finding reports. Attributes with DISAGREEING or
        non-primitive signatures drop to UNKNOWN (permissive: no false
        findings). ``entity`` stays empty so entity-identity checks don't
        fire. Memoized per validation pass (``union_memo``): the bare-action
        union scans every shape in the schema."""
        if not candidates:
            return _UNKNOWN
        if len(candidates) == 1:
            return self._entity_tc(candidates[0])
        memo = self._union_memo
        key = tuple(candidates)
        cached = memo.get(key)
        if cached is not None:
            return cached
        sigs: Dict[str, set] = {}
        for name in candidates:
            shape = self.schema.get_entity_shape(name)
            if shape is None:
                # an unresolvable candidate could carry ANY attribute types
                # at request time; deriving findings from the resolvable
                # subset would be unsound — go fully permissive, same as a
                # pinned scope of an unknown type (_entity_tc attrs=None)
                memo[key] = _UNKNOWN
                return _UNKNOWN
            ns = "::".join(name.split("::")[:-1])
            for aname, attr in shape.attributes.items():
                sigs.setdefault(aname, set()).add(
                    self._prim_sig(self._attr_tc(attr, ns))
                )
        union_attrs: Dict[str, Attribute] = {}
        for aname, s in sigs.items():
            if len(s) != 1:
                continue
            sig = next(iter(s))
            if sig is None:
                continue
            # synthesize an ns-INDEPENDENT attribute from the agreed
            # signature: a candidate's raw Attribute could hold a namespace-
            # relative common-type ref that resolves differently (or not at
            # all) under this TC's empty ns
            if sig.startswith("Set<"):
                union_attrs[aname] = Attribute(
                    type="Set", element=AttributeElement(type=sig[4:-1])
                )
            else:
                union_attrs[aname] = Attribute(type=sig)
        out = (
            TC(ENTITY, attrs=union_attrs, entity="", ns="")
            if union_attrs
            else _UNKNOWN
        )
        memo[key] = out
        return out

    def _resolve_common(self, ns: str, ref: str) -> Optional[EntityShape]:
        if ns:
            shape = self.schema.get_entity_shape(f"{ns}::{ref}")
            if shape is not None:
                return shape
        return self.schema.get_entity_shape(ref)

    def _attr_tc(self, attr: Attribute, ns: str) -> TC:
        prim = _PRIMITIVES.get(attr.type)
        if prim is not None:
            return TC(prim)
        if attr.type == "Set":
            elem = _UNKNOWN
            if attr.element is not None:
                elem = self._attr_tc(
                    Attribute(type=attr.element.type, name=attr.element.name),
                    ns,
                )
            return TC(SET, element=elem)
        if attr.type == "Record":
            return TC(RECORD, attrs=attr.attributes, ns=ns)
        if attr.type == "Entity":
            name = attr.name
            if name and "::" not in name and ns:
                name = f"{ns}::{name}"
            return self._entity_tc(name)
        if attr.type == "Extension":
            return TC(EXT)
        # common-type reference (namespace-relative)
        inner = self._resolve_common(ns, attr.type)
        if inner is None:
            return _UNKNOWN
        inner_ns = ns
        if "::" in attr.type:
            inner_ns = "::".join(attr.type.split("::")[:-1])
        if inner.type == "Record":
            return TC(RECORD, attrs=inner.attributes, ns=inner_ns)
        prim = _PRIMITIVES.get(inner.type)
        if prim is not None:
            return TC(prim)
        return _UNKNOWN

    # --------------------------------------------------------------- infer

    def err(self, msg: str) -> None:
        if msg not in self.findings:
            self.findings.append(msg)

    def _expect(self, got: TC, want: str, what: str) -> None:
        if got.kind != UNKNOWN and got.kind != want:
            self.err(f"{what} must be {want}, got {got}")

    def infer(self, e: ast.Expr) -> TC:
        if isinstance(e, ast.Lit):
            v = e.value
            if type(v) is bool:
                return _BOOL
            if type(v) is int:
                return _LONG
            return _STR
        if isinstance(e, ast.Var):
            return self.vars.get(e.name, _UNKNOWN)
        if isinstance(e, ast.EntityLit):
            return self._entity_tc(e.uid.type)
        if isinstance(e, (ast.GetAttr, ast.HasAttr)):
            obj = self.infer(e.obj)
            if isinstance(e, ast.HasAttr):
                return _BOOL
            if obj.kind in (ENTITY, RECORD) and obj.attrs is not None:
                attr = obj.attrs.get(e.attr)
                if attr is None:
                    return _UNKNOWN  # existence is the validator's finding
                return self._attr_tc(attr, obj.ns)
            if obj.kind not in (ENTITY, RECORD, UNKNOWN):
                self.err(f"attribute access .{e.attr} on {obj}")
            return _UNKNOWN
        if isinstance(e, (ast.And, ast.Or)):
            op = "&&" if isinstance(e, ast.And) else "||"
            self._expect(self.infer(e.left), BOOL, f"left operand of {op}")
            self._expect(self.infer(e.right), BOOL, f"right operand of {op}")
            return _BOOL
        if isinstance(e, ast.Unary):
            t = self.infer(e.arg)
            if e.op == "!":
                self._expect(t, BOOL, "operand of !")
                return _BOOL
            self._expect(t, LONG, "operand of unary -")
            return _LONG
        if isinstance(e, ast.If):
            self._expect(self.infer(e.cond), BOOL, "if condition")
            t1, t2 = self.infer(e.then), self.infer(e.els)
            if t1.kind == t2.kind and t1.kind != UNKNOWN:
                return t1
            return _UNKNOWN
        if isinstance(e, ast.Binary):
            lt, rt = self.infer(e.left), self.infer(e.right)
            if e.op in ("<", "<=", ">", ">="):
                self._expect(lt, LONG, f"left operand of {e.op}")
                self._expect(rt, LONG, f"right operand of {e.op}")
                return _BOOL
            if e.op in ("+", "-", "*"):
                self._expect(lt, LONG, f"left operand of {e.op}")
                self._expect(rt, LONG, f"right operand of {e.op}")
                return _LONG
            if e.op in ("==", "!="):
                if (
                    lt.kind != UNKNOWN
                    and rt.kind != UNKNOWN
                    and lt.kind != rt.kind
                ):
                    self.err(
                        f"{e.op} between {lt} and {rt} is always "
                        f"{'false' if e.op == '==' else 'true'}"
                    )
                elif (
                    lt.kind == ENTITY
                    and rt.kind == ENTITY
                    and lt.entity
                    and rt.entity
                    and lt.entity != rt.entity
                ):
                    self.err(
                        f"{e.op} between entity types {lt.entity} and "
                        f"{rt.entity} is always "
                        f"{'false' if e.op == '==' else 'true'}"
                    )
                return _BOOL
            if e.op == "in":
                if lt.kind not in (ENTITY, UNKNOWN):
                    self.err(f"left operand of `in` must be an entity, got {lt}")
                if rt.kind not in (ENTITY, SET, UNKNOWN):
                    self.err(
                        f"right operand of `in` must be an entity or set, got {rt}"
                    )
                if (
                    lt.kind == ENTITY
                    and rt.kind == ENTITY
                    and lt.entity
                    and rt.entity
                    and not in_feasible(self.schema, lt.entity, rt.entity)
                ):
                    self.err(
                        f"`in` between {lt.entity} and {rt.entity} is "
                        "always false: the hierarchy never relates them"
                    )
                return _BOOL
            return _UNKNOWN
        if isinstance(e, ast.Like):
            self._expect(self.infer(e.obj), STRING, "operand of like")
            return _BOOL
        if isinstance(e, ast.Is):
            t = self.infer(e.obj)
            if t.kind not in (ENTITY, UNKNOWN):
                self.err(f"operand of `is` must be an entity, got {t}")
            if e.in_entity is not None:
                self.infer(e.in_entity)
            return _BOOL
        if isinstance(e, ast.SetLit):
            elems = [self.infer(x) for x in e.elems]
            kinds = {t.kind for t in elems}
            # pin the element type only when EVERY member is known and
            # agrees — an UNKNOWN member could be anything at runtime, so
            # judging membership against the known members would flag
            # expressions that can in fact be true (permissive contract)
            if elems and len(kinds) == 1 and UNKNOWN not in kinds:
                return TC(SET, element=elems[0])
            return TC(SET, element=_UNKNOWN)
        if isinstance(e, ast.RecordLit):
            return TC(RECORD, attrs=None)
        if isinstance(e, ast.MethodCall):
            obj = self.infer(e.obj)
            args = [self.infer(a) for a in e.args]
            if e.method == "contains":
                self._expect(obj, SET, "receiver of .contains()")
                if (
                    obj.kind == SET
                    and obj.element is not None
                    and obj.element.kind != UNKNOWN
                    and args
                    and args[0].kind != UNKNOWN
                    and args[0].kind != obj.element.kind
                ):
                    self.err(
                        f".contains({args[0]}) on {obj} is always false"
                    )
                return _BOOL
            if e.method in ("containsAll", "containsAny"):
                self._expect(obj, SET, f"receiver of .{e.method}()")
                if args:
                    self._expect(args[0], SET, f"argument of .{e.method}()")
                return _BOOL
            if e.method in ("isIpv4", "isIpv6", "isLoopback", "isMulticast"):
                self._expect(obj, EXT, f"receiver of .{e.method}()")
                return _BOOL
            if e.method in ("isInRange", "lessThan", "lessThanOrEqual",
                            "greaterThan", "greaterThanOrEqual"):
                self._expect(obj, EXT, f"receiver of .{e.method}()")
                if args:
                    self._expect(args[0], EXT, f"argument of .{e.method}()")
                return _BOOL
            return _UNKNOWN
        if isinstance(e, ast.ExtCall):
            for a in e.args:
                self.infer(a)
            return TC(EXT)
        return _UNKNOWN


def typecheck_policy(
    schema: CedarSchema,
    policy: ast.Policy,
    principal_type: Optional[str],
    resource_type: Optional[str],
    principal_candidates: Optional[List[str]] = None,
    resource_candidates: Optional[List[str]] = None,
    union_memo: Optional[dict] = None,
) -> List[str]:
    """Type findings for every when/unless condition of one policy."""
    tc = TypeChecker(
        schema,
        principal_type,
        resource_type,
        principal_candidates=principal_candidates,
        resource_candidates=resource_candidates,
        union_memo=union_memo,
    )
    for cond in policy.conditions:
        t = tc.infer(cond.body)
        if t.kind not in (BOOL, UNKNOWN):
            tc.err(f"{cond.kind} condition must be Boolean, got {t}")
    return tc.findings
