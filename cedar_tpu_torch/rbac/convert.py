"""RBAC → Cedar compiler: (Cluster)RoleBinding + (Cluster)Role → permit policies.

Behavior parity with reference internal/convert/converter.go (rbacToCedar :31
and helpers), including:
  * subjects → principal constraints: Group → ``principal in k8s::Group``,
    User → ``principal is k8s::User`` + name equality condition, ServiceAccount
    → ``principal is k8s::ServiceAccount`` + namespace/name conditions; SAs
    whose synthesized ``system:serviceaccount:ns:name`` ID doesn't split into
    4 parts are skipped (:73-89)
  * verbs dedupe + star-collapse; one verb → ``action ==``, several →
    ``action in [...]``, ``*`` → unconstrained action (:91-105)
  * nonResourceURLs rules target ``k8s::NonResourceURL`` with path eq /
    trailing-glob ``like`` / set-contains conditions (:107-113, :237-271)
  * the impersonation expansion: a wildcard rule (* verbs/resources/apiGroups)
    or an explicit impersonate + authentication.k8s.io rule emits an extra
    ``action == k8s::Action::"impersonate"`` policy over principal-typed
    resources (users/groups/uids/userextras/<key>), with resourceNames
    narrowing (:115-131, :293-421)
  * apiGroups / resources / subresources / resourceNames conditions with the
    mixed resource+subresource OR structure (:133-158, :423-521)
  * namespace condition for Role-derived policies (:142-149)
  * ``unless { resource has subresource }`` when the rule names no
    subresource (:154-156)
  * provenance annotations (binding/role names, zero-padded policyRule index,
    namespace) and the reference's policy-ID scheme (:60-69, :110, :124, :159)
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..lang.ast import (
    And,
    Binary,
    Condition,
    EntityLit,
    Expr,
    GetAttr,
    HasAttr,
    Is,
    Like,
    Lit,
    MethodCall,
    Or,
    Pattern,
    Policy,
    Scope,
    SetLit,
    Var,
    WILDCARD,
)
from ..lang.authorize import PolicySet
from ..lang.values import EntityUID
from ..schema import consts

log = logging.getLogger(__name__)

# ------------------------------------------------------------ RBAC data model


@dataclass
class Subject:
    kind: str  # User | Group | ServiceAccount
    name: str
    namespace: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Subject":
        return cls(
            kind=d.get("kind", ""),
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
        )


@dataclass
class PolicyRule:
    verbs: List[str] = field(default_factory=list)
    api_groups: List[str] = field(default_factory=list)
    resources: List[str] = field(default_factory=list)
    resource_names: List[str] = field(default_factory=list)
    non_resource_urls: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyRule":
        return cls(
            verbs=list(d.get("verbs") or []),
            api_groups=list(d.get("apiGroups") or []),
            resources=list(d.get("resources") or []),
            resource_names=list(d.get("resourceNames") or []),
            non_resource_urls=list(d.get("nonResourceURLs") or []),
        )


@dataclass
class RoleRef:
    api_group: str = ""
    kind: str = ""
    name: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "RoleRef":
        return cls(
            api_group=d.get("apiGroup", ""),
            kind=d.get("kind", ""),
            name=d.get("name", ""),
        )


@dataclass
class Binding:
    """A (Cluster)RoleBinding: name + subjects + roleRef."""

    kind: str  # ClusterRoleBinding | RoleBinding
    name: str
    namespace: str = ""
    subjects: List[Subject] = field(default_factory=list)
    role_ref: RoleRef = field(default_factory=RoleRef)

    @property
    def binder_type(self) -> str:
        return "roleBinding" if self.kind == "RoleBinding" else "clusterRoleBinding"

    @classmethod
    def from_dict(cls, d: dict, kind: Optional[str] = None) -> "Binding":
        meta = d.get("metadata") or {}
        return cls(
            kind=kind or d.get("kind", "ClusterRoleBinding"),
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            subjects=[Subject.from_dict(s) for s in d.get("subjects") or []],
            role_ref=RoleRef.from_dict(d.get("roleRef") or {}),
        )


@dataclass
class Role:
    """A (Cluster)Role: name + rules."""

    kind: str  # ClusterRole | Role
    name: str
    namespace: str = ""
    rules: List[PolicyRule] = field(default_factory=list)

    @property
    def ruler_type(self) -> str:
        return "role" if self.kind == "Role" else "clusterRole"

    @classmethod
    def from_dict(cls, d: dict, kind: Optional[str] = None) -> "Role":
        meta = d.get("metadata") or {}
        return cls(
            kind=kind or d.get("kind", "ClusterRole"),
            name=meta.get("name", ""),
            namespace=meta.get("namespace", ""),
            rules=[PolicyRule.from_dict(r) for r in d.get("rules") or []],
        )


# ---------------------------------------------------------------- entry points


def cluster_role_binding_to_cedar(binding: Binding, role: Role) -> PolicySet:
    return _rbac_to_cedar(binding, role, "")


def role_binding_to_cedar(binding: Binding, role: Role) -> PolicySet:
    return _rbac_to_cedar(binding, role, role.namespace or binding.namespace)


# ----------------------------------------------------------------- AST helpers


def _resource_attr(name: str) -> Expr:
    return GetAttr(Var("resource"), name)


def _principal_attr(name: str) -> Expr:
    return GetAttr(Var("principal"), name)


def _eq(lhs: Expr, s: str) -> Expr:
    return Binary("==", lhs, Lit(s))


def _set_contains(values: List[str], item: Expr) -> Expr:
    return MethodCall(SetLit(tuple(Lit(v) for v in values)), "contains", (item,))


def _and(lhs: Optional[Expr], rhs: Optional[Expr]) -> Optional[Expr]:
    if lhs is not None:
        if rhs is not None:
            return And(lhs, rhs)
        return lhs
    return rhs


def _or(lhs: Optional[Expr], rhs: Optional[Expr]) -> Optional[Expr]:
    if lhs is not None:
        if rhs is not None:
            return Or(lhs, rhs)
        return lhs
    return rhs


def _glob_pattern(glob: str) -> Pattern:
    comps: List = []
    chunk = ""
    for ch in glob:
        if ch == "*":
            if chunk:
                comps.append(chunk)
                chunk = ""
            comps.append(WILDCARD)
        else:
            chunk += ch
    if chunk:
        comps.append(chunk)
    return Pattern(tuple(comps))


def _unique(items: List[str]) -> List[str]:
    out: List[str] = []
    for s in items:
        if s not in out:
            out.append(s)
    return out


def _reduce_if_star(items: List[str]) -> List[str]:
    return ["*"] if "*" in items else items


# ------------------------------------------------------------- the conversion


def _rbac_to_cedar(binder: Binding, ruler: Role, namespace: str) -> PolicySet:
    resp = PolicySet()

    principals: List[EntityUID] = []
    for subject in binder.subjects:
        if subject.kind == "Group":
            principals.append(EntityUID(consts.GROUP_ENTITY_TYPE, subject.name))
        elif subject.kind == "User":
            principals.append(EntityUID(consts.USER_ENTITY_TYPE, subject.name))
        elif subject.kind == "ServiceAccount":
            principals.append(
                EntityUID(
                    consts.SERVICE_ACCOUNT_ENTITY_TYPE,
                    f"system:serviceaccount:{subject.namespace}:{subject.name}",
                )
            )

    for pi, principal in enumerate(principals):
        for ri, rule in enumerate(ruler.rules):
            annotations = [
                (binder.binder_type, binder.name),
                (ruler.ruler_type, ruler.name),
                ("policyRule", f"{ri:02d}"),
            ]
            if namespace:
                annotations.append(("namespace", namespace))

            when: Optional[Expr] = None
            principal_scope = Scope("all")
            if principal.type == consts.GROUP_ENTITY_TYPE:
                principal_scope = Scope("in", entity=principal)
            elif principal.type == consts.SERVICE_ACCOUNT_ENTITY_TYPE:
                principal_scope = Scope(
                    "is", entity_type=consts.SERVICE_ACCOUNT_ENTITY_TYPE
                )
                parts = principal.id.split(":")
                if len(parts) != 4:
                    # invalid service-account ID: skip this rule (reference
                    # converter.go:78-81)
                    continue
                when = And(
                    _eq(_principal_attr("namespace"), parts[2]),
                    _eq(_principal_attr("name"), parts[3]),
                )
            elif principal.type == consts.USER_ENTITY_TYPE:
                principal_scope = Scope("is", entity_type=consts.USER_ENTITY_TYPE)
                when = _eq(_principal_attr("name"), principal.id)

            verbs = _reduce_if_star(_unique(rule.verbs))

            action_scope = Scope("all")
            if len(verbs) == 1 and verbs[0] != "*":
                action_scope = Scope(
                    "eq",
                    entity=EntityUID(
                        consts.AUTHORIZATION_ACTION_ENTITY_TYPE, verbs[0]
                    ),
                )
            elif len(verbs) > 1:
                action_scope = Scope(
                    "in",
                    entities=tuple(
                        EntityUID(consts.AUTHORIZATION_ACTION_ENTITY_TYPE, v)
                        for v in verbs
                    ),
                )

            def mk_policy(resource_scope, conditions, extra_annotations=()):
                return Policy(
                    effect="permit",
                    principal=principal_scope,
                    action=action_scope,
                    resource=resource_scope,
                    conditions=tuple(conditions),
                    annotations=tuple(annotations) + tuple(extra_annotations),
                )

            if rule.non_resource_urls:
                # Intentional divergence from the reference, which
                # drops the subject `when` here (converter.go:109 passes
                # emptyNode), so a User/ServiceAccount-subject binding over
                # nonResourceURLs permits EVERY user; we keep the subject
                # condition, which is what RBAC semantics require.
                cond = _and(when, _condition_for_non_resource_urls(rule))
                conditions = [Condition("when", cond)] if cond is not None else []
                resp.add(
                    mk_policy(
                        Scope("is", entity_type=consts.NON_RESOURCE_URL_ENTITY_TYPE),
                        conditions,
                    ),
                    policy_id=f"{binder.name}{pi}{ri}",
                )
                continue

            if not rule.resources:
                # a resource rule with no resources grants nothing in RBAC;
                # skip instead of emitting an unconstrained permit (the
                # reference would panic indexing rule.Resources[0] — it only
                # ever sees apiserver-validated objects)
                log.warning(
                    "rule %02d of %s %s has no resources; skipping",
                    ri,
                    ruler.ruler_type,
                    ruler.name,
                )
                continue

            is_full_wildcard = (
                verbs
                and verbs[0] == "*"
                and rule.resources
                and rule.resources[0] == "*"
                and rule.api_groups
                and rule.api_groups[0] == "*"
            )
            if is_full_wildcard or (
                "impersonate" in verbs and "authentication.k8s.io" in rule.api_groups
            ):
                imp_scope, imp_condition = _policy_for_impersonate(rule)
                imp_action = Scope(
                    "eq",
                    entity=EntityUID(
                        consts.AUTHORIZATION_ACTION_ENTITY_TYPE,
                        consts.AUTHORIZATION_ACTION_IMPERSONATE,
                    ),
                )
                cond = _and(when, imp_condition)
                conditions = [Condition("when", cond)] if cond is not None else []
                resp.add(
                    Policy(
                        effect="permit",
                        principal=principal_scope,
                        action=imp_action,
                        resource=imp_scope,
                        conditions=tuple(conditions),
                        annotations=tuple(annotations),
                    ),
                    policy_id=(
                        f"{binder.name}:{binder.binder_type}/impersonate:{pi}{ri}"
                    ),
                )
                if len(verbs) == 1 and verbs[0] == "impersonate":
                    # impersonate-only rules emit no resource policy
                    continue

            if not rule.api_groups:
                # malformed rule (file/stdin input isn't apiserver-validated):
                # skip instead of crashing the whole conversion
                log.warning(
                    "rule %02d of %s %s has no apiGroups; skipping",
                    ri,
                    ruler.ruler_type,
                    ruler.name,
                )
                continue

            api_groups = _reduce_if_star(_unique(rule.api_groups))
            resources = _reduce_if_star(_unique(rule.resources))
            resource_names = _unique(rule.resource_names)

            condition = _condition_for_api_groups(api_groups)
            condition = _condition_for_resources(condition, resources)
            condition = _condition_for_resource_names(condition, resource_names)

            if namespace:
                condition = _and(
                    condition,
                    And(
                        HasAttr(Var("resource"), "namespace"),
                        _eq(_resource_attr("namespace"), namespace),
                    ),
                )

            cond = _and(when, condition)
            conditions = [Condition("when", cond)] if cond is not None else []
            if not _has_sub_resources(resources):
                conditions.append(
                    Condition("unless", HasAttr(Var("resource"), "subresource"))
                )
            resp.add(
                mk_policy(
                    Scope("is", entity_type=consts.RESOURCE_ENTITY_TYPE), conditions
                ),
                policy_id=f"{binder.name}:{binder.binder_type}:{pi}{ri}",
            )
    return resp


def _condition_for_non_resource_urls(rule: PolicyRule) -> Optional[Expr]:
    urls = rule.non_resource_urls
    if len(urls) == 1:
        if urls[0] == "*":
            return None
        if urls[0].endswith("*"):
            return Like(_resource_attr("path"), _glob_pattern(urls[0]))
        return _eq(_resource_attr("path"), urls[0])

    wildcard = [u for u in urls if u.endswith("*")]
    plain = [u for u in urls if not u.endswith("*")]

    condition: Optional[Expr] = None
    for u in wildcard:
        condition = _or(condition, Like(_resource_attr("path"), _glob_pattern(u)))
    if len(plain) == 1:
        condition = _or(condition, _eq(_resource_attr("path"), plain[0]))
    elif len(plain) > 1:
        condition = _or(condition, _set_contains(plain, _resource_attr("path")))
    return condition


def _condition_for_api_groups(api_groups: List[str]) -> Optional[Expr]:
    if len(api_groups) == 1 and api_groups[0] == "*":
        return None
    if len(api_groups) > 1:
        return _set_contains(api_groups, _resource_attr("apiGroup"))
    return _eq(_resource_attr("apiGroup"), api_groups[0])


def _has_sub_resources(resources: List[str]) -> bool:
    return any("/" in r for r in resources)


def _subresource_condition(entry: str) -> Expr:
    """Condition for one ``resource/subresource`` entry."""
    left, right = entry.split("/", 1)
    condition: Optional[Expr] = None
    if left != "*":
        condition = _eq(_resource_attr("resource"), left)
    if right == "*":
        sub = And(
            HasAttr(Var("resource"), "subresource"),
            Binary("!=", _resource_attr("subresource"), Lit("")),
        )
    else:
        sub = And(
            HasAttr(Var("resource"), "subresource"),
            _eq(_resource_attr("subresource"), right),
        )
    return _and(condition, sub)


def _condition_for_resources(
    condition: Optional[Expr], resources: List[str]
) -> Optional[Expr]:
    if len(resources) == 1:
        if resources[0] == "*":
            return condition
        if "/" not in resources[0]:
            return _and(
                condition, _eq(_resource_attr("resource"), resources[0])
            )
        return _and(condition, _subresource_condition(resources[0]))

    sub_entries = [r for r in resources if "/" in r]
    regular = [r for r in resources if "/" not in r]

    sub_condition: Optional[Expr] = None
    for entry in sub_entries:
        sub_condition = _or(sub_condition, _subresource_condition(entry))

    resource_condition: Optional[Expr] = None
    if len(regular) == 1:
        resource_condition = _eq(_resource_attr("resource"), regular[0])
    elif len(regular) > 1:
        resource_condition = _set_contains(regular, _resource_attr("resource"))

    return _and(condition, _or(resource_condition, sub_condition))


def _condition_for_resource_names(
    condition: Optional[Expr], resource_names: List[str]
) -> Optional[Expr]:
    if len(resource_names) == 1:
        name_cond = And(
            HasAttr(Var("resource"), "name"),
            _eq(_resource_attr("name"), resource_names[0]),
        )
        return _and(condition, name_cond)
    if len(resource_names) > 1:
        name_cond = And(
            HasAttr(Var("resource"), "name"),
            _set_contains(resource_names, _resource_attr("name")),
        )
        return _and(condition, name_cond)
    return condition


# --------------------------------------------------------------- impersonation


def _policy_for_impersonate(rule: PolicyRule) -> Tuple[Scope, Optional[Expr]]:
    """Resource scope + condition for the impersonation policy (reference
    policyForImpersonate, converter.go:293-364). Operates on the raw
    (un-reduced) rule, like the reference."""
    condition: Optional[Expr] = None
    resources = rule.resources

    all_same = True
    r0 = resources[0] if resources else ""
    for r in resources:
        if r0.startswith("userextras"):
            if not r.startswith("userextras"):
                all_same = False
                break
            continue
        if r != r0:
            all_same = False
            break

    if all_same:
        scope = Scope("all")
        if r0 == "users":
            scope = Scope("is", entity_type=consts.USER_ENTITY_TYPE)
            condition = _condition_for_named_impersonation(condition, rule)
        elif r0 == "groups":
            scope = Scope("is", entity_type=consts.GROUP_ENTITY_TYPE)
            condition = _condition_for_named_impersonation(condition, rule)
        elif r0 == "uids":
            scope = Scope("is", entity_type=consts.PRINCIPAL_UID_ENTITY_TYPE)
            condition = _condition_for_uid_impersonation(condition, rule)
            if len(rule.resource_names) == 1:
                scope = Scope(
                    "eq",
                    entity=EntityUID(
                        consts.PRINCIPAL_UID_ENTITY_TYPE, rule.resource_names[0]
                    ),
                )
                return scope, condition
        if r0.startswith("userextras"):
            scope = Scope("is", entity_type=consts.EXTRA_VALUE_ENTITY_TYPE)
            condition = _condition_for_extra_impersonation(condition, rule)
        return scope, condition

    for resource in resources:
        local: Optional[Expr] = None
        if resource == "users":
            local = Is(Var("resource"), consts.USER_ENTITY_TYPE)
            local = _condition_for_named_impersonation(local, rule)
        elif resource == "groups":
            local = Is(Var("resource"), consts.GROUP_ENTITY_TYPE)
            local = _condition_for_named_impersonation(local, rule)
        elif resource == "uids":
            local = Is(Var("resource"), consts.PRINCIPAL_UID_ENTITY_TYPE)
            if len(rule.resource_names) == 1:
                local = Binary(
                    "==",
                    Var("resource"),
                    EntityLit(
                        EntityUID(
                            consts.PRINCIPAL_UID_ENTITY_TYPE,
                            rule.resource_names[0],
                        )
                    ),
                )
            local = _condition_for_uid_impersonation(local, rule)
        if resource.startswith("userextras"):
            local = Is(Var("resource"), consts.EXTRA_VALUE_ENTITY_TYPE)
            local = _condition_for_extra_impersonation(local, rule)
        condition = _or(local, condition)

    return Scope("all"), condition


def _condition_for_uid_impersonation(
    condition: Optional[Expr], rule: PolicyRule
) -> Optional[Expr]:
    if len(rule.resource_names) == 1:
        return condition
    # With no resourceNames this emits the never-true `resource in []`,
    # matching the reference (conditionForUidImpersonation builds the set
    # from an empty name list, converter.go:366-380) — fail-safe parity.
    uids = SetLit(
        tuple(
            EntityLit(EntityUID(consts.PRINCIPAL_UID_ENTITY_TYPE, name))
            for name in rule.resource_names
        )
    )
    return _and(condition, Binary("in", Var("resource"), uids))


def _condition_for_named_impersonation(
    condition: Optional[Expr], rule: PolicyRule
) -> Optional[Expr]:
    names = rule.resource_names
    if len(names) == 1:
        return _and(condition, _eq(_resource_attr("name"), names[0]))
    if len(names) > 1:
        return _and(condition, _set_contains(names, _resource_attr("name")))
    return condition


def _condition_for_extra_impersonation(
    condition: Optional[Expr], rule: PolicyRule
) -> Optional[Expr]:
    keys = [r.split("/", 1)[1] for r in rule.resources if "/" in r]
    if len(keys) == 1:
        condition = _and(condition, _eq(_resource_attr("key"), keys[0]))
    elif len(keys) > 1:
        condition = _and(condition, _set_contains(keys, _resource_attr("key")))

    names = rule.resource_names
    if len(names) == 1:
        condition = _and(
            condition,
            And(
                HasAttr(Var("resource"), "value"),
                _eq(_resource_attr("value"), names[0]),
            ),
        )
    elif len(names) > 1:
        condition = _and(
            condition,
            And(
                HasAttr(Var("resource"), "value"),
                _set_contains(names, _resource_attr("value")),
            ),
        )
    return condition
