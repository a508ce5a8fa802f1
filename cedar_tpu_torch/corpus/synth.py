"""Seeded synthesis of realistic org-wide (multi-cluster) policy sets.

The scale story (docs/performance.md "Giant policy sets") needs corpora with two properties real 100k-rule org stores have
and the 10k bench generator lacks:

  * **cluster locality** — most policies target ONE cluster's API groups
    (the serving-partition discriminator rides ``resource.apiGroup`` as
    the first ``when`` conjunct, a schema-mandatory attribute, so the
    partition pruner can prove never-match before lowering); a small
    fraction is org-wide (core groups, resident in every partition);
  * **edit stability** — every policy has its own filename + policy id
    and a per-policy derived RNG, so replacing one policy leaves every
    other Policy OBJECT (and its cached content fingerprint) untouched:
    exactly the CRD-store reload shape the shard differ keys on.

Determinism: ``synth_corpus(n, seed, clusters)`` twice yields identical
sources; per-policy parameters derive from ``Random((seed, i))``, never
from a shared stream, so an edit cannot reshuffle its neighbors.

The corpus also synthesizes matched traffic: ``sar_items``/``sar_bodies``
draw requests that hit the generated policies of ONE cluster (the
partition a serving process owns), and ``probe_request`` targets the
dedicated probe policy whose effect ``with_edit()`` flips — the
single-policy CRD edit the <1s edit-to-serving gate measures.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..lang.authorize import PolicySet
from ..lang.parser import parse_policies

CORE_GROUPS = ("", "apps", "rbac.authorization.k8s.io")
RESOURCES = (
    "pods", "services", "secrets", "configmaps", "deployments",
    "jobs", "statefulsets", "daemonsets", "cronjobs", "endpoints",
)
VERBS = ("get", "list", "watch", "create", "update", "delete", "patch")

PROBE_USER = "probe-user"
PROBE_RESOURCE = "probes"


def _cluster_groups(cluster: int, tenant: str = "") -> Tuple[str, ...]:
    # a tenant tag namespaces the cluster-local groups: multi-tenant
    # corpora get DISJOINT apiGroup universes per tenant (cross-tenant
    # content can never accidentally match), while CORE_GROUPS stay
    # shared org-wide — the slice that makes the isolation differential
    # sharp (without discriminators, tenant B's org-wide policies WOULD
    # flip tenant A's core-group decisions)
    tag = f"{tenant}." if tenant else ""
    return (
        f"platform.{tag}c{cluster}.corp",
        f"data.{tag}c{cluster}.corp",
        f"ml.{tag}c{cluster}.corp",
    )


@dataclass
class _PolicyParams:
    """The request-relevant parameters one synthesized policy was built
    from — retained so traffic synthesis can aim at real policies without
    re-parsing anything."""

    kind: str
    cluster: int  # -1 = org-wide (core groups)
    group: str
    team: str = ""
    user: str = ""
    ns: str = ""
    resource: str = ""
    verbs: Tuple[str, ...] = ()


def _policy_source(
    i: int, seed: int, clusters: int, tenant: str = ""
) -> Tuple[str, _PolicyParams]:
    rng = random.Random(f"{seed}:{i}")
    cluster = i % clusters
    org_wide = rng.random() < 0.02
    if org_wide:
        group = rng.choice(CORE_GROUPS)
        cluster = -1
    else:
        group = rng.choice(_cluster_groups(cluster, tenant))
    prefix = "org" if org_wide else f"c{cluster}"
    team = f"{prefix}-team-{rng.randint(0, 99)}"
    user = f"{prefix}-user-{rng.randint(0, 499)}"
    ns = f"{prefix}-ns-{rng.randint(0, 199)}"
    res = rng.choice(RESOURCES)
    verbs = tuple(rng.sample(VERBS, rng.randint(1, 3)))
    acts = ", ".join(f'k8s::Action::"{v}"' for v in verbs)
    kind = rng.random()
    if kind < 0.55:
        src = (
            f'permit (principal in k8s::Group::"{team}", action in [{acts}], '
            "resource is k8s::Resource) when { "
            f'resource.apiGroup == "{group}" && '
            f'resource.resource == "{res}" && '
            "resource has namespace && "
            f'resource.namespace == "{ns}" }};'
        )
        params = _PolicyParams(
            "team", cluster, group, team=team, ns=ns, resource=res,
            verbs=verbs,
        )
    elif kind < 0.75:
        src = (
            f"permit (principal is k8s::User, action in [{acts}], "
            "resource is k8s::Resource) when { "
            f'resource.apiGroup == "{group}" && '
            f'principal.name == "{user}" && '
            f'resource.resource == "{res}" }};'
        )
        params = _PolicyParams(
            "user", cluster, group, user=user, resource=res, verbs=verbs
        )
    elif kind < 0.9:
        src = (
            "permit (principal, action in [k8s::Action::\"get\", "
            'k8s::Action::"list", k8s::Action::"watch"], '
            "resource is k8s::Resource) when { "
            f'resource.apiGroup == "{group}" && '
            f'resource.resource == "{res}" && '
            "resource has namespace && "
            f'resource.namespace == "{ns}" }};'
        )
        params = _PolicyParams(
            "read", cluster, group, ns=ns, resource=res,
            verbs=("get", "list", "watch"),
        )
    else:
        src = (
            f"forbid (principal, action in [{acts}], "
            "resource is k8s::Resource) when { "
            f'resource.apiGroup == "{group}" && '
            f'resource.resource == "secrets" && '
            "resource has namespace && "
            f'resource.namespace == "{ns}" }};'
        )
        params = _PolicyParams(
            "forbid", cluster, group, ns=ns, resource="secrets", verbs=verbs
        )
    return src, params


def _probe_source(effect: str, tenant: str = "") -> str:
    group = _cluster_groups(0, tenant)[0]
    return (
        f'{effect} (principal is k8s::User, action == k8s::Action::"get", '
        "resource is k8s::Resource) when { "
        f'resource.apiGroup == "{group}" && '
        f'principal.name == "{PROBE_USER}" && '
        f'resource.resource == "{PROBE_RESOURCE}" }};'
    )


@dataclass
class SynthCorpus:
    policies: List[object]  # parsed lang.ast.Policy, one filename each
    params: List[_PolicyParams]
    n: int
    seed: int
    clusters: int
    probe_index: int = 0
    probe_effect: str = "permit"
    # multi-tenant corpora (synth_tenant_corpora): the tenant tag that
    # namespaces this corpus's cluster-local apiGroups — "" keeps every
    # generated byte identical to the single-tenant form
    tenant: str = ""
    _tier_cache: Optional[List[PolicySet]] = field(default=None, repr=False)

    # ----------------------------------------------------------- policy side

    def tiers(self) -> List[PolicySet]:
        """The corpus as a single-tier stack (cached: repeated loads must
        hand the engine IDENTICAL Policy objects, like a store would)."""
        if self._tier_cache is None:
            self._tier_cache = [PolicySet(list(self.policies))]
        return self._tier_cache

    def with_edit(self, index: Optional[int] = None) -> "SynthCorpus":
        """The corpus after one single-policy CRD edit: by default the
        probe policy's effect flips (permit <-> forbid), re-parsed alone
        under its own filename — every OTHER Policy object is shared by
        identity with this corpus, exactly like a CRD-store relist that
        reparses one changed object."""
        idx = self.probe_index if index is None else index
        effect = self.probe_effect
        if idx == self.probe_index:
            effect = "forbid" if effect == "permit" else "permit"
            src = _probe_source(effect, self.tenant)
        else:
            src, _ = _policy_source(idx, self.seed, self.clusters, self.tenant)
            # flip WHICHEVER effect the policy has — a permit-only
            # replace on a forbid-kind policy would be a silent no-op
            # edit (identical corpus, dirty_shards == 0) and fail far
            # from the cause
            if src.startswith("permit "):
                src = "forbid " + src[len("permit "):]
            elif src.startswith("forbid "):
                src = "permit " + src[len("forbid "):]
            else:  # unreachable for generated sources; fail loudly
                raise ValueError(f"with_edit: unrecognized effect in {src[:40]!r}")
        old = self.policies[idx]
        p = parse_policies(src, old.filename)[0]
        p.policy_id = old.policy_id
        pols = list(self.policies)
        pols[idx] = p
        return SynthCorpus(
            policies=pols,
            params=self.params,
            n=self.n,
            seed=self.seed,
            clusters=self.clusters,
            probe_index=self.probe_index,
            probe_effect=effect,
            tenant=self.tenant,
        )

    def partition_dict(self, cluster: int) -> dict:
        """The serving-partition spec for one cluster: its API groups
        plus the org-wide core groups."""
        return {
            "name": f"cluster-{cluster}",
            "slots": {
                "resource.apiGroup": list(
                    CORE_GROUPS + _cluster_groups(cluster, self.tenant)
                ),
            },
        }

    # ---------------------------------------------------------- traffic side

    def _attrs(self, rng: random.Random, cluster: int):
        """One in-partition SAR's attributes, aimed at the generated
        policies: ~80% target a known policy's (group, resource, ns,
        verb), the rest draw in-universe misses."""
        from ..entities.attributes import Attributes, UserInfo

        cluster_params = [
            p
            for p in self.params
            if p.cluster in (cluster, -1) and p.kind != "probe"
        ]
        if cluster_params and rng.random() < 0.8:
            p = rng.choice(cluster_params)
            user = p.user or f"c{cluster}-user-{rng.randint(0, 499)}"
            groups: Tuple[str, ...] = (p.team,) if p.team else ()
            return Attributes(
                user=UserInfo(name=user, uid="u", groups=groups),
                verb=rng.choice(p.verbs or VERBS),
                namespace=p.ns or f"c{cluster}-ns-{rng.randint(0, 199)}",
                api_group=p.group,
                api_version="v1",
                resource=p.resource or rng.choice(RESOURCES),
                resource_request=True,
                # tenant-tagged corpora stamp their traffic too, so
                # sar_items feed a fused plane directly; "" is a no-op
                tenant=self.tenant,
            )
        group = rng.choice(
            CORE_GROUPS + _cluster_groups(cluster, self.tenant)
        )
        return Attributes(
            user=UserInfo(
                name=f"c{cluster}-user-{rng.randint(0, 499)}",
                uid="u",
                groups=(f"c{cluster}-team-{rng.randint(0, 99)}",),
            ),
            verb=rng.choice(VERBS),
            namespace=f"c{cluster}-ns-{rng.randint(0, 199)}",
            api_group=group,
            api_version="v1",
            resource=rng.choice(RESOURCES),
            resource_request=True,
            tenant=self.tenant,
        )

    def sar_items(self, n: int, cluster: int = 0, seed: int = 1) -> list:
        """n (EntityMap, Request) pairs of in-partition traffic."""
        from ..server.authorizer import record_to_cedar_resource

        rng = random.Random(f"{self.seed}:sar:{seed}:{cluster}")
        return [
            record_to_cedar_resource(self._attrs(rng, cluster))
            for _ in range(n)
        ]

    def sar_bodies(self, n: int, cluster: int = 0, seed: int = 1) -> list:
        """n raw SubjectAccessReview JSON bodies (webhook wire shape)."""
        rng = random.Random(f"{self.seed}:sar:{seed}:{cluster}")
        out = []
        for _ in range(n):
            a = self._attrs(rng, cluster)
            out.append(
                json.dumps(
                    {
                        "apiVersion": "authorization.k8s.io/v1",
                        "kind": "SubjectAccessReview",
                        "spec": {
                            "user": a.user.name,
                            "uid": "u",
                            "groups": list(a.user.groups),
                            "resourceAttributes": {
                                "verb": a.verb,
                                "group": a.api_group,
                                "version": "v1",
                                "resource": a.resource,
                                "namespace": a.namespace,
                            },
                        },
                    }
                ).encode()
            )
        return out

    def probe_request(self):
        """(EntityMap, Request) matching exactly the probe policy."""
        from ..entities.attributes import Attributes, UserInfo
        from ..server.authorizer import record_to_cedar_resource

        return record_to_cedar_resource(
            Attributes(
                user=UserInfo(name=PROBE_USER, uid="u", groups=()),
                verb="get",
                namespace="c0-ns-0",
                api_group=_cluster_groups(0, self.tenant)[0],
                api_version="v1",
                resource=PROBE_RESOURCE,
                resource_request=True,
                tenant=self.tenant,
            )
        )


def _synth_sources(n: int, seed: int, clusters: int, tenant: str):
    srcs = [_probe_source("permit", tenant)]
    params: List[_PolicyParams] = [
        _PolicyParams("probe", 0, _cluster_groups(0, tenant)[0])
    ]
    for i in range(1, n):
        src, p = _policy_source(i, seed, clusters, tenant)
        srcs.append(src)
        params.append(p)
    return srcs, params


def synth_source(n: int, seed: int = 0, clusters: int = 10, tenant: str = "") -> str:
    """The Cedar text synth_corpus(n, seed, clusters, tenant) parses, policy
    i at index i: what a directory store serving that corpus holds."""
    return "\n".join(_synth_sources(n, seed, clusters, tenant)[0])


def synth_corpus(
    n: int,
    seed: int = 0,
    clusters: int = 10,
    filename_prefix: str = "synth",
    tenant: str = "",
) -> SynthCorpus:
    """Synthesize an ``n``-policy org corpus spread over ``clusters``
    clusters (index 0 carries the probe policy). One combined parse keeps
    generation fast; each policy then gets its own filename + stable id
    so edits and shard bucketing behave like per-object CRD stores.
    ``tenant`` tags the cluster-local apiGroups (multi-tenant corpora,
    see synth_tenant_corpora); "" is byte-identical to before."""
    if n < 1:
        raise ValueError("synth_corpus: n must be >= 1")
    if clusters < 1:
        raise ValueError("synth_corpus: clusters must be >= 1")
    srcs, params = _synth_sources(n, seed, clusters, tenant)
    policies = parse_policies("\n".join(srcs), filename_prefix)
    for i, p in enumerate(policies):
        p.policy_id = f"{filename_prefix}-{i:06d}"
        p.filename = f"{filename_prefix}-{i:06d}.cedar"
    return SynthCorpus(
        policies=list(policies),
        params=params,
        n=n,
        seed=seed,
        clusters=clusters,
        probe_index=0,
        probe_effect="permit",
        tenant=tenant,
    )


# --------------------------------------------------------------- coverage
# Adversarial lowerability corpus (bench.py --coverage):
# every Unlowerable family the burn-down tracks, generated deterministically
# against the same schema-generator/RBAC-converter shapes as the scale
# corpus, plus matched traffic that exercises each family's match, miss,
# presence-guard, and error paths.

# family -> what the full compiler does with it
COVERAGE_FAMILIES = (
    "spill",            # DNF expansion past MAX_CLAUSES: lowers via spillover
    "negated_untyped",  # negated like/cmp/contains on untyped context attrs:
                        # lowers via TYPE_ERR guards + clause flow-typing
    "ancestor_in",      # attr-chain `in` over deep ancestor graphs: lowers
                        # to IN_SLOT closure literals
    "opaque",           # negated arithmetic/ext exprs: lowers via the
                        # host-guardable HARD_OK path
    "blowup",           # expansion past SPILL_MAX_CLAUSES: still fallback
)

_COV_CHANNELS = ("beta", "stable", "canary", "dev")
_COV_CHAIN_DEPTH = 16  # parent-chain length behind each coverage root group


def _coverage_policy(
    i: int, family: str, seed: int, clusters: int
) -> Tuple[str, _PolicyParams]:
    """One adversarial policy of ``family``, scoped like a real cluster
    policy (apiGroup discriminator first, the schema-generator shape)."""
    rng = random.Random(f"{seed}:cov:{family}:{i}")
    cluster = i % clusters
    group = rng.choice(_cluster_groups(cluster))
    res = rng.choice(RESOURCES)
    scope = (
        f'resource.apiGroup == "{group}" && resource.resource == "{res}"'
    )
    params = _PolicyParams(f"cov-{family}", cluster, group, resource=res,
                           verbs=VERBS)
    if family in ("spill", "blowup"):
        # alternation product: ==-chains stay linear per slot (exclusivity
        # simplification), so clauses multiply ACROSS slots. 12x12=144
        # raw clauses clears MAX_CLAUSES=96 (spillover territory);
        # 13x13x13=2197 clears SPILL_MAX_CLAUSES=2048 (genuine fallback).
        per = 13 if family == "blowup" else 12
        names = " || ".join(
            f'resource.name == "cov-n{rng.randint(0, 7)}-{j}"'
            for j in range(per)
        )
        nss = " || ".join(
            f'resource.namespace == "cov-ns{rng.randint(0, 7)}-{j}"'
            for j in range(per)
        )
        body = f"({names}) && ({nss})"
        if family == "blowup":
            subs = " || ".join(
                f'resource.subresource == "cov-s-{j}"' for j in range(per)
            )
            body += f" && ({subs})"
        src = (
            "permit (principal, action, resource is k8s::Resource) "
            f"when {{ {scope} && ({body}) }};"
        )
    elif family == "negated_untyped":
        shape = rng.randrange(3)
        if shape == 0:
            neg = f'context.channel like "{rng.choice(_COV_CHANNELS)}*"'
        elif shape == 1:
            neg = f"context.build < {rng.randint(10, 99)}"
        else:
            neg = f'context.tags.contains("restricted-{rng.randint(0, 3)}")'
        src = (
            "permit (principal, action, resource is k8s::Resource) "
            f"when {{ {scope} }} unless {{ {neg} }};"
        )
    elif family == "ancestor_in":
        root = f"cov-root-{rng.randint(0, 3)}"
        kw = "unless" if rng.random() < 0.3 else "when"
        cond = f'context.team in k8s::Group::"{root}"'
        if kw == "when":
            src = (
                "permit (principal, action, resource is k8s::Resource) "
                f"when {{ {scope} && {cond} }};"
            )
        else:
            src = (
                "permit (principal, action, resource is k8s::Resource) "
                f"when {{ {scope} }} unless {{ {cond} }};"
            )
    elif family == "opaque":
        shape = rng.randrange(3)
        if shape == 0:
            neg = f"context.n + 1 == {rng.randint(2, 9)}"
        elif shape == 1:
            neg = f"context.a * 2 < context.b"
        else:
            neg = "ip(context.addr).isLoopback()"
        src = (
            "permit (principal, action, resource is k8s::Resource) "
            f"when {{ {scope} }} unless {{ {neg} }};"
        )
    else:
        raise ValueError(f"unknown coverage family {family!r}")
    return src, params


@dataclass
class CoverageCorpus:
    """The adversarial corpus plus its matched traffic. ``families`` maps
    each family name to the policy ids generated for it, so benches and
    tests can assert per-family lowering outcomes."""

    policies: List[object]
    params: List[_PolicyParams]
    families: Dict[str, List[str]]
    seed: int
    clusters: int
    _tier_cache: Optional[List[PolicySet]] = field(default=None, repr=False)

    def tiers(self) -> List[PolicySet]:
        if self._tier_cache is None:
            self._tier_cache = [PolicySet(list(self.policies))]
        return self._tier_cache

    def chain_entities(self):
        """The deep ancestor chains behind the ancestor_in roots: each
        root group ``cov-root-k`` sits atop a ``_COV_CHAIN_DEPTH``-deep
        parent chain; traffic teams enter at the chain bottom."""
        from ..lang.entities import Entity
        from ..lang.values import EntityUID

        ents = []
        for k in range(4):
            chain = [f"cov-root-{k}"] + [
                f"cov-mid-{k}-{d}" for d in range(_COV_CHAIN_DEPTH)
            ]
            for child, parent in zip(chain[1:], chain[:-1]):
                ents.append(
                    Entity(
                        EntityUID("k8s::Group", child),
                        parents=(EntityUID("k8s::Group", parent),),
                    )
                )
        return ents

    def _context(self, rng: random.Random):
        """One request context drawing every family's keys with mixed
        types: matches, misses, absent keys (presence-guard paths), and
        wrong-typed values (the TYPE_ERR / guard-error paths)."""
        from ..lang.values import CedarRecord, CedarSet, EntityUID

        ctx: Dict[str, object] = {}
        r = rng.random()
        if r < 0.7:
            ctx["channel"] = (
                f"{rng.choice(_COV_CHANNELS)}-{rng.randint(0, 9)}"
            )
        elif r < 0.85:
            ctx["channel"] = rng.randint(0, 9)  # type error under `like`
        if rng.random() < 0.8:
            ctx["build"] = (
                rng.randint(0, 120) if rng.random() < 0.85 else "not-a-long"
            )
        if rng.random() < 0.8:
            ctx["tags"] = (
                CedarSet(
                    [f"restricted-{rng.randint(0, 5)}", "public"]
                )
                if rng.random() < 0.85
                else "restricted-0"  # type error under .contains
            )
        r = rng.random()
        if r < 0.6:
            k, d = rng.randint(0, 3), rng.randint(0, _COV_CHAIN_DEPTH - 1)
            ctx["team"] = EntityUID("k8s::Group", f"cov-mid-{k}-{d}")
        elif r < 0.75:
            ctx["team"] = EntityUID("k8s::Group", f"other-{rng.randint(0, 3)}")
        elif r < 0.85:
            ctx["team"] = "not-an-entity"  # type error under `in`
        if rng.random() < 0.8:
            ctx["n"] = rng.randint(0, 9)
        if rng.random() < 0.8:
            ctx["a"] = rng.randint(0, 9)
            ctx["b"] = rng.randint(0, 20)
        r = rng.random()
        if r < 0.5:
            ctx["addr"] = rng.choice(("127.0.0.1", "10.1.2.3", "::1"))
        elif r < 0.7:
            ctx["addr"] = "not-an-ip"  # guard-error path
        return CedarRecord(ctx)

    def items(self, n: int, seed: int = 1) -> list:
        """n (EntityMap, Request) pairs aimed at the corpus: SAR-shaped
        resource/principal attributes targeting the generated policies'
        (group, resource, name, namespace) universe, contexts drawing
        every family's keys, and the deep group chains merged into each
        entity map."""
        from ..entities.attributes import Attributes, UserInfo
        from ..lang.eval import Request
        from ..server.authorizer import record_to_cedar_resource

        rng = random.Random(f"{self.seed}:covsar:{seed}")
        chain = self.chain_entities()
        out = []
        for _ in range(n):
            p = rng.choice(self.params)
            a = Attributes(
                user=UserInfo(
                    name=f"cov-user-{rng.randint(0, 49)}",
                    uid="u",
                    groups=(f"cov-team-{rng.randint(0, 9)}",),
                ),
                verb=rng.choice(VERBS),
                namespace=f"cov-ns{rng.randint(0, 7)}-{rng.randint(0, 13)}",
                api_group=p.group if rng.random() < 0.8 else "other.corp",
                api_version="v1",
                resource=p.resource or rng.choice(RESOURCES),
                name=f"cov-n{rng.randint(0, 7)}-{rng.randint(0, 13)}",
                resource_request=True,
            )
            em, req = record_to_cedar_resource(a)
            for e in chain:
                em.add(e)
            out.append(
                (em, Request(req.principal, req.action, req.resource,
                             self._context(rng)))
            )
        return out


def coverage_corpus(
    per_family: int = 4,
    base: int = 24,
    seed: int = 0,
    clusters: int = 4,
    filename_prefix: str = "cov",
) -> CoverageCorpus:
    """The adversarial lowerability corpus: ``base`` realistic policies
    (the scale generator's shapes) + ``per_family`` policies of each
    COVERAGE_FAMILIES entry, deterministically derived from ``seed``.
    Coverage numbers measured on it answer "what fraction of a realistic
    set with THESE constructs serves from the device plane?"."""
    if per_family < 1:
        raise ValueError("coverage_corpus: per_family must be >= 1")
    srcs: List[str] = []
    params: List[_PolicyParams] = []
    fam_of: List[str] = []
    for i in range(base):
        src, p = _policy_source(i + 1, seed, clusters)
        srcs.append(src)
        params.append(p)
        fam_of.append("base")
    for family in COVERAGE_FAMILIES:
        for i in range(per_family):
            src, p = _coverage_policy(i, family, seed, clusters)
            srcs.append(src)
            params.append(p)
            fam_of.append(family)
    policies = parse_policies("\n".join(srcs), filename_prefix)
    if len(policies) != len(srcs):
        raise RuntimeError("coverage_corpus: parse produced a policy-count "
                           f"mismatch ({len(policies)} != {len(srcs)})")
    families: Dict[str, List[str]] = {f: [] for f in COVERAGE_FAMILIES}
    families["base"] = []
    for i, p in enumerate(policies):
        p.policy_id = f"{filename_prefix}-{fam_of[i]}-{i:04d}"
        p.filename = f"{filename_prefix}-{i:04d}.cedar"
        families[fam_of[i]].append(p.policy_id)
    return CoverageCorpus(
        policies=list(policies),
        params=params,
        families=families,
        seed=seed,
        clusters=clusters,
    )


def synth_tenant_corpora(
    n: int, tenants: int, seed: int = 0, clusters: int = 4
) -> "Dict[str, SynthCorpus]":
    """``tenants`` deterministic per-tenant corpora of ``n`` policies each
    (ordered dict: tenant id → corpus) — the multi-tenant bench/test
    generator (bench.py --tenants, tests/test_tenancy.py).

    Per-tenant DERIVED seeds (never the shared stream, so one tenant's
    regeneration can't reshuffle a neighbor), DISJOINT cluster-local
    apiGroup universes (the tenant tag in _cluster_groups), and one
    shared org-wide slice (CORE_GROUPS policies, ~2%) that overlaps
    across tenants — the content that would cross-match without the
    plane's tenant discriminators. Policy ids/filenames are prefixed by
    tenant, so the fused plane's shard-scoped cache stamps resolve
    per-tenant."""
    if tenants < 1:
        raise ValueError("synth_tenant_corpora: tenants must be >= 1")
    out: Dict[str, SynthCorpus] = {}
    for t in range(tenants):
        tid = f"tenant-{t:02d}"
        tseed = random.Random(f"{seed}:tenant:{tid}").randrange(1 << 31)
        out[tid] = synth_corpus(
            n, seed=tseed, clusters=clusters, filename_prefix=tid,
            tenant=tid,
        )
    return out
