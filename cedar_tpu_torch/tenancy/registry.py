"""Tenant registry: per-tenant policy sets fused into one shared plane (a
copy of the JAX package's tenancy/registry.py).

The registry owns the tenant → policy-tier mapping and produces the FUSED
tier stack the (single, shared) ``TorchPolicyEngine`` compiles. Fusion works
by cloning: every tenant policy is shallow-cloned ONCE per object
identity, the clone is stamped with its tenant (``_cedar_tenant``, the
side-channel the shard compiler and pack read) and guard-wrapped with the
per-tenant AST condition (compiler/pack.py ``tenant_guard_condition``) so
the interpreter paths isolate tenants exactly like the packed
discriminator literal does. Clones are IDENTITY-STABLE across reloads
while the underlying store object is unchanged — the invariant the shard
differ, the fingerprint memos and the bucket memos key on — so a
one-policy edit in tenant T re-parses one object, produces one fresh
clone, and dirties exactly one ``T/t<tier>b<bucket>`` shard.

Tenant ids are validated (DNS-label-ish, no ``/``): the id is embedded in
shard ids, metrics labels, cache-key scopes and debug documents.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..lang.ast import Policy
from ..lang.authorize import PolicySet

_TENANT_RE = re.compile(r"^[a-z0-9]([a-z0-9._-]{0,62}[a-z0-9])?$", re.I)

__all__ = ["FusedPolicySet", "TenantError", "TenantRegistry"]


class TenantError(ValueError):
    """Invalid tenant id or tenant lifecycle misuse."""


class FusedPolicySet(PolicySet):
    """A PolicySet keyed by (tenant, policy id).

    Two tenants may legitimately carry the same policy id (each authored
    their store independently); the base class would silently overwrite
    one with the other. Reasons still carry the policy's OWN id — fused
    answers must be byte-compatible with the tenant's standalone engine
    (tests/test_torch_tenancy.py pins the differential)."""

    def add(self, p: Policy, policy_id: Optional[str] = None) -> None:
        from ..compiler.pack import policy_tenant

        pid = policy_id or p.policy_id or f"policy{len(self._policies)}"
        p.policy_id = pid
        self._policies[(policy_tenant(p), pid)] = p

    def get(self, policy_id: str) -> Optional[Policy]:
        for p in self._policies.values():
            if p.policy_id == policy_id:
                return p
        return None


class _Tenant:
    __slots__ = (
        "tenant", "tiers_fn", "stores", "clones", "policies", "gen_proxies"
    )

    def __init__(self, tenant: str, tiers_fn, stores):
        self.tenant = tenant
        self.tiers_fn = tiers_fn  # () -> List[PolicySet]
        self.stores = stores  # optional TieredPolicyStores (readiness/gen)
        # id(original) -> (original, clone): the strong ref to the
        # original pins its id for the lifetime of the entry, so an id
        # can never be reused into a false identity hit; entries whose
        # original left the corpus are pruned every fuse pass
        self.clones: Dict[int, Tuple[Policy, Policy]] = {}
        self.policies = 0
        # identity-proxy generation counters for change sources without a
        # content_generation counter (content_fingerprint): key ->
        # [last_seen, counter]; the strong ref pins last_seen so id()
        # reuse after GC can never fake an identity hit
        self.gen_proxies: Dict[object, list] = {}


class TenantRegistry:
    """Thread-safe tenant set + fused-tier assembly (see module doc)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._tenants: Dict[str, _Tenant] = {}
        # bumps on add/remove — folded into content_fingerprint() so the
        # reloader recompiles when the tenant SET changes, not just when
        # some tenant's store contents do
        self._topology_gen = 0
        # identity-stable fused tiers: repeated fused_tiers() calls hand
        # the engine the SAME PolicySet objects until content changes
        # (the store-reuse invariant incremental compilation keys on)
        self._fused_cache: Optional[List[PolicySet]] = None
        self._fused_token: Optional[str] = None
        # set by tenancy.stores.fused_tier_stores: the tier count the
        # wired store stack carries. A later-onboarded tenant with MORE
        # tiers must fail loudly (fused_tiers raises) — a fixed stack
        # would silently never serve the higher tiers' policies
        self.wired_tiers: Optional[int] = None

    # ---------------------------------------------------------- lifecycle

    def add_tenant(
        self,
        tenant: str,
        tiers: Optional[Sequence[PolicySet]] = None,
        tiers_fn: Optional[Callable[[], List[PolicySet]]] = None,
        stores=None,
    ) -> None:
        """Register a tenant. Exactly one of ``tiers`` (a static tier
        stack), ``tiers_fn`` (a provider called per fuse pass) or
        ``stores`` (a TieredPolicyStores — provides tiers, readiness AND
        content generations) must be given."""
        if not _TENANT_RE.match(tenant or ""):
            raise TenantError(
                f"invalid tenant id {tenant!r}: want DNS-label-ish "
                "([a-z0-9._-], no '/', <= 64 chars)"
            )
        provided = sum(x is not None for x in (tiers, tiers_fn, stores))
        if provided != 1:
            raise TenantError(
                "add_tenant: exactly one of tiers/tiers_fn/stores required"
            )
        if tiers is not None:
            static = list(tiers)

            def tiers_fn() -> List[PolicySet]:  # noqa: F811 — closure
                return static

        elif stores is not None:
            # port-only: a tenant's gated tiers are kept while its stores'
            # content generations stand, so a fuse after one tenant's edit
            # analyzes that tenant alone (the JAX registry re-runs every
            # tenant's gate, about 2 s per 1,000 policies)
            analyzed_memo: list = []

            def tiers_fn() -> List[PolicySet]:  # noqa: F811 — closure
                analyzed = getattr(stores, "analyzed_policy_sets", None)
                if analyzed is None:
                    return [s.policy_set() for s in stores]
                gen = stores.cache_generation()
                if analyzed_memo and analyzed_memo[0][0] == gen:
                    return analyzed_memo[0][1]
                tiers = analyzed()
                analyzed_memo[:] = [(gen, tiers)]
                return tiers

        with self._lock:
            if tenant in self._tenants:
                raise TenantError(f"tenant {tenant!r} already registered")
            self._tenants[tenant] = _Tenant(tenant, tiers_fn, stores)
            self._topology_gen += 1
            self._fused_cache = None

    def remove_tenant(self, tenant: str) -> bool:
        """Offboard a tenant: its policies leave the fused plane at the
        next compile; its shards' disappearance kills its scoped cache
        entries (removed shards drop out of the plane generations)."""
        with self._lock:
            gone = self._tenants.pop(tenant, None) is not None
            if gone:
                self._topology_gen += 1
                self._fused_cache = None
        if gone:
            try:
                from ..server.metrics import clear_tenant_policies

                # drop the departed tenant's policy-count gauge row — a
                # frozen last value would keep counting policies the
                # plane no longer serves
                clear_tenant_policies(tenant)
            except Exception:  # noqa: BLE001 — metrics never break offboard
                pass
        return gone

    def tenant_stores(self) -> list:
        """Every store object of the tenants registered with ``stores=``
        (the CLI's directory stores), tenant-sorted: what the server's
        stop() closes and the supervisor watches (port-only: the JAX
        server closes no store)."""
        with self._lock:
            entries = [self._tenants[t] for t in sorted(self._tenants)]
        return [s for e in entries if e.stores is not None for s in e.stores]

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    def __contains__(self, tenant: str) -> bool:
        # without the lock (a dict membership test is atomic): the front
        # door asks on every request, and fused_tiers() holds the lock
        # through a whole rebuild, each tenant's analysis gate included
        return tenant in self._tenants

    def __len__(self) -> int:
        with self._lock:
            return len(self._tenants)

    # ------------------------------------------------------------- fusion

    def _clone(self, entry: _Tenant, p: Policy, seen: set) -> Policy:
        key = id(p)
        seen.add(key)
        hit = entry.clones.get(key)
        if hit is not None and hit[0] is p:
            return hit[1]
        import copy

        from ..compiler.pack import tenant_guard_condition

        q = copy.copy(p)
        # fresh __dict__ rides the copy; strip memo stamps whose value
        # depends on source content — the clone's content INCLUDES the
        # guard, and a stale fingerprint would desync shard hashes across
        # processes (fanout peer-cache wire state compares them)
        q.__dict__.pop("_cedar_content_fp", None)
        q.__dict__.pop("_cedar_ord", None)
        q.conditions = (tenant_guard_condition(entry.tenant),) + tuple(
            p.conditions
        )
        q.__dict__["_cedar_tenant"] = entry.tenant
        entry.clones[key] = (p, q)
        return q

    def fused_tiers(self) -> List[PolicySet]:
        """The fused tier stack: tier i holds every tenant's tier-i
        clones (tenant-sorted for determinism). Tier count is the max
        over tenants; IDENTITY-CACHED until any tenant's content changes
        so repeated reload ticks hand the engine the same objects."""
        with self._lock:
            token = self.content_fingerprint()
            if self._fused_cache is not None and self._fused_token == token:
                return self._fused_cache
            per_tier: Dict[int, List[Policy]] = {}
            n_tiers = 1
            wired = self.wired_tiers
            for tenant in sorted(self._tenants):
                entry = self._tenants[tenant]
                seen: set = set()
                tiers = entry.tiers_fn()
                n_tiers = max(n_tiers, len(tiers))
                count = 0
                for i, ps in enumerate(tiers):
                    bucket = per_tier.setdefault(i, [])
                    for p in ps.policies():
                        bucket.append(self._clone(entry, p, seen))
                        count += 1
                entry.policies = count
                # prune clones whose original left this tenant's corpus
                # (edits replace objects; offboarded files disappear)
                for k in [k for k in entry.clones if k not in seen]:
                    del entry.clones[k]
            if wired is not None and n_tiers > wired:
                raise TenantError(
                    f"fused plane needs {n_tiers} tiers but the wired "
                    f"store stack carries {wired}: re-wire "
                    "fused_tier_stores(registry) before onboarding a "
                    "tenant with more tiers — a fixed stack would "
                    "silently never serve the higher tiers' policies"
                )
            fused = [
                FusedPolicySet(per_tier.get(i, [])) for i in range(n_tiers)
            ]
            self._fused_cache = fused
            self._fused_token = token
            try:
                from ..server.metrics import set_tenant_policies

                for t, e in self._tenants.items():
                    set_tenant_policies(t, e.policies)
            except Exception:  # noqa: BLE001 — metrics never break a fuse
                pass
            return fused

    # ---------------------------------------------------------- readiness

    def ready(self) -> bool:
        """True once every tenant's stores report initial load complete
        (store-less tenants — static tiers — are born ready)."""
        with self._lock:
            entries = list(self._tenants.values())
        for e in entries:
            if e.stores is None:
                continue
            for s in e.stores:
                if not s.initial_policy_load_complete():
                    return False
        return True

    def _proxy_gen(self, entry: _Tenant, key, obj) -> int:
        """Identity-proxy generation counter (the
        TieredPolicyStores.cache_generation pattern): bumps whenever the
        observed object identity changes — reloaders swap set objects on
        content change, so identity moves with content — with a strong
        ref pinning the last-seen object so id() reuse after garbage
        collection can never fake an identity hit. A source that builds
        fresh objects per call bumps every check, which safely disables
        the fused-tier identity cache for that tenant (rebuilt each
        pass, never stale)."""
        with self._lock:
            proxy = entry.gen_proxies.get(key)
            if isinstance(obj, tuple):
                same = (
                    proxy is not None
                    and isinstance(proxy[0], tuple)
                    and len(proxy[0]) == len(obj)
                    and all(a is b for a, b in zip(proxy[0], obj))
                )
            else:
                same = proxy is not None and proxy[0] is obj
            if not same:
                proxy = [obj, (proxy[1] + 1) if proxy else 0]
                entry.gen_proxies[key] = proxy
            return proxy[1]

    def content_fingerprint(self) -> str:
        """Cheap change detector for the reloader: tenant topology + each
        tenant store's content generation. Stores without the counter —
        and provider-fn tenants — contribute an identity-proxy counter
        over their current PolicySet objects (see _proxy_gen), so a
        content swap is ALWAYS detected and the fused plane can never
        keep serving a stale clone set."""
        # snapshot under the lock (the reloader thread calls this while an
        # embedder may be onboarding/offboarding); the store/provider
        # calls below run lock-free on the snapshot (_proxy_gen re-takes
        # the lock only for its table update)
        with self._lock:
            snapshot = dict(self._tenants)
            parts = [f"#{self._topology_gen}"]
        for tenant in sorted(snapshot):
            e = snapshot[tenant]
            if e.stores is not None:
                sub = []
                for i, s in enumerate(e.stores):
                    gen = getattr(s, "content_generation", None)
                    if gen is not None:
                        sub.append(f"{s.name()}@{gen()}")
                    else:
                        g = self._proxy_gen(e, ("store", i), s.policy_set())
                        sub.append(f"{s.name()}@p{g}")
                parts.append(f"{tenant}:{'|'.join(sub)}")
            else:
                sets = tuple(e.tiers_fn())
                parts.append(f"{tenant}:p{self._proxy_gen(e, 'tiers', sets)}")
        return ";".join(parts)

    # -------------------------------------------------------------- debug

    def stats(self) -> dict:
        """Per-tenant rollup for /debug/tenancy and the metrics gauges."""
        with self._lock:
            return {
                "tenants": len(self._tenants),
                "per_tenant": {
                    t: {"policies": e.policies}
                    for t, e in sorted(self._tenants.items())
                },
            }

    @staticmethod
    def shard_prefix(tenant: str) -> str:
        """The shard-id prefix of a tenant's (tenant, tier, bucket)
        shards — what dirty-scope gates and per-tenant rollups match on
        (compiler/shard.py shard_tenant is the inverse)."""
        return f"{tenant}/"
