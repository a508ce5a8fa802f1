"""Fused tier stores: the registry's tiers as a TieredPolicyStores stack (a
copy of the JAX package's tenancy/stores.py).

The interpreter paths (``--backend interpreter``, the gated rows'
re-run, explain) and the readiness gates all speak the store protocol; this module wraps the :class:`TenantRegistry` so the
fused plane's AUTHORIZER is wired exactly like a single-tenant one — the
served PolicySets contain the guard-wrapped clones, so even a pure
interpreter walk over the fused stack is tenant-isolated.
"""

from __future__ import annotations

from typing import List

from ..lang.authorize import PolicySet
from ..stores.store import TieredPolicyStores

__all__ = ["FusedTierStore", "fused_tier_stores"]


class FusedTierStore:
    """One fused tier as a policy store."""

    def __init__(self, registry, tier: int):
        self.registry = registry
        self.tier = tier

    def name(self) -> str:
        return f"tenants/t{self.tier}"

    def policy_set(self) -> PolicySet:
        tiers = self.registry.fused_tiers()
        return tiers[self.tier] if self.tier < len(tiers) else PolicySet([])

    def initial_policy_load_complete(self) -> bool:
        return self.registry.ready()

    def content_generation(self) -> str:
        # strings work everywhere the int counter does: the reloader and
        # cache composites only ever compare for equality
        return self.registry.content_fingerprint()

    def close(self) -> None:
        """Stop every tenant store's reload ticker (the server's
        close_stores; idempotent, so each tier's store may call it)."""
        for store in self.registry.tenant_stores():
            close = getattr(store, "close", None)
            if close is not None:
                close()


def fused_tier_stores(registry, n_tiers: int = 0) -> TieredPolicyStores:
    """The registry's fused tier stack as TieredPolicyStores. ``n_tiers``
    0 sizes from the current fused tiers (at least 1). The chosen count
    is stamped on the registry (``wired_tiers``): onboarding a tenant
    with MORE tiers later makes ``fused_tiers()`` raise instead of
    silently never serving the higher tiers through this fixed stack —
    size ``n_tiers`` up front when deeper tenants will onboard live."""
    if n_tiers <= 0:
        n_tiers = max(1, len(registry.fused_tiers()))
    registry.wired_tiers = n_tiers
    stores: List[FusedTierStore] = [
        FusedTierStore(registry, i) for i in range(n_tiers)
    ]
    return TieredPolicyStores(stores)
