"""Multi-tenant shared planes: many clusters' policy sets fused into ONE
card engine (docs/multitenancy.md; the JAX package's tenancy/ ported).

An AVP-style control plane serves N clusters (tenants) from one card.
Instead of N per-tenant engines at ~1/N duty cycle each (N warm ladders,
N compile caches, N half-empty batches), the :class:`TenantRegistry`
compiles every tenant's policy set through the EXISTING shard pipeline
into one fused plane whose rules carry a tenant-id discriminator literal
(compiler/pack.py ``tenant_literal``) — the words kernel
(csrc/match.cu ``match_words_kernel``) masks foreign tenants' rules with
zero new kernel code — and the
:class:`TenantResolver` front end stamps each request with its tenant id
(path / header / host map) so the existing ``PipelinedBatcher`` coalesces
requests ACROSS tenants into one device dispatch.

Per-tenant lifecycle rides what the shard pipeline already provides,
scoped by tenant: shards are (tenant, tier, bucket), so one tenant's CRD
edit dirties only its own shards, its cache entries die scoped, and its
neighbors' stay warm (the isolation contract a differential test pins,
tests/test_torch_tenancy.py).
"""

from .frontend import TenantBody, TenantResolver
from .registry import TenantError, TenantRegistry
from .stores import fused_tier_stores

__all__ = [
    "TenantBody",
    "TenantError",
    "TenantRegistry",
    "TenantResolver",
    "fused_tier_stores",
]
