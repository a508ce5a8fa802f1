"""Tenant-aware front end: stamp each request with its tenant id (a copy
of the JAX package's tenancy/frontend.py).

The webhook server resolves a tenant for every POST (path prefix, header,
or Host/SNI map — in that order) and wraps the raw body in a
:class:`TenantBody`, a ``bytes`` subclass carrying the tenant id. The
whole serving stack passes bodies through opaquely, so the stamp rides
the batcher and the decision cache unchanged; the layers that
actually interpret bodies read it back:

  * the native fast path stamps the tenant's feature code into the
    reserved context slot column after the C++ encode
    (engine/fastpath.py — the device then masks foreign tenants' rules);
  * the Python/interpreter paths stamp ``context.tenantId`` into the
    Cedar request (server/authorizer.py);
  * the canonical fingerprint folds the tenant in
    (cache/fingerprint.py), so decision-cache keys, recordings and audit
    lines are tenant-scoped — two tenants' byte-identical SARs can never
    share a cache entry.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

DEFAULT_TENANT_HEADER = "x-cedar-tenant"
DEFAULT_PATH_PREFIX = "/t/"

__all__ = ["DEFAULT_TENANT_HEADER", "TenantBody", "TenantResolver"]


class TenantBody(bytes):
    """A raw webhook body plus the tenant the front end resolved for it.

    Subclassing ``bytes`` keeps every signature on the serving path
    unchanged (C++ encode, json.loads, hashing, slicing into chunks all
    see plain bytes); only tenant-aware layers look for the attribute."""

    tenant: str = ""

    def __new__(cls, data: bytes, tenant: str = "") -> "TenantBody":
        self = super().__new__(cls, data)
        self.tenant = tenant
        return self


class TenantResolver:
    """Maps an incoming request to a registered tenant id.

    Resolution order (first hit wins):
      1. path prefix: ``/t/<tenant>/v1/authorize`` → tenant, with the
         prefix stripped so dispatch sees the canonical ``/v1/...`` path;
      2. header (default ``x-cedar-tenant``, case-insensitive);
      3. host map: exact ``Host``/SNI hostname (port stripped) → tenant —
         the shape a TLS-terminating LB hands multi-SNI traffic over in;
      4. ``default`` tenant, when configured.

    Path and header are CLIENT-SUPPLIED: an operator who authenticates
    tenants out of band (per-tenant SNI/LB routes) must restrict
    ``sources`` to the trusted ones (e.g. ``("host",)``) — otherwise a
    tenant could name a neighbor in the path or header and evaluate
    under its policy slice. When several enabled sources resolve, they
    must AGREE: a host-mapped request whose path/header names a
    different tenant is rejected (``why="conflict"``) instead of letting
    the client-supplied source win over the operator-configured one.

    A resolved-but-UNREGISTERED tenant is rejected (``why="unknown"``) —
    serving an unknown tenant from a plane that has no rules for it would
    silently answer every request NoOpinion and hide the misconfig."""

    SOURCES = ("path", "header", "host")

    def __init__(
        self,
        registry,
        header: str = DEFAULT_TENANT_HEADER,
        path_prefix: str = DEFAULT_PATH_PREFIX,
        hosts: Optional[Dict[str, str]] = None,
        default: Optional[str] = None,
        sources: Optional[Tuple[str, ...]] = None,
    ):
        self.registry = registry
        self.header = (header or DEFAULT_TENANT_HEADER).lower()
        self.path_prefix = path_prefix or DEFAULT_PATH_PREFIX
        self.hosts = {k.lower(): v for k, v in (hosts or {}).items()}
        self.default = default
        srcs = tuple(sources) if sources is not None else self.SOURCES
        bad = [s for s in srcs if s not in self.SOURCES]
        if bad or not srcs:
            raise ValueError(
                f"tenant sources must be a non-empty subset of "
                f"{self.SOURCES}, got {srcs!r}"
            )
        self.sources = srcs

    def _known(self, tenant: str) -> bool:
        try:
            return tenant in self.registry
        except Exception:  # noqa: BLE001 — a sick registry rejects
            return False

    def resolve(
        self, path: str, headers=None, host: Optional[str] = None
    ) -> Tuple[Optional[str], str, str]:
        """(tenant | None, dispatch path, why). ``why`` is the resolution
        source (``path``/``header``/``host``/``default``) or the
        rejection reason (``unknown``/``missing``/``conflict``)."""
        found: Dict[str, str] = {}  # enabled source -> resolved tenant
        out_path = path
        if "path" in self.sources and path.startswith(self.path_prefix):
            rest = path[len(self.path_prefix):]
            seg, sep, tail = rest.partition("/")
            if seg and sep:
                found["path"] = seg
                out_path = "/" + tail
        if "header" in self.sources and headers is not None:
            h = headers.get(self.header)
            if h:
                found["header"] = h.strip()
        if "host" in self.sources and host:
            hkey = host.lower()
            # strip a :port suffix — but a bracketed IPv6 literal without
            # a port ("[::1]") ends in "]" and must not lose its tail
            if ":" in hkey and not hkey.endswith("]"):
                hkey = hkey.rsplit(":", 1)[0]
            mapped = self.hosts.get(hkey)
            if mapped:
                found["host"] = mapped
        if len(set(found.values())) > 1:
            # disagreeing sources: never let a client-supplied path or
            # header override the operator-configured host route
            return None, out_path, "conflict"
        tenant = why = None
        for src in self.sources:
            if src in found:
                tenant, why = found[src], src
                break
        if tenant is None and self.default is not None:
            tenant, why = self.default, "default"
        if tenant is None:
            return None, out_path, "missing"
        if not self._known(tenant):
            return None, out_path, "unknown"
        return tenant, out_path, why

    def describe(self) -> dict:
        """Config document for /debug/tenancy."""
        return {
            "header": self.header,
            "path_prefix": self.path_prefix,
            "hosts": dict(self.hosts),
            "default": self.default,
            "sources": list(self.sources),
        }
