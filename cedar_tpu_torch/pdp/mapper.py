"""PDP attribute mapping: wire request -> SubjectAccessReview shape (a
copy of the JAX package's pdp/mapper.py).

Both PDP protocols become synthetic SubjectAccessReview documents that
the serving stack evaluates unchanged: the native encoder already speaks
the SAR attribute shape, so a mapped ext_authz check or batch tuple
rides the same tenant column, the same batcher claim and the same rule
plane as a kubelet's SAR, and one ``match_words_kernel`` launch answers
all three protocols. No kernel knows the protocol.

Disjointness is enforced twice (docs/pdp.md):

- at the VALUE level, every mapped action id carries a protocol prefix no
  k8s verb has (schema/consts.py ``PDP_EXTAUTHZ_VERB_PREFIX`` /
  ``PDP_BATCH_VERB_PREFIX``), and mapped context keys are ``pdp:``-prefixed;
- at the KEY level, the ``PdpBody`` protocol stamp is folded into the
  canonical fingerprint (cache/fingerprint.py), so even an adversarially
  crafted tuple never shares a cache, recorder or audit key with a SAR.
"""

from __future__ import annotations

import json

from ..schema.consts import PDP_BATCH_VERB_PREFIX, PDP_EXTAUTHZ_VERB_PREFIX

PROTOCOL_EXTAUTHZ = "extauthz"
PROTOCOL_BATCH = "batch"


class PdpMappingError(ValueError):
    """A wire request that cannot be mapped to evaluable attributes:
    answered with the protocol's malformed-request posture, never
    evaluated."""


class PdpBody(bytes):
    """Raw synthetic-SAR bytes stamped with the wire protocol (and the
    configured tenant), the PDP twin of tenancy's TenantBody: the stamp
    rides the serving stack as opaque payload, and each layer that must
    care (fingerprint, admission classify, metrics, audit, trace, the
    fast path's tenant column) reads it with ``getattr(body, ..., "")``."""

    def __new__(cls, data: bytes, protocol: str, tenant: str = ""):
        self = super().__new__(cls, data)
        self.protocol = protocol
        self.tenant = tenant
        return self


def _entity_ref(value, what: str) -> str:
    """An AVP-style entity reference -> a flat identifier string. Accepts
    the AVP wire shape ({"entityType": ..., "entityId": ...}; actionType /
    actionId for actions) or a plain string."""
    if isinstance(value, str):
        if not value:
            raise PdpMappingError(f"{what} must be non-empty")
        return value
    if isinstance(value, dict):
        etype = value.get("entityType") or value.get("actionType") or ""
        eid = value.get("entityId") or value.get("actionId") or ""
        if not eid:
            raise PdpMappingError(f"{what} is missing its entity id")
        return f"{etype}::{eid}" if etype else eid
    raise PdpMappingError(f"{what} must be a string or an entity reference")


def extauthz_to_sar(method: str, path: str, headers: dict, config) -> dict:
    """One Envoy ext_authz check (HTTP-service mode: the original
    request's method, path and headers) -> a synthetic SAR document.

    principal  <- the configured identity headers
    action     <- ``http:<method>`` (k8s::Action, value-disjoint from every
                  bare k8s verb)
    resource   <- the request path (k8s::NonResourceURL)
    context    <- the declared context headers plus source / destination,
                  as ``pdp:``-prefixed extra values
    """
    if not method:
        raise PdpMappingError("ext_authz check is missing the method")
    if not path or not path.startswith("/"):
        raise PdpMappingError("ext_authz check path must start with '/'")
    h = {str(k).lower(): str(v) for k, v in (headers or {}).items()}
    groups = [g.strip() for g in h.get(config.groups_header, "").split(",") if g.strip()]
    extra = {}
    for name in config.context_headers:
        if name in h:
            extra[f"pdp:header:{name}"] = [h[name]]
    # Envoy CheckRequest's source / destination in HTTP-service mode: the
    # downstream peer (x-forwarded-for) and the requested authority
    if h.get("x-forwarded-for"):
        extra["pdp:source"] = [h["x-forwarded-for"]]
    if h.get("host") or h.get(":authority"):
        extra["pdp:destination"] = [h.get("host") or h.get(":authority")]
    spec = {
        "user": h.get(config.principal_header, ""),
        "uid": h.get(config.uid_header, ""),
        "groups": groups,
        "extra": extra,
        "nonResourceAttributes": {
            "verb": PDP_EXTAUTHZ_VERB_PREFIX + method.lower(),
            "path": path,
        },
    }
    return {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview", "spec": spec}


def batch_tuple_to_sar(entry, config) -> dict:
    """One AVP-style batch tuple ({principal, action, resource, context})
    -> a synthetic SAR document.

    principal  <- the flattened entity reference (spec.user; an optional
                  ``groups`` list passes through)
    action     <- ``avp:<actionId>``
    resource   <- the flattened entity reference (the NonResourceURL path,
                  ``/``-prefixed)
    context    <- ``pdp:ctx:<key>`` extra values (stringified; context keys
                  reach Cedar lower-cased, as every extra key does)
    """
    if not isinstance(entry, dict):
        raise PdpMappingError("batch tuple must be a JSON object")
    principal = _entity_ref(entry.get("principal"), "principal")
    action = _entity_ref(entry.get("action"), "action")
    resource = _entity_ref(entry.get("resource"), "resource")
    context = entry.get("context") or {}
    if not isinstance(context, dict):
        raise PdpMappingError("context must be a JSON object")
    groups = entry.get("groups") or []
    if not isinstance(groups, list):
        raise PdpMappingError("groups must be a list")
    extra = {}
    for key in sorted(context):
        value = context[key]
        if isinstance(value, (dict, list)):
            value = json.dumps(value, sort_keys=True, separators=(",", ":"))
        extra[f"pdp:ctx:{key}"] = [str(value)]
    spec = {
        "user": principal,
        "groups": [str(g) for g in groups],
        "extra": extra,
        "nonResourceAttributes": {
            "verb": PDP_BATCH_VERB_PREFIX + action,
            "path": "/" + resource.lstrip("/"),
        },
    }
    return {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview", "spec": spec}


def encode_pdp_body(doc: dict, protocol: str, config) -> PdpBody:
    """Canonical wire bytes of a mapped document: sorted keys and compact
    separators, so two equivalent checks give byte-identical bodies and
    the fingerprint memo and the batcher's coalescing see repeat traffic
    as repeats."""
    data = json.dumps(doc, sort_keys=True, separators=(",", ":"), ensure_ascii=True).encode()
    return PdpBody(data, protocol, tenant=getattr(config, "tenant", ""))


__all__ = [
    "PROTOCOL_BATCH",
    "PROTOCOL_EXTAUTHZ",
    "PdpBody",
    "PdpMappingError",
    "batch_tuple_to_sar",
    "encode_pdp_body",
    "extauthz_to_sar",
]
