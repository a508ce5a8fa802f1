"""Canonical request fingerprints: the one key definition of the decision
cache (cache/decision_cache.py). A copy of the JAX package's
cache/fingerprint.py: the keys are byte-identical to its keys.

Why canonical rather than raw-body hashing: the apiserver serializes SARs
stably in practice, but nothing guarantees it. Field order, whitespace and
redundant members are all wire-legal variation that must not split cache
entries. The fingerprint therefore hashes a canonical JSON rendering of
the PARSED attributes (sorted keys, order-insensitive collections sorted),
not the bytes on the wire.

Determinism is what makes this safe: Cedar evaluation is total and
deterministic, so two requests with equal canonical attributes get the
same decision against the same policy-set generation. Anything that can
influence a decision MUST be part of the fingerprint; anything that
cannot (the AdmissionReview ``uid`` nonce, JSON formatting) must not be.

Versioned: ``FINGERPRINT_VERSION`` is folded into every hash so a future
canonicalization change invalidates old keys wholesale instead of
silently colliding with them.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Optional, Tuple

FINGERPRINT_VERSION = "1"

# hex digest length kept at 32 chars (128 bits): collision-safe for any
# realistic corpus while halving per-entry key memory vs the full digest
_DIGEST_CHARS = 32


def _hash_canonical(doc: dict) -> str:
    payload = json.dumps(doc, sort_keys=True, separators=(",", ":"), ensure_ascii=True)
    return hashlib.sha256((FINGERPRINT_VERSION + "\x00" + payload).encode()).hexdigest()[
        :_DIGEST_CHARS
    ]


def _canonical_user(user) -> dict:
    """UserInfo -> canonical dict. Groups and extra values are SETS to the
    evaluator (entity parents / Set<String> attributes), so order is
    normalized away here."""
    return {
        "name": user.name,
        "uid": user.uid,
        "groups": sorted(user.groups),
        "extra": {k: sorted(v) for k, v in sorted((user.extra or {}).items())},
    }


def fingerprint_attributes(attributes) -> str:
    """Canonical fingerprint of an authorization request
    (entities/attributes.py Attributes). Label and field selector
    requirements are order-insensitive (the evaluator exposes them as
    Cedar Sets)."""
    doc = {
        "kind": "sar",
        "user": _canonical_user(attributes.user),
        "verb": attributes.verb,
        "namespace": attributes.namespace,
        "apiGroup": attributes.api_group,
        "apiVersion": attributes.api_version,
        "resource": attributes.resource,
        "subresource": attributes.subresource,
        "name": attributes.name,
        "resourceRequest": attributes.resource_request,
        "path": attributes.path,
        "labelSelector": sorted(
            (r.key, r.operator, sorted(r.values)) for r in attributes.label_selector
        ),
        "fieldSelector": sorted(
            (r.field, r.operator, r.value) for r in attributes.field_selector
        ),
    }
    # a tenant or a wire protocol splits the key, folded only when present:
    # plain webhook fingerprints stay byte-identical without them
    if getattr(attributes, "tenant", ""):
        doc["tenant"] = attributes.tenant
    if getattr(attributes, "protocol", ""):
        doc["protocol"] = attributes.protocol
    return _hash_canonical(doc)


def fingerprint_admission_request(req) -> str:
    """Canonical fingerprint of an admission request
    (entities/admission.py AdmissionRequest).

    The review ``uid`` is deliberately EXCLUDED: it is a per-review nonce
    (fresh on every retry of the same write), and the decision cannot
    depend on it; the only place it reaches evaluation is as the re-ID of
    the oldObject entity, whose attributes are fingerprinted by content
    below. Including it would make every entry single-use."""
    doc = {
        "kind": "admission",
        "operation": req.operation,
        "gvk": (req.kind.group, req.kind.version, req.kind.kind),
        "gvr": (req.resource.group, req.resource.version, req.resource.resource),
        "subResource": req.sub_resource,
        "name": req.name,
        "namespace": req.namespace,
        "user": _canonical_user(req.user_info),
        "dryRun": bool(getattr(req, "dry_run", False)),
        # objects canonicalize through the same sorted-keys dump as the
        # envelope; lists stay ordered (k8s list fields are positional)
        "object": req.object,
        "oldObject": req.old_object,
    }
    if getattr(req, "tenant", ""):
        doc["tenant"] = req.tenant
    return _hash_canonical(doc)


def fingerprint_body(endpoint: str, body: bytes) -> Optional[str]:
    """Fingerprint a raw webhook POST body. ``endpoint`` is ``authorize``
    or ``admit`` (the /v1/ path tail). Returns None for bodies that do not
    parse: the serving paths produce their decode-error answer uncached.
    A body object carrying ``tenant`` or ``protocol`` attributes scopes
    the key to them."""
    tenant = getattr(body, "tenant", "")
    protocol = getattr(body, "protocol", "")
    try:
        doc = json.loads(body)
        if not isinstance(doc, dict):
            return None
        if endpoint == "authorize":
            # lazy import: the server wires the cache, so the cache layer
            # must not import it at module load
            from ..server.sar import get_authorizer_attributes

            attrs = get_authorizer_attributes(doc)
            if tenant:
                attrs.tenant = tenant
            if protocol:
                attrs.protocol = protocol
            return fingerprint_attributes(attrs)
        if endpoint == "admit":
            from ..entities.admission import AdmissionRequest

            req = AdmissionRequest.from_admission_review(doc)
            if tenant:
                req.tenant = tenant
            return fingerprint_admission_request(req)
    except Exception:  # noqa: BLE001 — unkeyable bodies are served uncached
        return None
    return None


class FingerprintMemo:
    """Bounded raw-body-digest -> canonical-fingerprint memo.

    The native SAR fast path ships raw bytes to the C++ encoder without a
    Python JSON parse; a canonical fingerprint needs that parse.
    Repetitive traffic (the premise of the cache) re-sends byte-identical
    bodies, so this memo makes the parse a once-per-unique-body cost: the
    hot path pays one sha256 over the body plus a dict hit.

    Two wire variants of the same canonical request occupy two memo rows
    that map to the SAME fingerprint: the decision cache still shares
    their entry."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._memo: "OrderedDict[bytes, Optional[str]]" = OrderedDict()

    def fingerprint(self, endpoint: str, body: bytes) -> Optional[str]:
        # a tenant or protocol splits memo rows as it splits keys; \x01 vs
        # \x00 separators keep the two prefixes unambiguous, and plain
        # bodies keep the bare-body key
        tenant = getattr(body, "tenant", "")
        protocol = getattr(body, "protocol", "")
        raw = body if not tenant else tenant.encode() + b"\x00" + body
        if protocol:
            raw = protocol.encode() + b"\x01" + raw
        digest = hashlib.sha256(raw).digest()
        with self._lock:
            if digest in self._memo:
                self._memo.move_to_end(digest)
                return self._memo[digest]
        fp = fingerprint_body(endpoint, body)
        with self._lock:
            self._memo[digest] = fp
            self._memo.move_to_end(digest)
            while len(self._memo) > self.capacity:
                self._memo.popitem(last=False)
        return fp


def recorded_name_parts(url_path: str, body: bytes) -> Tuple[str, str]:
    """(endpoint basename, fingerprint or 'unkeyed') for a recorded
    request: a recording's filename stamp, so it carries the exact cache
    key the live server used for it."""
    import os

    endpoint = os.path.basename(url_path) or "request"
    fp = fingerprint_body(endpoint, body)
    return endpoint, (fp if fp is not None else "unkeyed")
