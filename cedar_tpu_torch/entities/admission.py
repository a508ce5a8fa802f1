"""Admission-path entity construction: AdmissionReview → Cedar entities.

The port's copy of the JAX package's entities/admission.py. Behavior
parity with the upstream project's internal/server/entities/admission.go:
  * admission action entities ``create/update/delete/connect`` with a shared
    ``all`` parent (AdmissionActionEntities :40-53)
  * AdmissionRequest → authorizer-attributes adapter (:78-100): verb is the
    operation, always a resource request, no selectors
  * raw request object → Cedar Record via a recursive walk with a depth cap
    of 32 (:160-369), with:
      - per-group/version/kind map[string]string attributes rendered as a Set
        of {key, value} records (:195-251)
      - per-g/v/k map[string][]string attributes rendered as a Set of
        {key, value: Set<String>} records (:253-295)
      - a generic ``labels``/``annotations`` fallback (:297-312)
      - IP-typed well-known fields (podIP, clusterIP, ... :347-353)
      - dicts → Records (empties skipped), lists → Sets, ints → Long,
        bools → Boolean; other leaves (e.g. JSON floats) are an error, which
        the handler maps to its allow-on-error posture
  * the resource entity type is ``<group or "core">::<version>::<Kind>`` and
    its ID is the request's Kubernetes URL path (:123-158)

Intentional divergences from the reference: the
reference's map[string][]string branch dead-ends on JSON-decoded input (a Go
type-assertion to []string always fails post-unmarshal) and its non-string
label value path drops the remaining keys; we render both correctly and skip
only the offending key.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from ..lang.entities import Entity, EntityMap
from ..lang.values import CedarRecord, CedarSet, EntityUID, IPAddr
from ..schema import consts
from .attributes import Attributes, UserInfo, resource_request_to_path

MAX_WALK_DEPTH = 32

# g/v/k → attribute names whose map[string]string value becomes a
# Set<{key, value}> (reference admission.go:195-229).
KNOWN_KEY_VALUE_STRING_MAP_ATTRIBUTES = {
    ("core", "v1", "ConfigMap"): ("data", "binaryData"),
    ("core", "v1", "CSIPersistentVolumeSource"): ("volumeAttributes",),
    ("core", "v1", "CSIVolumeSource"): ("volumeAttributes",),
    ("core", "v1", "FlexPersistentVolumeSource"): ("options",),
    ("core", "v1", "FlexVolumeSource"): ("options",),
    ("core", "v1", "PersistentVolumeClaimStatus"): ("allocatedResourceStatuses",),
    ("core", "v1", "Pod"): ("nodeSelector",),
    ("core", "v1", "ReplicationController"): ("selector",),
    ("core", "v1", "Secret"): ("data", "stringData"),
    ("core", "v1", "Service"): ("selector",),
    ("discovery", "v1", "Endpoint"): ("deprecatedTopology",),
    ("node", "v1", "Scheduling"): ("nodeSelectors",),
    ("storage", "v1", "StorageClass"): ("parameters",),
    ("storage", "v1", "VolumeAttachmentStatus"): ("attachmentMetadata",),
    ("meta", "v1", "LabelSelector"): ("matchLabels",),
    ("meta", "v1", "ObjectMeta"): ("annotations", "labels"),
}

# g/v/k → attribute names whose map[string][]string value becomes a
# Set<{key, value: Set<String>}> (reference admission.go:253-269).
KNOWN_KEY_VALUE_STRING_SLICE_MAP_ATTRIBUTES = {
    ("authentication", "v1", "UserInfo"): ("extra",),
    ("authorization", "v1", "SubjectAccessReview"): ("extra",),
    ("certificates", "v1", "CertificateSigningRequest"): ("extra",),
}

# String leaves under these key names are parsed as Cedar ipaddr when
# possible (reference admission.go:347-353).
IP_ADDRESS_KEYS = frozenset(
    {"podIP", "clusterIP", "loadBalancerIP", "hostIP", "ip", "podIPs", "hostIPs"}
)


def review_request_uid(review) -> str:
    """uid of a decoded AdmissionReview, tolerating arbitrary wire shapes
    (non-dict review/request, non-string uid). Like the reference's typed
    unmarshal, malformed nodes read as zero values — the allow-on-error
    paths extract the uid AFTER a conversion crash, so this must never
    raise itself (found by the type-flip fuzz: ``"request": 3.5`` made
    the error path the thing that crashed)."""
    req = review.get("request") if isinstance(review, dict) else None
    uid = req.get("uid") if isinstance(req, dict) else ""
    return uid if isinstance(uid, str) else ""


@dataclass
class GroupVersionKind:
    group: str = ""
    version: str = ""
    kind: str = ""


@dataclass
class GroupVersionResource:
    group: str = ""
    version: str = ""
    resource: str = ""


@dataclass
class AdmissionRequest:
    """The slice of a k8s AdmissionReview request the webhook consumes."""

    uid: str = ""
    kind: GroupVersionKind = field(default_factory=GroupVersionKind)
    resource: GroupVersionResource = field(default_factory=GroupVersionResource)
    sub_resource: str = ""
    name: str = ""
    namespace: str = ""
    operation: str = ""  # CREATE | UPDATE | DELETE | CONNECT
    user_info: UserInfo = field(default_factory=UserInfo)
    object: Optional[dict] = None
    old_object: Optional[dict] = None
    # AdmissionReview.request.dryRun: true marks a side-effect-free review
    # (evaluation-identical to the real write); the admission decision
    # cache's read-only gate keys on it (server/admission.py)
    dry_run: bool = False
    # tenant id the front end resolved for this review (tenancy/, never
    # part of the wire body): stamped into context.tenantId so the fused
    # plane's discriminators isolate admission decisions too, and folded
    # into the canonical fingerprint (cache/fingerprint.py)
    tenant: str = ""

    @classmethod
    def from_admission_review(cls, review: dict) -> "AdmissionRequest":
        """Parse the ``request`` of a decoded admission.k8s.io/v1
        AdmissionReview JSON body."""
        req = review.get("request") or {}
        ui = req.get("userInfo", {}) or {}
        extra = {
            k: tuple(v) for k, v in (ui.get("extra") or {}).items()
        }

        def _obj(key: str) -> Optional[dict]:
            raw = req.get(key)
            if raw is None:
                return None
            if isinstance(raw, (str, bytes)):
                return json.loads(raw)
            return raw

        # known-field extraction, like the reference's typed json unmarshal
        # (unknown keys in the wire document are IGNORED, never an error —
        # a **kwargs construction would turn them into a TypeError and an
        # allow-on-error response; found by the mutate-adm fuzz)
        kind_d = req.get("kind") or {}
        res_d = req.get("resource") or {}
        return cls(
            uid=req.get("uid", ""),
            kind=GroupVersionKind(
                group=kind_d.get("group", ""),
                version=kind_d.get("version", ""),
                kind=kind_d.get("kind", ""),
            ),
            resource=GroupVersionResource(
                group=res_d.get("group", ""),
                version=res_d.get("version", ""),
                resource=res_d.get("resource", ""),
            ),
            sub_resource=req.get("subResource", ""),
            name=req.get("name", ""),
            namespace=req.get("namespace", ""),
            operation=req.get("operation", ""),
            dry_run=bool(req.get("dryRun", False)),
            user_info=UserInfo(
                name=ui.get("username", ""),
                uid=ui.get("uid", ""),
                groups=tuple(ui.get("groups") or ()),
                extra=extra,
            ),
            object=_obj("object"),
            old_object=_obj("oldObject"),
        )


def admission_action_entities() -> EntityMap:
    """The five admission action entities; create/update/delete/connect have
    ``all`` as parent so ``action in Action::"all"`` matches everything."""
    out = EntityMap()
    all_uid = EntityUID(
        consts.ADMISSION_ACTION_ENTITY_TYPE, consts.ADMISSION_ACTION_ALL
    )
    out.add(Entity(all_uid))
    for action_id in (
        consts.ADMISSION_ACTION_CONNECT,
        consts.ADMISSION_ACTION_CREATE,
        consts.ADMISSION_ACTION_UPDATE,
        consts.ADMISSION_ACTION_DELETE,
    ):
        out.add(
            Entity(
                EntityUID(consts.ADMISSION_ACTION_ENTITY_TYPE, action_id),
                parents=(all_uid,),
            )
        )
    return out


_OPERATION_TO_ACTION = {
    "CONNECT": consts.ADMISSION_ACTION_CONNECT,
    "CREATE": consts.ADMISSION_ACTION_CREATE,
    "UPDATE": consts.ADMISSION_ACTION_UPDATE,
    "DELETE": consts.ADMISSION_ACTION_DELETE,
}


def admission_action_uid(req: AdmissionRequest) -> EntityUID:
    action = _OPERATION_TO_ACTION.get(req.operation)
    if action is None:
        raise ValueError(f"unsupported operation {req.operation}")
    return EntityUID(consts.ADMISSION_ACTION_ENTITY_TYPE, action)


def admission_request_to_attributes(req: AdmissionRequest) -> Attributes:
    """AdmissionRequest viewed as authorizer attributes (reference
    admission.go:78-100): the operation is the verb, always a resource
    request, never read-only, no selectors."""
    return Attributes(
        user=req.user_info,
        verb=req.operation,
        namespace=req.namespace,
        api_group=req.resource.group,
        api_version=req.resource.version,
        resource=req.resource.resource,
        subresource=req.sub_resource,
        name=req.name,
        resource_request=True,
    )


def principal_entities_from_admission_request(
    req: AdmissionRequest,
) -> Tuple[EntityUID, EntityMap]:
    from .user import user_to_cedar_entity

    return user_to_cedar_entity(req.user_info)


def resource_entity_from_admission_request(
    req: AdmissionRequest, old: bool = False
) -> Entity:
    """Build the Cedar resource entity from the request's (old)object.

    The entity type is ``<group or "core">::<version>::<Kind>`` and the ID is
    the request's Kubernetes URL path (reference admission.go:123-158).
    """
    raw = req.old_object if old else req.object
    if raw is None:
        which = "oldObject" if old else "object"
        raise ValueError(f"unstructured data is nil for {which}")

    group = req.resource.group or "core"
    attributes = unstructured_to_record(raw, group, req.kind.version, req.kind.kind)
    entity_type = "::".join([group, req.kind.version, req.kind.kind])
    path = resource_request_to_path(admission_request_to_attributes(req))
    return Entity(EntityUID(entity_type, path), attributes)


def unstructured_to_record(
    obj: dict, group: str, version: str, kind: str
) -> CedarRecord:
    """Top-level unstructured object → Cedar Record (reference
    admission.go:160-182). Nil values and empty nested objects are skipped."""
    if obj is None:
        raise ValueError("unstructured object is nil")
    attrs = {}
    for k, v in obj.items():
        if v is None:
            continue
        val = _walk_object(MAX_WALK_DEPTH, group, version, kind, k, v)
        if val is None:
            continue
        attrs[k] = val
    return CedarRecord(attrs)


def _key_value_set(mapping: Any) -> CedarSet:
    elems = []
    for kk, vv in mapping.items():
        if not isinstance(vv, str):
            continue  # non-string value: skip this key (see module docstring)
        elems.append(CedarRecord({"key": kk, "value": vv}))
    return CedarSet(elems)


def _key_value_slice_set(mapping: Any) -> CedarSet:
    elems = []
    for kk, vv in mapping.items():
        if not isinstance(vv, (list, tuple)):
            continue
        vals = tuple(v for v in vv if isinstance(v, str))
        elems.append(CedarRecord({"key": kk, "value": CedarSet(vals)}))
    return CedarSet(elems)


def _walk_object(
    depth: int, group: str, version: str, kind: str, key_name: str, obj: Any
):
    if depth == 0:
        raise ValueError("max depth reached")
    if obj is None:
        return None

    if isinstance(obj, dict):
        gvk = (group, version, kind)
        if key_name in KNOWN_KEY_VALUE_STRING_MAP_ATTRIBUTES.get(gvk, ()):
            return _key_value_set(obj)
        if key_name in KNOWN_KEY_VALUE_STRING_SLICE_MAP_ATTRIBUTES.get(gvk, ()):
            return _key_value_slice_set(obj)
        if key_name in ("labels", "annotations"):
            return _key_value_set(obj)
        rec = {}
        for kk, vv in obj.items():
            val = _walk_object(depth - 1, group, version, kind, kk, vv)
            if val is None:
                continue
            rec[kk] = val
        if not rec:
            return None  # skip empty records
        return CedarRecord(rec)

    if isinstance(obj, (list, tuple)):
        elems = []
        for item in obj:
            val = _walk_object(depth - 1, group, version, kind, key_name, item)
            if val is not None:
                elems.append(val)
        return CedarSet(elems)

    if isinstance(obj, str):
        if key_name in IP_ADDRESS_KEYS:
            try:
                return IPAddr.parse(obj)
            except Exception:
                return obj
        return obj

    if isinstance(obj, bool):
        return obj
    if isinstance(obj, int):
        return obj

    raise ValueError(f"unsupported type {type(obj).__name__}")
