"""OpenAPI v3 → Cedar schema compiler.

Behavior parity with reference internal/schema/convert/openapi.go, operating
on plain decoded JSON documents (the live ``/openapi/v3`` and APIResourceList
payloads, or recorded fixtures):
  * component schemas become entities iff they carry apiVersion + kind +
    ``metadata: meta::v1::ObjectMeta`` (isEntity :227-243); List types
    (ListMeta metadata) are dropped (:246-262); everything else becomes a
    common type
  * entities get wired to admission actions by their APIResourceList verbs
    (delete/deletecollection → delete, update/patch → update + the
    self-referential optional ``oldObject`` attribute, create → create, and
    every entity joins ``all``) (:181-201)
  * attribute conversion (RefToEntityShape :320-527): string/integer/boolean
    primitives, arrays of primitives or $ref'd types (entity-typed elements
    for entity shapes and ``<Kind>List`` items), allOf single-ref attributes,
    inline-property objects via the depth-15 CRD walker (:529-597), and the
    known map[string]string / map[string][]string tables rendered as
    meta::v1 KeyValue / KeyValueStringSlice sets (:440-489)
  * kube-aggregator and apimachinery pkg types are skipped; Time/MicroTime
    degrade to String (name mangling in names.py)
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set

from ..k8s import (
    ADMISSION_CREATE_ACTION,
    ADMISSION_DELETE_ACTION,
    ADMISSION_UPDATE_ACTION,
    ALL_ACTION,
    add_resource_type_to_action,
)
from ..model import (
    BOOL_TYPE,
    ENTITY_TYPE,
    LONG_TYPE,
    RECORD_TYPE,
    SET_TYPE,
    STRING_TYPE,
    Attribute,
    AttributeElement,
    CedarSchema,
    Entity,
    EntityShape,
)
from .names import (
    escape_docstrings,
    ref_to_relative_type_name,
    schema_name_to_cedar,
    parse_schema_name,
    strip_ref_prefix,
)

log = logging.getLogger(__name__)

MAX_CRD_DEPTH = 15

# schemaKind → attr names whose map[string]string becomes Set<KeyValue>
# (reference openapi.go:440-457)
KNOWN_KEY_VALUE_STRING_MAP_ATTRIBUTES = {
    "io.k8s.api.core.v1.ConfigMap": ("data", "binaryData"),
    "io.k8s.api.core.v1.CSIPersistentVolumeSource": ("volumeAttributes",),
    "io.k8s.api.core.v1.CSIVolumeSource": ("volumeAttributes",),
    "io.k8s.api.core.v1.FlexPersistentVolumeSource": ("options",),
    "io.k8s.api.core.v1.FlexVolumeSource": ("options",),
    "io.k8s.api.core.v1.PersistentVolumeClaimStatus": (
        "allocatedResourceStatuses",
    ),
    "io.k8s.api.core.v1.PodSpec": ("nodeSelector",),
    "io.k8s.api.core.v1.ReplicationControllerSpec": ("selector",),
    "io.k8s.api.core.v1.Secret": ("data", "stringData"),
    "io.k8s.api.core.v1.ServiceSpec": ("selector",),
    "io.k8s.api.discovery.v1.Endpoint": ("deprecatedTopology",),
    "io.k8s.api.node.v1.Scheduling": ("nodeSelector",),
    "io.k8s.api.storage.v1.StorageClass": ("parameters",),
    "io.k8s.api.storage.v1.VolumeAttachmentStatus": ("attachmentMetadata",),
    "io.k8s.apimachinery.pkg.apis.meta.v1.LabelSelector": ("matchLabels",),
    "io.k8s.apimachinery.pkg.apis.meta.v1.ObjectMeta": ("annotations", "labels"),
}

# schemaKind → attr names whose map[string][]string becomes
# Set<KeyValueStringSlice> (reference openapi.go:469-473)
KNOWN_KEY_VALUE_STRING_SLICE_ATTRIBUTES = {
    "io.k8s.api.authentication.v1.UserInfo": ("extra",),
    "io.k8s.api.authorization.v1.SubjectAccessReviewSpec": ("extra",),
    "io.k8s.api.certificates.v1.CertificateSigningRequestSpec": ("extra",),
}

_KEY_VALUE_REF = "io.k8s.apimachinery.pkg.apis.meta.v1.KeyValue"
_KEY_VALUE_SLICE_REF = "io.k8s.apimachinery.pkg.apis.meta.v1.KeyValueStringSlice"

# OpenAPI primitive type → Cedar type
_PRIMITIVE_MAP = {
    "string": STRING_TYPE,
    "integer": LONG_TYPE,
    "boolean": BOOL_TYPE,
}


def _schema_type(defn: dict) -> Optional[str]:
    t = defn.get("type")
    if t is None:
        return None
    if isinstance(t, list):
        return t[0] if t else None
    return t


def _ref_of(defn: dict) -> str:
    return defn.get("$ref", "")


def is_entity(shape: EntityShape) -> bool:
    attrs = shape.attributes
    api_version = attrs.get("apiVersion")
    if api_version is None or api_version.type != STRING_TYPE:
        return False
    kind = attrs.get("kind")
    if kind is None or kind.type != STRING_TYPE:
        return False
    metadata = attrs.get("metadata")
    if metadata is None or metadata.type != "meta::v1::ObjectMeta":
        return False
    return True


def is_list_entity(shape: EntityShape) -> bool:
    attrs = shape.attributes
    api_version = attrs.get("apiVersion")
    if api_version is None or api_version.type != STRING_TYPE:
        return False
    kind = attrs.get("kind")
    if kind is None or kind.type != STRING_TYPE:
        return False
    metadata = attrs.get("metadata")
    if metadata is None or metadata.type != "meta::v1::ListMeta":
        return False
    return True


def verbs_for_kind(kind: str, api_resources: dict) -> Set[str]:
    verbs: Set[str] = set()
    for r in api_resources.get("resources", []):
        if r.get("kind") == kind:
            verbs.update(r.get("verbs", []))
    return verbs


def _components(openapi: dict) -> Dict[str, dict]:
    return (openapi.get("components") or {}).get("schemas") or {}


def ref_to_entity_shape(openapi: dict, schema_kind: str) -> EntityShape:
    """Component schema → EntityShape (reference RefToEntityShape)."""
    shape = EntityShape(type=RECORD_TYPE, attributes={})
    defn = _components(openapi).get(schema_kind)
    if defn is None:
        raise KeyError(f"schema {schema_kind} not found")

    required = defn.get("required") or []
    for attr_name, attr_def in (defn.get("properties") or {}).items():
        attr_type = _schema_type(attr_def)
        is_required = attr_name in required

        if attr_type in _PRIMITIVE_MAP:
            shape.attributes[attr_name] = Attribute(
                type=_PRIMITIVE_MAP[attr_type], required=is_required
            )
        elif attr_type == "number":
            # OpenAPI floats have no Cedar analogue; degrade like the
            # reference's default branch (skipped with a log line)
            log.debug("skipping %s attr %s of type number", schema_kind, attr_name)
        elif attr_type == "array":
            attr = _array_attribute(
                openapi, schema_kind, attr_name, attr_def, is_required
            )
            if attr is not None:
                shape.attributes[attr_name] = attr
        elif attr_type == "object":
            attr = _object_attribute(
                openapi, schema_kind, attr_name, attr_def, is_required
            )
            if attr is not None:
                shape.attributes[attr_name] = attr
        elif attr_type is None:
            all_of = attr_def.get("allOf") or []
            if len(all_of) == 1 and _ref_of(all_of[0]):
                ref = _ref_of(all_of[0])
                type_name = ref_to_relative_type_name(schema_kind, ref)
                attr = Attribute(type=type_name, required=is_required)
                if type_name != STRING_TYPE:
                    ref_shape = ref_to_entity_shape(openapi, strip_ref_prefix(ref))
                    if is_entity(ref_shape):
                        attr = Attribute(
                            type=ENTITY_TYPE, name=type_name, required=is_required
                        )
                shape.attributes[attr_name] = attr
            else:
                log.debug(
                    "skipping %s attr %s with no .type or single allOf",
                    schema_kind,
                    attr_name,
                )
        else:
            log.debug(
                "skipping %s attr %s type %s", schema_kind, attr_name, attr_type
            )
    return shape


def _array_attribute(
    openapi: dict,
    schema_kind: str,
    attr_name: str,
    attr_def: dict,
    is_required: bool,
) -> Optional[Attribute]:
    items = attr_def.get("items") or {}
    item_type = _schema_type(items)
    if item_type in _PRIMITIVE_MAP:
        return Attribute(
            type=SET_TYPE,
            element=AttributeElement(type=_PRIMITIVE_MAP[item_type]),
            required=is_required,
        )

    all_of = items.get("allOf") or []
    ref = _ref_of(all_of[0]) if all_of else _ref_of(items)
    if ref:
        type_name = ref_to_relative_type_name(schema_kind, ref)
        element = AttributeElement(type=type_name)
        if type_name != STRING_TYPE:
            item_shape = ref_to_entity_shape(openapi, strip_ref_prefix(ref))
            # list items of `<Kind>List` types, and any entity-shaped items,
            # are entity references (reference openapi.go:384-387)
            if schema_kind.endswith(f".{type_name}List") or is_entity(item_shape):
                element = AttributeElement(type=ENTITY_TYPE, name=type_name)
        return Attribute(
            type=SET_TYPE, element=element, required=is_required
        )

    log.debug(
        "skipping %s attr %s array of type %s", schema_kind, attr_name, item_type
    )
    return None


def _object_attribute(
    openapi: dict,
    schema_kind: str,
    attr_name: str,
    attr_def: dict,
    is_required: bool,
) -> Optional[Attribute]:
    if attr_def.get("properties"):
        attrs = parse_crd_properties(MAX_CRD_DEPTH, attr_def["properties"])
        return Attribute(
            type=RECORD_TYPE, attributes=attrs, required=is_required
        )

    additional = attr_def.get("additionalProperties")
    if not isinstance(additional, dict):
        log.debug(
            "skipping %s attr %s object with no additionalProperties",
            schema_kind,
            attr_name,
        )
        return None

    ref = _ref_of(additional)
    if ref:
        type_name = ref_to_relative_type_name(schema_kind, ref)
        if type_name != STRING_TYPE:
            ref_shape = ref_to_entity_shape(openapi, strip_ref_prefix(ref))
            if is_entity(ref_shape):
                return Attribute(
                    type=ENTITY_TYPE, name=type_name, required=is_required
                )
        return Attribute(type=type_name, required=is_required)

    if (
        attr_name in KNOWN_KEY_VALUE_STRING_MAP_ATTRIBUTES.get(schema_kind, ())
        and _schema_type(additional) == "string"
    ):
        return Attribute(
            type=SET_TYPE,
            element=AttributeElement(
                type=ref_to_relative_type_name(schema_kind, _KEY_VALUE_REF)
            ),
        )

    additional_items = (additional.get("items") or {})
    if (
        attr_name in KNOWN_KEY_VALUE_STRING_SLICE_ATTRIBUTES.get(schema_kind, ())
        and _schema_type(additional) == "array"
        and _schema_type(additional_items) == "string"
    ):
        return Attribute(
            type=SET_TYPE,
            element=AttributeElement(
                type=ref_to_relative_type_name(schema_kind, _KEY_VALUE_SLICE_REF)
            ),
        )

    log.debug("skipping %s attr %s untyped map", schema_kind, attr_name)
    return None


def parse_crd_properties(depth: int, properties: dict) -> Dict[str, Attribute]:
    """Inline object properties walker, depth-capped at 15 (reference
    parseCRDProperties, openapi.go:529-597)."""
    if depth == 0:
        raise ValueError("max depth reached")
    attrs: Dict[str, Attribute] = {}
    for key, defn in properties.items():
        t = _schema_type(defn)
        required = key in (defn.get("required") or [])
        if t in _PRIMITIVE_MAP:
            attrs[key] = Attribute(type=_PRIMITIVE_MAP[t], required=required)
        elif t == "array":
            items = defn.get("items") or {}
            item_type = _schema_type(items)
            if item_type in _PRIMITIVE_MAP:
                attrs[key] = Attribute(
                    type=SET_TYPE,
                    element=AttributeElement(type=_PRIMITIVE_MAP[item_type]),
                    required=required,
                )
            else:
                log.debug("skipping CRD attr %s array of %s", key, item_type)
        elif t == "object":
            if key == "podTemplate":
                attrs[key] = Attribute(
                    type="core::v1::PodTemplate", required=required
                )
            elif defn.get("properties"):
                attrs[key] = Attribute(
                    type=RECORD_TYPE,
                    attributes=parse_crd_properties(
                        depth - 1, defn["properties"]
                    ),
                )
        else:
            log.debug("skipping CRD attr %s type %s", key, t)
    return attrs


def modify_schema_for_api_version(
    api_resources: dict,
    openapi: dict,
    cedar_schema: CedarSchema,
    api: str,
    version: str,
    action_namespace: str,
) -> None:
    """Fold one API group/version's OpenAPI document into the Cedar schema
    (reference ModifySchemaForAPIVersion, openapi.go:90-205)."""
    for schema_kind, defn in _components(openapi).items():
        if "io.k8s.kube-aggregator.pkg.apis" in schema_kind:
            continue

        api_ns, api_group, s_version, s_kind = parse_schema_name(schema_kind)
        if api_ns == "pkg.apimachinery.k8s.io" or (
            api_group == "meta"
            and s_version == "v1"
            and s_kind in ("Time", "MicroTime")
        ):
            continue
        if s_version != version:
            continue

        ns_name, _ = schema_name_to_cedar(schema_kind)
        ns = cedar_schema.namespace(ns_name)
        if s_kind in ns.entity_types or s_kind in ns.common_types:
            continue

        def_type = _schema_type(defn)
        if def_type is None:
            continue

        if def_type == "object":
            try:
                shape = ref_to_entity_shape(openapi, schema_kind)
            except (KeyError, ValueError) as e:
                log.error("failed to serialize entity %s: %s", schema_kind, e)
                continue
            entity = Entity(shape=shape)
            doc = escape_docstrings(defn.get("description", ""))
            if doc:
                entity.annotations = {"doc": doc}
        elif def_type == "string":
            entity = Entity(shape=EntityShape(type=STRING_TYPE, attributes={}))
        else:
            continue

        if is_list_entity(entity.shape):
            # List types never reach admission; drop them
            continue

        if not is_entity(entity.shape):
            ns.common_types[s_kind] = entity.shape
            continue

        if "oldObject" in entity.shape.attributes:
            raise ValueError(
                f"Conflict with Kubernetes resource {ns_name}::{s_kind}: has "
                "attribute name `oldObject` that conflicts with Cedar "
                "schema's oldObject"
            )

        verbs = verbs_for_kind(s_kind, api_resources)
        full_name = f"{ns_name}::{s_kind}"

        if verbs & {"delete", "deletecollection"}:
            add_resource_type_to_action(
                cedar_schema, action_namespace, ADMISSION_DELETE_ACTION, full_name
            )
        if verbs & {"update", "patch"}:
            # updates see the prior object: optional self-referential
            # oldObject entity attribute (reference openapi.go:175-192)
            entity.shape.attributes["oldObject"] = Attribute(
                type=ENTITY_TYPE, name=s_kind, required=False
            )
            add_resource_type_to_action(
                cedar_schema, action_namespace, ADMISSION_UPDATE_ACTION, full_name
            )
        if "create" in verbs:
            add_resource_type_to_action(
                cedar_schema, action_namespace, ADMISSION_CREATE_ACTION, full_name
            )

        ns.entity_types[s_kind] = entity
        add_resource_type_to_action(
            cedar_schema, action_namespace, ALL_ACTION, full_name
        )
