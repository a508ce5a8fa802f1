"""OpenAPI schema-name → Cedar namespace/type mangling.

Behavior parity with reference internal/schema/convert/name_transform.go:
``io.k8s.api.apps.v1.Deployment`` → (``apps::v1``, ``Deployment``);
apimachinery meta types → ``meta::v1``; third-party CRD schema names keep
their reversed-domain namespace; Time/MicroTime/Quantity/IntOrString/
RawExtension degrade to String.
"""

from __future__ import annotations

from typing import Tuple

from ..model import STRING_TYPE

_COMPONENTS_PREFIX = "#/components/schemas/"


def parse_schema_name(schema_name: str) -> Tuple[str, str, str, str]:
    """→ (ns, api_group, version, kind). ns is non-empty only for types that
    are neither io.k8s.api.* nor apimachinery meta.* (i.e. CRDs)."""
    schema_name = schema_name.replace("-", "_")
    parts = schema_name.split(".")
    if len(parts) < 4:
        return "", "", "", ""
    rev = list(reversed(parts))

    ns = ""
    if schema_name.startswith("io.k8s.api."):
        rev = rev[: len(rev) - 3]
    elif schema_name.startswith("io.k8s.apimachinery.pkg.apis.meta"):
        rev = rev[: len(rev) - 4]
    else:
        ns_parts = list(reversed(rev[3:]))
        ns = "::".join(ns_parts)

    kind = rev[0]
    version = rev[1]
    api_group = rev[2]
    return ns, api_group, version, kind


def schema_name_to_cedar(schema_name: str) -> Tuple[str, str]:
    """→ (cedar namespace, type name)."""
    ns, api_group, version, kind = parse_schema_name(schema_name)
    if ns:
        return f"{ns}::{api_group}::{version}", kind
    return f"{api_group}::{version}", kind


_STRING_DEGRADED = {
    ("meta::v1", "Time"),
    ("meta::v1", "MicroTime"),
    ("io::k8s::apimachinery::pkg::util::intstr", "IntOrString"),
    ("io::k8s::apimachinery::pkg::api::resource", "Quantity"),
    ("io::k8s::apimachinery::pkg::runtime", "RawExtension"),
}


def strip_ref_prefix(ref: str) -> str:
    if ref.startswith(_COMPONENTS_PREFIX):
        return ref[len(_COMPONENTS_PREFIX):]
    return ref


def ref_to_relative_type_name(current: str, ref: str) -> str:
    """``#/components/schemas/io.k8s.api.apps.v1.DaemonSetSpec`` referenced
    from an apps/v1 type → ``DaemonSetSpec``; cross-namespace references are
    fully qualified; timestamp-ish types degrade to String."""
    current_ns, _ = schema_name_to_cedar(strip_ref_prefix(current))
    ref_ns, ref_type = schema_name_to_cedar(strip_ref_prefix(ref))

    if (ref_ns, ref_type) in _STRING_DEGRADED:
        return STRING_TYPE

    if current_ns == ref_ns:
        return ref_type
    return f"{ref_ns}::{ref_type}"


def escape_docstrings(doc: str) -> str:
    idx = doc.find("Example:")
    if idx >= 0:
        doc = doc[:idx]
    return doc.strip()
