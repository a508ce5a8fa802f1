"""Cedar schema text rendering: JSON model → ``.cedarschema`` source.

The reference delegates this translation to the Rust ``cedar translate-schema``
CLI in CI (Makefile:158-163) and then re-indents with its schema-formatter.
Here the translation is native: the output matches the layout of the
reference's generated artifacts (cedarschema/k8s-authorization.cedarschema):
common types, then entities, then actions, each alphabetized; optional
attributes marked ``?:``; primitives namespaced ``__cedar::``.
"""

from __future__ import annotations

from typing import List

from .model import (
    BOOL_TYPE,
    ENTITY_TYPE,
    LONG_TYPE,
    RECORD_TYPE,
    SET_TYPE,
    STRING_TYPE,
    ActionShape,
    Attribute,
    CedarSchema,
    Entity,
    EntityShape,
)

_PRIMITIVES = {STRING_TYPE, LONG_TYPE, BOOL_TYPE}

INDENT = "\t"


def _quote(s: str) -> str:
    return (
        '"'
        + s.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\r", "\\r")
        .replace("\t", "\\t")
        + '"'
    )


def _type_ref(type_name: str, name: str = "") -> str:
    if type_name in _PRIMITIVES:
        return f"__cedar::{type_name}"
    if type_name == ENTITY_TYPE and name:
        return name
    return type_name


def _attr_type(attr: Attribute, depth: int) -> str:
    if attr.type == SET_TYPE and attr.element is not None:
        return f"Set < {_type_ref(attr.element.type, attr.element.name)} >"
    if attr.type == RECORD_TYPE:
        return _record_body(attr.attributes, depth)
    return _type_ref(attr.type, attr.name)


def _record_body(attributes: dict, depth: int) -> str:
    if not attributes:
        return "{}"
    pad = INDENT * (depth + 1)
    lines = []
    for key in sorted(attributes):
        attr = attributes[key]
        opt = "" if attr.required else "?"
        lines.append(f"{pad}{_quote(key)}{opt}: {_attr_type(attr, depth + 1)}")
    return "{\n" + ",\n".join(lines) + "\n" + INDENT * depth + "}"


def _annotations(annotations: dict, depth: int) -> List[str]:
    pad = INDENT * depth
    return [
        f"{pad}@{key}({_quote(value)})"
        for key, value in sorted(annotations.items())
    ]


def _format_common_type(name: str, shape: EntityShape, depth: int) -> str:
    lines = _annotations(shape.annotations, depth)
    pad = INDENT * depth
    lines.append(f"{pad}type {name} = {_record_body(shape.attributes, depth)};")
    return "\n".join(lines)


def _format_entity(name: str, entity: Entity, depth: int) -> str:
    lines = _annotations(entity.annotations, depth)
    pad = INDENT * depth
    decl = f"{pad}entity {name}"
    if entity.member_of_types:
        decl += " in [" + ", ".join(entity.member_of_types) + "]"
    if entity.shape.attributes:
        decl += f" = {_record_body(entity.shape.attributes, depth)}"
    decl += ";"
    lines.append(decl)
    return "\n".join(lines)


def _format_action(name: str, action: ActionShape, depth: int) -> str:
    lines = _annotations(action.annotations, depth)
    pad = INDENT * depth
    decl = f"{pad}action {_quote(name)}"
    if action.member_of:
        ids = ", ".join(f'Action::{_quote(m.id)}' for m in action.member_of)
        decl += f" in [{ids}]"
    decl += " appliesTo {"
    lines.append(decl)
    pad1 = INDENT * (depth + 1)
    principals = ", ".join(sorted(action.applies_to.principal_types))
    resources = ", ".join(sorted(action.applies_to.resource_types))
    lines.append(f"{pad1}principal: [{principals}],")
    lines.append(f"{pad1}resource: [{resources}],")
    if action.applies_to.context is not None:
        ctx = _record_body(action.applies_to.context.attributes, depth + 1)
        lines.append(f"{pad1}context: {ctx}")
    else:
        lines.append(f"{pad1}context: {{}}")
    lines.append(f"{INDENT * depth}}};")
    return "\n".join(lines)


def format_schema(schema: CedarSchema) -> str:
    """Render the whole schema as cedarschema text, namespaces sorted by
    name; an empty-named namespace renders unwrapped at top level."""
    chunks = []
    for ns_name in sorted(schema.namespaces):
        ns = schema.namespaces[ns_name]
        depth = 1 if ns_name else 0
        decls = []
        for name in sorted(ns.common_types):
            decls.append(_format_common_type(name, ns.common_types[name], depth))
        for name in sorted(ns.entity_types):
            decls.append(_format_entity(name, ns.entity_types[name], depth))
        for name in sorted(ns.actions):
            decls.append(_format_action(name, ns.actions[name], depth))
        body = "\n".join(decls)
        if ns_name:
            chunks.append(f"namespace {ns_name} {{\n{body}\n}}")
        else:
            chunks.append(body)
    return "\n".join(chunks) + "\n"
