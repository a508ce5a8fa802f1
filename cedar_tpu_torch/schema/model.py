"""Cedar schema data model (JSON schema format).

Mirrors reference internal/schema/cedar_schema_types.go: a CedarSchema is a
map of namespace → {entityTypes, actions, commonTypes}, with the marshal
quirk that a Record-typed attribute always serializes an ``attributes`` key
(cedar assumes it is present, :100-150), and ``required`` is always emitted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

STRING_TYPE = "String"
LONG_TYPE = "Long"
BOOL_TYPE = "Boolean"
SET_TYPE = "Set"
RECORD_TYPE = "Record"
ENTITY_TYPE = "Entity"


def doc_annotation(value: str) -> Dict[str, str]:
    return {"doc": value}


@dataclass
class AttributeElement:
    """Element type of a Set attribute."""

    type: str
    name: str = ""

    def to_json(self) -> dict:
        out = {"type": self.type}
        if self.name:
            out["name"] = self.name
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "AttributeElement":
        return cls(type=doc.get("type", ""), name=doc.get("name", ""))


@dataclass
class Attribute:
    type: str
    name: str = ""
    required: bool = False
    element: Optional[AttributeElement] = None
    attributes: Dict[str, "Attribute"] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out: dict = {}
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        if self.name:
            out["name"] = self.name
        out["type"] = self.type
        out["required"] = self.required
        if self.element is not None:
            out["element"] = self.element.to_json()
        if self.attributes:
            out["attributes"] = {
                k: v.to_json() for k, v in self.attributes.items()
            }
        elif self.type == RECORD_TYPE:
            # cedar requires `attributes` on Record types even when empty
            out["attributes"] = {}
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "Attribute":
        elem = doc.get("element")
        return cls(
            type=doc.get("type", ""),
            name=doc.get("name", ""),
            required=bool(doc.get("required", False)),
            element=AttributeElement.from_json(elem) if elem else None,
            attributes={
                k: Attribute.from_json(v)
                for k, v in (doc.get("attributes") or {}).items()
            },
            annotations=dict(doc.get("annotations") or {}),
        )


@dataclass
class EntityShape:
    type: str = RECORD_TYPE
    attributes: Dict[str, Attribute] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out: dict = {}
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        out["type"] = self.type
        out["attributes"] = {k: v.to_json() for k, v in self.attributes.items()}
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "EntityShape":
        return cls(
            type=doc.get("type", RECORD_TYPE),
            attributes={
                k: Attribute.from_json(v)
                for k, v in (doc.get("attributes") or {}).items()
            },
            annotations=dict(doc.get("annotations") or {}),
        )


@dataclass
class Entity:
    shape: EntityShape = field(default_factory=EntityShape)
    member_of_types: List[str] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out: dict = {}
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        out["shape"] = self.shape.to_json()
        if self.member_of_types:
            out["memberOfTypes"] = list(self.member_of_types)
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "Entity":
        return cls(
            shape=EntityShape.from_json(doc.get("shape") or {}),
            member_of_types=list(doc.get("memberOfTypes") or []),
            annotations=dict(doc.get("annotations") or {}),
        )


@dataclass
class ActionMember:
    id: str

    def to_json(self) -> dict:
        return {"id": self.id}


@dataclass
class ActionAppliesTo:
    principal_types: List[str] = field(default_factory=list)
    resource_types: List[str] = field(default_factory=list)
    context: Optional[EntityShape] = None

    def to_json(self) -> dict:
        out: dict = {
            "principalTypes": list(self.principal_types),
            "resourceTypes": list(self.resource_types),
        }
        if self.context is not None:
            out["context"] = self.context.to_json()
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "ActionAppliesTo":
        ctx = doc.get("context")
        return cls(
            principal_types=list(doc.get("principalTypes") or []),
            resource_types=list(doc.get("resourceTypes") or []),
            context=EntityShape.from_json(ctx) if ctx else None,
        )


@dataclass
class ActionShape:
    applies_to: ActionAppliesTo = field(default_factory=ActionAppliesTo)
    member_of: List[ActionMember] = field(default_factory=list)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out: dict = {}
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        out["appliesTo"] = self.applies_to.to_json()
        if self.member_of:
            out["memberOf"] = [m.to_json() for m in self.member_of]
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "ActionShape":
        return cls(
            applies_to=ActionAppliesTo.from_json(doc.get("appliesTo") or {}),
            member_of=[
                ActionMember(id=m.get("id", ""))
                for m in (doc.get("memberOf") or [])
            ],
            annotations=dict(doc.get("annotations") or {}),
        )


@dataclass
class Namespace:
    entity_types: Dict[str, Entity] = field(default_factory=dict)
    actions: Dict[str, ActionShape] = field(default_factory=dict)
    common_types: Dict[str, EntityShape] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out: dict = {}
        if self.annotations:
            out["annotations"] = dict(self.annotations)
        out["entityTypes"] = {
            k: v.to_json() for k, v in self.entity_types.items()
        }
        out["actions"] = {k: v.to_json() for k, v in self.actions.items()}
        if self.common_types:
            out["commonTypes"] = {
                k: v.to_json() for k, v in self.common_types.items()
            }
        return out

    @classmethod
    def from_json(cls, doc: dict) -> "Namespace":
        return cls(
            entity_types={
                k: Entity.from_json(v)
                for k, v in (doc.get("entityTypes") or {}).items()
            },
            actions={
                k: ActionShape.from_json(v)
                for k, v in (doc.get("actions") or {}).items()
            },
            common_types={
                k: EntityShape.from_json(v)
                for k, v in (doc.get("commonTypes") or {}).items()
            },
            annotations=dict(doc.get("annotations") or {}),
        )


class CedarSchema:
    """namespace name → Namespace."""

    def __init__(self):
        self.namespaces: Dict[str, Namespace] = {}

    def namespace(self, name: str) -> Namespace:
        """Get or create a namespace."""
        if name not in self.namespaces:
            self.namespaces[name] = Namespace()
        return self.namespaces[name]

    def to_json(self) -> dict:
        return {k: v.to_json() for k, v in self.namespaces.items()}

    @classmethod
    def from_json(cls, doc: dict) -> "CedarSchema":
        schema = cls()
        for name, ns_doc in doc.items():
            schema.namespaces[name] = Namespace.from_json(ns_doc or {})
        return schema

    def sort_action_entities(self) -> None:
        for ns in self.namespaces.values():
            for action in ns.actions.values():
                action.applies_to.principal_types.sort()
                action.applies_to.resource_types.sort()

    def get_entity_shape(self, name: str) -> Optional[EntityShape]:
        """Shape of an entity or common type by namespaced name (reference
        GetEntityShape, cedar_schema_types.go:29-60)."""
        parts = name.split("::")
        ns_name = ""
        if len(parts) > 1:
            ns_name = "::".join(parts[:-1])
            name = parts[-1]
        ns = self.namespaces.get(ns_name)
        if ns is None:
            return None
        entity = ns.entity_types.get(name)
        if entity is not None:
            return entity.shape
        return ns.common_types.get(name)
