"""Hand-coded Kubernetes Cedar schema namespaces.

Behavior parity with the reference's hand-written schema definitions:
  * authorization namespace — internal/schema/authorization.go: entity shapes
    for PrincipalUID/NonResourceURL/Resource + Field/LabelRequirement common
    types, the 19 verbs with their resource-only / non-resource-only
    appliesTo splits, and impersonate applying to principal types
  * principal entities — internal/schema/user_entities.go: User/Group/
    ServiceAccount/Node/Extra shapes + ExtraAttribute common type
  * admission actions — internal/schema/admission_actions.go: create/update/
    delete/connect with `all` as parent
  * CONNECT option entities — internal/schema/connect_entities.go: core::v1
    {Node,Pod,Service}ProxyOptions, PodExec/Attach/PortForwardOptions
  * meta::v1 KeyValue common types — internal/schema/admission.go
"""

from __future__ import annotations

from typing import List

from .model import (
    BOOL_TYPE,
    RECORD_TYPE,
    SET_TYPE,
    STRING_TYPE,
    ActionAppliesTo,
    ActionMember,
    ActionShape,
    Attribute,
    AttributeElement,
    CedarSchema,
    Entity,
    EntityShape,
    Namespace,
    doc_annotation,
)

USER_PRINCIPAL_TYPE = "User"
GROUP_PRINCIPAL_TYPE = "Group"
SERVICE_ACCOUNT_PRINCIPAL_TYPE = "ServiceAccount"
NODE_PRINCIPAL_TYPE = "Node"
EXTRA_VALUE_TYPE = "Extra"
EXTRA_VALUES_ATTRIBUTE_TYPE = "ExtraAttribute"

PRINCIPAL_UID_ENTITY_NAME = "PrincipalUID"
NON_RESOURCE_URL_ENTITY_NAME = "NonResourceURL"
RESOURCE_ENTITY_NAME = "Resource"
FIELD_REQUIREMENT_NAME = "FieldRequirement"
LABEL_REQUIREMENT_NAME = "LabelRequirement"

ADMISSION_CREATE_ACTION = "create"
ADMISSION_UPDATE_ACTION = "update"
ADMISSION_DELETE_ACTION = "delete"
ADMISSION_CONNECT_ACTION = "connect"
ALL_ACTION = "all"

AUTHORIZATION_ACTION_NAMES = (
    "get",
    "list",
    "watch",
    "create",
    "update",
    "patch",
    "delete",
    "deletecollection",
    "use",
    "bind",
    "impersonate",
    "approve",
    "sign",
    "escalate",
    "attest",
    "put",
    "post",
    "head",
    "options",
)

NON_RESOURCE_ONLY_ACTIONS = ("put", "post", "head", "options")

RESOURCE_ONLY_ACTIONS = (
    "list",
    "watch",
    "create",
    "update",
    "deletecollection",
    "use",
    "bind",
    "approve",
    "sign",
    "escalate",
    "attest",
)


def _extra_set_attribute() -> Attribute:
    return Attribute(
        type=SET_TYPE,
        required=False,
        element=AttributeElement(type=EXTRA_VALUES_ATTRIBUTE_TYPE),
    )


def user_entity() -> Entity:
    return Entity(
        annotations=doc_annotation("User represents a Kubernetes user identity"),
        member_of_types=[GROUP_PRINCIPAL_TYPE],
        shape=EntityShape(
            attributes={
                "name": Attribute(type=STRING_TYPE, required=True),
                "extra": _extra_set_attribute(),
            }
        ),
    )


def group_entity() -> Entity:
    return Entity(
        annotations=doc_annotation("Group represents a Kubernetes group"),
        shape=EntityShape(
            attributes={"name": Attribute(type=STRING_TYPE, required=True)}
        ),
    )


def service_account_entity() -> Entity:
    return Entity(
        annotations=doc_annotation(
            "ServiceAccount represents a Kubernetes service account identity"
        ),
        member_of_types=[GROUP_PRINCIPAL_TYPE],
        shape=EntityShape(
            attributes={
                "name": Attribute(type=STRING_TYPE, required=True),
                "namespace": Attribute(type=STRING_TYPE, required=True),
                "extra": _extra_set_attribute(),
            }
        ),
    )


def node_entity() -> Entity:
    return Entity(
        annotations=doc_annotation("Node represents a Kubernetes node identity"),
        member_of_types=[GROUP_PRINCIPAL_TYPE],
        shape=EntityShape(
            attributes={
                "name": Attribute(type=STRING_TYPE, required=True),
                "extra": _extra_set_attribute(),
            }
        ),
    )


def extra_entity_shape() -> EntityShape:
    return EntityShape(
        annotations=doc_annotation(
            "ExtraAttribute represents a set of key-value pairs for an identity"
        ),
        attributes={
            "key": Attribute(type=STRING_TYPE, required=True),
            "values": Attribute(
                type=SET_TYPE,
                required=True,
                element=AttributeElement(type=STRING_TYPE),
            ),
        },
    )


def extra_entity() -> Entity:
    return Entity(
        annotations=doc_annotation(
            "Extra represents a set of key-value pairs for an identity"
        ),
        shape=EntityShape(
            attributes={
                "key": Attribute(type=STRING_TYPE, required=True),
                # the SAR resource name carrying the value is optional, so
                # value cannot be required (reference user_entities.go:111-114)
                "value": Attribute(type=STRING_TYPE, required=False),
            }
        ),
    )


def principal_uid_entity() -> Entity:
    return Entity(
        annotations=doc_annotation(
            "PrincipalUID represents an impersonatable identifier for a principal"
        ),
        shape=EntityShape(attributes={}),
    )


def non_resource_url_entity() -> Entity:
    return Entity(
        annotations=doc_annotation(
            "NonResourceURL represents a URL that is not associated with a "
            "Kubernetes resource"
        ),
        shape=EntityShape(
            attributes={"path": Attribute(type=STRING_TYPE, required=True)}
        ),
    )


def field_requirement_shape() -> EntityShape:
    return EntityShape(
        annotations=doc_annotation(
            "FieldRequirement represents a requirement on a field"
        ),
        attributes={
            "field": Attribute(type=STRING_TYPE, required=True),
            "operator": Attribute(type=STRING_TYPE, required=True),
            "value": Attribute(type=STRING_TYPE, required=True),
        },
    )


def label_requirement_shape() -> EntityShape:
    return EntityShape(
        annotations=doc_annotation(
            "LabelRequirement represents a requirement on a label"
        ),
        attributes={
            "key": Attribute(type=STRING_TYPE, required=True),
            "operator": Attribute(type=STRING_TYPE, required=True),
            "values": Attribute(
                type=SET_TYPE,
                required=True,
                element=AttributeElement(type=STRING_TYPE),
            ),
        },
    )


def resource_entity() -> Entity:
    return Entity(
        annotations=doc_annotation(
            "Resource represents an authorizable Kubernetes resource"
        ),
        shape=EntityShape(
            attributes={
                "apiGroup": Attribute(type=STRING_TYPE, required=True),
                "resource": Attribute(type=STRING_TYPE, required=True),
                "namespace": Attribute(type=STRING_TYPE),
                "name": Attribute(type=STRING_TYPE),
                "subresource": Attribute(type=STRING_TYPE),
                "fieldSelector": Attribute(
                    type=SET_TYPE,
                    element=AttributeElement(type=FIELD_REQUIREMENT_NAME),
                ),
                "labelSelector": Attribute(
                    type=SET_TYPE,
                    element=AttributeElement(type=LABEL_REQUIREMENT_NAME),
                ),
            }
        ),
    )


def authorization_principal_types(namespace: str = "") -> List[str]:
    principals = [
        USER_PRINCIPAL_TYPE,
        GROUP_PRINCIPAL_TYPE,
        SERVICE_ACCOUNT_PRINCIPAL_TYPE,
        NODE_PRINCIPAL_TYPE,
    ]
    if not namespace:
        return principals
    return [f"{namespace}::{p}" for p in principals]


admission_principal_types = authorization_principal_types


def get_authorization_actions(
    principal_ns: str, entity_ns: str, action_ns: str
) -> dict:
    """The 19 authorization actions with their appliesTo splits (reference
    GetAuthorizationActions, authorization.go:156-232)."""
    principal_prefix = f"{principal_ns}::" if principal_ns != action_ns else ""
    entity_prefix = f"{entity_ns}::" if entity_ns != action_ns else ""
    principal_ns_eff = "" if principal_ns == action_ns else principal_ns

    actions = {}
    for action in AUTHORIZATION_ACTION_NAMES:
        if action == "impersonate":
            continue
        if action in NON_RESOURCE_ONLY_ACTIONS:
            resource_types = [entity_prefix + NON_RESOURCE_URL_ENTITY_NAME]
        elif action in RESOURCE_ONLY_ACTIONS:
            resource_types = [entity_prefix + RESOURCE_ENTITY_NAME]
        else:
            resource_types = [
                entity_prefix + RESOURCE_ENTITY_NAME,
                entity_prefix + NON_RESOURCE_URL_ENTITY_NAME,
            ]
        actions[action] = ActionShape(
            applies_to=ActionAppliesTo(
                principal_types=authorization_principal_types(principal_ns_eff),
                resource_types=resource_types,
            )
        )
    actions["impersonate"] = ActionShape(
        applies_to=ActionAppliesTo(
            principal_types=authorization_principal_types(principal_ns_eff),
            resource_types=[
                principal_prefix + PRINCIPAL_UID_ENTITY_NAME,
                principal_prefix + USER_PRINCIPAL_TYPE,
                principal_prefix + GROUP_PRINCIPAL_TYPE,
                principal_prefix + SERVICE_ACCOUNT_PRINCIPAL_TYPE,
                principal_prefix + NODE_PRINCIPAL_TYPE,
                principal_prefix + EXTRA_VALUE_TYPE,
            ],
        )
    )
    return actions


def get_authorization_namespace(
    principal_ns: str = "k8s", entity_ns: str = "k8s", action_ns: str = "k8s"
) -> Namespace:
    """The complete hand-coded k8s authorization namespace (reference
    GetAuthorizationNamespace, authorization.go:240-259)."""
    return Namespace(
        actions=get_authorization_actions(principal_ns, entity_ns, action_ns),
        entity_types={
            PRINCIPAL_UID_ENTITY_NAME: principal_uid_entity(),
            USER_PRINCIPAL_TYPE: user_entity(),
            GROUP_PRINCIPAL_TYPE: group_entity(),
            SERVICE_ACCOUNT_PRINCIPAL_TYPE: service_account_entity(),
            NODE_PRINCIPAL_TYPE: node_entity(),
            NON_RESOURCE_URL_ENTITY_NAME: non_resource_url_entity(),
            RESOURCE_ENTITY_NAME: resource_entity(),
            EXTRA_VALUE_TYPE: extra_entity(),
        },
        common_types={
            FIELD_REQUIREMENT_NAME: field_requirement_shape(),
            LABEL_REQUIREMENT_NAME: label_requirement_shape(),
            EXTRA_VALUES_ATTRIBUTE_TYPE: extra_entity_shape(),
        },
    )


def add_principals_to_schema(schema: CedarSchema, namespace: str) -> None:
    ns = schema.namespace(namespace)
    ns.entity_types[USER_PRINCIPAL_TYPE] = user_entity()
    ns.entity_types[GROUP_PRINCIPAL_TYPE] = group_entity()
    ns.entity_types[SERVICE_ACCOUNT_PRINCIPAL_TYPE] = service_account_entity()
    ns.entity_types[NODE_PRINCIPAL_TYPE] = node_entity()
    ns.entity_types[EXTRA_VALUE_TYPE] = extra_entity()
    ns.common_types[EXTRA_VALUES_ATTRIBUTE_TYPE] = extra_entity_shape()


def all_admission_actions() -> List[str]:
    return [
        ADMISSION_CREATE_ACTION,
        ADMISSION_UPDATE_ACTION,
        ADMISSION_DELETE_ACTION,
        ADMISSION_CONNECT_ACTION,
        ALL_ACTION,
    ]


def add_admission_actions(
    schema: CedarSchema, action_namespace: str, principal_namespace: str
) -> None:
    """create/update/delete/connect admission actions, members of ``all``
    (reference AddAdmissionActions, admission_actions.go:23-49)."""
    if action_namespace == principal_namespace:
        principal_namespace = ""
    principal_types = admission_principal_types(principal_namespace)
    ns = schema.namespace(action_namespace)
    for action in all_admission_actions():
        if action in ns.actions:
            continue
        shape = ActionShape(
            applies_to=ActionAppliesTo(
                principal_types=list(principal_types), resource_types=[]
            )
        )
        if action != ALL_ACTION:
            shape.member_of = [ActionMember(id=ALL_ACTION)]
        ns.actions[action] = shape


def add_resource_type_to_action(
    schema: CedarSchema, action_namespace: str, action: str, resource_type: str
) -> None:
    ns = schema.namespaces.get(action_namespace)
    if ns is None:
        return
    shape = ns.actions.get(action)
    if shape is None:
        return
    shape.applies_to.resource_types.append(resource_type)


def _proxy_option_shape() -> EntityShape:
    return EntityShape(
        attributes={
            "kind": Attribute(type=STRING_TYPE, required=True),
            "apiVersion": Attribute(type=STRING_TYPE, required=True),
            "path": Attribute(type=STRING_TYPE, required=True),
        }
    )


def _pod_exec_attach_shape() -> EntityShape:
    return EntityShape(
        attributes={
            "kind": Attribute(type=STRING_TYPE, required=True),
            "apiVersion": Attribute(type=STRING_TYPE, required=True),
            "stdin": Attribute(type=BOOL_TYPE, required=True),
            "stdout": Attribute(type=BOOL_TYPE, required=True),
            "stderr": Attribute(type=BOOL_TYPE, required=True),
            "tty": Attribute(type=BOOL_TYPE, required=True),
            "container": Attribute(type=STRING_TYPE, required=True),
            "command": Attribute(
                type=SET_TYPE,
                required=True,
                element=AttributeElement(type=STRING_TYPE),
            ),
        }
    )


def add_connect_entities(
    schema: CedarSchema,
    action_namespace: str = "k8s::admission",
    principal_namespace: str = "k8s",
) -> None:
    """CONNECT option entities + the connect admission action wiring
    (reference AddConnectEntities, connect_entities.go:87-129). A deliberate
    divergence: the reference hardcodes the ``k8s::admission``
    namespace and silently drops the wiring when it doesn't pre-exist; here
    the action namespace is a parameter so custom namespaces keep their
    connect action."""
    core = schema.namespace("core::v1")
    core.entity_types["NodeProxyOptions"] = Entity(
        annotations=doc_annotation(
            "NodeProxyOptions represents options for proxying to a Kubernetes node"
        ),
        shape=_proxy_option_shape(),
    )
    core.entity_types["PodProxyOptions"] = Entity(
        annotations=doc_annotation(
            "PodProxyOptions represents options for proxying to a Kubernetes pod"
        ),
        shape=_proxy_option_shape(),
    )
    core.entity_types["ServiceProxyOptions"] = Entity(
        annotations=doc_annotation(
            "ServiceProxyOptions represents options for proxying to a "
            "Kubernetes service"
        ),
        shape=_proxy_option_shape(),
    )
    core.entity_types["PodPortForwardOptions"] = Entity(
        annotations=doc_annotation(
            "PodPortForwardOptions represents options for port forwarding to "
            "a Kubernetes pod"
        ),
        shape=EntityShape(
            attributes={
                "kind": Attribute(type=STRING_TYPE, required=True),
                "apiVersion": Attribute(type=STRING_TYPE, required=True),
                "ports": Attribute(
                    type=SET_TYPE,
                    required=False,
                    element=AttributeElement(type=STRING_TYPE),
                ),
            }
        ),
    )
    core.entity_types["PodExecOptions"] = Entity(
        annotations=doc_annotation(
            "PodExecOptions represents options for executing a command in a "
            "Kubernetes pod"
        ),
        shape=_pod_exec_attach_shape(),
    )
    core.entity_types["PodAttachOptions"] = Entity(
        annotations=doc_annotation(
            "PodAttachOptions represents options for attaching to a Kubernetes pod"
        ),
        shape=_pod_exec_attach_shape(),
    )

    admission = schema.namespace(action_namespace)
    admission.actions[ADMISSION_CONNECT_ACTION] = ActionShape(
        applies_to=ActionAppliesTo(
            principal_types=admission_principal_types(principal_namespace),
            resource_types=[
                "core::v1::NodeProxyOptions",
                "core::v1::PodAttachOptions",
                "core::v1::PodExecOptions",
                "core::v1::PodPortForwardOptions",
                "core::v1::PodProxyOptions",
                "core::v1::ServiceProxyOptions",
            ],
        ),
        member_of=[ActionMember(id=ALL_ACTION)],
    )


def modify_object_meta_maps(schema: CedarSchema) -> None:
    """Inject meta::v1 KeyValue / KeyValueStringSlice common types (reference
    ModifyObjectMetaMaps, admission.go:4-28)."""
    ns = schema.namespaces.get("meta::v1")
    if ns is None:
        return
    ns.common_types["KeyValue"] = EntityShape(
        attributes={
            "key": Attribute(type=STRING_TYPE, required=True),
            "value": Attribute(type=STRING_TYPE, required=True),
        }
    )
    ns.common_types["KeyValueStringSlice"] = EntityShape(
        attributes={
            "key": Attribute(type=STRING_TYPE, required=True),
            "value": Attribute(
                type=SET_TYPE,
                required=True,
                element=AttributeElement(type=STRING_TYPE),
            ),
        }
    )
