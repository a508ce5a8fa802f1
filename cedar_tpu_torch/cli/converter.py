"""RBAC→Cedar converter CLI.

Mirrors the behavior of the reference ``converter`` command
(the upstream project's cmd/converter/main.go): positional kind
(clusterrolebinding|rolebinding + aliases), optional comma-separated names,
``-output {cedar,json,crd}``, ``-namespace`` for single rolebinding lookup.
Instead of a live cluster, bindings and roles are read from multi-document
YAML files (``-f``, repeatable; or stdin), which is also how the reference's
golden corpus drives the converter in tests.

Output formats (main.go:96-120):
  * cedar — ``// <binding name>`` header + policies, bindings separated by a
    ``// ---...`` rule
  * json  — one Cedar JSON policy-set document per binding
  * crd   — a ``cedar.k8s.aws/v1alpha1 Policy`` YAML per binding
    (CRDForCedarPolicy, main.go:178-196: name colons become dots, strict
    enforced validation)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

import yaml

from ..lang.format import format_policy_set
from ..lang.json_format import policy_set_to_json
from ..rbac.convert import (
    Binding,
    Role,
    cluster_role_binding_to_cedar,
    role_binding_to_cedar,
)

BINDING_KINDS = {"ClusterRoleBinding", "RoleBinding"}
ROLE_KINDS = {"ClusterRole", "Role"}


def load_rbac_documents(
    streams: List[str],
) -> Tuple[List[Binding], Dict[Tuple[str, str, str], Role]]:
    """Parse multi-document YAML into bindings + a (kind, namespace, name) →
    Role index. ClusterRoles are indexed with an empty namespace."""
    bindings: List[Binding] = []
    roles: Dict[Tuple[str, str, str], Role] = {}
    for text in streams:
        for doc in yaml.safe_load_all(text):
            if not doc:
                continue
            kind = doc.get("kind", "")
            if kind in BINDING_KINDS:
                bindings.append(Binding.from_dict(doc, kind=kind))
            elif kind in ROLE_KINDS:
                role = Role.from_dict(doc, kind=kind)
                ns = role.namespace if kind == "Role" else ""
                roles[(kind, ns, role.name)] = role
    return bindings, roles


RBAC_BASE = "/apis/rbac.authorization.k8s.io/v1"


def fetch_rbac_documents(
    client, kind: str, names: List[str], namespace: str
) -> Tuple[List[Binding], Dict[Tuple[str, str, str], Role]]:
    """Live-cluster twin of load_rbac_documents: list/get bindings from the
    apiserver and Get each referenced role, mirroring the reference's
    converter (the upstream project's cmd/converter/main.go:56-146 — list when no
    names, per-name Get otherwise; a failed role Get skips that binding
    with a message, which convert_bindings() emits when the role is absent
    from the returned index)."""
    bindings: List[Binding] = []
    roles: Dict[Tuple[str, str, str], Role] = {}
    if kind == "clusterrolebinding":
        b_kind, list_path = (
            "ClusterRoleBinding", f"{RBAC_BASE}/clusterrolebindings"
        )
        get_path = lambda n: f"{RBAC_BASE}/clusterrolebindings/{n}"  # noqa: E731
    else:
        b_kind, list_path = "RoleBinding", f"{RBAC_BASE}/rolebindings"
        get_path = lambda n: (  # noqa: E731
            f"{RBAC_BASE}/namespaces/{namespace}/rolebindings/{n}"
        )
    if names:
        items = []
        for n in names:
            try:
                items.append(client.get_json(get_path(n)))
            except Exception as e:  # noqa: BLE001 — per-name skip, like the ref
                print(
                    f"Error getting {b_kind} {n}: {e}. Skipping this one",
                    file=sys.stderr,
                )
    else:
        items = client.get_json(list_path).get("items", [])
    kept: List[Binding] = []
    failed: set = set()
    for item in items:
        b = Binding.from_dict(item, kind=b_kind)
        ref = b.role_ref
        key = (ref.kind, b.namespace if ref.kind == "Role" else "", ref.name)
        if key not in roles and key not in failed:
            try:
                if ref.kind == "Role":
                    doc = client.get_json(
                        f"{RBAC_BASE}/namespaces/{b.namespace}/roles/{ref.name}"
                    )
                else:
                    doc = client.get_json(
                        f"{RBAC_BASE}/clusterroles/{ref.name}"
                    )
                roles[key] = Role.from_dict(doc, kind=ref.kind)
            except Exception as e:  # noqa: BLE001 — log the REAL error and
                # skip the binding, like the reference (main.go:80-96); a
                # 503/401 must not masquerade as "not found" downstream
                failed.add(key)
                print(
                    f"Error getting {ref.kind} {ref.name}: {e}. "
                    "Skipping this one",
                    file=sys.stderr,
                )
        if key in roles:
            kept.append(b)
    return kept, roles


def resolve_role(
    binding: Binding, roles: Dict[Tuple[str, str, str], Role]
) -> Optional[Role]:
    ref = binding.role_ref
    if ref.kind == "Role":
        return roles.get(("Role", binding.namespace, ref.name))
    return roles.get(("ClusterRole", "", ref.name))


def sorted_policies(policy_set):
    """cedar-go marshals policy sets ordered by policy ID; match that so
    output diffs cleanly against the reference's golden corpus."""
    return sorted(policy_set.policies(), key=lambda p: p.policy_id)


def crd_for_cedar_policy(name: str, policy_set) -> dict:
    return {
        "apiVersion": "cedar.k8s.aws/v1alpha1",
        "kind": "Policy",
        "metadata": {"name": name.replace(":", ".")},
        "spec": {
            "validation": {"enforced": True, "validationMode": "strict"},
            "content": format_policy_set(sorted_policies(policy_set)),
        },
    }


def convert_bindings(
    kind: str,
    bindings: List[Binding],
    roles: Dict[Tuple[str, str, str], Role],
    names: List[str],
    namespace: str,
):
    """Yield (binding, PolicySet) for each selected binding."""
    want_kind = "RoleBinding" if kind == "rolebinding" else "ClusterRoleBinding"
    for binding in bindings:
        if binding.kind != want_kind:
            continue
        if names and binding.name not in names:
            continue
        if names and want_kind == "RoleBinding" and binding.namespace != namespace:
            continue
        role = resolve_role(binding, roles)
        if role is None:
            print(
                f"Error getting {binding.role_ref.kind} {binding.role_ref.name}: "
                "not found. Skipping this one",
                file=sys.stderr,
            )
            continue
        if want_kind == "RoleBinding":
            yield binding, role_binding_to_cedar(binding, role)
        else:
            yield binding, cluster_role_binding_to_cedar(binding, role)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="converter", description="Convert RBAC bindings to Cedar policies"
    )
    parser.add_argument(
        "kind",
        help="clusterrolebinding|rolebinding (aliases: crb, rb, plurals)",
    )
    parser.add_argument(
        "names", nargs="?", default="", help="comma-separated binding names"
    )
    parser.add_argument(
        "-output",
        "--output",
        default="cedar",
        choices=["cedar", "json", "crd"],
        help="Output format. One of [cedar, crd, json]",
    )
    parser.add_argument(
        "-namespace",
        "--namespace",
        default="default",
        help="Namespace to query when getting a single rolebinding",
    )
    parser.add_argument(
        "-f",
        "--file",
        action="append",
        default=[],
        help="YAML file(s) with bindings and roles (default: stdin)",
    )
    parser.add_argument(
        "--kubeconfig",
        default="",
        help="Fetch bindings and roles from a live cluster via this "
        "kubeconfig (the reference converter's primary mode) instead of "
        "files/stdin",
    )
    args = parser.parse_args(argv)

    aliases = {
        "clusterrolebinding": "clusterrolebinding",
        "clusterrolebindings": "clusterrolebinding",
        "crb": "clusterrolebinding",
        "rolebinding": "rolebinding",
        "rolebindings": "rolebinding",
        "rb": "rolebinding",
    }
    kind = aliases.get(args.kind)
    if kind is None:
        print(
            "Invalid type to convert, must be one of "
            f"[clusterrolebinding, rolebinding] : {args.kind}",
            file=sys.stderr,
        )
        return 1

    names = [n for n in args.names.split(",") if n]
    if args.kubeconfig:
        from ..stores.kubeclient import KubeConfigClient

        client = KubeConfigClient(args.kubeconfig)
        bindings, roles = fetch_rbac_documents(
            client, kind, names, args.namespace
        )
        names = []  # already filtered server-side (per-name Gets)
    else:
        if args.file:
            streams = [open(f).read() for f in args.file]
        else:
            streams = [sys.stdin.read()]
        bindings, roles = load_rbac_documents(streams)

    results = list(convert_bindings(kind, bindings, roles, names, args.namespace))
    for i, (binding, ps) in enumerate(results):
        if args.output == "json":
            print(json.dumps(policy_set_to_json(sorted_policies(ps))))
        elif args.output == "cedar":
            if i > 0:
                print()
                print("// " + "-" * 80)
            print("// " + binding.name)
            print(format_policy_set(sorted_policies(ps)))
        elif args.output == "crd":
            print("# " + binding.name)
            print(yaml.safe_dump(crd_for_cedar_policy(binding.name, ps), sort_keys=False))
            if i != len(results) - 1:
                print("---")
    return 0


if __name__ == "__main__":
    sys.exit(main())
