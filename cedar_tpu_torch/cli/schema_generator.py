"""Cedar schema generator CLI.

Behavior parity with reference cmd/schema-generator/main.go: builds the
hand-coded k8s authorization namespace, optionally adds admission actions +
per-API-group OpenAPI conversion + CONNECT entities + meta::v1 KeyValue
types, sorts action entity lists, and emits JSON (or, natively here,
``.cedarschema`` text — the reference needs the Rust ``cedar
translate-schema`` CLI for that step).

Instead of fetching ``/openapi/v3`` from a live apiserver, API documents are
read from a directory of recorded fixtures shaped like the reference's
internal/schema/convert/testdata: ``<name>.schema.json`` (the OpenAPI v3
document) paired with ``<name>.resourcelist.json`` (the APIResourceList),
where ``<name>`` encodes the API path (``apis.apps.v1``, ``api.v1``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from ..schema import k8s
from ..schema.convert.openapi import modify_schema_for_api_version
from ..schema.format import format_schema
from ..schema.model import CedarSchema


def api_path_to_group_version(name: str):
    """``apis.apps.v1`` → ("apps", "v1"); ``api.v1`` → ("core", "v1");
    ``apis.authentication.k8s.io.v1`` → ("authentication.k8s.io", "v1")."""
    parts = name.split(".")
    if parts[0] == "api" and len(parts) == 2:
        return "core", parts[1]
    if parts[0] == "apis" and len(parts) >= 3:
        return ".".join(parts[1:-1]), parts[-1]
    raise ValueError(f"cannot parse API path from fixture name {name!r}")


def fetch_openapi_documents(client):
    """Live-cluster fetch mirroring the reference's K8sSchemaGetter
    (the upstream project's internal/schema/convert/openapi.go:48-88 +
    cmd/schema-generator/main.go:80-137): GET /openapi/v3, keep versioned
    API paths (ending /vN[alphaN|betaN]), sort alphabetically, special-case
    api/v1 -> core/v1, skip apiextensions.k8s.io, and fetch each path's
    OpenAPI document + APIResourceList. Returns [(group, version, openapi,
    resourcelist)]; per-API failures log and skip like the reference."""
    import re

    doc = client.get_json("/openapi/v3")
    matcher = re.compile(r"/v\d+(?:alpha\d+|beta\d+)?$")
    paths = sorted(k for k in doc.get("paths", {}) if matcher.search(k))
    out = []
    for p in paths:
        if p == "api/v1":
            group, version = "core", "v1"
        else:
            parts = p.split("/")
            if len(parts) < 3:
                continue
            group, version = parts[1], parts[2]
        if group == "apiextensions.k8s.io":
            continue
        rel = doc["paths"][p].get("serverRelativeURL") or f"/openapi/v3/{p}"
        try:
            openapi = client.get_json(rel)
        except Exception as e:  # noqa: BLE001 — per-API skip, like the ref
            print(
                f"Failed to get schema for API {p}: {e}; skipping",
                file=sys.stderr,
            )
            continue
        try:
            resources = client.get_json(f"/{p}")
        except Exception as e:  # noqa: BLE001
            print(
                f"Failed to get APIResourceList for API {p}: {e}; skipping",
                file=sys.stderr,
            )
            continue
        out.append((group, version, openapi, resources))
    return out


def generate_schema(
    authorization_ns: str = "k8s",
    action_ns: str = "k8s::admission",
    admission: bool = True,
    openapi_dir: Optional[str] = None,
    source_schema: Optional[dict] = None,
    api_docs=None,
) -> CedarSchema:
    schema = CedarSchema()
    if source_schema:
        # seed from a previously generated schema JSON (merge-in workflow)
        schema = CedarSchema.from_json(source_schema)

    schema.namespaces[authorization_ns] = k8s.get_authorization_namespace(
        authorization_ns, authorization_ns, authorization_ns
    )

    if admission:
        if action_ns == authorization_ns:
            raise ValueError(
                "Admission and authorization namespaces cannot be the same"
            )
        k8s.add_admission_actions(schema, action_ns, authorization_ns)

        if openapi_dir:
            # ":"-separated list of fixture directories. First writer wins
            # per namespace type, and EARLIER directories process first —
            # list the richest recordings first; later directories only
            # extend the namespace set
            specs = []
            for d in str(openapi_dir).split(":"):
                if d:
                    specs.extend(
                        sorted(
                            pathlib.Path(d).glob("*.schema.json"),
                            key=lambda p: p.name,
                        )
                    )
            for spec_path in specs:
                name = spec_path.name[: -len(".schema.json")]
                group, version = api_path_to_group_version(name)
                if group == "apiextensions.k8s.io":
                    continue
                rl_path = spec_path.with_name(f"{name}.resourcelist.json")
                if not rl_path.exists():
                    print(
                        f"missing {rl_path.name}; skipping {name}",
                        file=sys.stderr,
                    )
                    continue
                openapi = json.loads(spec_path.read_text())
                resources = json.loads(rl_path.read_text())
                modify_schema_for_api_version(
                    resources, openapi, schema, group, version, action_ns
                )
        for group, version, openapi, resources in api_docs or ():
            # live-cluster documents (fetch_openapi_documents); per-API
            # conversion failures skip like the reference
            try:
                modify_schema_for_api_version(
                    resources, openapi, schema, group, version, action_ns
                )
            except Exception as e:  # noqa: BLE001
                print(
                    f"Failed to convert schema for {group}/{version}: {e}; "
                    "skipping",
                    file=sys.stderr,
                )
        k8s.add_connect_entities(schema, action_ns, authorization_ns)

    schema.sort_action_entities()
    k8s.modify_object_meta_maps(schema)
    return schema


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="schema-generator", description="Generate the k8s Cedar schema"
    )
    parser.add_argument(
        "--authorization-namespace",
        default="k8s",
        help="Namespace for authorization entities and actions",
    )
    parser.add_argument(
        "--admission-action-namespace",
        default="k8s::admission",
        help="Namespace for admission entities",
    )
    parser.add_argument(
        "--admission",
        default=True,
        action=argparse.BooleanOptionalAction,
        help="Add admission entities",
    )
    parser.add_argument(
        "--openapi-dir",
        default="",
        help="Directory of recorded <api>.schema.json/<api>.resourcelist.json "
        "OpenAPI fixtures (offline replacement for the live /openapi/v3)",
    )
    parser.add_argument(
        "--source-schema",
        default="",
        help="Seed from a previously generated schema JSON before adding "
        "namespaces (merge-in workflow)",
    )
    parser.add_argument(
        "--kubeconfig",
        default="",
        help="Fetch /openapi/v3 + APIResourceLists from a live cluster via "
        "this kubeconfig (the reference's primary mode) in addition to any "
        "--openapi-dir fixtures",
    )
    parser.add_argument("--output", default="", help="File to write schema to")
    parser.add_argument(
        "--format",
        default="json",
        choices=["json", "cedarschema"],
        help="Output format (cedarschema text needs no external translator)",
    )
    args = parser.parse_args(argv)

    api_docs = None
    if args.kubeconfig and args.admission:
        # --no-admission never consumes API documents (the admission branch
        # owns the OpenAPI conversion) — skip the cluster crawl entirely
        from ..stores.kubeclient import KubeConfigClient

        api_docs = fetch_openapi_documents(KubeConfigClient(args.kubeconfig))
    try:
        schema = generate_schema(
            authorization_ns=args.authorization_namespace,
            action_ns=args.admission_action_namespace,
            admission=args.admission,
            openapi_dir=args.openapi_dir or None,
            source_schema=(
                json.loads(pathlib.Path(args.source_schema).read_text())
                if args.source_schema
                else None
            ),
            api_docs=api_docs,
        )
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1

    if args.format == "cedarschema":
        data = format_schema(schema)
    else:
        data = json.dumps(schema.to_json(), indent="\t", sort_keys=True)
    if args.output:
        pathlib.Path(args.output).write_text(data)
    else:
        print(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
