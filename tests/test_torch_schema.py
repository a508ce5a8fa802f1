"""The port's schema tooling (schema/model.py, format.py, k8s.py,
convert/names.py, convert/openapi.py, cli/schema_generator.py,
cli/schema_formatter.py) against the JAX package's, at tolerance 0: the same
inputs through both, outputs equal byte for byte (schema JSON text, the
cedarschema rendering, the CLIs' stdout, stderr and exit codes).

Inputs are the repo's own: the recorded OpenAPI fixtures under
tests/testdata/openapi/ and the generated artifacts under cedarschema/.
"""

import json
import pathlib
import shutil

import pytest
from test_live_cluster_cli import _kubeconfig, _start_stub, _StubHandler

from cedar_tpu.cli import schema_formatter as j_fmt_cli
from cedar_tpu.cli import schema_generator as j_gen
from cedar_tpu.schema import k8s as j_k8s
from cedar_tpu.schema.convert import names as j_names
from cedar_tpu.schema.convert import openapi as j_openapi
from cedar_tpu.schema.format import format_schema as j_format_schema
from cedar_tpu.schema.model import CedarSchema as JSchema
from cedar_tpu_torch.cli import schema_formatter as t_fmt_cli
from cedar_tpu_torch.cli import schema_generator as t_gen
from cedar_tpu_torch.schema import k8s as t_k8s
from cedar_tpu_torch.schema.convert import names as t_names
from cedar_tpu_torch.schema.convert import openapi as t_openapi
from cedar_tpu_torch.schema.format import format_schema as t_format_schema
from cedar_tpu_torch.schema.model import CedarSchema as TSchema

REPO = pathlib.Path(__file__).resolve().parent.parent
OPENAPI = REPO / "tests" / "testdata" / "openapi"
API_NAMES = sorted(p.name[: -len(".schema.json")] for p in OPENAPI.glob("*.schema.json"))
SCHEMA_JSON = sorted((REPO / "cedarschema").glob("*.cedarschema.json"))
SCHEMA_TEXT = sorted((REPO / "cedarschema").glob("*.cedarschema"))


def _dump(schema) -> str:
    """The generator CLI's JSON rendering."""
    return json.dumps(schema.to_json(), indent="\t", sort_keys=True)


def _run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(capsys, j_main, t_main, argv):
    """Both CLIs' (exit code, stdout, stderr) on the same argv."""
    j = _run(capsys, j_main, list(argv))
    t = _run(capsys, t_main, list(argv))
    return j, t


# ---- model: JSON round trip and rendering of the repo's artifacts


@pytest.mark.parametrize("path", SCHEMA_JSON, ids=lambda p: p.name)
def test_schema_json_roundtrip_equals_jax(path):
    doc = json.loads(path.read_text())
    j, t = JSchema.from_json(doc), TSchema.from_json(doc)
    assert _dump(t) == _dump(j)
    assert t.to_json() == doc


@pytest.mark.parametrize("path", SCHEMA_JSON, ids=lambda p: p.name)
def test_format_schema_of_artifact_equals_jax(path):
    doc = json.loads(path.read_text())
    assert t_format_schema(TSchema.from_json(doc)) == j_format_schema(JSchema.from_json(doc))


@pytest.mark.parametrize("path", SCHEMA_JSON, ids=lambda p: p.name)
def test_schema_lookups_equal_jax(path):
    doc = json.loads(path.read_text())
    j, t = JSchema.from_json(doc), TSchema.from_json(doc)
    for ns_name, ns in sorted(j.namespaces.items()):
        for ent in sorted(ns.entity_types):
            full = f"{ns_name}::{ent}" if ns_name else ent
            js, ts = j.get_entity_shape(full), t.get_entity_shape(full)
            assert (ts is None) == (js is None), full
            if js is not None:
                assert ts.to_json() == js.to_json(), full
    j.sort_action_entities()
    t.sort_action_entities()
    assert _dump(t) == _dump(j)


# ---- k8s.py: the hand-written namespaces


@pytest.mark.parametrize("ns", ["k8s", "acme", ""])
def test_authorization_namespace_equals_jax(ns):
    j = j_k8s.get_authorization_namespace(ns, ns, ns)
    t = t_k8s.get_authorization_namespace(ns, ns, ns)
    assert json.dumps(t.to_json(), sort_keys=True) == json.dumps(j.to_json(), sort_keys=True)
    assert t_k8s.authorization_principal_types(ns) == j_k8s.authorization_principal_types(ns)


@pytest.mark.parametrize("action_ns,principal_ns", [("k8s::admission", "k8s"),
                                                    ("acme::admission", "acme")])
def test_admission_and_connect_wiring_equals_jax(action_ns, principal_ns):
    out = []
    for k8s, Schema in ((j_k8s, JSchema), (t_k8s, TSchema)):
        s = Schema()
        s.namespaces[principal_ns] = k8s.get_authorization_namespace(
            principal_ns, principal_ns, principal_ns)
        k8s.add_admission_actions(s, action_ns, principal_ns)
        k8s.add_connect_entities(s, action_ns, principal_ns)
        s.sort_action_entities()
        k8s.modify_object_meta_maps(s)
        out.append(_dump(s))
    assert out[1] == out[0]
    assert t_k8s.all_admission_actions() == j_k8s.all_admission_actions()


# ---- generate_schema over the recorded OpenAPI fixtures


@pytest.mark.parametrize("admission", [True, False], ids=["admission", "no-admission"])
def test_generate_schema_over_fixtures_equals_jax(admission):
    kw = dict(admission=admission, openapi_dir=str(OPENAPI))
    j, t = j_gen.generate_schema(**kw), t_gen.generate_schema(**kw)
    assert _dump(t) == _dump(j)
    assert t_format_schema(t) == j_format_schema(j)


@pytest.mark.parametrize("api", API_NAMES)
def test_generate_schema_per_api_equals_jax(api, tmp_path):
    """One recorded API at a time: each group/version's conversion on its
    own, so a divergence names its fixture."""
    for suffix in ("schema.json", "resourcelist.json"):
        shutil.copy(OPENAPI / f"{api}.{suffix}", tmp_path / f"{api}.{suffix}")
    kw = dict(openapi_dir=str(tmp_path))
    j, t = j_gen.generate_schema(**kw), t_gen.generate_schema(**kw)
    assert _dump(t) == _dump(j)
    assert t_format_schema(t) == j_format_schema(j)
    group, version = t_gen.api_path_to_group_version(api)
    assert (group, version) == j_gen.api_path_to_group_version(api)


def test_generate_schema_custom_namespaces_equal_jax():
    kw = dict(authorization_ns="acme", action_ns="acme::admission",
              openapi_dir=str(OPENAPI))
    j, t = j_gen.generate_schema(**kw), t_gen.generate_schema(**kw)
    assert _dump(t) == _dump(j)


def test_generate_schema_same_namespaces_raise_like_jax():
    msgs = []
    for gen in (j_gen, t_gen):
        with pytest.raises(ValueError) as e:
            gen.generate_schema(authorization_ns="k8s", action_ns="k8s")
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("path", SCHEMA_JSON, ids=lambda p: p.name)
def test_generate_schema_seeded_equals_jax(path):
    seed = json.loads(path.read_text())
    kw = dict(admission=False, source_schema=seed)
    assert _dump(t_gen.generate_schema(**kw)) == _dump(j_gen.generate_schema(**kw))


# ---- names.py and openapi.py over every definition in the fixtures


def _refs(node):
    if isinstance(node, dict):
        for k, v in node.items():
            if k == "$ref" and isinstance(v, str):
                yield v
            else:
                yield from _refs(v)
    elif isinstance(node, list):
        for v in node:
            yield from _refs(v)


@pytest.mark.parametrize("api", API_NAMES)
def test_names_of_every_definition_equal_jax(api):
    doc = json.loads((OPENAPI / f"{api}.schema.json").read_text())
    comps = doc.get("components", {}).get("schemas", {})
    assert comps
    for name, defn in comps.items():
        for fn in ("parse_schema_name", "schema_name_to_cedar", "strip_ref_prefix"):
            assert getattr(t_names, fn)(name) == getattr(j_names, fn)(name), (fn, name)
        current = "#/components/schemas/" + name
        for ref in _refs(defn):
            assert (t_names.ref_to_relative_type_name(current, ref)
                    == j_names.ref_to_relative_type_name(current, ref)), (name, ref)
        desc = defn.get("description", "")
        assert t_names.escape_docstrings(desc) == j_names.escape_docstrings(desc)


@pytest.mark.parametrize("api", API_NAMES)
def test_entity_shapes_of_every_definition_equal_jax(api):
    doc = json.loads((OPENAPI / f"{api}.schema.json").read_text())
    rl = json.loads((OPENAPI / f"{api}.resourcelist.json").read_text())
    for name in doc.get("components", {}).get("schemas", {}):
        j = j_openapi.ref_to_entity_shape(doc, name)
        t = t_openapi.ref_to_entity_shape(doc, name)
        assert json.dumps(t.to_json(), sort_keys=True) == json.dumps(j.to_json(), sort_keys=True)
        assert t_openapi.is_entity(t) == j_openapi.is_entity(j)
        assert t_openapi.is_list_entity(t) == j_openapi.is_list_entity(j)
        kind = name.rsplit(".", 1)[-1]
        assert t_openapi.verbs_for_kind(kind, rl) == j_openapi.verbs_for_kind(kind, rl)


# ---- the generator CLI


GEN_ARGVS = {
    "json": ["--openapi-dir", str(OPENAPI)],
    "cedarschema": ["--openapi-dir", str(OPENAPI), "--format", "cedarschema"],
    "no-admission-json": ["--no-admission"],
    "no-admission-cedarschema": ["--no-admission", "--format", "cedarschema"],
    "custom-ns": ["--authorization-namespace", "acme", "--admission-action-namespace",
                  "acme::admission", "--openapi-dir", str(OPENAPI)],
    "same-ns": ["--authorization-namespace", "k8s", "--admission-action-namespace", "k8s"],
    "seeded": ["--source-schema", str(REPO / "cedarschema" / "k8s-full.cedarschema.json"),
               "--no-admission"],
    "missing-resourcelist": ["--openapi-dir", "{partial}"],
}


@pytest.mark.parametrize("case", sorted(GEN_ARGVS))
def test_generator_cli_equals_jax(case, capsys, tmp_path):
    partial = tmp_path / "partial"
    partial.mkdir()
    shutil.copy(OPENAPI / "apis.batch.v1.schema.json", partial)
    argv = [a.replace("{partial}", str(partial)) for a in GEN_ARGVS[case]]
    j, t = _both(capsys, j_gen.main, t_gen.main, argv)
    assert t == j
    assert t[0] == (1 if case == "same-ns" else 0)


def test_generator_cli_output_file_equals_jax(capsys, tmp_path):
    outs = []
    for name, main in (("j", j_gen.main), ("t", t_gen.main)):
        out = tmp_path / f"{name}.cedarschema"
        rc = main(["--openapi-dir", str(OPENAPI), "--format", "cedarschema",
                   "--output", str(out)])
        assert rc == 0
        outs.append(out.read_bytes())
    assert capsys.readouterr().out == ""
    assert outs[1] == outs[0]


# ---- the schema formatter CLI


@pytest.mark.parametrize("path", SCHEMA_TEXT, ids=lambda p: p.name)
def test_schema_formatter_cli_equals_jax(path, capsys):
    j, t = _both(capsys, j_fmt_cli.main, t_fmt_cli.main, [str(path)])
    assert t == j
    assert t[0] == 0 and t[1]


@pytest.mark.parametrize("path", SCHEMA_JSON, ids=lambda p: p.name)
def test_schema_formatter_of_rendered_text_equals_jax(path, tmp_path, capsys):
    """The formatter over the renderer's own output (a packed layout)."""
    doc = json.loads(path.read_text())
    packed = t_format_schema(TSchema.from_json(doc)).replace("\n", " ")
    src = tmp_path / "packed.cedarschema"
    src.write_text(packed)
    j, t = _both(capsys, j_fmt_cli.main, t_fmt_cli.main, [str(src)])
    assert t == j
    assert t_fmt_cli.format_schema_text(packed) == j_fmt_cli.format_schema_text(packed)


def test_schema_formatter_usage_equals_jax(capsys):
    j, t = _both(capsys, j_fmt_cli.main, t_fmt_cli.main, [])
    assert t == j == (1, "", "usage: schema-formatter <file.cedarschema>\n")


# ---- live mode: --kubeconfig against a stub apiserver on port 0


@pytest.fixture
def stub_apiserver():
    """The JAX live-mode tests' stub apiserver on port 0 -> start(routes)
    returning its port."""
    srvs = []

    def start(routes):
        srvs.append(_start_stub(routes))
        return srvs[-1].server_address[1]

    yield start
    for srv in srvs:
        srv.shutdown()
        srv.server_close()


LIVE_APIS = ["apis.batch.v1", "apis.networking.k8s.io.v1", "apis.policy.v1"]


@pytest.mark.parametrize("fmt", ["json", "cedarschema"])
def test_generator_live_mode_equals_jax(fmt, stub_apiserver, tmp_path, capsys):
    paths, routes = {}, {}
    for api in LIVE_APIS:
        group, version = t_gen.api_path_to_group_version(api)
        p = f"apis/{group}/{version}"
        paths[p] = {"serverRelativeURL": f"/openapi/v3/{p}?hash=abc"}
        routes[f"/openapi/v3/{p}"] = json.loads((OPENAPI / f"{api}.schema.json").read_text())
        routes[f"/{p}"] = json.loads((OPENAPI / f"{api}.resourcelist.json").read_text())
    paths["apis/apiextensions.k8s.io/v1"] = {}
    paths["apis/foo"] = {}
    paths["apis/missing.example.com/v1"] = {}  # 404: logged and skipped
    routes["/openapi/v3"] = {"paths": paths}
    port = stub_apiserver(routes)
    argv = ["--kubeconfig", _kubeconfig(tmp_path, port), "--format", fmt]
    j, t = _both(capsys, j_gen.main, t_gen.main, argv)
    assert t == j
    assert t[0] == 0 and "Failed to get schema for API apis/missing.example.com/v1" in t[2]
    assert not any("apiextensions" in p for p in _StubHandler.seen_paths)
    assert "Bearer stub-token" in _StubHandler.seen_auth
