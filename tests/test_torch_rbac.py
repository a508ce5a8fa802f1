"""The port's RBAC converter (rbac/convert.py, cli/converter.py) against the
JAX package's, at tolerance 0: every tests/testdata/rbac/*.yaml fixture
through both CLIs in each output format (cedar, json, crd), stdout, stderr
and exit code equal byte for byte; the --kubeconfig mode against a stub
apiserver bound to port 0; and the migration path end to end in the port
alone: convert, validate against the port's generated authorization
schema, serve on TorchPolicyEngine (CPU, the kernels' plain versions),
each decision equal to the JAX interpreter's over SubjectAccessReviews made
from each binding's subjects and rules.
"""

import json
import pathlib

import pytest
import yaml
from test_live_cluster_cli import _kubeconfig, _start_stub, _StubHandler

from cedar_tpu.cli import converter as j_conv
from cedar_tpu.lang.format import format_policy_set as j_format_set
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import http as j_http
from cedar_tpu.stores import store as j_store
from cedar_tpu_torch.cli import converter as t_conv
from cedar_tpu_torch.cli import schema_generator as t_gen
from cedar_tpu_torch.cli import validator as t_val
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.lang import PolicySet as TPolicySet
from cedar_tpu_torch.lang.format import format_policy_set as t_format_set
from cedar_tpu_torch.schema.model import CedarSchema as TSchema
from cedar_tpu_torch.server import authorizer as t_auth
from cedar_tpu_torch.server import sar as t_sar
from cedar_tpu_torch.stores import store as t_store

TESTDATA = pathlib.Path(__file__).resolve().parent / "testdata" / "rbac"
FIXTURES = sorted(TESTDATA.glob("*.yaml"))
KINDS = ["clusterrolebinding", "rolebinding"]
RBAC_BASE = "/apis/rbac.authorization.k8s.io/v1"


def _cli(capsys, main, argv):
    rc = main(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _both(capsys, argv):
    return _cli(capsys, j_conv.main, argv), _cli(capsys, t_conv.main, argv)


@pytest.mark.parametrize("output", ["cedar", "json", "crd"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_converter_cli_equals_jax(fixture, kind, output, capsys):
    j, t = _both(capsys, [kind, "-output", output, "-f", str(fixture)])
    assert t == j
    assert t[0] == 0


@pytest.mark.parametrize("output", ["cedar", "json", "crd"])
def test_converter_cli_all_fixtures_at_once_equals_jax(output, capsys):
    argv = ["crb", "--output", output]
    for f in FIXTURES:
        argv += ["-f", str(f)]
    j, t = _both(capsys, argv)
    assert t == j and t[1]


@pytest.mark.parametrize("argv", [
    ["rb", "app-readers", "--namespace", "web"],
    ["rolebindings", "app-readers"],  # another namespace: nothing selected
    ["crb", "no-such-binding"],
    ["bogus-kind"],
], ids=["named-rb", "rb-wrong-ns", "crb-unknown-name", "bad-kind"])
def test_converter_cli_selection_equals_jax(argv, capsys):
    argv = argv + ["-f", str(TESTDATA / "namespaced-role.yaml"),
                   "-f", str(TESTDATA / "cluster-admin.yaml")]
    j, t = _both(capsys, argv)
    assert t == j
    assert t[0] == (1 if argv[0] == "bogus-kind" else 0)


def test_converter_missing_role_equals_jax(capsys, tmp_path):
    docs = [d for d in yaml.safe_load_all((TESTDATA / "cluster-admin.yaml").read_text()) if d]
    only = tmp_path / "binding-only.yaml"
    only.write_text(yaml.safe_dump(next(d for d in docs if d["kind"] == "ClusterRoleBinding")))
    j, t = _both(capsys, ["crb", "-f", str(only)])
    assert t == j
    assert "not found. Skipping this one" in t[2]


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_converted_policy_sets_equal_jax_and_golden(fixture):
    """The library path: each binding's policy set, formatted, equals the
    JAX package's and, concatenated, the fixture's golden."""
    text = fixture.read_text()
    jb, jr = j_conv.load_rbac_documents([text])
    tb, tr = t_conv.load_rbac_documents([text])
    chunks = []
    for kind in KINDS:
        j = [(b.name, j_format_set(j_conv.sorted_policies(ps)))
             for b, ps in j_conv.convert_bindings(kind, jb, jr, [], "default")]
        t = [(b.name, t_format_set(t_conv.sorted_policies(ps)))
             for b, ps in t_conv.convert_bindings(kind, tb, tr, [], "default")]
        assert t == j
        chunks += [s for _, s in t]
    assert "\n".join(chunks) == fixture.with_suffix(".cedar").read_text()


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


def _routes(with_roles=True):
    """Every fixture's bindings listed, and its roles served for a Get."""
    crbs, rbs, routes = [], [], {}
    for f in FIXTURES:
        for d in yaml.safe_load_all(f.read_text()):
            if not d:
                continue
            meta = d.get("metadata", {})
            ns, name = meta.get("namespace", ""), meta.get("name", "")
            if d["kind"] == "ClusterRoleBinding":
                crbs.append(d)
                routes[f"{RBAC_BASE}/clusterrolebindings/{name}"] = d
            elif d["kind"] == "RoleBinding":
                rbs.append(d)
                routes[f"{RBAC_BASE}/namespaces/{ns}/rolebindings/{name}"] = d
            elif with_roles and d["kind"] == "ClusterRole":
                routes[f"{RBAC_BASE}/clusterroles/{name}"] = d
            elif with_roles and d["kind"] == "Role":
                routes[f"{RBAC_BASE}/namespaces/{ns}/roles/{name}"] = d
    routes[f"{RBAC_BASE}/clusterrolebindings"] = {"items": crbs}
    routes[f"{RBAC_BASE}/rolebindings"] = {"items": rbs}
    return routes


LIVE_ARGVS = {
    "list-crb-cedar": ["clusterrolebinding"],
    "list-crb-json": ["crb", "-output", "json"],
    "list-crb-crd": ["crb", "-output", "crd"],
    "list-rb-cedar": ["rolebinding"],
    "named-rb": ["rolebinding", "app-readers", "--namespace", "web"],
    "named-crb-one-missing": ["crb", "cluster-admin,no-such-binding"],
}


@pytest.mark.parametrize("case", sorted(LIVE_ARGVS))
def test_converter_live_mode_equals_jax(case, stub_apiserver, tmp_path, capsys):
    port = stub_apiserver(_routes())
    argv = LIVE_ARGVS[case] + ["--kubeconfig", _kubeconfig(tmp_path, port)]
    j, t = _both(capsys, argv)
    assert t == j
    assert t[0] == 0 and t[1]
    assert "Bearer stub-token" in _StubHandler.seen_auth


def test_converter_live_mode_missing_roles_equals_jax(stub_apiserver, tmp_path, capsys):
    port = stub_apiserver(_routes(with_roles=False))
    j, t = _both(capsys, ["crb", "--kubeconfig", _kubeconfig(tmp_path, port)])
    assert t == j
    assert t[1] == "" and "Skipping this one" in t[2]


# ---- the migration path: convert -> validate -> serve on the port


def _sar(user, groups, verb, group="", resource=None, sub="", ns="", name="", path=None):
    spec = {"user": user, "uid": "uid-1", "groups": list(groups)}
    if path is not None:
        spec["nonResourceAttributes"] = {"path": path, "verb": verb}
    else:
        spec["resourceAttributes"] = {
            "verb": verb, "group": group, "version": "v1", "resource": resource,
            "subresource": sub, "namespace": ns, "name": name,
        }
    return {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": spec}


def _identities(subject, binding_ns):
    if subject.kind == "User":
        return [(subject.name, ["system:authenticated"])]
    if subject.kind == "Group":
        return [("member-of-" + subject.name.replace(":", "-"), [subject.name])]
    ns = subject.namespace or binding_ns or "default"
    return [(f"system:serviceaccount:{ns}:{subject.name}",
             ["system:serviceaccounts", f"system:serviceaccounts:{ns}"])]


def _concrete(resource):
    """An RBAC resource entry -> (resource, subresource) a request names."""
    res, _, sub = resource.partition("/")
    res = "deployments" if res == "*" else res
    return res, ("proxy" if sub == "*" else sub)


def migration_sars(bindings, roles):
    """For each binding: each subject's identity over each rule's verbs,
    groups, resources and names (wildcards made concrete), the same request
    from a stranger, and a verb the rule does not grant."""
    out = []
    for b in bindings:
        role = t_conv.resolve_role(b, roles)
        if role is None:
            continue
        ns = b.namespace if b.kind == "RoleBinding" else "kube-system"
        idents = [i for s in b.subjects for i in _identities(s, b.namespace)]
        idents.append(("stranger", ["system:authenticated"]))
        for rule in role.rules:
            verbs = [v if v != "*" else "get" for v in rule.verbs] or ["get"]
            if "*" in rule.verbs:
                verbs.append("delete")
            verbs.append("escalate")
            for user, groups in idents:
                for verb in verbs:
                    for url in rule.non_resource_urls:
                        path = url.replace("*", "x/y")
                        out.append(_sar(user, groups, verb, path=path))
                    for res in rule.resources or ([] if rule.non_resource_urls else ["pods"]):
                        resource, sub = _concrete(res)
                        group = next((g for g in rule.api_groups if g != "*"), "apps")
                        for name in (rule.resource_names or [""])[:2]:
                            out.append(_sar(user, groups, verb, group, resource, sub, ns, name))
    return out


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_migration_path_serves_like_jax_interpreter(fixture, capsys, tmp_path):
    # 1. the port's converter CLI turns the fixture into Cedar text
    texts = []
    for kind in KINDS:
        rc, out, _ = _cli(capsys, t_conv.main, [kind, "-f", str(fixture)])
        assert rc == 0
        texts.append(out)
    source = "\n".join(t for t in texts if t.strip())
    assert source
    cedar = tmp_path / f"{fixture.stem}.cedar"
    cedar.write_text(source)

    # 2. the port's validator accepts it against the port's generated
    # authorization schema
    schema_json = tmp_path / "authorization.cedarschema.json"
    assert t_gen.main(["--no-admission", "--output", str(schema_json)]) == 0
    schema = TSchema.from_json(json.loads(schema_json.read_text()))
    n, findings = t_val.validate_file(schema, cedar)
    assert not findings, [str(f) for f in findings]
    assert n == len(TPolicySet.from_source(source, "rbac").policies())
    assert _cli(capsys, t_val.main, ["--schema", str(schema_json), str(cedar)])[0] == 0

    # 3. the port's engine serves it on the CPU; the JAX interpreter is
    # the oracle over the same text
    engine = TorchPolicyEngine(device="cpu")
    engine.load([TPolicySet.from_source(source, "rbac")])
    ta = t_auth.CedarWebhookAuthorizer(
        t_store.TieredPolicyStores([t_store.MemoryStore.from_source("rbac", source)]),
        evaluate_batch=engine.evaluate_batch)
    ja = j_auth.CedarWebhookAuthorizer(
        j_store.TieredPolicyStores([j_store.MemoryStore.from_source("rbac", source)]))

    bindings, roles = t_conv.load_rbac_documents([fixture.read_text()])
    sars = migration_sars(bindings, roles)
    assert sars
    t_out = ta.authorize_batch([t_sar.get_authorizer_attributes(s) for s in sars])
    j_out = [ja.authorize(j_http.get_authorizer_attributes(s)) for s in sars]
    t_resp = [t_sar.sar_response(d, r) for d, r in t_out]
    j_resp = [j_http.sar_response(d, r) for d, r in j_out]
    for s, t, j in zip(sars, t_resp, j_resp):
        assert t == j, json.dumps(s)
    decisions = [d for d, _ in t_out]
    assert len(decisions) == len(sars)
    if n:
        assert t_auth.DECISION_ALLOW in decisions
