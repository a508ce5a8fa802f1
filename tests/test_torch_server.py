"""The port's webhook server (cedar_tpu_torch/server/http.py) against the
JAX package's WebhookServer, over real HTTP on the CPU, at tolerance 0.

Both servers serve the same directory of policies (the demo policies, a
small synth corpus, and an interpreter-fallback and a native-opaque policy
whose scopes gate rows back to the exact path). The JAX server is built
as its own server fast-path tests build it (SARFastPath over
TPUPolicyEngine on JAX's CPU plane, behind its pipelined batcher); the
port's comes from its CLI's build_server with ``--device cpu``. Each body
is POSTed to both, and the HTTP status and the response document must be
equal: the demo SARs, synth-corpus bodies, gated-scope bodies, malformed
and oversized bodies, a wrong method and a wrong path. The same holds for
the interpreter-only servers, for a deadline expiry and for a drain.

The same differential holds for ``POST /v1/admit``: both servers carry
the admission stack (the store plus the allow-all final tier) over a
directory that also holds admission policies (chip_smoke.py phase 9's),
and answer its generated AdmissionReview bodies and malformed ones with
the same status and document, one at a time and from 4 clients, in every
serving mode (pipelined, --pipeline-depth 0, --no-native, interpreter).
And over three directory tiers (a forbid with the gated policies, the
synth set, the demo) for both endpoints.

Then what only the port promises: no quiet degradation (a stage, a
kernel launch or a gated re-run that fails answers NoOpinion with the
error, and nothing re-runs the batch on the interpreter; the admission
twin is in test_torch_admission.py), /v1/admit answering 404 on a server
built without an admission handler, and the /metrics and /debug/engine
documents.
"""

import http.client
import json
import pathlib
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import sys

import pytest
import yaml

from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import AdmissionFastPath as JAdmissionFastPath
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.corpus.synth import synth_corpus, synth_source
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import SARFastPath
from cedar_tpu_torch.ops import cuda_match
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
from cedar_tpu_torch.stores.store import TieredPolicyStores

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — phase 9's admission policies and traffic

FALLBACK_POLICY = (
    'permit (principal in k8s::Group::"joiners", '
    'action == k8s::Action::"get",\n'
    "        resource is k8s::Resource)\n"
    "  when { "
    + " && ".join(
        '(resource.resource == "widgets" || resource.name == "10.0.0.1")'
        for _ in range(12)
    )
    + " };\n"
)
NATIVE_OPAQUE_POLICY = """
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""
SYNTH_N, SYNTH_SEED = 48, 7


def _demo_source() -> str:
    docs = [d for d in yaml.safe_load_all((REPO / "demo/authorization-policy.yaml").read_text()) if d]
    return "\n".join(d["spec"]["content"] for d in docs)


def _sar(user, verb, resource, groups=(), selector=None, namespace="default", name="",
         nonresource=None, api_group=""):
    spec = {"user": user, "uid": "u1", "groups": list(groups)}
    if nonresource is not None:
        spec["nonResourceAttributes"] = {"path": nonresource, "verb": verb}
    else:
        ra = {"verb": verb, "resource": resource, "version": "v1", "namespace": namespace,
              "group": api_group}
        if name:
            ra["name"] = name
        if selector is not None:
            ra["labelSelector"] = {"requirements": selector}
        spec["resourceAttributes"] = ra
    return json.dumps(
        {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview", "spec": spec}
    ).encode()


# the demo behavior of the verify recipe: allow, deny, group read with
# the secrets carve-out, selector-gated lists, the system-user skip, the
# authorizer's own self-allow, a non-resource request
DEMO_BODIES = {
    "sam-get-pods": _sar("sam", "get", "pods"),
    "sam-list-nodes": _sar("sam", "list", "nodes"),
    "team-get-configmaps": _sar("pat", "get", "configmaps", groups=["platform-team"]),
    "team-get-secrets": _sar("pat", "get", "secrets", groups=["platform-team"]),
    "team-list-public-secrets": _sar(
        "pat", "list", "secrets", groups=["platform-team"],
        selector=[{"key": "confidentiality", "operator": "In", "values": ["public"]}],
    ),
    "owner-lists-own-secrets": _sar(
        "alice", "list", "secrets",
        selector=[{"key": "owner", "operator": "In", "values": ["alice"]}],
    ),
    "owner-lists-other-secrets": _sar(
        "alice", "list", "secrets",
        selector=[{"key": "owner", "operator": "In", "values": ["bob"]}],
    ),
    "impersonate": _sar("ops-lead", "impersonate", "users"),
    "system-user-skip": _sar("system:kube-scheduler", "get", "pods"),
    "authorizer-self-allow": _sar(
        "system:authorizer:cedar-authorizer", "list", "rolebindings",
        api_group="rbac.authorization.k8s.io",
    ),
    "nonresource": _sar("sam", "get", None, nonresource="/healthz"),
}
GATED_BODIES = {
    f"joiners-widgets-{nm or 'noname'}": _sar("jo", "get", "widgets", groups=["joiners"], name=nm)
    for nm in ("10.0.0.1", "x", "")
}
GATED_BODIES.update({
    f"deletecollection-{u}-{nm}": _sar(u, "deletecollection", "pods", name=nm)
    for u in ("sam", "c0-user-1") for nm in ("127.0.0.1", "10.0.0.1", "not-an-ip")
})
SYNTH_BODIES = synth_corpus(SYNTH_N, seed=SYNTH_SEED).sar_bodies(200, seed=11)
SYNTH_GROUP = 8
# (method, path, body, extra headers)
EDGE_REQUESTS = {
    "malformed-json": ("POST", "/v1/authorize", b'{"spec": {"user": ', {}),
    "empty-body": ("POST", "/v1/authorize", b"", {}),
    "json-array": ("POST", "/v1/authorize", b"[1, 2]", {}),
    "json-null": ("POST", "/v1/authorize", b"null", {}),
    "not-utf8": ("POST", "/v1/authorize", b"\xff\xfe{}", {}),
    "query-string": ("POST", "/v1/authorize?dryRun=1", DEMO_BODIES["sam-get-pods"], {}),
    "oversized": ("POST", "/v1/authorize", b"{}", {"Content-Length": str(8 * 1024 * 1024 + 1)}),
    "bad-content-length": ("POST", "/v1/authorize", b"{}", {"Content-Length": "abc"}),
    "wrong-method-get": ("GET", "/v1/authorize", None, {}),
    "wrong-method-put": ("PUT", "/v1/authorize", b"{}", {}),
    "wrong-path": ("POST", "/v1/authorization", DEMO_BODIES["sam-get-pods"], {}),
}


def request(port, method, path, body=None, headers=None):
    """One request on a fresh connection -> (status, JSON document or raw
    bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        headers = dict(headers or {})
        if body is not None and "Content-Length" not in headers:
            headers["Content-Length"] = str(len(body))
        conn.putrequest(method, path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body is not None and headers.get("Content-Length") == str(len(body)):
            conn.send(body)
        resp = conn.getresponse()
        data = resp.read()
        if resp.getheader("Content-Type") == "application/json":
            return resp.status, json.loads(data)
        return resp.status, data
    finally:
        conn.close()


def _write_policies(d: pathlib.Path) -> None:
    (d / "demo.cedar").write_text(_demo_source())
    (d / "synth.cedar").write_text(synth_source(SYNTH_N, seed=SYNTH_SEED))
    (d / "gated.cedar").write_text(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY)


def _jax_server(policy_dir, fast=True, **kw):
    stores = JTieredPolicyStores([JDirectoryPolicyStore(str(policy_dir), start_ticker=False)])
    fastpath = None
    if fast:
        engine = TPUPolicyEngine()
        engine.load([s.policy_set() for s in stores], warm="off")
        authz = j_auth.CedarWebhookAuthorizer(
            stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch
        )
        fastpath = JSARFastPath(engine, authz)
    else:
        authz = j_auth.CedarWebhookAuthorizer(stores)
    srv = JWebhookServer(authz, None, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=fastpath, **kw)
    srv.start()
    return srv


def _port_server(policy_dir, *flags):
    """The port's CLI server with --device cpu over one directory store, or
    one tier per directory when given a list."""
    dirs = policy_dir if isinstance(policy_dir, list) else [policy_dir]
    cfg = dirs[0].parent / "store-config.json"
    cfg.write_text(json.dumps({
        "apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
        "spec": {"stores": [{"type": "directory", "directoryStore": {"path": str(d)}}
                            for d in dirs]},
    }))
    args = make_parser().parse_args([
        "--config", str(cfg), "--device", "cpu", "--insecure",
        "--secure-port", "0", "--metrics-port", "0", *flags,
    ])
    srv = build_server(args)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def policy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("srv") / "policies"
    d.mkdir()
    _write_policies(d)
    return d


@pytest.fixture(scope="module")
def servers(policy_dir):
    """(JAX server, port server) on the device plane, both pipelined."""
    j = _jax_server(policy_dir, pipeline_depth=2, request_timeout_s=60.0)
    t = _port_server(policy_dir, "--request-timeout-ms", "60000")
    yield j, t
    j.stop()
    t.stop()


@pytest.fixture(scope="module")
def interp_servers(policy_dir):
    j = _jax_server(policy_dir, fast=False)
    t = _port_server(policy_dir, "--backend", "interpreter")
    yield j, t
    j.stop()
    t.stop()


def _same(servers, method, path, body=None, headers=None):
    j, t = servers
    want = request(j.bound_port, method, path, body, headers)
    got = request(t.bound_port, method, path, body, headers)
    assert got == want
    return got


# ------------------------------------------------------- the differential


@pytest.mark.parametrize("name", sorted(DEMO_BODIES))
def test_demo_sar_equals_jax(servers, name):
    status, doc = _same(servers, "POST", "/v1/authorize", DEMO_BODIES[name])
    assert status == 200 and doc["kind"] == "SubjectAccessReview"


def test_demo_answers_are_the_demo_behavior(servers):
    _, t = servers
    want = {
        "sam-get-pods": "allowed", "sam-list-nodes": "denied", "team-get-configmaps": "allowed",
        "team-get-secrets": None, "team-list-public-secrets": "allowed",
        "owner-lists-own-secrets": "allowed", "owner-lists-other-secrets": None,
        "system-user-skip": None, "authorizer-self-allow": "allowed",
    }
    for name, verdict in want.items():
        st = request(t.bound_port, "POST", "/v1/authorize", DEMO_BODIES[name])[1]["status"]
        assert (st["allowed"], st["denied"]) == (verdict == "allowed", verdict == "denied"), name


@pytest.mark.parametrize("group", range(len(SYNTH_BODIES) // SYNTH_GROUP))
def test_synth_bodies_equal_jax(servers, group):
    for body in SYNTH_BODIES[group * SYNTH_GROUP:(group + 1) * SYNTH_GROUP]:
        _same(servers, "POST", "/v1/authorize", body)


@pytest.mark.parametrize("name", sorted(GATED_BODIES))
def test_gated_scope_bodies_equal_jax(servers, name):
    _same(servers, "POST", "/v1/authorize", GATED_BODIES[name])


@pytest.mark.parametrize("name", sorted(EDGE_REQUESTS))
def test_edge_requests_equal_jax(servers, name):
    method, path, body, headers = EDGE_REQUESTS[name]
    status, doc = _same(servers, method, path, body, headers)
    if name == "malformed-json":
        assert status == 200 and doc["status"]["evaluationError"].startswith(
            "failed parsing request body"
        )


def test_concurrent_bodies_equal_jax(servers):
    """Every synth and gated body from 16 client threads at once to the
    port's server: the batches it forms differ from the JAX server's, the
    answers do not. The JAX server keeps the standard library's listen
    backlog of 5, which a burst of 16 fresh connections can overflow on a
    loaded host (the kernel then resets one), so its reference answers
    come from 4 client threads."""
    bodies = SYNTH_BODIES + list(GATED_BODIES.values()) + list(DEMO_BODIES.values())

    def all_answers(port, clients):
        with ThreadPoolExecutor(clients) as pool:
            return list(pool.map(lambda b: request(port, "POST", "/v1/authorize", b), bodies))

    j, t = servers
    assert all_answers(t.bound_port, 16) == all_answers(j.bound_port, 4)
    assert t.debug_engine()["authorization"]["pipeline"]["largest_batch"] > 1


@pytest.mark.parametrize("path", ["/healthz", "/readyz", "/nope"])
def test_health_endpoints_equal_jax(servers, path):
    j, t = servers
    assert request(t.bound_metrics_port, "GET", path) == request(j.bound_metrics_port, "GET", path)


@pytest.mark.parametrize("name", sorted(DEMO_BODIES) + ["malformed-json", "json-null"])
def test_interpreter_backend_equals_jax(interp_servers, name):
    if name in DEMO_BODIES:
        _same(interp_servers, "POST", "/v1/authorize", DEMO_BODIES[name])
    else:
        _same(interp_servers, "POST", "/v1/authorize", EDGE_REQUESTS[name][2])


def jax_native_ready(wait_s: float = 120.0) -> bool:
    """Load the JAX package's native library in this process, so its fast
    path serves natively. Its build takes a thread lock only: test
    processes that build it at once race on one temporary file, and a
    loser caches the failure and serves through its Python path (ROADMAP
    §C). A loser clears that cached failure and loads the library the
    winner built, retrying for up to ``wait_s``."""
    from cedar_tpu import native as jnative

    deadline = time.monotonic() + wait_s
    while not jnative.native_available():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        jnative._lib_error = None
    return True


def _held_decode(fastpath, gate: threading.Event):
    """Hold every batch's decode stage until ``gate`` is set."""
    real = fastpath.pipeline_decode

    def held(ctx):
        gate.wait(120)
        return real(ctx)

    fastpath.pipeline_decode = held


def test_deadline_expiry_equals_jax(policy_dir):
    """A batch that outlives the request budget: NoOpinion with the
    deadline's evaluationError, from both servers. Both servers' decode
    stages are held until both answers are in, so the budget runs out
    whatever the host's load; the message names the budget left at
    submit (each server starts the clock when the request arrives), which
    must lie in (0, budget]."""
    from cedar_tpu import native as jnative

    assert jax_native_ready(), jnative.native_error()
    budget = 2.0
    j = _jax_server(policy_dir, pipeline_depth=2, request_timeout_s=budget)
    t = _port_server(policy_dir, "--request-timeout-ms", str(budget * 1e3))
    gate = threading.Event()
    try:
        _held_decode(j.fastpath, gate)
        _held_decode(t.fastpath, gate)
        body = DEMO_BODIES["sam-get-pods"]
        with ThreadPoolExecutor(2) as pool:
            got = pool.submit(request, t.bound_port, "POST", "/v1/authorize", body)
            want = pool.submit(request, j.bound_port, "POST", "/v1/authorize", body)
            got, want = got.result(), want.result()
        for _, doc in (got, want):
            err = doc["status"]["evaluationError"]
            m = re.fullmatch(
                r"evaluation error: deadline of (\d+\.\d{3})s exceeded waiting for batch result",
                err,
            )
            assert m and 0 < float(m.group(1)) <= budget, err
            doc["status"]["evaluationError"] = err.replace(m.group(1), "<budget>")
        assert got == want
        assert t.metrics.deadline_exceeded_total.value(path="authorization") == 1
    finally:
        gate.set()
        j.stop()
        t.stop()


def test_drain_equals_jax(policy_dir):
    j = _jax_server(policy_dir, fast=False)
    t = _port_server(policy_dir, "--backend", "interpreter")
    try:
        j.begin_drain()
        t.begin_drain()
        assert _same((j, t), "POST", "/v1/authorize", DEMO_BODIES["sam-get-pods"])[0] == 503
        j_ready = request(j.bound_metrics_port, "GET", "/readyz")
        assert request(t.bound_metrics_port, "GET", "/readyz") == j_ready == (503, b"")
        assert t.metrics.requests_shed_total.value(path="authorization") == 1
    finally:
        j.stop()
        t.stop()


# ------------------------------------------------ /v1/admit, the differential

ADM_FILES = {
    "admission.cedar": chip_smoke.ADM_POLICIES,
    "admission-demo.cedar": chip_smoke.ADM_DEMO_OWNER_POLICY,
    "admission-gated.cedar": chip_smoke.ADM_FALLBACK_POLICY,
}
ADM_BODIES = chip_smoke.admission_bodies(160, seed=31)
ADM_GROUP = 20
ADM_EDGE = {
    "malformed-json": ("POST", "/v1/admit", b'{"request": ', {}),
    "empty-body": ("POST", "/v1/admit", b"", {}),
    "json-null": ("POST", "/v1/admit", b"null", {}),
    "json-array": ("POST", "/v1/admit", b"[1, 2]", {}),
    "not-utf8": ("POST", "/v1/admit", b"\xff\xfe{}", {}),
    "query-string": ("POST", "/v1/admit?timeout=10s", ADM_BODIES[0], {}),
    "oversized": ("POST", "/v1/admit", b"{}", {"Content-Length": str(8 * 1024 * 1024 + 1)}),
    "bad-content-length": ("POST", "/v1/admit", b"{}", {"Content-Length": "abc"}),
    "wrong-method-get": ("GET", "/v1/admit", None, {}),
}
ADM_MODES = {
    "pipelined": ("--request-timeout-ms", "60000"),
    "depth0": ("--request-timeout-ms", "60000", "--pipeline-depth", "0"),
    "no-native": ("--request-timeout-ms", "60000", "--no-native"),
    "interpreter": ("--backend", "interpreter"),
}


def _jax_adm_server(policy_dirs, mode):
    """The JAX WebhookServer with both stacks, as its CLI wires them: the
    authorization stores, the admission stores (plus the allow-all tier),
    an engine each (unless interpreter), and the native fast paths
    (unless no-native or interpreter)."""
    stores = JTieredPolicyStores(
        [JDirectoryPolicyStore(str(d), start_ticker=False) for d in policy_dirs])
    adm_stores = JTieredPolicyStores(
        list(stores.stores) + [j_adm.allow_all_admission_policy_store()])
    fast = adm_fast = None
    if mode == "interpreter":
        authz = j_auth.CedarWebhookAuthorizer(stores)
        handler = j_adm.CedarAdmissionHandler(adm_stores)
    else:
        engine, adm_engine = TPUPolicyEngine(), TPUPolicyEngine()
        engine.load([s.policy_set() for s in stores], warm="off")
        adm_engine.load([s.policy_set() for s in adm_stores], warm="off")
        authz = j_auth.CedarWebhookAuthorizer(
            stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
        handler = j_adm.CedarAdmissionHandler(
            adm_stores, evaluate=adm_engine.evaluate, evaluate_batch=adm_engine.evaluate_batch)
        if mode != "no-native":
            fast = JSARFastPath(engine, authz)
            adm_fast = JAdmissionFastPath(adm_engine, handler)
    srv = JWebhookServer(authz, handler, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=fast, admission_fastpath=adm_fast,
                         pipeline_depth=0 if mode == "depth0" else 2, request_timeout_s=60.0)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def adm_policy_dir(tmp_path_factory):
    """The differential's policies plus admission policies in one
    directory: one store holding both kinds, as the reference deploys."""
    d = tmp_path_factory.mktemp("adm") / "policies"
    d.mkdir()
    _write_policies(d)
    for name, text in ADM_FILES.items():
        (d / name).write_text(text)
    return d


@pytest.fixture(scope="module", params=sorted(ADM_MODES))
def adm_servers(request, adm_policy_dir):
    """(JAX server, port server) with both endpoints, in one serving mode."""
    mode = request.param
    j = _jax_adm_server([adm_policy_dir], mode)
    t = _port_server(adm_policy_dir, *ADM_MODES[mode])
    yield j, t
    j.stop()
    t.stop()


@pytest.mark.parametrize("group", range(len(ADM_BODIES) // ADM_GROUP))
def test_admit_bodies_equal_jax(adm_servers, group):
    """One at a time: status and AdmissionReview document equal."""
    for body in ADM_BODIES[group * ADM_GROUP:(group + 1) * ADM_GROUP]:
        status, doc = _same(adm_servers, "POST", "/v1/admit", body)
        assert status == 200 and doc["kind"] == "AdmissionReview"


@pytest.mark.parametrize("name", sorted(ADM_EDGE))
def test_admit_edge_requests_equal_jax(adm_servers, name):
    method, path, body, headers = ADM_EDGE[name]
    status, doc = _same(adm_servers, method, path, body, headers)
    if name == "malformed-json":
        assert status == 200 and doc["response"]["status"]["message"].startswith(
            "failed parsing body")


def test_admit_concurrent_equals_jax(adm_servers):
    """Every admission body from 4 client threads to both servers (and
    the authorization bodies beside them on the port's): the batches
    differ, the answers do not. The port's pipelined server forms batches
    above one."""
    j, t = adm_servers
    work = [("/v1/admit", b) for b in ADM_BODIES] + [("/v1/authorize", b)
                                                     for b in SYNTH_BODIES[:40]]

    def all_answers(port, clients):
        with ThreadPoolExecutor(clients) as pool:
            return list(pool.map(lambda pb: request(port, "POST", *pb), work))

    assert all_answers(t.bound_port, 4) == all_answers(j.bound_port, 4)
    doc = t.debug_engine()
    if "admission" in doc:
        assert doc["admission"]["engine"]["device"] == "cpu"
        assert doc["admission"]["pipeline"]["rows_total"] >= len(ADM_BODIES)


# three directory tiers: a forbid with the gated policies first, the synth
# set, then the demo (both halves of the repo's demo)
TIER1_FORBIDS = """
forbid (principal, action == k8s::Action::"delete", resource is k8s::Resource)
  when { resource.resource == "secrets" };
forbid (principal is k8s::User, action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when { resource.metadata has namespace && resource.metadata.namespace == "team-a" };
"""
TIER_SAR_BODIES = (list(DEMO_BODIES.values()) + list(GATED_BODIES.values())
                   + SYNTH_BODIES[:48]
                   + [_sar(u, "delete", "secrets", groups=g)
                      for u, g in (("sam", ()), ("pat", ("platform-team",)))])


def _demo_admission_source() -> str:
    docs = [d for d in yaml.safe_load_all((REPO / "demo/admission-policy.yaml").read_text()) if d]
    return "\n".join(d["spec"]["content"] for d in docs if d.get("spec"))


@pytest.fixture(scope="module")
def tier_servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiers")
    dirs = [root / name for name in ("t1-forbid-gated", "t2-synth", "t3-demo")]
    for d in dirs:
        d.mkdir()
    (dirs[0] / "forbid.cedar").write_text(TIER1_FORBIDS)
    (dirs[0] / "gated.cedar").write_text(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY
                                        + chip_smoke.ADM_FALLBACK_POLICY)
    (dirs[1] / "synth.cedar").write_text(synth_source(SYNTH_N, seed=SYNTH_SEED))
    (dirs[2] / "demo.cedar").write_text(_demo_source())
    (dirs[2] / "demo-admission.cedar").write_text(_demo_admission_source())
    j = _jax_adm_server(dirs, "pipelined")
    t = _port_server(dirs, *ADM_MODES["pipelined"])
    yield j, t
    j.stop()
    t.stop()


@pytest.mark.parametrize("group", range(-(-len(TIER_SAR_BODIES) // SYNTH_GROUP)))
def test_three_tiers_authorize_equals_jax(tier_servers, group):
    for body in TIER_SAR_BODIES[group * SYNTH_GROUP:(group + 1) * SYNTH_GROUP]:
        _same(tier_servers, "POST", "/v1/authorize", body)


@pytest.mark.parametrize("group", range(len(ADM_BODIES) // ADM_GROUP))
def test_three_tiers_admit_equals_jax(tier_servers, group):
    for body in ADM_BODIES[group * ADM_GROUP:(group + 1) * ADM_GROUP]:
        _same(tier_servers, "POST", "/v1/admit", body)


def test_three_tiers_stop_at_the_first_explicit_tier(tier_servers):
    """Tier 1's forbids decide before the later tiers: a secrets delete is
    denied by tier 1 whatever the demo permits, and a create in team-a by
    a tenants user names tier 1's forbid, not the demo's owner forbid."""
    _, t = tier_servers
    st = request(t.bound_port, "POST", "/v1/authorize",
                 _sar("pat", "delete", "secrets", groups=["platform-team"]))[1]["status"]
    assert st["denied"] is True and "forbid.cedar.policy0" in st["reason"]
    body = json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                       "request": {"uid": "t", "operation": "CREATE",
                                   "userInfo": {"username": "bob", "groups": ["tenants"]},
                                   "kind": {"group": "", "version": "v1", "kind": "ConfigMap"},
                                   "resource": {"group": "", "version": "v1",
                                                "resource": "configmaps"},
                                   "namespace": "team-a", "name": "c",
                                   "object": {"apiVersion": "v1", "kind": "ConfigMap",
                                              "metadata": {"name": "c",
                                                           "namespace": "team-a"}}}}).encode()
    r = _same(tier_servers, "POST", "/v1/admit", body)[1]["response"]
    assert r["allowed"] is False
    assert [x["policy"] for x in json.loads(r["status"]["message"])] == ["forbid.cedar.policy1"]


# --------------------------------------------------- what the port promises


def test_admit_is_not_served(servers):
    """/v1/admit answers 404 on a server built without an admission
    handler (the library WebhookServer over an authorizer alone); the
    CLI's servers carry one."""
    _, t = servers
    bare = WebhookServer(t.authorizer, address="127.0.0.1", port=0, metrics_port=0)
    bare.start()
    try:
        assert request(bare.bound_port, "POST", "/v1/admit", ADM_BODIES[0])[0] == 404
        assert request(bare.bound_port, "POST", "/v1/authorize",
                       DEMO_BODIES["sam-get-pods"])[0] == 200
    finally:
        bare.stop()
    assert request(t.bound_port, "POST", "/v1/admit", ADM_BODIES[0])[0] == 200


def test_metrics_and_debug_engine(servers):
    _, t = servers
    request(t.bound_port, "POST", "/v1/authorize", DEMO_BODIES["sam-get-pods"])
    status, text = request(t.bound_metrics_port, "GET", "/metrics")
    assert status == 200
    text = text.decode()
    for family in (
        "cedar_authorizer_request_total", "cedar_authorizer_request_duration_seconds",
        "cedar_authorizer_deadline_exceeded_total", "cedar_authorizer_requests_shed_total",
        "cedar_authorizer_fallback_batches_total", "cedar_batch_occupancy",
        "cedar_pipeline_stall_seconds_total", "cedar_pipeline_stage_seconds",
        "cedar_authorizer_row_routing_total", "cedar_packed_decode_transfers_total",
        "cedar_packed_decode_chunks_total", "cedar_native_encode_threads",
    ):
        assert f"# TYPE {family} " in text, family
    assert 'cedar_authorizer_request_total{decision="Allow"}' in text
    assert 'cedar_authorizer_fallback_batches_total{path="authorization",reason="evaluator_error"} 0' in text
    assert 'cedar_authorizer_row_routing_total{path="authorization",row_class="clean_native"}' in text
    status, doc = request(t.bound_metrics_port, "GET", "/debug/engine")
    assert status == 200
    entry = doc["authorization"]
    assert entry["pipeline"]["mode"] == "pipelined" and entry["pipeline"]["depth"] == 2
    assert entry["engine"]["device"] == "cpu"
    assert set(entry["engine"]["launches"]) == {"match_groups_kernel", "match_words_kernel"}
    assert entry["engine"]["fallback"]["policies"] == 1
    # the admission stack: its own engine behind its own pipeline, and
    # the path="admission" series of the batch and routing families
    request(t.bound_port, "POST", "/v1/admit", ADM_BODIES[0])
    adm = request(t.bound_metrics_port, "GET", "/debug/engine")[1]["admission"]
    assert adm["pipeline"]["mode"] == "pipelined" and adm["pipeline"]["batches_total"] >= 1
    assert adm["engine"]["device"] == "cpu" and adm["engine"]["R"] == entry["engine"]["R"]
    text = request(t.bound_metrics_port, "GET", "/metrics")[1].decode()
    assert 'cedar_authorizer_fallback_batches_total{path="admission",reason="evaluator_error"} 0' in text
    assert 'cedar_batch_occupancy_count{path="admission"}' in text
    assert 'cedar_authorizer_row_routing_total{path="admission",' in text
    assert 'cedar_pipeline_stage_seconds_count{path="admission",stage="dispatch"}' in text


@pytest.fixture
def small_stack(tmp_path):
    """A port server over the demo policies, pipelined, started; the
    interpreter entry points it must never use are wrapped in spies."""
    d = tmp_path / "policies"
    d.mkdir()
    (d / "demo.cedar").write_text(_demo_source())
    (d / "gated.cedar").write_text(NATIVE_OPAQUE_POLICY)
    stores = TieredPolicyStores([DirectoryPolicyStore(str(d))])
    engine = TorchPolicyEngine(device="cpu")
    engine.load([s.policy_set() for s in stores])
    authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    fast = SARFastPath(engine, authz)
    calls = []

    def spy(obj, name):
        real = getattr(obj, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)

        setattr(obj, name, wrapped)

    for obj, name in ((authz, "authorize"), (authz, "authorize_batch"),
                      (stores, "is_authorized"), (fast, "_python_fallback")):
        spy(obj, name)

    def make(depth=2):
        srv = WebhookServer(authz, address="127.0.0.1", port=0, metrics_port=0, fastpath=fast,
                            pipeline_depth=depth, request_timeout_s=30.0)
        spy(srv.metrics, "record_fallback_batch")
        srv.start()
        return srv

    return engine, fast, calls, make


def _boom(*a, **k):
    raise RuntimeError("injected device failure")


def _kernel_boom(*a, **k):
    raise RuntimeError("match_words_kernel launch failed: error 700 (an illegal memory access)")


# where the failure is injected: (what, attribute, replacement, pipeline depth)
FAILURES = {
    "encode-stage": ("fast", "_encode_into", _boom, 2),
    "dispatch-stage": ("engine", "match_arrays_launch", _boom, 2),
    "decode-stage": ("fast", "_decode_word_payload", _boom, 2),
    "serial-batch": ("engine", "match_arrays_launch", _boom, 0),
    "kernel-launch": ("cuda_match", "match_words", _kernel_boom, 2),
    "gated-rerun": ("engine", "evaluate_batch", _boom, 2),
}


@pytest.mark.parametrize("where", sorted(FAILURES))
def test_failure_answers_error_and_never_the_interpreter(small_stack, monkeypatch, where):
    """A failure anywhere on the device path answers every request of the
    failed batch NoOpinion with an evaluationError naming it. Nothing
    re-runs the batch on the interpreter: no per-row exact path, no
    authorizer, no store walk, no fallback-batch count."""
    engine, fast, calls, make = small_stack
    what, attr, repl, depth = FAILURES[where]
    target = {"fast": fast, "engine": engine, "cuda_match": cuda_match}[what]
    monkeypatch.setattr(target, attr, repl)
    srv = make(depth)
    try:
        body = (
            _sar("sam", "deletecollection", "pods", name="127.0.0.1")
            if where == "gated-rerun" else DEMO_BODIES["sam-get-pods"]
        )
        with ThreadPoolExecutor(8) as pool:
            answers = list(pool.map(
                lambda b: request(srv.bound_port, "POST", "/v1/authorize", b), [body] * 8
            ))
        for status, doc in answers:
            assert status == 200
            st = doc["status"]
            assert (st["allowed"], st["denied"], st["reason"]) == (False, False, "")
            assert "batch evaluation failed" in st["evaluationError"]
            assert ("match_words_kernel launch failed" if where == "kernel-launch"
                    else "injected device failure") in st["evaluationError"]
        assert calls == []
        assert srv.metrics.fallback_batches_total.value(
            path="authorization", reason="evaluator_error") == 0
        # the server goes on serving once the fault is gone
        monkeypatch.undo()
        status, doc = request(srv.bound_port, "POST", "/v1/authorize", DEMO_BODIES["sam-get-pods"])
        assert doc["status"]["allowed"] is True
    finally:
        srv.stop()


def test_tls_serving(tmp_path):
    """Without --insecure the webhook serves TLS with a self-signed pair
    made in --cert-dir (the JAX CLI's maybe_self_signed_certs)."""
    pytest.importorskip("cryptography")
    import ssl

    d = tmp_path / "policies"
    d.mkdir()
    (d / "demo.cedar").write_text(_demo_source())
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(d)}}]}}))
    args = make_parser().parse_args([
        "--config", str(cfg), "--device", "cpu", "--cert-dir", str(tmp_path / "certs"),
        "--secure-port", "0", "--metrics-port", "0",
    ])
    srv = build_server(args)
    srv.start()
    try:
        ctx = ssl.create_default_context(cafile=srv.certfile)
        conn = http.client.HTTPSConnection("127.0.0.1", srv.bound_port, context=ctx, timeout=30)
        body = DEMO_BODIES["sam-get-pods"]
        conn.request("POST", "/v1/authorize", body=body)
        doc = json.loads(conn.getresponse().read())
        conn.close()
        assert doc["status"]["allowed"] is True
    finally:
        srv.stop()
