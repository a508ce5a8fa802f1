"""The port's explain plane (cedar_tpu_torch/explain/) and ``?explain=1`` on
its webhook server, against the JAX package's cedar_tpu/explain, on the
CPU, at tolerance 0.

  * Explainer.explain_authorize / explain_admit over 1,100 bodies (800
    SubjectAccessReviews, 300 AdmissionReviews) and the short-circuit
    bodies, in each plane: device (the port's plain bits plane on a CPU
    engine; JAX's XLA plane), host (both breakers forced open) and
    interpreter (no engine), on a policy set without and with an
    interpreter-fallback policy: outputs equal as canonical JSON;
  * literal_test / clause_tests for every rule clause of six packs,
    host_sat and sat_from_bits on their traffic, attribution_summary;
  * the non-explain path of a server whose explain plane was used is byte
    for byte that of one that never explained, and explain never reads or
    fills the decision cache;
  * over HTTP on both endpoints (the CLI's wiring: fast paths, breakers,
    cache): every query form of ``explain`` held to a JAX server's answer;
  * the bypasses on a CLI server with the injector firing on every call,
    tracing at rate 1, the audit log and the recorder: real answers, no
    batch, no trace, no audit line, no SLO record, the recorder's file,
    ``cedar_explain_requests_total``, one bits fetch and no match launch
    per request (spies);
  * under the gate's pressure state explain is shed as sheddable and a
    normal request is not, as on a JAX server in the same state;
  * a device explain failure with the breaker closed answers explain-error
    and never re-runs on the host plane (by design, unlike JAX);
  * DiffAttributor against JAX's over duck-typed candidates;
  * cedar_explain_compiles_total: 0 on a warmed set, 1 on a set that was
    never warmed; the families' names and help are JAX's; the serving
    stack does not import the explain package.
"""

from __future__ import annotations

import functools
import http.client
import json
import pathlib
import subprocess
import sys
import time
import types
from contextlib import ExitStack

import numpy as np
import pytest

from cedar_tpu import load as jload
from cedar_tpu.compiler.table import encode_request_codes as j_encode
from cedar_tpu.engine.breaker import CircuitBreaker as JCircuitBreaker
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.entities.admission import AdmissionRequest as JAdmissionRequest
from cedar_tpu.explain import DiffAttributor as JDiffAttributor
from cedar_tpu.explain import Explainer as JExplainer
from cedar_tpu.explain import attribution as j_attr
from cedar_tpu.explain import explainer as j_explainer
from cedar_tpu.explain.plane import encode_single as j_encode_single
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.server.http import get_authorizer_attributes as j_attributes
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import explain as t_explain
from cedar_tpu_torch import load as tload
from cedar_tpu_torch.cache import DecisionCache
from cedar_tpu_torch.cache.generation import plane_composite
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.compiler.table import encode_request_codes
from cedar_tpu_torch.corpus.synth import synth_corpus, synth_source
from cedar_tpu_torch.engine.breaker import CircuitBreaker
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.entities.admission import AdmissionRequest
from cedar_tpu_torch.explain import DiffAttributor, Explainer
from cedar_tpu_torch.explain import attribution as t_attr
from cedar_tpu_torch.explain import explainer as t_explainer
from cedar_tpu_torch.explain.plane import encode_single
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.admission import (
    CedarAdmissionHandler,
    allow_all_admission_policy_store,
)
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.server.sar import get_authorizer_attributes
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores
from test_torch_cache import _jax_counters_restored  # noqa: F401 — JAX counters put back

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _jax_jit_caches_cleared():
    """The JAX explain planes traced here stay in JAX's process-wide jit
    caches, and tests/test_explain.py counts the trace of a first explain
    request over the same policies (TestLazyCompile): the caches are
    cleared when the module ends, whichever file the same test process
    runs next."""
    yield
    import jax

    jax.clear_caches()
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — the admission policies

# ------------------------------------------------ fixtures (test_explain.py)

FILENAME = "explain-test"

POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.name == "alice" && resource.resource == "pods" };
forbid (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.name == "carol" && resource.resource == "secrets" };
permit (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal is k8s::User,
        action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when { resource.metadata has labels &&
         resource.metadata.labels.contains({key: "env", value: "prod"}) };
"""

# an ordered-DNF alternation product past the spillover ceiling: served by
# the interpreter fallback, which ALLOWS every pods SAR
UNLOWERABLE = (
    "permit (principal, action, resource) when { "
    + " && ".join(
        f'(resource.resource == "pods" || resource.name == "z{i}")'
        for i in range(12)
    )
    + " };"
)

LAZY_POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.name == "alice" && resource.namespace == "default" };
forbid (principal is k8s::User, action == k8s::Action::"list",
        resource is k8s::Resource)
  when { resource.resource == "secrets" && principal.name like "ba*" };
"""

# like, in-set, negated and entity-membership literals
KINDS = """
permit (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name like "a*" && ["pods", "services"].contains(resource.resource) };
forbid (principal is k8s::User, action == k8s::Action::"list", resource is k8s::Resource)
  unless { resource has namespace && resource.namespace == "default" };
permit (principal in k8s::Group::"ops", action, resource)
  when { principal.name == "bob" || resource.resource == "nodes" };
permit (principal, action in [k8s::Action::"get", k8s::Action::"watch"], resource is k8s::Resource)
  when { resource.resource == "secrets" && resource.name != "" && resource.namespace like "ns-*" };
"""

SOURCES = {
    "base": POLICIES,
    "fallback": POLICIES + UNLOWERABLE,
    "lazy": LAZY_POLICIES,
    "kinds": KINDS,
    "synth": synth_source(48, seed=7),
    # cmp, set_has, hard, type_err and hard_err literals, a fallback forbid
    "admission": chip_smoke.ADM_POLICIES + chip_smoke.FALLBACK_POLICY
    + chip_smoke.NATIVE_OPAQUE_POLICY,
}


def sar_body(user="alice", resource="pods", namespace="default", verb="get", name="",
             groups=(), group=""):
    ra = {"verb": verb, "version": "v1", "resource": resource, "namespace": namespace}
    if name:
        ra["name"] = name
    if group:
        ra["group"] = group
    return json.dumps({
        "apiVersion": "authorization.k8s.io/v1",
        "kind": "SubjectAccessReview",
        "spec": {"user": user, "uid": "u", "groups": list(groups), "resourceAttributes": ra},
    }).encode()


def review_body(env=None, uid="r1", name="c", namespace="default"):
    obj = {"apiVersion": "v1", "kind": "ConfigMap",
           "metadata": {"name": name, "namespace": namespace}}
    if env is not None:
        obj["metadata"]["labels"] = {"env": env}
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": uid,
            "operation": "CREATE",
            "userInfo": {"username": "sam", "groups": []},
            "kind": {"group": "", "version": "v1", "kind": "ConfigMap"},
            "resource": {"group": "", "version": "v1", "resource": "configmaps"},
            "namespace": namespace,
            "name": name,
            "object": obj,
        },
    }).encode()


def _traffic():
    """1,100 bodies: SARs over users x resources x namespaces plus
    admission reviews over 3 label states."""
    bodies = []
    users = ["alice", "bob", "carol", "dave"]
    resources = ["pods", "secrets", "services"]
    for i in range(800):
        bodies.append(("authorize", sar_body(user=users[i % 4], resource=resources[(i // 4) % 3],
                                             namespace=f"ns-{i % 7}")))
    envs = ["prod", "heha", None]
    for i in range(300):
        bodies.append(("admit", review_body(env=envs[i % 3], uid=f"r{i}", name=f"c{i}")))
    return bodies


TRAFFIC = _traffic()

# every gate an explain answer can short-circuit at
GATE_BODIES = [
    ("authorize", sar_body("system:kube-scheduler")),
    ("authorize", sar_body("system:serviceaccount:ns:sa", "pods")),
    ("authorize", sar_body("system:node:n1", "secrets")),
    ("authorize", sar_body("system:authorizer:cedar-authorizer", "policies",
                           group="cedar.k8s.aws")),
    ("authorize", b"not json {"),
    ("authorize", b"[1, 2]"),
    ("authorize", b""),
    ("admit", b"not json {"),
    ("admit", b'{"request": 7}'),
    ("admit", review_body(env="prod", namespace="kube-system")),
    ("admit", review_body(env="prod", namespace="cedar-k8s-authz-system")),
    ("admit", json.dumps({"request": {"uid": "x", "operation": "CREATE"}}).encode()),
]


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True)


# --------------------------------------------------------------- stacks


@functools.lru_cache(maxsize=None)
def _t_stack(src_name: str, warm: bool = True):
    """The port's stacks over one source, the CLI's wiring without fast
    paths: CPU engines bound as the stacks' batched backends, each load
    warmed as a server's are (unless ``warm`` is off)."""
    src = SOURCES[src_name]

    def tiers():
        return [PolicySet.from_source(src, FILENAME)]

    engine = TorchPolicyEngine(device="cpu", name="authorization")
    engine.load(tiers(), max_batch=1 if warm else None)
    adm = TorchPolicyEngine(device="cpu", name="admission")
    adm.load(tiers() + [allow_all_admission_policy_store().policy_set()],
             max_batch=1 if warm else None)
    stores = TieredPolicyStores([MemoryStore(FILENAME, tiers()[0])])
    authorizer = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    handler = CedarAdmissionHandler(
        TieredPolicyStores(list(stores.stores) + [allow_all_admission_policy_store()]),
        evaluate_batch=adm.evaluate_batch)
    return types.SimpleNamespace(engine=engine, adm=adm, authorizer=authorizer,
                                 handler=handler, stores=stores, tiers=tiers)


@functools.lru_cache(maxsize=None)
def _j_stack(src_name: str):
    """The JAX package's stacks over the same source (test_explain.py's
    _engine_stack wiring)."""
    src = SOURCES[src_name]

    def tiers():
        return [JPolicySet.from_source(src, FILENAME)]

    engine = TPUPolicyEngine(name="authorization")
    engine.load(tiers(), warm="off")
    adm = TPUPolicyEngine(name="admission")
    adm.load(tiers() + [j_adm.allow_all_admission_policy_store().policy_set()], warm="off")
    stores = JTieredPolicyStores([JMemoryStore(FILENAME, tiers()[0])])
    authorizer = j_auth.CedarWebhookAuthorizer(
        stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
    handler = j_adm.CedarAdmissionHandler(
        JTieredPolicyStores(list(stores.stores) + [j_adm.allow_all_admission_policy_store()]),
        evaluate=adm.evaluate, evaluate_batch=adm.evaluate_batch)
    return types.SimpleNamespace(engine=engine, adm=adm, authorizer=authorizer,
                                 handler=handler, stores=stores, tiers=tiers)


def _open_breakers():
    """A port and a JAX breaker forced open (no half-open within a test)."""
    t = CircuitBreaker(name="explain-host", recovery_s=3600.0)
    j = JCircuitBreaker(name="explain-host", recovery_s=3600.0)
    t.force_open()
    j.force_open()
    return t, j


def _explainers(plane: str, src_name: str):
    """(port Explainer, JAX Explainer) answering through ``plane``."""
    t, j = _t_stack(src_name), _j_stack(src_name)
    if plane == "interpreter":
        return (Explainer(authorizer=t.authorizer, admission_handler=t.handler),
                JExplainer(authorizer=j.authorizer, admission_handler=j.handler))
    tb = jb = tab = jab = None
    if plane == "host":
        tb, jb = _open_breakers()
        tab, jab = _open_breakers()
    return (Explainer(authorizer=t.authorizer, admission_handler=t.handler,
                      authz_engine=t.engine, admission_engine=t.adm,
                      authz_breaker=tb, admission_breaker=tab),
            JExplainer(authorizer=j.authorizer, admission_handler=j.handler,
                       authz_engine=j.engine, admission_engine=j.adm,
                       authz_breaker=jb, admission_breaker=jab))


def _explain(exp, ep: str, body: bytes):
    """One explain answer as comparable JSON-able data."""
    if ep == "authorize":
        return list(exp.explain_authorize(body))
    response, explanation = exp.explain_admit(body)
    return [response.to_admission_review(), explanation]


# ------------------------------------------------------------ explainer

N_CHUNKS = 5


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
@pytest.mark.parametrize("src_name", ["base", "fallback"])
@pytest.mark.parametrize("plane", ["device", "host", "interpreter"])
def test_explainer_equals_jax(plane, src_name, chunk):
    """A fifth of the 1,100 bodies per case (all of them over the chunks):
    the port's explain answers equal JAX's as canonical JSON, each
    labelled with its plane (or the gate it short-circuited at)."""
    t, j = _explainers(plane, src_name)
    n = len(TRAFFIC)
    part = TRAFFIC[chunk * n // N_CHUNKS:(chunk + 1) * n // N_CHUNKS]
    diffs = []
    for ep, body in part:
        got, want = _explain(t, ep, body), _explain(j, ep, body)
        if _canon(got) != _canon(want):
            diffs.append((ep, body, got, want))
        assert got[-1]["source"] in (plane, "gate")
    assert not diffs, diffs[:2]


@pytest.mark.parametrize("plane", ["device", "host", "interpreter"])
def test_gate_answers_equal_jax(plane):
    """The short circuits (system users, the authorizer's self-allows,
    bodies that do not decode or convert, skipped namespaces): the same
    answer and gate label as JAX's."""
    t, j = _explainers(plane, "fallback")
    for ep, body in GATE_BODIES:
        got, want = _explain(t, ep, body), _explain(j, ep, body)
        assert _canon(got) == _canon(want), (ep, body)
    labels = {_explain(t, ep, b)[-1].get("shortCircuit") for ep, b in GATE_BODIES}
    assert {"system-user-skip", "decode-error", "namespace-skip", "authorizer-self-allow",
            "conversion-error"} <= labels


def test_device_explanation_content():
    """The device plane's explanation on the port: determining policy,
    clause tests and spans, as tests/test_explain.py asserts of JAX's."""
    t, _ = _explainers("device", "base")
    decision, _r, err, e = t.explain_authorize(sar_body("carol", "secrets"))
    assert (decision, err, e["source"], e["webhookDecision"]) == ("deny", None, "device", "deny")
    det = e["determining"]
    assert (det["policyId"], det["effect"], det["tier"], det["span"]["file"]) == (
        "policy1", "forbid", 0, FILENAME)
    by_attr = {x["attribute"]: x for x in det["clause"]["tests"]}
    assert by_attr["principal.name"]["value"] == "carol"
    _d, _r, _e, e = t.explain_authorize(sar_body("alice", "pods"))
    assert {d["policyId"] for d in e["reasons"]} == {"policy0", "policy2"}
    _d, _r, _e, e = _explainers("device", "fallback")[0].explain_authorize(
        sar_body("anyone", "pods", verb="list", name="mypod"))
    assert e["fallback"] is True and e["determining"]["unlowerable"]["code"] == "clause_limit"


# ----------------------------------------------------------- attribution


def _sar_items(src_name: str) -> list:
    """(entities, request) pairs of the port and of JAX for the traffic of
    a source: the explain traffic, and the synth corpus' own SARs."""
    from cedar_tpu.server.authorizer import record_to_cedar_resource as j_record
    from cedar_tpu_torch.server.authorizer import record_to_cedar_resource

    bodies = [b for ep, b in TRAFFIC if ep == "authorize"][:200]
    if src_name == "synth":
        bodies += synth_corpus(48, seed=7).sar_bodies(200, seed=3)
    return [(record_to_cedar_resource(get_authorizer_attributes(json.loads(b))),
             j_record(j_attributes(json.loads(b)))) for b in bodies]


def _adm_items(src_name: str) -> list:
    t, j = _t_stack(src_name), _j_stack(src_name)
    bodies = [b for ep, b in TRAFFIC if ep == "admit"][:60]
    if src_name == "admission":
        bodies += chip_smoke.admission_bodies(200, 5)
    out = []
    for b in bodies:
        try:
            tr = AdmissionRequest.from_admission_review(json.loads(b))
            jr = JAdmissionRequest.from_admission_review(json.loads(b))
            out.append((t.handler._build(tr), j.handler._build(jr)))
        except Exception:  # noqa: BLE001 — reviews that do not convert
            continue
    return out


def _jax_literal_test(jcl) -> dict:
    """JAX's literal_test, with a ``like`` test's pattern as its text: the
    JAX payload holds the raw pattern components, which JSON cannot encode
    (the port answers the text; ROADMAP §C)."""
    from cedar_tpu.lang.ast import WILDCARD

    return _like_as_text(j_attr.literal_test(jcl))


def _like_as_text(test: dict) -> dict:
    from cedar_tpu.lang.ast import WILDCARD

    if test["operator"] == "like" and isinstance(test["value"], tuple):
        test["value"] = "".join("*" if c is WILDCARD else c.replace("*", "\\*")
                                for c in test["value"])
        src = f'{test["attribute"]} like "{test["value"]}"'
        test["source"] = f"!({src})" if test["negated"] else src
    return test


def _jax_explanation(doc: dict) -> dict:
    """A JAX explanation with its ``like`` tests as text (_jax_literal_test)."""
    for d in [doc.get("determining")] + list(doc.get("reasons") or ()):
        for test in ((d or {}).get("clause") or {}).get("tests") or ():
            _like_as_text(test)
    return doc


@pytest.mark.parametrize("src_name", sorted(SOURCES))
def test_attribution_helpers_equal_jax(src_name):
    """Every rule clause of both packs renders the same tests
    (literal_test, clause_tests); per request host_sat equals JAX's and
    sat_from_bits over the port's bits plane, which equals JAX's over its
    own; build_explanation and attribution_summary agree."""
    t, j = _t_stack(src_name), _j_stack(src_name)
    satisfied = 0
    for t_eng, j_eng, items in ((t.engine, j.engine, _sar_items(src_name)),
                                (t.adm, j.adm, _adm_items(src_name))):
        tp, jp = t_eng.compiled_set.packed, j_eng._compiled.packed
        assert len(tp.rule_clause) == len(jp.rule_clause)
        n_clauses = 0
        for trc, jrc in zip(tp.rule_clause, jp.rule_clause):
            if jrc.clause is None:
                assert trc.clause is None
                continue
            n_clauses += 1
            assert _canon(t_attr.clause_tests(trc.clause)) == _canon(
                [_jax_literal_test(jcl) for jcl in jrc.clause])
            for tcl, jcl in zip(trc.clause, jrc.clause):
                assert t_attr.literal_test(tcl) == _jax_literal_test(jcl)
        assert n_clauses
        for (te, tq), (je, jq) in items:
            codes, extras = encode_request_codes(tp.plan, tp.table, te, tq)
            jcodes, jextras = j_encode(jp.plan, jp.table, je, jq)
            sat = t_attr.host_sat(tp, codes, extras)
            assert np.array_equal(sat, j_attr.host_sat(jp, jcodes, jextras))
            cs = t_eng.compiled_set
            bits = t_eng.match_bits_arrays(*encode_single(t_eng, cs, te, tq), cs=cs)
            jcs = j_eng._compiled
            jbits = np.asarray(j_eng.match_bits_arrays(*j_encode_single(j_eng, jcs, je, jq), cs=jcs))
            assert np.array_equal(t_attr.sat_from_bits(tp, bits[0]), sat)
            assert np.array_equal(j_attr.sat_from_bits(jp, jbits[0]), sat)
            satisfied += int(sat.any())
            got = t_attr.build_explanation(tp, sat, te, tq, source="host")
            want = j_attr.build_explanation(jp, sat, je, jq, source="host")
            assert (got[0], [(r.policy, r.filename, r.position) for r in got[1].reasons],
                    got[1].errors) == (
                want[0], [(r.policy, r.filename, r.position) for r in want[1].reasons],
                want[1].errors)
            assert _canon(got[2]) == _canon(_jax_explanation(want[2]))
            assert t_attr.attribution_summary(got[2]) == j_attr.attribution_summary(want[2])
    assert satisfied


def test_sat_from_bits_stops_at_the_last_rule():
    """A bits row with every bit set, padding rules included: the decoded
    vector has one entry per packed rule, all set, as JAX's decoder
    gives."""
    for name in ("base", "fallback"):
        t, j = _t_stack(name), _j_stack(name)
        cs = t.engine.compiled_set
        bits = np.full((-(-cs.R // 32),), 0xFFFFFFFF, np.uint32)
        assert cs.R > cs.packed.n_rules
        sat = t_attr.sat_from_bits(cs.packed, bits)
        assert sat.shape == (cs.packed.n_rules,) and sat.all()
        assert np.array_equal(sat, j_attr.sat_from_bits(j.engine._compiled.packed, bits))


# ---------------------------------------------- the non-explain path, cache


@pytest.fixture(scope="module")
def differential_pair():
    """Two in-process port servers over one stack (engines bound into the
    stacks, as tests/test_explain.py wires JAX's), each with a decision
    cache; the second has answered explain requests on both endpoints,
    flagged and clean rows, before anything else."""
    t = _t_stack("fallback")

    def server():
        dc = DecisionCache(generation_fn=lambda: plane_composite(t.stores, t.engine),
                           path="authorization")
        return WebhookServer(t.authorizer, admission_handler=t.handler, decision_cache=dc), dc

    plain, _ = server()
    explained, cache = server()
    for ep, body in TRAFFIC[:6] + TRAFFIC[800:803]:
        doc = (explained.handle_authorize if ep == "authorize" else explained.handle_admit)(
            body, explain=True)
        assert doc["explanation"]["source"] in ("device", "gate")
    stats = dict(cache.stats())
    yield plain, explained, cache, stats
    plain.stop_batchers()
    explained.stop_batchers()


def test_explain_never_fills_the_cache(differential_pair):
    _plain, _explained, cache, stats = differential_pair
    assert (stats["size"], stats["hits"], stats["misses"]) == (0, 0, 0)


@pytest.mark.parametrize("chunk", range(N_CHUNKS))
def test_non_explain_path_byte_identical(differential_pair, chunk):
    """The bare answers of the server whose explain plane ran are those of
    the server that never explained, byte for byte."""
    plain, explained, _cache, _stats = differential_pair
    n = len(TRAFFIC)
    for ep, body in TRAFFIC[chunk * n // N_CHUNKS:(chunk + 1) * n // N_CHUNKS]:
        if ep == "authorize":
            a, b = plain.handle_authorize(body), explained.handle_authorize(body)
        else:
            a, b = plain.handle_admit(body), explained.handle_admit(body)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        assert "explanation" not in b


def test_explain_on_a_warm_cache_bypasses_it(differential_pair):
    """After the sweep filled the cache, an explain request of a cached key
    neither reads nor writes it."""
    _plain, explained, cache, _stats = differential_pair
    assert cache.size() > 0
    before = dict(cache.stats())
    doc = explained.handle_authorize(TRAFFIC[0][1], explain=True)
    assert doc["explanation"]["source"] == "device"
    after = dict(cache.stats())
    assert {k: after[k] for k in ("hits", "misses", "size")} == \
        {k: before[k] for k in ("hits", "misses", "size")}


# ------------------------------------------------------------------ HTTP


def _policy_dir(tmp_path) -> pathlib.Path:
    d = tmp_path / "policies"
    d.mkdir()
    (d / "demo.cedar").write_text(POLICIES + UNLOWERABLE)
    return d


def _port(policy_dir, *flags):
    """The CLI's server on the CPU over a directory store of policy_dir:
    fast paths, breakers, the decision cache at its defaults."""
    cfg = policy_dir.parent / "store-config.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(policy_dir)}}]}}))
    args = make_parser().parse_args([
        "--config", str(cfg), "--device", "cpu", "--insecure", "--secure-port", "0",
        "--metrics-port", "0", "--request-timeout-ms", "60000", *flags])
    srv = build_server(args)
    srv.start()
    return srv


def _jax(policy_dir, engines: bool = True):
    """A JAX server over the same directory: its engines bound into the
    stacks (or none: the interpreter), no injector, no cache."""
    stores = JTieredPolicyStores([JDirectoryPolicyStore(str(policy_dir), start_ticker=False)])
    adm_stores = JTieredPolicyStores([JDirectoryPolicyStore(str(policy_dir), start_ticker=False),
                                      j_adm.allow_all_admission_policy_store()])
    kw, akw = {}, {}
    if engines:
        engine = TPUPolicyEngine(name="authorization")
        engine.load([s.policy_set() for s in stores], warm="off")
        adm = TPUPolicyEngine(name="admission")
        adm.load([s.policy_set() for s in adm_stores], warm="off")
        kw = dict(evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
        akw = dict(evaluate=adm.evaluate, evaluate_batch=adm.evaluate_batch)
    srv = JWebhookServer(j_auth.CedarWebhookAuthorizer(stores, **kw),
                         j_adm.CedarAdmissionHandler(adm_stores, **akw),
                         address="127.0.0.1", port=0, metrics_port=0)
    srv.start()
    return srv


def _post(port, path, body, headers=None):
    """-> (status, decoded body, response headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Length": str(len(body)), **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


HTTP_SARS = [sar_body("carol", "secrets"), sar_body("alice", "pods"),
             sar_body("mallory", "services"), sar_body("anyone", "pods", verb="list", name="p"),
             sar_body("system:kube-scheduler"), b"not json {"]
HTTP_REVIEWS = [review_body(env="prod"), review_body(env="dev", uid="r2"),
                review_body(uid="r3"), review_body(env="prod", namespace="kube-system"),
                b"not json {"]
QUERIES = ["", "?explain=1", "?explain=0", "?explain=false", "?explain=", "?explain=true",
           "?explain=0&explain=1", "?verbose=1"]


def _explains(query: str) -> bool:
    """The JAX server's rule for a query string."""
    from urllib.parse import parse_qs

    vals = parse_qs(query.lstrip("?")).get("explain")
    return bool(vals) and vals[-1] not in ("0", "false", "")


@pytest.fixture(scope="module", params=["device", "interpreter"])
def http_pair(request, tmp_path_factory):
    """A port CLI server (fast paths and cache; or --backend interpreter)
    and a JAX server over one directory."""
    d = tmp_path_factory.mktemp(f"explain-http-{request.param}")
    pdir = _policy_dir(d)
    if request.param == "device":
        t, j = _port(pdir), _jax(pdir)
    else:
        t, j = _port(pdir, "--backend", "interpreter"), _jax(pdir, engines=False)
    yield request.param, t, j
    t.stop()
    j.stop()


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("path", ["/v1/authorize", "/v1/admit"])
def test_http_query_forms_equal_jax(http_pair, path, query):
    """Every query form of ``explain`` on both endpoints: the port's status
    and document equal the JAX server's; an explain answer carries the
    explanation of its plane (or its gate), a bare one none; both answer
    X-Cedar-Trace-Id."""
    plane, t, j = http_pair
    bodies = HTTP_SARS if path == "/v1/authorize" else HTTP_REVIEWS
    for body in bodies:
        st, doc, hdrs = _post(t.bound_port, path + query, body)
        jst, jdoc, jhdrs = _post(j.bound_port, path + query, body)
        assert (st, doc) == (jst, jdoc), (path + query, body)
        assert len(hdrs["X-Cedar-Trace-Id"]) == len(jhdrs["X-Cedar-Trace-Id"]) == 32
        if _explains(query):
            assert doc["explanation"]["source"] in (plane, "gate")
        else:
            assert "explanation" not in doc


# --------------------------------------------------------------- bypasses

N_EXPLAIN_SARS, N_EXPLAIN_REVIEWS = 8, 4


def _counter(family, **labels) -> float:
    key = tuple(sorted(labels.items()))
    with family._lock:
        return float(family._values.get(key, 0.0))


@pytest.fixture(scope="module")
def bypass_window(tmp_path_factory):
    """One explain window on a CLI server with the injector firing on every
    call (behind the non-prod gate), tracing at rate 1, the audit log, the
    recorder and the SLO tracker, bare requests before it; spies count the
    engines' match and bits calls over the window. Yields what was seen
    before and after, and the JAX server's explain answers."""
    d = tmp_path_factory.mktemp("explain-bypass")
    pdir = _policy_dir(d)
    audit, rec = d / "audit.jsonl", d / "recordings"
    t = _port(pdir, "--confirm-non-prod-inject-errors", "--artificial-error-rate", "1e9",
              "--trace-sample-rate", "1", "--audit-log-file", str(audit),
              "--enable-recording", "--recording-dir", str(rec))
    j = _jax(pdir)
    pm = t_metrics.process_metrics()
    sars = [sar_body(u, r) for u in ("alice", "carol", "bob", "dave")
            for r in ("pods", "secrets")][:N_EXPLAIN_SARS]
    reviews = [review_body(env=e, uid=f"e{i}") for i, e in enumerate(("prod", "dev", None,
                                                                        "prod"))]
    try:
        bare = [_post(t.bound_port, "/v1/authorize", b)[1] for b in sars[:2]]
        bare.append(_post(t.bound_port, "/v1/admit", reviews[0])[1])

        def snapshot():
            eng = t.debug_engine()
            return {
                "batches": {p: (eng[p]["pipeline"]["batches_total"], eng[p]["pipeline"]["rows_total"])
                            for p in ("authorization", "admission")},
                "finished": t.tracer.stats()["finished"],
                "audit": audit.read_text().count("\n"),
                "slo": {p: v["5m"]["requests"] for p, v in t.slo.status()["paths"].items()},
                "files": sorted(x.name for x in rec.iterdir()),
                "explain": {p: _counter(pm.explain_requests_total, path=p)
                            for p in ("authorization", "admission")},
                "requests": sum(t.metrics.request_total._values.values()),
                "cache": {k: t.decision_cache.stats()[k] for k in ("hits", "misses", "size")},
            }

        calls = {"match": 0, "bits": 0}
        engines = (t.fastpath.engine, t.admission_fastpath.engine)
        for eng in engines:
            real_match, real_bits = eng.match_arrays_launch, eng.match_bits_arrays

            def match(*a, _real=real_match, **kw):
                calls["match"] += 1
                return _real(*a, **kw)

            def bits(*a, _real=real_bits, **kw):
                calls["bits"] += 1
                return _real(*a, **kw)

            eng.match_arrays_launch, eng.match_bits_arrays = match, bits
        before = snapshot()
        answers = []
        try:
            for i, body in enumerate(sars):
                tp = f"00-{i + 1:032x}-{i + 1:016x}-01"
                answers.append(("/v1/authorize", body, tp,
                                *_post(t.bound_port, "/v1/authorize?explain=1", body,
                                       {"traceparent": tp})))
            for body in reviews:
                answers.append(("/v1/admit", body, None,
                                *_post(t.bound_port, "/v1/admit?explain=1", body)))
        finally:
            for eng in engines:
                del eng.match_arrays_launch, eng.match_bits_arrays
        after = snapshot()
        want = [_post(j.bound_port, path + "?explain=1", body)[1]
                for path, body, *_ in answers]
        yield types.SimpleNamespace(t=t, bare=bare, before=before, after=after,
                                    answers=answers, want=want, calls=calls, audit=audit,
                                    rec=rec, sars=sars, reviews=reviews)
    finally:
        t.stop()
        j.stop()


def test_bypass_injector_armed_for_bare_requests(bypass_window):
    w = bypass_window
    assert [d["status"]["evaluationError"] for d in w.bare[:2]] == ["encountered error"] * 2


def test_bypass_answers_are_real(bypass_window):
    """The injector never sees an explain answer: each equals the JAX
    server's (which has no injector)."""
    w = bypass_window
    for (path, body, _tp, st, doc, _h), want in zip(w.answers, w.want):
        assert st == 200 and doc == want, (path, body)
        assert doc["explanation"]["source"] == "device"


def test_bypass_claims_no_batch(bypass_window):
    assert bypass_window.after["batches"] == bypass_window.before["batches"]


def test_bypass_keeps_no_trace(bypass_window):
    w = bypass_window
    assert w.after["finished"] == w.before["finished"]
    for *_x, hdrs in w.answers:
        assert w.t.tracer.get(hdrs["X-Cedar-Trace-Id"]) is None


def test_bypass_writes_no_audit_line(bypass_window):
    w = bypass_window
    assert w.after["audit"] == w.before["audit"] == 3
    text = w.audit.read_text()
    for *_x, hdrs in w.answers:
        assert hdrs["X-Cedar-Trace-Id"] not in text


def test_bypass_feeds_no_slo_ring(bypass_window):
    assert bypass_window.after["slo"] == bypass_window.before["slo"]
    assert sum(bypass_window.before["slo"].values()) == 3


def test_bypass_records_each_body(bypass_window):
    """The recorder still writes every explain body."""
    w = bypass_window
    new = sorted(set(w.after["files"]) - set(w.before["files"]))
    assert len(new) == len(w.answers)
    bodies = sorted((w.rec / n).read_bytes() for n in new)
    assert bodies == sorted(body for _p, body, *_x in w.answers)


def test_bypass_counts_on_the_explain_family(bypass_window):
    w = bypass_window
    assert w.after["explain"]["authorization"] - w.before["explain"]["authorization"] == \
        N_EXPLAIN_SARS
    assert w.after["explain"]["admission"] - w.before["explain"]["admission"] == \
        N_EXPLAIN_REVIEWS
    assert w.after["requests"] == w.before["requests"]


def test_bypass_one_bits_fetch_and_no_match_launch(bypass_window):
    assert bypass_window.calls == {"match": 0, "bits": len(bypass_window.answers)}


def test_bypass_reads_no_cache(bypass_window):
    assert bypass_window.after["cache"] == bypass_window.before["cache"]


def test_bypass_answers_the_trace_id(bypass_window):
    """X-Cedar-Trace-Id on every explain answer; a sent traceparent's id
    comes back."""
    for _path, _body, tp, _st, _doc, hdrs in bypass_window.answers:
        rid = hdrs["X-Cedar-Trace-Id"]
        assert len(rid) == 32
        if tp:
            assert rid == tp.split("-")[1]


# ------------------------------------------------------------- overload


def _gate_servers(held: int):
    """An in-process port and JAX server (interpreter stacks over the base
    policies) behind gates at max_inflight 4, each holding ``held``
    normal requests in flight."""
    t_st, j_st = _t_stack("base"), _j_stack("base")
    tc = tload.AdmissionController(max_inflight=4)
    jc = jload.AdmissionController(max_inflight=4)
    t = WebhookServer(CedarWebhookAuthorizer(t_st.stores),
                      admission_handler=CedarAdmissionHandler(t_st.handler.stores),
                      address="127.0.0.1", port=0, metrics_port=0, load=tc)
    j = JWebhookServer(j_auth.CedarWebhookAuthorizer(j_st.stores),
                       j_adm.CedarAdmissionHandler(j_st.handler.stores),
                       address="127.0.0.1", port=0, metrics_port=0, load=jc)
    t.start()
    j.start()
    return t, j, tc, jc


def _settle(ctrl, held: int, wait_s: float = 10.0) -> None:
    """Wait until a gate counts only the ``held`` requests in flight: an
    HTTP handler leaves the count after its answer is on the wire."""
    deadline = time.monotonic() + wait_s
    while sum(ctrl.stats()["inflight"].values()) != held:
        assert time.monotonic() < deadline, ctrl.stats()
        time.sleep(0.005)


@pytest.mark.parametrize("explain", [False, True])
@pytest.mark.parametrize("path", ["/v1/authorize", "/v1/admit"])
@pytest.mark.parametrize("held", [0, 2])
def test_explain_sheds_as_sheddable_under_pressure(held, path, explain):
    """At load 0 both are served; at 2 of 4 in flight (pressure) an explain
    request is shed as sheddable and a normal one is served. Status, body
    and Retry-After equal the JAX server's in the same state, through HTTP
    and the serve_* wrappers."""
    t, j, tc, jc = _gate_servers(held)
    body = sar_body("carol", "secrets") if path == "/v1/authorize" else review_body(env="prod")
    q = "?explain=1" if explain else ""
    try:
        with ExitStack() as stack:
            for ctrl in (tc, jc):
                for _ in range(held):
                    stack.enter_context(ctrl.track("authorization", "normal"))
            assert tc.load_state() == jc.load_state() == ("pressure" if held else "ok")
            got = _post(t.bound_port, path + q, body)
            want = _post(j.bound_port, path + q, body)
            assert got[:2] == want[:2]
            assert got[2].get("Retry-After") == want[2].get("Retry-After")
            for ctrl in (tc, jc):
                _settle(ctrl, held)
            serve = "serve_authorize" if path == "/v1/authorize" else "serve_admit"
            assert getattr(t, serve)(body, explain=explain) == getattr(j, serve)(body,
                                                                            explain=explain)
        shed = held and explain
        # the counts (the in-flight gauges settle after the answer is read)
        keys = ("offered", "admitted", "shed", "eval_shed", "shed_by")
        assert {k: tc.stats()[k] for k in keys} == {k: jc.stats()[k] for k in keys}
        assert tc.stats()["shed_by"] == ({"sheddable/load_pressure": 2} if shed else {})
        doc = got[1]
        if shed:
            key = "status" if path == "/v1/authorize" else "response"
            msg = doc[key].get("evaluationError") or doc[key]["status"]["message"]
            assert "request shed under overload (load_pressure)" in msg
            assert got[2]["Retry-After"] == "1"
        else:
            assert ("explanation" in doc) == explain
    finally:
        t.stop(drain_grace_s=0)
        j.stop(drain_grace_s=0)


# ------------------------------------------------ device failure, by design


@pytest.mark.parametrize("path", ["authorize", "admit"])
def test_device_failure_answers_explain_error(monkeypatch, path):
    """A device explain that raises with the breaker closed answers JAX's
    explain-error shape (NoOpinion and the error; the handler's code-500
    review), and the host plane is never asked: no silent re-run (the JAX
    package would answer from its host plane here; ROADMAP §C)."""
    t = _t_stack("base")
    host_calls = []
    real_host_sat = t_explainer.host_sat
    monkeypatch.setattr(t_explainer, "host_sat",
                        lambda *a: host_calls.append(1) or real_host_sat(*a))
    eng = t.engine if path == "authorize" else t.adm

    def lost(*_a, **_kw):
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "match_bits_arrays", lost)
    breaker = CircuitBreaker(name="explain-closed")
    exp = Explainer(authorizer=t.authorizer, admission_handler=t.handler,
                    authz_engine=t.engine, admission_engine=t.adm,
                    authz_breaker=breaker, admission_breaker=breaker)
    gate = j_explainer._gate_explanation("explain-error", error="device lost")
    srv = WebhookServer(t.authorizer, admission_handler=t.handler)
    srv._explainer = exp
    try:
        if path == "authorize":
            got = exp.explain_authorize(sar_body("carol", "secrets"))
            assert _canon(list(got)) == _canon(
                ["no_opinion", "", "evaluation error: device lost", gate])
            doc = srv.handle_authorize(sar_body("carol", "secrets"), explain=True)
            assert doc["status"]["evaluationError"] == "evaluation error: device lost"
            assert doc["explanation"] == gate
        else:
            response, expl = exp.explain_admit(review_body(env="prod"))
            want = j_adm.AdmissionResponse(uid="r1", allowed=True, code=500, error="device lost")
            assert response.to_admission_review() == want.to_admission_review()
            assert expl == gate
            doc = srv.handle_admit(review_body(env="prod"), explain=True)
            assert doc["response"] == want.to_admission_review()["response"]
            assert doc["explanation"] == gate
    finally:
        srv.stop_batchers()
    assert host_calls == []
    assert breaker.state == "closed"


# ------------------------------------------------------------ DiffAttributor

CANDIDATE = POLICIES.replace(
    'forbid (principal is k8s::User, action == k8s::Action::"get"',
    'permit (principal is k8s::User, action == k8s::Action::"get"', 1,
).replace('value: "prod"', 'value: "heha"')
SOURCES["candidate"] = CANDIDATE


def _candidate(stack, engines: bool):
    """A duck-typed rollout candidate over a stack: its engines and tiers,
    or its tiers alone (the interpreter walk)."""
    return types.SimpleNamespace(
        authz_engine=stack.engine if engines else None, tiers=stack.tiers(),
        admission_engine=stack.adm if engines else None, admission_handler=stack.handler)


@pytest.mark.parametrize("case", ["engines", "candidate-tiers", "live-tiers"])
def test_diff_attributor_equals_jax(case):
    """Live and candidate attribution for the explain traffic's SARs and
    reviews, equal to JAX's: both sides compiled, a candidate with no
    engine (its tiers walked by the interpreter), a live side with no
    engine (its tiers)."""
    lt, lj = _t_stack("base"), _j_stack("base")
    ct, cj = _t_stack("candidate"), _j_stack("candidate")
    engines = case != "candidate-tiers"
    live = case != "live-tiers"
    t = DiffAttributor(
        live_authz_engine=lt.engine if live else None,
        live_admission_engine=lt.adm if live else None,
        candidate=_candidate(ct, engines),
        live_authz_tiers=None if live else lt.tiers(),
        live_admission_tiers=None if live else lt.tiers() + [
            allow_all_admission_policy_store().policy_set()])
    j = JDiffAttributor(
        live_authz_engine=lj.engine if live else None,
        live_admission_engine=lj.adm if live else None,
        candidate=_candidate(cj, engines),
        live_authz_tiers=None if live else lj.tiers(),
        live_admission_tiers=None if live else lj.tiers() + [
            j_adm.allow_all_admission_policy_store().policy_set()])
    flips = 0
    for ep, body in TRAFFIC[::4]:
        if ep == "authorize":
            got = t.authorization(get_authorizer_attributes(json.loads(body)))
            want = j.authorization(j_attributes(json.loads(body)))
        else:
            got = t.admission(AdmissionRequest.from_admission_review(json.loads(body)))
            want = j.admission(JAdmissionRequest.from_admission_review(json.loads(body)))
        assert got == want, (ep, body)
        if got and got["live"]["decision"] != got["candidate"]["decision"]:
            flips += 1
    assert flips


# ------------------------------------------------- compiles, families, lazy


def test_explain_compiles_zero_on_a_warmed_set():
    t = _t_stack("base")
    exp = Explainer(authorizer=t.authorizer, admission_handler=t.handler,
                    authz_engine=t.engine, admission_engine=t.adm)
    fam = t_metrics.process_metrics().explain_compiles_total
    before = _counter(fam)
    for ep, body in TRAFFIC[:4] + TRAFFIC[800:802]:
        assert _explain(exp, ep, body)[-1]["source"] == "device"
    assert _counter(fam) == before


def test_explain_compiles_counts_a_cold_set_once():
    """A set that was never warmed: the first explain builds its float
    plane and counts one; the next counts nothing."""
    t = _t_stack("lazy", warm=False)
    assert t.engine.compiled_set._W_f32 is None
    exp = Explainer(authorizer=t.authorizer, authz_engine=t.engine)
    fam = t_metrics.process_metrics().explain_compiles_total
    before = _counter(fam)
    assert exp.explain_authorize(sar_body("alice", "pods"))[3]["source"] == "device"
    assert _counter(fam) == before + 1
    exp.explain_authorize(sar_body("bob", "secrets", verb="list"))
    assert _counter(fam) == before + 1


@pytest.mark.parametrize("name", ["explain_requests_total", "explain_compiles_total"])
def test_explain_families_equal_jax(name):
    tf, jf = getattr(t_metrics.process_metrics(), name), getattr(j_metrics, name)
    assert (tf.name, tf.help, tf.label_names, type(tf).__name__) == \
        (jf.name, jf.help, jf.label_names, type(jf).__name__)


def test_public_names_equal_jax():
    import cedar_tpu.explain as j_explain

    assert t_explain.__all__ == j_explain.__all__


def test_serving_stack_does_not_import_explain():
    """Pay-for-use: the CLI and the server import no explain module."""
    code = ("import sys, cedar_tpu_torch.cli.webhook, cedar_tpu_torch.server.http; "
            "print(sorted(m for m in sys.modules if m.startswith('cedar_tpu_torch.explain')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip() == "[]"
