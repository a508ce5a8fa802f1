"""The port's PDP front end (cedar_tpu_torch/pdp/ and its serving
branches) against the JAX package's cedar_tpu/pdp, on the CPU, at
tolerance 0: every comparison below is exact equality.

  * config: the defaults, a schema file's load and its refusals (unknown
    keys, a bad context_headers, a zero tuple cap, not an object, not
    JSON) as the JAX PdpConfig gives them;
  * mapping: the canonical bytes of encode_pdp_body for seeded ext_authz
    checks and batch tuples of both protocols, with their protocol and
    tenant stamps, equal to the JAX bytes; unmappable requests raise the
    same PdpMappingError;
  * fail posture: every row of docs/pdp.md's matrix (render_check_response
    under both unavailable postures, render_malformed) and the batch
    handler's partial answers and whole-body 400s, document for document;
  * keys: fingerprint_body and FingerprintMemo split on protocol and on
    tenant as the JAX ones do (the native SAR fingerprint pinned);
    classify never classes a PDP body high;
  * metrics and audit: the bounded ``protocol`` label, folded into
    ``other`` at the cap of 8, a SAR-only exposition without a trace of
    it, and audit_entry's ``protocol`` key;
  * serving: protocol_mix on the serial and the pipelined batcher over a
    CPU engine (a SAR, a check and a tuple in one claim); the decision
    cache's independent entries for a check and a byte-identical SAR; a
    tenant-stamped PdpBody on a fused two-tenant engine answered as that
    tenant's own directory answers;
  * over HTTP: the port's CLI server with --pdp-listen on a CPU engine and
    the JAX WebhookServer with the JAX PdpListener over the same seeded
    mixed corpus (chip_smoke.MeshCorpus: k8s, http:* and avp:* permits, an
    interpreter-fallback policy and a header-reading one): the same status
    code and the same JSON bytes for every check and batch body,
    malformed ones included; every answer equal to the port's PdpOracle;
    request counts, audit lines and gated rows by protocol.

The JAX servers here count into the JAX package's process-wide counters
(put back at the end by _jax_counters_restored). Listeners bind port 0.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import pathlib
import random
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from cedar_tpu.cache.fingerprint import FingerprintMemo as JFingerprintMemo
from cedar_tpu.cache.fingerprint import fingerprint_body as j_fingerprint_body
from cedar_tpu.load.admission import classify as j_classify
from cedar_tpu.obs.audit import audit_entry as j_audit_entry
from cedar_tpu.pdp import PdpConfig as JPdpConfig
from cedar_tpu.pdp import PdpListener as JPdpListener
from cedar_tpu.pdp import batch as j_batch
from cedar_tpu.pdp import extauthz as j_ext
from cedar_tpu.pdp import mapper as j_map
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.server.admission import CedarAdmissionHandler as JAdmissionHandler
from cedar_tpu.server.admission import allow_all_admission_policy_store as j_allow_all
from cedar_tpu.server.authorizer import CedarWebhookAuthorizer as JAuthorizer
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch.cache import DecisionCache
from cedar_tpu_torch.cache.fingerprint import FingerprintMemo, fingerprint_body
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import SARFastPath
from cedar_tpu_torch.load.admission import PRIORITY_HIGH, classify
from cedar_tpu_torch.obs.audit import audit_entry
from cedar_tpu_torch.pdp import PdpBody, PdpConfig, PdpListener, PdpMappingError, PdpOracle
from cedar_tpu_torch.pdp import batch as t_batch
from cedar_tpu_torch.pdp import extauthz as t_ext
from cedar_tpu_torch.pdp import mapper as t_map
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.authorizer import DECISION_NO_OPINION, CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.server.sar import sar_response
from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
from cedar_tpu_torch.stores.store import TieredPolicyStores
from cedar_tpu_torch.tenancy import TenantRegistry, fused_tier_stores

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — the mesh corpus of phase 21
from test_torch_cache import _jax_counters_restored  # noqa: E402,F401 — JAX counters put back

SIDES = {
    "port": (PdpConfig, t_map, t_ext, t_batch),
    "jax": (JPdpConfig, j_map, j_ext, j_batch),
}

SAR_BODY = json.dumps({
    "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
    "spec": {"user": "alice", "uid": "u1", "groups": ["dev"],
             "resourceAttributes": {"verb": "get", "version": "v1", "resource": "pods",
                                    "namespace": "default"}},
}, sort_keys=True).encode()
# the JAX package's hard pin of SAR_BODY's canonical fingerprint
SAR_PIN = "aff94bdb4fae452f123f39c0d9cd0e71"


def _both(fn):
    """fn(side) for each package -> {side: result or (exception type
    name, message)}."""
    out = {}
    for side, mods in SIDES.items():
        try:
            out[side] = fn(*mods)
        except Exception as e:  # noqa: BLE001 — compared across packages
            out[side] = (type(e).__name__, str(e))
    return out


# ------------------------------------------------------------------ config

CONFIG_DOCS = [
    {},
    {"principal_header": "X-User", "uid_header": "X-Uid", "groups_header": "X-Groups"},
    {"context_headers": ["X-Request-Id", "X-Tenant-Tier"]},
    {"extauthz_deny_on_unavailable": False},
    {"tenant": "alpha", "batch_max_tuples": 3},
    {"principal_header": "x-a", "uid_header": "x-b", "groups_header": "x-c",
     "context_headers": [], "extauthz_deny_on_unavailable": True, "tenant": "",
     "batch_max_tuples": 1},
]


def test_config_defaults_equal_jax():
    assert dataclasses.asdict(PdpConfig()) == dataclasses.asdict(JPdpConfig())
    assert PdpConfig().batch_max_tuples == 256 and PdpConfig().extauthz_deny_on_unavailable


@pytest.mark.parametrize("doc", CONFIG_DOCS, ids=lambda d: ",".join(d) or "empty")
def test_config_file_loads_as_jax(tmp_path, doc):
    path = tmp_path / "pdp.json"
    path.write_text(json.dumps(doc))
    got = _both(lambda cfg, *_: dataclasses.asdict(cfg.load(str(path))))
    assert got["port"] == got["jax"]
    assert isinstance(got["port"], dict)


CONFIG_REFUSALS = {
    "unknown-key": '{"principal_headr": "x-user"}',
    "unknown-beside-known": '{"tenant": "a", "bogus": 1}',
    "context-not-a-list": '{"context_headers": "x-a"}',
    "zero-cap": '{"batch_max_tuples": 0}',
    "not-an-object": '["x-user"]',
    "not-json": "{principal_header: x}",
}


@pytest.mark.parametrize("name", CONFIG_REFUSALS)
def test_config_refusal_as_jax(tmp_path, name):
    path = tmp_path / "pdp.json"
    path.write_text(CONFIG_REFUSALS[name])
    got = _both(lambda cfg, *_: cfg.load(str(path)))
    assert got["port"] == got["jax"]
    assert isinstance(got["port"], tuple)  # refused on both sides


# ----------------------------------------------------------------- mapping

METHODS = ["GET", "post", "Put", "DELETE", "PATCH", "OPTIONS"]
PATHS = ["/", "/shop/cart", "/api/items/3?q=1", "/docs/ä", "/a//b"]


def _seeded_check(seed: int):
    """(method, path, headers, config kwargs) of one seeded ext_authz
    check: identity, group, context, source and destination headers in
    mixed case, some absent."""
    r = random.Random(f"pdp-check:{seed}")
    headers = {}
    for name, value in (("X-Forwarded-User", r.choice(["alice", "", "system:node:n1"])),
                        ("x-forwarded-uid", "u9"),
                        ("X-Forwarded-Groups", r.choice(["dev", "dev, ops ,", " "])),
                        ("X-Request-Id", f"r{seed}"), ("x-tenant-tier", "gold"),
                        ("X-Forwarded-For", "10.0.0.9"), ("Host", "shop.local"),
                        (":authority", "auth.local")):
        if r.random() < 0.7:
            headers[name] = value
    kwargs = {"context_headers": tuple(r.sample(["X-Request-Id", "x-tenant-tier", "x-absent"],
                                                r.randint(0, 3))),
              "tenant": r.choice(["", "alpha"])}
    return r.choice(METHODS), r.choice(PATHS), headers, kwargs


@pytest.mark.parametrize("seed", range(12))
def test_check_bytes_equal_jax(seed):
    method, path, headers, kwargs = _seeded_check(seed)

    def mapped(cfg, m, ext, _batch):
        body = ext.check_body(method, path, headers, cfg(**kwargs))
        return (bytes(body), body.protocol, body.tenant,
                m.extauthz_to_sar(method, path, headers, cfg(**kwargs)))

    got = _both(mapped)
    assert got["port"] == got["jax"]
    assert got["port"][1:3] == ("extauthz", kwargs["tenant"])


def _seeded_tuple(seed: int) -> dict:
    """One seeded batch tuple: string and object entity forms, groups and
    context values of several JSON types."""
    r = random.Random(f"pdp-tuple:{seed}")
    entry = {
        "principal": r.choice(["App::User::alice", {"entityType": "App::User", "entityId": "bob"},
                               {"entityId": "carol"}]),
        "action": r.choice(["viewPhoto", {"actionType": "Action", "actionId": "edit"},
                            {"actionId": "share"}]),
        "resource": r.choice(["photos/v.jpg", "/docs/d1", {"entityType": "Doc", "entityId": "d2"}]),
    }
    if r.random() < 0.7:
        entry["context"] = {k: v for k, v in (
            ("ip", "10.0.0.9"), ("n", 7), ("ok", True), ("nested", {"b": [1, 2], "a": None}),
            ("list", ["x", {"y": 1}]), ("Upper", "v")) if r.random() < 0.6}
    if r.random() < 0.5:
        entry["groups"] = r.sample(["dev", "ops", 7], r.randint(0, 3))
    return entry


@pytest.mark.parametrize("seed", range(12))
def test_tuple_bytes_equal_jax(seed):
    entry = _seeded_tuple(seed)
    tenant = "beta" if seed % 3 == 0 else ""

    def mapped(cfg, m, _ext, _batch):
        body = m.encode_pdp_body(m.batch_tuple_to_sar(entry, cfg(tenant=tenant)),
                                 m.PROTOCOL_BATCH, cfg(tenant=tenant))
        return bytes(body), body.protocol, body.tenant

    got = _both(mapped)
    assert got["port"] == got["jax"]
    assert got["port"][1:] == ("batch", tenant)


UNMAPPABLE = {
    "check-no-method": ("check", ("", "/x", {})),
    "check-relative-path": ("check", ("GET", "x", {})),
    "check-empty-path": ("check", ("GET", "", {})),
    "tuple-not-object": ("tuple", ["principal"]),
    "tuple-empty-principal": ("tuple", {"principal": "", "action": "a", "resource": "r"}),
    "tuple-no-entity-id": ("tuple", {"principal": {"entityType": "T"}, "action": "a",
                                     "resource": "r"}),
    "tuple-number-resource": ("tuple", {"principal": "p", "action": "a", "resource": 3}),
    "tuple-context-list": ("tuple", {"principal": "p", "action": "a", "resource": "r",
                                     "context": ["x"]}),
    "tuple-groups-string": ("tuple", {"principal": "p", "action": "a", "resource": "r",
                                      "groups": "dev"}),
}


@pytest.mark.parametrize("name", UNMAPPABLE)
def test_unmappable_raises_as_jax(name):
    kind, arg = UNMAPPABLE[name]
    if kind == "check":
        got = _both(lambda cfg, m, *_: m.extauthz_to_sar(*arg, cfg()))
    else:
        got = _both(lambda cfg, m, *_: m.batch_tuple_to_sar(arg, cfg()))
    assert got["port"] == got["jax"]
    assert got["port"][0] == "PdpMappingError"


# ------------------------------------------------------------ fail posture

SAR_ANSWERS = {
    "allow": {"status": {"allowed": True, "reason": '{"reasons":[{"policy":"policy0"}]}'}},
    "deny": {"status": {"allowed": False, "denied": True, "reason": "denied by policy"}},
    "no-opinion": {"status": {"allowed": False, "reason": ""}},
    "evaluation-error": {"status": {"allowed": False, "evaluationError": "engine down"}},
    "shed": {"status": {"allowed": False, "evaluationError": "request shed under overload"}},
    "empty-error": {"status": {"allowed": True, "evaluationError": ""}},
    "no-status": {},
}


@pytest.mark.parametrize("deny_on_unavailable", [True, False], ids=["deny-posture", "allow-posture"])
@pytest.mark.parametrize("name", SAR_ANSWERS)
def test_check_posture_as_jax(name, deny_on_unavailable):
    got = _both(lambda cfg, _m, ext, _b: ext.render_check_response(
        SAR_ANSWERS[name], cfg(extauthz_deny_on_unavailable=deny_on_unavailable)))
    assert got["port"] == got["jax"]
    status, doc = got["port"]
    if name == "allow":
        assert (status, doc["decision"]) == (200, "allow")
    elif "evaluationError" in SAR_ANSWERS[name].get("status", {}):
        assert status == (403 if deny_on_unavailable else 200)
        assert doc.get("degraded", False) is not deny_on_unavailable
    else:
        assert (status, doc["decision"]) == (403, "deny")


def test_malformed_check_denies_on_either_posture_as_jax():
    got = _both(lambda _c, m, ext, _b: ext.render_malformed(m.PdpMappingError("no principal")))
    assert got["port"] == got["jax"] == (403, {"decision": "deny",
                                               "reason": "unmappable request: no principal"})


def _serve_stub(body) -> dict:
    """A deterministic serving stand-in: a tuple answers by its principal
    (boom raises, err errs, d denies, anything else is allowed)."""
    user = json.loads(body)["spec"]["user"]
    if user.endswith("boom"):
        raise RuntimeError("engine down")
    if user.endswith("err"):
        return {"status": {"allowed": False, "evaluationError": "deadline exceeded"}}
    if user.endswith("::d"):
        return {"status": {"allowed": False, "denied": True,
                           "reason": '{"reasons":[{"policy":"forbid1"}]}'}}
    return {"status": {"allowed": True, "reason": '{"reasons":[{"policy":"policy3"}]}'}}


def _tuple(user, **kw):
    return {"principal": f"App::User::{user}", "action": "view", "resource": "r", **kw}


BATCH_BODIES = {
    "partial-eval-error": json.dumps({"requests": [_tuple("a"), _tuple("boom"), _tuple("b")]}),
    "malformed-tuple": json.dumps({"requests": [_tuple("a"), {"principal": ""}, 3, _tuple("d")]}),
    "errored-tuple": json.dumps({"requests": [_tuple("err"), _tuple("d"), _tuple("x")]}),
    "at-cap": json.dumps({"requests": [_tuple(f"u{i}") for i in range(4)]}),
    "over-cap": json.dumps({"requests": [_tuple(f"u{i}") for i in range(5)]}),
    "unparseable": "{not json",
    "missing-requests": '{"nope": []}',
    "requests-not-list": '{"requests": {"a": 1}}',
    "empty-requests": '{"requests": []}',
    "not-an-object": "[1, 2]",
}


@pytest.mark.parametrize("name", BATCH_BODIES)
def test_batch_handler_as_jax(name):
    raw = BATCH_BODIES[name].encode()
    with ThreadPoolExecutor(max_workers=4) as pool:
        got = _both(lambda cfg, _m, _e, batch: batch.handle_batch(
            _serve_stub, raw, cfg(batch_max_tuples=4), pool))
    assert got["port"] == got["jax"]
    status, doc = got["port"]
    if name in ("over-cap", "unparseable", "missing-requests", "requests-not-list",
                "empty-requests", "not-an-object"):
        assert status == 400 and set(doc) == {"error"}
    else:
        assert status == 200
        assert [r["index"] for r in doc["responses"]] == list(range(len(json.loads(raw)["requests"])))


# -------------------------------------------------------- keys and classes

STAMPS = {
    "none": None,
    "extauthz": ("extauthz", ""),
    "batch": ("batch", ""),
    "extauthz-alpha": ("extauthz", "alpha"),
    "batch-beta": ("batch", "beta"),
    "tenant-only": ("", "alpha"),
}


def _stamped(pkg_map, body: bytes, stamp):
    return body if stamp is None else pkg_map.PdpBody(body, stamp[0], tenant=stamp[1])


@pytest.mark.parametrize("stamp", STAMPS)
def test_fingerprint_equal_jax(stamp):
    cfg = PdpConfig()
    bodies = [SAR_BODY, bytes(t_ext.check_body("GET", "/shop/cart", {"x-forwarded-user": "a"}, cfg)),
              bytes(t_map.encode_pdp_body(t_map.batch_tuple_to_sar(_tuple("a"), cfg), "batch", cfg))]
    for body in bodies:
        assert fingerprint_body("authorize", _stamped(t_map, body, STAMPS[stamp])) == \
            j_fingerprint_body("authorize", _stamped(j_map, body, STAMPS[stamp]))


def test_fingerprints_split_on_protocol_and_tenant():
    keys = {name: fingerprint_body("authorize", _stamped(t_map, SAR_BODY, st))
            for name, st in STAMPS.items()}
    assert keys["none"] == SAR_PIN
    assert len(set(keys.values())) == len(STAMPS)


def test_memo_splits_rows_as_jax():
    """One raw body under every stamp through one memo per package: the
    same keys, each stamp its own row, repeats answering their own row."""
    memo, jmemo = FingerprintMemo(), JFingerprintMemo()
    for _ in range(2):
        got = [memo.fingerprint("authorize", _stamped(t_map, SAR_BODY, st)) for st in STAMPS.values()]
        want = [jmemo.fingerprint("authorize", _stamped(j_map, SAR_BODY, st))
                for st in STAMPS.values()]
        assert got == want and len(set(got)) == len(STAMPS)


CLASSIFY_BODIES = {
    "kubelet-user": b'{"spec": {"user": "system:node:node-1"}}',
    "nodes-group": b'{"spec": {"groups": ["system:nodes"]}}',
    "scheduler": b'{"spec": {"user": "system:kube-scheduler"}}',
    "controller": b'{"spec": {"user": "controller-a"}}',
    "mapped-check": bytes(t_ext.check_body(
        "GET", "/x", {"x-forwarded-user": "system:node:node-1",
                      "x-forwarded-groups": "system:nodes"}, PdpConfig())),
}


@pytest.mark.parametrize("name", CLASSIFY_BODIES)
def test_pdp_body_never_classed_high(name):
    raw = CLASSIFY_BODIES[name]
    assert classify("authorization", raw) == j_classify("authorization", raw)
    for proto in ("extauthz", "batch"):
        got = classify("authorization", PdpBody(raw, proto))
        assert got == j_classify("authorization", j_map.PdpBody(raw, proto))
        assert got != PRIORITY_HIGH


# ------------------------------------------------------- metrics and audit


def test_protocol_free_exposition_byte_identical(monkeypatch):
    """SAR-only traffic: a counter driven without the extra label and one
    driven with an empty one collect alike, and a server's whole
    exposition holds no protocol label and no overflow family until a
    protocol was recorded in the process."""
    a = t_metrics.Counter("t_total", "h", ["decision"])
    b = t_metrics.Counter("t_total", "h", ["decision"])
    a.inc(decision="Allow")
    b.inc(decision="Allow", extra=())
    assert a.collect() == b.collect()
    monkeypatch.setattr(t_metrics._PROCESS, "_protocol_labels", set())
    m = t_metrics.WebhookMetrics()
    m.record_request("Allow", 0.002)
    m.record_request("NoOpinion", 0.3)
    text = m.expose()
    assert "protocol" not in text
    plain = t_metrics.WebhookMetrics()
    plain.request_total.inc(decision="Allow")
    plain.request_total.inc(decision="NoOpinion")
    plain.request_latency.observe(0.002, decision="Allow")
    plain.request_latency.observe(0.3, decision="NoOpinion")
    assert text == plain.expose()
    m.record_request("Allow", 0.002, protocol="extauthz")
    assert "cedar_protocol_label_overflow_total" in m.expose()


def test_protocol_label_appended_as_jax(monkeypatch):
    """A PDP request's series carry the protocol label after the decision,
    line for line as the JAX families render them."""
    monkeypatch.setattr(t_metrics._PROCESS, "_protocol_labels", set())
    m = t_metrics.WebhookMetrics()
    jc = j_metrics.Counter(m.request_total.name, m.request_total.help, ["decision"])
    jh = j_metrics.Histogram(m.request_latency.name, m.request_latency.help, ["decision"],
                             m.request_latency.buckets)
    for decision, lat, proto in (("Allow", 0.01, "extauthz"), ("Deny", 0.6, "batch"),
                                 ("Allow", 0.02, ""), ("<error>", 2.0, "extauthz")):
        m.record_request(decision, lat, protocol=proto)
        extra = (("protocol", proto),) if proto else ()
        jc.inc(decision=decision, extra=extra)
        jh.observe(lat, decision=decision, extra=extra)
    assert m.request_total.collect() == jc.collect()
    assert m.request_latency.collect() == jh.collect()
    assert 'cedar_authorizer_request_total{decision="Allow",protocol="extauthz"} 1' in \
        m.request_total.collect()


def test_label_cap_folds_to_other_as_jax(monkeypatch):
    monkeypatch.setattr(t_metrics._PROCESS, "_protocol_labels", set())
    saved = set(j_metrics._protocol_labels)
    j_metrics._protocol_labels.clear()
    overflow = t_metrics._PROCESS.protocol_label_overflow_total
    before = overflow.value()
    try:
        assert t_metrics._PROTOCOL_LABEL_CAP == j_metrics._PROTOCOL_LABEL_CAP == 8
        names = [f"p{i}" for i in range(8)] + ["p-new", "p0", "other", "p-newer"]
        got = [t_metrics._protocol_label_for(n) for n in names]
        assert got == [j_metrics._protocol_label_for(n) for n in names]
        assert got[8:] == ["other", "p0", "other", "other"]
        assert overflow.value() - before == 2
    finally:
        j_metrics._protocol_labels.clear()
        j_metrics._protocol_labels.update(saved)


AUDIT_CASES = [("", ""), ("extauthz", ""), ("batch", "alpha"), ("", "beta")]


@pytest.mark.parametrize("protocol,tenant", AUDIT_CASES,
                         ids=[f"{p or 'sar'}-{t or 'single'}" for p, t in AUDIT_CASES])
def test_audit_entry_as_jax(protocol, tenant):
    kw = dict(path="authorization", trace_id="t", fingerprint="f", decision="Allow",
              reason='{"reasons":[{"policy":"policy0"}]}', latency_s=0.001, tenant=tenant,
              protocol=protocol)
    got, want = audit_entry(**kw), j_audit_entry(**kw)
    got.pop("ts"), want.pop("ts")
    assert got == want
    assert ("protocol" in got) == bool(protocol)  # absent, not empty, for a SAR


# ---------------------------------------------------------------- serving

MESH_N = 240
MESH_SEED = 3


@pytest.fixture(scope="module")
def mesh():
    return chip_smoke.MeshCorpus(MESH_N, MESH_SEED)


def _cpu_stack(source: str, pipeline_depth: int, window_s: float, **kw) -> WebhookServer:
    from cedar_tpu_torch.stores.store import MemoryStore

    stores = TieredPolicyStores([MemoryStore.from_source("mesh", source)])
    engine = TorchPolicyEngine(device="cpu")
    engine.load([s.policy_set() for s in stores])
    authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    return WebhookServer(authz, fastpath=SARFastPath(engine, authz), pipeline_depth=pipeline_depth,
                         batch_window_s=window_s, **kw)


@pytest.mark.parametrize("depth", [0, 2], ids=["serial", "pipelined"])
def test_batcher_tallies_protocol_mix(mesh, depth):
    """A SAR, a check and a tuple submitted together through
    serve_authorize land in one claim: its signature names all three,
    as the JAX batcher names them."""
    srv = _cpu_stack(mesh.source, depth, 0.2)
    cfg = PdpConfig()
    bodies = [mesh.sar(0), t_ext.check_body(*mesh.check(0), cfg),
              t_map.encode_pdp_body(t_map.batch_tuple_to_sar(mesh.tuples(0, 1)[0], cfg),
                                    "batch", cfg)]
    gate = threading.Barrier(len(bodies))
    answers = [None] * len(bodies)

    def submit(i):
        gate.wait()
        answers[i] = srv.serve_authorize(bodies[i])

    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        mix = srv._batcher.debug_stats()["protocol_mix"]
    finally:
        srv.stop_batchers()
    assert mix == {"batch,extauthz,sar": 1}
    oracle = PdpOracle(srv.authorizer.stores)
    for body, doc in zip(bodies, answers):
        assert doc == sar_response(*oracle.authorize_body(body))


def test_cross_protocol_cache_isolation(mesh):
    """A check and a SAR with the same bytes: two misses and two entries,
    no cross-protocol hit; repeats hit their own entries."""
    cache = DecisionCache()
    srv = _cpu_stack(mesh.source, 2, 0.0002, decision_cache=cache)
    try:
        listener = PdpListener(config=PdpConfig())
        listener.bind(srv)
        method, path, headers = "GET", mesh.mesh_paths[0], {"x-forwarded-user": mesh.mesh_users[0]}
        sar = bytes(t_ext.check_body(method, path, headers, listener.config))
        first = (listener.check(method, path, headers), srv.serve_authorize(sar))
        assert (cache.stats()["misses"], cache.stats()["hits"]) == (2, 0)
        again = (listener.check(method, path, headers), srv.serve_authorize(sar))
        assert (cache.stats()["misses"], cache.stats()["hits"]) == (2, 2)
        assert first == again
    finally:
        listener.stop()
        srv.stop_batchers()


TENANTS = ("alpha", "beta")


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """Two tenants' mesh corpora, each a directory, fused into one CPU
    engine behind its SARFastPath; each tenant's own directory behind a
    PdpOracle."""
    root = tmp_path_factory.mktemp("pdp-tenants")
    reg = TenantRegistry()
    corpora, oracles = {}, {}
    for i, t in enumerate(TENANTS):
        corpora[t] = chip_smoke.MeshCorpus(120, seed=11 + i)
        d = root / t
        d.mkdir()
        (d / "mesh.cedar").write_text(corpora[t].source)
        reg.add_tenant(t, stores=TieredPolicyStores([DirectoryPolicyStore(str(d),
                                                                          start_ticker=False)]))
        oracles[t] = PdpOracle(TieredPolicyStores([DirectoryPolicyStore(str(d),
                                                                        start_ticker=False)]))
    engine = TorchPolicyEngine(device="cpu", incremental=True)
    engine.load(reg.fused_tiers())
    authz = CedarWebhookAuthorizer(fused_tier_stores(reg), evaluate_batch=engine.evaluate_batch)
    fast = SARFastPath(engine, authz)
    bodies = {}
    for t in TENANTS:
        cfg = PdpConfig(tenant=t, context_headers=(chip_smoke.PDP_HEADER,))
        out = []
        for c in corpora.values():  # the neighbour's traffic too
            out += [t_ext.check_body(*c.check(i), cfg) for i in range(48)]
            out += [t_map.encode_pdp_body(t_map.batch_tuple_to_sar(tp, cfg), "batch", cfg)
                    for tp in c.tuples(0, 32)]
        bodies[t] = out
    return {"fast": fast, "authz": authz, "oracles": oracles, "bodies": bodies}


def _canon(decision: str, reason: str) -> tuple:
    return decision, sorted(json.dumps(r, sort_keys=True)
                            for r in (json.loads(reason)["reasons"] if reason else []))


@pytest.mark.parametrize("tenant", TENANTS)
def test_tenant_pdp_body_answers_as_its_own_directory(fused, tenant):
    """A PdpBody stamped with a tenant (PdpConfig.tenant) through the
    fused plane: the fast path's tenant column reads body.tenant, and
    every answer equals the tenant's own directory's, gated rows
    included."""
    bodies = fused["bodies"][tenant]
    gated0 = fused["fast"].routing["gated"]
    got = [_canon(d, r) for d, r, _e in fused["fast"].authorize_raw(bodies)]
    want = [_canon(*fused["oracles"][tenant].authorize_body(b)) for b in bodies]
    assert got == want
    assert fused["fast"].routing["gated"] > gated0
    assert sum(d == "allow" for d, _ in got) > len(got) // 4


def test_tenants_answer_the_same_bytes_differently(fused):
    """The same mapped bytes stamped for each tenant, and unstamped: the
    tenants answer some differently, and an unstamped row matches no
    tenant's rules."""
    a = fused["fast"].authorize_raw(fused["bodies"]["alpha"])
    b = fused["fast"].authorize_raw([PdpBody(bytes(x), x.protocol, tenant="beta")
                                     for x in fused["bodies"]["alpha"]])
    assert sum(x[0] != y[0] for x, y in zip(a, b)) >= 16
    none = fused["fast"].authorize_raw([PdpBody(bytes(x), x.protocol)
                                        for x in fused["bodies"]["alpha"]])
    assert all(d == DECISION_NO_OPINION and not r for d, r, e in none if e is None)


def test_tenant_listener_through_the_server(fused, mesh):
    """A listener whose schema names a tenant, bound to a server over the
    fused fast path: its checks answer as that tenant's directory."""
    srv = WebhookServer(fused["authz"], fastpath=fused["fast"], pipeline_depth=2)
    cfg = PdpConfig(tenant="beta", context_headers=(chip_smoke.PDP_HEADER,))
    listener = PdpListener(config=cfg)
    listener.bind(srv)
    try:
        corpus = chip_smoke.MeshCorpus(120, seed=12)
        for i in range(24):
            check = corpus.check(i, stream="via-server")
            want = t_ext.render_check_response(sar_response(
                *fused["oracles"]["beta"].authorize_body(t_ext.check_body(*check, cfg))), cfg)
            assert listener.check(*check) == want
    finally:
        listener.stop()
        srv.stop_batchers()


# ------------------------------------------------------------ over HTTP

PDP_CAP = 32


def _pdp_request(port: int, method: str, path: str, headers=None, body=None):
    """One request on a fresh connection -> (status, raw body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _batch_raw(mesh, i: int) -> bytes:
    tuples = mesh.tuples(i, 12)
    if i % 3 == 1:  # a malformed tuple among answered neighbours
        tuples[4] = {"principal": "", "action": "view", "resource": "docs/d0"}
    return json.dumps({"requests": tuples}).encode()


HTTP_BATCH_KINDS = {
    "unparseable": b"{nope",
    "missing-requests": b'{"req": []}',
    "over-cap": json.dumps({"requests": [{"principal": "p", "action": "a", "resource": "r"}]
                            * (PDP_CAP + 1)}).encode(),
    "empty": b'{"requests": []}',
}
N_CHECKS = 96
N_BATCHES = 9


@pytest.fixture(scope="module")
def servers(mesh, tmp_path_factory):
    """The port's CLI server (--pdp-listen on port 0, a --pdp-schema file,
    a CPU engine, the decision cache and an audit log) and the JAX
    WebhookServer with the JAX PdpListener, both over one directory of
    the mesh corpus; every check and batch body sent to both over HTTP."""
    tmp = tmp_path_factory.mktemp("pdp-http")
    pdir = tmp / "policies"
    pdir.mkdir()
    (pdir / "mesh.cedar").write_text(mesh.source)
    schema = {"context_headers": [chip_smoke.PDP_HEADER], "batch_max_tuples": PDP_CAP}
    (tmp / "pdp.json").write_text(json.dumps(schema))
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(pdir)}}]}}))
    audit = tmp / "audit.jsonl"
    args = make_parser().parse_args([
        "--config", str(cfg), "--insecure", "--device", "cpu", "--secure-port", "0",
        "--metrics-port", "0", "--pdp-listen", "127.0.0.1:0", "--pdp-schema",
        str(tmp / "pdp.json"), "--audit-log-file", str(audit)])
    port_srv = build_server(args)
    port_srv.start()
    jstores = JTieredPolicyStores([JDirectoryPolicyStore(str(pdir))])
    jadm = JTieredPolicyStores([JDirectoryPolicyStore(str(pdir)), j_allow_all()])
    jlistener = JPdpListener(config=JPdpConfig.from_dict(schema), port=0)
    jsrv = JWebhookServer(JAuthorizer(jstores), JAdmissionHandler(jadm), pdp=jlistener)
    jlistener.start()
    out = {"port_srv": port_srv, "audit": audit, "schema": schema, "sent": {}}
    try:
        ports = {"port": port_srv.pdp.bound_port, "jax": jlistener.bound_port}
        checks = [mesh.check(i, stream="http") for i in range(N_CHECKS)]
        checks.append(("OPTIONS", "*", {"x-forwarded-user": "alice", "host": "mesh.local"}))
        batches = [_batch_raw(mesh, i) for i in range(N_BATCHES)]
        batches += list(HTTP_BATCH_KINDS.values())
        answers = {}
        for side, p in ports.items():
            answers[side] = {
                "checks": [_pdp_request(p, m, path, headers) for m, path, headers in checks],
                "batches": [_pdp_request(p, "POST", "/v1/batch-authorize",
                                         {"Content-Type": "application/json"}, raw)
                            for raw in batches],
            }
        out.update(checks=checks, batches=batches, answers=answers)
        out["metrics"] = port_srv.metrics.expose()
        out["routing"] = dict(port_srv.fastpath.routing)
        out["mix"] = port_srv._batcher.debug_stats()["protocol_mix"]
        yield out
    finally:
        port_srv.stop()
        jsrv.stop()


@pytest.mark.parametrize("part", range(4))
def test_checks_over_http_equal_jax(servers, part):
    """A quarter of the checks each: the same status and the same JSON
    bytes from both listeners."""
    n = len(servers["checks"])
    sl = slice(part * n // 4, (part + 1) * n // 4)
    got, want = servers["answers"]["port"]["checks"][sl], servers["answers"]["jax"]["checks"][sl]
    assert got == want
    assert {s for s, _ in got} <= {200, 403}


@pytest.mark.parametrize("i", range(N_BATCHES + len(HTTP_BATCH_KINDS)),
                         ids=[f"mesh{i}" for i in range(N_BATCHES)] + list(HTTP_BATCH_KINDS))
def test_batch_over_http_equal_jax(servers, i):
    got = servers["answers"]["port"]["batches"][i]
    assert got == servers["answers"]["jax"]["batches"][i]
    if i >= N_BATCHES:
        assert got[0] == 400
    else:
        doc = json.loads(got[1])
        assert got[0] == 200 and len(doc["responses"]) == 12
        if i % 3 == 1:
            assert doc["responses"][4]["decision"] == "DENY" and doc["responses"][4]["errors"]


def test_http_answers_equal_the_oracle(servers):
    """Every check and tuple the port served, held to its PdpOracle: the
    interpreter over the same directory, uncached."""
    cfg = PdpConfig.from_dict(servers["schema"])
    oracle = PdpOracle(servers["port_srv"].authorizer.stores)
    for (method, path, headers), (status, raw) in zip(servers["checks"],
                                                      servers["answers"]["port"]["checks"]):
        try:
            body = t_ext.check_body(method, path, headers, cfg)
        except PdpMappingError as e:
            want = t_ext.render_malformed(e)
        else:
            want = t_ext.render_check_response(sar_response(*oracle.authorize_body(body)), cfg)
        assert (status, json.loads(raw)) == want
    for raw_in, (status, raw) in zip(servers["batches"][:N_BATCHES],
                                     servers["answers"]["port"]["batches"]):
        with ThreadPoolExecutor(max_workers=4) as pool:
            want = t_batch.handle_batch(
                lambda b: sar_response(*oracle.authorize_body(b)), raw_in, cfg, pool)
        assert (status, json.loads(raw)) == want


def test_request_total_counts_each_protocol(servers):
    """cedar_authorizer_request_total by protocol equals what reached
    serve_authorize: every mappable check and every mappable tuple."""
    text = servers["metrics"]
    counts = {}
    for line in text.splitlines():
        if line.startswith("cedar_authorizer_request_total{") and "protocol=" in line:
            proto = line.split('protocol="')[1].split('"')[0]
            counts[proto] = counts.get(proto, 0) + float(line.rsplit(" ", 1)[1])
    tuples = sum(1 for raw in servers["batches"][:N_BATCHES]
                 for t in json.loads(raw)["requests"] if t.get("principal"))
    assert counts == {"extauthz": float(N_CHECKS), "batch": float(tuples)}


def test_audit_lines_carry_protocol(servers):
    lines = [json.loads(x) for x in servers["audit"].read_text().splitlines()]
    by = {}
    for e in lines:
        by[e.get("protocol", "")] = by.get(e.get("protocol", ""), 0) + 1
    assert by.get("extauthz") == N_CHECKS and by.get("batch", 0) > 0 and "" not in by


def test_pdp_rows_reach_the_engine_and_its_gated_lane(servers):
    """The port's checks and tuples went through the fast path: clean rows
    to the words launch, the joiners' POSTs to the gated lane; the
    batcher's claims name only PDP protocols here."""
    assert servers["routing"]["gated"] > 0 and servers["routing"]["clean_native"] > 0
    assert servers["mix"] and all(set(sig.split(",")) <= {"extauthz", "batch"}
                                  for sig in servers["mix"])


def test_listener_stops_with_the_server(mesh):
    """WebhookServer.start() starts the bound listener and stop() closes
    it, after the webhook's listeners and before the batchers."""
    srv = _cpu_stack(mesh.source, 2, 0.0002, port=0, metrics_port=0,
                     pdp=PdpListener(config=PdpConfig()))
    srv.start()
    port = srv.pdp.bound_port
    status, raw = _pdp_request(port, "GET", mesh.mesh_paths[0],
                               {"x-forwarded-user": mesh.mesh_users[0]})
    assert status in (200, 403) and json.loads(raw)["decision"] in ("allow", "deny")
    srv.stop()
    assert srv.pdp.bound_port is None
    with pytest.raises(OSError):
        _pdp_request(port, "GET", "/x")
