"""The port's chaos plane (cedar_tpu_torch/chaos and the server's
/chaos/* and /debug/chaos endpoints) against the JAX package's, on the
CPU, at tolerance 0.

Held equal: the seam catalogue and rule kinds; for the same scenario and
seed, the fired call indices per seam, the payloads after ``corrupt`` and
``response_*`` rules and the registries' stats() documents; which
scenario documents load_scenario accepts and rejects (and the normalized
documents it returns); every builtin scenario; and 1000 SubjectAccessReview
answers of a port server whose registry is configured but disarmed
against the JAX server's, byte for byte. The control endpoints answer
403 without the non-prod gate and round-trip configure -> arm -> inject
-> disarm with it.
"""

import json
import random
import time
import urllib.error
import urllib.request

import pytest

from cedar_tpu.chaos import registry as j_reg
from cedar_tpu.chaos import scenario as j_scn
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores import store as j_store
from cedar_tpu_torch.chaos import registry as t_reg
from cedar_tpu_torch.chaos import scenario as t_scn
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import SARFastPath
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.server.metrics import WebhookMetrics, process_metrics
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

POLICIES = """
permit (principal, action in [k8s::Action::"get", k8s::Action::"list"],
        resource is k8s::Resource)
  when { principal.name == "test-user" && resource.resource == "pods" };
permit (principal in k8s::Group::"dev", action == k8s::Action::"get",
        resource is k8s::Resource)
  when { resource.resource == "configmaps" };
forbid (principal, action == k8s::Action::"delete", resource is k8s::Resource)
  when { resource.resource == "secrets" };
"""


@pytest.fixture(autouse=True)
def _pristine_registries():
    t_reg.default_registry().reset()
    j_reg.default_registry().reset()
    yield
    t_reg.default_registry().reset()
    j_reg.default_registry().reset()


def test_catalogue_and_kinds_equal_jax():
    assert t_reg.SEAMS == j_reg.SEAMS
    assert t_reg._KINDS == j_reg._KINDS
    assert t_reg.RESPONSE_SEAM == j_reg.RESPONSE_SEAM
    assert t_scn.DEFAULT_SLO == j_scn.DEFAULT_SLO


# (scenario, [(seam, payload) calls in order])
SCHEDULES = {
    "after-count": (
        {"seed": 1, "faults": [{"seam": "engine.dispatch", "kind": "error", "after": 3,
                                "count": 4}]},
        [("engine.dispatch", None)] * 12),
    "probability": (
        {"seed": 42, "faults": [{"seam": "engine.decode", "kind": "error",
                                 "probability": 0.3}]},
        [("engine.decode", None)] * 60),
    "two-seams-interleaved": (
        {"seed": 5, "faults": [
            {"seam": "pipeline.decode_q", "kind": "kill", "after": 2, "count": 1},
            {"seam": "engine.encode", "kind": "error", "probability": 0.5, "count": 5}]},
        [("pipeline.decode_q", None), ("engine.encode", None)] * 15),
    "corrupt-default": (
        {"seed": 0, "faults": [{"seam": "store.crd.object", "kind": "corrupt", "count": 2}]},
        [("store.crd.object", "permit (principal, action, resource);"),
         ("store.crd.object", b"bytes payload"), ("store.crd.object", {"not": "text"}),
         ("store.crd.object", "clean")]),
    "corrupt-replacement": (
        {"seed": 0, "faults": [{"seam": "store.crd.object", "kind": "corrupt",
                                "replacement": "permit (galaxy;;; %%"}]},
        [("store.crd.object", "a"), ("store.crd.object", b"b")]),
    "response-kinds": (
        {"seed": 9, "faults": [
            {"seam": "response", "kind": "response_error", "count": 2},
            {"seam": "response", "kind": "response_deny", "after": 3, "count": 1}]},
        [("response", ("allow", "r", None))] * 6),
    "several-rules-one-seam": (
        {"seed": 2, "faults": [
            {"seam": "store.load", "kind": "corrupt", "after": 1, "count": 2,
             "replacement": "x"},
            {"seam": "store.load", "kind": "error", "after": 4, "count": 1,
             "message": "second rule"}]},
        [("store.load", "y")] * 7),
}


def _drive(mod, scenario, calls):
    """Fire every call through a fresh registry of package ``mod`` ->
    ([(call, outcome)], stats)."""
    reg = mod.ChaosRegistry()
    reg.configure(scenario)
    reg.arm()
    out = []
    for i, (seam, payload) in enumerate(calls):
        try:
            got = reg.fire(seam, payload)
            out.append((i, "ok", got))
        except BaseException as e:  # noqa: BLE001 — the injected kinds
            out.append((i, type(e).__name__, str(e)))
    return out, reg.stats()


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_same_scenario_same_schedule_as_jax(name):
    scenario, calls = SCHEDULES[name]
    t_out, t_stats = _drive(t_reg, scenario, calls)
    j_out, j_stats = _drive(j_reg, scenario, calls)
    assert t_out == j_out
    assert t_stats == j_stats
    assert any(o[1] != "ok" or o[2] != calls[o[0]][1] for o in t_out)


def test_latency_rule_sleeps_through_the_seams_sleep():
    slept = {}
    for mod in (t_reg, j_reg):
        seam = mod.Seam("store.load", sleep=lambda s, m=mod: slept.setdefault(m, []).append(s))
        seam.add_rule(mod.InjectionRule("latency", count=2, delay_s=0.25))
        for _ in range(3):
            seam.fire("p", rng=random.Random(0))
    assert slept[t_reg] == slept[j_reg] == [0.25, 0.25]


def test_rate_rule_token_bucket_equals_jax():
    for rate in (0.0, 2.0):
        fired = {}
        for mod in (t_reg, j_reg):
            clock = [100.0]
            rule = mod.InjectionRule("error", rate=rate, now=lambda c=clock: c[0])
            seq = []
            for step in range(12):
                clock[0] += 0.2
                seq.append(rule.should_fire(step, random.Random(0)))
            fired[mod] = seq
        assert fired[t_reg] == fired[j_reg]


def test_disarmed_fire_is_a_pass_through():
    for mod in (t_reg, j_reg):
        reg = mod.default_registry()
        reg.configure({"faults": [{"seam": "engine.dispatch", "kind": "error"}]})
        assert mod.chaos_fire("engine.dispatch", 7) == 7
        assert reg.stats()["seams"]["engine.dispatch"]["calls"] == 0


def test_unknown_seam_or_kind_rejected_by_configure():
    for mod in (t_reg, j_reg):
        reg = mod.ChaosRegistry()
        with pytest.raises(ValueError, match="unknown chaos seam"):
            reg.configure({"faults": [{"seam": "zap", "kind": "error"}]})
        with pytest.raises(ValueError, match="unknown chaos rule kind"):
            reg.configure({"faults": [{"seam": "response", "kind": "zap"}]})


def test_injection_metric_reaches_the_ports_metrics():
    key = {"seam": "engine.decode", "kind": "error"}
    before = process_metrics().chaos_injections_total.value(**key)
    reg = t_reg.default_registry()
    reg.configure({"faults": [{"seam": "engine.decode", "kind": "error", "count": 1}]})
    reg.arm()
    with pytest.raises(t_reg.ChaosError):
        t_reg.chaos_fire("engine.decode")
    assert process_metrics().chaos_injections_total.value(**key) == before + 1
    assert 'cedar_chaos_injections_total{seam="engine.decode",kind="error"}' in (
        WebhookMetrics().expose())


# documents for load_scenario: each accepted or rejected alike
SCENARIO_DOCS = {
    "empty": {"name": "empty"},
    "faults-not-list": {"faults": {"seam": "response"}},
    "faults-empty": {"faults": []},
    "fault-not-object": {"faults": ["response"]},
    "unknown-seam": {"faults": [{"seam": "zap", "kind": "error"}]},
    "unknown-kind": {"faults": [{"seam": "response", "kind": "zap"}]},
    "not-json": "{nope",
    "json-array": "[1, 2]",
    "json-string": '{"faults": [{"seam": "cache.get", "kind": "latency"}], '
                   '"slo": {"availability": 0.95}}',
    "bytes": b'{"faults": [{"seam": "engine.dispatch", "kind": "error", "count": 1}]}',
    "slo-merged": {"faults": [{"seam": "store.load", "kind": "latency", "delay_s": 1}],
                   "slo": {"recovery_p99_ratio": 2.0}},
    "unported-seam": {"faults": [{"seam": "fleet.replica_dispatch", "kind": "kill"}]},
    "extra-keys": {"name": "x", "spawn_args": ["--a"],
                   "faults": [{"seam": "response", "kind": "response_deny", "rate": 1.0}]},
}


def _load(mod_scn, doc):
    try:
        return ("ok", mod_scn.load_scenario(doc))
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(SCENARIO_DOCS))
def test_load_scenario_accepts_and_rejects_like_jax(name):
    doc = SCENARIO_DOCS[name]
    assert _load(t_scn, doc) == _load(j_scn, doc)


@pytest.mark.parametrize("name", sorted(j_scn.BUILTIN_SCENARIOS))
def test_every_builtin_validates_in_both_packages(name):
    """The builtins are the JAX package's, with the same faults and SLOs
    (descriptions may state the port's posture)."""
    t, j = t_scn.builtin_scenario(name), j_scn.builtin_scenario(name)
    assert t is not None and j is not None
    strip = lambda d: {k: v for k, v in d.items() if k != "description"}  # noqa: E731
    assert strip(t) == strip(j)
    t_reg.ChaosRegistry().configure(t)
    j_reg.ChaosRegistry().configure(t)


def test_builtin_names_equal_and_unknown_is_none():
    assert sorted(t_scn.BUILTIN_SCENARIOS) == sorted(j_scn.BUILTIN_SCENARIOS)
    assert t_scn.builtin_scenario("no-such-thing") is None


def test_scenario_file(tmp_path):
    f = tmp_path / "s.json"
    f.write_text(json.dumps(SCHEDULES["after-count"][0]))
    assert t_scn.load_scenario_file(str(f)) == j_scn.load_scenario_file(str(f))


# -------------------------------------------------------- HTTP control


def _server(**kw):
    ps = PolicySet.from_source(POLICIES, "p")
    engine = TorchPolicyEngine(device="cpu")
    engine.load([ps])
    stores = TieredPolicyStores([MemoryStore("p", ps)])
    authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    srv = WebhookServer(authz, address="127.0.0.1", port=0, metrics_port=0,
                        fastpath=SARFastPath(engine, authz), pipeline_depth=2,
                        request_timeout_s=30.0, **kw)
    srv.start()
    return srv


def _post(port, path, doc=None):
    data = b"" if doc is None else (doc if isinstance(doc, bytes) else json.dumps(doc).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            return e.code, json.loads(body)
        except ValueError:
            return e.code, body


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def sar(user="test-user", verb="get", resource="pods", groups=("dev",)):
    return json.dumps({
        "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
        "spec": {"user": user, "uid": "u1", "groups": list(groups),
                 "resourceAttributes": {"verb": verb, "resource": resource, "version": "v1"}},
    }).encode()


@pytest.mark.parametrize("path", ["/chaos/configure", "/chaos/arm", "/chaos/disarm",
                                  "/chaos/reset"])
def test_control_answers_403_without_the_gate(path):
    srv = _server()
    try:
        status, doc = _post(srv.bound_metrics_port, path, {"faults": []})
        assert status == 403 and "confirm-non-prod-inject-errors" in doc["error"]
        assert _get(srv.bound_metrics_port, "/debug/chaos")["armed"] is False
        assert t_reg.default_registry().stats()["seams"] == {}
    finally:
        srv.stop()


def test_configure_arm_inject_disarm_roundtrip():
    srv = _server(chaos_control_enabled=True)
    try:
        port = srv.bound_metrics_port
        scenario = {"name": "http-response-fault",
                    "faults": [{"seam": "response", "kind": "response_error", "count": 1}]}
        assert _post(port, "/chaos/configure", scenario)[0] == 200
        status, stats = _post(port, "/chaos/arm")
        assert status == 200 and stats["armed"] is True
        doc = srv.handle_authorize(sar())
        assert doc["status"]["evaluationError"] == "encountered error"
        # count exhausted: the next answer is clean again
        assert srv.handle_authorize(sar())["status"]["allowed"] is True
        stats = _get(port, "/debug/chaos")
        assert stats["armed"] is True and stats["scenario"] == "http-response-fault"
        assert stats["seams"]["response"]["rules"][0]["fired"] == 1
        assert _post(port, "/chaos/disarm")[1]["armed"] is False
        assert _post(port, "/chaos/configure", {"faults": []})[0] == 400
        assert _post(port, "/chaos/configure",
                     {"faults": [{"seam": "nope", "kind": "error"}]})[0] == 400
        assert _post(port, "/chaos/nope")[0] == 404
        status, stats = _post(port, "/chaos/reset")
        assert status == 200 and stats == {"armed": False, "scenario": "", "seams": {}}
        assert _post(srv.bound_port, "/chaos/arm")[0] == 404  # not on the webhook port
    finally:
        srv.stop()


def test_debug_supervisor_without_a_supervisor():
    srv = _server()
    try:
        doc = _get(srv.bound_metrics_port, "/debug/supervisor")
        assert set(doc) == {"quarantine"} and "count" in doc["quarantine"]
    finally:
        srv.stop()


# --------------------------------------------- the disarmed differential


def _jax_native_ready(wait_s: float = 120.0) -> bool:
    from cedar_tpu import native as jnative

    deadline = time.monotonic() + wait_s
    while not jnative.native_available():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        jnative._lib_error = None
    return True


def test_1k_bodies_byte_identical_with_the_plane_disarmed():
    """With faults configured on every seam the path fires, but the
    registry disarmed, 1000 answers of the port's server equal the JAX
    server's byte for byte, and no seam counts a call."""
    assert _jax_native_ready()
    rng = random.Random(17)
    users = ["test-user", "alice", "bob", "carol"]
    verbs = ["get", "list", "create", "delete"]
    resources = ["pods", "secrets", "configmaps"]
    bodies = [sar(rng.choice(users), rng.choice(verbs), rng.choice(resources),
                  groups=rng.choice([(), ("dev",)]))
              for _ in range(1000)]
    t_srv = _server()
    j_ps = JPolicySet.from_source(POLICIES, "p")
    j_stores = j_store.TieredPolicyStores([j_store.MemoryStore("p", j_ps)])
    j_eng = TPUPolicyEngine()
    j_eng.load([s.policy_set() for s in j_stores], warm="off")
    j_authz = j_auth.CedarWebhookAuthorizer(j_stores, evaluate_batch=j_eng.evaluate_batch)
    j_srv = JWebhookServer(j_authz, None, address="127.0.0.1", port=0, metrics_port=0,
                           fastpath=JSARFastPath(j_eng, j_authz), pipeline_depth=2,
                           request_timeout_s=30.0)
    try:
        reg = t_reg.default_registry()
        reg.configure({"faults": [
            {"seam": s, "kind": "error", "count": 99}
            for s in ("engine.encode", "engine.dispatch", "engine.decode", "pipeline.collect",
                      "pipeline.dispatch_q", "pipeline.decode_q", "store.load")
        ] + [{"seam": "response", "kind": "response_deny", "count": 99}]})
        got = [json.dumps(t_srv.handle_authorize(b), sort_keys=True) for b in bodies]
        want = [json.dumps(j_srv.handle_authorize(b), sort_keys=True) for b in bodies]
        assert got == want
        assert len(set(got)) > 3
        assert all(s["calls"] == 0 for s in reg.stats()["seams"].values())
    finally:
        t_srv.stop()
        j_srv.stop()
