"""The port's admission path (cedar_tpu_torch: entities/admission.py,
server/admission.py, the native admission encoder binding and
engine/fastpath.py AdmissionFastPath) against the JAX package's, on the
CPU, at tolerance 0.

The JAX package runs on its CPU plane, as tests/test_admission_native.py
runs it (TPUPolicyEngine, warm="off"); the port with device="cpu", where
every kernel wrapper takes its plain version. Both take the same bodies:
a seeded copy of the JAX tests' gen_admission_bodies (300 bodies), the
directed cases of those tests (deny and allow per forbid, DELETE and
UPDATE oldObject, CONNECT exec options, field joins, namespace skip,
parse and conversion errors, type-flipped request nodes) and chip_smoke.py
phase 9's traffic. Per policy set they must agree on

  * AdmissionRequest's fields and the entities and request the handler
    builds;
  * the native encoder's codes, extras, counts, flags and uids;
  * the admission stack's pack (W, thresh, rule_group, rule_policy,
    act_rows), and the verdict words of the JAX pack carried across
    (engine/weights.py);
  * CedarAdmissionHandler on the interpreter;
  * AdmissionFastPath.handle_raw, to the response document.

Then what only the port promises: no quiet degradation. A failure on the
device path (a pipeline stage, a kernel launch, the gated rows'
evaluate_batch, the --no-native batch) answers the server's
--admission-fail-mode posture with code 500 and the error, and nothing
re-runs on the interpreter (spied); a deadline answers the same way.
"""

import dataclasses
import json
import pathlib
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import yaml

from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import AdmissionFastPath as JAdmissionFastPath
from cedar_tpu.entities import admission as j_ent
from cedar_tpu.compiler import table as j_table
from cedar_tpu.server import admission as j_adm
from cedar_tpu.stores import store as j_store
from cedar_tpu_torch import native as tnative
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import AdmissionFastPath
from cedar_tpu_torch.engine.weights import compiled_set_from_numpy, packed_arrays
from cedar_tpu_torch.entities import admission as t_ent
from cedar_tpu_torch.ops import cuda_match
from cedar_tpu_torch.server import admission as t_adm
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.stores import store as t_store

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — phase 9's policies and traffic

# the forbid set of the JAX package's native admission tests
ADM_POLICIES = chip_smoke.ADM_POLICIES
IMMUTABLE_SA = """
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is apps::v1::Deployment
) when {
    context has oldObject && context.oldObject has spec &&
    context.oldObject.spec has serviceAccountName &&
    resource has spec && resource.spec has serviceAccountName &&
    !(resource.spec.serviceAccountName ==
      context.oldObject.spec.serviceAccountName)
};
"""
EXEC_SHELL = """
forbid (
    principal,
    action == k8s::admission::Action::"connect",
    resource is core::v1::PodExecOptions
) when {
    resource has command && resource.command.contains("/bin/sh")
};
"""
NO_SCALE_UP = """
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is apps::v1::Deployment
) when {
    context has oldObject && context.oldObject has spec &&
    context.oldObject.spec has replicas &&
    resource has spec && resource.spec has replicas &&
    resource.spec.replicas > context.oldObject.spec.replicas
};
"""
IP_JOIN = """
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is core::v1::Service
) when {
    context has oldObject && context.oldObject has spec &&
    context.oldObject.spec has clusterIP &&
    resource has spec && resource.spec has clusterIP &&
    !(resource.spec.clusterIP == context.oldObject.spec.clusterIP)
};
"""
_BLOWUP = " && ".join(
    '(resource.metadata.namespace == "default" || resource.metadata.name == "zzz")'
    for _ in range(12)
)
HYBRID = f"""
forbid (principal is k8s::ServiceAccount,
        action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when {{ {_BLOWUP} }};
forbid (principal, action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when {{
    resource.metadata has labels &&
    resource.metadata.labels.contains({{key: "env", value: "prod"}})
  }};
"""


def _demo_admission_source() -> str:
    docs = [d for d in yaml.safe_load_all((REPO / "demo/admission-policy.yaml").read_text()) if d]
    return "\n".join(d["spec"]["content"] for d in docs if d.get("spec"))


SETS = {
    "adm": ADM_POLICIES,
    "immutable": ADM_POLICIES + IMMUTABLE_SA,
    "exec": ADM_POLICIES + EXEC_SHELL,
    "scale": ADM_POLICIES + NO_SCALE_UP,
    "ip_join": ADM_POLICIES + IP_JOIN,
    "hybrid": HYBRID,
    "demo": _demo_admission_source(),
    "phase9": ADM_POLICIES + chip_smoke.ADM_DEMO_OWNER_POLICY + chip_smoke.ADM_FALLBACK_POLICY,
}


# ------------------------------------------------------------------ bodies


def review(op="CREATE", gvk=("", "v1", "ConfigMap"), resource=None, ns="default", obj=None,
           old=None, user="bob", groups=("tenants",), uid="r-1", extra=None, sub=""):
    group, version, kind = gvk
    req = {
        "uid": uid,
        "operation": op,
        "userInfo": {"username": user, "uid": "u-" + user, "groups": list(groups)},
        "kind": {"group": group, "version": version, "kind": kind},
        "resource": {"group": group, "version": version,
                     "resource": resource or (kind.lower() + "s")},
        "namespace": ns,
        "name": (obj or {}).get("metadata", {}).get("name", "x"),
    }
    if sub:
        req["subResource"] = sub
    if extra is not None:
        req["userInfo"]["extra"] = extra
    if obj is not None:
        req["object"] = obj
    if old is not None:
        req["oldObject"] = old
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview", "request": req}


def obj_cm(name="cm", ns="default", labels=None, data=None):
    o = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": name, "namespace": ns}}
    if labels is not None:
        o["metadata"]["labels"] = labels
    if data is not None:
        o["data"] = data
    return o


def gen_admission_bodies(rng, n):
    """A copy of the JAX package's tests/test_admission_native.py
    generator: random AdmissionReview bodies over the kinds, operations
    and shapes the forbid set exercises."""
    kinds = [("", "v1", "ConfigMap"), ("", "v1", "Secret"),
             ("apps", "v1", "Deployment"), ("", "v1", "Pod")]
    users = ["bob", "alice", "system:serviceaccount:ns1:sa1", "system:node:node-1"]
    bodies = []
    for i in range(n):
        gvk = rng.choice(kinds)
        op = rng.choice(["CREATE", "UPDATE", "DELETE", "CONNECT"])
        labels = rng.choice([None, {}, {"env": rng.choice(["prod", "dev"])},
                             {"env": "prod", "team": "a"}, {"owner": "bob"}])
        o = {"apiVersion": "v1", "kind": gvk[2],
             "metadata": {"name": f"o{i}",
                          "namespace": rng.choice(["default", "protected", "locked"])}}
        if labels is not None:
            o["metadata"]["labels"] = labels
        if gvk[2] == "Deployment":
            o["spec"] = {"replicas": rng.choice([0, 1, 50, 51, 500])}
        if gvk[2] == "Pod":
            o["spec"] = {"hostNetwork": rng.choice([True, False]),
                         "nodeSelector": {"disk": "ssd"}}
            if rng.random() < 0.5:
                o["status"] = {"podIP": rng.choice(
                    ["10.0.0.1", "not-an-ip", "fe80::1", "10.0.0.1/8"])}
        if gvk[2] == "ConfigMap" and rng.random() < 0.5:
            o["data"] = {f"k{j}": f"v{j}" for j in range(rng.randint(0, 4))}
        if rng.random() < 0.2:
            o["metadata"]["annotations"] = {"note": "x", "n": "y"}
        old = None
        if op == "DELETE" or (op == "UPDATE" or rng.random() < 0.2):
            old = {"apiVersion": "v1", "kind": gvk[2],
                   "metadata": {"name": f"o{i}",
                                "namespace": rng.choice(["default", "locked"])}}
        extra = None
        if rng.random() < 0.2:
            extra = {"scopes": ["a", "b"], "Upper-Key": ["c"]}
        bodies.append(json.dumps(review(
            op=op, gvk=gvk, ns=rng.choice(["default", "protected", "kube-system"]),
            obj=None if op == "DELETE" else o, old=old, user=rng.choice(users),
            groups=rng.choice([(), ("tenants",), ("tenants", "dev")]), uid=f"u-{i}",
            extra=extra,
        )).encode())
    return bodies


def _dep(spec=None, name="d"):
    o = {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": name, "namespace": "default"}}
    if spec is not None:
        o["spec"] = spec
    return o


def _svc(ip):
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": "s", "namespace": "default"}, "spec": {"clusterIP": ip}}


def _exec_review(command):
    r = review(op="CONNECT", gvk=("", "v1", "PodExecOptions"), resource="pods", sub="exec",
               groups=(), uid="e1",
               obj={"apiVersion": "v1", "kind": "PodExecOptions", "stdin": True, "tty": True,
                    "container": "app", "command": command})
    r["request"]["name"] = "p1"
    return r


def _flipped(mutate):
    d = review(obj=obj_cm())
    mutate(d)
    return d


SECRET = {"apiVersion": "v1", "kind": "Secret",
          "metadata": {"name": "s", "namespace": "protected"}, "data": {"k": "dmFsdWU="}}
DIRECTED = {
    "create-prod-label-deny": review(obj=obj_cm(labels={"env": "prod"})),
    "create-dev-label-allow": review(obj=obj_cm(labels={"env": "dev"})),
    "create-no-labels": review(obj=obj_cm()),
    "update-protected-secret-tenant-deny": review(
        op="UPDATE", gvk=("", "v1", "Secret"), obj=SECRET,
        old={"apiVersion": "v1", "kind": "Secret",
             "metadata": {"name": "s", "namespace": "protected"}}, ns="protected"),
    "update-protected-secret-admin-allow": review(
        op="UPDATE", gvk=("", "v1", "Secret"), obj=SECRET,
        old={"apiVersion": "v1", "kind": "Secret"}, ns="protected", groups=("admins",)),
    "update-replicas-51-deny": review(
        op="UPDATE", gvk=("apps", "v1", "Deployment"), obj=_dep({"replicas": 51}),
        old=_dep()),
    "update-replicas-50-allow": review(
        op="UPDATE", gvk=("apps", "v1", "Deployment"), obj=_dep({"replicas": 50}),
        old=_dep()),
    "update-old-object-locked-deny": review(op="UPDATE", obj=obj_cm(), old=obj_cm(ns="locked")),
    "update-old-object-default-allow": review(op="UPDATE", obj=obj_cm(ns="locked"),
                                              old=obj_cm()),
    "delete-evaluates-old-object": review(
        op="DELETE", gvk=("", "v1", "Secret"),
        old={"apiVersion": "v1", "kind": "Secret",
             "metadata": {"name": "s", "namespace": "protected"}}, ns="protected"),
    "delete-without-old-object": review(op="DELETE", gvk=("", "v1", "Secret"), ns="protected"),
    "host-network-pod-sa": review(
        gvk=("", "v1", "Pod"),
        obj={"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p"},
             "spec": {"hostNetwork": True, "containers": []}},
        user="system:serviceaccount:default:deployer"),
    "namespace-skip": review(ns="kube-system", obj=obj_cm(labels={"env": "prod"})),
    "namespace-skip-authz-system": review(ns="cedar-k8s-authz-system",
                                          obj=obj_cm(labels={"env": "prod"})),
    "namespace-skip-malformed": _flipped(
        lambda d: (d["request"].__setitem__("namespace", "kube-system"),
                   d["request"].__setitem__("userInfo", 7))),
    "unknown-operation": review(op="EVICT", obj=obj_cm()),
    "float-leaf": review(obj={"apiVersion": "v1", "kind": "ConfigMap",
                              "metadata": {"name": "f"}, "weird": 1.5}),
    "missing-object": review(obj=None),
    "request-is-float": _flipped(lambda d: d.__setitem__("request", 3.5)),
    "request-is-string": _flipped(lambda d: d.__setitem__("request", "x")),
    "user-info-is-int": _flipped(lambda d: d["request"].__setitem__("userInfo", 7)),
    "uid-is-list": _flipped(lambda d: d["request"].__setitem__("uid", ["u"])),
    "kind-is-string": _flipped(lambda d: d["request"].__setitem__("kind", "ConfigMap")),
    "resource-is-list": _flipped(lambda d: d["request"].__setitem__("resource", ["cms"])),
    "uid-over-255-bytes": review(obj=obj_cm(labels={"env": "prod"}), uid="u" * 300),
    "uid-255-bytes": review(obj=obj_cm(labels={"env": "prod"}), uid="u" * 255),
    "unicode-owner": review(obj=obj_cm(labels={"owner": "üser-ünïcode"}), user="üser-ünïcode"),
    "owner-label-matches": review(obj=obj_cm(labels={"owner": "bob"})),
    "owner-label-other": review(obj=obj_cm(labels={"owner": "alice"})),
    "sa-create-default-gated": review(obj=obj_cm(), user="system:serviceaccount:default:ci-runner",
                                      groups=()),
    "sa-create-other-gated": review(obj=obj_cm(ns="other"), ns="other",
                                    user="system:serviceaccount:default:ci-runner", groups=()),
    "sa-create-prod-gated-two-forbids": review(
        obj=obj_cm(labels={"env": "prod"}), user="system:serviceaccount:default:ci-runner",
        groups=()),
    "dry-run-unknown-keys": {**review(obj=obj_cm()), "extraTop": 1},
}
for _new, _old in [("app-sa", "app-sa"), ("app-sa", "other-sa"), ("app-sa", None),
                   (None, "app-sa")]:
    DIRECTED[f"immutable-sa-{_new}-{_old}"] = review(
        op="UPDATE", gvk=("apps", "v1", "Deployment"),
        obj=_dep(None if _new is None else {"serviceAccountName": _new}),
        old=_dep(None if _old is None else {"serviceAccountName": _old}))
for _k, _cmd in enumerate([["/bin/sh"], ["/bin/bash"], ["/bin/sh", "-c", "id"], ["ls"], []]):
    DIRECTED[f"exec-{_k}"] = _exec_review(_cmd)
for _new, _old in [(3, 3), (2, 3), (4, 3), (None, 3), (3, None)]:
    DIRECTED[f"scale-{_new}-{_old}"] = review(
        op="UPDATE", gvk=("apps", "v1", "Deployment"),
        obj=_dep(None if _new is None else {"replicas": _new}),
        old=_dep(None if _old is None else {"replicas": _old}))
for _k, (_new, _old) in enumerate([
    ("10.0.0.7", "10.0.0.7"), ("10.0.0.7", "10.0.0.8"), ("::1", "::1"), ("::1", "fe80::2"),
    ("::1", "0:0:0:0:0:0:0:1"), ("10.0.0.7/32", "10.0.0.7"), ("None", "10.0.0.7"),
]):
    DIRECTED[f"ip-join-{_k}"] = review(op="UPDATE", gvk=("", "v1", "Service"),
                                       obj=_svc(_new), old=_svc(_old))
DIRECTED_BODIES = {k: json.dumps(v).encode() for k, v in DIRECTED.items()}
DIRECTED_BODIES.update({
    "parse-error": b"{not json",
    "empty-body": b"",
    "json-null": b"null",
    "json-array": b"[1, 2]",
    "not-utf8": b"\xff\xfe{}",
})
RANDOM_BODIES = gen_admission_bodies(random.Random(42), 300)
PHASE9_BODIES = chip_smoke.admission_bodies(400, 3)
ALL_BODIES = RANDOM_BODIES + list(DIRECTED_BODIES.values()) + PHASE9_BODIES
GROUP = 10


# ------------------------------------------------------------------ stacks


class Stack:
    """One policy set on both sides: engines, handlers and fast paths."""

    def __init__(self, src: str, load_complete: bool = True):
        aa_src = t_adm.ALLOW_ALL_ADMISSION_POLICY_SOURCE
        assert aa_src == j_adm.ALLOW_ALL_ADMISSION_POLICY_SOURCE
        self.j_stores = j_store.TieredPolicyStores([
            j_store.MemoryStore.from_source("adm", src, load_complete),
            j_adm.allow_all_admission_policy_store(),
        ])
        self.t_stores = t_store.TieredPolicyStores([
            t_store.MemoryStore.from_source("adm", src, load_complete),
            t_adm.allow_all_admission_policy_store(),
        ])
        self.j_engine = TPUPolicyEngine(incremental=False)
        self.j_engine.load([s.policy_set() for s in self.j_stores], warm="off")
        self.t_engine = TorchPolicyEngine(device="cpu")
        self.t_engine.load([s.policy_set() for s in self.t_stores])
        self.j_handler = j_adm.CedarAdmissionHandler(
            self.j_stores, evaluate=self.j_engine.evaluate,
            evaluate_batch=self.j_engine.evaluate_batch)
        self.t_handler = t_adm.CedarAdmissionHandler(
            self.t_stores, evaluate_batch=self.t_engine.evaluate_batch)
        self.j_fast = JAdmissionFastPath(self.j_engine, self.j_handler)
        self.t_fast = AdmissionFastPath(self.t_engine, self.t_handler)
        self.j_interp = j_adm.CedarAdmissionHandler(self.j_stores)
        self.t_interp = t_adm.CedarAdmissionHandler(self.t_stores)


_STACKS: dict = {}


def stack(name: str) -> Stack:
    if name not in _STACKS:
        _STACKS[name] = Stack(SETS[name])
    return _STACKS[name]


def _oracle(mod_ent, mod_adm, handler, body: bytes) -> dict:
    """The exact Python path, shaped like the webhook's answer."""
    try:
        review_doc = json.loads(body)
    except ValueError as e:
        return mod_adm.AdmissionResponse(
            uid="", allowed=False, code=400, error=f"failed parsing body: {e}"
        ).to_admission_review()
    try:
        req = mod_ent.AdmissionRequest.from_admission_review(review_doc)
        return handler.handle(req).to_admission_review()
    except Exception as e:  # noqa: BLE001 — every body gets an answer
        return mod_adm.AdmissionResponse(
            uid=mod_ent.review_request_uid(review_doc), allowed=True,
            error=f"evaluation error (allowed on error): {e}",
        ).to_admission_review()


# ----------------------------------------------------- entities and parse


def _outcome(fn):
    """(True, value) or (False, 'ExcType: message')."""
    try:
        return True, fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return False, f"{type(e).__name__}: {e}"


def _built(handler, req):
    entities, cedar_req = handler._build(req)
    return (sorted(repr(e) for e in entities),
            tuple(repr(getattr(cedar_req, k)) for k in ("principal", "action", "resource",
                                                        "context")))


@pytest.mark.parametrize("group", range(-(-len(ALL_BODIES) // GROUP)))
def test_admission_request_and_entities_equal_jax(group):
    """AdmissionRequest.from_admission_review's fields, and the entities
    and Cedar request the handler builds from them (or the error either
    raises), equal the JAX package's."""
    jh = j_adm.CedarAdmissionHandler(j_store.TieredPolicyStores([]))
    th = t_adm.CedarAdmissionHandler(t_store.TieredPolicyStores([]))
    for body in ALL_BODIES[group * GROUP:(group + 1) * GROUP]:
        doc = _outcome(lambda: json.loads(body))
        if not doc[0]:
            continue
        j_req = _outcome(lambda: j_ent.AdmissionRequest.from_admission_review(doc[1]))
        t_req = _outcome(lambda: t_ent.AdmissionRequest.from_admission_review(doc[1]))
        assert t_req[0] == j_req[0], body[:200]
        if not t_req[0]:
            assert t_req == j_req
            continue
        # every field, the tenant stamp included (unset from a wire body)
        assert dataclasses.asdict(t_req[1]) == dataclasses.asdict(j_req[1])
        assert t_req[1].tenant == ""
        assert t_ent.review_request_uid(doc[1]) == j_ent.review_request_uid(doc[1])
        assert _outcome(lambda: _built(th, t_req[1])) == _outcome(lambda: _built(jh, j_req[1]))


def test_admission_action_entities_equal_jax():
    t = sorted(repr(e) for e in t_ent.admission_action_entities())
    assert t == sorted(repr(e) for e in j_ent.admission_action_entities())
    assert len(t) == 5


# ------------------------------------------- encoder, pack and carried plane


def _jax_python_encode(st: "Stack", body: bytes):
    """The JAX package's Python encode of one admission body over its own
    pack: ("ok", codes, sorted extras, uid), ("skip", uid) for a namespace
    the handler skips, or ("error",) when the review does not decode,
    convert or build."""
    try:
        doc = json.loads(body)
        req = j_ent.AdmissionRequest.from_admission_review(doc)
        if req.namespace in j_adm.SKIPPED_NAMESPACES:
            return ("skip", j_ent.review_request_uid(doc))
        entities, cedar_req = st.j_interp._build(req)
        packed = st.j_engine._compiled.packed
        codes, extras = j_table.encode_request_codes(packed.plan, packed.table, entities,
                                                     cedar_req)
    except Exception:  # noqa: BLE001 — a review the Python path rejects
        return ("error",)
    return ("ok", list(codes), sorted(extras), j_ent.review_request_uid(doc))


@pytest.mark.parametrize("entry", ["pylist", "packed"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_native_encode_adm_equals_jax(name, entry):
    """The port's native admission encode of every body (both entries:
    the list the C side reads in place, and the joined buffer) equals the
    JAX package's Python encode of the same review over the JAX pack
    (byte-identical to the port's, test_admission_pack_equals_jax): codes,
    extras and uid on every row it encodes, the namespace skip where the
    JAX handler skips, and a Python-path flag wherever the JAX review
    conversion or entity build raises. (The JAX encoder is held to, not
    its native twin: the JAX native build is not safe across concurrent
    test processes.)"""
    st = stack(name)
    t_enc = tnative.NativeEncoder.create(st.t_engine.compiled_set.packed)
    bodies = list(ALL_BODIES) if entry == "pylist" else tuple(ALL_BODIES)
    codes, extras, counts, flags, uids = t_enc.encode_adm_batch(bodies)
    n_ok = 0
    for i, body in enumerate(ALL_BODIES):
        want = _jax_python_encode(st, body)
        if flags[i] == tnative.F_OK:
            assert want[0] == "ok", body[:200]
            assert codes[i].tolist() == want[1], body[:200]
            assert sorted(extras[i, : counts[i]].tolist()) == want[2], body[:200]
            assert uids[i] == want[3]
            n_ok += 1
        elif flags[i] == tnative.F_ADM_NS_SKIP:
            assert want[0] == "skip" and uids[i] == want[1], body[:200]
        else:
            assert flags[i] in (tnative.F_ADM_ERROR, tnative.F_PARSE_ERROR,
                                tnative.F_EXTRAS_OVERFLOW), (flags[i], body[:200])
        if want[0] == "error":
            assert flags[i] in (tnative.F_ADM_ERROR, tnative.F_PARSE_ERROR), body[:200]
    assert n_ok > 500
    assert (tnative.F_ADM_NS_SKIP, tnative.F_ADM_ERROR) == (6, 7)
    assert (flags == tnative.F_ADM_NS_SKIP).any() and (flags == tnative.F_ADM_ERROR).any()
    long_row = list(DIRECTED_BODIES).index("uid-over-255-bytes") + len(RANDOM_BODIES)
    assert flags[long_row] == tnative.F_ADM_ERROR and uids[long_row] == ""
    edge_row = list(DIRECTED_BODIES).index("uid-255-bytes") + len(RANDOM_BODIES)
    assert flags[edge_row] == tnative.F_OK and uids[edge_row] == "u" * 255


@pytest.mark.parametrize("name", sorted(SETS))
def test_admission_pack_equals_jax(name):
    """The port's own pack of the admission tiers is the JAX pack, byte
    for byte."""
    st = stack(name)
    j, t = st.j_engine._compiled.packed, st.t_engine.compiled_set.packed
    for attr in ("W", "thresh", "rule_group", "rule_policy"):
        a, b = np.asarray(getattr(t, attr)), np.asarray(getattr(j, attr))
        assert a.dtype == b.dtype and a.shape == b.shape, attr
        assert a.tobytes() == b.tobytes(), attr
    assert np.asarray(t.table.rows).tobytes() == np.asarray(j.table.rows).tobytes()
    assert (t.n_tiers, t.has_gate, t.n_rules, t.L, t.R) == (
        j.n_tiers, j.has_gate, j.n_rules, j.L, j.R)


@pytest.mark.parametrize("name", sorted(SETS))
def test_jax_pack_carried_across_gives_jax_words(name):
    """The JAX pack carried into the port (engine/weights.py) gives the
    port engine the JAX engine's verdict words on the admission bodies."""
    st = stack(name)
    jcs = st.j_engine._compiled
    # the codes from the port's native encoder over the port's pack, which
    # is the JAX pack byte for byte (test_admission_pack_equals_jax); its
    # codes are the JAX encoder's (test_native_encode_adm_equals_jax)
    codes, extras, _counts, flags, _uids = tnative.NativeEncoder.create(
        st.t_engine.compiled_set.packed).encode_adm_batch(list(ALL_BODIES))
    ok = flags == 0
    codes, extras = codes[ok], extras[ok]
    jw, _ = st.j_engine.match_arrays(codes, extras, cs=jcs)
    cs = compiled_set_from_numpy(packed_arrays(jcs.packed), "cpu")
    tw, _ = st.t_engine.match_arrays(codes, extras, cs=cs)
    np.testing.assert_array_equal(tw, np.asarray(jw).astype(np.uint32))
    assert len(tw) > 500


# ------------------------------------------------------ handler, fast path


@pytest.mark.parametrize("name", sorted(SETS))
def test_interpreter_handler_equals_jax(name):
    st = stack(name)
    for body in ALL_BODIES:
        assert _oracle(t_ent, t_adm, st.t_interp, body) == _oracle(
            j_ent, j_adm, st.j_interp, body), body[:200]


def _reason_set(doc: dict) -> tuple:
    r = doc["response"]
    msg = r["status"]["message"]
    if msg.startswith("[{"):
        msg = sorted(json.dumps(x, sort_keys=True) for x in json.loads(msg))
    return r["uid"], r["allowed"], r["status"]["code"], msg


@pytest.mark.parametrize("name", sorted(SETS))
def test_fastpath_handle_raw_equals_jax(name):
    """AdmissionFastPath.handle_raw answers every body with the JAX fast
    path's response document, byte for byte, and the interpreter's
    (a deny's reasons as a set: the engine lists the device plane's
    before the interpreter-fallback policies')."""
    st = stack(name)
    got = [r.to_admission_review() for r in st.t_fast.handle_raw(list(ALL_BODIES))]
    want = [r.to_admission_review() for r in st.j_fast.handle_raw(list(ALL_BODIES))]
    assert len(got) == len(ALL_BODIES)
    for g, w, b in zip(got, want, ALL_BODIES):
        assert g == w, b[:200]
        assert _reason_set(g) == _reason_set(_oracle(t_ent, t_adm, st.t_interp, b)), b[:200]
    assert any(not g["response"]["allowed"] for g in got)


def test_phase9_traffic_takes_every_route():
    """chip_smoke.py phase 9's traffic over its admission policies routes
    rows down every class (the card run requires each above 0) and
    answers as the JAX fast path does."""
    st = stack("phase9")
    before = dict(st.t_fast.routing)
    got = [r.to_admission_review() for r in st.t_fast.handle_raw(PHASE9_BODIES)]
    routing = {k: st.t_fast.routing[k] - before[k] for k in before}
    assert all(routing[k] > 0 for k in routing), routing
    assert got == [r.to_admission_review() for r in st.j_fast.handle_raw(PHASE9_BODIES)]
    ops = [json.loads(b)["request"]["operation"] for b in chip_smoke.admission_bodies(4096, 9)]
    share = {op: ops.count(op) / len(ops) for op in ("CREATE", "UPDATE", "DELETE", "CONNECT")}
    assert abs(share["CREATE"] - 0.5) < 0.03 and abs(share["UPDATE"] - 0.3) < 0.03
    assert abs(share["DELETE"] - 0.15) < 0.03 and abs(share["CONNECT"] - 0.05) < 0.02


# semantics the JAX handler defines, held on the fast path's answers:
# (body, allowed, code, message prefix)
SEMANTICS = {
    "namespace-skip": (True, 200, ""),
    "namespace-skip-authz-system": (True, 200, ""),
    "namespace-skip-malformed": (True, 500, "evaluation error (allowed on error): "),
    "delete-evaluates-old-object": (False, 200, '[{"policy":"policy1"'),
    "delete-without-old-object": (True, 500, "unstructured data is nil for oldObject"),
    "update-old-object-locked-deny": (False, 200, '[{"policy":"policy3"'),
    "update-old-object-default-allow": (True, 200, ""),
    # AdmissionResponse renders every errored answer as code 500 (the
    # handler's 400 stays internal), as in the JAX package
    "parse-error": (False, 500, "failed parsing body: "),
    "not-utf8": (False, 500, "failed parsing body: "),
    "json-null": (True, 500, "evaluation error (allowed on error): "),
    "float-leaf": (True, 500, "unsupported type float"),
    "unknown-operation": (True, 500, "unsupported operation EVICT"),
    "uid-over-255-bytes": (False, 200, '[{"policy":"policy0"'),
}


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_directed_semantics(case):
    st = stack("adm")
    allowed, code, prefix = SEMANTICS[case]
    body = DIRECTED_BODIES[case]
    doc = st.t_fast.handle_raw([body])[0].to_admission_review()
    assert doc == st.j_fast.handle_raw([body])[0].to_admission_review()
    r = doc["response"]
    assert (r["allowed"], r["status"]["code"]) == (allowed, code)
    assert r["status"]["message"].startswith(prefix)
    if case == "uid-over-255-bytes":
        assert r["uid"] == "u" * 300


def test_unready_stores_allow_without_evaluating(monkeypatch):
    """Before every store's initial load completes, every review is
    allowed (handler.go:49-57) without evaluation, as in the JAX
    package."""
    st = Stack(ADM_POLICIES, load_complete=False)
    calls = []
    monkeypatch.setattr(st.t_engine, "match_arrays_launch",
                        lambda *a, **k: calls.append("launch"))
    bodies = [DIRECTED_BODIES["create-prod-label-deny"], DIRECTED_BODIES["parse-error"],
              DIRECTED_BODIES["float-leaf"]]
    got = [r.to_admission_review() for r in st.t_fast.handle_raw(bodies)]
    assert got == [r.to_admission_review() for r in st.j_fast.handle_raw(bodies)]
    assert got[0]["response"]["allowed"] is True and got[0]["response"]["status"]["code"] == 200
    assert calls == []
    ctx = st.t_fast.pipeline_encode(bodies)
    assert ctx[0] == "direct"
    assert st.t_fast.pipeline_decode(st.t_fast.pipeline_dispatch(ctx)) == st.t_fast.handle_raw(
        bodies)


def test_handler_batch_failure_answers_every_member_with_the_error():
    """CedarAdmissionHandler with a batched backend: a failing batch
    answers each request it carried allow-on-error with code 500 and the
    error (raise_errors=True raises instead); the interpreter is never
    asked."""
    calls = []
    stores = t_store.TieredPolicyStores([t_store.MemoryStore.from_source("adm", ADM_POLICIES),
                                        t_adm.allow_all_admission_policy_store()])
    stores.is_authorized = lambda *a, **k: calls.append("interpreter")

    def boom(items):
        raise RuntimeError("injected device failure")

    reqs = [t_ent.AdmissionRequest.from_admission_review(DIRECTED[k])
            for k in ("create-prod-label-deny", "namespace-skip", "missing-object")]
    for allow in (True, False):
        h = t_adm.CedarAdmissionHandler(stores, allow_on_error=allow, evaluate_batch=boom)
        got = [r.to_admission_review()["response"] for r in h.handle_batch(reqs)]
        assert got[0] == {"uid": "r-1", "allowed": allow,
                          "status": {"code": 500, "message": "injected device failure"}}
        assert got[1]["allowed"] is True and got[1]["status"]["code"] == 200
        assert got[2]["status"] == {"code": 500,
                                    "message": "unstructured data is nil for object"}
        with pytest.raises(RuntimeError, match="injected device failure"):
            h.handle_batch(reqs, raise_errors=True)
        short = t_adm.CedarAdmissionHandler(stores, allow_on_error=allow,
                                            evaluate_batch=lambda items: [])
        assert "0 results for 1 items" in short.handle(reqs[0]).error
    assert calls == []


# --------------------------------------------- no quiet degradation (HTTP)


def _post(port, body, path="/v1/admit"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture
def adm_stack():
    """A port admission stack over the hybrid set (a gated scope), with
    spies on every interpreter entry point; make(mode, fail_open, depth)
    starts a server over it."""
    calls = []
    stores = t_store.TieredPolicyStores([t_store.MemoryStore.from_source("adm", HYBRID),
                                        t_adm.allow_all_admission_policy_store()])
    real_is_authorized = stores.is_authorized

    def spy_is_authorized(*a, **k):
        calls.append("stores.is_authorized")
        return real_is_authorized(*a, **k)

    stores.is_authorized = spy_is_authorized
    engine = TorchPolicyEngine(device="cpu")
    engine.load([s.policy_set() for s in stores])
    servers = []

    def make(native=True, fail_open=True, depth=2, timeout_s=30.0):
        handler = t_adm.CedarAdmissionHandler(stores, allow_on_error=fail_open,
                                              evaluate_batch=engine.evaluate_batch)
        fast = AdmissionFastPath(engine, handler) if native else None
        for obj, name in ((handler, "handle"), (handler, "_evaluate")) + (
                ((fast, "_py_one"),) if fast else ()):
            real = getattr(obj, name)

            def wrapped(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)

            setattr(obj, name, wrapped)
        srv = WebhookServer(CedarWebhookAuthorizer(stores), address="127.0.0.1", port=0,
                            metrics_port=0, pipeline_depth=depth, request_timeout_s=timeout_s,
                            admission_handler=handler, admission_fastpath=fast,
                            admission_fail_open=fail_open)
        srv.metrics.record_fallback_batch = lambda *a, **k: calls.append("fallback_batch")
        srv.start()
        servers.append(srv)
        return srv, handler, fast

    yield engine, calls, make
    for srv in servers:
        srv.stop()


def _boom(*a, **k):
    raise RuntimeError("injected device failure")


def _kernel_boom(*a, **k):
    raise RuntimeError("match_words_kernel launch failed: error 700 (an illegal memory access)")


GATED_BODY = DIRECTED_BODIES["sa-create-default-gated"]
CLEAN_BODY = DIRECTED_BODIES["create-prod-label-deny"]
# where the failure is injected: (what, attribute, replacement, depth,
# native, body)
ADM_FAILURES = {
    "encode-stage": ("fast", "_encode_into", _boom, 2, True, CLEAN_BODY),
    "dispatch-stage": ("engine", "match_arrays_launch", _boom, 2, True, CLEAN_BODY),
    "decode-stage": ("fast", "_decode_word_payload", _boom, 2, True, CLEAN_BODY),
    "serial-batch": ("engine", "match_arrays_launch", _boom, 0, True, CLEAN_BODY),
    "kernel-launch": ("cuda_match", "match_words", _kernel_boom, 2, True, CLEAN_BODY),
    "gated-evaluate-batch": ("handler", "_evaluate_batch", _boom, 2, True, GATED_BODY),
    "no-native-batch": ("handler", "_evaluate_batch", _boom, 2, False, CLEAN_BODY),
}


@pytest.mark.parametrize("mode", ["open", "closed"])
@pytest.mark.parametrize("where", sorted(ADM_FAILURES))
def test_admit_failure_answers_fail_mode_and_never_the_interpreter(adm_stack, monkeypatch,
                                                                  where, mode):
    """A failure anywhere on the admission device path answers every
    review of the failed batch with the --admission-fail-mode posture,
    code 500 and the error. Nothing re-runs on the interpreter: no store
    walk, no per-item handler call, no per-row exact path. A failed batch
    of the native path counts once as a fallback batch (the JAX family,
    answered with the posture here); the handler's own batcher counts
    none."""
    engine, calls, make = adm_stack
    what, attr, repl, depth, native, body = ADM_FAILURES[where]
    fail_open = mode == "open"
    srv, handler, fast = make(native=native, fail_open=fail_open, depth=depth)
    target = {"fast": fast, "engine": engine, "cuda_match": cuda_match, "handler": handler}[what]
    monkeypatch.setattr(target, attr, repl)
    calls.clear()
    with ThreadPoolExecutor(8) as pool:
        answers = list(pool.map(lambda b: _post(srv.bound_port, b), [body] * 8))
    uid = json.loads(body)["request"]["uid"]
    for status, doc in answers:
        assert status == 200
        r = doc["response"]
        assert (r["uid"], r["allowed"], r["status"]["code"]) == (uid, fail_open, 500)
        msg = r["status"]["message"]
        assert msg.startswith(f"evaluation error ({'allowed' if fail_open else 'denied'} "
                              "on error): batch evaluation failed")
        assert ("match_words_kernel launch failed" if where == "kernel-launch"
                else "injected device failure") in msg
    assert [c for c in calls if c != "fallback_batch"] == []
    assert (1 <= calls.count("fallback_batch") <= 8) if native else not calls
    # the server goes on serving once the fault is gone
    monkeypatch.undo()
    status, doc = _post(srv.bound_port, CLEAN_BODY)
    assert (doc["response"]["allowed"], doc["response"]["status"]["code"]) == (False, 200)


@pytest.mark.parametrize("mode", ["open", "closed"])
def test_admit_deadline_answers_fail_mode(adm_stack, mode):
    """A batch that outlives the request budget answers the fail-mode with
    the deadline's error, and counts one deadline_exceeded{admission}."""
    _engine, calls, make = adm_stack
    fail_open = mode == "open"
    srv, _handler, fast = make(fail_open=fail_open, timeout_s=0.05)
    real = fast.pipeline_decode

    def slow(ctx):
        time.sleep(0.3)
        return real(ctx)

    fast.pipeline_decode = slow
    status, doc = _post(srv.bound_port, CLEAN_BODY)
    r = doc["response"]
    assert (status, r["uid"], r["allowed"], r["status"]["code"]) == (200, "r-1", fail_open, 500)
    assert r["status"]["message"].startswith(
        f"evaluation error ({'allowed' if fail_open else 'denied'} on error): deadline of 0.0")
    assert srv.metrics.deadline_exceeded_total.value(path="admission") == 1
    assert calls == []
