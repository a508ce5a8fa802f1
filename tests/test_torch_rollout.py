"""The port's shadow-rollout plane (cedar_tpu_torch/rollout/, the rollout
routes and flags of its server and CLI, cedar-shadow and cedar-why)
against the JAX package's, on the CPU, at tolerance 0.

  * the candidate sources (directory, inline source, CRD objects) and
    their refusals: the same policies, ids, positions and errors;
  * classify_decision_diff and DiffReport.to_dict() / render_text() from
    the same (live, candidate) pairs of 1,100 seeded bodies, with and
    without the explain plane's attribution;
  * the recorded-traffic differential of tests/test_rollout.py on the
    port: live answers byte for byte those of a server that does not
    shadow, and the report catching exactly the inverted fingerprints;
  * stage -> offer -> drain -> promote -> rollback on the port CLI's server
    (CPU engines, fast paths, decision cache) beside a JAX server wired
    the same way: equal answers after each swap (and each equal to the
    interpreter over the set that serves), equal diff reports, equal
    status documents (times and engine statistics masked) and equal
    decision-cache hits, misses and sizes;
  * the refusals (promote when idle, rollback after a store reload, a
    strict gate's rejection, ...) with the same messages and details;
  * adoption on the engine: load hooks, no warm-up launch, both
    engines' staging untouched, a fresh lineage for the next reload, rebuild_compiled of
    the adopted set, a warm-up stopped part way, the float plane built
    once under concurrent first use;
  * the chaos seams shadow.offer, shadow.process, rollout.stage and
    rollout.promote, and the supervisor's revive;
  * the six flags and the empty-token refusal; the routes' codes and
    bodies against the JAX server's;
  * cedar-shadow and cedar-why against the JAX CLIs, and the Explainer's
    host-pack override they use.
"""

from __future__ import annotations

import copy
import io
import json
import pathlib
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import pytest

from cedar_tpu import cache as jcache
from cedar_tpu import rollout as j_rollout
from cedar_tpu.apis.v1alpha1 import PolicyObject as JPolicyObject
from cedar_tpu.cache.generation import plane_composite as j_plane_composite
from cedar_tpu.chaos import registry as j_reg
from cedar_tpu.cli import shadow as j_shadow_cli
from cedar_tpu.cli import webhook as j_webhook
from cedar_tpu.cli import why as j_why_cli
from cedar_tpu.compiler.lower import AUTHZ_SCHEMA_INFO as J_SCHEMA
from cedar_tpu.compiler.lower import lower_tiers as j_lower_tiers
from cedar_tpu.compiler.pack import pack as j_pack
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.entities.admission import AdmissionRequest as JAdmissionRequest
from cedar_tpu.explain import DiffAttributor as JDiffAttributor
from cedar_tpu.explain import Explainer as JExplainer
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.lang.format import format_policy as j_format_policy
from cedar_tpu.rollout import report as j_report
from cedar_tpu.rollout import shadow as j_shadow
from cedar_tpu.rollout import source as j_source
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.server.http import get_authorizer_attributes as j_attributes
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import rollout as t_rollout
from cedar_tpu_torch.apis.v1alpha1 import PolicyObject
from cedar_tpu_torch.chaos import registry as t_reg
from cedar_tpu_torch.cli import shadow as t_shadow_cli
from cedar_tpu_torch.cli import why as t_why_cli
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.compiler.lower import AUTHZ_SCHEMA_INFO, lower_tiers
from cedar_tpu_torch.compiler.pack import pack
from cedar_tpu_torch.engine import evaluator as t_evaluator
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.entities.admission import AdmissionRequest
from cedar_tpu_torch.explain import DiffAttributor, Explainer
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.lang.format import format_policy
from cedar_tpu_torch.rollout import report as t_report
from cedar_tpu_torch.rollout import shadow as t_shadow
from cedar_tpu_torch.rollout import source as t_source
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.admission import (
    CedarAdmissionHandler,
    allow_all_admission_policy_store,
)
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.server.sar import get_authorizer_attributes
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_rollout import (  # noqa: E402 — the JAX suite's policies and traffic
    CANDIDATE_POLICIES,
    LIVE_POLICIES,
    _traffic,
    review_body,
    sar_body,
)
from test_torch_cache import _jax_counters_restored  # noqa: E402,F401 — JAX counters put back

# the file the live and candidate directories hold: same name on both
# sides, so unchanged policies keep their ids, positions and reasons
POLICY_FILE = "rollout-test.cedar"


@pytest.fixture(autouse=True, scope="module")
def _jax_jit_caches_cleared():
    """The JAX planes traced here (its engines' serving shapes) stay in
    JAX's process-wide jit caches, and the JAX package's own tests count
    traces: the caches are cleared when the module ends."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(autouse=True)
def _pristine_registries():
    t_reg.default_registry().reset()
    j_reg.default_registry().reset()
    yield
    t_reg.default_registry().reset()
    j_reg.default_registry().reset()


def _masked(doc, keys=("started_at", "staged_at", "warm_stats", "live_engines")):
    """A status or report document with its wall-clock times and the
    engines' own statistics taken out (the port's engine reports other
    counters than the JAX engine: launches, staging, device memory; the
    port's status adds the shadow worker's launches); each live engine
    keeps its load_generation."""
    doc = copy.deepcopy(doc)

    def walk(d):
        if isinstance(d, dict):
            for k in list(d):
                if k == "live_engines":
                    d[k] = {role: e["load_generation"] for role, e in d[k].items()}
                elif k == "shadow_launches":
                    del d[k]
                elif k in keys:
                    d[k] = "<masked>"
                else:
                    walk(d[k])
        elif isinstance(d, list):
            for x in d:
                walk(x)

    walk(doc)
    return doc


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------------------------ sources


def _tier_doc(tiers, fmt) -> list:
    return [[(p.policy_id, p.filename, tuple(p.position), p.effect, fmt(p))
             for p in ps.policies()] for ps in tiers]


def _outcome(fn, fmt):
    try:
        return ("ok", _tier_doc(fn(), fmt))
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return ("error", type(e).__name__, str(e))


def _objects(cls, specs):
    return [cls.from_dict({"metadata": {"name": n, "uid": f"u-{n}",
                                        **({"labels": lab} if lab else {})},
                           "spec": {"content": c}}) for n, c, lab in specs]


CAND_LABEL = {"cedar.k8s.aws/rollout": "candidate"}
OBJECTS = {
    "labelled": [("a", LIVE_POLICIES, CAND_LABEL), ("b", CANDIDATE_POLICIES, None),
                 ("c", "forbid (principal, action, resource);", CAND_LABEL)],
    "other-value": [("a", LIVE_POLICIES, {"cedar.k8s.aws/rollout": "canary"})],
    "none": [("b", CANDIDATE_POLICIES, None)],
    "bad": [("a", "permit (nope", CAND_LABEL)],
}


def _write_dir(d: pathlib.Path, files: dict) -> pathlib.Path:
    d.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        if name.endswith("/"):
            (d / name).mkdir()
        else:
            (d / name).write_text(text)
    return d


SOURCE_CASES = {
    "directory": ("dir", {"b.cedar": CANDIDATE_POLICIES, "a.cedar": LIVE_POLICIES,
                          "notes.txt": "x", "sub/": ""}),
    "directory-missing": ("dir", None),
    "directory-empty": ("dir", {"notes.txt": "x"}),
    "directory-bad-file": ("dir", {"a.cedar": LIVE_POLICIES, "z.cedar": "permit (nope"}),
    "source": ("source", LIVE_POLICIES),
    "source-named": ("source-named", CANDIDATE_POLICIES),
    "source-bad": ("source", "forbid (principal, action, resource) when { 1 +"),
    "objects-labelled": ("objects", "labelled"),
    "objects-any-value": ("objects-any", "other-value"),
    "objects-other-value": ("objects", "other-value"),
    "objects-none": ("objects", "none"),
    "objects-bad": ("objects", "bad"),
}


@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_candidate_sources_equal_jax(tmp_path, case):
    kind, arg = SOURCE_CASES[case]
    out = []
    for src, apis, fmt in ((t_source, PolicyObject, format_policy),
                           (j_source, JPolicyObject, j_format_policy)):
        if kind == "dir":
            d = tmp_path / "cand"
            if arg is not None and not d.exists():
                _write_dir(d, arg)
            fn = lambda: src.candidate_tiers_from_directory(str(d))  # noqa: E731
        elif kind == "source":
            fn = lambda: src.candidate_tiers_from_source(arg)  # noqa: E731
        elif kind == "source-named":
            fn = lambda: src.candidate_tiers_from_source(arg, "named.cedar")  # noqa: E731
        else:
            objs = _objects(apis, OBJECTS[arg])
            value = None if kind == "objects-any" else src.CANDIDATE_LABEL_VALUE
            fn = lambda: src.candidate_tiers_from_objects(objs, value=value)  # noqa: E731
        out.append(_outcome(fn, fmt))
    assert out[0] == out[1]
    assert t_source.CANDIDATE_LABEL == j_source.CANDIDATE_LABEL
    assert t_source.CANDIDATE_LABEL_VALUE == j_source.CANDIDATE_LABEL_VALUE


# ------------------------------------------------------------------ reports


@pytest.mark.parametrize("pair,kind", [
    (("allow", "x", "deny", "y"), "allow_to_deny"),
    (("deny", "x", "allow", "y"), "deny_to_allow"),
    (("no_opinion", "", "allow", "r"), "decision_changed"),
    (("deny", "r", "no_opinion", ""), "decision_changed"),
    (("allow", "r1", "allow", "r2"), "reason_changed"),
    (("allow", "r", "allow", "r"), None),
])
def test_classify_decision_diff_equals_jax(pair, kind):
    assert t_report.classify_decision_diff(*pair) == kind
    assert j_report.classify_decision_diff(*pair) == kind


@pytest.mark.parametrize("cap", [1, 2, 64])
def test_report_ring_and_counters_equal_jax(cap):
    docs = []
    for mod in (t_report, j_report):
        rep = mod.DiffReport(exemplar_cap=cap)
        rep.record_diff("authorization", "allow_to_deny", "fp1", {}, {})
        rep.record_diff("authorization", "allow_to_deny", "fp2", {}, {})
        rep.record_diff("admission", "deny_to_allow", "fp3", {"a": 1}, {"b": 2},
                        attribution={"live": {"policyId": "p"}})
        rep.record_match("admission")
        rep.record_shed("authorization")
        rep.record_skipped("admission")
        rep.record_error()
        docs.append((_masked(rep.to_dict()), sorted(rep.diff_fingerprints()),
                     rep.total_diffs, rep.total_evaluations, rep.render_text()))
    assert docs[0] == docs[1]
    # the ring keeps the newest exemplars; the counters keep everything
    assert docs[0][2] == 3 and len(docs[0][1]) == min(cap, 3)


def _interp_stacks(pkg: str, src: str):
    """(authorizer, admission handler) on the interpreter over one tier of
    ``src`` named as the live directory store names it."""
    if pkg == "port":
        ps = t_source.candidate_tiers_from_source(src, POLICY_FILE)[0]
        stores = TieredPolicyStores([MemoryStore(POLICY_FILE, ps)])
        return (CedarWebhookAuthorizer(stores), CedarAdmissionHandler(TieredPolicyStores(
            list(stores.stores) + [allow_all_admission_policy_store()])))
    ps = j_source.candidate_tiers_from_source(src, POLICY_FILE)[0]
    stores = JTieredPolicyStores([JMemoryStore(POLICY_FILE, ps)])
    return (j_auth.CedarWebhookAuthorizer(stores), j_adm.CedarAdmissionHandler(
        JTieredPolicyStores(list(stores.stores) + [j_adm.allow_all_admission_policy_store()])))


def _report_of(pkg: str, bodies, attributed: bool, cap: int):
    rep_mod = t_report if pkg == "port" else j_report
    attrs_of = get_authorizer_attributes if pkg == "port" else j_attributes
    req_cls = AdmissionRequest if pkg == "port" else JAdmissionRequest
    live, cand = _interp_stacks(pkg, LIVE_POLICIES), _interp_stacks(pkg, CANDIDATE_POLICIES)
    attributor = None
    if attributed:
        from types import SimpleNamespace

        cls = DiffAttributor if pkg == "port" else JDiffAttributor
        attributor = cls(
            candidate=SimpleNamespace(
                authz_engine=None, admission_engine=None,
                tiers=[s.policy_set() for s in cand[0].stores], admission_handler=cand[1]),
            live_authz_tiers=[s.policy_set() for s in live[0].stores],
            live_admission_tiers=[s.policy_set() for s in live[1].stores],
        )
    rep = rep_mod.DiffReport(exemplar_cap=cap)
    kinds = []
    for endpoint, body in bodies:
        if endpoint == "authorize":
            a = attrs_of(json.loads(body))
            kinds.append(rep_mod.compare_authorization(
                rep, a, live[0].authorize(a), cand[0].authorize(a), attributor=attributor))
        else:
            r = req_cls.from_admission_review(json.loads(body))
            lr, cr = live[1].handle(r), cand[1].handle(r)
            kinds.append(rep_mod.compare_admission(
                rep, r, (lr.allowed, lr.message or ""), (cr.allowed, cr.message or ""),
                attributor=attributor))
    return kinds, _masked(rep.to_dict()), rep.render_text()


@pytest.mark.parametrize("attributed", [False, True])
@pytest.mark.parametrize("cap", [4, 4096])
def test_diff_report_from_the_same_pairs_equals_jax(attributed, cap):
    """1,100 bodies (800 SARs, 300 reviews), each answered by the live and
    the candidate interpreter stacks of each package, compared into each
    package's DiffReport: the same kinds, documents and text."""
    bodies = _traffic()
    port, jax = (_report_of(p, bodies, attributed, cap) for p in ("port", "jax"))
    assert port == jax
    kinds, doc, _ = port
    assert doc["diffs"]["allow_to_deny"] > 0 and doc["diffs"]["deny_to_allow"] > 0
    assert sum(k is not None for k in kinds) == doc["total_diffs"]
    assert all(("attribution" in e) == attributed for e in doc["exemplars"])


def test_compare_publishes_the_shadow_metrics():
    """publish_metrics feeds the cedar_shadow_* families, whose names and
    help are the JAX package's; offline replays publish nothing."""
    fam = t_metrics.process_metrics()
    ev = fam.shadow_evaluations_total.value(path="authorization")
    diffs = fam.shadow_diffs_total.value(kind="allow_to_deny")
    rep = t_report.DiffReport()
    a = get_authorizer_attributes(json.loads(sar_body("alice", "pods")))
    t_report.compare_authorization(rep, a, ("allow", "r"), ("deny", "r"), publish_metrics=True)
    t_report.compare_authorization(rep, a, ("allow", "r"), ("deny", "r"))
    assert fam.shadow_evaluations_total.value(path="authorization") == ev + 1
    assert fam.shadow_diffs_total.value(kind="allow_to_deny") == diffs + 1
    from cedar_tpu.server import metrics as j_metrics

    for name in ("shadow_evaluations_total", "shadow_diffs_total", "shadow_shed_total",
                 "rollout_generation"):
        t, j = getattr(fam, name), getattr(j_metrics, name)
        assert (t.name, t.help, t.label_names) == (j.name, j.help, tuple(j.label_names))
    assert "cedar_rollout_generation" in "\n".join(fam.collect())


# ------------------------------------------- the recorded-traffic differential


def _interp_server(pkg: str, src: str, rollout=None, ready: bool = True, **kw):
    if pkg == "port":
        ps = t_source.candidate_tiers_from_source(src, POLICY_FILE)[0]
        store = MemoryStore(POLICY_FILE, ps, load_complete=ready)
        stores = TieredPolicyStores([store])
        return WebhookServer(
            CedarWebhookAuthorizer(stores),
            admission_handler=CedarAdmissionHandler(
                TieredPolicyStores([store, allow_all_admission_policy_store()])),
            rollout=rollout, **kw)
    ps = j_source.candidate_tiers_from_source(src, POLICY_FILE)[0]
    store = JMemoryStore(POLICY_FILE, ps, load_complete=ready)
    stores = JTieredPolicyStores([store])
    return JWebhookServer(
        j_auth.CedarWebhookAuthorizer(stores),
        j_adm.CedarAdmissionHandler(
            JTieredPolicyStores([store, j_adm.allow_all_admission_policy_store()])),
        rollout=rollout, **kw)


def _expected_kinds(bodies) -> dict:
    """fingerprint -> diff kind of every body the candidate inverts (the
    JAX suite's derivation)."""
    from cedar_tpu_torch.cache.fingerprint import fingerprint_body

    out = {}
    for endpoint, body in bodies:
        doc = json.loads(body)
        if endpoint == "authorize":
            spec = doc["spec"]
            who, res = spec["user"], spec["resourceAttributes"]["resource"]
            kind = {("alice", "pods"): "allow_to_deny",
                    ("carol", "secrets"): "deny_to_allow"}.get((who, res))
        else:
            env = (doc["request"]["object"]["metadata"].get("labels") or {}).get("env")
            kind = {"prod": "deny_to_allow", "heha": "allow_to_deny"}.get(env)
        if kind:
            out[fingerprint_body(endpoint, body)] = kind
    return out


def test_recorded_traffic_differential_equals_jax():
    """1,100 bodies through a port server that shadows (interpreter stacks,
    no sampling, a queue that cannot fill, no duty-cycle bound) and one
    that does not: byte-identical live answers; the report catches exactly
    the inverted fingerprints, skips and errs on nothing, and equals the
    report of a JAX server that shadows the same traffic."""
    bodies = _traffic()
    reports = {}
    for pkg, mod in (("port", t_rollout), ("jax", j_rollout)):
        plain = _interp_server(pkg, LIVE_POLICIES)
        rollout = mod.RolloutController(exemplar_cap=4096, queue_depth=4096, duty_cycle=1.0)
        shadowed = _interp_server(pkg, LIVE_POLICIES, rollout=rollout)
        tiers = (t_source if pkg == "port" else j_source).candidate_tiers_from_source(
            CANDIDATE_POLICIES, POLICY_FILE)
        rollout.stage(tiers=tiers, description="inverting candidate", warm="off")
        try:
            for endpoint, body in bodies:
                handle = "handle_authorize" if endpoint == "authorize" else "handle_admit"
                base = getattr(plain, handle)(body)
                if pkg == "port":
                    assert json.dumps(base).encode() == json.dumps(
                        getattr(shadowed, handle)(body)).encode(), (endpoint, body)
                else:
                    getattr(shadowed, handle)(body)
            assert rollout.drain(60)
            reports[pkg] = rollout.report.to_dict()
        finally:
            shadowed.stop()
            plain.stop()
    report = reports["port"]
    assert {e["fingerprint"]: e["kind"] for e in report["exemplars"]} == _expected_kinds(bodies)
    assert report["skipped"] == {} and report["candidate_errors"] == 0
    assert report["diffs"]["reason_changed"] == report["diffs"]["decision_changed"] == 0
    assert sum(report["evaluations"].values()) == len(bodies)
    assert _masked(report) == _masked(reports["jax"])


# ------------------------------------------------------------- shadow queue


class _SlowCandidate:
    """A duck-typed candidate stack whose authorize blocks until released."""

    def __init__(self, release):
        outer = self

        class _A:
            @staticmethod
            def authorize_batch(attrs):
                outer.release.wait(10)
                return [("allow", "")] * len(attrs)

        class _H:
            @staticmethod
            def handle_batch(reqs, **kw):
                return []

        self.release = release
        self.authorizer, self.admission_handler = _A(), _H()


def test_full_queue_sheds_not_blocks():
    """With the worker held inside a batch and the bounded queue full,
    offers return at once as shed (counted in the report and
    cedar_shadow_shed_total): the live caller never waits."""
    release = threading.Event()
    report = t_report.DiffReport()
    shadow = t_shadow.ShadowEvaluator(_SlowCandidate(release), report, queue_depth=4)
    fam = t_metrics.process_metrics()
    shed0 = fam.shadow_shed_total.value(path="authorization")
    try:
        live = ("allow", "")
        shadow.offer("authorize", sar_body(), live)
        deadline = time.time() + 5
        shed = 0
        while shed == 0 and time.time() < deadline:
            t0 = time.monotonic()
            ok = shadow.offer("authorize", sar_body(), live)
            assert time.monotonic() - t0 < 0.5, "offer blocked"
            shed += not ok
        assert shed and report.shed["authorization"] >= 1
        assert fam.shadow_shed_total.value(path="authorization") >= shed0 + 1
    finally:
        release.set()
        shadow.stop()


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_sampling_draws_equal_jax(rate):
    """The same seed samples the same offers in both packages; rate 0
    offers nothing and evaluates nothing."""
    got = []
    for mod, rep_mod in ((t_shadow, t_report), (j_shadow, j_report)):
        release = threading.Event()
        release.set()
        report = rep_mod.DiffReport()
        shadow = mod.ShadowEvaluator(_SlowCandidate(release), report, sample_rate=rate,
                                     seed=7, queue_depth=4096)
        try:
            offered = [shadow.offer("authorize", sar_body(f"u{i}"), ("allow", ""))
                       for i in range(200)]
            assert shadow.drain(10)
            got.append((offered, report.to_dict()["evaluations"]))
        finally:
            shadow.stop()
    assert got[0] == got[1]
    assert sum(got[0][0]) == {0.0: 0, 1.0: 200}.get(rate, sum(got[0][0]))


def test_unready_live_answers_not_offered():
    """A pre-ready NoOpinion and a pre-ready allow are start-up artifacts:
    the server does not offer them (as on the JAX server)."""
    docs = []
    for pkg, mod in (("port", t_rollout), ("jax", j_rollout)):
        rollout = mod.RolloutController()
        tiers = (t_source if pkg == "port" else j_source).candidate_tiers_from_source(
            CANDIDATE_POLICIES, POLICY_FILE)
        rollout.stage(tiers=tiers, warm="off")
        server = _interp_server(pkg, LIVE_POLICIES, rollout=rollout, ready=False)
        try:
            resp = server.handle_authorize(sar_body("alice", "pods"))
            adm = server.handle_admit(review_body(env="heha"))
            assert rollout.drain(10)
            docs.append((resp, adm, rollout.report.to_dict()["evaluations"]))
        finally:
            server.stop()
            rollout.stop()
    assert docs[0] == docs[1]
    assert docs[0][0]["status"]["allowed"] is False and docs[0][1]["response"]["allowed"]
    assert docs[0][2] == {}


def test_candidate_batch_failure_is_a_candidate_error():
    """A candidate evaluation that raises (a failed launch) counts as a
    candidate error and is never diffed or answered on another path; the
    worker goes on. Admission asks the handler to raise, so its
    allow-on-error answer is not diffed as a decision."""
    calls = []

    class _Boom:
        class authorizer:  # noqa: N801 — duck-typed stack
            @staticmethod
            def authorize_batch(attrs):
                raise RuntimeError("launch failed")

        class admission_handler:  # noqa: N801
            @staticmethod
            def handle_batch(reqs, raise_errors=False):
                calls.append(raise_errors)
                raise RuntimeError("launch failed")

    report = t_report.DiffReport()
    shadow = t_shadow.ShadowEvaluator(_Boom(), report, duty_cycle=1.0)
    try:
        shadow.offer("authorize", sar_body(), ("allow", ""))
        assert shadow.drain(10)
        review = {"response": {"allowed": True, "status": {"code": 200}}}
        shadow.offer("admit", review_body(), review)
        assert shadow.drain(10)
        shadow.offer("admit", review_body(), {"response": {"status": {"code": 500}}})
        assert shadow.drain(10)
    finally:
        shadow.stop()
    doc = report.to_dict()
    assert doc["candidate_errors"] == 2 and doc["evaluations"] == {}
    assert doc["skipped"] == {"admission": 1} and calls == [True]


# ------------------------------------------------- the lifecycle on engines


def _policy_dirs(tmp_path):
    live = _write_dir(tmp_path / "live", {POLICY_FILE: LIVE_POLICIES})
    cand = _write_dir(tmp_path / "candidate", {POLICY_FILE: CANDIDATE_POLICIES})
    return live, cand


def _port_server(policy_dir, *flags):
    """The port CLI's server on the CPU over one directory store: fast
    paths, breakers and the decision cache at their defaults; the shadow
    queue deep and unthrottled, so no offer sheds."""
    cfg = policy_dir.parent / "store-config.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(policy_dir)}}]}}))
    args = make_parser().parse_args([
        "--config", str(cfg), "--device", "cpu", "--insecure", "--secure-port", "0",
        "--metrics-port", "0", "--request-timeout-ms", "60000",
        "--shadow-queue-depth", "4096", "--shadow-duty-cycle", "1.0", *flags])
    srv = build_server(args)
    srv.start()
    return srv


def _jax_server(policy_dir, control=True, token=None):
    """A JAX server wired as its CLI wires the device backend: engines
    (incremental, 64 buckets) bound into both stacks, the SAR fast path,
    the decision cache over the engine's plane lineage, a rollout
    controller over both engines."""
    store = JDirectoryPolicyStore(str(policy_dir), start_ticker=False)
    stores = JTieredPolicyStores([store])
    adm_stores = JTieredPolicyStores([store, j_adm.allow_all_admission_policy_store()])
    engines = []
    for name, ts in (("authorization", stores), ("admission", adm_stores)):
        e = TPUPolicyEngine(name=name, warm_max_batch=1, incremental=True, shard_buckets=64)
        e.load([s.policy_set() for s in ts], warm="off")
        engines.append(e)
    engine, adm = engines
    authz = j_auth.CedarWebhookAuthorizer(
        stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
    handler = j_adm.CedarAdmissionHandler(
        adm_stores, evaluate=adm.evaluate, evaluate_batch=adm.evaluate_batch)
    # the JAX CLI wires a CRD candidate provider whatever the stores are
    rollout = j_rollout.RolloutController(authz_engine=engine, admission_engine=adm,
                                          queue_depth=4096, duty_cycle=1.0,
                                          crd_candidate_provider=lambda: [])
    cache = jcache.DecisionCache(generation_fn=lambda: j_plane_composite(stores, engine),
                                 path="authorization")
    srv = JWebhookServer(authz, handler, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=JSARFastPath(engine, authz), pipeline_depth=2,
                         request_timeout_s=60.0, decision_cache=cache, rollout=rollout,
                         rollout_control_enabled=control, rollout_control_token=token)
    srv.start()
    return srv


def _window():
    """A window of 160 SARs over 40 distinct keys (each sent four times:
    cache hits after the first) and 60 reviews over 3 label states."""
    users, resources = ["alice", "bob", "carol", "dave"], ["pods", "secrets", "services"]
    keys = [("authorize", sar_body(users[i % 4], resources[(i // 4) % 3], f"ns-{i % 5}"))
            for i in range(40)]
    envs = ["prod", "heha", None]
    reviews = [("admit", review_body(env=envs[i % 3], uid=f"r{i}", name=f"c{i}"))
               for i in range(60)]
    return keys * 4 + reviews


def _serve(srv, bodies) -> list:
    return [json.dumps(srv.handle_authorize(b) if ep == "authorize" else srv.handle_admit(b))
            for ep, b in bodies]


def _oracle(src: str, bodies) -> list:
    """The answers of a port interpreter server over one tier of ``src``."""
    srv = _interp_server("port", src)
    try:
        return _serve(srv, bodies)
    finally:
        srv.stop()


def _cache_doc(srv) -> dict:
    s = srv.decision_cache.stats()
    return {k: s[k] for k in ("hits", "misses", "size")}


def test_stage_shadow_promote_rollback_equals_jax(tmp_path):
    """The lifecycle on the port CLI's server (CPU engines) beside a JAX
    server: after each step the same answers (the interpreter's over the
    serving set: 0 stale answers across both swaps), the same diff
    report and status documents, and the same decision-cache hits,
    misses and sizes on the same key sequence. On the port, promotion and
    rollback add no warm-up launch, and the fast path's native encoder of
    the promoted set exists before its first request."""
    live_dir, cand_dir = _policy_dirs(tmp_path)
    t, j = _port_server(live_dir, "--rollout-insecure-control"), _jax_server(live_dir)
    window = _window()
    want_live, want_cand = _oracle(LIVE_POLICIES, window), _oracle(CANDIDATE_POLICIES, window)
    try:
        steps = {}
        assert _masked(t.rollout.status()) == _masked(j.rollout.status())
        staged = [s.rollout.stage(directory=str(cand_dir), warm="sync") for s in (t, j)]
        assert staged[0]["candidate"]["warm_state"] == "ready"
        assert _masked(staged[0]) == _masked(staged[1])
        engine = t.fastpath.engine
        warm0 = (dict(engine.warmup_launches), dict(t.admission_fastpath.engine.warmup_launches))
        for step in ("staged", "promoted", "rolled_back"):
            if step == "promoted":
                docs = [s.rollout.promote() for s in (t, j)]
                assert _masked(docs[0]) == _masked(docs[1]) and docs[0]["state"] == "promoted"
                assert "SARFastPath" in engine.compiled_set.host_state
            elif step == "rolled_back":
                docs = [s.rollout.rollback() for s in (t, j)]
                assert _masked(docs[0]) == _masked(docs[1]) and docs[0]["state"] == "idle"
            got = _serve(t, window)
            assert got == _serve(j, window)
            assert got == (want_cand if step == "promoted" else want_live), step
            if step == "staged":
                assert t.rollout.drain(60) and j.rollout.drain(60)
                report = t.rollout.report.to_dict()
                assert _masked(report) == _masked(j.rollout.report.to_dict())
                assert report["evaluations"] == {"authorization": 160, "admission": 60}
                assert report["diffs"]["allow_to_deny"] > 0 and report["candidate_errors"] == 0
                assert _masked(t.rollout.status()) == _masked(j.rollout.status())
            steps[step] = _cache_doc(t)
            assert steps[step] == _cache_doc(j), step
        assert (dict(engine.warmup_launches),
                dict(t.admission_fastpath.engine.warmup_launches)) == warm0
        assert steps["promoted"]["misses"] > steps["staged"]["misses"]
    finally:
        t.stop()
        j.stop()


def _engine_pair(pkg: str, src: str = LIVE_POLICIES):
    """(authorization engine, admission engine) of one package, loaded."""
    tiers_of = (t_source if pkg == "port" else j_source).candidate_tiers_from_source
    tail = (allow_all_admission_policy_store() if pkg == "port"
            else j_adm.allow_all_admission_policy_store()).policy_set()
    out = []
    for name, extra in (("authorization", []), ("admission", [tail])):
        tiers = tiers_of(src, POLICY_FILE) + extra
        if pkg == "port":
            e = TorchPolicyEngine(device="cpu", name=name, incremental=True)
            e.load(tiers, max_batch=1)
        else:
            e = TPUPolicyEngine(name=name, warm_max_batch=1, incremental=True)
            e.load(tiers, warm="off")
        out.append(e)
    return out


_BLOWUP = " && ".join('(resource.resource == "r1" || resource.name == "never")'
                      for _ in range(12))
UNLOWERABLE_CANDIDATE = LIVE_POLICIES + (
    'permit (principal in k8s::Group::"joiners", action == k8s::Action::"get", '
    f"resource is k8s::Resource)\n  when {{ {_BLOWUP} }};\n"
)


def _refusal(pkg: str, case: str):
    """Run one refusal scenario -> (error type, message, detail)."""
    mod = t_rollout if pkg == "port" else j_rollout
    src = t_source if pkg == "port" else j_source
    engine, adm = _engine_pair(pkg)
    rollout = mod.RolloutController(authz_engine=engine, admission_engine=adm)
    cand = src.candidate_tiers_from_source(CANDIDATE_POLICIES, POLICY_FILE)
    try:
        if case == "promote-idle":
            rollout.promote()
        elif case == "rollback-idle":
            rollout.rollback()
        elif case == "stage-no-source":
            rollout.stage()
        elif case == "stage-no-tiers":
            rollout.stage(tiers=[])
        elif case == "stage-crd-no-provider":
            rollout.stage(crd=True)
        elif case == "stage-bad-directory":
            rollout.stage(directory="/nonexistent/candidate-dir")
        elif case == "strict-gate":
            rollout.stage(tiers=src.candidate_tiers_from_source(
                UNLOWERABLE_CANDIDATE, POLICY_FILE), warm="off")
        elif case == "stage-over-promotion":
            rollout.stage(tiers=cand, warm="off")
            rollout.promote()
            rollout.stage(tiers=cand, warm="off")
        elif case in ("rollback-after-reload", "rollback-after-admission-reload"):
            rollout.stage(tiers=cand, warm="off")
            rollout.promote(force=True)
            target = engine if case == "rollback-after-reload" else adm
            tiers = src.candidate_tiers_from_source(LIVE_POLICIES, POLICY_FILE)
            if target is adm:
                tiers += [(allow_all_admission_policy_store() if pkg == "port"
                           else j_adm.allow_all_admission_policy_store()).policy_set()]
            if pkg == "port":
                target.load(tiers, max_batch=1)
            else:
                target.load(tiers, warm="off")
            rollout.rollback()
        else:
            raise AssertionError(case)
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return type(e).__name__, str(e), getattr(e, "detail", None), rollout.status()["state"]
    finally:
        rollout.stop()
    return None


REFUSALS = ["promote-idle", "rollback-idle", "stage-no-source", "stage-no-tiers",
            "stage-crd-no-provider", "stage-bad-directory", "strict-gate",
            "stage-over-promotion", "rollback-after-reload",
            "rollback-after-admission-reload"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_equal_jax(case):
    port, jax = _refusal("port", case), _refusal("jax", case)
    assert port is not None and port == jax


def test_permissive_gate_stages_what_strict_refuses():
    engine, adm = _engine_pair("port")
    lax = t_rollout.RolloutController(authz_engine=engine, stage_validation_mode="permissive")
    try:
        doc = lax.stage(tiers=t_source.candidate_tiers_from_source(
            UNLOWERABLE_CANDIDATE, POLICY_FILE), warm="off")
        jlax = j_rollout.RolloutController(stage_validation_mode="permissive")
        jdoc = jlax.stage(tiers=j_source.candidate_tiers_from_source(
            UNLOWERABLE_CANDIDATE, POLICY_FILE), warm="off")
        jlax.stop()
    finally:
        lax.stop()
    assert doc["state"] == jdoc["state"] == "staged"
    assert doc["candidate"]["analysis_findings"] == jdoc["candidate"]["analysis_findings"]
    assert lax._candidate.authz_engine.compiled_set.fallback


def test_discard_then_stage_again_and_supersede_equal_jax():
    """Staged rollback discards (no generation step on the live engines);
    a promotion a store reload superseded is finalized by the next stage;
    the lifecycle generation counts the same on both."""
    out = []
    for pkg, mod, src in (("port", t_rollout, t_source), ("jax", j_rollout, j_source)):
        engine, adm = _engine_pair(pkg)
        rollout = mod.RolloutController(authz_engine=engine, admission_engine=adm)
        cand = src.candidate_tiers_from_source(CANDIDATE_POLICIES, POLICY_FILE)
        seq = [rollout.stage(tiers=cand, warm="off")["state"], engine.load_generation]
        seq += [rollout.rollback()["state"], engine.load_generation]
        rollout.stage(tiers=cand, warm="off")
        rollout.promote(force=True)
        if pkg == "port":
            engine.load(cand, max_batch=1)
        else:
            engine.load(cand, warm="off")
        seq += [rollout.stage(tiers=cand, warm="off")["state"], rollout.generation,
                engine.load_generation]
        rollout.stop()
        out.append(seq)
    assert out[0] == out[1] == ["staged", 1, "idle", 1, "staged", 5, 3]


def test_crd_candidates_stage_through_the_provider():
    """stage(crd=True) builds the candidate from the provider's labelled
    objects (the CLI wires the CRD stores' candidate_objects)."""
    from cedar_tpu_torch.stores.crd import CRDPolicyStore

    objs = _objects(PolicyObject, OBJECTS["labelled"])

    class _Src:
        def list(self):
            return list(objs)

        def watch(self, on_event, stop):
            stop.wait(5)

    store = CRDPolicyStore(source=_Src(), start=False)
    store._relist()
    assert [o.name for o in store.candidate_objects()] == ["a", "c"]
    rollout = t_rollout.RolloutController(crd_candidate_provider=store.candidate_objects)
    try:
        status = rollout.stage(crd=True, warm="off")
    finally:
        rollout.stop()
    jrollout = j_rollout.RolloutController(
        crd_candidate_provider=lambda: _objects(JPolicyObject, OBJECTS["labelled"][::2]))
    try:
        jstatus = jrollout.stage(crd=True, warm="off")
    finally:
        jrollout.stop()
    assert _masked(status) == _masked(jstatus)
    assert status["candidate"]["description"] == "crd-label"
    assert status["candidate"]["policies"] == 5


# ------------------------------------------------------ adoption on the engine


def _port_engine(src=LIVE_POLICIES, max_batch=1, **kw):
    e = TorchPolicyEngine(device="cpu", incremental=True, **kw)
    e.load(t_source.candidate_tiers_from_source(src, POLICY_FILE), max_batch=max_batch)
    return e


def test_adoption_runs_the_load_hooks_before_publishing():
    live, cand = _port_engine(), _port_engine(CANDIDATE_POLICIES)
    seen = []
    live.load_hooks.append(lambda cs: seen.append((cs, live.compiled_set)))
    prior, gen = live.adopt_compiled(cand.compiled_set, donor=cand)
    assert seen[0][0] is cand.compiled_set and seen[0][1] is prior
    assert live.compiled_set is cand.compiled_set and gen == live.load_generation == 2
    assert live.last_adoption_scope == cand.compiled_set.plane.scope == "full"

    def boom(cs):
        raise RuntimeError("hook failed")

    live.load_hooks.append(boom)
    with pytest.raises(RuntimeError, match="hook failed"):
        live.adopt_compiled(prior)
    assert live.compiled_set is cand.compiled_set and live.load_generation == 2


def test_adoption_refuses_a_set_of_another_device():
    live = _port_engine()

    class _Set:
        device = __import__("torch").device("meta")

    with pytest.raises(ValueError, match="lives on meta"):
        live.adopt_compiled(_Set())
    with pytest.raises(ValueError, match="required"):
        live.adopt_compiled(None)


def test_adoption_leaves_both_engines_staging_as_it_was():
    """The port has no mesh, so ``donor`` carries nothing: the live
    engine's staging pool and its bucket diagnostic show only the shapes
    it acquired itself, and the donor keeps its free buffers."""
    live, cand = _port_engine(), _port_engine(CANDIDATE_POLICIES, max_batch=64)
    buf = cand._staging.acquire((8, 3), "int32")
    cand._staging.release(buf)
    before = live.staging_stats()
    live.adopt_compiled(cand.compiled_set, donor=cand)
    assert live.staging_stats() == before and 8 not in before["buckets"]
    assert cand._staging.acquire((8, 3), "int32") is buf


@pytest.mark.parametrize("case", ["reload-after-promotion", "reload-after-rollback"])
def test_lineage_after_adoption_equals_jax(case):
    """A store reload after a promotion does not continue the lineage of
    the plane the engine last loaded (that plane no longer serves): a
    fresh structural id, as the JAX engine gives. After a rollback the
    restored plane is the engine's own last load again, and a reload
    continues its lineage (same structural id, incremental)."""
    out = []
    for pkg in ("port", "jax"):
        live, _ = _engine_pair(pkg)
        cand, _ = _engine_pair(pkg, CANDIDATE_POLICIES)
        tiers_of = (t_source if pkg == "port" else j_source).candidate_tiers_from_source
        if pkg == "port":
            def load(e, src):
                return e.load(tiers_of(src, POLICY_FILE), max_batch=1)
        else:
            def load(e, src):
                return e.load(tiers_of(src, POLICY_FILE), warm="off")
        s0 = live.compiled_set.plane.structural
        prior, _ = live.adopt_compiled(cand.compiled_set)
        if case == "reload-after-rollback":
            live.adopt_compiled(prior)
        scope = load(live, LIVE_POLICIES.replace('"bob"', '"bobby"'))["compile_scope"]
        pl = live.compiled_set.plane
        out.append((pl.structural == s0, pl.structural == cand.compiled_set.plane.structural,
                    scope, pl.scope, sorted(pl.dirty), live.load_generation))
    assert out[0] == out[1]
    if case == "reload-after-promotion":
        assert out[0][:2] == (False, False)
    else:
        assert out[0][:4] == (True, False, "incremental", "incremental") and out[0][4]


def test_rebuild_compiled_rebuilds_the_adopted_set():
    live, cand = _port_engine(), _port_engine(CANDIDATE_POLICIES)
    live.adopt_compiled(cand.compiled_set)
    stats = live.rebuild_compiled(max_batch=1)
    assert stats is not None and live.last_adoption_scope == "rebuild"
    assert live.compiled_set is not cand.compiled_set
    assert live.compiled_set.packed is cand.compiled_set.packed
    attrs = get_authorizer_attributes(json.loads(sar_body("alice", "pods")))
    from cedar_tpu_torch.server.authorizer import record_to_cedar_resource

    em, req = record_to_cedar_resource(attrs)
    assert live.evaluate(em, req)[0] == cand.evaluate(em, req)[0] == "deny"


def test_warmup_stops_when_told():
    e = _port_engine()
    polls = []

    def should_continue():
        polls.append(1)
        return len(polls) <= 2

    launches = e.warmup(4096, should_continue=should_continue)
    # the CPU takes the plain versions: no launch counts, on either call
    assert e.warm_buckets == (1, 8) and len(polls) == 3
    assert e.warmup(8, should_continue=lambda: False) == dict.fromkeys(launches, 0)
    assert e.warm_buckets == ()


def test_float_plane_is_built_once_under_concurrent_first_use():
    e = _port_engine()
    cs = e.compiled_set
    cs._W_f32 = None
    got, start = [], threading.Barrier(16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def first_use():
        start.wait(10)
        got.append(cs.W_f32)

    try:
        threads = [threading.Thread(target=first_use) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 16 and all(w is got[0] for w in got)
    assert not any(th.is_alive() for th in threads)


def test_warm_threads_are_joined_at_exit_and_polled():
    t = threading.Thread(target=lambda: None)
    t_evaluator.track_warm_thread(t)
    assert t in t_evaluator._live_warm_threads
    t_evaluator.untrack_warm_thread(t)
    assert t not in t_evaluator._live_warm_threads
    assert t_evaluator.warm_shutdown_set() is False


def test_async_warm_reaches_ready_and_a_superseded_candidate_stops():
    engine, adm = _engine_pair("port")
    engine.warm_buckets = adm.warm_buckets = (1, 8, 32)
    rollout = t_rollout.RolloutController(authz_engine=engine, admission_engine=adm)
    cand = t_source.candidate_tiers_from_source(CANDIDATE_POLICIES, POLICY_FILE)
    try:
        rollout.stage(tiers=cand)
        assert _wait(rollout.warm_ready)
        stats = rollout.status()["candidate"]["warm_stats"]
        assert set(stats) == {"candidate-authorization", "candidate-admission"}
        assert all(s["buckets"] == [1, 8, 32] for s in stats.values())
        first = rollout._candidate
        first.warm_state = "unwarmed"
        rollout.stage(tiers=cand, warm="off")
        rollout._start_warm(first, "sync")
        assert first.warm_state == "warming"  # superseded: never claims ready
    finally:
        rollout.stop()


# -------------------------------------------------------------- chaos seams


def _offer_one(mod, rep_mod, reg_mod, seam, kind):
    """Arm one fault, offer one SAR to an evaluator over an interpreter
    candidate -> (offer result, report, worker alive, revived)."""
    rule = {"seam": seam, "kind": kind, "count": 1}
    if kind == "latency":
        rule["delay_s"] = 0.01
    reg_mod.default_registry().configure({"faults": [rule]})
    reg_mod.default_registry().arm()
    cand = _interp_stacks("port" if mod is t_shadow else "jax", CANDIDATE_POLICIES)
    stack = type("C", (), {"authorizer": cand[0], "admission_handler": cand[1]})()
    report = rep_mod.DiffReport()
    shadow = mod.ShadowEvaluator(stack, report, duty_cycle=1.0)
    try:
        ok = shadow.offer("authorize", sar_body("alice", "pods"), ("allow", "r"))
        shadow.drain(5)
        if (seam, kind) == ("shadow.process", "kill"):
            shadow._worker.join(5)  # the injected kill unwinds the worker
        alive = shadow._worker.is_alive()
        revived = shadow.revive()
        reg_mod.default_registry().disarm()
        again = shadow.offer("authorize", sar_body("carol", "secrets"), ("deny", "r"))
        assert shadow.drain(10)
        return ok, again, _masked(report.to_dict()), alive, revived
    finally:
        shadow.stop()
        reg_mod.default_registry().reset()


@pytest.mark.parametrize("seam,kind", [
    ("shadow.offer", "error"), ("shadow.offer", "kill"), ("shadow.offer", "latency"),
    ("shadow.process", "error"), ("shadow.process", "kill"),
])
def test_shadow_seams_equal_jax(seam, kind):
    port = _offer_one(t_shadow, t_report, t_reg, seam, kind)
    jax = _offer_one(j_shadow, j_report, j_reg, seam, kind)
    assert port == jax
    if seam == "shadow.process" and kind == "kill":
        assert port[3] is False and port[4] is True  # dead, then revived
    if seam == "shadow.offer" and kind != "latency":
        assert port[0] is False and port[2]["shed"] == {"authorization": 1}


@pytest.mark.parametrize("seam", ["rollout.stage", "rollout.promote"])
def test_rollout_seams_equal_jax(seam):
    out = []
    for pkg, mod, reg_mod, src in (("port", t_rollout, t_reg, t_source),
                                   ("jax", j_rollout, j_reg, j_source)):
        engine, adm = _engine_pair(pkg)
        rollout = mod.RolloutController(authz_engine=engine, admission_engine=adm)
        cand = src.candidate_tiers_from_source(CANDIDATE_POLICIES, POLICY_FILE)
        if seam == "rollout.promote":
            rollout.stage(tiers=cand, warm="off")
        reg_mod.default_registry().configure({"faults": [{"seam": seam, "kind": "error"}]})
        reg_mod.default_registry().arm()
        try:
            rollout.stage(tiers=cand, warm="off") if seam == "rollout.stage" else rollout.promote()
            got = None
        except Exception as e:  # noqa: BLE001 — the injected error
            got = (type(e).__name__, str(e))
        finally:
            reg_mod.default_registry().reset()
            rollout.stop()
        out.append((got, rollout.status()["state"], engine.load_generation))
    assert out[0] == out[1] and out[0][0] is not None


def test_supervisor_revives_a_killed_shadow_worker(tmp_path):
    """The CLI registers the shadow worker with the supervisor: a kill on
    shadow.process is revived within a few supervisor ticks, and later
    offers are evaluated."""
    live_dir, cand_dir = _policy_dirs(tmp_path)
    srv = _port_server(live_dir, "--rollout-insecure-control",
                       "--supervisor-interval-seconds", "0.1")
    try:
        assert "shadow.worker" in srv.supervisor.status()["components"]
        srv.rollout.stage(directory=str(cand_dir), warm="off")
        reg = t_reg.default_registry()
        reg.configure({"faults": [{"seam": "shadow.process", "kind": "kill", "count": 1}]})
        reg.arm()
        srv.handle_authorize(sar_body("alice", "pods"))
        assert _wait(lambda: srv.supervisor.status()["components"]["shadow.worker"]["restarts"]
                     >= 1, 10)
        reg.reset()
        srv.handle_authorize(sar_body("carol", "secrets"))
        assert srv.rollout.drain(10)
        assert srv.rollout.report.to_dict()["evaluations"] == {"authorization": 1}
    finally:
        srv.stop()


# --------------------------------------------------------------- flags, CLI

FLAGS = {
    "--rollout-candidate-dir": ("rollout_candidate_dir", "/x/cand"),
    "--shadow-sample-rate": ("shadow_sample_rate", "0.25"),
    "--shadow-queue-depth": ("shadow_queue_depth", "7"),
    "--shadow-duty-cycle": ("shadow_duty_cycle", "0.5"),
    "--rollout-control-token-file": ("rollout_control_token_file", "/x/token"),
    "--rollout-insecure-control": ("rollout_insecure_control", None),
}


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_rollout_flags_equal_jax(flag):
    dest, value = FLAGS[flag]
    argv = [flag] if value is None else [flag, value]
    tp, jp = make_parser(), j_webhook.make_parser()
    assert getattr(tp.parse_args([]), dest) == getattr(jp.parse_args([]), dest)
    assert getattr(tp.parse_args(argv), dest) == getattr(jp.parse_args(argv), dest)
    t_help = next(a.help for a in tp._actions if flag in a.option_strings)
    assert t_help


@pytest.mark.parametrize("content", ["", "  \n"])
def test_empty_token_file_refuses_to_start_as_jax(tmp_path, content):
    tok = tmp_path / "token"
    tok.write_text(content)
    argv = ["--backend", "interpreter", "--insecure", "--secure-port", "0",
            "--metrics-port", "0", "--rollout-control-token-file", str(tok)]
    with pytest.raises(ValueError) as te:
        build_server(make_parser().parse_args(argv))
    with pytest.raises(ValueError) as je:
        j_webhook.build_server(j_webhook.make_parser().parse_args(argv))
    assert str(te.value) == str(je.value)


def test_interpreter_backend_has_no_rollout_and_ignores_the_candidate_dir(tmp_path, caplog):
    live_dir, cand_dir = _policy_dirs(tmp_path)
    srv = _port_server(live_dir, "--backend", "interpreter", "--rollout-candidate-dir",
                       str(cand_dir))
    try:
        assert srv.rollout is None
        assert "requires --backend device" in caplog.text
    finally:
        srv.stop()


def test_startup_candidate_dir_stages_and_audits(tmp_path):
    """--rollout-candidate-dir stages at start; the lifecycle steps land in
    the audit log as kind=rollout records."""
    live_dir, cand_dir = _policy_dirs(tmp_path)
    audit = tmp_path / "audit.jsonl"
    srv = _port_server(live_dir, "--rollout-candidate-dir", str(cand_dir),
                       "--rollout-insecure-control", "--audit-log-file", str(audit))
    try:
        assert srv.rollout.status()["state"] == "staged"
        assert _wait(srv.rollout.warm_ready)
        srv.rollout.promote()
        srv.rollout.rollback()
    finally:
        srv.stop()
    events = [json.loads(ln) for ln in audit.read_text().splitlines()]
    assert [(e["kind"], e["event"]) for e in events if e.get("kind") == "rollout"] == [
        ("rollout", "promoted"), ("rollout", "rolled_back")]


# ------------------------------------------------------------------ routes


def _http(port, method, path, body=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            code, data = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, data = e.code, e.read()
    try:
        return code, _masked(json.loads(data))
    except ValueError:
        return code, data.decode(errors="replace")


def _routes(cand_dir, token):
    bearer = {"Authorization": f"Bearer {token}"} if token else {}
    stage = json.dumps({"directory": str(cand_dir), "warm": "sync"}).encode()
    return [
        ("GET", "/debug/rollout", None, {}),
        ("POST", "/rollout/promote", b"{}", {}),
        ("POST", "/rollout/promote", b"{}", {"Authorization": "Bearer nope"}),
        ("POST", "/rollout/promote", b"{}", {"Authorization": "Bearer s\xe9krit"}),
        ("POST", "/rollout/stage", b"{}", bearer),
        ("POST", "/rollout/stage", b"{nope", bearer),
        ("POST", "/rollout/stage", json.dumps({"source": "permit (nope"}).encode(), bearer),
        ("POST", "/rollout/stage", json.dumps({"directory": "/nonexistent"}).encode(), bearer),
        ("POST", "/rollout/promote", b"{}", bearer),
        ("POST", "/rollout/rollback", b"{}", bearer),
        ("POST", "/rollout/stage", stage, bearer),
        ("GET", "/debug/rollout", None, {}),
        ("POST", "/rollout/stage", json.dumps({"crd": True}).encode(), bearer),
        ("POST", "/rollout/nope", b"{}", bearer),
        ("POST", "/rollout/promote", b"", bearer),
        ("POST", "/rollout/stage", stage, bearer),
        ("POST", "/rollout/rollback", None, bearer),
        ("POST", "/rollout/rollback", b"{}", bearer),
        ("GET", "/debug/rollout", None, {}),
    ]


@pytest.mark.parametrize("mode", ["token", "insecure", "disabled"])
def test_routes_equal_jax(tmp_path, mode):
    """The metrics listener's rollout routes on the port CLI's server and
    on a JAX server with the same control settings: the same codes and
    bodies (status documents with times and engine statistics masked)."""
    live_dir, cand_dir = _policy_dirs(tmp_path)
    token = "sekrit" if mode == "token" else None
    flags = {"token": ("--rollout-control-token-file", str(tmp_path / "tok")),
             "insecure": ("--rollout-insecure-control",), "disabled": ()}[mode]
    (tmp_path / "tok").write_text("sekrit\n")
    t = _port_server(live_dir, *flags)
    j = _jax_server(live_dir, control=mode != "disabled", token=token)
    try:
        for method, path, body, headers in _routes(cand_dir, token):
            got = _http(t.bound_metrics_port, method, path, body, headers)
            want = _http(j.bound_metrics_port, method, path, body, headers)
            assert got == want, (method, path, headers)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{t.bound_metrics_port}/metrics", timeout=30).read().decode()
        assert "cedar_rollout_generation" in text
    finally:
        t.stop()
        j.stop()


def test_routes_404_without_a_rollout_as_jax(tmp_path):
    live_dir, _ = _policy_dirs(tmp_path)
    t = _port_server(live_dir, "--backend", "interpreter")
    j = _interp_server("jax", LIVE_POLICIES, address="127.0.0.1", port=0, metrics_port=0)
    j.start()
    try:
        for method, path in (("GET", "/debug/rollout"), ("POST", "/rollout/promote"),
                             ("POST", "/rollout/stage")):
            body = b"{}" if method == "POST" else None
            assert (_http(t.bound_metrics_port, method, path, body)[0]
                    == _http(j.bound_metrics_port, method, path, body)[0] == 404)
    finally:
        t.stop()
        j.stop()


# ------------------------------------------------------------ offline CLIs


def _recordings(tmp_path, bodies) -> pathlib.Path:
    from cedar_tpu_torch.cache.fingerprint import fingerprint_body

    rec = tmp_path / "recordings"
    rec.mkdir()
    for i, (endpoint, body) in enumerate(bodies):
        fp = fingerprint_body(endpoint, body)
        (rec / f"req-{endpoint}-{fp}-{1000 + i}.json").write_bytes(body)
    (rec / "req-authorize-garbage-1.json").write_bytes(b"{not json")
    return rec


def _config(tmp_path, policy_dir) -> pathlib.Path:
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                               "spec": {"stores": [{"type": "directory", "directoryStore":
                                                    {"path": str(policy_dir)}}]}}))
    return cfg


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _shadow_bodies():
    return [b for i, b in enumerate(_traffic()) if i % 9 == 0]


@pytest.mark.parametrize("fmt", ["json", "text"])
@pytest.mark.parametrize("gate", ["fail-on-diff", "plain"])
def test_cedar_shadow_equals_jax(tmp_path, fmt, gate):
    live_dir, cand_dir = _policy_dirs(tmp_path)
    rec = _recordings(tmp_path, _shadow_bodies())
    argv = [str(rec), "--config", str(_config(tmp_path, live_dir)),
            "--candidate-dir", str(cand_dir)]
    argv += ["--json"] if fmt == "json" else []
    argv += ["--fail-on-diff"] if gate == "fail-on-diff" else []
    port, jax = _run_cli(t_shadow_cli.main, argv), _run_cli(j_shadow_cli.main, argv)
    if fmt == "json":
        port = (port[0], _masked(json.loads(port[1])), port[2])
        jax = (jax[0], _masked(json.loads(jax[1])), jax[2])
        assert port[1]["diffs"]["allow_to_deny"] > 0 and port[1]["skipped"] == {
            "authorization": 1}
    assert port == jax
    assert port[0] == (2 if gate == "fail-on-diff" else 0)


@pytest.mark.parametrize("case", ["no-recordings", "strict-rejects", "permissive-stages",
                                  "missing-candidate"])
def test_cedar_shadow_errors_equal_jax(tmp_path, case):
    live_dir, cand_dir = _policy_dirs(tmp_path)
    if case in ("strict-rejects", "permissive-stages"):
        (cand_dir / POLICY_FILE).write_text(UNLOWERABLE_CANDIDATE)
    rec = _recordings(tmp_path, _shadow_bodies()[:10])
    if case == "no-recordings":
        rec = tmp_path / "empty"
        rec.mkdir()
    argv = [str(rec), "--config", str(_config(tmp_path, live_dir)), "--candidate-dir",
            str(cand_dir) if case != "missing-candidate" else str(tmp_path / "nope")]
    if case == "permissive-stages":
        argv += ["--validation-mode", "permissive"]
    port, jax = _run_cli(t_shadow_cli.main, argv), _run_cli(j_shadow_cli.main, argv)
    assert port == jax
    assert port[0] == (0 if case == "permissive-stages" else 1)


def _why_argv(tmp_path, case, live_dir, cand_dir, rec, fp):
    cfg = str(_config(tmp_path, live_dir))
    return {
        "fingerprint-both": [str(rec), "--fingerprint", fp[:10], "--config", cfg,
                             "--candidate-dir", str(cand_dir)],
        "fingerprint-json": [str(rec), "--fingerprint", fp, "--policy-dir", str(live_dir),
                             "--candidate-source", CANDIDATE_POLICIES, "--json"],
        "all-json": [str(rec), "--all", "--config", cfg, "--json"],
        "all-text": [str(rec), "--all", "--policy-dir", str(live_dir)],
        "no-match": [str(rec), "--fingerprint", "ffffffff", "--config", cfg],
        "no-stack": [str(rec), "--fingerprint", fp],
        "bad-stack": [str(rec), "--fingerprint", fp, "--policy-dir", str(tmp_path / "nope")],
    }[case]


@pytest.mark.parametrize("case", ["fingerprint-both", "fingerprint-json", "all-json",
                                  "all-text", "no-match", "no-stack", "bad-stack"])
def test_cedar_why_equals_jax(tmp_path, case):
    from cedar_tpu_torch.cache.fingerprint import fingerprint_body

    live_dir, cand_dir = _policy_dirs(tmp_path)
    (live_dir / "extra.cedar").write_text(chip_fallback_policy())
    bodies = [b for i, b in enumerate(_traffic()) if i % 37 == 0]
    rec = _recordings(tmp_path, bodies)
    fp = fingerprint_body(*bodies[0])
    argv = _why_argv(tmp_path, case, live_dir, cand_dir, rec, fp)
    port, jax = _run_cli(t_why_cli.main, argv), _run_cli(j_why_cli.main, argv)
    assert port == jax
    assert port[0] == {"no-match": 2, "no-stack": 1, "bad-stack": 1}.get(case, 0)
    if case == "fingerprint-both":
        assert "live: decision=" in port[1] and "candidate: decision=" in port[1]
        assert "clause 1/" in port[1]


def chip_fallback_policy() -> str:
    """An interpreter-fallback policy (an alternation product past the
    lowering's clause ceiling) on pods: explained with fallback marks."""
    return ("permit (principal, action, resource) when { "
            + " && ".join(f'(resource.resource == "pods" || resource.name == "z{i}")'
                          for i in range(12)) + " };\n")


@pytest.mark.parametrize("fallback", [False, True])
def test_explainer_host_pack_override_equals_jax(fallback):
    """Explainer(authz_packed=, admission_packed=) with no engine explains
    on the host plane (clause tests, source "host") as the JAX Explainer
    does with the same override, on 1,100 bodies."""
    src = LIVE_POLICIES + (chip_fallback_policy() if fallback else "")
    exps = []
    for pkg in ("port", "jax"):
        authz, handler = _interp_stacks(pkg, src)
        tiers = [s.policy_set() for s in authz.stores]
        adm_tiers = [s.policy_set() for s in handler.stores]
        if pkg == "port":
            exps.append(Explainer(
                authorizer=authz, admission_handler=handler,
                authz_packed=pack(lower_tiers(tiers, AUTHZ_SCHEMA_INFO)),
                admission_packed=pack(lower_tiers(adm_tiers, AUTHZ_SCHEMA_INFO))))
        else:
            exps.append(JExplainer(
                authorizer=authz, admission_handler=handler,
                authz_packed=j_pack(j_lower_tiers(tiers, J_SCHEMA)),
                admission_packed=j_pack(j_lower_tiers(adm_tiers, J_SCHEMA))))
    sources = set()
    for endpoint, body in _traffic():
        if endpoint == "authorize":
            got, want = (list(e.explain_authorize(body)) for e in exps)
        else:
            (rg, eg), (rw, ew) = (e.explain_admit(body) for e in exps)
            got, want = [rg.to_admission_review(), eg], [rw.to_admission_review(), ew]
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), body
        sources.add(got[-1]["source"])
    assert "host" in sources and "interpreter" not in sources


def test_batch_authorize_matches_single():
    authz, _ = _interp_stacks("port", LIVE_POLICIES)
    attrs = [get_authorizer_attributes(json.loads(b)) for b in (
        sar_body("alice", "pods"), sar_body("carol", "secrets"), sar_body("dave", "services"),
        sar_body("system:kube-scheduler", "pods"))]
    assert authz.authorize_batch(attrs) == [authz.authorize(a) for a in attrs]
    assert authz.authorize_batch(attrs)[3] == ("no_opinion", "")
