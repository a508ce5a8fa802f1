"""The port's policy stores that change under the server (cedar_tpu_torch/
stores/crd.py, kubeclient.py, avp.py, config.py, server/backoff.py)
against the JAX package's, on the CPU, at tolerance 0 throughout.

  * CRDPolicyStore: both stores take the same event scripts (watch
    events, relists, a 410 relist, candidate labels, poison objects, the
    poison-crd chaos scenario); after every step the served policies (id,
    file, position, formatted text), the content generation, the
    candidate set and the quarantine equal the JAX store's. A relist of
    the same content and a metadata-only update step nothing.
  * The real transport: KubeAPIWatchSource and KubeConfigClient of both
    packages against a local fake apiserver (chip_smoke.FakeApiServer,
    port 0): list, watch events, the bookmark, 410 as a status and as an
    ERROR event, a whole store lifecycle; a JSON kubeconfig read with
    PyYAML blocked at import.
  * VerifiedPermissionsPolicyStore with a fake client, and the store
    config over every tier order of the three store types.
  * The CLI (build_server, --device cpu) over a CRD store on the fake
    apiserver beside the JAX server over the JAX CRD store on the same
    apiserver: each object event reaches both engines by an incremental
    reload (or none, for a metadata-only update and a relist), and every
    /v1/authorize and /v1/admit answer equals the JAX server's.
"""

import dataclasses
import json
import pathlib
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from cedar_tpu.apis.v1alpha1 import PolicyObject as JPolicyObject
from cedar_tpu.chaos.registry import default_registry as j_chaos
from cedar_tpu.chaos.scenario import builtin_scenario as j_builtin_scenario
from cedar_tpu.cli.webhook import TPUReloader as JTPUReloader
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import AdmissionFastPath as JAdmissionFastPath
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.lang.format import format_policy as j_format
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server.backoff import Backoff as JBackoff
from cedar_tpu.server.backoff import retry_call as j_retry_call
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores.avp import VerifiedPermissionsPolicyStore as JAVPStore
from cedar_tpu.stores.config import cedar_config_stores as j_config_stores
from cedar_tpu.stores.config import parse_config as j_parse_config
from cedar_tpu.stores.crd import CRDPolicyStore as JCRDPolicyStore
from cedar_tpu.stores.crd import KubeAPIWatchSource as JKubeAPIWatchSource
from cedar_tpu.stores.crd import WatchExpired as JWatchExpired
from cedar_tpu.stores.quarantine import quarantine_registry as j_quarantine
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch.apis.v1alpha1 import PolicyObject
from cedar_tpu_torch.chaos.registry import default_registry as t_chaos
from cedar_tpu_torch.chaos.scenario import builtin_scenario
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.lang.format import format_policy
from cedar_tpu_torch.server.backoff import Backoff, retry_call
from cedar_tpu_torch.server.metrics import process_metrics
from cedar_tpu_torch.stores.avp import VerifiedPermissionsPolicyStore
from cedar_tpu_torch.stores.config import cedar_config_stores, parse_config
from cedar_tpu_torch.stores.crd import CRDPolicyStore, KubeAPIWatchSource, WatchExpired
from cedar_tpu_torch.stores.kubeclient import KubeConfigClient
from cedar_tpu_torch.stores.quarantine import quarantine_registry

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — the fake apiserver of phase 12
from test_torch_server import ADM_BODIES, DEMO_BODIES, _sar, request  # noqa: E402

PERMIT = 'permit (principal, action == k8s::Action::"get", resource is k8s::Resource);'
FORBID = 'forbid (principal, action == k8s::Action::"list", resource is k8s::Resource);'
TWO = PERMIT + "\n" + FORBID
BAD = "permit (principal galaxy-brain;;; %%"
# parses, but its alternation product passes the lowering's clause
# ceiling: a clause_limit finding (severity error) for the validationMode
# gate
CLAUSE_LIMIT = (
    'permit (principal in k8s::Group::"joiners", action == k8s::Action::"get",\n'
    "        resource is k8s::Resource)\n  when { "
    + " && ".join('(resource.resource == "widgets" || resource.name == "10.0.0.1")'
                  for _ in range(12))
    + " };"
)
CANDIDATE = {"cedar.k8s.aws/rollout": "candidate"}


def _obj(name, content, uid="", labels=None, rv="1", annotations=None):
    meta = {"name": name, "uid": uid or f"uid-{name}", "resourceVersion": rv}
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    return {"metadata": meta, "spec": {"content": content}}


@pytest.fixture(autouse=True)
def _clean_chaos():
    t_chaos().reset()
    j_chaos().reset()
    yield
    t_chaos().reset()
    j_chaos().reset()


# ------------------------------------------------- the store, event by event


class ScriptSource:
    """A watch source whose list() answers the objects it is given."""

    def __init__(self, cls):
        self.cls, self.objects, self.resets = cls, [], 0

    def list(self):
        return [self.cls.from_dict(d) for d in self.objects]

    def reset_resource_version(self):
        self.resets += 1

    def watch(self, on_event, stop):
        stop.wait(0.05)


# scenario -> steps: ("relist", [object dicts]) / (event type, object dict)
# / ("arm", scenario name); object names carry the scenario, because both
# quarantine registries are process-wide
SCENARIOS = {
    "add-modify-delete": [
        ("relist", [_obj("amd-a", PERMIT)]), ("ADDED", _obj("amd-b", TWO)),
        ("MODIFIED", _obj("amd-a", FORBID)), ("DELETED", _obj("amd-b", ""))],
    "metadata-only-update": [
        ("relist", [_obj("mo-a", TWO)]),
        ("MODIFIED", _obj("mo-a", TWO, rv="7", annotations={"note": "x"})),
        ("MODIFIED", _obj("mo-a", TWO, rv="8", labels={"team": "a"}))],
    "relist-same-content": [
        ("relist", [_obj("rs-a", PERMIT), _obj("rs-b", TWO)]),
        ("relist", [_obj("rs-b", TWO, rv="9"), _obj("rs-a", PERMIT, rv="9")])],
    "relist-changed": [
        ("relist", [_obj("rc-a", PERMIT), _obj("rc-b", TWO)]),
        ("relist", [_obj("rc-a", FORBID), _obj("rc-c", PERMIT)])],
    "recreated-uid": [
        ("relist", [_obj("ru-a", TWO)]), ("MODIFIED", _obj("ru-a", TWO, uid="uid-new"))],
    "delete-unknown": [
        ("relist", [_obj("du-a", PERMIT)]), ("DELETED", _obj("du-ghost", ""))],
    "candidate-label": [
        ("relist", [_obj("cl-a", PERMIT), _obj("cl-c", FORBID, labels=CANDIDATE)]),
        ("MODIFIED", _obj("cl-c", FORBID)),
        ("MODIFIED", _obj("cl-c", FORBID, labels=CANDIDATE)),
        ("MODIFIED", _obj("cl-c", TWO, labels=CANDIDATE)),
        ("relist", [_obj("cl-a", PERMIT)]), ("DELETED", _obj("cl-c", ""))],
    "poison-new": [
        ("relist", [_obj("pn-a", PERMIT)]), ("ADDED", _obj("pn-bad", BAD)),
        ("MODIFIED", _obj("pn-bad", FORBID))],
    "poison-after-good": [
        ("relist", [_obj("pg-a", TWO)]), ("MODIFIED", _obj("pg-a", BAD)),
        ("relist", [_obj("pg-a", BAD)]), ("MODIFIED", _obj("pg-a", PERMIT))],
    "poison-gone-while-down": [
        ("relist", [_obj("pd-a", PERMIT)]), ("ADDED", _obj("pd-bad", BAD)),
        ("relist", [_obj("pd-a", PERMIT)])],
    "poison-crd-scenario": [
        ("relist", [_obj("pc-a", PERMIT)]), ("arm", "poison-crd"),
        ("ADDED", _obj("pc-b", TWO)), ("MODIFIED", _obj("pc-a", FORBID)),
        ("disarm", ""), ("MODIFIED", _obj("pc-b", FORBID))],
    # a relist that lists a quarantined object repaired clears its
    # quarantine, though its content equals the retained last good one
    "relist-repaired": [
        ("relist", [_obj("rr-a", TWO), _obj("rr-b", PERMIT)]), ("MODIFIED", _obj("rr-a", BAD)),
        ("relist", [_obj("rr-a", TWO), _obj("rr-b", PERMIT)])],
    # the same with a strict-mode rejection for the bad content
    "strict-relist-repaired": [
        ("relist", [_obj("sr-a", TWO), _obj("sr-b", PERMIT)]),
        ("MODIFIED", _obj("sr-a", CLAUSE_LIMIT)),
        ("relist", [_obj("sr-a", TWO), _obj("sr-b", PERMIT)])],
    "strict-new-object": [
        ("relist", [_obj("sn-a", PERMIT)]), ("ADDED", _obj("sn-b", FORBID + CLAUSE_LIMIT)),
        ("relist", [_obj("sn-a", PERMIT), _obj("sn-b", FORBID + CLAUSE_LIMIT)]),
        ("MODIFIED", _obj("sn-b", FORBID))],
    "partial-drops-policy": [
        ("relist", [_obj("pp-a", PERMIT + CLAUSE_LIMIT + FORBID)]),
        ("MODIFIED", _obj("pp-a", CLAUSE_LIMIT + TWO)),
        ("relist", [_obj("pp-a", TWO)])],
    "permissive-keeps": [
        ("relist", [_obj("pk-a", PERMIT + CLAUSE_LIMIT)]), ("ADDED", _obj("pk-b", CLAUSE_LIMIT)),
        ("relist", [_obj("pk-a", FORBID)])],
}
# the stores' validationMode per scenario (None: no gate)
SCENARIO_MODES = {
    "strict-relist-repaired": "strict", "strict-new-object": "strict",
    "partial-drops-policy": "partial", "permissive-keeps": "permissive",
}


def _served(store, fmt) -> list:
    return [(p.policy_id, p.filename, p.position, fmt(p))
            for p in store.policy_set().policies()]


def _state(store, fmt, quarantine, names) -> dict:
    return {
        "served": _served(store, fmt),
        "generation": store.content_generation(),
        "candidates": sorted(o.name for o in store.candidate_objects()),
        "quarantined": [n for n in names if quarantine.is_quarantined("crd", n)],
        "ready": store.initial_policy_load_complete(),
    }


def _apply(store, source, cls, chaos, step):
    kind, arg = step
    if kind == "relist":
        source.objects = arg
        store._relist()
    elif kind == "arm":
        chaos.configure(builtin_scenario(arg) if cls is PolicyObject
                        else j_builtin_scenario(arg))
        chaos.arm()
    elif kind == "disarm":
        chaos.disarm()
    else:
        store._dispatch(kind, cls.from_dict(arg))


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_crd_store_equals_jax(scenario):
    """Served policies, generation steps, candidates and quarantine of the
    port's CRD store equal the JAX store's after every step, with and
    without the per-object validationMode gate."""
    steps = SCENARIOS[scenario]
    names = sorted({a["metadata"]["name"] for k, a in steps if k not in ("relist", "arm", "disarm")}
                   | {o["metadata"]["name"] for k, a in steps if k == "relist" for o in a})
    t_src, j_src = ScriptSource(PolicyObject), ScriptSource(JPolicyObject)
    mode = SCENARIO_MODES.get(scenario)
    t_store = CRDPolicyStore(source=t_src, start=False, validation_mode=mode)
    j_store = JCRDPolicyStore(source=j_src, start=False, validation_mode=mode)
    gens = []
    for step in steps:
        _apply(t_store, t_src, PolicyObject, t_chaos(), step)
        _apply(j_store, j_src, JPolicyObject, j_chaos(), step)
        t_state = _state(t_store, format_policy, quarantine_registry(), names)
        assert t_state == _state(j_store, j_format, j_quarantine(), names), step
        gens.append(t_state["generation"])
    steps_up = [b > a for a, b in zip(gens, gens[1:])]
    if scenario in ("metadata-only-update", "relist-same-content", "delete-unknown"):
        assert not any(steps_up)
    if scenario in ("relist-repaired", "strict-relist-repaired"):
        # quarantined after the bad MODIFIED, cleared by the relist
        assert t_state["quarantined"] == []
    for name in names:  # leave no quarantine entry behind for other tests
        quarantine_registry().clear("crd", name)
        j_quarantine().clear("crd", name)


def test_watch_error_event_raises_watch_expired():
    store = CRDPolicyStore(source=ScriptSource(PolicyObject), start=False)
    with pytest.raises(WatchExpired):
        store._dispatch("ERROR", PolicyObject.from_dict(_obj("x", "")))


def test_unchanged_objects_keep_their_policy_objects():
    """A watch event re-parses its own object only: every other object's
    Policy objects carry over (with the fingerprints memoized on them)."""
    store = CRDPolicyStore(source=ScriptSource(PolicyObject), start=False)
    store.on_add(PolicyObject.from_dict(_obj("keep-a", TWO)))
    store.on_add(PolicyObject.from_dict(_obj("keep-b", PERMIT)))
    before = {p.policy_id: p for p in store.policy_set().policies()}
    store.on_update(PolicyObject.from_dict(_obj("keep-b", FORBID)))
    after = {p.policy_id: p for p in store.policy_set().policies()}
    assert all(after[pid] is before[pid] for pid in before if pid.startswith("keep-a"))
    assert after["keep-b0-uid-keep-b"] is not before["keep-b0-uid-keep-b"]


@pytest.mark.parametrize("change", ["none", "one-object", "uid"])
def test_relist_parses_only_changed_objects(change):
    """A relist keeps the Policy objects of every object whose uid and
    content are unchanged (no parse: a relist of an unchanged corpus
    costs a dict compare per object), and parses the others; the served
    set equals the JAX store's, which parses every object again."""
    docs = [_obj(f"rl-{k}", TWO if k % 2 else PERMIT) for k in range(6)]
    t_src, j_src = ScriptSource(PolicyObject), ScriptSource(JPolicyObject)
    t_store = CRDPolicyStore(source=t_src, start=False)
    j_store = JCRDPolicyStore(source=j_src, start=False)
    t_src.objects = j_src.objects = docs
    t_store._relist()
    j_store._relist()
    before = {p.policy_id: p for p in t_store.policy_set().policies()}
    again = [dict(d) for d in docs]
    if change == "one-object":
        again[2] = _obj("rl-2", FORBID)
    elif change == "uid":
        again[3] = _obj("rl-3", TWO, uid="uid-recreated")
    t_src.objects = j_src.objects = again
    t_store._relist()
    j_store._relist()
    assert _served(t_store, format_policy) == _served(j_store, j_format)
    assert t_store.content_generation() == j_store.content_generation() == \
        1 + (change != "none")
    after = t_store.policy_set().policies()
    fresh = sorted({p.policy_id.split("-uid")[0][:-1] for p in after
                    if before.get(p.policy_id) is not p})
    assert fresh == {"none": [], "one-object": ["rl-2"], "uid": ["rl-3"]}[change]


def test_dead_watch_thread_counts_a_worker_death(monkeypatch):
    """A list+watch thread that dies on an uncaught exception counts in
    cedar_worker_deaths_total{component="crd.watch"}, and revive()
    starts a fresh one."""
    died = []
    monkeypatch.setattr(threading, "excepthook", lambda a: died.append(a.exc_type))

    class Dying:
        def list(self):
            raise KeyboardInterrupt  # a BaseException the retry loop does not take

        def watch(self, on_event, stop):
            stop.wait(1)

    deaths = process_metrics().worker_deaths_total
    before = deaths.value(component="crd.watch", replica="")
    store = CRDPolicyStore(source=Dying(), start=False)
    store._start_thread()
    (t,) = store.watch_threads()
    t.join(timeout=10)
    assert not t.is_alive() and died == [KeyboardInterrupt]
    assert deaths.value(component="crd.watch", replica="") == before + 1
    store._source = ScriptSource(PolicyObject)
    assert store.revive() is True
    deadline = time.monotonic() + 10
    while not store.initial_policy_load_complete() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert store.initial_policy_load_complete()
    store.close()


# ------------------------------------------------------- the real transport


@pytest.fixture
def api():
    srv = chip_smoke.FakeApiServer(hold_s=0.3)
    yield srv
    srv.shutdown()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_watch_source_lists_and_follows_events(api, tmp_path, pkg):
    """list() takes the list's resourceVersion; watch() delivers each
    event and advances the bookmark, and the next watch resumes from it.
    The port's source and the JAX one see the same."""
    cls = KubeAPIWatchSource if pkg == "port" else JKubeAPIWatchSource
    api.apply("w-a", PERMIT)
    src = cls(api.kubeconfig(str(tmp_path / "kubeconfig")))
    assert [o.name for o in src.list()] == ["w-a"]
    assert src._resource_version == str(api.rv)
    api.apply("w-b", FORBID)
    api.apply("w-a", TWO)
    api.touch("w-b")
    seen = []
    src.watch(lambda t, o: seen.append((t, o.name, o.spec.content)), threading.Event())
    assert seen == [("ADDED", "w-b", FORBID), ("MODIFIED", "w-a", TWO),
                    ("MODIFIED", "w-b", FORBID)]
    assert src._resource_version == str(api.rv)
    src.watch(lambda t, o: seen.append(t), threading.Event())
    assert api.watches[-1] == str(api.rv) and len(seen) == 3


@pytest.mark.parametrize("how", ["status-410", "error-event-410"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_watch_source_expired(api, tmp_path, pkg, how):
    """A compacted version answers 410 (raised as WatchExpired); so does
    an ERROR event carrying code 410."""
    cls, expired = ((KubeAPIWatchSource, WatchExpired) if pkg == "port"
                    else (JKubeAPIWatchSource, JWatchExpired))
    src = cls(api.kubeconfig(str(tmp_path / "kubeconfig")))
    src.list()
    if how == "status-410":
        api.expire()
    else:
        with api.cond:
            api.rv += 1
            api.events.append((api.rv, {"type": "ERROR", "object": {"code": 410}}))
    with pytest.raises(expired):
        src.watch(lambda t, o: None, threading.Event())


def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.02)


def test_store_lifecycle_over_the_real_transport_equals_jax(api, tmp_path):
    """Both stores list+watch the same fake apiserver from their own
    threads: an add, an edit and a delete reach both; a metadata-only
    update and a 410 relist of the same content step no generation; the
    served policies equal after each."""
    cfg = api.kubeconfig(str(tmp_path / "kubeconfig"))
    api.apply("lc-a", PERMIT)
    api.apply("lc-b", TWO)
    t_store = CRDPolicyStore(kubeconfig_path=cfg)
    j_store = JCRDPolicyStore(kubeconfig_path=cfg)
    try:
        _wait(lambda: t_store.initial_policy_load_complete()
              and j_store.initial_policy_load_complete())
        steps = [("apply", "lc-c", FORBID), ("apply", "lc-a", FORBID), ("delete", "lc-b", None),
                 ("touch", "lc-a", None), ("expire", None, None)]
        for kind, name, content in steps:
            g = (t_store.content_generation(), j_store.content_generation())
            lists = api.list_calls
            if kind == "apply":
                api.apply(name, content)
            elif kind == "delete":
                api.delete(name)
            elif kind == "touch":
                api.touch(name)
            else:
                api.expire()
            if kind in ("touch", "expire"):
                if kind == "expire":
                    _wait(lambda: api.list_calls >= lists + 2)  # both relisted
                time.sleep(0.5)
                assert (t_store.content_generation(), j_store.content_generation()) == g
            else:
                _wait(lambda: t_store.content_generation() > g[0]
                      and j_store.content_generation() > g[1])
            assert _served(t_store, format_policy) == _served(j_store, j_format)
    finally:
        t_store.close()
        j_store.close()


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_json_kubeconfig_needs_no_yaml(api, tmp_path, monkeypatch, fmt):
    """With PyYAML unimportable, a JSON kubeconfig still builds the client
    (and its bearer token reaches the apiserver); a YAML one raises the
    import error."""
    path = api.kubeconfig(str(tmp_path / "kubeconfig"))
    if fmt == "yaml":
        import yaml

        with open(path) as f:
            text = yaml.safe_dump(json.load(f))
        with open(path, "w") as f:
            f.write(text)
    monkeypatch.setitem(sys.modules, "yaml", None)
    if fmt == "yaml":
        with pytest.raises(ImportError):
            KubeConfigClient(path)
        return
    client = KubeConfigClient(path)
    assert client.server == f"http://127.0.0.1:{api.port}" and client._ssl is None
    assert client._token == "fake-token"
    assert client.get_json(chip_smoke.POLICIES_PATH)["kind"] == "PolicyList"


def test_get_json_retries_server_errors_only(tmp_path):
    """get_json retries a 5xx and gives up at once on a 4xx."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    hits = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            hits.append(self.path)
            code = 503 if self.path == "/flaky" and len(hits) == 1 else (
                404 if self.path == "/missing" else 200)
            body = b'{"ok": true}'
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        cfg = tmp_path / "kubeconfig"
        cfg.write_text(json.dumps({
            "current-context": "c", "contexts": [{"name": "c", "context": {
                "cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c", "cluster": {
                "server": f"http://127.0.0.1:{srv.server_address[1]}"}}],
            "users": [{"name": "u", "user": {}}]}))
        client = KubeConfigClient(str(cfg))
        assert client.get_json("/flaky") == {"ok": True} and hits == ["/flaky"] * 2
        import urllib.error

        with pytest.raises(urllib.error.HTTPError):
            client.get_json("/missing")
        assert hits.count("/missing") == 1
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("case", ["backoff", "retry"])
def test_backoff_equals_jax(case):
    """The decorrelated-jitter delays and retry_call's attempts and sleeps
    equal the JAX package's for the same draws."""
    def draws(cls):
        seq = iter([0.7, 2.0, 9.0, 40.0, 1.0])
        return cls(base_s=0.5, cap_s=10.0, uniform=lambda a, b: min(b, next(seq)))

    if case == "backoff":
        t, j = draws(Backoff), draws(JBackoff)
        assert [t.next() for _ in range(4)] == [j.next() for _ in range(4)]
        t.reset(), j.reset()
        assert t.next() == j.next()
        return
    out = {}
    for name, fn, cls in (("port", retry_call, Backoff), ("jax", j_retry_call, JBackoff)):
        calls, sleeps = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("down")
            return len(calls)

        out[name] = (fn(flaky, attempts=4, retry_on=(OSError,), backoff=draws(cls),
                        sleep=sleeps.append), sleeps)
    assert out["port"] == out["jax"] and out["port"][0] == 3


# ------------------------------------------------------ Verified Permissions


class FakeAVP:
    def __init__(self, policies):
        self.policies, self.fail = dict(policies), False

    def list_policy_ids(self, store_id):
        if self.fail:
            raise RuntimeError("throttled")
        return list(self.policies)[::-1]

    def get_policy_statement(self, store_id, pid):
        return self.policies[pid]


AVP_STEPS = {
    "load": [],
    "unchanged": [("same", None)],
    "changed": [("set", {"pol-1": FORBID, "pol-2": TWO})],
    "parse-error-skipped": [("set", {"pol-1": PERMIT, "pol-bad": BAD})],
    "client-error-keeps-set": [("fail", None)],
    "empty-statement-skipped": [("set", {"pol-1": PERMIT, "pol-empty": ""})],
}


@pytest.mark.parametrize("case", list(AVP_STEPS))
def test_avp_store_equals_jax(case):
    """Policy ids, text and generation of the port's Verified Permissions
    store equal the JAX store's over the same client answers."""
    t_client, j_client = FakeAVP({"pol-1": PERMIT, "pol-2": FORBID}), FakeAVP(
        {"pol-1": PERMIT, "pol-2": FORBID})
    t = VerifiedPermissionsPolicyStore("ps-1", client=t_client, start_ticker=False)
    j = JAVPStore("ps-1", client=j_client, start_ticker=False)
    for kind, arg in [("same", None)] + AVP_STEPS[case]:
        for client, store in ((t_client, t), (j_client, j)):
            if kind == "set":
                client.policies = dict(arg)
            client.fail = kind == "fail"
            store.load_policies()
        assert (_served(t, format_policy), t.content_generation(),
                t.initial_policy_load_complete()) == (
            _served(j, j_format), j.content_generation(), j.initial_policy_load_complete())
    assert t.name() == j.name() == "VerifiedPermissionsStore"


# --------------------------------------------------------------- the config

TIER_ORDERS = {
    "directory-crd-avp": ("directory", "crd", "verifiedPermissions"),
    "crd-avp-directory": ("crd", "verifiedPermissions", "directory"),
    "avp-directory-crd": ("verifiedPermissions", "directory", "crd"),
}


@pytest.mark.parametrize("order", list(TIER_ORDERS))
def test_config_builds_every_store_type_in_any_order(tmp_path, order):
    """The three store types in any tier order: the port's config builds
    stores of the JAX config's kinds, in its order."""
    (tmp_path / "p.cedar").write_text(PERMIT)
    docs = {"directory": {"type": "directory", "directoryStore": {"path": str(tmp_path)}},
            "crd": {"type": "crd", "crdStore": {}},
            "verifiedPermissions": {"type": "verifiedPermissions",
                                    "verifiedPermissionsStore": {"policyStoreId": "ps-1"}}}
    text = json.dumps({"spec": {"stores": [docs[k] for k in TIER_ORDERS[order]]}})
    assert dataclasses.asdict(parse_config(text)) == dataclasses.asdict(j_parse_config(text))
    kube = str(tmp_path / "absent-kubeconfig")
    t = cedar_config_stores(parse_config(text), kubeconfig_path=kube,
                            avp_client=FakeAVP({"pol-1": PERMIT}))
    j = j_config_stores(j_parse_config(text), kubeconfig_path=kube,
                        avp_client=FakeAVP({"pol-1": PERMIT}))
    try:
        assert [s.name() for s in t] == [s.name() for s in j]
        assert [s.initial_policy_load_complete() for s in t] == \
            [s.initial_policy_load_complete() for s in j]
    finally:
        for s in list(t) + list(j):
            getattr(s, "close", lambda: None)()


# --------------------------------------------------- the CLI over a CRD store

FLIPPER = ('permit (principal, action == k8s::Action::"get", resource is k8s::Resource)\n'
           '  when { resource.resource == "pods" };\n')
WATCH_BODIES = [_sar("sam", "watch", "pods"), _sar("pat", "watch", "secrets", groups=["team"])]
CLI_BODIES = {
    "/v1/authorize": list(DEMO_BODIES.values()) + WATCH_BODIES,
    "/v1/admit": ADM_BODIES[:60],
}
# step -> (does it reload, the endpoints whose answers it changes)
CLI_STEPS = {
    "modify": (True, ("/v1/authorize",)),
    "add": (True, ("/v1/authorize", "/v1/admit")),
    "delete": (True, ("/v1/authorize", "/v1/admit")),
    "metadata-only": (False, ()),
    "relist": (False, ()),
}


def _cli_objects(api) -> None:
    """The Policy objects: the repo demo's (one object per document, as
    its manifest deploys them), the admission policies, and a permit the
    edit flips."""
    import yaml

    docs = [d for d in yaml.safe_load_all((REPO / "demo/authorization-policy.yaml").read_text())
            if d]
    for d in docs:
        api.apply(d["metadata"]["name"], d["spec"]["content"])
    api.apply("admission", chip_smoke.ADM_POLICIES)
    api.apply("flipper", FLIPPER)


def _jax_crd_server(kubeconfig):
    """The JAX server over the JAX CRD store: both stacks with incremental
    engines and a TPUReloader (driven by hand), as the JAX CLI wires them
    by default."""
    store = JCRDPolicyStore(kubeconfig_path=kubeconfig)
    _wait(store.initial_policy_load_complete)
    stores = JTieredPolicyStores([store])
    adm_stores = JTieredPolicyStores([store, j_adm.allow_all_admission_policy_store()])
    engine = TPUPolicyEngine(incremental=True, shard_buckets=8)
    adm_engine = TPUPolicyEngine(incremental=True, shard_buckets=8)
    reloader = JTPUReloader(stores, targets=[(engine, stores), (adm_engine, adm_stores)],
                            interval_s=3600)
    assert reloader.reload_if_changed()
    authz = j_auth.CedarWebhookAuthorizer(stores, evaluate=engine.evaluate,
                                          evaluate_batch=engine.evaluate_batch)
    handler = j_adm.CedarAdmissionHandler(adm_stores, evaluate=adm_engine.evaluate,
                                          evaluate_batch=adm_engine.evaluate_batch)
    srv = JWebhookServer(authz, handler, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=JSARFastPath(engine, authz),
                         admission_fastpath=JAdmissionFastPath(adm_engine, handler),
                         pipeline_depth=2, request_timeout_s=60.0)
    srv.start()
    return srv, store, reloader


def _answers(port: int, path: str) -> list:
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(lambda b: request(port, "POST", path, b), CLI_BODIES[path]))


@pytest.fixture(scope="module")
def crd_sequence(tmp_path_factory):
    """Every CLI_STEPS step in order on one fake apiserver watched by both
    servers: per step the answers before and after, what each reload
    returned, and the port's /debug/engine and /metrics."""
    tmp = tmp_path_factory.mktemp("crd-cli")
    api = chip_smoke.FakeApiServer(hold_s=0.5)
    _cli_objects(api)
    kube = api.kubeconfig(str(tmp / "kubeconfig"))
    cfg = tmp / "store-config.json"
    cfg.write_text(json.dumps({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                               "spec": {"stores": [{"type": "crd", "crdStore": {}}]}}))
    t = build_server(make_parser().parse_args([
        "--config", str(cfg), "--kubeconfig", kube, "--device", "cpu", "--insecure",
        "--secure-port", "0", "--metrics-port", "0", "--request-timeout-ms", "60000",
        "--reload-seconds", "3600", "--shard-buckets", "8"]))
    t.start()
    j, j_store, j_reloader = _jax_crd_server(kube)
    (t_store,) = t.authorizer.stores.stores
    out = {"start": {"port": {p: _answers(t.bound_port, p) for p in CLI_BODIES},
                     "jax": {p: _answers(j.bound_port, p) for p in CLI_BODIES},
                     "debug": t.debug_engine(), "supervisor": t.debug_supervisor()}}
    try:
        prev = out["start"]["port"]
        for step in CLI_STEPS:
            gens = (t_store.content_generation(), j_store.content_generation())
            lists = api.list_calls
            if step == "modify":
                api.apply("flipper", FLIPPER.replace("permit", "forbid"))
            elif step == "add":
                api.apply("flip", chip_smoke.RELOAD_FLIP_POLICY)
            elif step == "delete":
                api.delete("flip")
            elif step == "metadata-only":
                api.touch("admission")
            else:
                api.expire()
            if CLI_STEPS[step][0]:
                _wait(lambda: t_store.content_generation() > gens[0]
                      and j_store.content_generation() > gens[1])
            else:
                if step == "relist":
                    _wait(lambda: api.list_calls >= lists + 2)  # both stores relisted
                time.sleep(1.0)
            rec = {"gens": (gens, (t_store.content_generation(), j_store.content_generation())),
                   "port_reload": t.reloader.reload_if_changed(),
                   "jax_reload": j_reloader.reload_if_changed(), "prev": prev}
            rec["port"] = {p: _answers(t.bound_port, p) for p in CLI_BODIES}
            rec["jax"] = {p: _answers(j.bound_port, p) for p in CLI_BODIES}
            rec["debug"] = t.debug_engine()
            rec["metrics"] = request(t.bound_metrics_port, "GET", "/metrics")[1].decode()
            out[step] = rec
            prev = rec["port"]
    finally:
        t.stop()
        j.stop()
        j_store.close()
        api.shutdown()
    return out


@pytest.mark.parametrize("path", list(CLI_BODIES))
@pytest.mark.parametrize("step", ["start"] + list(CLI_STEPS))
def test_crd_cli_answers_equal_jax(crd_sequence, step, path):
    """Every body's HTTP status and document equal the JAX server's after
    each object event and its reload; the events that change answers on
    this endpoint changed some, the others none."""
    rec = crd_sequence[step]
    assert rec["port"][path] == rec["jax"][path]
    if step == "start":
        return
    changed = sum(a != b for a, b in zip(rec["port"][path], rec["prev"][path]))
    assert (changed > 0) is (path in CLI_STEPS[step][1]), changed


@pytest.mark.parametrize("step", list(CLI_STEPS))
def test_crd_cli_reloads_incrementally(crd_sequence, step):
    """An object event reloads both engines incrementally, with no more
    dirty shards than the object has policies; a metadata-only update and
    a relist of the same content step no store generation and reload
    nothing, as in the JAX server."""
    rec = crd_sequence[step]
    reloads = CLI_STEPS[step][0]
    assert rec["port_reload"] is rec["jax_reload"] is reloads
    (t_before, j_before), (t_after, j_after) = rec["gens"]
    assert (t_after > t_before) is (j_after > j_before) is reloads
    before = crd_sequence[list(crd_sequence)[list(crd_sequence).index(step) - 1]]["debug"]
    for path in ("authorization", "admission"):
        eng, was = rec["debug"][path]["engine"], before[path]["engine"]
        assert eng["load_generation"] == was["load_generation"] + reloads
        if reloads:
            last = eng["last_load"]
            assert last["compile_scope"] == eng["shards"]["scope"] == "incremental"
            assert 1 <= last["dirty_shards"] <= 2  # the edited object's policies
            assert len(eng["shards"]["dirty"]) == last["dirty_shards"]
            # analyze: the config's (permissive) validationMode gate
            assert set(last["compile_seconds"]) == {"analyze", "hash", "lower", "pack",
                                                    "place", "warm", "total"}


def test_crd_cli_debug_metrics_and_supervision(crd_sequence):
    """/debug/engine carries each engine's shards document, /metrics the
    shard gauges and the incremental compile phases, and the CRD store's
    list+watch thread is a supervised component."""
    start, last = crd_sequence["start"], crd_sequence["delete"]
    for path in ("authorization", "admission"):
        shards = start["debug"][path]["engine"]["shards"]
        assert shards["scope"] == "full" and shards["shards"] > 0
        assert start["debug"][path]["engine"]["name"] == path
    text = last["metrics"]
    for engine in ("authorization", "admission"):
        eng = last["debug"][engine]["engine"]
        assert f'cedar_policy_shards{{engine="{engine}"}} {eng["shards"]["shards"]}' in text
        assert f'cedar_dirty_shards{{engine="{engine}"}} {eng["last_load"]["dirty_shards"]}' \
            in text
    assert 'cedar_compile_seconds_count{phase="hash",scope="incremental"} 6' in text
    assert 'cedar_compile_seconds_count{phase="hash",scope="full"} 2' in text
    components = start["supervisor"]["components"]
    assert "store.crd.CRDPolicyStore" in components


@pytest.mark.parametrize("flag", ["--kubeconfig", "--shard-buckets", "--no-incremental-compile",
                                  "--validation-mode"])
def test_new_flags_default_as_jax(flag):
    """This slice's CLI flags: the JAX CLI's defaults, types and actions
    (--shard-buckets 0 means the default of 64 buckets in both)."""
    from cedar_tpu.cli.webhook import make_parser as j_make_parser

    jp, tp = j_make_parser(), make_parser()
    j_act, t_act = jp._option_string_actions[flag], tp._option_string_actions[flag]
    assert getattr(tp.parse_args([]), t_act.dest) == getattr(jp.parse_args([]), j_act.dest)
    assert (t_act.type, t_act.nargs, type(t_act).__name__) == (
        j_act.type, j_act.nargs, type(j_act).__name__)
