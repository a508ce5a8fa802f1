"""Live policy reload in the port (cedar_tpu_torch/cli/webhook.py
TorchReloader, the directory stores' tickers, TorchPolicyEngine.load's
warm-before-publish), against the JAX package on the CPU.

The JAX side is its WebhookServer over JAX directory stores, with its
``TPUReloader`` over two ``TPUPolicyEngine(incremental=False)`` (the
authorization stack and the admission stack), as its CLI wires them with
``--no-incremental-compile``; the port's is its CLI's build_server with
``--device cpu``. Both serve the same directory; the test makes the same
edits in the same order and drives every reload by hand, with the stores'
``load_policies()`` and ``reload_if_changed()`` (no sleeps), then POSTs
the same bodies to both: the HTTP status and the document must be equal,
on ``/v1/authorize`` and ``/v1/admit``, for the device and the
interpreter backends.

The swap contract the tests pin:
  (a) every answer is wholly one generation's: the old set's or the new
      set's (8 clients POST while a policy flips five times; and a batch
      held between encode and decode across a swap);
  (b) once reload_if_changed() has returned True, every request sent
      after it gets the new set's answer;
  (c) the authorization engine swaps before the admission engine, and
      between the two swaps each endpoint answers from its own
      generation;
  (d) an unchanged tick compiles nothing;
  (e) a failed compile, placement, warm-up or load hook leaves the old
      plane serving with its load_generation, and the next tick
      recompiles.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from cedar_tpu.cli.webhook import TPUReloader as JTPUReloader
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import AdmissionFastPath as JAdmissionFastPath
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch.apis.v1alpha1 import CedarConfig
from cedar_tpu_torch.cli.webhook import make_parser
from cedar_tpu_torch.engine import evaluator as t_evaluator
from cedar_tpu_torch.stores.config import cedar_config_stores
from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
from cedar_tpu_torch.stores.quarantine import quarantine_registry
from test_torch_server import (
    ADM_BODIES,
    ADM_FILES,
    DEMO_BODIES,
    GATED_BODIES,
    SYNTH_BODIES,
    _port_server,
    _sar,
    _write_policies,
    request,
)

# ------------------------------------------------------------- the edits

EXTRA_PERMIT = """
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { resource.resource == "nodes" };
forbid (principal, action == k8s::admission::Action::"delete", resource is core::v1::Secret);
"""
EXTRA_FORBID = EXTRA_PERMIT.replace('permit (principal, action == k8s::Action::"get"',
                                    'forbid (principal, action == k8s::Action::"get"')
# the failed-reload cases flip extra.cedar between EXTRA_PERMIT and this:
# both endpoints' answers change
EXTRA_FORBID_CM = EXTRA_FORBID.replace("core::v1::Secret", "core::v1::ConfigMap")
# interpreter-fallback policies (alternation products past the lowering's
# clause ceiling), one per endpoint: their scopes gate rows on the plane
GATED_FORBIDS = (
    'forbid (principal in k8s::Group::"joiners", action == k8s::Action::"list",\n'
    "        resource is k8s::Resource)\n"
    "  when { "
    + " && ".join('(resource.resource == "widgets" || resource.name == "10.0.0.2")'
                  for _ in range(12))
    + " };\n"
    "forbid (principal is k8s::ServiceAccount,\n"
    '        action == k8s::admission::Action::"update",\n'
    "        resource is core::v1::ConfigMap)\n"
    "  when { "
    + " && ".join('(resource.metadata.namespace == "team-a" || resource.metadata.name == "zz")'
                  for _ in range(12))
    + " };\n"
)


def _edit(d, step: str) -> None:
    if step == "add-file":
        (d / "extra.cedar").write_text(EXTRA_PERMIT)
    elif step == "remove-file":
        (d / "admission-demo.cedar").unlink()
    elif step == "permit-to-forbid":
        (d / "extra.cedar").write_text(EXTRA_FORBID)
    elif step == "add-gated":
        (d / "gated-extra.cedar").write_text(GATED_FORBIDS)
    elif step == "poison":
        (d / "extra.cedar").write_text("permit (principal,")
    elif step != "unchanged":
        raise ValueError(step)


# step -> (reload expected, the endpoints whose answers it must change)
STEPS = {
    "add-file": (True, ("/v1/authorize", "/v1/admit")),
    "remove-file": (True, ("/v1/admit",)),
    "permit-to-forbid": (True, ("/v1/authorize",)),
    "add-gated": (True, ("/v1/authorize", "/v1/admit")),
    "poison": (False, ()),
    "unchanged": (False, ()),
}
ENDPOINTS = ("/v1/authorize", "/v1/admit")
NODES_BODIES = [_sar("sam", "get", "nodes"), _sar("pat", "get", "nodes", groups=["platform-team"]),
                _sar("sam", "list", "nodes")]
LIST_WIDGETS = [_sar("jo", "list", "widgets", groups=["joiners"], name=nm)
                for nm in ("10.0.0.2", "x")]


def _adm(uid: str, op: str, user: str, kind: str = "ConfigMap", ns: str = "team-a",
         groups=()) -> bytes:
    """One AdmissionReview of a `kind` object named "obj" in `ns`."""
    resource = {"ConfigMap": "configmaps", "Secret": "secrets"}[kind]
    req = {"uid": uid, "kind": {"group": "", "version": "v1", "kind": kind},
           "resource": {"group": "", "version": "v1", "resource": resource},
           "name": "obj", "namespace": ns, "operation": op, "dryRun": False,
           "userInfo": {"username": user, "uid": "u", "groups": list(groups)}}
    obj = {"apiVersion": "v1", "kind": kind, "metadata": {"name": "obj", "namespace": ns}}
    req["oldObject" if op == "DELETE" else "object"] = obj
    if op == "UPDATE":
        req["oldObject"] = obj
    return json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                       "request": req}).encode()


SA = "system:serviceaccount:default:ci-runner"
# rows each edit is made to flip: a clean delete (the plane decides it),
# a service account's create outside "default" and update in team-a (the
# fallback forbids' scopes: gated rows), a tenant's create without an
# owner label (the demo's owner-label forbid)
ADM_DIRECTED = {
    "delete-cm": _adm("d-cm", "DELETE", "alice"),
    "delete-secret": _adm("d-secret", "DELETE", "alice", kind="Secret"),
    "sa-create-cm": _adm("sa-create", "CREATE", SA),
    "sa-update-cm": _adm("sa-update", "UPDATE", SA),
    "tenant-create-cm": _adm("t-create", "CREATE", "bob", groups=["tenants"]),
}
BODIES = {
    "/v1/authorize": (list(DEMO_BODIES.values()) + list(GATED_BODIES.values())
                      + SYNTH_BODIES[:40] + NODES_BODIES + LIST_WIDGETS),
    "/v1/admit": list(ADM_DIRECTED.values()) + ADM_BODIES[:80],
}


def _base_dir(d):
    d.mkdir()
    _write_policies(d)
    for name, text in ADM_FILES.items():
        (d / name).write_text(text)
    return d


def _jax_server(policy_dir, backend: str):
    """(JAX server, its stores, its TPUReloader or None): both stacks as
    the JAX CLI wires them with --no-incremental-compile, the reloader
    not started (each test drives it)."""
    stores = JTieredPolicyStores([JDirectoryPolicyStore(str(policy_dir), start_ticker=False)])
    adm_stores = JTieredPolicyStores(
        list(stores.stores) + [j_adm.allow_all_admission_policy_store()])
    fast = adm_fast = reloader = None
    if backend == "interpreter":
        authz = j_auth.CedarWebhookAuthorizer(stores)
        handler = j_adm.CedarAdmissionHandler(adm_stores)
    else:
        engine = TPUPolicyEngine(incremental=False)
        adm_engine = TPUPolicyEngine(incremental=False)
        reloader = JTPUReloader(stores, targets=[(engine, stores), (adm_engine, adm_stores)],
                                interval_s=3600)
        assert reloader.reload_if_changed()
        authz = j_auth.CedarWebhookAuthorizer(
            stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
        handler = j_adm.CedarAdmissionHandler(
            adm_stores, evaluate=adm_engine.evaluate, evaluate_batch=adm_engine.evaluate_batch)
        fast = JSARFastPath(engine, authz)
        adm_fast = JAdmissionFastPath(adm_engine, handler)
    srv = JWebhookServer(authz, handler, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=fast, admission_fastpath=adm_fast, pipeline_depth=2,
                         request_timeout_s=60.0)
    srv.start()
    return srv, stores, reloader


def _port(policy_dir, backend: str, reload_seconds: float = 3600.0):
    """The port's CLI server; its reloader thread polls every
    reload_seconds (the default: never, within a test)."""
    extra = ("--backend", "interpreter") if backend == "interpreter" else ()
    return _port_server(policy_dir, "--request-timeout-ms", "60000", "--reload-seconds",
                        str(reload_seconds), *extra)


def _reread(stores) -> None:
    for s in stores:
        if hasattr(s, "load_policies"):
            s.load_policies()


def _port_tick(t) -> bool:
    """One reload of the port server by hand: its stores re-read, then
    its reloader's tick (False with no reloader: the interpreter)."""
    _reread(t.authorizer.stores)
    return t.reloader.reload_if_changed() if t.reloader is not None else False


def _jax_tick(stores, reloader) -> bool:
    _reread(stores)
    return reloader.reload_if_changed() if reloader is not None else False


def _answers(port: int, path: str, bodies=None) -> list:
    bodies = BODIES[path] if bodies is None else bodies
    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(lambda b: request(port, "POST", path, b), bodies))


def _engines(t) -> list:
    return [engine for engine, _ in t.reloader.targets] if t.reloader is not None else []


def _count_loads(engine, calls: list, monkeypatch=None) -> None:
    """Record each load call of engine in calls."""
    real = engine.load

    def load(*a, **kw):
        calls.append(engine)
        return real(*a, **kw)

    if monkeypatch is not None:
        monkeypatch.setattr(engine, "load", load)
    else:
        engine.load = load


# ------------------------------------------- the edit sequence, both sides


@pytest.fixture(scope="module", params=["device", "interpreter"])
def edit_sequence(request, tmp_path_factory):
    """Every step of STEPS in order on one directory served by both
    servers: per step the answers before and after, what each reload
    returned, the port engines' load calls and generations, and its
    /debug/engine."""
    backend = request.param
    d = _base_dir(tmp_path_factory.mktemp(f"reload-{backend}") / "policies")
    j, j_stores, j_reloader = _jax_server(d, backend)
    t = _port(d, backend)
    calls: list = []
    for engine in _engines(t):
        _count_loads(engine, calls)
    out = {}
    try:
        prev = {path: _answers(t.bound_port, path) for path in ENDPOINTS}
        for step in STEPS:
            _edit(d, step)
            gens = [e.load_generation for e in _engines(t)]
            del calls[:]
            rec = {"port_reload": _port_tick(t), "jax_reload": _jax_tick(j_stores, j_reloader),
                   "gens": (gens, [e.load_generation for e in _engines(t)]),
                   "loads": list(calls), "engines": _engines(t), "prev": prev,
                   "debug": t.debug_engine(), "backend": backend,
                   "quarantined": quarantine_registry().is_quarantined("directory",
                                                                       "extra.cedar")}
            rec["port"] = {path: _answers(t.bound_port, path) for path in ENDPOINTS}
            rec["jax"] = {path: _answers(j.bound_port, path) for path in ENDPOINTS}
            out[step] = rec
            prev = rec["port"]
    finally:
        j.stop()
        t.stop()
    return out


@pytest.mark.parametrize("path", ENDPOINTS)
@pytest.mark.parametrize("step", list(STEPS))
def test_edit_step_equals_jax(edit_sequence, step, path):
    """After each edit and its reload, every body's HTTP status and
    document equal the JAX server's; the edits that change answers on
    this endpoint changed some."""
    rec = edit_sequence[step]
    assert rec["port"][path] == rec["jax"][path]
    changed = sum(a != b for a, b in zip(rec["port"][path], rec["prev"][path]))
    if path in STEPS[step][1]:
        assert changed > 0, f"{step} changed no {path} answer"
    else:
        assert changed == 0


@pytest.mark.parametrize("step", list(STEPS))
def test_edit_step_reloads_as_jax(edit_sequence, step):
    """The port's reload steps exactly where the JAX reloader's does: a
    content change recompiles both engines (authorization first) and
    steps both load generations, as /debug/engine shows; a poisoned file
    (quarantined, its last good policies kept) and an unchanged tick
    compile nothing and leave the generations (d)."""
    rec = edit_sequence[step]
    want_reload = STEPS[step][0]
    if rec["backend"] == "interpreter":
        assert rec["port"] and rec["jax_reload"] is False and rec["port_reload"] is False
        assert rec["debug"] == {}
    else:
        assert rec["port_reload"] is rec["jax_reload"] is want_reload
        before, after = rec["gens"]
        assert after == [g + want_reload for g in before]
        assert rec["loads"] == (rec["engines"] if want_reload else [])
        assert [rec["debug"][p]["engine"]["load_generation"]
                for p in ("authorization", "admission")] == after
        if want_reload:
            last = rec["debug"]["authorization"]["engine"]["last_load"]
            assert last["generation"] == after[0]
            assert set(last["compile_seconds"]) == {"lower", "pack", "place", "warm", "total"}
    assert rec["quarantined"] is (step in ("poison", "unchanged"))


# ----------------------------------------------------- a failed reload (e)


def _raise_once(real):
    state = {"armed": True}

    def fn(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected compile failure")
        return real(*a, **kw)

    return fn


@pytest.fixture(scope="module")
def fail_servers(tmp_path_factory):
    """(directory, JAX server, its stores and reloader, port server) on
    the device backend, shared by the failed-reload cases: each flips the
    directory between two versions and leaves both servers on the same
    one."""
    d = _base_dir(tmp_path_factory.mktemp("reload-fail") / "policies")
    (d / "extra.cedar").write_text(EXTRA_PERMIT)
    j, j_stores, j_reloader = _jax_server(d, "device")
    t = _port(d, "device")
    yield d, j, j_stores, j_reloader, t
    j.stop()
    t.stop()


@pytest.mark.parametrize("point", ["lower", "pack", "place", "warm", "hook"])
def test_failed_reload_keeps_the_old_plane(fail_servers, monkeypatch, point):
    """The authorization engine's load fails once at `point`: it keeps
    serving its old plane with its load_generation, while the admission
    engine, loaded next, steps (c, e): /v1/authorize still equals the JAX
    server before its reload, /v1/admit the JAX server after it. The next
    tick recompiles the authorization engine alone, and both endpoints
    equal the reloaded JAX server. Nothing falls back to the interpreter."""
    d, j, j_stores, j_reloader, t = fail_servers
    engine, adm_engine = _engines(t)
    old = {path: _answers(j.bound_port, path) for path in ENDPOINTS}
    text = (d / "extra.cedar").read_text()
    (d / "extra.cedar").write_text(EXTRA_FORBID_CM if text == EXTRA_PERMIT else EXTRA_PERMIT)
    if point == "warm":
        monkeypatch.setattr(engine, "warmup", _raise_once(engine.warmup))
    elif point == "hook":
        monkeypatch.setattr(engine, "load_hooks",
                            engine.load_hooks + [_raise_once(lambda cs: None)])
    else:
        name = {"lower": "lower_tiers", "pack": "pack",
                "place": "compiled_set_from_numpy"}[point]
        monkeypatch.setattr(t_evaluator, name, _raise_once(getattr(t_evaluator, name)))
    gens = (engine.load_generation, adm_engine.load_generation)
    cs = engine.compiled_set
    assert _port_tick(t) is True  # the admission engine loaded
    assert (engine.load_generation, adm_engine.load_generation) == (gens[0], gens[1] + 1)
    assert engine.compiled_set is cs
    assert _answers(t.bound_port, "/v1/authorize") == old["/v1/authorize"]
    assert _jax_tick(j_stores, j_reloader) is True
    new = {path: _answers(j.bound_port, path) for path in ENDPOINTS}
    assert all(new[path] != old[path] for path in ENDPOINTS)
    assert _answers(t.bound_port, "/v1/admit") == new["/v1/admit"]
    calls: list = []
    for e in (engine, adm_engine):
        _count_loads(e, calls, monkeypatch)
    assert _port_tick(t) is True
    assert calls == [engine]
    assert (engine.load_generation, adm_engine.load_generation) == (gens[0] + 1, gens[1] + 1)
    assert {path: _answers(t.bound_port, path) for path in ENDPOINTS} == new
    assert t.metrics.fallback_batches_total.value(path="authorization",
                                                  reason="evaluator_error") == 0


# ------------------------------------------------ swap under traffic (a, b)

FLIP_A = ""
FLIP_B = """
forbid (principal in k8s::Group::"joiners", action == k8s::Action::"get",
        resource is k8s::Resource);
forbid (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { resource.resource == "nodes" };
forbid (principal, action == k8s::admission::Action::"delete", resource);
forbid (principal is k8s::ServiceAccount, action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap);
"""
SWAP_BODIES = [("/v1/authorize", b) for b in BODIES["/v1/authorize"]] + [
    ("/v1/admit", b) for b in BODIES["/v1/admit"][:40]]


@pytest.fixture(scope="module")
def swap_setup(tmp_path_factory):
    """A directory whose flip.cedar holds version A (empty) or B (four
    forbids that flip gated and clean rows of both endpoints), the
    oracle answers of each version from the JAX server, and the port
    server on it."""
    d = _base_dir(tmp_path_factory.mktemp("reload-swap") / "policies")
    (d / "flip.cedar").write_text(FLIP_A)
    j, j_stores, j_reloader = _jax_server(d, "device")
    try:
        oracle = {}
        for version, text in (("A", FLIP_A), ("B", FLIP_B), ("A2", FLIP_A)):
            (d / "flip.cedar").write_text(text)
            _jax_tick(j_stores, j_reloader)
            oracle[version[0]] = [request(j.bound_port, "POST", p, b) for p, b in SWAP_BODIES]
    finally:
        j.stop()
    assert oracle["A"] != oracle["B"]
    t = _port(d, "device")
    yield d, oracle, t
    t.stop()


def _set_version(d, t, version: str) -> float:
    """Write the version and reload; returns when reload_if_changed()
    returned True."""
    (d / "flip.cedar").write_text(FLIP_A if version == "A" else FLIP_B)
    assert _port_tick(t) is True
    return time.monotonic()


def test_swap_under_traffic_answers_one_generation(swap_setup):
    """8 client threads POST to both endpoints while flip.cedar flips
    A -> B -> A ... five times: every answer is the oracle's for the
    version before or after the swap in flight (a), and every request
    sent after reload_if_changed() returned and answered before the next
    swap began has the new version's answer (b)."""
    d, oracle, t = swap_setup
    version = "A" if (d / "flip.cedar").read_text() == FLIP_A else "B"
    swaps = []  # (began, returned, new version)
    records = []
    stop = threading.Event()
    lock = threading.Lock()

    def client(k):
        i = k
        while not stop.is_set():
            path, body = SWAP_BODIES[i % len(SWAP_BODIES)]
            sent = time.monotonic()
            got = request(t.bound_port, "POST", path, body)
            with lock:
                records.append((sent, time.monotonic(), i % len(SWAP_BODIES), got))
            i += 7

    threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for th in threads:
        th.start()
    try:
        for _ in range(5):
            time.sleep(0.3)
            version = "B" if version == "A" else "A"
            began = time.monotonic()
            swaps.append((began, _set_version(d, t, version), version))
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
    assert len(records) > 100
    n_after = 0
    for sent, done, i, got in records:
        assert got in (oracle["A"][i], oracle["B"][i]), SWAP_BODIES[i]
        for k, (_began, returned, ver) in enumerate(swaps):
            next_began = swaps[k + 1][0] if k + 1 < len(swaps) else float("inf")
            if sent > returned and done < next_began:
                assert got == oracle[ver][i], (ver, SWAP_BODIES[i])
                n_after += 1
    assert n_after > 50
    flipped = sum(got != oracle["A"][i] for _s, _d, i, got in records)
    assert flipped > 0


# (endpoint, body, the version a batch encoded on A and decoded after the
# swap to B answers): a clean row its snapshot's, a gated row the current
# set's. "authorize-synth" is a body a synth.cedar policy allows in both
# versions: B's flip.cedar sorts before synth.cedar, so its policies sit
# at other indices in B's plane, and a word decoded against B's set
# would name another policy
HELD = {
    "authorize-clean": ("/v1/authorize", _sar("sam", "get", "nodes"), "A"),
    "authorize-synth": ("/v1/authorize", None, "A"),
    "authorize-gated": ("/v1/authorize", GATED_BODIES["joiners-widgets-10.0.0.1"], "B"),
    "admit-clean": ("/v1/admit", ADM_DIRECTED["delete-cm"], "A"),
    "admit-gated": ("/v1/admit", ADM_DIRECTED["sa-create-cm"], "B"),
}


@pytest.mark.parametrize("kind", sorted(HELD))
def test_batch_held_across_a_swap(swap_setup, kind):
    """A batch encoded on version A is held between its device launch and
    its decode while the reload swaps in B. A clean row answers wholly
    from the snapshot it was encoded on (A); a gated row re-runs through
    engine.evaluate_batch at decode time and answers wholly from the
    current set (B), as the JAX fast path does. Both are the oracle's
    answers of that version, never a mix."""
    d, oracle, t = swap_setup
    path, body, want_version = HELD[kind]
    fast = t.fastpath if path == "/v1/authorize" else t.admission_fastpath
    if body is None:
        i = next(k for k, (p, _b) in enumerate(SWAP_BODIES)
                 if p == path and oracle["A"][k] == oracle["B"][k]
                 and "synth.cedar" in oracle["A"][k][1]["status"].get("reason", ""))
        body = SWAP_BODIES[i][1]
    i = SWAP_BODIES.index((path, body))
    want = {v: oracle[v][i] for v in ("A", "B")}
    assert (want["A"] == want["B"]) is (kind == "authorize-synth")
    (d / "flip.cedar").write_text(FLIP_A)
    _port_tick(t)
    entered, release = threading.Event(), threading.Event()
    real = fast.pipeline_decode

    def held(ctx):
        entered.set()
        release.wait(60)
        return real(ctx)

    fast.pipeline_decode = held
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(request, t.bound_port, "POST", path, body)
            assert entered.wait(60)
            fast.pipeline_decode = real
            _set_version(d, t, "B")
            release.set()
            got = fut.result(60)
    finally:
        fast.pipeline_decode = real
        release.set()
    assert got == want[want_version]
    assert request(t.bound_port, "POST", path, body) == want["B"]


# --------------------------------------------------- the CLI and its thread


@pytest.fixture(scope="module")
def threaded_server(tmp_path_factory):
    """The port server with its reloader thread polling every 0.1 s: one
    edit, re-read by hand, reaches both engines without a tick from the
    test. Returns (server, directory, generations before, JAX answers
    after the edit)."""
    d = _base_dir(tmp_path_factory.mktemp("reload-thread") / "policies")
    t = _port(d, "device", reload_seconds=0.1)
    before = [e.load_generation for e in _engines(t)]
    (d / "extra.cedar").write_text(EXTRA_FORBID)
    _reread(t.authorizer.stores)
    deadline = time.monotonic() + 60
    while [e.load_generation for e in _engines(t)] != [g + 1 for g in before]:
        assert time.monotonic() < deadline, "the reloader thread did not reload"
        time.sleep(0.05)
    j, _j_stores, _j_reloader = _jax_server(d, "device")
    try:
        want = {path: _answers(j.bound_port, path) for path in ENDPOINTS}
    finally:
        j.stop()
    yield t, before, want
    t.stop()


def test_reloader_thread_reloads_both_engines(threaded_server):
    t, before, want = threaded_server
    doc = t.debug_engine()
    assert [doc[p]["engine"]["load_generation"] for p in ("authorization", "admission")] == \
        [g + 1 for g in before]
    assert {path: _answers(t.bound_port, path) for path in ENDPOINTS} == want


@pytest.mark.parametrize("phase", ["lower", "pack", "place", "warm", "total"])
def test_compile_seconds_per_load_and_phase(threaded_server, phase):
    """cedar_compile_seconds{phase,scope="full"}: one observation per
    load (two at start, two for the reload) and phase."""
    t, _before, _want = threaded_server
    text = request(t.bound_metrics_port, "GET", "/metrics")[1].decode()
    line = f'cedar_compile_seconds_count{{phase="{phase}",scope="full"}} '
    counts = [ln for ln in text.splitlines() if ln.startswith(line)]
    assert counts == [line + "4"], counts


@pytest.mark.parametrize("argv,want", [([], 5.0), (["--reload-seconds", "0.25"], 0.25)])
def test_reload_seconds_flag(argv, want):
    assert make_parser().parse_args(argv).reload_seconds == want


@pytest.mark.parametrize("backend", ["device", "interpreter"])
def test_server_stop_leaves_no_reload_thread(tmp_path, backend):
    """server.stop() stops the reloader thread and every store ticker it
    started; none is left alive."""
    names = ("reloader", "directory-store-reload")
    before = {th for th in threading.enumerate() if th.name in names}
    t = _port(_base_dir(tmp_path / "policies"), backend)
    started = {th for th in threading.enumerate() if th.name in names} - before
    assert any(th.name == "directory-store-reload" for th in started)
    assert any(th.name == "reloader" for th in started) is (backend == "device")
    t.stop()
    for th in started:
        th.join(5)
    assert not [th for th in started if th.is_alive()]


# ------------------------------------------------- StoreConfig and tickers


@pytest.mark.parametrize("interval,want", [("30s", 30.0), ("90s", 90.0), ("2h", 7200.0),
                                           (None, 60.0)])
def test_refresh_interval_reaches_the_store(tmp_path, interval, want):
    ds = {"path": str(tmp_path)}
    if interval is not None:
        ds["refreshInterval"] = interval
    config = CedarConfig.from_dict({"spec": {"stores": [{"type": "directory",
                                                         "directoryStore": ds}]}})
    config.validate()
    stores = cedar_config_stores(config)
    try:
        assert [s.refresh_interval_s for s in stores] == [want]
    finally:
        for s in stores:
            s.close()


def test_ticker_rereads_the_directory(tmp_path):
    """A store's ticker re-reads its files on its interval: an added file
    reaches policy_set() and steps content_generation() without a
    load_policies() call."""
    (tmp_path / "a.cedar").write_text(EXTRA_PERMIT)
    store = DirectoryPolicyStore(str(tmp_path), refresh_interval_s=0.05)
    try:
        gen = store.content_generation()
        (tmp_path / "b.cedar").write_text(EXTRA_FORBID)
        deadline = time.monotonic() + 30
        while store.content_generation() == gen:
            assert time.monotonic() < deadline, "the ticker did not re-read"
            time.sleep(0.02)
        assert sorted({p.filename for p in store.policy_set().policies()}) == ["a.cedar", "b.cedar"]
    finally:
        store.close()


def test_close_stops_the_ticker(tmp_path):
    (tmp_path / "a.cedar").write_text(EXTRA_PERMIT)
    store = DirectoryPolicyStore(str(tmp_path), refresh_interval_s=0.05)
    store.close()
    store._ticker.join(5)
    assert not store._ticker.is_alive()
    gen = store.content_generation()
    (tmp_path / "b.cedar").write_text(EXTRA_FORBID)
    time.sleep(0.2)
    assert store.content_generation() == gen


def test_loads_run_with_the_collector_paused(tmp_path):
    """A reloader's load runs with the cyclic garbage collector off; after
    a successful load the heap is frozen (later collections skip the
    compiled sets) and the collector is on again; after a failed one
    nothing is frozen."""
    import gc

    from cedar_tpu_torch.cli.webhook import TorchReloader
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.stores.store import TieredPolicyStores

    (tmp_path / "a.cedar").write_text(EXTRA_PERMIT)
    store = DirectoryPolicyStore(str(tmp_path), start_ticker=False)
    stores = TieredPolicyStores([store])
    engine = TorchPolicyEngine(device="cpu")
    seen = []
    engine.load_hooks.append(lambda cs: seen.append(gc.isenabled()))
    reloader = TorchReloader(stores, targets=[(engine, stores)], interval_s=3600)
    assert gc.isenabled()
    gc.unfreeze()
    try:
        assert reloader.reload_if_changed()
        frozen = gc.get_freeze_count()
        assert frozen > 0 and gc.isenabled()
        (tmp_path / "a.cedar").write_text(EXTRA_FORBID)
        store.load_policies()
        engine.load_hooks.append(_raise_once(lambda cs: None))
        assert not reloader.reload_if_changed()
        # frozen objects that die leave the count: it can only fall
        assert gc.isenabled() and gc.get_freeze_count() <= frozen
        assert reloader.reload_if_changed() and engine.load_generation == 2
        assert seen == [False] * 3
    finally:
        gc.unfreeze()


def test_a_load_leaves_no_cyclic_garbage():
    """What the reloader's paused collector and gc.freeze() rely on: a
    full load (compile, placement, warm-up, a fast path's load hook)
    makes no cyclic garbage, and the set it replaces is freed by
    reference counting alone."""
    import gc
    import weakref

    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import SARFastPath
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    corpus = synth_corpus(200, seed=3)
    engine = TorchPolicyEngine(device="cpu")
    engine.load(corpus.tiers(), max_batch=1)
    stores = TieredPolicyStores([MemoryStore("synth", corpus.tiers()[0])])
    SARFastPath(engine, CedarWebhookAuthorizer(stores,
                                               evaluate_batch=engine.evaluate_batch)).prepare()
    tiers = [PolicySet.from_source(EXTRA_FORBID, "extra"), corpus.tiers()[0]]
    gc.collect()
    gc.disable()
    try:
        old = weakref.ref(engine.compiled_set)
        engine.load(tiers, max_batch=1)
        assert old() is None
        assert gc.collect() == 0
    finally:
        gc.enable()
