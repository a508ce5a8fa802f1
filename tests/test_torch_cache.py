"""The port's decision cache (cedar_tpu_torch/cache/) and its wiring against
the JAX package's cedar_tpu/cache, on the CPU, at tolerance 0.

  * fingerprints: 600 seeded SubjectAccessReview bodies (groups, extra,
    label and field selectors in shuffled order, wire variants) and 600
    seeded AdmissionReview bodies give the JAX package's keys byte for
    byte, and so do the memo, the recorder's name parts, tenant- and
    protocol-scoped bodies and bodies that do not parse;
  * DecisionCache: one FakeClock op script (get, put with a TTL cap,
    clock steps, generation steps, peer_lookup, invalidate_all) gives the
    same results, stats() and metric counts on both sides;
  * SingleFlight: the leader runs once, followers share its answer, a
    follower's deadline raises the port's DeadlineExceeded while the
    leader runs on, a leader's failure reaches every follower as a fresh
    error, with the same coalesced counts;
  * shard-scoped stamps over TorchPolicyEngine(device="cpu",
    incremental=True) and the JAX TPUPolicyEngine(incremental=True): after
    a one-file edit that deletes or moves policies the same entries
    survive on both sides; after an edit that ADDS a policy the port also
    kills every entry the added policy's actions could change, so none of
    its survivors is stale, while the JAX stamp keeps stale ones (ROADMAP
    §C); a rebuild or a full compile kills every entry; plane_composite
    and plane_wire_state agree;
  * the servers: a port WebhookServer (the CLI's wiring, CPU engine and
    cache) and a JAX WebhookServer with a DecisionCache over one seeded
    repeating stream give the same answers and the same hit, miss and
    coalesced counts; a hit while the breaker is open answers as JAX's
    does and a miss gets the posture, never cached; a raising cache is a
    miss that goes to the device; /debug/cache; the admission cache takes
    CONNECT and dry-run reviews only.
"""

from __future__ import annotations

import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

from cedar_tpu import cache as jcache
from cedar_tpu.cache.generation import plane_composite as j_plane_composite
from cedar_tpu.cache.generation import plane_wire_state as j_plane_wire_state
from cedar_tpu.chaos.registry import default_registry as j_chaos
from cedar_tpu.engine.batcher import DeadlineExceeded as JDeadlineExceeded
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.entities.admission import AdmissionRequest as JAdmissionRequest
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.lang.parser import parse_policies as j_parse
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.server.http import get_authorizer_attributes as j_attributes
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import cache as tcache
from cedar_tpu_torch.cache.generation import plane_composite, plane_wire_state
from cedar_tpu_torch.chaos.registry import default_registry as t_chaos
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.corpus.synth import synth_source
from cedar_tpu_torch.engine.batcher import DeadlineExceeded
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.entities.admission import AdmissionRequest
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.lang.parser import parse_policies
from cedar_tpu_torch.server import admission as t_adm
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.sar import get_authorizer_attributes
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — admission_bodies, the gated policies


@pytest.fixture(autouse=True, scope="module")
def _jax_counters_restored():
    """The JAX package's counters are process-wide, and its own tests read
    exact counts off them (tests/test_cache.py a hit count of 1). The JAX
    servers of a module using this fixture count into them, so every
    counter is put back as it was when the module ends, whichever file
    the same test process runs next."""
    saved = [(m, dict(m._values)) for m in j_metrics.REGISTRY._metrics
             if isinstance(m, j_metrics.Counter)]
    yield
    for m, values in saved:
        with m._lock:
            m._values.clear()
            m._values.update(values)

# ------------------------------------------------------------ fingerprints

USERS = ["sam", "alice", "c0-user-1", "system:serviceaccount:ns:sa", "system:node:n1",
         "system:kube-scheduler", "system:authorizer:cedar-authorizer", "jo"]
GROUPS = ["dev", "ops", "viewers", "joiners", "platform-team", "system:authenticated"]
VERBS = ["get", "list", "watch", "create", "update", "patch", "delete", "deletecollection",
         "impersonate"]
RESOURCES = ["pods", "nodes", "secrets", "configmaps", "deployments", "widgets", "users",
             "serviceaccounts", "policies"]
LABEL_OPS = ["In", "NotIn", "Exists", "DoesNotExist", "Bogus"]


def _pick(rng, xs):
    return xs[int(rng.integers(len(xs)))]


def _shuffled(rng, xs):
    xs = list(xs)
    rng.shuffle(xs)
    return xs


def _dump(rng, doc) -> bytes:
    """One of several wire renderings of the same document."""
    k = int(rng.integers(4))
    if k == 0:
        return json.dumps(doc).encode()
    if k == 1:
        return json.dumps(doc, indent=2, sort_keys=True).encode()
    if k == 2:
        return json.dumps(doc, separators=(",", ":")).encode()
    return json.dumps(doc, indent=1).encode()


def _sar_doc(rng) -> dict:
    spec: dict = {"user": _pick(rng, USERS), "uid": _pick(rng, ["u1", "u2", ""])}
    if rng.random() < 0.7:
        spec["groups"] = _shuffled(rng, GROUPS)[: int(rng.integers(0, 4))]
    if rng.random() < 0.3:
        spec["extra"] = {_pick(rng, ["Scopes", "reason", "acme.io/tier"]):
                         _shuffled(rng, ["a", "b", "c"])[: int(rng.integers(1, 4))]
                         for _ in range(int(rng.integers(1, 3)))}
    if rng.random() < 0.12:
        spec["nonResourceAttributes"] = {"path": _pick(rng, ["/healthz", "/metrics", "/api"]),
                                         "verb": _pick(rng, ["get", "post"])}
    else:
        ra = {"verb": _pick(rng, VERBS), "resource": _pick(rng, RESOURCES),
              "version": _pick(rng, ["v1", "v1beta1"])}
        if rng.random() < 0.7:
            ra["namespace"] = _pick(rng, ["default", "c0-ns-0", "kube-system"])
        if rng.random() < 0.3:
            ra["group"] = _pick(rng, ["apps", "rbac.authorization.k8s.io", "cedar.k8s.aws"])
        if rng.random() < 0.4:
            ra["name"] = _pick(rng, ["10.0.0.1", "127.0.0.1", "web-0", "x"])
        if rng.random() < 0.15:
            ra["subresource"] = _pick(rng, ["status", "log", "exec"])
        if rng.random() < 0.3:
            ra["labelSelector"] = {"requirements": [
                {"key": _pick(rng, ["owner", "confidentiality", "app"]),
                 "operator": _pick(rng, LABEL_OPS),
                 "values": _shuffled(rng, ["alice", "bob", "public", "x"])[: int(rng.integers(0, 4))]}
                for _ in range(int(rng.integers(1, 4)))]}
        if rng.random() < 0.2:
            ra["fieldSelector"] = {"requirements": [
                {"key": _pick(rng, ["spec.nodeName", "metadata.name"]),
                 "operator": _pick(rng, ["In", "NotIn", "Exists"]),
                 "values": _shuffled(rng, ["n1", "n2"])[: int(rng.integers(0, 3))]}
                for _ in range(int(rng.integers(1, 3)))]}
        spec["resourceAttributes"] = ra
    return {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": spec}


def _sar_bodies(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [_dump(rng, _sar_doc(rng)) for _ in range(n)]


def _adm_bodies(seed: int, n: int) -> list:
    """chip_smoke's seeded AdmissionReview traffic, every third review
    made a CONNECT or a dry run (the cacheable kinds)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, body in enumerate(chip_smoke.admission_bodies(n, seed)):
        try:
            doc = json.loads(body)
        except ValueError:
            out.append(body)
            continue
        req = doc.get("request") if isinstance(doc, dict) else None
        if isinstance(req, dict) and i % 3 == 1:
            req["operation"] = "CONNECT"
        elif isinstance(req, dict) and i % 3 == 2:
            req["dryRun"] = True
        out.append(_dump(rng, doc))
    return out


@pytest.mark.parametrize("chunk", range(10))
def test_sar_fingerprints_equal_jax(chunk):
    """60 seeded SAR bodies per chunk: the port's key is the JAX key; a
    re-rendering of the same document keeps it."""
    rng = np.random.default_rng(1000 + chunk)
    for body in _sar_bodies(chunk, 60):
        got = tcache.fingerprint_body("authorize", body)
        assert got is not None and got == jcache.fingerprint_body("authorize", body)
        assert tcache.fingerprint_body("authorize", _dump(rng, json.loads(body))) == got
        attrs = get_authorizer_attributes(json.loads(body))
        assert tcache.fingerprint_attributes(attrs) == got


@pytest.mark.parametrize("chunk", range(5))
def test_admission_fingerprints_equal_jax(chunk):
    """120 seeded AdmissionReview bodies per chunk (CREATE, UPDATE,
    DELETE, CONNECT, dry runs, conversion errors): the JAX key, byte for
    byte, and the same key whatever the review's uid."""
    for body in _adm_bodies(50 + chunk, 120):
        got = tcache.fingerprint_body("admit", body)
        assert got == jcache.fingerprint_body("admit", body)
        if got is None:
            continue
        doc = json.loads(body)
        doc["request"]["uid"] = "another-uid"
        assert tcache.fingerprint_body("admit", json.dumps(doc).encode()) == got
        req = AdmissionRequest.from_admission_review(json.loads(body))
        jreq = JAdmissionRequest.from_admission_review(json.loads(body))
        assert tcache.fingerprint_admission_request(req) == \
            jcache.fingerprint_admission_request(jreq) == got


UNKEYABLE = {"malformed": b'{"spec": {"user": ', "empty": b"", "array": b"[1, 2]",
             "null": b"null", "not-utf8": b"\xff\xfe{}", "number": b"42",
             "string": b'"spec"'}


@pytest.mark.parametrize("name", sorted(UNKEYABLE))
@pytest.mark.parametrize("endpoint", ["authorize", "admit"])
def test_unkeyable_bodies_equal_jax(endpoint, name):
    body = UNKEYABLE[name]
    assert tcache.fingerprint_body(endpoint, body) == jcache.fingerprint_body(endpoint, body)


class _Scoped(bytes):
    """A body carrying the tenant or protocol its front end resolved."""

    tenant = ""
    protocol = ""


@pytest.mark.parametrize("tenant,protocol", [("alpha", ""), ("", "extauthz"), ("beta", "batch")])
def test_scoped_body_fingerprints_equal_jax(tenant, protocol):
    """A tenant or protocol splits the key (and the memo row) as in JAX."""
    for body in _sar_bodies(77, 20):
        b = _Scoped(body)
        b.tenant, b.protocol = tenant, protocol
        got = tcache.fingerprint_body("authorize", b)
        assert got == jcache.fingerprint_body("authorize", b)
        assert got != tcache.fingerprint_body("authorize", body)
        assert tcache.FingerprintMemo().fingerprint("authorize", b) == got


def test_memo_equals_jax():
    """A capacity-bounded memo over a repeating stream: the same keys and
    the same memo size, each unique body parsed once."""
    bodies = _sar_bodies(5, 40)
    rng = np.random.default_rng(5)
    stream = [bodies[int(i)] for i in rng.integers(0, len(bodies), 400)]
    tm, jm = tcache.FingerprintMemo(capacity=16), jcache.FingerprintMemo(capacity=16)
    for body in stream:
        assert tm.fingerprint("authorize", body) == jm.fingerprint("authorize", body)
        assert len(tm._memo) == len(jm._memo) <= 16


@pytest.mark.parametrize("url", ["/v1/authorize", "/v1/admit", "/"])
def test_recorded_name_parts_equal_jax(url):
    for body in _sar_bodies(9, 10) + [b"{"]:
        assert tcache.recorded_name_parts(url, body) == jcache.recorded_name_parts(url, body)
    assert tcache.FINGERPRINT_VERSION == jcache.FINGERPRINT_VERSION


# ---------------------------------------------------------- DecisionCache


class FakeClock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _series(counter, **labels) -> float:
    """A counter series of either package (both key series the same way)."""
    key = tuple((k, labels.get(k, "")) for k in counter.label_names)
    with counter._lock:
        return counter._values.get(key, 0.0)


def _cache_counts(path: str) -> dict:
    """(port, JAX) decision cache counter values of one path."""
    t, j = t_metrics.process_metrics(), j_metrics
    out = {}
    for name in ("hits", "misses", "coalesced"):
        out[name] = (_series(getattr(t, f"decision_cache_{name}_total"), path=path),
                     _series(getattr(j, f"decision_cache_{name}_total"), path=path))
    for reason in ("lru", "ttl", "generation", "flush"):
        out[reason] = (_series(t.decision_cache_evictions_total, path=path, reason=reason),
                       _series(j.decision_cache_evictions_total, path=path, reason=reason))
    return out


CACHE_CONFIGS = {
    "default-ttls": dict(max_entries=16, shards=4),
    "one-shard": dict(max_entries=6, shards=1),
    "more-shards-than-entries": dict(max_entries=3, shards=8),
    "allow-disabled": dict(max_entries=12, shards=2, allow_ttl_s=0.0),
    "short-ttls": dict(max_entries=32, shards=8, allow_ttl_s=2.0, deny_ttl_s=1.0,
                       no_opinion_ttl_s=0.5),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", sorted(CACHE_CONFIGS))
def test_cache_script_equals_jax(config, seed):
    """One op script on both caches under one FakeClock and one
    generation counter: every result, every stats() and the metric counts
    of the path are equal."""
    rng = np.random.default_rng(seed)
    clock, gen = FakeClock(), [0]
    path = f"script-{config}-{seed}"
    kw = dict(CACHE_CONFIGS[config], clock=clock, generation_fn=lambda: gen[0], path=path)
    t, j = tcache.DecisionCache(**kw), jcache.DecisionCache(**kw)
    before = _cache_counts(path)
    keys = [f"k{i}" for i in range(24)]
    classes = ["allow", "deny", "no_opinion", "weird"]
    for step in range(600):
        op = rng.random()
        key = _pick(rng, keys)
        if op < 0.45:
            assert t.get(key) == j.get(key)
        elif op < 0.8:
            cls = _pick(rng, classes)
            ttl = None if rng.random() < 0.7 else float(rng.integers(0, 400))
            g = gen[0] if rng.random() < 0.9 else gen[0] - 1
            val = (cls, f"reason-{step}")
            assert t.put(key, val, cls, generation=g, ttl_s=ttl) == \
                j.put(key, val, cls, generation=g, ttl_s=ttl)
        elif op < 0.9:
            clock.now += float(rng.choice([0.1, 0.6, 1.5, 6.0, 31.0]))
        elif op < 0.95:
            gen[0] += 1
        elif op < 0.99:
            a, b = t.peer_lookup(key), j.peer_lookup(key)
            assert a == b
        else:
            assert t.invalidate_all() == j.invalidate_all()
        assert t.stats() == j.stats()
    assert t.size() == j.size()
    after = _cache_counts(path)
    for name, (tb, jb) in before.items():
        ta, ja = after[name]
        assert ta - tb == ja - jb, name
    assert t.current_generation() == j.current_generation()
    for cls in classes:
        assert t.ttl_for(cls) == j.ttl_for(cls)
        assert tcache.classify_decision(cls) == jcache.classify_decision(cls)


def test_raising_generation_fn_is_a_miss_on_both():
    """A generation_fn that raises stamps a generation equal to nothing."""

    def boom():
        raise RuntimeError("boom")

    for mod in (tcache, jcache):
        c = mod.DecisionCache(generation_fn=boom, path="boom")
        c.put("k", ("allow", ""), "allow")
        assert c.get("k") is None


# ------------------------------------------------------------- SingleFlight


def _flight_run(mod, deadline_cls, n_followers: int, mode: str):
    """One leader held on an event and n followers: [(result or error
    kind, is_leader)], the fn calls and the coalesced count."""
    sf = mod.SingleFlight(f"sf-{mode}-{n_followers}")
    c0 = _coalesced(sf.path, mod)
    entered, release = threading.Event(), threading.Event()
    calls = []

    def fn():
        calls.append(1)
        entered.set()
        release.wait(10)
        if mode == "error":
            raise ValueError("leader failed")
        return ("allow", "r")

    out = []
    errors = []
    lock = threading.Lock()

    def run(timeout):
        try:
            res = sf.do("key", fn, timeout=timeout)
            with lock:
                out.append(res)
        except deadline_cls:
            with lock:
                out.append(("deadline", False))
        except Exception as e:  # noqa: BLE001 — recorded for the caller
            with lock:
                errors.append(e)
                out.append((type(e).__name__, isinstance(e, ValueError)))

    leader = threading.Thread(target=run, args=(None,))
    leader.start()
    assert entered.wait(10)
    timeout = 0.05 if mode == "deadline" else None
    followers = [threading.Thread(target=run, args=(timeout,)) for _ in range(n_followers)]
    for th in followers:
        th.start()
    if mode == "deadline":
        for th in followers:
            th.join(10)
    else:
        # every follower attaches to the flight before the leader finishes
        deadline = time.monotonic() + 10
        while _coalesced(sf.path, mod) - c0 < n_followers and time.monotonic() < deadline:
            time.sleep(0.005)
    release.set()
    leader.join(10)
    for th in followers:
        th.join(10)
    if mode == "error":
        causes = [e.__cause__ for e in errors if isinstance(e, RuntimeError)]
        assert all(isinstance(c, ValueError) for c in causes)
        assert len({id(e) for e in errors}) == len(errors)  # a fresh error each
    return sorted(out, key=repr), len(calls), _coalesced(sf.path, mod) - c0, sf.in_flight()


def _coalesced(path, mod) -> float:
    counter = (t_metrics.process_metrics().decision_cache_coalesced_total if mod is tcache
               else j_metrics.decision_cache_coalesced_total)
    return _series(counter, path=path)


@pytest.mark.parametrize("mode", ["ok", "error", "deadline"])
@pytest.mark.parametrize("n_followers", [1, 4, 12])
def test_singleflight_equals_jax(n_followers, mode):
    """The same leader/follower outcome on both: one evaluation; followers
    share a clean answer, get the leader's failure as a fresh
    RuntimeError caused by it, or, past their deadline, DeadlineExceeded
    (the port's class) while the leader runs on to its answer."""
    t = _flight_run(tcache, DeadlineExceeded, n_followers, mode)
    j = _flight_run(jcache, JDeadlineExceeded, n_followers, mode)
    assert t == j
    outcomes, calls, coalesced, in_flight = t
    assert calls == 1 and coalesced == n_followers and in_flight == 0
    if mode == "deadline":
        assert outcomes.count(("deadline", False)) == n_followers
        assert (("allow", "r"), True) in outcomes


def test_singleflight_sequential_calls_each_lead():
    for mod in (tcache, jcache):
        sf = mod.SingleFlight("seq")
        assert sf.do("k", lambda: 1) == (1, True)
        assert sf.do("k", lambda: 2) == (2, True)


# --------------------------------------------------- shard-scoped survivors

SCOPE_POLICIES, SCOPE_SEED, PER_FILE = 240, 3, 10
LIST_FORBID = 'forbid (principal, action == k8s::Action::"list", resource is k8s::Resource);'


def _scope_files() -> dict:
    lines = synth_source(SCOPE_POLICIES, seed=SCOPE_SEED).split("\n")
    return {f"obj-{k:02d}.cedar": "\n".join(lines[i:i + PER_FILE]) + "\n"
            for k, i in enumerate(range(0, len(lines), PER_FILE))}


def _edit(files: dict, kind: str) -> dict:
    """delete-first: a file loses its first policy (the rest move up);
    delete-last: its last; add-forbid: its first policy becomes a forbid on
    every list (chip_smoke phase 12's event 1)."""
    name = "obj-07.cedar"
    head, rest = files[name].split("\n", 1)
    if kind == "delete-first":
        return {**files, name: rest}
    if kind == "delete-last":
        lines = files[name].rstrip("\n").split("\n")
        return {**files, name: "\n".join(lines[:-1]) + "\n"}
    return {**files, name: LIST_FORBID + "\n" + rest}


def _tiers(parse, ps_cls, files: dict, cache: dict):
    ps = ps_cls()
    for fname in sorted(files):
        key = (fname, files[fname])
        if key not in cache:
            cache[key] = parse(files[fname], fname)
        for i, p in enumerate(cache[key]):
            ps.add(p, policy_id=f"{fname}.policy{i}")
    return [ps]


def _scope_bodies() -> list:
    """SARs that hit the corpus' policies (list and other verbs), the
    default deny and the short-circuits."""
    from cedar_tpu_torch.corpus.synth import synth_corpus

    corpus = synth_corpus(SCOPE_POLICIES, seed=SCOPE_SEED)
    bodies = corpus.sar_bodies(300, seed=4) + _sar_bodies(8, 60)
    seen, out = set(), []
    for b in bodies:
        k = tcache.fingerprint_body("authorize", b)
        if k not in seen:
            seen.add(k)
            out.append(b)
    return out


def _answers(authz, attrs_fn, bodies):
    return authz.authorize_batch([attrs_fn(json.loads(b)) for b in bodies])


class _ScopedSide:
    """One package's incremental engine, authorizer and stamps."""

    def __init__(self, port: bool, buckets: int):
        self.port = port
        self.cache: dict = {}
        if port:
            self.engine = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=buckets)
        else:
            self.engine = TPUPolicyEngine(incremental=True, shard_buckets=buckets)

    def load(self, files):
        if self.port:
            tiers = _tiers(parse_policies, PolicySet, files, self.cache)
            self.engine.load(tiers)
            stores = TieredPolicyStores([MemoryStore("scope", tiers[0])])
            self.authz = CedarWebhookAuthorizer(stores, evaluate_batch=self.engine.evaluate_batch)
        else:
            tiers = _tiers(j_parse, JPolicySet, files, self.cache)
            self.engine.load(tiers, warm="off")
            stores = JTieredPolicyStores([JMemoryStore("scope", tiers[0])])
            self.authz = j_auth.CedarWebhookAuthorizer(
                stores, evaluate=self.engine.evaluate, evaluate_batch=self.engine.evaluate_batch)

    def answers(self, bodies):
        fn = get_authorizer_attributes if self.port else j_attributes
        return _answers(self.authz, fn, bodies)

    def stamps(self, bodies, answers):
        gen = self.engine.plane_generation()
        out = []
        for body, (_decision, reason) in zip(bodies, answers):
            if self.port:
                verb = get_authorizer_attributes(json.loads(body)).verb
                out.append(gen.scoped(reason, action=f'k8s::Action::"{verb}"'))
            else:
                out.append(gen.scoped(reason))
        return out

    def survivors(self, stamps) -> list:
        gen = self.engine.plane_generation()
        return [s == gen for s in stamps]


@pytest.fixture(scope="module")
def scope_bodies():
    return _scope_bodies()


@pytest.mark.parametrize("buckets", [16, 64])
@pytest.mark.parametrize("edit", ["delete-first", "delete-last", "add-forbid",
                                  "add-forbid+delete-last"])
def test_scoped_survivors_after_one_file_edit(scope_bodies, edit, buckets):
    """Entries cached before a one-file incremental edit, checked after
    it on both sides. Every survivor of the port answers as the edited
    set does, every entry a dirty shard decided dies, and so does every
    entry whose reason names no policy. An edit that only deletes or
    moves policies leaves the JAX survivors exactly; an edit that adds a
    policy also kills the port's entries the added policy's actions could
    change, which the JAX stamp keeps, stale ones among them. Two edits
    in a row are checked against both steps."""
    base = _scope_files()
    versions = []
    for kind in edit.split("+"):
        versions.append(_edit(versions[-1] if versions else base, kind))
    sides = {name: _ScopedSide(name == "port", buckets) for name in ("port", "jax")}
    old, stamps = {}, {}
    for name, side in sides.items():
        side.load(base)
        old[name] = side.answers(scope_bodies)
        stamps[name] = side.stamps(scope_bodies, old[name])
    assert old["port"] == old["jax"]
    for version in versions:
        for side in sides.values():
            side.load(version)
    new = sides["port"].answers(scope_bodies)
    assert new == sides["jax"].answers(scope_bodies)
    alive = {name: side.survivors(stamps[name]) for name, side in sides.items()}
    pl = sides["port"].engine.compiled_set.plane
    assert pl.scope == "incremental" and pl.dirty
    # every shard dirtied by any of the edits
    dirty = {sid for sid, hist in pl.shard_added.items() if hist}
    stale_jax = 0
    for i, ((_, reason), now) in enumerate(zip(old["port"], new)):
        pols = tcache.generation._determining_policies(reason)
        in_dirty = any(pl.policy_shard.get(p) in dirty for p in pols) or any(
            p not in pl.policy_shard for p in pols)
        if alive["port"][i]:
            assert now == old["port"][i], scope_bodies[i]
            assert pols and not in_dirty
        if alive["jax"][i] and now != old["jax"][i]:
            stale_jax += 1
        if not pols or in_dirty:
            assert not alive["jax"][i]
    assert any(alive["port"]) and not all(alive["port"])
    if "add-forbid" in edit:
        assert all(a <= b for a, b in zip(alive["port"], alive["jax"]))
        assert stale_jax > 0  # the reference's stamp serves stale answers here
        # what only the port kills: list requests, the added forbid's action
        killed = [i for i, (a, b) in enumerate(zip(alive["port"], alive["jax"])) if b and not a]
        assert killed and all(
            get_authorizer_attributes(json.loads(scope_bodies[i])).verb == "list" for i in killed)
    else:
        assert alive["port"] == alive["jax"] and stale_jax == 0


@pytest.mark.parametrize("how", ["rebuild", "full-compile", "tier-added"])
def test_structural_change_kills_every_entry(scope_bodies, how):
    """A device rebuild (a fresh structural id), a full compile and a
    change of the tier count kill every scoped and full stamp, on both
    sides."""
    files = _scope_files()
    sides = {name: _ScopedSide(name == "port", 8) for name in ("port", "jax")}
    for name, side in sides.items():
        side.load(files)
        stamps = side.stamps(scope_bodies, side.answers(scope_bodies))
        assert any(isinstance(s, (tcache.ShardScopedStamp, jcache.ShardScopedStamp))
                   for s in stamps)
        assert all(side.survivors(stamps))
        if how == "rebuild":
            if side.port:
                assert side.engine.rebuild_compiled() is not None
            else:
                assert side.engine.rebuild_compiled()
        elif how == "full-compile":
            side.engine.incremental = False
            if side.port:
                side.engine.load(_tiers(parse_policies, PolicySet, files, side.cache))
            else:
                side.engine._shard_compiler = None
                side.engine.load(_tiers(j_parse, JPolicySet, files, side.cache), warm="off")
        else:
            guard = {"guard.cedar": LIST_FORBID + "\n"}
            if side.port:
                tiers = _tiers(parse_policies, PolicySet, guard, {}) + \
                    _tiers(parse_policies, PolicySet, files, side.cache)
                side.engine.load(tiers)
            else:
                tiers = _tiers(j_parse, JPolicySet, guard, {}) + \
                    _tiers(j_parse, JPolicySet, files, side.cache)
                side.engine.load(tiers, warm="off")
        assert not any(side.survivors(stamps)), (name, how)


def test_plane_composite_and_wire_state_equal_jax():
    """Before a load the composite is the stores' generations with the
    engine's ("unloaded", 0) on both sides; once loaded, a
    PlaneGenerations whose shard generations equal the JAX engine's; the
    content-derived wire token is the JAX token."""
    files = _scope_files()
    tt = _tiers(parse_policies, PolicySet, files, {})
    jt = _tiers(j_parse, JPolicySet, files, {})
    t_stores = TieredPolicyStores([MemoryStore("w", tt[0])])
    j_stores = JTieredPolicyStores([JMemoryStore("w", jt[0])])
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=8)
    je = TPUPolicyEngine(incremental=True, shard_buckets=8)
    assert plane_composite(t_stores, te)[1] == j_plane_composite(j_stores, je)[1] == \
        ("unloaded", 0)
    assert plane_wire_state(te) is None and j_plane_wire_state(je) is None
    te.load(tt)
    je.load(jt, warm="off")
    tg, jg = plane_composite(t_stores, te), j_plane_composite(j_stores, je)
    assert isinstance(tg, tcache.PlaneGenerations) and isinstance(jg, jcache.PlaneGenerations)
    assert dict(tg.shards) == dict(jg.shards) and dict(tg.lookup) == dict(jg.lookup)
    assert tg == plane_composite(t_stores, te) and tg != ("plane", 1)
    assert plane_wire_state(te) == j_plane_wire_state(je)
    assert tcache.PlaneGenerations(("plane", 9), {}).scoped('{"reasons":[{"policy":"x"}]}') \
        is not None


# ------------------------------------------------------------------ servers


def _policy_dir(tmp_path) -> pathlib.Path:
    d = tmp_path / "policies"
    d.mkdir()
    (d / "synth.cedar").write_text(synth_source(48, seed=7))
    (d / "gated.cedar").write_text(chip_smoke.FALLBACK_POLICY + chip_smoke.NATIVE_OPAQUE_POLICY)
    (d / "demo.cedar").write_text(
        'permit (principal is k8s::User, action == k8s::Action::"get", '
        'resource is k8s::Resource) when { principal.name == "sam" && '
        'resource.resource == "pods" };\n'
        'forbid (principal, action, resource is k8s::Resource) when '
        '{ resource.resource == "nodes" };\n')
    return d


def _port(policy_dir, *flags):
    cfg = policy_dir.parent / "store-config.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(policy_dir)}}]}}))
    args = make_parser().parse_args([
        "--config", str(cfg), "--device", "cpu", "--insecure", "--secure-port", "0",
        "--metrics-port", "0", "--request-timeout-ms", "60000", *flags])
    srv = build_server(args)
    srv.start()
    return srv


def _jax(policy_dir, fast=True, depth=2, **kw):
    """The JAX server as its CLI wires a compiled backend's cache."""
    stores = JTieredPolicyStores([JDirectoryPolicyStore(str(policy_dir), start_ticker=False)])
    fastpath = None
    if fast:
        engine = TPUPolicyEngine()
        engine.load([s.policy_set() for s in stores], warm="off")
        authz = j_auth.CedarWebhookAuthorizer(
            stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
        fastpath = JSARFastPath(engine, authz)
        gen_fn = lambda: j_plane_composite(stores, engine)  # noqa: E731
    else:
        authz = j_auth.CedarWebhookAuthorizer(stores)
        gen_fn = stores.cache_generation
    cache = jcache.DecisionCache(generation_fn=gen_fn, path="authorization")
    srv = JWebhookServer(authz, None, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=fastpath, pipeline_depth=depth, request_timeout_s=60.0,
                         decision_cache=cache, **kw)
    srv.start()
    return srv


def _post(port, body, path="/v1/authorize"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _stream(seed: int, n: int) -> list:
    """A repeating stream: 40 distinct requests (synth, gated, demo and
    generated ones, some in two wire renderings), drawn n times."""
    from cedar_tpu_torch.corpus.synth import synth_corpus

    rng = np.random.default_rng(seed)
    pool = synth_corpus(48, seed=7).sar_bodies(16, seed=11) + _sar_bodies(seed, 16)
    pool += [chip_smoke.gated_bodies(synth_corpus(48, seed=7), 16, seed=2)[i] for i in (0, 8)]
    pool += [_dump(rng, json.loads(b)) for b in pool[:6]]
    return [pool[int(i)] for i in rng.integers(0, len(pool), n)]


SERVER_MODES = {
    "pipelined": ((), dict()),
    "serial": (("--pipeline-depth", "0"), dict(depth=0)),
    "interpreter": (("--backend", "interpreter"), dict(fast=False)),
}


@pytest.mark.parametrize("mode", sorted(SERVER_MODES))
def test_server_stream_equals_jax(tmp_path, mode):
    """One seeded repeating stream through both servers, one request at a
    time: the same answers, and the same hits, misses, size and metric
    counts of the authorization cache (the port's default
    --decision-cache-size, the JAX server given a DecisionCache)."""
    d = _policy_dir(tmp_path)
    flags, jkw = SERVER_MODES[mode]
    t, j = _port(d, *flags), _jax(d, **jkw)
    try:
        assert t.decision_cache is not None and t.decision_cache.max_entries == 65536
        t_before, j_before = t.decision_cache.stats(), j.decision_cache.stats()
        assert t_before["hits"] == j_before["hits"] == 0
        for body in _stream(3, 240):
            assert _post(t.bound_port, body) == _post(j.bound_port, body)
        ts, js = t.decision_cache.stats(), j.decision_cache.stats()
        for k in ("hits", "misses", "size", "evictions", "hit_ratio", "ttl_seconds",
                  "max_entries", "shards", "path"):
            assert ts[k] == js[k], k
        assert ts["hits"] > ts["misses"] > 0
    finally:
        t.stop()
        j.stop()


def _hold_uncached(server, gate: threading.Event, calls: list):
    """Hold every uncached evaluation of the server until `gate` is set."""
    real = server._authorize_uncached

    def held(*a, **kw):
        calls.append(kw.get("coalesce_key"))
        gate.wait(30)
        return real(*a, **kw)

    server._authorize_uncached = held


def test_concurrent_misses_coalesce_as_jax(tmp_path):
    """Eight concurrent identical misses: one evaluation with the key as
    its coalesce_key, seven followers counted coalesced, eight equal
    answers, one entry; the same on the JAX server."""
    d = _policy_dir(tmp_path)
    t, j = _port(d), _jax(d)
    body = _stream(4, 1)[0]
    try:
        out = {}
        for name, srv, counter in (
            ("port", t, t_metrics.process_metrics().decision_cache_coalesced_total),
            ("jax", j, j_metrics.decision_cache_coalesced_total),
        ):
            gate, calls = threading.Event(), []
            _hold_uncached(srv, gate, calls)
            c0 = _series(counter, path="authorization")
            answers = []
            threads = [threading.Thread(target=lambda: answers.append(
                _post(srv.bound_port, body))) for _ in range(8)]
            for th in threads:
                th.start()
            deadline = time.monotonic() + 30
            while _series(counter, path="authorization") - c0 < 7:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            gate.set()
            for th in threads:
                th.join(30)
            out[name] = (answers, len(calls), _series(counter, path="authorization") - c0,
                         srv.decision_cache.size())
            assert calls == [tcache.fingerprint_body("authorize", body)]
        assert out["port"] == out["jax"]
        answers, n_calls, coalesced, size = out["port"]
        assert len(answers) == 8 and len({json.dumps(a) for a in answers}) == 1
        assert (n_calls, coalesced, size) == (1, 7, 1)
    finally:
        t.stop()
        j.stop()


def test_follower_deadline_leader_warms_the_cache(tmp_path):
    """A follower whose budget runs out answers NoOpinion with the
    deadline error (counted in deadline_exceeded); the leader runs on and
    its answer is cached."""
    d = _policy_dir(tmp_path)
    # the interpreter backend: the held leader has no batcher deadline of
    # its own, as in the JAX package's test of this
    t = _port(d, "--request-timeout-ms", "300", "--backend", "interpreter")
    body = _stream(5, 1)[0]
    try:
        gate, calls = threading.Event(), []
        _hold_uncached(t, gate, calls)
        lead = []
        th = threading.Thread(target=lambda: lead.append(_post(t.bound_port, body)))
        th.start()
        while not calls:
            time.sleep(0.005)
        _, follower = _post(t.bound_port, body)
        assert "deadline exceeded waiting for coalesced result" in \
            follower["status"]["evaluationError"]
        assert t.metrics.deadline_exceeded_total.value(path="authorization") == 1
        gate.set()
        th.join(30)
        assert "evaluationError" not in lead[0][1]["status"]
        assert t.decision_cache.size() == 1
        assert _post(t.bound_port, body) == lead[0]
    finally:
        t.stop()


def test_breaker_open_hit_answers_and_miss_gets_the_posture(tmp_path):
    """With the authorization breaker open a cached request answers from
    the cache, as the JAX server's does; an uncached one answers the
    posture before the batcher and is not cached, so it gets the posture
    again. Once the breaker closes the miss is evaluated and cached."""
    d = _policy_dir(tmp_path)
    t, j = _port(d), _jax(d)
    warm, cold = _stream(6, 1)[0], _sar_bodies(61, 1)[0]
    try:
        want = _post(j.bound_port, warm)
        assert _post(t.bound_port, warm) == want
        breaker = t.fastpath.breaker
        breaker.force_open()
        assert breaker.state == "open"
        j.fastpath.breaker = type("Open", (), {"allow": lambda self: False,
                                               "record_failure": lambda self: None})()
        batches = t.debug_engine()["authorization"]["pipeline"]["batches_total"]
        for _ in range(3):
            assert _post(t.bound_port, warm) == _post(j.bound_port, warm) == want
        size = t.decision_cache.size()
        for _ in range(2):
            _, doc = _post(t.bound_port, cold)
            assert doc["status"]["evaluationError"] == "evaluation error: device breaker open"
        assert t.decision_cache.size() == size
        assert t.debug_engine()["authorization"]["pipeline"]["batches_total"] == batches
        breaker.half_open_now()  # the next request is a probe
        _, doc = _post(t.bound_port, cold)
        assert "evaluationError" not in doc["status"]
        assert t.decision_cache.size() == size + 1
    finally:
        t.stop()
        j.stop()


@pytest.mark.parametrize("seam", ["cache.get", "cache.put"])
def test_raising_cache_is_a_miss_on_the_device_path(tmp_path, seam):
    """A cache whose lookup (or insert) raises: every answer is the one
    the JAX server gives under the same fault, each request is evaluated
    through the batcher (never the interpreter), and nothing is cached
    while the insert raises."""
    d = _policy_dir(tmp_path)
    t, j = _port(d), _jax(d)
    bodies = _stream(7, 6)
    scenario = {"seed": 0, "faults": [{"seam": seam, "kind": "error", "count": 6}]}
    authorize_calls = []
    real = t.authorizer.authorize
    t.authorizer.authorize = lambda *a, **kw: (authorize_calls.append(1), real(*a, **kw))[1]
    try:
        for reg in (t_chaos(), j_chaos()):
            reg.configure(scenario)
            reg.arm()
        b0 = t.debug_engine()["authorization"]["pipeline"]["batches_total"]
        for body in bodies:
            assert _post(t.bound_port, body) == _post(j.bound_port, body)
        assert t.debug_engine()["authorization"]["pipeline"]["batches_total"] - b0 == len(bodies)
        assert authorize_calls == []
        ts, js = t.decision_cache.stats(), j.decision_cache.stats()
        assert (ts["hits"], ts["misses"], ts["size"]) == (js["hits"], js["misses"], js["size"])
        if seam == "cache.put":
            assert ts["size"] == 0 and ts["misses"] == len(bodies)
        else:
            assert ts["hits"] == ts["misses"] == 0
    finally:
        for reg in (t_chaos(), j_chaos()):
            reg.reset()
        t.stop()
        j.stop()


def test_decode_errors_and_unready_answers_are_never_cached(tmp_path):
    d = _policy_dir(tmp_path)
    t = _port(d)
    try:
        _, doc = _post(t.bound_port, b"{not json")
        assert doc["status"]["reason"] == "Encountered decoding error"
        assert t.decision_cache.size() == 0
        t.authorizer._stores_loaded = False
        store = t.authorizer.stores.stores[0]
        real = store.initial_policy_load_complete
        store.initial_policy_load_complete = lambda: False
        _post(t.bound_port, _stream(8, 1)[0])
        assert t.decision_cache.size() == 0 and t.decision_cache.stats()["misses"] == 0
        store.initial_policy_load_complete = real
    finally:
        t.stop()


def test_debug_cache_equals_jax(tmp_path):
    """/debug/cache on the metrics port: each path's stats() as the JAX
    server serves them (its generation's repr aside), and the admission
    cache beside the authorization one with --decision-cache-admission."""
    d = _policy_dir(tmp_path)
    t, j = _port(d), _jax(d)
    t_off = _port(d, "--decision-cache-size", "0")
    try:
        for body in _stream(9, 30):
            _post(t.bound_port, body)
            _post(j.bound_port, body)
        td, jd = _get(t.bound_metrics_port, "/debug/cache"), _get(j.bound_metrics_port,
                                                                  "/debug/cache")
        assert set(td) == set(jd) == {"authorization"}
        assert td["authorization"]["generation"].startswith("PlaneGenerations(")
        for doc in (td, jd):
            doc["authorization"].pop("generation")
        assert td == jd
        assert _get(t_off.bound_metrics_port, "/debug/cache") == {}
        text = _get_text(t.bound_metrics_port)
        for fam in ("cedar_decision_cache_hits_total", "cedar_decision_cache_misses_total",
                    "cedar_decision_cache_size", "cedar_decision_cache_hit_ratio",
                    "cedar_decision_cache_coalesced_total",
                    "cedar_decision_cache_evictions_total"):
            assert f"# TYPE {fam} " in text
    finally:
        t.stop()
        j.stop()
        t_off.stop()


def _get_text(port) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        return r.read().decode()


def test_metric_families_equal_jax():
    """The cache families' names, types, labels and help are the JAX
    package's."""
    t = t_metrics.process_metrics()
    for name in ("hits_total", "misses_total", "evictions_total", "coalesced_total", "size",
                 "hit_ratio"):
        tf, jf = getattr(t, f"decision_cache_{name}"), getattr(j_metrics, f"decision_cache_{name}")
        assert (tf.name, tf.help, tf.label_names, type(tf).__name__) == \
            (jf.name, jf.help, jf.label_names, type(jf).__name__)


# ---------------------------------------------------------------- admission

ADM_FORBID = ('forbid (principal, action == k8s::admission::Action::"connect", resource) '
              'when { resource.metadata.name == "blocked" };')


def _review(op: str, uid: str, name: str = "pod-a", dry_run: bool = False) -> dict:
    req = {
        "uid": uid, "operation": op,
        "userInfo": {"username": "bob", "groups": ["tenants"]},
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "resource": {"group": "", "version": "v1", "resource": "pods"},
        "namespace": "default", "name": name,
        "object": {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": name, "namespace": "default"}},
    }
    if op in ("UPDATE", "DELETE"):
        req["oldObject"] = req["object"]
    if dry_run:
        req["dryRun"] = True
    return {"request": req}


def _adm_handler(port: bool, cache):
    adm, store, stores, ps = ((t_adm, MemoryStore, TieredPolicyStores, PolicySet) if port
                              else (j_adm, JMemoryStore, JTieredPolicyStores, JPolicySet))
    tiered = stores([store("adm", ps.from_source(ADM_FORBID, "adm")),
                     adm.allow_all_admission_policy_store()])
    calls = []

    def counting(entities, req):
        calls.append(1)
        return tiered.is_authorized(entities, req)

    return adm.CedarAdmissionHandler(tiered, evaluate=counting, cache=cache), calls


ADM_CASES = {
    "connect": ("CONNECT", False, True), "connect-blocked": ("CONNECT", False, True),
    "dry-run-create": ("CREATE", True, True), "create": ("CREATE", False, False),
    "update": ("UPDATE", False, False), "delete": ("DELETE", False, False),
}


@pytest.mark.parametrize("case", sorted(ADM_CASES))
def test_admission_cache_equals_jax(case):
    """Three reviews of one request with fresh uids: CONNECT and dry-run
    reviews are evaluated once and answered from the cache with their own
    uid, mutating reviews are evaluated every time; the same on both."""
    op, dry, cacheable = ADM_CASES[case]
    name = "blocked" if case == "connect-blocked" else "pod-a"
    out = {}
    for side, (req_cls, mod) in (("port", (AdmissionRequest, t_adm)),
                                 ("jax", (JAdmissionRequest, j_adm))):
        cache = (tcache if side == "port" else jcache).DecisionCache(path=f"adm-{case}")
        handler, calls = _adm_handler(side == "port", cache)
        resps = []
        for k in range(3):
            req = req_cls.from_admission_review(_review(op, f"uid-{k}", name, dry))
            assert mod.cacheable_admission_request(req) is cacheable
            resps.append(handler.handle(req).to_admission_review())
        out[side] = (resps, len(calls), cache.size(), cache.stats()["hits"])
    assert out["port"] == out["jax"]
    resps, n_calls, size, hits = out["port"]
    assert [r["response"]["uid"] for r in resps] == ["uid-0", "uid-1", "uid-2"]
    assert (n_calls, size, hits) == ((1, 1, 2) if cacheable else (3, 0, 0))
    if case == "connect-blocked":
        assert not resps[2]["response"]["allowed"]


def test_admission_error_verdicts_are_never_cached():
    """A verdict with evaluation errors and an evaluation that raises are
    transient: evaluated again every time, on both sides."""
    from cedar_tpu.lang.authorize import DENY as JDENY
    from cedar_tpu.lang.authorize import Diagnostics as JDiagnostics
    from cedar_tpu_torch.lang.authorize import DENY, Diagnostics

    for side in ("port", "jax"):
        mod = t_adm if side == "port" else j_adm
        c = (tcache if side == "port" else jcache).DecisionCache(path="adm-errors")
        stores = (TieredPolicyStores if side == "port" else JTieredPolicyStores)(
            [mod.allow_all_admission_policy_store()])
        deny, diag = (DENY, Diagnostics) if side == "port" else (JDENY, JDiagnostics)
        calls = []

        def erroring(entities, req, calls=calls, deny=deny, diag=diag):
            calls.append(1)
            return deny, diag(errors=["store x: boom"])

        handler = mod.CedarAdmissionHandler(stores, evaluate=erroring, cache=c)
        req_cls = AdmissionRequest if side == "port" else JAdmissionRequest
        for k in range(3):
            r = handler.handle(req_cls.from_admission_review(_review("CONNECT", f"u{k}")))
            assert not r.allowed
        assert len(calls) == 3 and c.size() == 0


def test_server_admission_cache_on_the_python_path(tmp_path):
    """--no-native --decision-cache-admission: /v1/admit's Python handler
    answers a repeated CONNECT review from its cache (one engine call),
    with the review's own uid; /debug/cache shows both paths."""
    d = _policy_dir(tmp_path)
    t = _port(d, "--no-native", "--decision-cache-admission")
    try:
        assert t.admission_handler.cache is not None
        answers = [_post(t.bound_port, json.dumps(_review("CONNECT", f"u{k}")).encode(),
                         "/v1/admit")[1]["response"] for k in range(3)]
        assert [a["uid"] for a in answers] == ["u0", "u1", "u2"]
        assert all(a["allowed"] for a in answers)
        doc = _get(t.bound_metrics_port, "/debug/cache")
        assert set(doc) == {"authorization", "admission"}
        assert (doc["admission"]["hits"], doc["admission"]["misses"]) == (2, 1)
    finally:
        t.stop()


def test_authorizer_cache_seam_equals_jax():
    """The authorizer's own cache (library embedders): a repeat is a hit,
    use_cache=False bypasses it, short-circuits are not cached."""
    src = ('permit (principal is k8s::User, action == k8s::Action::"get", resource is '
           'k8s::Resource) when { principal.name == "sam" };')
    bodies = _sar_bodies(12, 30) + [_sar_bodies(12, 1)[0]] * 3
    out = {}
    for side in ("port", "jax"):
        if side == "port":
            authz = CedarWebhookAuthorizer(
                TieredPolicyStores([MemoryStore.from_source("a", src)]),
                cache=tcache.DecisionCache(path="authz-seam"))
            attrs = get_authorizer_attributes
        else:
            authz = j_auth.CedarWebhookAuthorizer(
                JTieredPolicyStores([JMemoryStore.from_source("a", src)]),
                cache=jcache.DecisionCache(path="authz-seam"))
            attrs = j_attributes
        answers = [authz.authorize(attrs(json.loads(b))) for b in bodies]
        answers += [authz.authorize(attrs(json.loads(bodies[0])), use_cache=False)]
        out[side] = (answers, authz.cache.stats()["hits"], authz.cache.size())
    assert out["port"] == out["jax"]
