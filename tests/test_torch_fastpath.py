"""The port's native SAR fast path (cedar_tpu_torch/engine/fastpath.py) on
the CPU, against the JAX package and the port's interpreter, exactly.

SARFastPath.authorize_raw over TorchPolicyEngine(device="cpu") must give,
body for body, the (decision, reason set, error) of

  * the JAX package's exact Python path: cedar_tpu's
    CedarWebhookAuthorizer over TPUPolicyEngine.evaluate, the SAR parsed by
    cedar_tpu.server.http.get_authorizer_attributes (through the JAX fast
    path's per-body Python entry, which builds no native library), and
  * the port's interpreter (CedarWebhookAuthorizer over the tiered stores),

over the policy texts of the JAX package's server fast-path tests and
body families that reach every route: clean rows, multi-match and error
rows (flagged), gated rows (interpreter-fallback and native-opaque
scopes), principal/resource joins, malformed bodies, and the authorizer's
self-allow and system-skip gates. Then the pipeline's pieces: the chunk
plan, multi-chunk batches at CPU sizes, the in-launch bitset compaction,
the staging pool's buffer lifetime, and the failures that must raise.
"""

import json
import random

import numpy as np
import pytest
import torch

from cedar_tpu.engine import fastpath as jfastpath
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.ops import match as jmatch
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.stores import store as j_store
from cedar_tpu_torch import native as tnative
from cedar_tpu_torch.compiler.lower import AUTHZ_SCHEMA_INFO as T_SCHEMA
from cedar_tpu_torch.compiler.lower import lower_tiers as t_lower
from cedar_tpu_torch.compiler.pack import pack as t_pack
from cedar_tpu_torch.corpus import synth as t_synth
from cedar_tpu_torch.engine import fastpath as tfastpath
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine, _WordPacker
from cedar_tpu_torch.lang import PolicySet as TPolicySet
from cedar_tpu_torch.native import build as tbuild
from cedar_tpu_torch.ops import cuda_match
from cedar_tpu_torch.ops import match as tmatch
from cedar_tpu_torch.server import authorizer as t_auth
from cedar_tpu_torch.stores import store as t_store

import jax.numpy as jnp

# the policy texts of the JAX package's server fast-path tests
SRV_POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
forbid (principal, action, resource is k8s::Resource)
  when { resource.resource == "nodes" };
forbid (principal is k8s::User,
        action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when { resource.metadata has labels &&
         resource.metadata.labels.contains({key: "env", value: "prod"}) };
"""
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
JOIN_POLICY = """
permit (principal is k8s::ServiceAccount, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.namespace == resource.namespace };
"""
RESOURCE_JOIN_POLICY = """
permit (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && resource has namespace &&
         resource.name == resource.namespace };
"""
NATIVE_OPAQUE_POLICY = """
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""
# added to every set: a second permit on (get, pods) makes "sam get pods"
# a multi-match row, and a forbid that errors on name-less watch requests
# sits beside that permit's match (the err bit)
MULTI_ERR_POLICIES = """
permit (principal, action in [k8s::Action::"get", k8s::Action::"watch"],
        resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal, action == k8s::Action::"watch", resource is k8s::Resource)
  when { resource.name == "locked" };
"""
SETS = {
    name: SRV_POLICIES + MULTI_ERR_POLICIES + text
    for name, text in (
        ("srv", ""),
        ("fallback", FALLBACK_POLICY),
        ("join", JOIN_POLICY),
        ("resource_join", RESOURCE_JOIN_POLICY),
        ("native_opaque", NATIVE_OPAQUE_POLICY),
        ("all", FALLBACK_POLICY + JOIN_POLICY + RESOURCE_JOIN_POLICY + NATIVE_OPAQUE_POLICY),
    )
}


def sar(user="sam", groups=(), verb="get", resource="pods", name="", namespace="",
        group="", nonresource=None):
    spec = {"user": user, "uid": "u", "groups": list(groups)}
    if nonresource is not None:
        spec["nonResourceAttributes"] = {"path": nonresource, "verb": verb}
    else:
        ra = {"verb": verb, "resource": resource, "version": "v1", "group": group}
        if name:
            ra["name"] = name
        if namespace:
            ra["namespace"] = namespace
        spec["resourceAttributes"] = ra
    return json.dumps({"apiVersion": "authorization.k8s.io/v1",
                       "kind": "SubjectAccessReview", "spec": spec}).encode()


def family_bodies(family: str, seed: int = 0) -> list:
    rng = random.Random(f"{family}:{seed}")
    if family == "clean":
        return [
            sar(user=rng.choice(["sam", "alice", "bob"]),
                groups=rng.choice([(), ("devs",), ("joiners",)]),
                verb=rng.choice(["get", "list", "create", "delete"]),
                resource=rng.choice(["pods", "nodes", "secrets", "configmaps"]),
                namespace=rng.choice(["", "default", "kube-system"]),
                name=rng.choice(["", "app-1"]))
            for _ in range(40)
        ] + [sar(verb="get", nonresource=p) for p in ("/healthz", "/metrics")]
    if family == "multi":
        return [sar(user="sam", namespace=ns) for ns in ("", "default", "a", "b")] + [
            sar(user=u, verb="watch", resource="pods", namespace=ns)
            for u in ("sam", "alice") for ns in ("default", "b")
        ] + [sar(user="alice", verb="watch", resource="pods", name="locked")]
    if family == "gated":
        return [
            sar(user="jo", groups=("joiners",), resource=r, name=n)
            for r in ("widgets", "pods") for n in ("", "10.0.0.1", "x")
        ] + [
            sar(user=u, verb="deletecollection", resource="pods", name=n, namespace=ns)
            for u in ("sam", "alice") for n in ("127.0.0.1", "10.0.0.1", "not-an-ip")
            for ns in ("", "default")
        ] + [sar(user="alice", resource="nodes"), sar(user="sam")]
    if family == "join":
        return [
            sar(user=f"system:serviceaccount:{sa_ns}:app", resource="pods", namespace=ns, name=n)
            for sa_ns in ("default", "kube-system") for ns in ("", "default", "kube-system")
            for n in ("", "x")
        ] + [
            sar(user="alice", verb="deletecollection", resource="pods", name=n, namespace=ns)
            for n, ns in (("default", "default"), ("a", "b"), ("", "default"), ("b", ""))
        ]
    if family == "malformed":
        good = sar()
        return [
            b'{"not": "valid json',
            b"[" * 10_000,
            b"",
            b"[]",
            b'{"spec": 5}',
            b'{"spec": {"user": 5, "resourceAttributes": {"verb": "get"}}}',
            good.replace(b'"user"', b'"us\x8fer"', 1),
            good.replace(b"sam", b"s\xed\xa0\x80m", 1),
            good,
        ]
    if family == "gates":
        me = "system:authorizer:cedar-authorizer"
        return [
            sar(user=me, verb=v, group="cedar.k8s.aws", resource="policies") for v in ("get", "list")
        ] + [
            sar(user=me, verb=v, group="rbac.authorization.k8s.io", resource="roles")
            for v in ("watch", "delete")
        ] + [
            sar(user=u, resource="nodes")
            for u in ("system:kube-scheduler", "system:apiserver", "system:node:n1",
                      "system:serviceaccount:default:x", me)
        ]
    raise ValueError(family)


FAMILIES = ["clean", "multi", "gated", "join", "malformed", "gates"]


class Paths:
    """One policy set loaded into every path under comparison."""

    def __init__(self, src: str):
        tiers = [TPolicySet.from_source(src, "fp")]
        self.engine = TorchPolicyEngine(device="cpu")
        self.engine.load(tiers)
        stores = t_store.TieredPolicyStores([t_store.MemoryStore("fp", tiers[0])])
        authz = t_auth.CedarWebhookAuthorizer(stores, evaluate_batch=self.engine.evaluate_batch)
        self.fast = tfastpath.SARFastPath(self.engine, authz)
        # the port's interpreter, behind the same per-body JSON handling
        self.interp = tfastpath.SARFastPath(
            self.engine, t_auth.CedarWebhookAuthorizer(stores))._python_fallback
        j_engine = TPUPolicyEngine()
        j_engine.load([JPolicySet.from_source(src, "fp")], warm="off")
        j_stores = j_store.TieredPolicyStores([j_store.MemoryStore.from_source("fp", src)])
        self.jax_exact = jfastpath.SARFastPath(
            j_engine, j_auth.CedarWebhookAuthorizer(j_stores, evaluate=j_engine.evaluate)
        )._python_fallback


_PATHS: dict = {}


def paths(name: str) -> Paths:
    if name not in _PATHS:
        _PATHS[name] = Paths(SETS[name])
    return _PATHS[name]


def _reason_doc(reason: str):
    try:
        doc = json.loads(reason)
    except ValueError:
        return reason  # a gate's or decode error's plain-text reason
    return (
        sorted(json.dumps(r, sort_keys=True) for r in doc.get("reasons", [])),
        sorted(doc.get("errors", [])),
    )


def canon(res):
    """(decision, reason set with its errors, evaluation error)."""
    d, r, e = res
    return d, _reason_doc(r) if r else "", e


def canon_reasons(res):
    """(decision, reason set, evaluation error): the interpreter's error
    texts differ from the device plane's ("evaluation error") by design."""
    d, r, e = res
    doc = _reason_doc(r) if r else ""
    return d, doc[0] if isinstance(doc, tuple) else doc, e


def check(p: Paths, bodies, got):
    assert len(got) == len(bodies)
    for b, g in zip(bodies, got):
        assert canon(g) == canon(p.jax_exact(b)), b
        assert canon_reasons(g) == canon_reasons(p.interp(b)), b


# ------------------------------------------------------------------ parity


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("name", sorted(SETS))
def test_fastpath_equals_exact_paths(name, family):
    p = paths(name)
    bodies = family_bodies(family)
    before = dict(p.fast.routing)
    got = p.fast.authorize_raw(bodies)
    check(p, bodies, got)
    moved = {k: p.fast.routing[k] - before[k] for k in before}
    assert sum(moved.values()) == len(bodies)
    if family == "gated" and name in ("fallback", "native_opaque", "all"):
        assert moved["gated"] > 0
    if family == "multi":
        assert moved["flagged"] > 0
    if family == "malformed":
        assert moved["encoder_fallback"] >= 7
    if family == "gates":
        assert moved["encoder_gate"] == 7  # all but the node and the service account


def test_gated_rows_take_want_full(monkeypatch):
    """With interpreter-fallback policies, gated rows re-run through
    engine.evaluate_batch, whose hybrid merge launches the first-match
    kernel (want_full), never the words kernel for those rows."""
    p = paths("fallback")
    calls = []
    real = p.engine.match_arrays_launch

    def spy(*a, **k):
        calls.append(k.get("want_full", False))
        return real(*a, **k)

    monkeypatch.setattr(p.engine, "match_arrays_launch", spy)
    bodies = [sar(user="jo", groups=("joiners",), resource="widgets", name="10.0.0.1")] * 3
    got = p.fast.authorize_raw(bodies)
    check(p, bodies, got)
    assert got[0][0] == "allow"
    assert calls == [False, True]  # the native words launch, then the gated re-run


def test_encoder_fallback_for_extras_overflow(monkeypatch):
    """Rows whose extras overflow the staging width take the per-row
    Python path and still answer exactly."""
    src = SRV_POLICIES + """
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name like "a*" };
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name like "*z" };
"""
    p = Paths(src)
    monkeypatch.setattr(tnative.NativeEncoder, "DEFAULT_EXTRAS_CAP", 1)
    bodies = [sar(user=u) for u in ("abz", "az", "sam", "bz", "ab")]
    got = p.fast.authorize_raw(bodies)
    check(p, bodies, got)
    assert p.fast.routing["encoder_fallback"] >= 2


def test_unready_stores_answer_no_opinion():
    class NeverReady(t_store.MemoryStore):
        def initial_policy_load_complete(self):
            return False

    p = paths("srv")
    stores = t_store.TieredPolicyStores([NeverReady("fp", TPolicySet.from_source(SRV_POLICIES, "fp"))])
    fast = tfastpath.SARFastPath(
        p.engine, t_auth.CedarWebhookAuthorizer(stores, evaluate_batch=p.engine.evaluate_batch))
    me = "system:authorizer:cedar-authorizer"
    got = fast.authorize_raw([sar(), sar(user=me, group="rbac.authorization.k8s.io")])
    assert got[0] == ("no_opinion", "", None)
    assert got[1][0] == "allow"  # the gates still apply


# --------------------------------------------------------------- chunking


@pytest.mark.parametrize("chunk,tail", [(16384, 8192), (8, 4), (5, 3), (4096, 2048)])
def test_chunk_sizes_match_jax(chunk, tail):
    for n in list(range(0, 200)) + list(range(200, 70000, 397)) + [65536, 16384, 24577]:
        assert tfastpath._chunk_sizes(n, chunk, tail) == jfastpath._chunk_sizes(n, chunk, tail)


@pytest.mark.parametrize("chunk,tail,incall", [(8, 4, 4096), (8, 4, 2), (16, 8, 0), (5, 3, 3)])
def test_multi_chunk_batches(monkeypatch, chunk, tail, incall):
    """Several chunks per batch: their words share one packed readback,
    and flagged rows of chunks above the in-launch limit resolve in the
    deferred cross-chunk fetch."""
    p = Paths(SETS["all"])
    monkeypatch.setattr(p.fast, "_CHUNK", chunk)
    monkeypatch.setattr(p.fast, "_TAIL_CHUNK", tail)
    monkeypatch.setattr(p.fast, "_BITS_INCALL_MAX", incall)
    packers = []
    real_init = _WordPacker.__init__

    def spy_init(self):
        real_init(self)
        packers.append(self)

    monkeypatch.setattr(_WordPacker, "__init__", spy_init)
    launches = []
    real_launch = p.engine.match_arrays_launch

    def launch(c, e, **kw):
        launches.append(kw.get("want_bits", False))
        return real_launch(c, e, **kw)

    monkeypatch.setattr(p.engine, "match_arrays_launch", launch)
    bits_calls = []
    real_bits = p.engine.match_bits_arrays_launch
    monkeypatch.setattr(p.engine, "match_bits_arrays_launch",
                        lambda c, e, cs=None: bits_calls.append(len(c)) or real_bits(c, e, cs=cs))
    bodies = sum((family_bodies(f, seed=1) for f in FAMILIES), [])
    random.Random(chunk).shuffle(bodies)
    got = p.fast.authorize_raw(bodies)
    check(p, bodies, got)
    n_chunks = len(tfastpath._chunk_sizes(len(bodies), chunk, tail))
    assert len(launches) >= n_chunks > 2  # the gated re-runs launch too
    # the batch's packer (the first made) carries the words of every
    # chunk launched without the in-launch compaction
    assert packers[0].parts == launches[:n_chunks].count(False)
    if incall < tail // 2:
        assert packers[0].parts == n_chunks
        assert bits_calls  # the deferred fetch ran
    # the same traffic again: flagged feature rows come from the cache
    n_fetch = len(bits_calls)
    check(p, bodies, p.fast.authorize_raw(bodies))
    assert len(bits_calls) == n_fetch


def test_incall_bitmap_spares_the_bits_fetch(monkeypatch):
    """Up to BITS_TOPK flagged rows of a small batch come back with the
    words: no match_bits_arrays call. Past that, the overflow rows fetch
    theirs once (deduplicated by feature row)."""
    p = Paths(SETS["srv"])
    fetched = []
    real = p.engine.match_bits_arrays_launch
    monkeypatch.setattr(p.engine, "match_bits_arrays_launch",
                        lambda c, e, cs=None: fetched.append(len(c)) or real(c, e, cs=cs))
    real_sync = p.engine.match_bits_arrays
    monkeypatch.setattr(p.engine, "match_bits_arrays",
                        lambda c, e, cs=None: fetched.append(len(c)) or real_sync(c, e, cs=cs))
    few = [sar(user="sam", namespace=f"ns{i}") for i in range(100)]  # flagged, distinct rows
    check(p, few, p.fast.authorize_raw(few))
    assert p.fast.routing["flagged"] == 100 and fetched == []
    many = [sar(user="sam", namespace=f"n{i}") for i in range(300)]
    check(p, many, p.fast.authorize_raw(many))
    # the 172 overflow rows share one feature row (the namespace is not
    # encoded here): one row fetched
    assert fetched == [1]


# ----------------------------------------------------------- staging pool


def _pool_ids(engine):
    return {id(a) for bufs in engine._staging._free.values() for a in bufs}


def _track_acquires(monkeypatch, engine):
    acquired = []
    real = engine._staging.acquire

    def acquire(shape, dtype):
        a = real(shape, dtype)
        acquired.append(a)
        return a

    monkeypatch.setattr(engine._staging, "acquire", acquire)
    return acquired


def test_staging_released_only_after_outputs_materialize(monkeypatch):
    p = Paths(SETS["srv"])
    state = {"pending": 0}
    staged = set()
    real_launch = p.engine.match_arrays_launch

    def launch(codes, extras, **kw):
        staged.add(id(codes))
        state["pending"] += 1
        fin = real_launch(codes, extras, **kw)

        def finish():
            out = fin()
            state["pending"] -= 1
            return out

        return finish

    monkeypatch.setattr(p.engine, "match_arrays_launch", launch)
    real_release = p.engine._staging.release

    def release(*arrays):
        if any(id(a) in staged for a in arrays):
            assert state["pending"] == 0, "staging buffer released while a launch was pending"
        real_release(*arrays)

    monkeypatch.setattr(p.engine._staging, "release", release)
    monkeypatch.setattr(p.fast, "_CHUNK", 8)
    monkeypatch.setattr(p.fast, "_TAIL_CHUNK", 4)
    bodies = [sar(user=f"u{i}") for i in range(30)]
    check(p, bodies, p.fast.authorize_raw(bodies))
    assert staged
    assert p.engine.staging_stats()["outstanding"] == 0


def test_staging_released_when_the_encode_raises(monkeypatch):
    p = Paths(SETS["srv"])
    acquired = _track_acquires(monkeypatch, p.engine)
    snap = p.fast._current_snapshot()

    def boom(*a, **k):
        raise RuntimeError("injected encode failure")

    monkeypatch.setattr(snap.encoder, "encode_batch_into", boom)
    with pytest.raises(RuntimeError, match="injected encode failure"):
        p.fast.authorize_raw([sar(user=f"u{i}") for i in range(20)])
    assert acquired and {id(a) for a in acquired} <= _pool_ids(p.engine)
    assert p.engine.staging_stats()["outstanding"] == 0


def test_staging_abandoned_when_the_launch_raises(monkeypatch):
    """An exception after the encode (here: the launch) propagates and
    abandons the held buffers: they never re-enter the pool, where a later
    batch could overwrite rows an in-flight copy still reads."""
    p = Paths(SETS["srv"])
    acquired = _track_acquires(monkeypatch, p.engine)

    def boom(*a, **k):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(p.engine, "match_arrays_launch", boom)
    with pytest.raises(RuntimeError, match="injected launch failure"):
        p.fast.authorize_raw([sar(user=f"u{i}") for i in range(20)])
    assert acquired and not ({id(a) for a in acquired} & _pool_ids(p.engine))


def test_staging_peak_outstanding_and_reuse(monkeypatch):
    """Every chunk holds its two encode buffers until the batch's deferred
    resolve, and its launch holds a third (the extras trimmed to their
    live width) until its finish(); a three-chunk batch acquires all nine
    before the first release. The next batch reuses exactly the buffers
    the first returned."""
    p = Paths(SETS["srv"])
    monkeypatch.setattr(p.fast, "_CHUNK", 8)
    monkeypatch.setattr(p.fast, "_TAIL_CHUNK", 8)
    bodies = [sar(user=f"u{i}") for i in range(24)]
    p.fast.authorize_raw(bodies)
    st = p.engine.staging_stats()
    assert st["outstanding"] == 0 and st["peak_outstanding"] == 9 and st["acquires"] == 9
    assert st["pinned"] is False
    free = _pool_ids(p.engine)
    p.fast.authorize_raw(bodies)
    assert _pool_ids(p.engine) == free


# -------------------------------------------------------------- failures


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No Python fallback for the whole batch: a native encoder that cannot
    be built makes authorize_raw raise."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_pylib", None)
    monkeypatch.setenv("CXX", "false")
    p = Paths(SETS["srv"])
    with pytest.raises(RuntimeError, match="native encoder build"):
        p.fast.authorize_raw([sar()])


def test_device_failure_propagates(monkeypatch):
    p = Paths(SETS["srv"])

    def boom(*a, **k):
        raise RuntimeError("injected kernel failure")

    monkeypatch.setattr(cuda_match, "match_words", boom)
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        p.fast.authorize_raw([sar(), sar(user="alice")])


def test_engine_without_device_requires_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPolicyEngine()


# ------------------------------------------------- compaction and packing


@pytest.mark.parametrize("B,n_valid,p_flag", [(8, None, 0.5), (64, 40, 0.3), (300, 250, 0.7), (1, 1, 1.0)])
def test_compact_flagged_bits_matches_jax(B, n_valid, p_flag):
    rng = np.random.default_rng(B)
    L, R = 96, 200
    lit = (rng.random((B, L)) < 0.1).astype(np.int8)
    W = np.zeros((L, R), np.int8)
    W[rng.integers(0, L, R), np.arange(R)] = 1
    W[rng.integers(0, L, R), np.arange(R)] = -1
    thresh = np.maximum((W > 0).sum(0), 1).astype(np.int32)
    flagged = rng.random(B) < p_flag
    vals, idx, kbits = (
        t.numpy() for t in tmatch.compact_flagged_bits(
            torch.from_numpy(lit), torch.from_numpy(W), torch.from_numpy(thresh),
            torch.from_numpy(flagged), n_valid)
    )
    sat = (lit.astype(np.float32) @ W.astype(np.float32)) >= thresh
    bits_all = tmatch.pack_sat_bits(torch.from_numpy(sat)).numpy()
    jv, ji, jk = (np.asarray(a) for a in jmatch._compact_flagged_bits(
        jnp.asarray(bits_all), jnp.asarray(flagged), n_valid))
    assert vals.shape == jv.shape == (min(B, tmatch.BITS_TOPK),)
    np.testing.assert_array_equal(vals, jv)
    live = vals > 0
    assert live.sum() == min(tmatch.BITS_TOPK, int(flagged[: n_valid or B].sum()))
    np.testing.assert_array_equal(idx[live], ji[live])
    np.testing.assert_array_equal(kbits[live], jk[live])


def test_flagged_rows_rule():
    words = torch.tensor([0, tmatch.WORD_MULTI, tmatch.WORD_ERR, tmatch.WORD_GATE, 1 << 30],
                         dtype=torch.int32)
    assert tmatch.flagged_rows(words, None).tolist() == [False, True, True, False, False]
    M = tmatch.INT32_MAX
    first = torch.tensor([[M, 3, M], [2, 2, M], [1, M, 5]], dtype=torch.int32)
    last = torch.tensor([[-1, 3, -1], [2, 4, -1], [1, -1, 5]], dtype=torch.int32)
    assert tmatch.flagged_rows(None, (first, last)).tolist() == [False, True, False]


@pytest.mark.parametrize("want_full", [False, True])
def test_launch_want_bits_bitmap_equals_bits_arrays(want_full):
    """The in-launch compaction carries exactly the bitsets
    match_bits_arrays computes for the flagged rows."""
    p = paths("all")
    cs = p.engine.compiled_set
    bodies = family_bodies("multi") + family_bodies("clean")
    snap = p.fast._current_snapshot()
    codes, extras, _counts, flags = snap.encoder.encode_batch(bodies)
    ok = flags == tnative.F_OK
    codes, extras = codes[ok], extras[ok]
    words, full, bitmap = p.engine.match_arrays_launch(
        codes, extras, cs=cs, want_full=want_full, want_bits=True)()
    if want_full:
        f, l = full
        flagged = np.nonzero(((f != l) & (f != tmatch.INT32_MAX)).any(axis=1))[0]
    else:
        flagged = np.nonzero((words & (tmatch.WORD_ERR | tmatch.WORD_MULTI)) != 0)[0]
    assert flagged.size and sorted(bitmap) == flagged.tolist()
    want = p.engine.match_bits_arrays(codes[flagged], extras[flagged], cs=cs)
    for k, i in enumerate(flagged.tolist()):
        np.testing.assert_array_equal(bitmap[i], want[k])


def test_word_packer_single_and_multi_part():
    one = _WordPacker()
    a = torch.tensor([1, -1, 7], dtype=torch.int32)
    one.add(a)
    one.flush()
    assert one.view(0, 2).tolist() == [1, 0xFFFFFFFF]
    many = _WordPacker()
    parts = [torch.arange(k, dtype=torch.int32) + 10 * k for k in (3, 1, 4)]
    ids = [many.add(t) for t in parts]
    for i, t in zip(ids, parts):
        assert many.view(i, t.shape[0]).tolist() == t.tolist()
    with pytest.raises(RuntimeError):
        many.add(a)


def test_chip_smoke_encoder_fallback_counts():
    """chip_smoke.py holds the card's encoder_fallback count of each
    fast-path batch to the count the encoder gives here on the CPU for the
    same seeded corpus and bodies (its defaults: 10000 policies, seed 0)."""
    import chip_smoke

    corpus = t_synth.synth_corpus(10000, seed=0)
    packed = t_pack(t_lower(corpus.tiers(), T_SCHEMA))
    enc = tnative.NativeEncoder.create(packed)
    # the smoke's batches: its --sars 300 bodies (seed + 1), its batch-4096
    # bodies (seed + 2) and the 65536 more (seed + 5)
    for label, n, seed in (("300", 300, 1), ("4096", 4096, 2), ("65536", 65536, 5)):
        _c, _e, _n, flags = enc.encode_batch(corpus.sar_bodies(n, seed=seed))
        n_fallback = int(((flags == tnative.F_PARSE_ERROR) | (flags == tnative.F_EXTRAS_OVERFLOW)).sum())
        assert chip_smoke.EXPECTED_ENCODER_FALLBACK[label] == n_fallback
