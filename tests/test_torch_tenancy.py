"""The port's multi-tenant shared plane (cedar_tpu_torch/tenancy/ and its
serving branches) against the JAX package's cedar_tpu/tenancy, on the CPU,
at tolerance 0.

  * registry: for the same seeded tenant corpora (corpus/synth.py
    synth_tenant_corpora), fused_tiers gives the same policy ids, tenant
    stamps, filenames and guard conditions tier by tier;
    content_fingerprint and stats are equal; a one-policy edit makes
    exactly one fresh clone (every other clone keeps its identity) on
    both sides; remove_tenant, tenant-id validation, add_tenant misuse,
    the wired-tier guard and colliding policy ids behave the same;
  * pack: the fused plane each package's incremental engine compiles is
    equal byte for byte (W, thresh, rule_group, rule_policy, act_rows),
    with the same policy order, tenant_column and shard document (the
    per-tenant rollup ``tenants`` included);
  * resolver: path prefix, header, host map, default, restricted
    sources, conflict, unknown and missing requests give the same
    (tenant, dispatch path, why) and describe() as JAX's TenantResolver;
  * engine: on the CPU (the words kernel's plain version) the port's
    fused engine behind its native SARFastPath answers every tenant's
    traffic (tenant-stamped TenantBody bodies, one tenant carrying an
    interpreter-fallback policy whose gated rows re-run through
    evaluate_batch) as the JAX fused engine does, and as each tenant's
    standalone JAX engine does (decision and reason set); bodies whose
    answers differ per tenant are answered differently; an unknown or
    unstamped tenant matches nothing;
  * server: the port's CLI server and the JAX CLI server with the same
    three --tenant flags and a --tenant-host give the same answers by
    path, header and host, byte-equal refusals (unknown, missing,
    conflict on both endpoints), equal /debug/tenancy documents and
    tenant metric families, the same audit-line tenants, two cache
    entries for one body sent to two tenants, and, after a one-policy
    edit in one tenant's directory, the same dirty shard and
    ``shards.tenants`` rollup on /debug/engine, the same answers after
    it, and the other tenants' cached decisions still hits;
  * CLI: the JAX CLI's errors for --tenant with --enable-recording and
    with each rollout flag, for malformed --tenant / --tenant-host /
    --tenant-sources values and for an invalid tenant id, and the
    tenancy flags' defaults.

The JAX servers here count into the JAX package's process-wide counters
(put back at the end by _jax_counters_restored) and trace JAX planes
(cleared by _jax_jit_caches_cleared).
"""

from __future__ import annotations

import email.message
import http.client
import json
import pathlib
import sys
import time

import pytest

from cedar_tpu import tenancy as jten
from cedar_tpu.cli.webhook import build_server as j_build_server
from cedar_tpu.cli.webhook import make_parser as j_make_parser
from cedar_tpu.compiler.pack import policy_tenant as j_policy_tenant
from cedar_tpu.corpus import synth_tenant_corpora as j_corpora
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.lang.parser import parse_policies as j_parse
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import tenancy as tten
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.compiler.pack import policy_tenant
from cedar_tpu_torch.corpus.synth import _synth_sources, synth_tenant_corpora
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import SARFastPath
from cedar_tpu_torch.engine.weights import packed_arrays
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.lang.parser import parse_policies
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.authorizer import DECISION_NO_OPINION, CedarWebhookAuthorizer
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — the interpreter-fallback policy and gated bodies
from test_torch_cache import _jax_counters_restored  # noqa: E402,F401 — JAX counters put back


@pytest.fixture(autouse=True, scope="module")
def _jax_jit_caches_cleared():
    """The JAX planes traced here stay in JAX's process-wide jit caches,
    and the JAX package's own tests count traces: cleared at the end."""
    yield
    import jax

    jax.clear_caches()


BUCKETS = 16
PACK_ARRAYS = ("W", "thresh", "rule_group", "rule_policy", "act_rows")


def _side(pkg: str):
    """(tenancy module, corpora fn, PolicySet, parse, MemoryStore,
    TieredPolicyStores, policy_tenant) of one package."""
    if pkg == "port":
        return (tten, synth_tenant_corpora, PolicySet, parse_policies, MemoryStore,
                TieredPolicyStores, policy_tenant)
    return (jten, j_corpora, JPolicySet, j_parse, JMemoryStore, JTieredPolicyStores,
            j_policy_tenant)


# ------------------------------------------------------------- registry

# (policies per tenant, tenants, seed)
CORPUS_CASES = [(20, 2, 1), (30, 3, 5), (12, 4, 9), (40, 2, 17)]
CASE_IDS = [f"n{n}-t{t}-s{s}" for n, t, s in CORPUS_CASES]


def _registry(pkg: str, n: int, tenants: int, seed: int, mode: str = "tiers_fn"):
    """(registry, live corpora {tenant: corpus}) over the seeded tenant
    corpora; ``mode`` is how the tenants register (tiers_fn over the live
    dict, static tiers, or stores of one MemoryStore each)."""
    ten, corpora_fn, _ps, _parse, mem, tiered, _pt = _side(pkg)
    live = dict(corpora_fn(n, tenants, seed=seed, clusters=2))
    reg = ten.TenantRegistry()
    for tid, c in live.items():
        if mode == "tiers_fn":
            reg.add_tenant(tid, tiers_fn=(lambda t=tid: live[t].tiers()))
        elif mode == "tiers":
            reg.add_tenant(tid, tiers=c.tiers())
        else:
            reg.add_tenant(tid, stores=tiered([mem(f"{tid}-store", c.tiers()[0])]))
    return reg, live


def _fused_key(pkg: str, tiers) -> list:
    """Per fused tier: (tenant stamp, policy id, filename, guard repr,
    condition count) of each clone, in order."""
    pt = _side(pkg)[6]
    return [[(pt(p), p.policy_id, p.filename, repr(p.conditions[0]), len(p.conditions))
             for p in ps.policies()] for ps in tiers]


@pytest.mark.parametrize("mode", ["tiers_fn", "tiers", "stores"])
@pytest.mark.parametrize("case", CORPUS_CASES, ids=CASE_IDS)
def test_fused_tiers_equal_jax(case, mode):
    """The fused stack: the same clones, stamps and guards, tier by
    tier, in the same order; the originals are left untouched."""
    t_reg, t_live = _registry("port", *case, mode=mode)
    j_reg, _ = _registry("jax", *case, mode=mode)
    t_tiers, j_tiers = t_reg.fused_tiers(), j_reg.fused_tiers()
    assert _fused_key("port", t_tiers) == _fused_key("jax", j_tiers)
    assert t_reg.fused_tiers() is t_tiers  # identity-cached until content changes
    for c in t_live.values():
        for p in c.tiers()[0].policies():
            assert policy_tenant(p) is None and "_cedar_tenant" not in p.__dict__


@pytest.mark.parametrize("mode", ["tiers_fn", "stores"])
@pytest.mark.parametrize("case", CORPUS_CASES, ids=CASE_IDS)
def test_fingerprint_and_stats_equal_jax(case, mode):
    t_reg, _ = _registry("port", *case, mode=mode)
    j_reg, _ = _registry("jax", *case, mode=mode)
    t_reg.fused_tiers()
    j_reg.fused_tiers()
    assert t_reg.content_fingerprint() == j_reg.content_fingerprint()
    assert t_reg.stats() == j_reg.stats()
    assert t_reg.tenants() == j_reg.tenants() and len(t_reg) == len(j_reg)
    assert [tten.TenantRegistry.shard_prefix(t) for t in t_reg.tenants()] == \
        [jten.TenantRegistry.shard_prefix(t) for t in j_reg.tenants()]


@pytest.mark.parametrize("case", CORPUS_CASES, ids=CASE_IDS)
def test_one_policy_edit_makes_one_fresh_clone(case):
    """Editing one policy of one tenant re-clones that policy alone: every
    other clone keeps its object identity (the invariant the shard
    differ keys on), on both sides, and the fingerprints step alike."""
    out = {}
    for pkg in ("port", "jax"):
        reg, live = _registry(pkg, *case)
        before = {id(p): p for ps in reg.fused_tiers() for p in ps.policies()}
        fp0 = reg.content_fingerprint()
        tid = sorted(live)[-1]
        live[tid] = live[tid].with_edit(3)
        after = [p for ps in reg.fused_tiers() for p in ps.policies()]
        fresh = [(_side(pkg)[6](p), p.policy_id) for p in after if id(p) not in before]
        out[pkg] = (fresh, fp0, reg.content_fingerprint(), len(after))
    assert out["port"] == out["jax"]
    fresh, fp0, fp1, _ = out["port"]
    assert len(fresh) == 1 and fp0 != fp1


@pytest.mark.parametrize("case", CORPUS_CASES, ids=CASE_IDS)
def test_remove_tenant_equal_jax(case):
    """Offboarding: the tenant leaves the fused stack at the next fuse,
    the topology steps the fingerprint, a second removal answers False,
    and its cedar_tenant_policies row leaves the exposition."""
    out = {}
    for pkg in ("port", "jax"):
        reg, live = _registry(pkg, *case)
        reg.fused_tiers()
        gone = sorted(live)[0]
        first, second = reg.remove_tenant(gone), reg.remove_tenant(gone)
        tiers = reg.fused_tiers()
        out[pkg] = (first, second, reg.tenants(), _fused_key(pkg, tiers),
                    reg.content_fingerprint(), reg.stats(), gone in reg)
        text = (t_metrics.WebhookMetrics().expose() if pkg == "port"
                else j_metrics.REGISTRY.expose())
        assert f'cedar_tenant_policies{{tenant="{gone}"}}' not in text
    assert out["port"] == out["jax"]
    assert out["port"][:2] == (True, False)


TENANT_IDS = ["alpha", "a", "tenant-00", "t.1", "a_b", "A1", "x" * 64, "",
              "x" * 65, "bad/id", "-lead", "trail-", "has space", "ünï"]


@pytest.mark.parametrize("tid", TENANT_IDS, ids=lambda t: repr(t)[:24])
def test_tenant_id_validation_equal_jax(tid):
    """DNS-label-ish ids only (they are embedded in shard ids, labels and
    cache scopes): the same ids are accepted, the same refused, with the
    same message."""
    res = []
    for pkg in ("port", "jax"):
        ten, _, ps_cls = _side(pkg)[:3]
        try:
            ten.TenantRegistry().add_tenant(tid, tiers=[ps_cls([])])
            res.append("ok")
        except ten.TenantError as e:
            res.append(str(e))
    assert res[0] == res[1]


@pytest.mark.parametrize("misuse", ["none", "two", "duplicate"])
def test_add_tenant_misuse_equal_jax(misuse):
    res = []
    for pkg in ("port", "jax"):
        ten, _, ps_cls = _side(pkg)[:3]
        reg = ten.TenantRegistry()
        try:
            if misuse == "none":
                reg.add_tenant("a")
            elif misuse == "two":
                reg.add_tenant("a", tiers=[ps_cls([])], tiers_fn=lambda: [])
            else:
                reg.add_tenant("a", tiers=[ps_cls([])])
                reg.add_tenant("a", tiers=[ps_cls([])])
            res.append("ok")
        except ten.TenantError as e:
            res.append(str(e))
    assert res[0] == res[1] != "ok"


def test_onboarding_deeper_tenant_than_wired_raises_as_jax():
    res = []
    for pkg in ("port", "jax"):
        ten, _, ps_cls = _side(pkg)[:3]
        reg = ten.TenantRegistry()
        reg.add_tenant("a", tiers=[ps_cls([])])
        stores = ten.fused_tier_stores(reg)
        reg.add_tenant("b", tiers=[ps_cls([]), ps_cls([])])
        with pytest.raises(ten.TenantError) as ei:
            reg.fused_tiers()
        res.append((len(stores.stores), reg.wired_tiers, str(ei.value)))
    assert res[0] == res[1]


def test_colliding_policy_ids_keep_both_as_jax():
    """Two tenants with the same policy id: FusedPolicySet keys by
    (tenant, id), so both survive, in the same order as JAX's."""
    res = []
    for pkg in ("port", "jax"):
        ten, _, ps_cls, parse = _side(pkg)[:4]
        reg = ten.TenantRegistry()
        for tid, effect in (("a", "permit"), ("b", "forbid")):
            p = parse(f"{effect} (principal, action, resource);", f"{tid}.cedar")[0]
            p.policy_id = "same"
            reg.add_tenant(tid, tiers=[ps_cls([p])])
        fused = reg.fused_tiers()[0]
        res.append((_fused_key(pkg, [fused]), fused.get("same").filename))
    assert res[0] == res[1]
    assert len(res[0][0][0]) == 2


def test_fused_tier_stores_equal_jax():
    res = []
    for pkg in ("port", "jax"):
        reg, _ = _registry(pkg, 12, 3, 2, mode="stores")
        stores = _side(pkg)[0].fused_tier_stores(reg)
        res.append(([s.name() for s in stores], [s.initial_policy_load_complete() for s in stores],
                     [s.content_generation() for s in stores],
                     _fused_key(pkg, [s.policy_set() for s in stores])))
    assert res[0] == res[1]


def test_tenant_body_rides_bytes():
    b = tten.TenantBody(b'{"a": 1}', "alpha")
    assert isinstance(b, bytes) and b == b'{"a": 1}' and b.tenant == "alpha"
    assert json.loads(b) == {"a": 1} and getattr(b"x", "tenant", "") == ""


# ----------------------------------------------------------------- pack


def _fused_engines(n: int, tenants: int, seed: int, buckets: int):
    """(port engine, JAX engine, port registry, JAX registry) over the
    same fused corpora, both incremental on the CPU."""
    t_reg, _ = _registry("port", n, tenants, seed)
    j_reg, _ = _registry("jax", n, tenants, seed)
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=buckets, name="fused")
    je = TPUPolicyEngine(incremental=True, shard_buckets=buckets, name="fused")
    te.load(t_reg.fused_tiers())
    je.load(j_reg.fused_tiers(), warm="off")
    return te, je, t_reg, j_reg


def _pack_bytes(packed) -> dict:
    arrays = packed_arrays(packed)
    return {k: (arrays[k].dtype.str, arrays[k].shape, arrays[k].tobytes()) for k in PACK_ARRAYS}


@pytest.mark.parametrize("buckets", [4, BUCKETS])
@pytest.mark.parametrize("case", CORPUS_CASES, ids=CASE_IDS)
def test_fused_pack_equal_jax(case, buckets):
    """The fused plane byte for byte, its policy order, its tenant
    discriminator column and the shard document with its per-tenant
    rollup (the structural id aside)."""
    te, je, _, _ = _fused_engines(*case, buckets)
    tcs, jcs = te.compiled_set, je._compiled
    assert _pack_bytes(tcs.packed) == _pack_bytes(jcs.packed)
    assert [(m.policy_id, m.filename) for m in tcs.packed.policy_meta] == \
        [(m.policy_id, m.filename) for m in jcs.packed.policy_meta]
    assert tcs.tenant_column == jcs.tenant_column
    col, vocab = tcs.tenant_column
    assert sorted(v for _k, v in vocab) == sorted(f"tenant-{i:02d}" for i in range(case[1]))
    tdoc, jdoc = te.shard_status(), je.shard_status()
    assert set(tdoc["tenants"]) == set(jdoc["tenants"]) == set(te_tenants(case))
    for k in ("shards", "dirty", "hashes", "tenants", "scope"):
        assert tdoc[k] == jdoc[k], k


def te_tenants(case) -> list:
    return [f"tenant-{i:02d}" for i in range(case[1])]


def test_tenant_column_survives_rebuild_and_adoption():
    """A rebuilt set and a set adopted by another engine carry the same
    tenant column (it is derived from the pack every path keeps)."""
    te, _, _, _ = _fused_engines(12, 3, 4, BUCKETS)
    col = te.compiled_set.tenant_column
    assert te.rebuild_compiled() is not None
    assert te.compiled_set.tenant_column == col
    other = TorchPolicyEngine(device="cpu", name="other")
    other.adopt_compiled(te.compiled_set)
    assert other.compiled_set.tenant_column == col


# ------------------------------------------------------------- resolver

# name -> (resolver kwargs, path, headers, host)
RESOLVE_CASES = {
    "path": ({}, "/t/alpha/v1/authorize", {}, None),
    "path-admit": ({}, "/t/beta/v1/admit", {}, None),
    "path-no-tail": ({}, "/t/alpha", {}, None),
    "path-empty-seg": ({}, "/t//v1/authorize", {}, None),
    "header": ({}, "/v1/authorize", {"x-cedar-tenant": " beta "}, None),
    "header-custom": ({"header": "X-Org"}, "/v1/authorize", {"x-org": "alpha"}, None),
    "header-message": ({}, "/v1/authorize", "message:X-Cedar-Tenant=alpha", None),
    "host": ({"hosts": {"Beta.Example": "beta"}}, "/v1/authorize", {}, "beta.example"),
    "host-port": ({"hosts": {"beta.example": "beta"}}, "/v1/authorize", {}, "BETA.example:8443"),
    "host-ipv6": ({"hosts": {"[::1]": "alpha"}}, "/v1/authorize", {}, "[::1]"),
    "host-ipv6-port": ({"hosts": {"[::1]": "alpha"}}, "/v1/authorize", {}, "[::1]:443"),
    "default": ({"default": "alpha"}, "/v1/authorize", {}, None),
    "default-unknown": ({"default": "zeta"}, "/v1/authorize", {}, None),
    "sources-host": ({"hosts": {"h": "beta"}, "sources": ("host",)},
                     "/t/alpha/v1/authorize", {"x-cedar-tenant": "alpha"}, "h"),
    "sources-host-only-path": ({"sources": ("host",)}, "/t/alpha/v1/authorize", {}, None),
    "agree": ({"hosts": {"h": "alpha"}}, "/t/alpha/v1/authorize",
              {"x-cedar-tenant": "alpha"}, "h"),
    "conflict": ({"hosts": {"h": "beta"}}, "/t/alpha/v1/authorize", {}, "h"),
    "conflict-header": ({}, "/t/alpha/v1/authorize", {"x-cedar-tenant": "beta"}, None),
    "unknown": ({}, "/t/zeta/v1/authorize", {}, None),
    "missing": ({}, "/v1/authorize", {}, None),
}


def _headers(spec):
    if isinstance(spec, str):
        msg = email.message.Message()
        name, value = spec.split(":", 1)[1].split("=", 1)
        msg[name] = value
        return msg
    return spec


@pytest.mark.parametrize("name", sorted(RESOLVE_CASES))
def test_resolver_equal_jax(name):
    kwargs, path, headers, host = RESOLVE_CASES[name]
    out = []
    for ten in (tten, jten):
        reg = ten.TenantRegistry()
        for tid in ("alpha", "beta"):
            reg.add_tenant(tid, tiers=[])
        r = ten.TenantResolver(reg, **kwargs)
        out.append((r.resolve(path, _headers(headers), host=host), r.describe()))
    assert out[0] == out[1]


@pytest.mark.parametrize("sources", [(), ("path", "sni"), ("hdr",)])
def test_resolver_refuses_bad_sources_as_jax(sources):
    msgs = []
    for ten in (tten, jten):
        with pytest.raises(ValueError) as ei:
            ten.TenantResolver(ten.TenantRegistry(), sources=sources)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------- engine


def _canon(status: tuple) -> tuple:
    """(decision, sorted reasons, error) of a fast path's answer."""
    decision, reason, error = status
    reasons = tuple(sorted(json.dumps(r, sort_keys=True)
                           for r in (json.loads(reason).get("reasons", []) if reason else [])))
    return decision, reasons, error


ENGINE_TENANTS = ("tenant-00", "tenant-01", "tenant-02")
FALLBACK_TENANT = "tenant-01"


@pytest.fixture(scope="module")
def engines():
    """The port's fused CPU engine behind its SARFastPath, the JAX fused
    engine behind its own, and each tenant's standalone JAX engine, over
    three 40-policy tenants; tenant-01 also carries the
    interpreter-fallback policy. Per tenant, the traffic: its own synth
    bodies with every eighth aimed at a gated scope, and every other
    tenant's bodies (the org-wide slice makes some cross-match)."""
    out = {"t": {}, "j": {}}
    for pkg, key in (("port", "t"), ("jax", "j")):
        ten, corpora_fn, ps_cls, parse = _side(pkg)[:4]
        corpora = corpora_fn(40, 3, seed=5, clusters=2)
        fb = parse(chip_smoke.FALLBACK_POLICY, "fallback.cedar")[0]
        fb.policy_id = "fallback"
        tiers = {t: ([ps_cls(list(c.policies) + [fb])] if t == FALLBACK_TENANT else c.tiers())
                 for t, c in corpora.items()}
        reg = ten.TenantRegistry()
        for t in corpora:
            reg.add_tenant(t, tiers=tiers[t])
        stores = ten.fused_tier_stores(reg)
        if pkg == "port":
            eng = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=BUCKETS)
            eng.load(reg.fused_tiers())
            authz = CedarWebhookAuthorizer(stores, evaluate_batch=eng.evaluate_batch)
            fast = SARFastPath(eng, authz)
        else:
            eng = TPUPolicyEngine(incremental=True, shard_buckets=BUCKETS, name="fused")
            eng.load(reg.fused_tiers(), warm="off")
            authz = j_auth.CedarWebhookAuthorizer(stores, evaluate_batch=eng.evaluate_batch)
            fast = JSARFastPath(eng, authz)
            solo = {}
            for t in corpora:
                e = TPUPolicyEngine(name=f"solo-{t}")
                e.load(tiers[t], warm="off")
                st = JTieredPolicyStores([JMemoryStore(t, tiers[t][0])])
                solo[t] = JSARFastPath(e, j_auth.CedarWebhookAuthorizer(
                    st, evaluate_batch=e.evaluate_batch))
            out["solo"] = solo
        out[key] = {"engine": eng, "fast": fast, "ten": ten}
        if pkg == "port":
            bodies = {t: chip_smoke.gated_bodies(c, 48, seed=11) for t, c in corpora.items()}
            out["bodies"] = bodies
    allb = [b for t in ENGINE_TENANTS for b in out["bodies"][t]]
    out["all_bodies"] = list(dict.fromkeys(allb))
    return out


def _answers(side: dict, tenant: str, bodies: list) -> list:
    return [_canon(a) for a in side["fast"].authorize_raw(
        [side["ten"].TenantBody(b, tenant) for b in bodies])]


@pytest.mark.parametrize("tenant", ENGINE_TENANTS)
def test_fused_fastpath_equals_jax_fused(engines, tenant):
    """Every body, stamped with this tenant, through both fused planes:
    the same decision, reason set and error."""
    got = _answers(engines["t"], tenant, engines["all_bodies"])
    assert got == _answers(engines["j"], tenant, engines["all_bodies"])


@pytest.mark.parametrize("tenant", ENGINE_TENANTS)
def test_fused_equals_standalone_engine(engines, tenant):
    """The isolation contract: the fused answer of each body equals that
    tenant's standalone single-tenant engine's answer."""
    got = _answers(engines["t"], tenant, engines["all_bodies"])
    want = [_canon(a) for a in engines["solo"][tenant].authorize_raw(engines["all_bodies"])]
    assert got == want


@pytest.mark.parametrize("tenant", ENGINE_TENANTS)
def test_fused_python_path_equals_jax(engines, tenant):
    """The interpreter-merging path (authorizer.authorize_batch over the
    fused engine's evaluate_batch, context.tenantId stamped) answers as
    the JAX one does."""
    from cedar_tpu.server.http import get_authorizer_attributes as j_attrs
    from cedar_tpu_torch.server.sar import get_authorizer_attributes as t_attrs

    res = []
    for key, attrs_fn in (("t", t_attrs), ("j", j_attrs)):
        authz = engines[key]["fast"].authorizer
        items = []
        for b in engines["bodies"][tenant]:
            a = attrs_fn(json.loads(b))
            a.tenant = tenant
            items.append(a)
        res.append([(d, r) for d, r in authz.authorize_batch(items)])
    assert res[0] == res[1]


def test_fallback_tenant_gates_rows_through_evaluate_batch(engines):
    """The fallback tenant's gated scope reaches the interpreter merge on
    both sides, while other tenants' identical bodies are clean rows."""
    te = engines["t"]
    routing0 = dict(te["fast"].routing)
    _answers(te, FALLBACK_TENANT, engines["bodies"][FALLBACK_TENANT])
    gated = te["fast"].routing["gated"] - routing0["gated"]
    assert gated > 0
    routing1 = dict(te["fast"].routing)
    _answers(te, "tenant-00", engines["bodies"][FALLBACK_TENANT])
    assert te["fast"].routing["gated"] == routing1["gated"]


def test_cross_tenant_bodies_answer_per_tenant(engines):
    """Bodies whose standalone answers differ across tenants get each
    tenant's own answer from the one fused plane."""
    answers = {t: _answers(engines["t"], t, engines["all_bodies"]) for t in ENGINE_TENANTS}
    differing = [i for i in range(len(engines["all_bodies"]))
                 if len({answers[t][i] for t in ENGINE_TENANTS}) > 1]
    assert len(differing) >= 16


@pytest.mark.parametrize("stamp", ["unknown", "unstamped"])
def test_unknown_tenant_rows_match_nothing(engines, stamp):
    """A row stamped with an unknown tenant, or not stamped at all, takes
    code 0 in the discriminator column: it matches no tenant's rules."""
    bodies = engines["all_bodies"]
    got = {}
    for key in ("t", "j"):
        side = engines[key]
        if stamp == "unknown":
            got[key] = _answers(side, "zeta", bodies)
        else:
            got[key] = [_canon(a) for a in side["fast"].authorize_raw(list(bodies))]
    assert got["t"] == got["j"]
    assert got["t"] == [(DECISION_NO_OPINION, (), None)] * len(bodies)


# --------------------------------------------------------------- server

SRV_TENANTS = ("tenant-00", "tenant-01", "tenant-02")
HOST_TENANT = "tenant-02"
HOST_NAME = "gamma.example"
EDIT_TENANT = "tenant-01"


def _post(port: int, path: str, body: bytes, headers=None):
    """(status, raw response bytes) on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json",
                                                       **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _write_tenant_dirs(root: pathlib.Path) -> dict:
    """Each tenant's directory, one file per policy (an edit then
    re-parses one object); the fallback tenant also holds the
    interpreter-fallback policy. Returns {tenant: corpus}."""
    corpora = synth_tenant_corpora(14, len(SRV_TENANTS), seed=23, clusters=2)
    for tid, c in corpora.items():
        d = root / tid
        d.mkdir()
        for i, src in enumerate(_synth_sources(c.n, c.seed, c.clusters, tid)[0]):
            (d / f"p{i:03d}.cedar").write_text(src + "\n")
        if tid == EDIT_TENANT:
            (d / "fallback.cedar").write_text(chip_smoke.FALLBACK_POLICY)
    return corpora


def _tenant_flags(root: pathlib.Path) -> list:
    flags = []
    for tid in SRV_TENANTS:
        flags += ["--tenant", f"{tid}={root / tid}"]
    # deny entries must outlive the fixture's traffic and reloads (the
    # neighbors' entries are read back after the edit)
    return flags + ["--tenant-host", f"{HOST_NAME}={HOST_TENANT}", "--insecure",
                    "--secure-port", "0", "--metrics-port", "0", "--max-batch", "8",
                    "--decision-cache-deny-ttl-seconds", "600"]


def _jax_tenant_counters() -> dict:
    """The JAX package's tenant families as {(family, labels): value}
    (process-wide; the fixture compares their growth)."""
    out = {}
    for fam in (j_metrics.tenant_requests_total, j_metrics.tenant_rejected_total):
        with fam._lock:
            for k, v in fam._values.items():
                out[(fam.name, k)] = v
    fam = j_metrics.tenant_request_latency
    with fam._lock:
        for k, v in fam._totals.items():
            out[(fam.name + "_count", k)] = v
    return out


def _port_tenant_counters(srv) -> dict:
    m = srv.metrics
    out = {}
    for fam in (m.tenant_requests_total, m.tenant_rejected_total):
        for k, v in fam._values.items():
            out[(fam.name, k)] = v
    for k, v in m.tenant_request_latency._totals.items():
        out[(m.tenant_request_latency.name + "_count", k)] = v
    return out


def _wait_jax_allowed(j, tid, body, deadline_s=60.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if _post(j.bound_port, f"/t/{tid}/v1/authorize", body)[0] == 200 and \
                _get(j.bound_metrics_port, "/readyz")[0] == 200:
            return
        time.sleep(0.1)
    raise AssertionError("the JAX server was not ready")


def _engine_doc(port: int) -> dict:
    return json.loads(_get(port, "/debug/engine")[1])


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both CLI servers over the same three tenant directories, the same
    traffic sent to each in the same order, one request at a time;
    returns what every server test reads."""
    root = tmp_path_factory.mktemp("tenancy-srv")
    tdirs = root / "tenants"
    tdirs.mkdir()
    corpora = _write_tenant_dirs(tdirs)
    t_audit, j_audit = root / "t-audit.jsonl", root / "j-audit.jsonl"
    mp = pytest.MonkeyPatch()
    mp.setenv("CEDAR_TPU_WARM_DEFAULT", "off")
    t = j = None
    rec: dict = {"corpora": corpora}
    try:
        t = build_server(make_parser().parse_args(
            _tenant_flags(tdirs) + ["--device", "cpu", "--reload-seconds", "3600",
                                    "--audit-log-file", str(t_audit)]))
        t.start()
        j = j_build_server(j_make_parser().parse_args(
            _tenant_flags(tdirs) + ["--backend", "tpu", "--tpu-reload-seconds", "0.2",
                                    "--audit-log-file", str(j_audit)]))
        j.start()
        j_counts0 = _jax_tenant_counters()
        bodies = {tid: chip_smoke.gated_bodies(c, 16, seed=3) for tid, c in corpora.items()}
        probe = bodies[SRV_TENANTS[0]][1]
        _wait_jax_allowed(j, SRV_TENANTS[0], probe)
        j_counts0 = _jax_tenant_counters()
        j_skip = j.audit_log.records  # the JAX-only readiness probes
        # the traffic: per tenant by path, by header, and the host tenant
        # by host, each body of every tenant (the cross-tenant share)
        allb = list(dict.fromkeys(b for tid in SRV_TENANTS for b in bodies[tid]))
        routes = {
            "path": lambda tid: (f"/t/{tid}/v1/authorize", {}),
            "header": lambda tid: ("/v1/authorize", {"x-cedar-tenant": tid}),
            "host": lambda tid: ("/v1/authorize", {"Host": HOST_NAME}),
        }
        answers = {}
        for route, how in routes.items():
            for tid in (SRV_TENANTS if route != "host" else (HOST_TENANT,)):
                path, hdrs = how(tid)
                answers[(route, tid)] = [
                    (_post(t.bound_port, path, b, hdrs), _post(j.bound_port, path, b, hdrs))
                    for b in allb]
        rec["answers"] = answers
        rec["all_bodies"] = allb
        # admission reviews through the path route (the stack is the
        # fused set plus the allow-all tier)
        adm = chip_smoke.admission_bodies(24, seed=5)
        rec["admit"] = [(_post(t.bound_port, f"/t/{tid}/v1/admit", b),
                         _post(j.bound_port, f"/t/{tid}/v1/admit", b))
                        for tid in SRV_TENANTS for b in adm]
        # refusals
        sar, review = allb[0], adm[0]
        refusals = {
            "authorize-unknown": ("/t/zeta/v1/authorize", sar, {}),
            "authorize-missing": ("/v1/authorize", sar, {}),
            "authorize-conflict": (f"/t/{SRV_TENANTS[0]}/v1/authorize", sar,
                                   {"Host": HOST_NAME}),
            "admit-unknown": ("/t/zeta/v1/admit", review, {}),
            "admit-missing": ("/v1/admit", review, {}),
            "admit-conflict": ("/v1/admit", review,
                               {"Host": HOST_NAME, "x-cedar-tenant": SRV_TENANTS[0]}),
        }
        t_launch0 = {p: dict(_engine_doc(t.bound_metrics_port)[p]["engine"]["launches"])
                     for p in ("authorization", "admission")}
        rec["refusals"] = {k: (_post(t.bound_port, p, b, h), _post(j.bound_port, p, b, h))
                           for k, (p, b, h) in refusals.items()}
        rec["refusal_launches"] = (t_launch0, {
            p: dict(_engine_doc(t.bound_metrics_port)[p]["engine"]["launches"])
            for p in ("authorization", "admission")})
        rec["tenancy_doc"] = (_get(t.bound_metrics_port, "/debug/tenancy"),
                              _get(j.bound_metrics_port, "/debug/tenancy"))
        # one body sent to two tenants: two entries, then two hits
        twin = chip_smoke.gated_bodies(corpora[SRV_TENANTS[0]], 40, seed=77)[5]
        cache = {}
        for name, srv in (("port", t), ("jax", j)):
            c0 = json.loads(_get(srv.bound_metrics_port, "/debug/cache")[1])["authorization"]
            got = [_post(srv.bound_port, f"/t/{tid}/v1/authorize", twin)
                   for _ in range(2) for tid in SRV_TENANTS[:2]]
            c1 = json.loads(_get(srv.bound_metrics_port, "/debug/cache")[1])["authorization"]
            cache[name] = (c1["size"] - c0["size"], c1["hits"] - c0["hits"],
                           c1["misses"] - c0["misses"], got)
        rec["cache"] = cache
        rec["counters"] = (_port_tenant_counters(t), {
            k: v - j_counts0.get(k, 0) for k, v in _jax_tenant_counters().items()
            if v != j_counts0.get(k, 0)})
        # the port's decided (allow or deny) answers before the edit, per
        # tenant: cache entries stamped with their determining shards
        decided = {}
        for tid in SRV_TENANTS:
            decided[tid] = []
            for b, ((_s, raw), _j) in zip(allb, answers[("path", tid)]):
                st = json.loads(raw)["status"]
                if st.get("allowed") or st.get("denied"):
                    decided[tid].append(b)
        # ---- one policy of one tenant edited (written elsewhere, renamed)
        edited = tdirs / EDIT_TENANT / "p001.cedar"
        src = edited.read_text()
        flipped = ("forbid " + src[len("permit "):] if src.startswith("permit ")
                   else "permit " + src[len("forbid "):])
        tmp = tdirs / "edit.tmp"
        tmp.write_text(flipped)
        tmp.rename(edited)
        gens = {name: [_engine_doc(s.bound_metrics_port)[p]["engine"]["load_generation"]
                       for p in ("authorization", "admission")] for name, s in
                (("port", t), ("jax", j))}
        for s in t.tenancy.registry.tenant_stores():
            s.load_policies()
        assert t.reloader.reload_if_changed() is True
        c0 = json.loads(_get(t.bound_metrics_port, "/debug/cache")[1])["authorization"]
        n0 = t.audit_log.records  # the port-only requests' audit lines are left out
        for tid in SRV_TENANTS:
            if tid != EDIT_TENANT:
                for b in decided[tid]:
                    _post(t.bound_port, f"/t/{tid}/v1/authorize", b)
        c1 = json.loads(_get(t.bound_metrics_port, "/debug/cache")[1])["authorization"]
        rec["port_only"] = (n0, t.audit_log.records)
        rec["neighbor_hits"] = (c1["hits"] - c0["hits"],
                                sum(len(decided[tid]) for tid in SRV_TENANTS
                                    if tid != EDIT_TENANT))
        for s in j.tenancy.registry._tenants[EDIT_TENANT].stores:
            s.load_policies()
        end = time.monotonic() + 120
        while any(a == b for a, b in zip(
                [_engine_doc(j.bound_metrics_port)[p]["engine"]["load_generation"]
                 for p in ("authorization", "admission")], gens["jax"])):
            assert time.monotonic() < end, "the JAX reloader did not reload both engines"
            time.sleep(0.1)
        rec["engine_docs"] = (_engine_doc(t.bound_metrics_port),
                              _engine_doc(j.bound_metrics_port))
        rec["gens"] = gens
        rec["after"] = {tid: [(_post(t.bound_port, f"/t/{tid}/v1/authorize", b),
                               _post(j.bound_port, f"/t/{tid}/v1/authorize", b))
                              for b in allb] for tid in SRV_TENANTS}
        rec["tickers"] = [bool(s.ticker_threads()) for s in t.tenancy.registry.tenant_stores()]
    finally:
        mp.undo()
        for srv in (t, j):
            if srv is not None:
                srv.stop()
    rec["tickers"] = (rec.get("tickers"),
                      [bool(s.ticker_threads()) for s in t.tenancy.registry.tenant_stores()])
    with open(t_audit) as f:
        t_lines = [json.loads(ln) for ln in f if ln.strip()]
    with open(j_audit) as f:
        j_lines = [json.loads(ln) for ln in f if ln.strip()]
    n0, n1 = rec["port_only"]
    rec["audit"] = (t_lines[:n0] + t_lines[n1:], j_lines[j_skip:])
    return rec


@pytest.mark.parametrize("route,tenant", [("path", t) for t in SRV_TENANTS]
                         + [("header", t) for t in SRV_TENANTS] + [("host", HOST_TENANT)])
def test_server_answers_equal_jax(servers, route, tenant):
    """Every body under this route and tenant: the same HTTP status and
    the same response document from both servers."""
    for (ts, tb), (js, jb) in servers["answers"][(route, tenant)]:
        assert ts == js == 200
        assert json.loads(tb) == json.loads(jb)


def test_server_routes_agree(servers):
    """Path, header and host name the same tenant the same way."""
    a = servers["answers"]
    assert [x[0] for x in a[("path", HOST_TENANT)]] == [x[0] for x in a[("host", HOST_TENANT)]]
    for tid in SRV_TENANTS:
        assert [x[0] for x in a[("path", tid)]] == [x[0] for x in a[("header", tid)]]


def test_server_cross_tenant_bodies_differ(servers):
    a = servers["answers"]
    n = len(servers["all_bodies"])
    differ = [i for i in range(n) if len({a[("path", t)][i][0][1] for t in SRV_TENANTS}) > 1]
    assert len(differ) >= 8


def test_server_admission_equals_jax(servers):
    for (ts, tb), (js, jb) in servers["admit"]:
        assert ts == js == 200
        assert json.loads(tb) == json.loads(jb)


@pytest.mark.parametrize("kind", ["authorize-unknown", "authorize-missing", "authorize-conflict",
                                  "admit-unknown", "admit-missing", "admit-conflict"])
def test_refusals_byte_equal_jax(servers, kind):
    (ts, tb), (js, jb) = servers["refusals"][kind]
    assert ts == js == 200
    assert tb == jb
    doc = json.loads(tb)
    if kind.startswith("admit"):
        assert doc["response"]["allowed"] is False and doc["response"]["status"]["code"] == 403
    else:
        assert doc["status"]["evaluationError"].startswith("tenant rejected: ")


def test_refusals_launch_nothing(servers):
    before, after = servers["refusal_launches"]
    assert before == after


def test_debug_tenancy_equal_jax(servers):
    (ts, tb), (js, jb) = servers["tenancy_doc"]
    assert ts == js == 200
    assert json.loads(tb) == json.loads(jb)
    doc = json.loads(tb)
    assert doc["resolver"]["hosts"] == {HOST_NAME: HOST_TENANT}
    assert sorted(doc["registry"]["per_tenant"]) == list(SRV_TENANTS)


def test_tenant_metric_families_equal_jax(servers):
    """cedar_tenant_requests_total, cedar_tenant_rejected_total and the
    duration histogram's counts: the port server's equal the JAX
    families' growth over the same traffic."""
    t_counts, j_grew = servers["counters"]
    assert t_counts == j_grew
    assert any(name == "cedar_tenant_rejected_total" for name, _ in t_counts)


def test_audit_tenant_equal_jax(servers):
    """Every answered decision's audit line names its tenant the same way
    (joined by path, fingerprint and decision)."""
    t_lines, j_lines = servers["audit"]

    def key(lines):
        return sorted((ln["path"], ln.get("tenant"), ln["fingerprint"], ln["decision"],
                       tuple(ln["policies"])) for ln in lines)

    assert key(t_lines) == key(j_lines)
    assert {ln.get("tenant") for ln in t_lines} == set(SRV_TENANTS)


def test_one_body_two_tenants_two_cache_entries(servers):
    """The same bytes sent to two tenants are two cache entries (two
    misses, then two hits), never one shared answer."""
    for name in ("port", "jax"):
        size, hits, misses, _ = servers["cache"][name]
        assert (size, hits, misses) == (2, 2, 2), name
    t_got, j_got = servers["cache"]["port"][3], servers["cache"]["jax"][3]
    assert [(s, json.loads(b)) for s, b in t_got] == [(s, json.loads(b)) for s, b in j_got]


def test_edit_dirty_shards_equal_jax(servers):
    """The one-policy edit dirtied one shard of the edited tenant on each
    engine, as on the JAX server."""
    tdoc, jdoc = servers["engine_docs"]
    for path in ("authorization", "admission"):
        ts, js = tdoc[path]["engine"]["shards"], jdoc[path]["engine"]["shards"]
        assert ts["dirty"] == js["dirty"]
        assert len(ts["dirty"]) == 1 and ts["dirty"][0].startswith(f"{EDIT_TENANT}/")


def test_edit_rollup_equal_jax(servers):
    tdoc, jdoc = servers["engine_docs"]
    for path in ("authorization", "admission"):
        ts, js = tdoc[path]["engine"]["shards"], jdoc[path]["engine"]["shards"]
        assert ts["tenants"] == js["tenants"]
        assert {t: r["dirty"] for t, r in ts["tenants"].items()} == \
            {t: int(t == EDIT_TENANT) for t in SRV_TENANTS}
    gens = servers["gens"]["port"]
    assert [tdoc[p]["engine"]["load_generation"] for p in ("authorization", "admission")] == \
        [g + 1 for g in gens]


@pytest.mark.parametrize("tenant", SRV_TENANTS)
def test_answers_after_edit_equal_jax(servers, tenant):
    for (ts, tb), (js, jb) in servers["after"][tenant]:
        assert ts == js == 200
        assert json.loads(tb) == json.loads(jb)


def test_neighbors_cache_survives_edit(servers):
    """Every decided (allow or deny) entry of the other tenants answers
    from the cache after the edit: the edit's added policy carries its
    own tenant's discriminator, so it cannot decide them."""
    hits, n = servers["neighbor_hits"]
    assert n > 0 and hits == n


# ------------------------------------------------------------------ CLI


def _cli_error(pkg: str, argv: list):
    parse = make_parser if pkg == "port" else j_make_parser
    build = build_server if pkg == "port" else j_build_server
    with pytest.raises(ValueError) as ei:
        build(parse().parse_args(argv + ["--backend", "interpreter", "--insecure",
                                         "--secure-port", "0", "--metrics-port", "0"]))
    return type(ei.value).__name__, str(ei.value)


CLI_ERRORS = {
    "recording": ["--enable-recording", "--recording-dir", "REC"],
    "candidate-dir": ["--rollout-candidate-dir", "CAND"],
    "token-file": ["--rollout-control-token-file", "TOKEN"],
    "insecure-control": ["--rollout-insecure-control"],
    "bad-tenant-spec": ["--tenant", "no-equals-sign"],
    "bad-host-spec": ["--tenant-host", "no-equals"],
    "bad-sources": ["--tenant-sources", "path,sni"],
    "bad-tenant-id": ["--tenant", "bad/id=DIR"],
}


@pytest.mark.parametrize("name", sorted(CLI_ERRORS))
def test_cli_errors_equal_jax(name, tmp_path):
    d = tmp_path / "alpha"
    d.mkdir()
    (d / "p.cedar").write_text("permit (principal, action, resource);")
    argv = [a.replace("CAND", str(tmp_path / "cand")).replace("TOKEN", str(tmp_path / "tok"))
            .replace("REC", str(tmp_path / "rec")).replace("DIR", str(d))
            for a in CLI_ERRORS[name]]
    if name != "bad-tenant-spec" and name != "bad-tenant-id":
        argv = ["--tenant", f"alpha={d}"] + argv
    if name == "bad-tenant-id":
        argv = argv + ["--tenant", f"alpha={d}"]
    assert _cli_error("port", argv) == _cli_error("jax", argv)


TENANT_FLAGS = ["--tenant", "--tenant-header", "--tenant-host", "--tenant-default",
                "--tenant-sources"]


@pytest.mark.parametrize("flag", TENANT_FLAGS)
def test_tenant_flags_default_as_jax(flag):
    jp, tp = j_make_parser(), make_parser()
    j_act, t_act = jp._option_string_actions[flag], tp._option_string_actions[flag]
    assert getattr(tp.parse_args([]), t_act.dest) == getattr(jp.parse_args([]), j_act.dest)
    assert (t_act.type, t_act.nargs, t_act.metavar, type(t_act).__name__) == (
        j_act.type, j_act.nargs, j_act.metavar, type(j_act).__name__)


def test_interpreter_backend_serves_tenants(tmp_path):
    """--backend interpreter over the fused stack: the guard conditions
    isolate tenants on the interpreter walk too."""
    for tid, effect in (("alpha", "permit"), ("beta", "forbid")):
        d = tmp_path / tid
        d.mkdir()
        (d / "p.cedar").write_text(
            f"{effect} (principal, action, resource is k8s::Resource) when "
            '{ resource.apiGroup == "apps" };')
    srv = build_server(make_parser().parse_args(
        ["--tenant", f"alpha={tmp_path / 'alpha'}", "--tenant", f"beta={tmp_path / 'beta'}",
         "--backend", "interpreter", "--insecure", "--secure-port", "0", "--metrics-port", "0"]))
    srv.start()
    try:
        body = json.dumps({"spec": {"user": "u", "uid": "u", "resourceAttributes": {
            "verb": "get", "group": "apps", "version": "v1", "resource": "deployments",
            "namespace": "ns"}}}).encode()
        a = json.loads(_post(srv.bound_port, "/t/alpha/v1/authorize", body)[1])["status"]
        b = json.loads(_post(srv.bound_port, "/t/beta/v1/authorize", body)[1])["status"]
        assert a["allowed"] is True and b["denied"] is True
    finally:
        srv.stop()
    assert all(not s.ticker_threads() for s in srv.tenancy.registry.tenant_stores())


def test_server_closes_tenant_stores(servers):
    """stop() stops every tenant directory store's ticker (the fused tier
    stores close them); they ticked while the server served."""
    before, after = servers["tickers"]
    assert before == [True] * len(SRV_TENANTS) and after == [False] * len(SRV_TENANTS)


# ------------------------------------------- tenant directory store ticks


def _dir_store_side(d, pkg: str):
    from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

    cls = DirectoryPolicyStore if pkg == "port" else JDirectoryPolicyStore
    return cls(str(d), start_ticker=False)


def _store_key(store) -> list:
    return [(p.policy_id, p.effect, p.filename) for p in store.policy_set().policies()]


def _count_reads(monkeypatch) -> list:
    """Every file the port's directory store opens, by path."""
    import builtins

    from cedar_tpu_torch.stores import directory

    opened = []

    def counting_open(path, *a, **kw):
        opened.append(path)
        return builtins.open(path, *a, **kw)

    monkeypatch.setattr(directory, "open", counting_open, raising=False)
    return opened


@pytest.mark.parametrize("racy_s", [0.0, 2.0])
def test_directory_store_tick_reads_only_what_may_have_changed(tmp_path, monkeypatch, racy_s):
    """A tick re-reads no file that settled before the read that cached it
    (racy_s 0: every file settled), and re-reads every file while it is
    "racily clean" (racy_s 2: just written); the served sets, ids and
    content generations equal the JAX store's at every step."""
    from cedar_tpu_torch.stores import directory

    monkeypatch.setattr(directory, "RACY_S", racy_s)
    for i in range(4):
        (tmp_path / f"p{i}.cedar").write_text(
            f'permit (principal, action == k8s::Action::"get", resource) when '
            f'{{ resource.resource == "r{i}" }};\n')
    time.sleep(0.01)
    t, j = _dir_store_side(tmp_path, "port"), _dir_store_side(tmp_path, "jax")
    opened = _count_reads(monkeypatch)
    t.load_policies()
    j.load_policies()
    assert len(opened) == (0 if racy_s == 0 else 4)
    assert _store_key(t) == _store_key(j)
    assert t.content_generation() == j.content_generation()


def test_directory_store_rereads_a_rewritten_file(tmp_path, monkeypatch):
    """Settled files are skipped; a file rewritten in place with content
    of the same length is read again (its ctime moved) and served, as the
    JAX store serves it."""
    from cedar_tpu_torch.stores import directory

    monkeypatch.setattr(directory, "RACY_S", 0.0)
    texts = {f"p{i}.cedar": f'permit (principal, action == k8s::Action::"get", resource) '
             f'when {{ resource.resource == "r{i}" }};\n' for i in range(3)}
    for name, text in texts.items():
        (tmp_path / name).write_text(text)
    time.sleep(0.01)
    t, j = _dir_store_side(tmp_path, "port"), _dir_store_side(tmp_path, "jax")
    opened = _count_reads(monkeypatch)
    g0 = t.content_generation()
    time.sleep(0.01)
    (tmp_path / "p1.cedar").write_text(texts["p1.cedar"].replace("permit", "forbid"))
    t.load_policies()
    j.load_policies()
    assert [pathlib.Path(p).name for p in opened] == ["p1.cedar"]
    assert _store_key(t) == _store_key(j)
    assert [p.effect for p in t.policy_set().policies()] == ["permit", "forbid", "permit"]
    assert t.content_generation() == j.content_generation() == g0 + 1


def test_fuse_after_one_tenant_edit_analyzes_that_tenant_alone(tmp_path, monkeypatch):
    """Each tenant's validationMode gate runs on its own originals; after
    one tenant's edit the next fuse re-runs that tenant's gate alone (the
    others' content generations stand), and the fused stack still equals
    the JAX registry's, which re-runs every gate."""
    from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
    from cedar_tpu_torch.analysis import loadgate
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

    for t in ("a", "b", "c"):
        (tmp_path / t).mkdir()
        for i in range(3):
            (tmp_path / t / f"p{i}.cedar").write_text(
                f'permit (principal, action == k8s::Action::"get", resource) when '
                f'{{ resource.resource == "{t}{i}" }};\n')
    regs, stores = {}, {}
    for pkg, ten, dcls, tiered in (("port", tten, DirectoryPolicyStore, TieredPolicyStores),
                                   ("jax", jten, JDirectoryPolicyStore, JTieredPolicyStores)):
        reg = ten.TenantRegistry()
        for t in ("a", "b", "c"):
            st = dcls(str(tmp_path / t), start_ticker=False)
            stores[(pkg, t)] = st
            reg.add_tenant(t, stores=tiered([st], validation_mode="permissive"))
        regs[pkg] = reg
    calls = []
    real = loadgate.enforce
    monkeypatch.setattr(loadgate, "enforce",
                        lambda tiers, *a, **kw: (calls.append(1), real(tiers, *a, **kw))[1])
    regs["port"].fused_tiers()
    assert len(calls) == 3
    (tmp_path / "b" / "p1.cedar").write_text(
        'forbid (principal, action == k8s::Action::"get", resource) when '
        '{ resource.resource == "b1" };\n')
    for pkg in ("port", "jax"):
        stores[(pkg, "b")].load_policies()
    fused = regs["port"].fused_tiers()
    assert len(calls) == 4
    assert _fused_key("port", fused) == _fused_key("jax", regs["jax"].fused_tiers())
    assert [p.effect for p in fused[0].policies()][3:6] == ["permit", "forbid", "permit"]
