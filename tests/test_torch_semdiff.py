"""The port's device-exact policy-space analysis (cedar_tpu_torch/analysis/
space.py and semdiff.py) against the JAX package's, on the CPU, at
tolerance 0.

  * enumerate_universe gives the same requests (request_doc), in the same
    order, with the same exhaustive flag, strata and truncation, for the
    tiny sets of the JAX suite and synth corpora, exhaustive and
    stratified;
  * the host sat matrices are equal, bit for bit;
  * sweep and semantic_diff give equal results (dead, shadowed, overlaps,
    match counts, flips, exemplars, oracle), and apply_sweep the same
    report;
  * sweep over a TorchPolicyEngine on the CPU (its bits product) equals
    the host route, and its sat matrix _host_sat_matrix's, byte for byte;
  * the analysis metric families publish on every sweep and diff.
"""

from __future__ import annotations

import numpy as np
import pytest

from cedar_tpu.analysis import analyze_tiers as j_analyze_tiers
from cedar_tpu.analysis import semdiff as j_semdiff
from cedar_tpu.analysis import space as j_space
from cedar_tpu.corpus import synth_corpus as j_synth_corpus
from cedar_tpu.lang.authorize import PolicySet as JPolicySet
from cedar_tpu_torch.analysis import analyze_tiers
from cedar_tpu_torch.analysis import semdiff as t_semdiff
from cedar_tpu_torch.analysis import space as t_space
from cedar_tpu_torch.compiler import encode as t_encode
from cedar_tpu_torch.corpus.synth import synth_corpus
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.server import metrics as t_metrics

SCOPE = "(principal is k8s::User, action, resource is k8s::Resource)"
BROAD_PERMIT = f'permit {SCOPE} when {{ resource.resource == "pods" }};\n'
NARROW_PERMIT = (f"permit {SCOPE} when "
                 '{ resource.resource == "pods" && principal.name == "alice" };\n')
DEAD_PERMIT = (f"permit {SCOPE} when "
               '{ resource.resource == "pods" && resource.resource == "secrets" };\n')
FORBID_PODS = (f'forbid {SCOPE} when {{ resource.resource == "pods" '
               '&& principal.name == "mallory" };\n')
TINY = BROAD_PERMIT + NARROW_PERMIT + DEAD_PERMIT + FORBID_PODS
# attribute presence, comparisons, likes and sets: every domain kind
WIDE = (
    f'permit {SCOPE} when {{ resource has namespace && resource.namespace like "team-*" }};\n'
    f'forbid {SCOPE} when {{ principal.name == "eve" || resource.name == "root" }};\n'
    'permit (principal in k8s::Group::"admins", action in [k8s::Action::"get", '
    'k8s::Action::"list"], resource);\n'
    f'permit {SCOPE} when {{ principal.extra has tier && principal.extra.tier == ["gold"] }};\n'
)

# name -> tier sources (inline) or a synth corpus (n, seed, clusters)
SETS = {
    "tiny": [TINY],
    "tiny-two-tiers": [BROAD_PERMIT + DEAD_PERMIT, FORBID_PODS + NARROW_PERMIT],
    "broad": [BROAD_PERMIT],
    "wide": [WIDE],
    "synth80": (80, 13, 2),
    "synth60": (60, 3, 2),
}


def _tiers(pkg: str, name: str):
    spec = SETS[name]
    if isinstance(spec, tuple):
        n, seed, clusters = spec
        fn = synth_corpus if pkg == "port" else j_synth_corpus
        return fn(n, seed=seed, clusters=clusters).tiers()
    cls = PolicySet if pkg == "port" else JPolicySet
    return [cls.from_source(src, f"tier{i}.cedar") for i, src in enumerate(spec)]


def _mods(pkg: str):
    return (t_space, t_semdiff) if pkg == "port" else (j_space, j_semdiff)


def _no_seconds(doc):
    if isinstance(doc, dict):
        return {k: (None if k == "seconds" else _no_seconds(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_no_seconds(v) for v in doc]
    return doc


CASES = [("tiny", 4096), ("tiny", 8), ("tiny-two-tiers", 4096), ("broad", 2048),
         ("wide", 64), ("wide", 4096), ("synth80", 512), ("synth60", 96)]


def _universe(pkg: str, name: str, budget: int):
    space, semdiff = _mods(pkg)
    packed = semdiff.pack_tiers(_tiers(pkg, name))
    uni = space.enumerate_universe([packed], budget=budget, seed=5)
    docs = [semdiff.request_doc(em, req) for em, req in uni.items]
    return packed, uni, docs


@pytest.mark.parametrize("name,budget", CASES)
def test_universe_equals_jax(name, budget):
    _, t_uni, t_docs = _universe("port", name, budget)
    _, j_uni, j_docs = _universe("jax", name, budget)
    assert t_docs == j_docs
    assert t_uni.to_dict() == j_uni.to_dict()
    assert 0 < t_uni.size <= budget


def test_universe_shapes_and_the_port_sentinel():
    """The tiny set is exhaustive, a budget of 8 stratifies it, a synth
    corpus gets a clause witness per policy; the missing-attribute class
    is the port's own compiler.encode._MISSING."""
    _, uni, _ = _universe("port", "tiny", 4096)
    assert uni.exhaustive
    assert not _universe("port", "tiny", 8)[1].exhaustive
    assert _universe("port", "synth60", 96)[1].strata.get("clause", 0) >= 60
    packed = t_semdiff.pack_tiers(_tiers("port", "wide"))
    doms = t_space.build_domains([packed], None)
    assert any(v is t_encode._MISSING for vals in doms.slot_domains.values() for v in vals)


@pytest.mark.parametrize("name,budget", CASES)
def test_host_sat_matrix_equals_jax(name, budget):
    mats = []
    for pkg in ("port", "jax"):
        packed, uni, _ = _universe(pkg, name, budget)
        mats.append(np.asarray(_mods(pkg)[1].sat_matrix(packed, uni)))
    assert mats[0].dtype == mats[1].dtype == bool
    assert np.array_equal(mats[0], mats[1])


def _sweep(pkg: str, name: str, budget: int):
    res = _mods(pkg)[1].sweep(_tiers(pkg, name), budget=budget, oracle_sample=32, seed=2)
    return _no_seconds(res.to_dict()), res.match_counts, res.provenance


@pytest.mark.parametrize("name,budget", CASES)
def test_sweep_equals_jax(name, budget):
    got = _sweep("port", name, budget)
    assert got == _sweep("jax", name, budget)
    doc = got[0]
    assert doc["oracle"]["disagreements"] == 0 and doc["oracle"]["sampled"] > 0


def test_sweep_verdicts_on_the_tiny_set():
    doc, _, provenance = _sweep("port", "tiny", 4096)
    assert provenance == "exact"
    assert [d["policy"] for d in doc["dead"]] == ["policy2"]
    assert "policy1" in {s["policy"] for s in doc["shadowed"]}
    assert doc["overlaps"] and all(o["provenance"] == "exact" for o in doc["overlaps"])


# (live, candidate) pairs of sets or inline edits
DIFFS = {
    "identical": ("tiny", "tiny"),
    "effect-flip": ([BROAD_PERMIT], [BROAD_PERMIT.replace("permit ", "forbid ", 1)]),
    "plus-one": ([TINY], [TINY + 'permit (principal == k8s::User::"newcomer", action, '
                                 'resource is k8s::Resource);\n']),
    "dropped-forbid": ([TINY], [BROAD_PERMIT + NARROW_PERMIT + DEAD_PERMIT]),
    "wide-edit": ([WIDE], [WIDE.replace('"team-*"', '"team-a*"')]),
    "synth-vs-synth": ("synth80", "synth60"),
}
SELECTORS = [(), ({"kind": "allow_to_deny"},), ({"kind": "deny_to_allow"},),
             ({"principal": "k8s::User::*"},), ({"principal": "k8s::Group::*"},),
             ({"kind": "deny_to_allow", "principal": "k8s::User::newcomer"},)]


def _side_tiers(pkg, spec):
    if isinstance(spec, str):
        return _tiers(pkg, spec)
    cls = PolicySet if pkg == "port" else JPolicySet
    return [cls.from_source(src, f"tier{i}.cedar") for i, src in enumerate(spec)]


def _diff(pkg: str, name: str, budget: int):
    live, cand = DIFFS[name]
    res = _mods(pkg)[1].semantic_diff(_side_tiers(pkg, live), _side_tiers(pkg, cand),
                                      budget=budget, oracle_sample=24, seed=1)
    return (_no_seconds(res.to_dict()), [res.out_of_intent(s) for s in SELECTORS],
            res.total_flips)


@pytest.mark.parametrize("budget", [2048, 48])
@pytest.mark.parametrize("name", sorted(DIFFS))
def test_semantic_diff_equals_jax(name, budget):
    got = _diff("port", name, budget)
    assert got == _diff("jax", name, budget)
    doc, out_of_intent, total = got
    assert doc["oracle"]["disagreements"] == 0
    if name == "identical":
        assert total == 0
    if name == "plus-one" and budget == 2048:
        assert set(doc["flip_counts"]) == {"deny_to_allow"} and out_of_intent[-1] == 0
    if name == "effect-flip":
        assert set(doc["flip_counts"]) == {"allow_to_deny"} and out_of_intent[1] == 0


@pytest.mark.parametrize("selector", [{}, {"kind": "allow_to_deny"}, {"kind": "deny_to_allow"},
                                      {"principal": "k8s::User::a*"},
                                      {"resource": "k8s::Resource::*", "action": "*get*"},
                                      {"principal": "k8s::Group::*"}])
def test_flip_in_intent_equals_jax(selector):
    flip = {"kind": "allow_to_deny", "request": {
        "principal": "k8s::User::alice", "action": "k8s::Action::get",
        "resource": "k8s::Resource::pods"}}
    assert t_semdiff.flip_in_intent(flip, selector) == j_semdiff.flip_in_intent(flip, selector)


def test_uncapped_flips_count_out_of_intent_as_jax():
    kw = dict(universe=None, exact=False, n_requests=10,
              flips=[{"kind": "allow_to_deny", "request": {
                  "principal": "k8s::User::u", "action": "k8s::Action::get",
                  "resource": "k8s::Resource::r"}}],
              flip_counts={"allow_to_deny": 5},
              oracle={"sampled": 0, "disagreements": 0, "examples": []}, seconds=0.0)
    t, j = t_semdiff.DiffResult(**kw), j_semdiff.DiffResult(**kw)
    for sel in SELECTORS:
        assert t.out_of_intent(sel) == j.out_of_intent(sel)
    assert t.out_of_intent(({"kind": "allow_to_deny"},)) == 4


def _applied(pkg: str, name: str, budget: int):
    tiers = _tiers(pkg, name)
    semdiff = _mods(pkg)[1]
    report = (analyze_tiers if pkg == "port" else j_analyze_tiers)(tiers, capacity=False)
    packed = semdiff.pack_tiers(tiers)
    res = semdiff.sweep(tiers, budget=budget, packed=packed, oracle_sample=16)
    semdiff.apply_sweep(report, res, packed)
    doc = report.to_dict()
    doc["sweep"] = _no_seconds(doc.get("sweep"))
    return doc, report.render_text().replace(str(round(res.seconds, 3)), "S")


@pytest.mark.parametrize("name,budget", [("tiny", 4096), ("tiny", 8), ("wide", 4096),
                                         ("synth80", 512)])
def test_apply_sweep_report_equals_jax(name, budget):
    got = _applied("port", name, budget)
    assert got == _applied("jax", name, budget)
    if name == "tiny" and budget == 4096:
        codes = {f["code"] for f in got[0]["findings"]}
        assert "dead_rule" in codes and "/exact]" in got[1]


def _engine(tiers):
    engine = TorchPolicyEngine(device="cpu", name="semdiff")
    engine.load(tiers, max_batch=1)
    return engine


@pytest.mark.parametrize("name,budget", CASES)
def test_engine_sweep_equals_host(name, budget):
    """sweep(engine=TorchPolicyEngine(device="cpu")) scores the universe
    through the engine's bits product: the same results as the host route
    over the engine's own pack, and the same sat matrix byte for byte."""
    tiers = _tiers("port", name)
    engine = _engine(tiers)
    packed = engine._compiled.packed
    dev = t_semdiff.sweep(tiers, budget=budget, engine=engine, packed=packed, oracle_sample=32)
    host = t_semdiff.sweep(tiers, budget=budget, packed=packed, oracle_sample=32)
    assert _no_seconds(dev.to_dict()) == _no_seconds(host.to_dict())
    assert dev.match_counts == host.match_counts
    uni = dev.universe
    codes, extras = t_semdiff.encode_universe(packed, uni)
    on_engine = t_semdiff._engine_sat_matrix(engine, packed, codes, extras)
    on_host = t_semdiff._host_sat_matrix(packed, codes, extras)
    assert on_engine.tobytes() == on_host.tobytes()
    # the engine's pack sweeps as the JAX package's fresh pack does
    assert _no_seconds(host.to_dict()) == _sweep_on_fresh_pack(name, budget)


def _sweep_on_fresh_pack(name, budget):
    res = j_semdiff.sweep(_tiers("jax", name), budget=budget, oracle_sample=32)
    return _no_seconds(res.to_dict())


def test_engine_sweep_needs_a_loaded_engine():
    packed = t_semdiff.pack_tiers(_tiers("port", "tiny"))
    uni = t_space.enumerate_universe([packed], budget=64)
    with pytest.raises(RuntimeError, match="no policy set loaded"):
        t_semdiff.sat_matrix(packed, uni, engine=TorchPolicyEngine(device="cpu"))


def test_universe_for_tiers_equals_jax():
    t_uni, t_packed = t_space.universe_for_tiers(_tiers("port", "tiny"), budget=256)
    j_uni, j_packed = j_space.universe_for_tiers(_tiers("jax", "tiny"), budget=256)
    assert ([t_semdiff.request_doc(*it) for it in t_uni.items]
            == [j_semdiff.request_doc(*it) for it in j_uni.items])
    assert (t_packed.n_rules, t_packed.L) == (j_packed.n_rules, j_packed.L)


def test_sweeps_publish_the_analysis_metrics():
    fam = t_metrics.process_metrics()
    t_semdiff.sweep(_tiers("port", "tiny"), budget=4096)
    t_semdiff.semantic_diff(_tiers("port", "tiny"), _tiers("port", "broad"), budget=256)
    text = "\n".join(fam.collect())
    assert 'cedar_analysis_sweep_seconds{mode="sweep"}' in text
    assert 'cedar_analysis_sweep_seconds{mode="semdiff"}' in text
    assert 'cedar_analysis_universe_requests{mode="sweep",exhaustive="1"}' in text
