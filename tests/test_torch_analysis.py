"""The port's policy-set analysis (cedar_tpu_torch/analysis/) against the
JAX package's (cedar_tpu/analysis/), on the CPU, at tolerance 0.

  * analyze_tiers(...).to_dict() equals the JAX report, findings in the
    same order and ``truncated`` the same: over tests/test_analysis.py's
    policy sets (copied here as texts), over synth_corpus at 200 and
    1,000 policies with and without the two gated policies across pair
    budgets, and once at 10,000 policies with the default budget (the
    JAX report computed once per module);
  * the rewritten shadowing and conflict passes leave the budget as the
    JAX loops do (``left`` and ``exhausted``) at every budget over sets
    whose clause counts differ, so a charge that does not fit (which
    consumes nothing) is followed by smaller ones that do;
  * the cover index is sound: implies(a, b) only where b's needed token
    is among a's given tokens; and at 10,000 policies almost none of the
    JAX pass's 2,000,000 covers calls remain;
  * the load-time gate (loadgate.enforce, TieredPolicyStores
    .analyzed_policy_sets) in each mode on a clean and a gated set,
    check_object_policies, and the metric lines a gated load publishes.
"""

import json
import time

import pytest

from cedar_tpu.analysis import analyze as j_analyze
from cedar_tpu.analysis import loadgate as j_loadgate
from cedar_tpu.analysis import subsume as j_subsume
from cedar_tpu.compiler.lower import LowerOptions as JLowerOptions
from cedar_tpu.corpus.synth import synth_corpus as j_synth_corpus
from cedar_tpu.lang.authorize import PolicySet as JPolicySet
from cedar_tpu.lang.parser import parse_policies as j_parse_policies
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch.analysis import AnalysisRejected, analyze, check_object_policies, enforce
from cedar_tpu_torch.analysis import subsume
from cedar_tpu_torch.compiler.lower import LowerOptions
from cedar_tpu_torch.corpus.synth import synth_corpus
from cedar_tpu_torch.lang.authorize import PolicySet
from cedar_tpu_torch.lang.parser import parse_policies
from cedar_tpu_torch.server import metrics
from cedar_tpu_torch.server.metrics import WebhookMetrics
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

# ------------------------------------------- tests/test_analysis.py's sets

LOWERABLE = 'permit (principal, action, resource) when { resource.resource == "pods" };'
CLAUSE_LIMIT = (
    "permit (principal, action, resource) when { "
    + " && ".join(f'(context.a{i} == "x" || context.b{i} == "x")' for i in range(12))
    + " };"
)
LITERAL_LIMIT = (
    "permit (principal, action, resource) when { "
    + " && ".join(f'!(context.a{i} like "x*")' for i in range(180))
    + " };"
)
NEGATED_OPAQUE = ("permit (principal, action, resource) "
                  "unless { [1, 2].containsAll([resource.name]) };")
NEGATED_UNTYPED = 'permit (principal, action, resource) unless { context.path like "/api*" };'
HARD_LITERAL = ("permit (principal, action, resource) when "
                "{ resource.labelSelector.contains("
                '{key: "owner", operator: "=", values: [principal.name]}) };')
NATIVE_OPAQUE = "permit (principal, action, resource) when { context.sourceIP.isIpv4() };"
CLAUSE_HEAVY = (
    "permit (principal, action, resource) when { "
    + " && ".join(f'(context.a{i} == "x" || context.b{i} == "x")' for i in range(5))
    + " };"
)
SHADOW_TIERS = [
    """
forbid (principal, action, resource) when { resource.resource == "secrets" };
permit (principal, action, resource) when { resource.resource == "secrets" };
permit (principal in k8s::Group::"admins", action, resource) when { resource.resource == "pods" };
permit (principal in k8s::Group::"admins", action == k8s::Action::"get", resource) when { resource.resource == "pods" };
forbid (principal, action, resource) when { resource.resource == "nodes" };
forbid (principal, action, resource) when { resource.resource == "nodes" && resource.apiGroup == "" };
""",
    """
permit (principal in k8s::Group::"admins", action, resource) when { resource.resource == "pods" };
forbid (principal, action, resource) when { resource.resource == "secrets" && resource.namespace == "prod" };
permit (principal, action, resource) when { resource.resource == "configmaps" };
""",
]
ERROR_SIGNAL_TIERS = [
    """
forbid (principal, action, resource) when { resource.resource == "secrets" };
permit (principal, action, resource) when { resource.namespace == "x" && resource.resource == "secrets" };
""",
    "permit (principal, action, resource);",
]
CONFLICTS = """
permit (principal, action, resource) when { resource.resource == "pods" };
forbid (principal, action, resource) when { resource.resource == "pods" && resource.namespace == "kube-system" };
forbid (principal, action, resource) when { resource.resource == "nodes" };
"""
DISJOINT = """
permit (principal, action, resource) when { resource.resource == "pods" };
forbid (principal, action, resource) when { resource.resource == "secrets" };
"""
# clause counts 1, 2, 4 and 8, error clauses on some: the charges differ
# from pair to pair, so a charge that does not fit is followed by smaller
# ones that do
RAGGED = [
    """
permit (principal, action, resource) when { resource.resource == "pods" };
permit (principal, action, resource) when { (resource.resource == "pods" || resource.resource == "svc") && (principal.name == "a" || principal.name == "b") };
forbid (principal, action, resource) when { resource.resource == "nodes" || resource.resource == "pods" };
permit (principal, action, resource) when { resource.namespace == "x" && resource.resource == "secrets" };
forbid (principal, action, resource) when { (resource.resource == "nodes" || resource.resource == "secrets") && (principal.name == "a" || principal.name == "b") && (resource.apiGroup == "" || resource.apiGroup == "apps") };
permit (principal, action, resource) when { resource.resource == "nodes" };
permit (principal, action, resource) when { principal.name == "a" };
forbid (principal, action, resource) when { resource.namespace == "kube-system" };
""",
    """
permit (principal, action, resource) when { resource.resource == "pods" && principal.name == "a" };
forbid (principal, action, resource) when { (resource.resource == "cm" || resource.resource == "pods") && (resource.namespace == "x" || resource.namespace == "y") };
permit (principal, action, resource) when { resource.resource == "secrets" };
permit (principal, action, resource);
""",
]

# name -> (tier sources, analyze_tiers keywords other than opts, the
# LowerOptions fields for opts or None)
SETS = {
    "lowerable": ([LOWERABLE], {}, None),
    "clause-limit": ([CLAUSE_LIMIT], {}, None),
    "literal-limit": ([LITERAL_LIMIT], {}, None),
    "negated-opaque": ([NEGATED_OPAQUE], {}, {"host_guard": False}),
    "negated-untyped": ([NEGATED_UNTYPED], {}, {"type_guards": False}),
    "negated-opaque-default": ([NEGATED_OPAQUE], {}, None),
    "hard-literal": ([HARD_LITERAL], {}, None),
    "native-opaque": ([NATIVE_OPAQUE], {}, None),
    "never-false": (["permit (principal, action, resource) when { false };"], {}, None),
    "never-two-names": (['permit (principal, action, resource) '
                         'when { principal.name == "a" && principal.name == "b" };'], {}, None),
    "never-apigroup-errors": (['permit (principal, action, resource) '
                               'when { resource.apiGroup == "a" && resource.apiGroup == "b" };'],
                              {}, None),
    "clause-heavy": ([CLAUSE_HEAVY], {}, None),
    "catalog": ([CLAUSE_LIMIT + "\n" + LITERAL_LIMIT + "\n" + NEGATED_OPAQUE + "\n"
                 + NEGATED_UNTYPED], {}, None),
    "shadow-tiers": (SHADOW_TIERS, {}, None),
    "shadow-budget-1": (SHADOW_TIERS[:1], {"pair_budget": 1}, None),
    "error-signals": (ERROR_SIGNAL_TIERS, {}, None),
    "conflicts": ([CONFLICTS], {}, None),
    "disjoint": ([DISJOINT], {}, None),
    "gate-set": ([LOWERABLE + "\n" + CLAUSE_LIMIT], {}, None),
    "ragged": (RAGGED, {}, None),
    "ragged-no-capacity": (RAGGED, {"capacity": False, "pair_budget": 40}, None),
}


def _tiers(cls, sources):
    return [cls.from_source(src, f"tier{i}") for i, src in enumerate(sources)]


def _dump(report) -> str:
    return json.dumps(report.to_dict(), sort_keys=True)


@pytest.mark.parametrize("name", list(SETS))
def test_report_equals_jax(name):
    """The whole report of tests/test_analysis.py's policy sets."""
    sources, kw, opts = SETS[name]
    j_kw, t_kw = dict(kw), dict(kw)
    if opts is not None:
        j_kw["opts"], t_kw["opts"] = JLowerOptions(**opts), LowerOptions(**opts)
    want = j_analyze.analyze_tiers(_tiers(JPolicySet, sources), **j_kw)
    got = analyze.analyze_tiers(_tiers(PolicySet, sources), **t_kw)
    assert _dump(got) == _dump(want)
    assert got.render_text() == want.render_text()


# ------------------------------------------------------- the synth corpora

FALLBACK_POLICY = (
    'permit (principal in k8s::Group::"joiners", action == k8s::Action::"get",\n'
    "        resource is k8s::Resource)\n"
    "  when { "
    + " && ".join('(resource.resource == "widgets" || resource.name == "10.0.0.1")'
                  for _ in range(12))
    + " };\n"
)
NATIVE_OPAQUE_POLICY = """
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""


def _synth(cls, synth, n: int, gated: bool):
    """synth_corpus(n, seed=0) as one tier, the interpreter-fallback and
    native-opaque policies appended when ``gated``."""
    tiers = synth(n, seed=0).tiers()
    if not gated:
        return tiers
    extra = cls.from_source(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY, "gated")
    return [cls(list(tiers[0].policies()) + extra.policies())]


BUDGETS = [0, 1, 7, 1000, 100000, j_analyze.PAIR_BUDGET]


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("n", [200, 1000])
def test_synth_report_equals_jax(n, gated, budget):
    want = j_analyze.analyze_tiers(_synth(JPolicySet, j_synth_corpus, n, gated),
                                   pair_budget=budget)
    got = analyze.analyze_tiers(_synth(PolicySet, synth_corpus, n, gated), pair_budget=budget)
    assert _dump(got) == _dump(want)


class _CountingCovers:
    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, a, b):
        self.calls += 1
        return self.real(a, b)


@pytest.fixture(scope="module")
def synth_10k():
    """The JAX report at 10,000 policies with the default budget, the
    covers calls its passes made, and the seconds analyze_tiers took
    (computed once per module)."""
    mp = pytest.MonkeyPatch()
    counting = _CountingCovers(j_subsume.covers)
    mp.setattr(j_analyze, "covers", counting)
    tiers = j_synth_corpus(10000, seed=0).tiers()
    try:
        t = time.perf_counter()
        want = j_analyze.analyze_tiers(tiers)
        seconds = time.perf_counter() - t
    finally:
        mp.undo()
    return want, counting.calls, seconds


def test_synth_10k_report_equals_jax(synth_10k, monkeypatch, capsys):
    """The north-star size: the same report, the budget spent and
    ``truncated`` set as in JAX, with almost none of the JAX pass's
    covers calls (the JAX loop makes one per budgeted pair). Prints both
    analyze_tiers times, measured in this process with the same covers
    counter on both sides (``-s`` shows them)."""
    want, j_calls, j_seconds = synth_10k
    counting = _CountingCovers(subsume.covers)
    monkeypatch.setattr(analyze, "covers", counting)
    tiers = synth_corpus(10000, seed=0).tiers()
    t = time.perf_counter()
    got = analyze.analyze_tiers(tiers)
    seconds = time.perf_counter() - t
    with capsys.disabled():
        print(f"\nanalyze_tiers at 10,000 policies: port {seconds:.3f} s "
              f"({counting.calls} covers calls), JAX {j_seconds:.3f} s ({j_calls} covers "
              f"calls), ratio {seconds / j_seconds:.3f}")
    assert _dump(got) == _dump(want)
    assert want.truncated
    assert j_calls > 1_000_000
    assert counting.calls * 100 < j_calls, (counting.calls, j_calls)


# ------------------------------------------------------ the budget, exactly


class _RecordingBudget(j_analyze._Budget):
    """The JAX budget, recording whether a charge succeeded after one had
    failed (the failure consumes nothing)."""

    def __init__(self, n: int):
        super().__init__(n)
        self.failed = self.took_after_failure = False

    def take(self, n: int) -> bool:
        ok = super().take(n)
        if not ok:
            self.failed = True
        elif self.failed:
            self.took_after_failure = True
        return ok


# RAGGED's shadowing pass charges 580 in all, its conflict pass 133 more:
# budgets below 580 end in shadowing, 580 to 712 in conflicts
RAGGED_BUDGETS = [0, 1, 2, 3, 5, 8, 13, 21, 40, 77, 150, 299, 450, 579, 580, 600, 650, 700,
                  712, 713, 100000]


@pytest.mark.parametrize("budget", RAGGED_BUDGETS)
def test_pair_passes_spend_the_budget_as_jax(budget):
    """find_shadowing then find_conflicts on one budget, as analyze_tiers
    runs them: the same findings, and the same ``left`` and ``exhausted``
    after each pass."""
    j_infos = j_analyze.lower_all(_tiers(JPolicySet, RAGGED))
    t_infos = analyze.lower_all(_tiers(PolicySet, RAGGED))
    jb, tb = _RecordingBudget(budget), analyze._Budget(budget)
    j_shadow = j_analyze.find_shadowing(j_infos, jb)
    t_shadow = analyze.find_shadowing(t_infos, tb)
    assert [f.to_dict() for f in t_shadow] == [f.to_dict() for f in j_shadow]
    assert (tb.left, tb.exhausted) == (jb.left, jb.exhausted)
    ids = frozenset(f.policy_id for f in j_shadow if f.code == "unreachable_permit")
    j_conf = j_analyze.find_conflicts(j_infos, jb, ids)
    t_conf = analyze.find_conflicts(t_infos, tb, ids)
    assert [f.to_dict() for f in t_conf] == [f.to_dict() for f in j_conf]
    assert (tb.left, tb.exhausted) == (jb.left, jb.exhausted)


def test_ragged_budgets_exercise_a_failed_then_kept_charge():
    """At least one budget of RAGGED_BUDGETS has a charge fail and a
    later, smaller one succeed, and at least one ends in each pass."""
    seen = set()
    for budget in RAGGED_BUDGETS:
        infos = j_analyze.lower_all(_tiers(JPolicySet, RAGGED))
        b = _RecordingBudget(budget)
        j_analyze.find_shadowing(infos, b)
        if b.took_after_failure:
            seen.add("kept-after-failure")
        if b.exhausted:
            seen.add("shadowing-exhausted")
            continue
        j_analyze.find_conflicts(infos, b)
        if b.exhausted:
            seen.add("conflicts-exhausted")
    assert seen == {"kept-after-failure", "shadowing-exhausted", "conflicts-exhausted"}


# ------------------------------------------------------ the index's claim


def _distinct_literals(tiers):
    """One ClauseLit per (literal key, sign) in the lowered clauses."""
    out = {}
    for info in analyze.lower_all(tiers):
        if info.lowered is None:
            continue
        for clause in info.lowered.clauses + info.lowered.error_clauses:
            for cl in clause:
                out.setdefault((cl.lit.key(), cl.negated), cl)
    return list(out.values())


INDEX_SETS = {
    "analysis-sets": lambda: _tiers(PolicySet, [s for v in SETS.values() for s in v[0]]
                                    + SHADOW_TIERS + RAGGED),
    "synth-200-gated": lambda: _synth(PolicySet, synth_corpus, 200, True),
}


@pytest.mark.parametrize("name", list(INDEX_SETS))
def test_cover_index_tokens_are_sound(name):
    """implies(a, b) holds only where b's needed token is among a's given
    tokens, and contradicts(x, y) only where one's negated need is among
    the other's tokens: the index rules out nothing subsume would prove."""
    lits = _distinct_literals(INDEX_SETS[name]())
    tokens = analyze._Tokens()
    seen_implies = 0
    for a in lits:
        _need_a, neg_a, give_a = tokens.literal(a)
        for b in lits:
            need_b, neg_b, give_b = tokens.literal(b)
            if subsume.implies(a, b):
                seen_implies += 1
                assert need_b in give_a, (a, b)
            if subsume.contradicts(a, b):
                assert neg_b in give_a or neg_a in give_b, (a, b)
    assert seen_implies > len(lits)  # more than the identities


# ------------------------------------------------------------- the gate


def _stacks(sources, mode):
    """(port, JAX) TieredPolicyStores over the same policy sources."""
    return (
        TieredPolicyStores([MemoryStore.from_source(f"t{i}", s) for i, s in enumerate(sources)],
                           validation_mode=mode),
        JTieredPolicyStores([JMemoryStore.from_source(f"t{i}", s) for i, s in enumerate(sources)],
                            validation_mode=mode),
    )


GATE_SETS = {"clean": [LOWERABLE], "gated": [LOWERABLE + "\n" + CLAUSE_LIMIT]}


@pytest.mark.parametrize("mode", ["strict", "permissive", "partial", None])
@pytest.mark.parametrize("which", list(GATE_SETS))
def test_enforce_equals_jax(which, mode):
    """analyzed_policy_sets through enforce: strict raises on the gated
    set (with the JAX message) and keeps its report; partial drops the
    offending policy and keeps the other Policy objects themselves (the
    shard compiler's fingerprints are memoized on them); permissive and
    a clean set pass the tiers unchanged; no mode runs no analysis."""
    t_stores, j_stores = _stacks(GATE_SETS[which], mode)
    try:
        want = [[p.policy_id for p in ps.policies()] for ps in j_stores.analyzed_policy_sets()]
    except j_loadgate.AnalysisRejected as e:
        with pytest.raises(AnalysisRejected) as ei:
            t_stores.analyzed_policy_sets()
        assert str(ei.value) == str(e)
        assert _dump(t_stores.last_analysis) == _dump(j_stores.last_analysis)
        assert (which, mode) == ("gated", "strict")
        return
    got = t_stores.analyzed_policy_sets()
    assert [[p.policy_id for p in ps.policies()] for ps in got] == want
    raw = {id(p) for s in t_stores.stores for p in s.policy_set().policies()}
    assert all(id(p) in raw for ps in got for p in ps.policies())
    if mode is None:
        assert t_stores.last_analysis is j_stores.last_analysis is None
    else:
        assert _dump(t_stores.last_analysis) == _dump(j_stores.last_analysis)
    if (which, mode) == ("gated", "partial"):
        assert want == [["policy0"]]


def test_enforce_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown validation mode"):
        enforce(_tiers(PolicySet, [CLAUSE_LIMIT]), "lenient")


OBJECT_TEXTS = {
    "clean": LOWERABLE,
    "mixed": LOWERABLE + "\n" + CLAUSE_LIMIT,
    "warning-only": NATIVE_OPAQUE + "\n" + CLAUSE_HEAVY,
}


@pytest.mark.parametrize("name", list(OBJECT_TEXTS))
def test_check_object_policies_equals_jax(name):
    text = OBJECT_TEXTS[name]
    want = j_loadgate.check_object_policies(j_parse_policies(text, "obj"))
    got = check_object_policies(parse_policies(text, "obj"))
    assert [(p.policy_id, f and f.to_dict()) for p, f in got] == \
        [(p.policy_id, f and f.to_dict()) for p, f in want]


def _findings_counts(values: dict) -> dict:
    return {dict(k)["kind"]: v for k, v in values.items()}


def test_gated_load_publishes_the_metric_lines():
    """A permissive load of the gated set sets the lowerable gauge per
    tier and counts each finding code once per load, as the JAX gate
    does; every server's /metrics renders both families."""
    t_stores, j_stores = _stacks(GATE_SETS["gated"] + [LOWERABLE], "permissive")
    t_family = metrics.process_metrics().policy_analysis_findings_total
    t_before = _findings_counts(dict(t_family._values))
    j_before = _findings_counts(dict(j_metrics.policy_analysis_findings_total._values))
    t_stores.analyzed_policy_sets()
    j_stores.analyzed_policy_sets()
    t_after = _findings_counts(dict(t_family._values))
    j_after = _findings_counts(dict(j_metrics.policy_analysis_findings_total._values))

    def delta(after, before):
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}

    # tier 1's copy of tier 0's lowerable permit is a duplicate
    assert delta(t_after, t_before) == delta(j_after, j_before) == {
        "clause_limit": 1, "duplicate": 1}
    text = WebhookMetrics().expose()
    assert 'cedar_policy_fastpath_lowerable{tier="0"} 1' in text
    assert 'cedar_policy_fastpath_lowerable{tier="1"} 1' in text
    assert "# TYPE cedar_policy_analysis_findings_total counter" in text
    assert 'cedar_policy_analysis_findings_total{kind="clause_limit"}' in text
    j_text = j_metrics.REGISTRY.expose()
    for tier in ("0", "1"):
        line = f'cedar_policy_fastpath_lowerable{{tier="{tier}"}} 1'
        assert line in j_text
