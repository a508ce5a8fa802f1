"""The port's declarative policy lifecycle (cedar_tpu_torch/lifecycle/, the
lifecycle routes and flags of its server and CLI) against the JAX
package's, on the CPU, at tolerance 0.

  * specs: the same manifests give equal ``to_dict()`` documents, and the
    bad ones the same SpecError message (files and directories too);
  * journal: the same appends give the same file bytes, and records
    written by one package replay in the other;
  * controller: under a scripted driver (each package's DriverError /
    GateBreach) and a fake clock, the transition, journal and status
    sequences are the JAX controller's for every gate and breach, with
    retries, deadlines, manual approval, deletion and resume();
  * driver: over the port's RolloutController with CPU engines, the same
    evidence, journal and ``serve()`` answers as the JAX driver over the
    JAX engine, through shadow, the canary ladder and each breach;
  * CLI and server: a port-0 server with ``--lifecycle-spec-dir`` answers
    ``/debug/lifecycle`` and ``POST /lifecycle/approve`` (403 / 404 / 409 /
    200) as a JAX server wired the same way; the CLI's refusals, warnings
    and resume from a journal file; the metric families' names and help;
  * the chaos seams lifecycle.gate, lifecycle.canary (the lifecycle-breach
    scenario) and lifecycle.journal inject in the port as in JAX.
"""

from __future__ import annotations

import json
import logging
import pathlib
import sys
from types import SimpleNamespace

import pytest

from cedar_tpu import lifecycle as j_lc
from cedar_tpu import rollout as j_rollout
from cedar_tpu.chaos import registry as j_reg
from cedar_tpu.chaos import scenario as j_scenario
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.lifecycle import driver as j_driver
from cedar_tpu.obs import SLOTracker as JSLOTracker
from cedar_tpu.rollout import source as j_source
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.server.http import get_authorizer_attributes as j_attributes
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import lifecycle as t_lc
from cedar_tpu_torch import rollout as t_rollout
from cedar_tpu_torch.chaos import registry as t_reg
from cedar_tpu_torch.chaos import scenario as t_scenario
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.lifecycle import driver as t_driver
from cedar_tpu_torch.obs import SLOTracker
from cedar_tpu_torch.rollout import source as t_source
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.sar import get_authorizer_attributes
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_rollout import CANDIDATE_POLICIES, LIVE_POLICIES, sar_body  # noqa: E402
from test_torch_rollout import (  # noqa: E402 — the rollout suite's servers
    _http,
    _jax_server,
    _port_server,
    _wait,
    _write_dir,
)

TENANT = "team-a"
# the file name both the live stacks and the inline-source candidates use:
# unchanged policies keep their ids, so reasons match
SRC_FILE = "candidate.cedar"

_BLOWUP = " && ".join('(resource.resource == "r1" || resource.name == "never")'
                      for _ in range(12))
# 2^12 DNF clauses: a blocking finding under permissive analysis
UNLOWERABLE_POLICIES = LIVE_POLICIES + (
    'permit (principal in k8s::Group::"joiners", action == k8s::Action::"get", '
    f"resource is k8s::Resource)\n  when {{ {_BLOWUP} }};\n"
)
# the live set plus one permit for a principal the traffic never sends:
# the analyze gate's flips are all deny_to_allow for that principal
PLUS_ONE_POLICIES = LIVE_POLICIES + (
    'permit (principal is k8s::User, action == k8s::Action::"get", '
    'resource is k8s::Resource)\n  when { principal.name == "newcomer" };\n'
)


@pytest.fixture(autouse=True)
def _pristine_registries():
    t_reg.default_registry().reset()
    j_reg.default_registry().reset()
    yield
    t_reg.default_registry().reset()
    j_reg.default_registry().reset()


@pytest.fixture(autouse=True, scope="module")
def _jax_jit_caches_cleared():
    """The JAX planes traced here stay in JAX's process-wide jit caches,
    and the JAX package's own tests count traces: cleared at the end."""
    yield
    import jax

    jax.clear_caches()


def _side(pkg: str) -> SimpleNamespace:
    if pkg == "port":
        return SimpleNamespace(lc=t_lc, drv=t_driver, reg=t_reg, metrics=t_metrics)
    return SimpleNamespace(lc=j_lc, drv=j_driver, reg=j_reg, metrics=j_metrics)


def _arm(pkg: str, faults: list) -> None:
    reg = _side(pkg).reg.default_registry()
    reg.configure({"faults": faults})
    reg.arm()


def _spec(pkg: str, **overrides):
    base = dict(
        tenant=TENANT,
        candidate={"source": LIVE_POLICIES},
        shadow_min_samples=20,
        canary_min_decisions=3,
        canary_ladder=(10, 50, 100),
        stage_deadline_s=300.0,
        max_retries=3,
    )
    base.update(overrides)
    return _side(pkg).lc.PolicyRolloutSpec(**base)


# ------------------------------------------------------------------- specs


MANIFESTS = {
    "minimal": {"metadata": {"name": "t1"}, "spec": {"candidate": {"directory": "/c"}}},
    "full": {
        "kind": "PolicyRollout",
        "metadata": {"name": "tenant-a"},
        "spec": {
            "candidate": {"source": "permit (principal, action, resource);"},
            "gates": {
                "lowerability_floor_pct": 95.0,
                "analyze": {"flip_budget": 2, "universe_budget": 512, "oracle_sample": 8,
                            "allowed_intents": [{"kind": "deny_to_allow",
                                                 "principal": "k8s::User::new*"}]},
                "shadow": {"min_samples": 200, "diff_budget": 1},
                "canary": {"min_decisions": 10, "max_flips": 1},
                "slo": {"burn_ceiling": 3.5, "window_s": 60},
            },
            "promotion": {"mode": "manual", "canary_ladder": []},
            "stage_deadline_s": 30,
            "max_retries": 1,
        },
    },
    "crd": {"tenant": "legacy.name", "spec": {"candidate": {"crd": True},
                                              "promotion": {"canary_ladder": [5, 100]}}},
    "analyze-defaults": {"metadata": {"name": "a"},
                         "spec": {"candidate": {"directory": "/c"}, "gates": {"analyze": {}}}},
    # the bad ones
    "not-an-object": ["PolicyRollout"],
    "wrong-kind": {"kind": "Policy", "metadata": {"name": "t"}},
    "no-name": {"spec": {"candidate": {"directory": "/c"}}},
    "spec-not-object": {"metadata": {"name": "t"}, "spec": [1]},
    "bad-tenant": {"metadata": {"name": "-bad-"}, "spec": {"candidate": {"directory": "/c"}}},
    "no-candidate": {"metadata": {"name": "t"}, "spec": {}},
    "two-candidates": {"metadata": {"name": "t"},
                       "spec": {"candidate": {"directory": "/c", "source": "permit;"}}},
    "bad-promotion": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "promotion": {"mode": "yolo"}}},
    "descending-ladder": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "promotion": {"canary_ladder": [50, 10]}}},
    "zero-rung": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "promotion": {"canary_ladder": [0]}}},
    "over-rung": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "promotion": {"canary_ladder": [101]}}},
    "zero-deadline": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "stage_deadline_s": 0}},
    "negative-retries": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "max_retries": -1}},
    "malformed-number": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "gates": {"shadow": {"min_samples": "many"}}}},
    "bad-intent-key": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"},
        "gates": {"analyze": {"allowed_intents": [{"tenant": "x"}]}}}},
    "bad-universe": {"metadata": {"name": "t"}, "spec": {
        "candidate": {"directory": "/c"}, "gates": {"analyze": {"universe_budget": 0}}}},
}


def _parse(pkg: str, doc):
    lc = _side(pkg).lc
    try:
        return ("ok", lc.spec_from_dict(doc).to_dict())
    except lc.SpecError as e:
        return ("SpecError", str(e))


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_spec_parse_equals_jax(name):
    got = _parse("port", MANIFESTS[name])
    assert got == _parse("jax", MANIFESTS[name])
    if got[0] == "ok":
        # the document round-trips through the parser
        spec = t_lc.spec_from_dict(MANIFESTS[name])
        assert t_lc.spec_from_dict(spec.to_dict()) == spec


def test_opaque_tiers_candidate_serializes_as_a_marker():
    tiers = t_source.candidate_tiers_from_source(LIVE_POLICIES, SRC_FILE)
    jtiers = j_source.candidate_tiers_from_source(LIVE_POLICIES, SRC_FILE)
    assert (_spec("port", candidate={"tiers": tiers}).to_dict()
            == _spec("jax", candidate={"tiers": jtiers}).to_dict())
    assert _spec("port", candidate={"tiers": tiers}).stage_kwargs() == {"tiers": tiers}


@pytest.mark.parametrize("case", ["sorted", "duplicate", "bad-json", "bad-spec"])
def test_specs_dir_equals_jax(tmp_path, case):
    docs = {"b.json": MANIFESTS["minimal"], "a.json": MANIFESTS["full"],
            "ignored.yaml": "not json", ".hidden.json": "not json"}
    if case == "duplicate":
        docs["c.json"] = MANIFESTS["full"]
    elif case == "bad-json":
        docs["d.json"] = "{nope"
    elif case == "bad-spec":
        docs["d.json"] = MANIFESTS["wrong-kind"]
    for name, doc in docs.items():
        (tmp_path / name).write_text(doc if isinstance(doc, str) else json.dumps(doc))

    def load(pkg):
        lc = _side(pkg).lc
        try:
            return ("ok", [s.to_dict() for s in lc.load_specs_dir(str(tmp_path))])
        except lc.SpecError as e:
            return ("SpecError", str(e))

    got = load("port")
    assert got == load("jax")
    assert got[0] == ("ok" if case == "sorted" else "SpecError")
    if case == "sorted":
        assert [d["metadata"]["name"] for d in got[1]] == ["tenant-a", "t1"]


# ----------------------------------------------------------------- journal


_RECORDS = [
    {"event": "applied", "tenant": "t1", "spec": MANIFESTS["full"]},
    {"event": "transition", "tenant": "t1", "from": "pending", "to": "verifying"},
    {"event": "applied", "tenant": "t2", "spec": MANIFESTS["minimal"]},
    {"event": "transition", "tenant": "t1", "from": "verifying", "to": "shadowing",
     "evidence": {"policies": 3, "lowerable_pct": 100.0, "blocking": 0}},
    {"event": "awaiting_approval", "tenant": "t1", "evidence": {"samples": 5, "diffs": 0}},
    {"event": "deleted", "tenant": "t2"},
    {"event": "transition", "tenant": "t1", "from": "shadowing", "to": "promoting"},
]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_written_by_one_package_replays_in_the_other(tmp_path, writer):
    """Byte-identical files, and each package's replay() of the other's
    journal equals its own: a torn tail is dropped and healed alike."""
    paths = {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        j = _side(pkg).lc.LifecycleJournal(str(path))
        for rec in _RECORDS:
            j.append(rec)
        j.close()
        paths[pkg] = path
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    reader = "jax" if writer == "port" else "port"
    src = paths[writer]
    with open(src, "a") as f:
        f.write('{"seq": 99, "event": "transition", "ten')  # a torn tail
    theirs = _side(reader).lc.LifecycleJournal(str(src))
    ours = _side(writer).lc.LifecycleJournal(str(src))
    assert theirs.records() == ours.records()
    assert theirs.replay() == ours.replay()
    assert theirs.replay()["t1"]["stage"] == "promoting" and "t2" not in theirs.replay()
    theirs.append({"event": "deleted", "tenant": "t1"})
    assert ours.records()[-1]["seq"] == len(_RECORDS) + 1
    ours.close()
    theirs.close()


def test_memory_journal_equals_jax():
    docs = []
    for pkg in ("port", "jax"):
        j = _side(pkg).lc.LifecycleJournal()
        for rec in _RECORDS:
            j.append(rec)
        docs.append((j.records(), j.replay(), j.path))
    assert docs[0] == docs[1]
    assert t_lc.TERMINAL_STAGES == j_lc.TERMINAL_STAGES


# -------------------------------------------- the controller, scripted driver


_OK_VERIFY = {"policies": 3, "lowerable_pct": 100.0, "blocking": 0}
_OK_ANALYZE = {"requests": 64, "exhaustive": True, "flips": {}, "total_flips": 0,
               "out_of_intent_flips": 0, "oracle_sampled": 8, "oracle_disagreements": 0,
               "exemplars": [], "seconds": 0.0}


class _ScriptedDriver:
    """A driver answering from a script: per method, a list of results,
    each a value or ("error", msg[, detail]) / ("breach", gate, evidence),
    raised as the package's DriverError / GateBreach. Calls are logged."""

    def __init__(self, pkg: str, script: dict):
        self.drv = _side(pkg).drv
        self.script = {k: list(v) for k, v in script.items()}
        self.calls = []

    def _next(self, name, default=None, arg=None):
        self.calls.append(name if arg is None else (name, arg))
        queue = self.script.get(name)
        r = queue.pop(0) if queue else default
        if isinstance(r, tuple) and r[0] == "error":
            e = self.drv.DriverError(r[1])
            if len(r) > 2:
                e.detail = r[2]
            raise e
        if isinstance(r, tuple) and r[0] == "breach":
            raise self.drv.GateBreach(r[1], r[2])
        return r

    def verify(self, spec):
        return self._next("verify", _OK_VERIFY)

    def analyze(self, spec):
        return self._next("analyze", _OK_ANALYZE)

    def start_shadow(self, spec):
        self._next("start_shadow")

    def shadow_evidence(self):
        return self._next("shadow_evidence", {"samples": 100, "diffs": 0})

    def set_canary(self, percent):
        self._next("set_canary", arg=percent)

    def canary_evidence(self, window_s):
        return self._next("canary_evidence", {"decisions": 50, "flips": 0, "burn": 0.0},
                          arg=window_s)

    def promote(self):
        self._next("promote")

    def rollback(self):
        self._next("rollback")

    def reset(self):
        self._next("reset")


# name -> (spec overrides, driver script, steps). A step is "tick",
# ("advance", seconds), "approve", "delete", ("chaos", faults)
SCRIPTS = {
    "auto-ladder": ({}, {}, ["tick"] * 8),
    "empty-ladder": ({"canary_ladder": ()}, {}, ["tick"] * 5),
    "manual-approval": ({"promotion": "manual", "canary_ladder": ()}, {},
                        ["tick"] * 5 + ["approve"] + ["tick"] * 3),
    "manual-at-last-rung": ({"promotion": "manual", "canary_ladder": (50,)}, {},
                            ["tick"] * 5 + [("advance", 400.0), "tick", "approve", "tick",
                                            "tick"]),
    "shadow-window-fills": ({}, {"shadow_evidence": [{"samples": 3, "diffs": 0},
                                                     {"samples": 19, "diffs": 0}]},
                            ["tick"] * 9),
    "lowerability-blocking": ({}, {"verify": [{**_OK_VERIFY, "blocking": 2}]}, ["tick"] * 4),
    "lowerability-floor": ({"lowerability_floor_pct": 99.5},
                           {"verify": [{**_OK_VERIFY, "lowerable_pct": 99.0}]}, ["tick"] * 4),
    "analyze-pass": ({"analyze_enabled": True}, {}, ["tick"] * 9),
    "analyze-oracle": ({"analyze_enabled": True},
                       {"analyze": [{**_OK_ANALYZE, "oracle_disagreements": 1}]}, ["tick"] * 5),
    "analyze-semantic-diff": ({"analyze_enabled": True, "analyze_flip_budget": 1},
                              {"analyze": [{**_OK_ANALYZE, "out_of_intent_flips": 2}]},
                              ["tick"] * 5),
    "stage-breach": ({}, {"start_shadow": [("breach", "lowerability", {"error": "x"})]},
                     ["tick"] * 4),
    "shadow-diff": ({"shadow_diff_budget": 1},
                    {"shadow_evidence": [{"samples": 40, "diffs": 2}]}, ["tick"] * 5),
    "canary-flip": ({}, {"canary_evidence": [{"decisions": 1, "flips": 1, "burn": 0.0}]},
                    ["tick"] * 6),
    "slo-burn": ({}, {"canary_evidence": [{"decisions": 2, "flips": 0, "burn": 2.5}]},
                 ["tick"] * 6),
    "canary-quorum-deadline": ({"stage_deadline_s": 5.0},
                               {"canary_evidence": [{"decisions": 0, "flips": 0,
                                                     "burn": 0.0}] * 3},
                               ["tick"] * 4 + [("advance", 10.0)] + ["tick"] * 3),
    "transient-then-ok": ({}, {"verify": [("error", "blip"), ("error", "blip again")]},
                          ["tick"] * 10),
    "retry-exhausted": ({"max_retries": 1}, {"verify": [("error", "down")] * 5},
                        ["tick"] * 6),
    "retry-past-deadline": ({"stage_deadline_s": 5.0},
                            {"verify": [("error", "slow")] * 3},
                            ["tick", "tick", ("advance", 10.0), "tick", "tick"]),
    "shadow-deadline": ({"stage_deadline_s": 5.0},
                        {"shadow_evidence": [{"samples": 0, "diffs": 0}] * 4},
                        ["tick"] * 3 + [("advance", 10.0)] + ["tick"] * 3),
    "rollback-diverged": ({}, {"verify": [{**_OK_VERIFY, "blocking": 1}],
                               "rollback": [("error", "diverged",
                                             {"classification": "store_reload_superseded"})]},
                          ["tick"] * 4),
    "rollback-retries-exhausted": ({"max_retries": 1},
                                   {"verify": [{**_OK_VERIFY, "blocking": 1}],
                                    "rollback": [("error", "busy")] * 4},
                                   ["tick"] * 6),
    "promote-retry": ({"canary_ladder": ()}, {"promote": [("error", "warming")]},
                      ["tick"] * 6),
    "gate-chaos-error": ({}, {}, [("chaos", [{"seam": "lifecycle.gate", "kind": "error",
                                              "count": 2}])] + ["tick"] * 10),
    "journal-chaos-error": ({}, {}, [("chaos", [{"seam": "lifecycle.journal",
                                                 "kind": "error", "after": 2,
                                                 "count": 1}])] + ["tick"] * 9),
    "delete-in-flight": ({}, {}, ["tick", "tick", "delete"]),
}


def _run_script(pkg: str, name: str, tmp_path=None):
    """One scripted scenario on one package -> everything observable: the
    tick results, the driver's calls, the journal and the status."""
    overrides, script, steps = SCRIPTS[name]
    side = _side(pkg)
    fake = [0.0]
    audit = []
    ctrl = side.lc.LifecycleController(
        clock=lambda: fake[0], backoff_base_s=0.0, backoff_cap_s=0.001,
        backoff_uniform=lambda a, b: 0.0,
        audit_log=SimpleNamespace(record=audit.append),
    )
    driver = _ScriptedDriver(pkg, script)
    ctrl.apply(_spec(pkg, **overrides), driver)
    out = []
    for step in steps:
        if step == "tick":
            out.append(ctrl.tick())
        elif step == "approve":
            out.append(ctrl.approve(TENANT))
        elif step == "delete":
            ctrl.delete(TENANT)
            out.append(ctrl.stages())
        elif step[0] == "advance":
            fake[0] += step[1]
        elif step[0] == "chaos":
            _arm(pkg, step[1])
    side.reg.default_registry().reset()
    events = [{k: v for k, v in r.items() if k != "ts"} for r in audit]
    return out, driver.calls, ctrl.journal.records(), ctrl.status(), events


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_sequences_equal_jax(name):
    got = _run_script("port", name)
    assert got == _run_script("jax", name)
    ticks, _calls, records, status, _audit = got
    assert records[0]["event"] == "applied"
    assert [r["seq"] for r in records] == list(range(1, len(records) + 1))
    final = status["tenants"].get(TENANT, {}).get("stage")
    want = {"auto-ladder": "promoted", "lowerability-blocking": "rolled_back",
            "rollback-diverged": "failed", "slo-burn": "rolled_back",
            "analyze-pass": "promoted"}
    if name in want:
        assert final == want[name]


def _resume_case(pkg: str, tmp_path, case: str):
    """Run a controller over a journal file, kill or stop it at a point,
    then resume a fresh one over the same file."""
    side = _side(pkg)
    # one path for both packages (the status names it): each run starts
    # from no file
    path = tmp_path / "journal.jsonl"
    path.unlink(missing_ok=True)
    path = str(path)
    fake = [0.0]

    def controller():
        return side.lc.LifecycleController(
            journal=side.lc.LifecycleJournal(path), clock=lambda: fake[0],
            backoff_base_s=0.0, backoff_cap_s=0.001, backoff_uniform=lambda a, b: 0.0)

    ctrl = controller()
    driver = _ScriptedDriver(pkg, {})
    ctrl.apply(_spec(pkg, candidate={"directory": "/cand"}), driver)
    died = None
    if case.startswith("kill-"):
        _arm(pkg, [{"seam": "lifecycle.journal", "kind": "kill",
                    "after": int(case.split("-")[1]), "count": 1}])
    n = 20 if case.startswith("kill-") else 8 if case == "terminal" else 3
    for _ in range(n):
        try:
            ctrl.tick()
        except side.reg.ThreadKilled:
            died = ctrl.stages()
            break
    side.reg.default_registry().reset()
    ctrl.journal.close()
    ctrl2 = controller()
    driver2 = _ScriptedDriver(pkg, {"reset": [("error", "wedged")]} if case == "reset-fails"
                              else {})
    resumed = ctrl2.resume({TENANT: driver2} if case != "no-driver" else {})
    ticks = [ctrl2.tick() for _ in range(3)]
    recs = ctrl2.journal.records()
    ctrl2.stop()
    return died, resumed, driver2.calls, ticks, recs, ctrl2.status()


RESUME_CASES = ["terminal", "in-flight", "reset-fails", "no-driver"] + [
    f"kill-{k}" for k in range(7)]


@pytest.mark.parametrize("case", RESUME_CASES)
def test_resume_equals_jax(tmp_path, case):
    """Terminal stages stay terminal; anything in flight (a kill at every
    stage boundary of the default ladder included) is reset and restarts
    from pending; a failed reset ends failed; a tenant without a driver is
    skipped."""
    port = _resume_case("port", tmp_path, case)
    jax = _resume_case("jax", tmp_path, case)
    assert port == jax
    died, resumed, calls, _ticks, _recs, _status = port
    if case.startswith("kill-"):
        assert died is not None
        assert resumed == {TENANT: "pending"} and calls[0] == "reset"
    elif case == "terminal":
        assert resumed == {TENANT: "promoted"} and "reset" not in calls
    elif case == "reset-fails":
        assert resumed == {TENANT: "failed"}


def test_apply_refusal_delete_and_gauge_row_equal_jax():
    outs = []
    for pkg in ("port", "jax"):
        side = _side(pkg)
        ctrl = side.lc.LifecycleController()
        driver = _ScriptedDriver(pkg, {})
        ctrl.apply(_spec(pkg), driver)
        with pytest.raises(side.lc.LifecycleError) as e1:
            ctrl.apply(_spec(pkg), driver)
        ctrl.delete(TENANT)
        with pytest.raises(side.lc.LifecycleError) as e2:
            ctrl.delete(TENANT)
        with pytest.raises(side.lc.LifecycleError) as e3:
            ctrl.approve("nobody")
        outs.append((str(e1.value), str(e2.value), str(e3.value), driver.calls,
                     ctrl.journal.records()))
    assert outs[0] == outs[1]
    fam = t_metrics.process_metrics()
    assert (("tenant", TENANT),) not in fam.lifecycle_stage._values


def test_metric_families_equal_jax():
    """Names, help and labels of the lifecycle and analysis families are
    the JAX package's; a transition, breach, retry and stage land in the
    port's exposition."""
    fam = t_metrics.process_metrics()
    for name in ("lifecycle_stage", "lifecycle_transitions_total",
                 "lifecycle_gate_breaches_total", "lifecycle_retries_total",
                 "analysis_sweep_seconds", "analysis_universe_requests",
                 "analysis_oracle_disagreements_total", "analysis_semdiff_flips_total",
                 "tenant_label_overflow_total"):
        t, j = getattr(fam, name), getattr(j_metrics, name)
        assert (t.name, t.help, t.label_names) == (j.name, j.help, tuple(j.label_names)), name
    _run_script("port", "slo-burn")
    text = "\n".join(fam.collect())
    assert f'cedar_lifecycle_stage{{tenant="{TENANT}"}} 7' in text
    assert (f'cedar_lifecycle_gate_breaches_total{{tenant="{TENANT}",gate="slo_burn"}}'
            in text)
    assert 'cedar_lifecycle_transitions_total{tenant="team-a",from="halted",to="rolled_back"}' \
        in text


def test_tenant_label_cap_folds_into_other():
    fam = t_metrics.process_metrics()
    before = fam.tenant_label_overflow_total.value()
    names = [f"cap-{i}" for i in range(70)]
    try:
        for n in names:
            t_metrics.set_lifecycle_stage(n, 1)
        assert fam.tenant_label_overflow_total.value() > before
        assert (("tenant", "other"),) in fam.lifecycle_stage._values
    finally:
        for n in names + ["other"]:
            t_metrics.clear_lifecycle_tenant(n)
        fam.lifecycle_stage.remove(tenant="other")


# ------------------------------------------------ the driver over engines


class _Stack:
    """One tenant's serving plane of one package on the CPU: the live
    engine and authorizer, a rollout controller over the engine, an SLO
    tracker and the lifecycle driver over them."""

    def __init__(self, pkg: str, live_src=LIVE_POLICIES, analyze=False):
        self.pkg = pkg
        if pkg == "port":
            tiers = t_source.candidate_tiers_from_source(live_src, SRC_FILE)
            self.engine = TorchPolicyEngine(device="cpu", name="authorization")
            self.engine.load(tiers, max_batch=1)
            stores = TieredPolicyStores([MemoryStore(SRC_FILE, tiers[0])])
            self.authorizer = CedarWebhookAuthorizer(
                stores, evaluate=self.engine.evaluate, evaluate_batch=self.engine.evaluate_batch)
            self.rollout = t_rollout.RolloutController(
                authz_engine=self.engine, queue_depth=4096, duty_cycle=1.0)
            self.slo = SLOTracker(availability_target=0.999)
            self.attrs = get_authorizer_attributes
        else:
            tiers = j_source.candidate_tiers_from_source(live_src, SRC_FILE)
            self.engine = TPUPolicyEngine(name="authorization", warm_max_batch=8)
            self.engine.load(tiers, warm="off")
            stores = JTieredPolicyStores([JMemoryStore(SRC_FILE, tiers[0])])
            self.authorizer = j_auth.CedarWebhookAuthorizer(
                stores, evaluate=self.engine.evaluate, evaluate_batch=self.engine.evaluate_batch)
            self.rollout = j_rollout.RolloutController(
                authz_engine=self.engine, queue_depth=4096, duty_cycle=1.0)
            self.slo = JSLOTracker(availability_target=0.999)
            self.attrs = j_attributes
        self.tiers = tiers
        self.driver = _side(pkg).drv.RolloutLifecycleDriver(
            TENANT, self.rollout, slo=self.slo, live_eval=self.live_eval,
            live_tiers=(lambda: self.tiers) if analyze else None)

    def live_eval(self, body):
        return self.authorizer.authorize_batch([self.attrs(json.loads(body))])[0]

    def stop(self):
        self.rollout.stop()


def _bodies(n=120):
    """n distinct SARs (every canary rung's crc32 slice holds a few) and
    the one the candidate flips."""
    return [sar_body(user=f"u{i:03d}", resource="pods") for i in range(n)] + [
        sar_body("alice", "pods"), sar_body("bob", "secrets")]


# name -> (spec overrides, chaos faults, stack options)
DRIVER_CASES = {
    "auto-ladder": ({}, None, {}),
    "manual-empty-ladder": ({"promotion": "manual", "canary_ladder": ()}, None, {}),
    "lowerability": ({"candidate": {"source": UNLOWERABLE_POLICIES}}, None, {}),
    "shadow-diff": ({"candidate": {"source": CANDIDATE_POLICIES}}, None, {}),
    "canary-flip": ({"candidate": {"source": CANDIDATE_POLICIES}, "shadow_min_samples": 0,
                     "canary_ladder": (100,), "canary_min_decisions": 1}, None, {}),
    "slo-burn": ({"shadow_min_samples": 0, "canary_ladder": (100,),
                  "canary_min_decisions": 1}, "lifecycle-breach", {}),
    "analyze": ({"candidate": {"source": PLUS_ONE_POLICIES}, "analyze_enabled": True,
                 "analyze_universe_budget": 256, "analyze_oracle_sample": 16,
                 "analyze_allowed_intents": ({"kind": "deny_to_allow",
                                              "principal": "k8s::User::*"},),
                 "canary_ladder": ()}, None, {"analyze": True}),
    "analyze-breach": ({"candidate": {"source": CANDIDATE_POLICIES}, "analyze_enabled": True,
                        "analyze_universe_budget": 256, "analyze_oracle_sample": 16},
                       None, {"analyze": True}),
}


def _mask_seconds(doc):
    if isinstance(doc, dict):
        return {k: (None if k == "seconds" else _mask_seconds(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask_seconds(v) for v in doc]
    return doc


def _drive(pkg: str, case: str):
    overrides, chaos, opts = DRIVER_CASES[case]
    side = _side(pkg)
    if chaos:
        builtin = (t_scenario if pkg == "port" else j_scenario).builtin_scenario(chaos)
        reg = side.reg.default_registry()
        reg.configure(builtin)
        reg.arm()
    stack = _Stack(pkg, **opts)
    fake = [0.0]
    ctrl = side.lc.LifecycleController(
        clock=lambda: fake[0], backoff_base_s=0.0, backoff_cap_s=0.001,
        backoff_uniform=lambda a, b: 0.0)
    served = []
    try:
        ctrl.apply(_spec(pkg, **overrides), stack.driver)
        for i in range(60):
            stage = ctrl.tick()[TENANT]
            if stage in side.lc.TERMINAL_STAGES:
                break
            if case == "manual-empty-ladder" and i == 8:
                ctrl.approve(TENANT)
            if stage in ("shadowing", "canary"):
                served.append([stack.driver.serve(b) for b in _bodies()])
                assert stack.rollout.drain(30)
        side.reg.default_registry().disarm()
        after = [stack.live_eval(b) for b in _bodies()]
        return (ctrl.stages(), _mask_seconds(ctrl.journal.records()),
                _mask_seconds(ctrl.status()), served, after,
                stack.rollout.status()["state"])
    finally:
        stack.stop()


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_over_engines_equals_jax(case):
    port = _drive("port", case)
    jax = _drive("jax", case)
    assert port == jax
    stages, records, status, served, _after, state = port
    want = {"auto-ladder": ("promoted", "promoted"),
            "manual-empty-ladder": ("promoted", "promoted"),
            "lowerability": ("rolled_back", "idle"), "shadow-diff": ("rolled_back", "idle"),
            "canary-flip": ("rolled_back", "idle"), "slo-burn": ("rolled_back", "idle"),
            "analyze": ("promoted", "promoted"), "analyze-breach": ("rolled_back", "idle")}
    assert (stages[TENANT], state) == want[case]
    doc = status["tenants"][TENANT]
    if case == "analyze":
        ev = doc["evidence"]["analyze"]
        assert ev["oracle_disagreements"] == 0 and ev["out_of_intent_flips"] == 0
        assert ev["flips"].get("deny_to_allow", 0) > 0
    if case == "analyze-breach":
        assert doc["halt"]["gate"] == "semantic_diff"
    if case in ("canary-flip", "slo-burn"):
        # fail-safe: every served answer is the live engine's
        live = _Stack("port")
        try:
            want_live = [live.live_eval(b) for b in _bodies()]
        finally:
            live.stop()
        assert all(window == want_live for window in served)


def test_driver_errors_equal_jax():
    """The driver's own refusals: no live_eval, no live_tiers, a crd
    candidate without a provider, shadow evidence unstaged."""
    outs = []
    for pkg in ("port", "jax"):
        side = _side(pkg)
        rollout = (t_rollout if pkg == "port" else j_rollout).RolloutController()
        d = side.drv.RolloutLifecycleDriver(TENANT, rollout)
        got = []
        for fn in (lambda: d.serve(b"{}"), lambda: d.analyze(_spec(pkg, analyze_enabled=True)),
                   lambda: d.verify(_spec(pkg, candidate={"crd": True})),
                   d.shadow_evidence, d.rollback, d.reset):
            try:
                got.append(("ok", fn()))
            except side.drv.DriverError as e:
                got.append(("DriverError", str(e)))
        got.append((d.canary_evidence(60.0), d.canary_fraction))
        d.set_canary(250)
        got.append(d.canary_fraction)
        outs.append(got)
        rollout.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("body", [b"x", b"{}", b"abc" * 40, sar_body("alice", "pods")])
@pytest.mark.parametrize("fraction", [0.1, 0.5, 1.0])
def test_canary_slice_equals_jax(body, fraction):
    body = body if isinstance(body, bytes) else body.encode()
    assert (t_driver.RolloutLifecycleDriver._in_canary_slice(body, fraction)
            == j_driver.RolloutLifecycleDriver._in_canary_slice(body, fraction))


# ---------------------------------------------------------- CLI and server


def _spec_dir(tmp_path, cand_dir, **gates) -> pathlib.Path:
    d = tmp_path / "specs"
    d.mkdir(exist_ok=True)
    doc = {"kind": "PolicyRollout", "metadata": {"name": TENANT},
           "spec": {"candidate": {"directory": str(cand_dir)},
                    "gates": {"shadow": {"min_samples": 100000}, **gates},
                    "promotion": {"mode": "manual", "canary_ladder": []}}}
    (d / "a.json").write_text(json.dumps(doc))
    return d


def _dirs(tmp_path):
    live = _write_dir(tmp_path / "live", {"rollout-test.cedar": LIVE_POLICIES})
    cand = _write_dir(tmp_path / "candidate", {"rollout-test.cedar": CANDIDATE_POLICIES})
    return live, cand


def _jax_lifecycle(srv, spec_dir, interval=0.05):
    """A JAX lifecycle controller wired onto a JAX server as the JAX CLI
    wires it (the driver over the server's rollout, warm async, resume then
    apply, the loop started)."""
    specs = j_lc.load_specs_dir(str(spec_dir))
    ctrl = j_lc.LifecycleController(journal=j_lc.LifecycleJournal())
    drivers = {s.tenant: j_lc.RolloutLifecycleDriver(s.tenant, srv.rollout, warm="async")
               for s in specs}
    ctrl.resume(drivers, specs={s.tenant: s for s in specs})
    for s in specs:
        ctrl.apply(s, drivers[s.tenant])
    ctrl.start(interval)
    srv.lifecycle = ctrl
    return ctrl


def _lifecycle_routes(token):
    bearer = {"Authorization": f"Bearer {token}"} if token else {}
    return [
        ("GET", "/debug/lifecycle", None, {}),
        ("POST", "/lifecycle/approve", json.dumps({"tenant": TENANT}).encode(), {}),
        ("POST", "/lifecycle/approve", b"{}", {"Authorization": "Bearer nope"}),
        ("POST", "/lifecycle/approve", json.dumps({"tenant": "nope"}).encode(), bearer),
        ("POST", "/lifecycle/approve", b"{nope", bearer),
        ("POST", "/lifecycle/nope", b"{}", bearer),
        ("POST", "/lifecycle/approve", json.dumps({"tenant": TENANT}).encode(), bearer),
        ("GET", "/debug/lifecycle", None, {}),
    ]


def _shadowing(srv) -> bool:
    doc = srv.lifecycle.status()["tenants"].get(TENANT, {})
    return doc.get("stage") == "shadowing" and "shadow" in doc.get("evidence", {})


@pytest.mark.parametrize("mode", ["token", "insecure", "disabled"])
def test_lifecycle_routes_equal_jax(tmp_path, mode):
    """/debug/lifecycle and POST /lifecycle/approve on the port CLI's server
    (--lifecycle-spec-dir) and on a JAX server wired the same way: the same
    codes and bodies once both hold the candidate in shadow."""
    live, cand = _dirs(tmp_path)
    spec_dir = _spec_dir(tmp_path, cand)
    token = "sekrit" if mode == "token" else None
    (tmp_path / "tok").write_text("sekrit\n")
    flags = {"token": ("--rollout-control-token-file", str(tmp_path / "tok")),
             "insecure": ("--rollout-insecure-control",), "disabled": ()}[mode]
    t = _port_server(live, "--lifecycle-spec-dir", str(spec_dir),
                     "--lifecycle-interval-seconds", "0.05", *flags)
    j = _jax_server(live, control=mode != "disabled", token=token)
    _jax_lifecycle(j, spec_dir)
    try:
        assert _wait(lambda: _shadowing(t) and _shadowing(j), timeout=120)
        for method, path, body, headers in _lifecycle_routes(token):
            got = _http(t.bound_metrics_port, method, path, body, headers)
            want = _http(j.bound_metrics_port, method, path, body, headers)
            assert got == want, (method, path, headers)
        code, doc = _http(t.bound_metrics_port, "GET", "/debug/lifecycle")
        assert code == 200 and doc["journal"] == "memory"
        assert doc["tenants"][TENANT]["evidence"]["verify"]["blocking"] == 0
    finally:
        t.stop()
        j.stop()


def test_lifecycle_routes_404_without_a_controller_as_jax(tmp_path):
    live, _ = _dirs(tmp_path)
    t = _port_server(live, "--rollout-insecure-control")
    j = _jax_server(live)
    try:
        for method, path in (("GET", "/debug/lifecycle"), ("POST", "/lifecycle/approve"),
                             ("POST", "/lifecycle/nope")):
            body = b"{}" if method == "POST" else None
            assert (_http(t.bound_metrics_port, method, path, body)[0]
                    == _http(j.bound_metrics_port, method, path, body)[0] == 404)
    finally:
        t.stop()
        j.stop()


def test_interpreter_backend_refuses_a_spec_dir(tmp_path):
    live, cand = _dirs(tmp_path)
    spec_dir = _spec_dir(tmp_path, cand)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(live)}}]}}))
    argv = ["--config", str(cfg), "--backend", "interpreter", "--insecure", "--secure-port",
            "0", "--metrics-port", "0", "--lifecycle-spec-dir", str(spec_dir)]
    with pytest.raises(ValueError, match="requires the shadow-rollout plane"):
        build_server(make_parser().parse_args(argv))
    (spec_dir / "b.json").write_text("{nope")
    argv[argv.index("interpreter")] = "device"
    with pytest.raises(t_lc.SpecError, match="not valid JSON"):
        build_server(make_parser().parse_args(argv + ["--device", "cpu"]))


def test_cli_warnings(tmp_path, caplog):
    """A canary ladder on a server, several specs and a journal without
    specs each log the JAX CLI's warning."""
    live, cand = _dirs(tmp_path)
    spec_dir = _spec_dir(tmp_path, cand)
    doc = json.loads((spec_dir / "a.json").read_text())
    doc["metadata"]["name"] = "team-b"
    doc["spec"]["promotion"]["canary_ladder"] = [10, 100]
    (spec_dir / "b.json").write_text(json.dumps(doc))
    with caplog.at_level(logging.WARNING):
        srv = _port_server(live, "--lifecycle-spec-dir", str(spec_dir))
        srv.stop()
        srv = _port_server(live, "--lifecycle-journal-file", str(tmp_path / "j.jsonl"))
        try:
            assert srv.lifecycle is None
        finally:
            srv.stop()
    text = caplog.text
    assert "has a canary ladder but the webhook server" in text
    assert "2 lifecycle specs share one rollout controller" in text
    assert "--lifecycle-journal-file without --lifecycle-spec-dir is inert" in text


def test_cli_resumes_from_its_journal(tmp_path):
    """A server stopped while its rollout shadows: the next start over the
    same journal resets the driver and restarts the rollout from pending
    (a ``resumed`` record), then walks it to shadowing again."""
    live, cand = _dirs(tmp_path)
    spec_dir = _spec_dir(tmp_path, cand)
    journal = tmp_path / "journal.jsonl"
    flags = ("--lifecycle-spec-dir", str(spec_dir), "--lifecycle-journal-file", str(journal),
             "--lifecycle-interval-seconds", "0.05", "--rollout-insecure-control")
    srv = _port_server(live, *flags)
    try:
        assert _wait(lambda: _shadowing(srv), timeout=120)
        assert srv.rollout.status()["state"] == "staged"
    finally:
        srv.stop()
    srv = _port_server(live, *flags)
    try:
        assert _wait(lambda: _shadowing(srv), timeout=120)
        recs = [json.loads(ln) for ln in journal.read_text().splitlines()]
        events = [(r["event"], r.get("from"), r.get("to")) for r in recs]
        assert events.count(("applied", None, None)) == 1
        assert ("resumed", "shadowing", "pending") in events
        assert events[-1] == ("transition", "verifying", "shadowing")
        # the JAX journal reader replays the port server's file
        assert j_lc.LifecycleJournal(str(journal)).replay()[TENANT]["stage"] == "shadowing"
    finally:
        srv.stop()


def test_server_stop_stops_the_loop_before_the_rollout(tmp_path):
    live, cand = _dirs(tmp_path)
    srv = _port_server(live, "--lifecycle-spec-dir", str(_spec_dir(tmp_path, cand)),
                       "--lifecycle-interval-seconds", "0.05")
    order = []
    real_l, real_r = srv.lifecycle.stop, srv.rollout.stop
    srv.lifecycle.stop = lambda: (order.append("lifecycle"), real_l())
    srv.rollout.stop = lambda: (order.append("rollout"), real_r())
    srv.stop()
    assert order == ["lifecycle", "rollout"]
    assert srv.lifecycle._loop is None


# ----------------------------------------------------------- chaos seams


@pytest.mark.parametrize("seam", ["lifecycle.gate", "lifecycle.journal"])
@pytest.mark.parametrize("kind", ["error", "kill"])
def test_lifecycle_seams_inject_as_jax(seam, kind):
    """An armed seam injects in the port where it injects in JAX: the
    injection counts and the controller's outcome are the same."""
    outs = []
    for pkg in ("port", "jax"):
        side = _side(pkg)
        _arm(pkg, [{"seam": seam, "kind": kind, "after": 1, "count": 1}])
        ctrl = side.lc.LifecycleController(
            backoff_base_s=0.0, backoff_cap_s=0.001, backoff_uniform=lambda a, b: 0.0)
        ctrl.apply(_spec(pkg), _ScriptedDriver(pkg, {}))
        died = None
        for _ in range(4):
            try:
                ctrl.tick()
            except side.reg.ThreadKilled:
                died = ctrl.stages()
                break
        stats = side.reg.default_registry().stats()
        side.reg.default_registry().reset()
        outs.append((died, ctrl.status(), ctrl.journal.records(),
                     {k: v for k, v in stats.items() if k in ("armed", "injections")}))
    assert outs[0] == outs[1]


def test_lifecycle_breach_scenario_injects_on_the_canary_as_jax():
    """The builtin lifecycle-breach scenario validates and fires on the
    port's canary router as on JAX's: each evaluation after the first five
    errors at the scenario's seeded probability, and every served answer
    stays the live one."""
    outs = []
    for pkg, scen in (("port", t_scenario), ("jax", j_scenario)):
        side = _side(pkg)
        reg = side.reg.default_registry()
        reg.configure(scen.builtin_scenario("lifecycle-breach"))
        reg.arm()
        stack = _Stack(pkg)
        try:
            stack.rollout.stage(tiers=stack.tiers, warm="sync")
            stack.driver.set_canary(100)
            bodies = _bodies(40)
            served = [stack.driver.serve(b) for b in bodies]
            live = [stack.live_eval(b) for b in bodies]
            ev = stack.driver.canary_evidence(300.0)
            stats = reg.stats()
            outs.append((served == live, ev["decisions"], ev["flips"], ev["burn"] > 2.0,
                         {k: v for k, v in stats.items() if k in ("armed", "injections")}))
        finally:
            reg.reset()
            stack.stop()
    assert outs[0] == outs[1]
    assert outs[0][0] and outs[0][3]
