"""The port's overload-control plane (cedar_tpu_torch/load/, the burn queries
of obs/slo.py, the batcher's backlog(), the gated WebhookServer and the
CLI's overload flags) against the JAX package's, on the CPU, at tolerance 0.

  * classify over seeded SAR and admission bodies: every system-critical
    marker, ordinary users, node users on /v1/admit, explain on and off,
    a body stamped with a protocol;
  * AdmissionController: a seeded script of admit, track enter/exit and
    check_eval calls under one injected clock drives a JAX controller and
    a port controller in lockstep; every verdict and every stats() equal,
    the fair-share buckets, the enforce threshold and the CLIENT_CAP
    overflow bucket included; the port's shed counter equals its shed_by;
  * the three arrival schedules, float for float, degenerate inputs
    included; latency_burn / availability_burn over one recorded stream;
  * AdaptiveBatchTuner: JAX's scenarios (shrink while burning, clamp,
    grow, mid-burn hold, decay home, log bound, backlog preference) and a
    seeded random one over the same fake batcher and burn trace, every
    decision and status() equal; backlog() of the port's PipelinedBatcher
    with a held stage counts claimed entries and drains to 0, after a
    revive() too;
  * the servers, each with a plane over the same policies (port servers
    bind port 0): shed bodies and Retry-After on both endpoints, fail-open
    and fail-closed; /readyz in each state; /debug/load and its 404; an
    idle gate byte for byte a plain server; the serve_* wrappers; a shed
    leader's coalesced follower; queue-burned expiries; shed-storm chaos;
  * the CLI: the overload flags' defaults and parses equal the JAX
    parser's; --adaptive-batching without the SLO tracker refused before
    any thread starts; the warm top is the tuner's clamp; a CPU server
    built with the plane wires the gate and one tuner per batcher under
    the supervisor.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import ExitStack

import numpy as np
import pytest

from cedar_tpu import load as jload
from cedar_tpu.cache import DecisionCache as JDecisionCache
from cedar_tpu.chaos import default_registry as j_registry
from cedar_tpu.cli import webhook as j_cli
from cedar_tpu.engine.breaker import CircuitBreaker as JCircuitBreaker
from cedar_tpu.load import admission as j_admission
from cedar_tpu.obs import slo as j_slo
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores.store import MemoryStore as JMemoryStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import load as tload
from cedar_tpu_torch.cache import DecisionCache
from cedar_tpu_torch.chaos import default_registry as t_registry
from cedar_tpu_torch.cli import webhook as t_cli
from cedar_tpu_torch.engine.batcher import PipelinedBatcher
from cedar_tpu_torch.engine.breaker import CLOSED, CircuitBreaker
from cedar_tpu_torch.load import admission as t_admission
from cedar_tpu_torch.obs import slo as t_slo
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server.admission import (
    CedarAdmissionHandler,
    allow_all_admission_policy_store,
)
from cedar_tpu_torch.server.authorizer import DECISION_ALLOW, CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores
from test_torch_cache import _jax_counters_restored  # noqa: F401 — JAX counters put back

DEMO_POLICY = """
permit (
    principal,
    action in [k8s::Action::"get", k8s::Action::"list"],
    resource is k8s::Resource
) when { principal.name == "test-user" && resource.resource == "pods" };
"""

HIGH_USERS = ("system:node:ip-10-0-0-1", "system:node:node-7", "system:kube-scheduler",
              "system:kube-controller-manager", "system:apiserver")
HIGH_GROUPS = ("system:nodes", "system:masters")


def sar_body(user="test-user", resource="pods", verb="get", groups=()) -> bytes:
    return json.dumps({
        "apiVersion": "authorization.k8s.io/v1",
        "kind": "SubjectAccessReview",
        "spec": {
            "user": user, "uid": "u", "groups": list(groups),
            "resourceAttributes": {"verb": verb, "version": "v1", "resource": resource,
                                   "namespace": "default"},
        },
    }).encode()


def review_body(uid="r1", username="sam", groups=()) -> bytes:
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": uid, "operation": "CREATE",
            "userInfo": {"username": username, "groups": list(groups)},
            "kind": {"group": "", "version": "v1", "kind": "ConfigMap"},
            "resource": {"group": "", "version": "v1", "resource": "configmaps"},
            "namespace": "default", "name": "c",
            "object": {"apiVersion": "v1", "kind": "ConfigMap",
                       "metadata": {"name": "c", "namespace": "default"}},
        },
    }).encode()


class Stamped(bytes):
    """A body stamped with a wire protocol, as the JAX package's mesh
    front end wraps its bodies: never high, whatever its bytes say."""

    protocol = "ext_authz"


def seeded_requests(seed: int, n: int, n_clients: int = 24) -> list:
    """[(path, body)]: SARs of system-critical principals (each marker),
    ordinary users and undecodable bodies, and admission reviews of
    ordinary and node users; users drawn from a pool of `n_clients`, a
    third of the ordinary SARs from one hot user."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(10))
        user = f"user-{int(rng.integers(n_clients))}"
        if k == 0:
            out.append(("authorization", sar_body(user=HIGH_USERS[int(rng.integers(5))])))
        elif k == 1:
            out.append(("authorization", sar_body(
                user=f"worker-{int(rng.integers(9))}",
                groups=[HIGH_GROUPS[int(rng.integers(2))]])))
        elif k == 2:
            out.append(("admission", review_body(uid=f"r{int(rng.integers(1000))}",
                                                 username="system:node:n1")))
        elif k == 3:
            out.append(("admission", review_body(uid=f"r{int(rng.integers(1000))}",
                                                 username=user)))
        elif k == 4:
            out.append(("authorization", b"{not json" if rng.random() < 0.5 else b""))
        else:
            if rng.random() < 1 / 3:
                user = "hot-controller"
            out.append(("authorization", sar_body(
                user=user, resource=("pods", "secrets", "nodes")[int(rng.integers(3))])))
    return out


# ---------------------------------------------------------------- classify


@pytest.mark.parametrize("explain", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_classify_equals_jax(seed, explain):
    reqs = seeded_requests(seed, 200)
    reqs += [("authorization", Stamped(sar_body(user="system:node:n1"))),
             ("admission", Stamped(review_body()))]
    got = [tload.classify(p, b, explain) for p, b in reqs]
    assert got == [jload.classify(p, b, explain) for p, b in reqs]
    assert set(got) == ({"sheddable"} if explain else {"high", "normal"})


def test_high_markers_equal_jax():
    assert t_admission._HIGH_MARKERS == j_admission._HIGH_MARKERS
    assert tload.__all__ == jload.__all__
    assert (tload.PRIORITIES, tload.STATE_CODES) == (jload.PRIORITIES, jload.STATE_CODES)
    assert tload.AdmissionController.CLIENT_CAP == jload.AdmissionController.CLIENT_CAP == 1024


# ------------------------------------------------------------ the controller


class FakeClock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def _verdict(res):
    priority, shed = res
    if shed is None:
        return priority, None
    return priority, (shed.priority, shed.reason, shed.retry_after_s, shed.client)


def _eval_verdict(ctrl, mod, priority):
    try:
        ctrl.check_eval(priority)
    except mod.RequestShed as e:
        return str(e), e.priority, e.reason, e.retry_after_s
    return None


def _series(counter, **labels) -> float:
    key = tuple((k, labels.get(k, "")) for k in counter.label_names)
    with counter._lock:
        return counter._values.get(key, 0.0)


CONTROLLERS = {
    "defaults": dict(max_inflight=8),
    "quota": dict(max_inflight=8, client_qps=4.0, client_burst=2.0, client_enforce_at=0.25,
                  retry_after_s=2.5),
    "quota-burst0": dict(max_inflight=6, shed_sheddable_at=0.3, shed_normal_at=0.6,
                         client_qps=3.0, client_enforce_at=0.0),
    "cap": dict(max_inflight=8, client_qps=2.0, client_burst=1.0, client_enforce_at=0.0),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("config", sorted(CONTROLLERS))
def test_controller_script_equals_jax(config, seed):
    """One seeded script of admits, track enters/exits and check_evals,
    the clock stepping between them, on both controllers in lockstep."""
    rng = np.random.default_rng(100 + seed)
    clock = FakeClock()
    kw = CONTROLLERS[config]
    t = tload.AdmissionController(clock=clock, **kw)
    j = jload.AdmissionController(clock=clock, **kw)
    n_clients = 40
    if config == "cap":
        t.CLIENT_CAP = j.CLIENT_CAP = 12  # the overflow bucket within the script
    reqs = seeded_requests(seed, 600, n_clients=n_clients)
    shed0 = {k: v for k, v in t_metrics.process_metrics().load_shed_total._values.items()}
    open_t, open_j = [], []
    for i, (path, body) in enumerate(reqs):
        clock.now += float(rng.exponential(0.05))
        explain = rng.random() < 0.1
        vt = _verdict(t.admit(path, body, explain))
        vj = _verdict(j.admit(path, body, explain))
        assert vt == vj, i
        if vt[1] is None:
            # admitted: held open a while, or closed at once
            ct, cj = t.track(path, vt[0]), j.track(path, vj[0])
            ct.__enter__()
            cj.__enter__()
            open_t.append(ct)
            open_j.append(cj)
        r = rng.random()
        if r < 0.5 and open_t:
            k = int(rng.integers(len(open_t)))
            open_t.pop(k).__exit__(None, None, None)
            open_j.pop(k).__exit__(None, None, None)
        elif r < 0.65:
            pr = ("high", "normal", "sheddable")[int(rng.integers(3))]
            assert _eval_verdict(t, tload, pr) == _eval_verdict(j, jload, pr), i
        assert (t.load_state(), t.load()) == (j.load_state(), j.load())
        if i % 25 == 0:
            assert t.stats() == j.stats(), i
    for ct, cj in zip(open_t, open_j):
        ct.__exit__(None, None, None)
        cj.__exit__(None, None, None)
    st = t.stats()
    assert st == j.stats()
    assert st["offered"] == st["admitted"] + st["shed"] == len(reqs)
    assert st["shed"] > 0 and st["state"] == "ok"
    if config == "cap":
        assert st["clients_tracked"] == 12 and t._overflow_bucket is not None
    if kw.get("client_qps"):
        assert any(k.endswith("/client_quota") for k in st["shed_by"])
    # every shed reached the port's process counter
    fam = t_metrics.process_metrics().load_shed_total
    delta = {}
    for key, v in fam._values.items():
        d = v - shed0.get(key, 0.0)
        if d:
            kd = dict(key)
            delta[f"{kd['priority']}/{kd['reason']}"] = d
    assert delta == st["shed_by"]


def test_client_cap_overflow_at_1024():
    """The real cap: 1,100 distinct clients under enforcement; the 77 past
    the cap share one overflow bucket, on both controllers alike."""
    clock = FakeClock()
    kw = dict(max_inflight=4, client_qps=1.0, client_burst=1.0, client_enforce_at=0.0)
    t = tload.AdmissionController(clock=clock, **kw)
    j = jload.AdmissionController(clock=clock, **kw)
    for i in range(1100):
        body = sar_body(user=f"minted-{i}")
        assert _verdict(t.admit("authorization", body)) == _verdict(j.admit("authorization", body))
    st = t.stats()
    assert st == j.stats()
    assert st["clients_tracked"] == 1024
    assert st["shed_by"] == {"normal/client_quota": 1100 - 1024 - 1}


def test_client_throttled_label_cap():
    """cedar_client_throttled_total folds ids past 64 into `other`,
    counted by cedar_client_label_overflow_total."""
    fam = t_metrics.process_metrics()
    with fam._client_label_lock:
        seen = len(fam._client_labels)
    over0 = _series(fam.client_label_overflow_total)
    other0 = _series(fam.client_throttled_total, client="other")
    n = 80
    for i in range(n):
        t_metrics.record_client_throttled(f"label-cap-{i}")
    folded = max(0, seen + n - t_metrics._CLIENT_LABEL_CAP)
    assert _series(fam.client_label_overflow_total) - over0 == folded
    assert _series(fam.client_throttled_total, client="other") - other0 == folded
    assert t_metrics._CLIENT_LABEL_CAP == 64


def test_load_families_on_metrics():
    text = t_metrics.WebhookMetrics().expose()
    for family in ("cedar_load_shed_total", "cedar_inflight_requests", "cedar_load_state",
                   "cedar_batch_tuning", "cedar_client_throttled_total",
                   "cedar_client_label_overflow_total"):
        assert f"# TYPE {family} " in text


# ------------------------------------------------------------ arrivals


SCHEDULES = [
    ("poisson", dict(rate_hz=200.0, duration_s=5.0)),
    ("poisson", dict(rate_hz=37.5, duration_s=11.0)),
    ("poisson", dict(rate_hz=0.0, duration_s=5.0)),
    ("poisson", dict(rate_hz=10.0, duration_s=0.0)),
    ("poisson", dict(rate_hz=-3.0, duration_s=2.0)),
    ("burst", dict(base_hz=20.0, burst_hz=400.0, period_s=1.0, duty=0.3, duration_s=6.0)),
    ("burst", dict(base_hz=400.0, burst_hz=20.0, period_s=0.7, duty=1.7, duration_s=3.0)),
    ("burst", dict(base_hz=50.0, burst_hz=90.0, period_s=0.0, duty=0.5, duration_s=2.0)),
    ("burst", dict(base_hz=5.0, burst_hz=60.0, period_s=2.0, duty=-0.5, duration_s=4.0)),
    ("burst", dict(base_hz=0.0, burst_hz=0.0, period_s=1.0, duty=0.5, duration_s=5.0)),
    ("flash", dict(base_hz=20.0, peak_hz=600.0, at_s=2.0, ramp_s=1.0, duration_s=8.0)),
    ("flash", dict(base_hz=321.0, peak_hz=1926.0, at_s=2.0, ramp_s=3.0, duration_s=16.0)),
    ("flash", dict(base_hz=300.0, peak_hz=50.0, at_s=0.5, ramp_s=0.5, duration_s=3.0)),
    ("flash", dict(base_hz=40.0, peak_hz=200.0, at_s=1.0, ramp_s=0.0, duration_s=3.0)),
    ("flash", dict(base_hz=0.0, peak_hz=0.0, at_s=1.0, ramp_s=1.0, duration_s=5.0)),
]


@pytest.mark.parametrize("seed", [0, 7, "storm"])
@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_arrival_schedules_equal_jax(case, seed):
    kind, kw = SCHEDULES[case]
    name = {"poisson": "poisson_schedule", "burst": "burst_schedule",
            "flash": "flash_crowd_schedule"}[kind]
    got = getattr(tload, name)(seed=seed, **kw)
    assert got == getattr(jload, name)(seed=seed, **kw)
    assert got == sorted(got) and all(0.0 <= t < max(kw["duration_s"], 1e-9) for t in got)


# ------------------------------------------------------------ burn queries


@pytest.mark.parametrize("seed", range(3))
def test_burn_queries_equal_jax(seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock(1_700_000_000.0)
    kw = dict(availability_target=0.995, latency_target=0.98, latency_budget_s=0.05,
              clock=clock)
    t, j = t_slo.SLOTracker(**kw), j_slo.SLOTracker(**kw)
    windows = (0.0, 0.001, 5.0, 10.0, 25.0, 60.0, 300.0, 3600.0, 30000.0)
    for step in range(400):
        clock.now += float(rng.exponential(2.0))
        path = ("authorization", "admission")[int(rng.integers(2))]
        lat, err = float(rng.exponential(0.04)), bool(rng.random() < 0.05)
        t.record(path, lat, err)
        j.record(path, lat, err)
        if step % 20 == 0:
            for p in ("authorization", "admission", "nothing"):
                for w in windows:
                    assert t.latency_burn(p, w) == j.latency_burn(p, w)
                    assert t.availability_burn(p, w) == j.availability_burn(p, w)
    assert t.latency_burn("nothing", 60.0) == 0.0
    # a 1 ms window still sees the current 10 s bucket
    t.record("authorization", 1.0, False)
    j.record("authorization", 1.0, False)
    assert t.latency_burn("authorization", 0.001) == j.latency_burn("authorization", 0.001) > 0.0


# ------------------------------------------------------------ the tuner


class FakeBatcher:
    def __init__(self, max_batch=256, window_s=0.0004, backlog=False):
        self.max_batch = max_batch
        self.window_s = window_s
        self.queue = 0
        self.claimed = 0
        if backlog:
            self.backlog = lambda: self.queue + self.claimed

    def queue_fill(self):
        return self.queue


class FakeSLO:
    def __init__(self):
        self.burn = 0.0
        self.asked = []

    def latency_burn(self, path, window_s):
        self.asked.append((path, window_s))
        return self.burn


def _grow_to_clamp():
    return [(0.0, 10_000)] * 12


def _decay():
    return [(2.0, 0), (0.0, 2_000)] + [(0.0, 0)] * 30


def _log_bound():
    # shrink, decay, shrink, ...: a move every tick
    return [(0.0 if i % 2 else 2.0, 0) for i in range(300)]


TUNER_SCENARIOS = {
    "shrink-while-burning": [(2.0, 10_000)],
    "linger-clamp": [(5.0, 0)] * 22,
    "grow": _grow_to_clamp(),
    "idle-at-home": [(0.1, 0)] * 3,
    "decay-home": _decay(),
    "mid-burn-hold": [(0.5, 10_000)] * 4,
    "log-bound": _log_bound(),
}


def _tuner_pair(backlog: bool, **kw):
    clock = FakeClock(5000.0)
    out = []
    for mod in (tload, jload):
        b, s = FakeBatcher(backlog=backlog), FakeSLO()
        bounds = mod.TuningBounds(min_batch=64, max_batch=1024, min_window_s=0.00005,
                                  max_window_s=0.002)
        out.append((mod.AdaptiveBatchTuner(b, s, bounds=bounds, clock=clock, **kw), b, s))
    return clock, out


@pytest.mark.parametrize("backlog", [False, True])
@pytest.mark.parametrize("scenario", sorted(TUNER_SCENARIOS))
def test_tuner_scenarios_equal_jax(scenario, backlog):
    clock, ((tt, tb, ts), (jt, jb, js)) = _tuner_pair(backlog)
    for burn, queue in TUNER_SCENARIOS[scenario]:
        clock.now += 0.5
        for b, s in ((tb, ts), (jb, js)):
            s.burn = burn
            b.queue, b.claimed = (queue, queue) if backlog else (queue, 0)
        assert tt.tick() == jt.tick()
        assert (tb.max_batch, tb.window_s) == (jb.max_batch, jb.window_s)
    assert tt.status() == jt.status()
    assert ts.asked == js.asked
    st = tt.status()
    assert len(st["decisions"]) <= tload.AdaptiveBatchTuner.DECISION_LOG == 128
    if scenario == "log-bound":
        assert st["moves"] > 128 and len(st["decisions"]) == 128
    if scenario == "decay-home":
        assert (tb.max_batch, tb.window_s) == (tt.home_batch, tt.home_window_s)
    if scenario in ("mid-burn-hold", "idle-at-home"):
        assert st["moves"] == 0


@pytest.mark.parametrize("seed", range(3))
def test_tuner_random_trace_equals_jax(seed):
    rng = np.random.default_rng(seed)
    clock, ((tt, tb, ts), (jt, jb, js)) = _tuner_pair(True, burn_low=0.3, burn_high=1.5,
                                                      window_s=30.0, path="admission")
    for _ in range(400):
        clock.now += float(rng.exponential(0.7))
        burn = float(rng.choice([0.0, 0.1, 0.3, 0.9, 1.5, 4.0]))
        queue, claimed = int(rng.integers(0, 3000)), int(rng.integers(0, 3000))
        for b, s in ((tb, ts), (jb, js)):
            s.burn, b.queue, b.claimed = burn, queue, claimed
        assert tt.tick() == jt.tick()
    assert tt.status() == jt.status()


def test_tuner_publishes_and_threads():
    tuner, b, s = _tuner_pair(False, path="tuned", interval_s=0.01)[1][0]
    fam = t_metrics.process_metrics().batch_tuning
    assert fam._values[(("path", "tuned"), ("param", "max_batch"))] == 256
    s.burn = 2.0
    tuner.start()
    deadline = time.monotonic() + 5.0
    while tuner.moves == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    tuner.stop()
    assert tuner.moves >= 1 and not tuner._thread.is_alive()
    assert fam._values[(("path", "tuned"), ("param", "linger_us"))] == b.window_s * 1e6


class _HeldStages:
    """Pipeline stages whose dispatch waits on `gate`."""

    def __init__(self):
        self.gate = threading.Event()

    def pipeline_encode(self, items):
        return list(items)

    def pipeline_dispatch(self, ctx):
        self.gate.wait(10.0)
        return ctx

    def pipeline_decode(self, ctx):
        return [f"ok-{x}" for x in ctx]


def _submit_all(b, n, prefix, results):
    ts = [threading.Thread(target=lambda i=i: results.append(
        b.submit(f"{prefix}{i}", timeout=10.0)), daemon=True) for i in range(n)]
    for t in ts:
        t.start()
    return ts


def _wait_for(pred, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)
    return pred()


def test_pipelined_backlog_counts_claimed_and_drains():
    """backlog() = queued + claimed into the stages: with dispatch held,
    every submitted entry stays visible after the collector claimed it
    (queue_fill() no longer sees it); 0 once the pipeline drains, and
    again after a forced revive() with a batch held."""
    stages = _HeldStages()
    b = PipelinedBatcher(stages, max_batch=2, window_s=0.0, depth=1, encode_workers=1)
    results = []
    try:
        ts = _submit_all(b, 6, "r", results)
        # the collector has claimed at least one batch into the held
        # stages, where queue_fill() no longer sees it
        assert _wait_for(lambda: b.backlog() == 6 and b.queue_fill() < 6)
        stages.gate.set()
        for t in ts:
            t.join(5.0)
        assert sorted(results) == [f"ok-r{i}" for i in range(6)]
        assert _wait_for(lambda: b.backlog() == 0)
        # a held batch, then a forced revive: the held entries fail at
        # once, and the count restarts from the new generation
        stages.gate.clear()
        errors = []

        def one(i):
            try:
                b.submit(f"s{i}", timeout=10.0)
            except RuntimeError as e:
                errors.append(str(e))

        ts = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(4)]
        for t in ts:
            t.start()
        assert _wait_for(lambda: b.backlog() == 4)
        assert b.revive(force=True)
        stages.gate.set()
        for t in ts:
            t.join(5.0)
        assert _wait_for(lambda: b.backlog() == 0)
        assert b.submit("after", timeout=5.0) == "ok-after"
        assert b.backlog() == 0
    finally:
        stages.gate.set()
        b.stop()


def test_knob_change_takes_effect_at_next_claim():
    """A max_batch written while a claim waits for its window never
    changes that claim: every entry is answered exactly once."""
    seen = []

    class Stages(_HeldStages):
        def pipeline_encode(self, items):
            seen.append(len(items))
            return list(items)

    stages = Stages()
    stages.gate.set()
    b = PipelinedBatcher(stages, max_batch=64, window_s=0.05, depth=2, encode_workers=1)
    results = []
    try:
        ts = _submit_all(b, 40, "k", results)
        time.sleep(0.01)
        b.max_batch = 4  # lands during the first claim's window
        for t in ts:
            t.join(5.0)
        assert sorted(results) == sorted(f"ok-k{i}" for i in range(40))
        assert sum(seen) == 40
    finally:
        b.stop()


# ------------------------------------------------------------ the servers


def _port_server(start=False, **kw):
    stores = TieredPolicyStores([MemoryStore.from_source("demo", DEMO_POLICY)])
    adm = TieredPolicyStores([MemoryStore.from_source("demo", DEMO_POLICY),
                              allow_all_admission_policy_store()])
    kw.setdefault("admission_handler", CedarAdmissionHandler(adm))
    srv = WebhookServer(CedarWebhookAuthorizer(stores), address="127.0.0.1", port=0,
                        metrics_port=0, **kw)
    if start:
        srv.start()
    return srv


def _jax_server(start=False, **kw):
    stores = JTieredPolicyStores([JMemoryStore.from_source("demo", DEMO_POLICY)])
    adm = JTieredPolicyStores([JMemoryStore.from_source("demo", DEMO_POLICY),
                               j_adm.allow_all_admission_policy_store()])
    kw.setdefault("admission_handler", j_adm.CedarAdmissionHandler(adm))
    srv = JWebhookServer(authorizer=j_auth.CedarWebhookAuthorizer(stores), address="127.0.0.1",
                         port=0, metrics_port=0, **kw)
    if start:
        srv.start()
    return srv


def _post(port, path, body):
    """-> (status, raw body, Retry-After or None)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Retry-After")
    finally:
        conn.close()


def _get(port, path):
    """-> (status, body, X-Cedar-Load-State or None)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read(), r.headers.get("X-Cedar-Load-State")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("X-Cedar-Load-State")


def _hold(stack, ctrl, n, path="authorization", priority="high"):
    for _ in range(n):
        stack.enter_context(ctrl.track(path, priority))


@pytest.fixture(params=[True, False], ids=["fail-open", "fail-closed"])
def server_pair(request):
    """A started port and JAX server, each with its own controller at
    max_inflight 5 and Retry-After 2.5 s."""
    kw = dict(max_inflight=5, retry_after_s=2.5)
    tc, jc = tload.AdmissionController(**kw), jload.AdmissionController(**kw)
    t = _port_server(start=True, load=tc, admission_fail_open=request.param)
    j = _jax_server(start=True, load=jc, admission_fail_open=request.param)
    yield t, j, tc, jc
    t.stop(drain_grace_s=0)
    j.stop(drain_grace_s=0)


TRAFFIC = [
    ("/v1/authorize", sar_body()),
    ("/v1/authorize", sar_body(user="alice", resource="secrets")),
    ("/v1/authorize", sar_body(user="system:node:n1")),
    ("/v1/authorize", sar_body(user="w", groups=["system:masters"])),
    ("/v1/authorize", b"{not json"),
    ("/v1/admit", review_body(uid="u-9")),
    ("/v1/admit", review_body(uid="u-10", username="system:node:n2")),
    ("/v1/admit", b"{not json"),
]


@pytest.mark.parametrize("held", [0, 3, 4, 5])
def test_gated_answers_and_readyz_equal_jax(server_pair, held):
    """At each load (ok, pressure, overload, saturated) every answer's
    status, bytes and Retry-After, and /readyz's status, body and
    X-Cedar-Load-State, equal the JAX server's."""
    t, j, tc, jc = server_pair
    with ExitStack() as stack:
        _hold(stack, tc, held)
        _hold(stack, jc, held)
        for path, body in TRAFFIC:
            got = _post(t.bound_port, path, body)
            assert got == _post(j.bound_port, path, body), (path, body)
        ready = _get(t.bound_metrics_port, "/readyz")
        assert ready == _get(j.bound_metrics_port, "/readyz")
        assert ready[1] == ready[2].encode() == tc.load_state().encode()
        assert ready[0] == (503 if held == 5 else 200)
        if held == 5:
            # a kubelet's shed: the honest shape, Retry-After in whole
            # seconds
            body = sar_body(user="system:node:x")
            st, data, retry = _post(t.bound_port, "/v1/authorize", body)
            assert (st, data, retry) == _post(j.bound_port, "/v1/authorize", body)
            doc = json.loads(data)["status"]
            assert (st, retry, doc["allowed"], doc["denied"]) == (200, "2", False, False)
            assert doc["evaluationError"] == ("request shed under overload (saturated); "
                                              "retry after 2.5s")
    ts, js = tc.stats(), jc.stats()
    n = len(TRAFFIC) + (held == 5)
    assert ts == js and ts["offered"] == ts["admitted"] + ts["shed"] == n
    # overload sheds the six normal requests (both endpoints), saturation
    # every one
    assert ts["shed"] == {0: 0, 3: 0, 4: 6, 5: n}[held]
    assert ts["eval_shed"] == 0


def test_debug_load_equals_jax(server_pair):
    t, j, tc, jc = server_pair
    for srv, mod in ((t, tload), (j, jload)):
        srv.tuners.append(mod.AdaptiveBatchTuner(FakeBatcher(), FakeSLO(), clock=lambda: 7.0))
    with ExitStack() as stack:
        # 4 of 5 held: the normal requests shed at ingress
        _hold(stack, tc, 4)
        _hold(stack, jc, 4)
        for path, body in TRAFFIC:
            _post(t.bound_port, path, body)
            _post(j.bound_port, path, body)
        # the evaluation stage of an admitted request on a saturated server
        _hold(stack, tc, 1)
        _hold(stack, jc, 1)
        for srv in (t, j):
            srv.handle_authorize(sar_body(), priority="normal")
    for srv in (t, j):
        srv.tuners[0].batcher.queue = 5000
        srv.tuners[0].tick()
    got = _get(t.bound_metrics_port, "/debug/load")
    want = _get(j.bound_metrics_port, "/debug/load")
    assert got[0] == want[0] == 200
    assert json.loads(got[1]) == json.loads(want[1])
    doc = json.loads(got[1])
    assert doc["tuning"]["authorization"]["moves"] == 1
    assert doc["admission_control"]["shed_by"] == {"normal/eval_saturated": 1,
                                                   "normal/load_overload": 6}


def test_no_plane_readyz_and_debug_load_unchanged():
    """Without a plane /readyz is bare and /debug/load answers 404, as on
    the JAX server."""
    t, j = _port_server(start=True), _jax_server(start=True)
    try:
        for path in ("/readyz", "/debug/load"):
            got = _get(t.bound_metrics_port, path)
            assert got == _get(j.bound_metrics_port, path)
        assert _get(t.bound_metrics_port, "/readyz") == (200, b"", None)
        assert _get(t.bound_metrics_port, "/debug/load")[0] == 404
    finally:
        t.stop(drain_grace_s=0)
        j.stop(drain_grace_s=0)


def test_idle_gate_byte_identical_to_no_gate():
    """An idle gate answers every request byte for byte as a server with
    no gate does, through HTTP and the serve_* wrappers, and as the JAX
    server's idle gate."""
    gated = _port_server(start=True, load=tload.AdmissionController(max_inflight=1024))
    plain = _port_server(start=True)
    jgated = _jax_server(load=jload.AdmissionController(max_inflight=1024))
    try:
        for path, body in TRAFFIC:
            a, b = _post(gated.bound_port, path, body), _post(plain.bound_port, path, body)
            assert a == b
            if path == "/v1/authorize":
                docs = [s.serve_authorize(body) for s in (gated, plain, jgated)]
            else:
                docs = [s.serve_admit(body) for s in (gated, plain, jgated)]
            assert json.dumps(docs[0]) == json.dumps(docs[1]) == json.dumps(docs[2])
        assert gated.load.stats()["shed"] == 0
    finally:
        for s in (gated, plain, jgated):
            s.stop(drain_grace_s=0)


@pytest.mark.parametrize("fail_open", [True, False])
def test_serve_wrappers_equal_jax(fail_open):
    tc, jc = tload.AdmissionController(max_inflight=2), jload.AdmissionController(max_inflight=2)
    t = _port_server(load=tc, admission_fail_open=fail_open)
    j = _jax_server(load=jc, admission_fail_open=fail_open)
    try:
        for n in (0, 1, 2):
            with ExitStack() as stack:
                _hold(stack, tc, n)
                _hold(stack, jc, n)
                for path, body in TRAFFIC:
                    if path == "/v1/authorize":
                        a, b = t.serve_authorize(body), j.serve_authorize(body)
                    else:
                        a, b = t.serve_admit(body), j.serve_admit(body)
                    assert json.dumps(a) == json.dumps(b)
        assert tc.stats() == jc.stats()
        # the evaluation-stage gate on /v1/admit renders the shed too
        with ExitStack() as stack:
            _hold(stack, tc, 2)
            _hold(stack, jc, 2)
            a = t.handle_admit(review_body(uid="e1"), priority="normal")
            b = j.handle_admit(review_body(uid="e1"), priority="normal")
            assert json.dumps(a) == json.dumps(b)
            assert "eval_saturated" in a["response"]["status"]["message"]
            assert a["response"]["allowed"] is fail_open
    finally:
        t.stop(drain_grace_s=0)
        j.stop(drain_grace_s=0)


def test_shed_leader_coalesced_follower():
    """A follower coalesced behind a leader the evaluation-stage gate sheds
    answers the same shed at once; one eval shed; nothing is cached, and
    the same SAR evaluates cleanly once the load is gone. The answers
    equal the JAX server's."""
    ctrl = tload.AdmissionController(max_inflight=1)
    srv = _port_server(decision_cache=DecisionCache(), load=ctrl, request_timeout_s=5.0)
    entered, gate = threading.Event(), threading.Event()
    real = srv._authorize_uncached

    def gated(body, request_id, start, coalesce_key=None, **kw):
        entered.set()
        gate.wait(5)
        return real(body, request_id, start, coalesce_key=coalesce_key, **kw)

    srv._authorize_uncached = gated
    body = sar_body()
    results = {}

    def run(name):
        results[name] = (srv.handle_authorize(body, priority="normal"), time.monotonic())

    try:
        with ExitStack() as stack:
            _hold(stack, ctrl, 1)
            leader = threading.Thread(target=run, args=("leader",))
            leader.start()
            assert entered.wait(5)
            follower = threading.Thread(target=run, args=("follower",))
            follower.start()
            assert _wait_for(lambda: srv._sar_flights.in_flight() > 0)
            time.sleep(0.05)
            t_release = time.monotonic()
            gate.set()
            leader.join(5)
            follower.join(5)
        assert results["leader"][0] == results["follower"][0]
        assert results["follower"][1] - t_release < 1.0
        assert ctrl.stats()["eval_shed"] == 1
        assert srv.decision_cache.size() == 0
        jctrl = jload.AdmissionController(max_inflight=1)
        jsrv = _jax_server(decision_cache=JDecisionCache(), load=jctrl, request_timeout_s=5.0)
        try:
            with ExitStack() as stack:
                _hold(stack, jctrl, 1)
                want = jsrv.handle_authorize(body, priority="normal")
            assert results["leader"][0] == want
            after = srv.handle_authorize(body, priority="normal")
            assert after == jsrv.handle_authorize(body, priority="normal")
            assert after["status"]["allowed"] is True
        finally:
            jsrv.stop(drain_grace_s=0)
    finally:
        gate.set()
        srv.stop(drain_grace_s=0)


class _FakeFastPath:
    def __init__(self, fn, breaker=None):
        self.available = True
        self.authorize_raw = fn
        self.breaker = breaker


def test_queue_burned_expiries_spare_the_breaker():
    """A moving but slow plane under 12 concurrent submitters with 120 ms
    budgets: the expiries burn in the submit queue, and none feeds the
    breaker (threshold 3), as on the JAX server."""

    def slow(items):
        time.sleep(0.05)
        return [(DECISION_ALLOW, "", None)] * len(items)

    out = {}
    for side, mk, brk in (("port", _port_server, CircuitBreaker),
                          ("jax", _jax_server, JCircuitBreaker)):
        breaker = brk(name=f"storm-{side}", failure_threshold=3, recovery_s=30.0)
        srv = mk(fastpath=_FakeFastPath(slow, breaker=breaker), request_timeout_s=0.12,
                 max_batch=1)
        try:
            results, lock = [], threading.Lock()

            def one(srv=srv, results=results, lock=lock):
                doc = srv.handle_authorize(sar_body())
                with lock:
                    results.append(doc)

            ts = [threading.Thread(target=one) for _ in range(12)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(10.0)
            expiries = [d for d in results
                        if "deadline" in (d["status"].get("evaluationError") or "")]
            out[side] = (len(results), breaker.state)
            assert len(expiries) >= 5
        finally:
            srv.stop(drain_grace_s=0)
    assert out["port"] == out["jax"] == (12, CLOSED)


def test_shed_storm_chaos_equals_jax():
    """The shed-storm fault (load.shed corrupt) on both registries at one
    seed forces the same sheds on both servers: honest answers, exact
    accounting, the breaker closed, clean answers once disarmed."""
    sides = {}
    for side, mk, mod, registry, brk in (
        ("port", _port_server, tload, t_registry, CircuitBreaker),
        ("jax", _jax_server, jload, j_registry, JCircuitBreaker),
    ):
        reg = registry()
        reg.reset()
        reg.configure({"seed": 23, "faults": [
            {"seam": "load.shed", "kind": "corrupt", "after": 5, "probability": 0.5,
             "count": 40}]})
        ctrl = mod.AdmissionController(max_inflight=1024)
        breaker = brk(name=f"shed-storm-{side}", failure_threshold=3)
        srv = mk(load=ctrl, request_timeout_s=2.0,
                 fastpath=_FakeFastPath(lambda items: [(DECISION_ALLOW, "", None)] * len(items),
                                        breaker=breaker))
        try:
            reg.arm()
            docs = [json.dumps(srv.serve_authorize(sar_body())) for _ in range(120)]
            docs += [json.dumps(srv.serve_admit(review_body(uid=f"s{i}"))) for i in range(20)]
            reg.disarm()
            docs.append(json.dumps(srv.serve_authorize(sar_body())))
            sides[side] = (docs, ctrl.stats(), breaker.state)
        finally:
            reg.reset()
            srv.stop(drain_grace_s=0)
    assert sides["port"] == sides["jax"]
    docs, st, state = sides["port"]
    assert state == CLOSED
    assert st["offered"] == 141 == st["admitted"] + st["shed"]
    assert st["shed"] == st["shed_by"]["normal/chaos"] == 40
    assert json.loads(docs[-1])["status"]["allowed"] is True


# ------------------------------------------------------------------ the CLI


OVERLOAD_FLAGS = ("max_inflight", "shed_sheddable_at", "shed_normal_at", "client_qps",
                  "client_burst", "client_enforce_at", "shed_retry_after_seconds",
                  "adaptive_batching", "tuner_interval_seconds", "tuner_burn_window_seconds",
                  "tuner_min_batch", "tuner_max_batch", "tuner_min_linger_us",
                  "tuner_max_linger_us")

ARGV = [
    [],
    ["--max-inflight", "512", "--shed-sheddable-at", "0.4", "--client-qps", "50",
     "--adaptive-batching", "--tuner-max-linger-us", "900"],
    ["--max-inflight", "100", "--shed-sheddable-at", "0.3", "--shed-normal-at", "0.4",
     "--client-qps", "10", "--client-burst", "3"],
    ["--max-inflight", "64", "--client-enforce-at", "0.7", "--shed-retry-after-seconds", "0.2",
     "--tuner-interval-seconds", "0.5", "--tuner-burn-window-seconds", "10",
     "--tuner-min-batch", "8", "--tuner-max-batch", "4096", "--tuner-min-linger-us", "10"],
]


@pytest.mark.parametrize("argv", range(len(ARGV)))
def test_overload_flags_equal_jax(argv):
    t = t_cli.make_parser().parse_args(ARGV[argv])
    j = j_cli.make_parser().parse_args(ARGV[argv])
    assert {f: getattr(t, f) for f in OVERLOAD_FLAGS} == {f: getattr(j, f) for f in OVERLOAD_FLAGS}
    assert t_cli._client_enforce_at(t) == j_cli._client_enforce_at(j)
    # the same controller from the same flags
    if t.max_inflight > 0:
        assert t_cli._load_controller(t).stats() == jload.AdmissionController(
            max_inflight=j.max_inflight, shed_sheddable_at=j.shed_sheddable_at,
            shed_normal_at=j.shed_normal_at, client_qps=j.client_qps,
            client_burst=j.client_burst, client_enforce_at=j_cli._client_enforce_at(j),
            retry_after_s=j.shed_retry_after_seconds).stats()
    else:
        assert t_cli._load_controller(t) is None


def test_overload_help_group():
    t_groups = {g.title: {a.dest for a in g._group_actions}
                for g in t_cli.make_parser()._action_groups}
    j_groups = {g.title: {a.dest for a in g._group_actions}
                for g in j_cli.make_parser()._action_groups}
    assert t_groups["overload control"] == j_groups["overload control"] == set(OVERLOAD_FLAGS)


@pytest.mark.parametrize("flags,want", [
    ((), 8192),
    (("--max-batch", "64"), 64),
    (("--max-batch", "64", "--adaptive-batching"), 16384),
    (("--max-batch", "64", "--adaptive-batching", "--tuner-max-batch", "4096"), 4096),
    (("--max-batch", "9000", "--adaptive-batching", "--tuner-max-batch", "4096"), 9000),
    (("--max-batch", "64", "--adaptive-batching", "--tuner-max-batch", "65536"), 32768),
])
def test_warm_top_is_the_tuners_clamp(flags, want):
    assert t_cli._warm_top(t_cli.make_parser().parse_args(list(flags))) == want


def _cfg(tmp_path):
    d = tmp_path / "policies"
    d.mkdir()
    (d / "demo.cedar").write_text(DEMO_POLICY)
    cfg = tmp_path / "store-config.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(d)}}]}}))
    return cfg


def test_adaptive_batching_without_slo_refused_before_threads(tmp_path):
    cfg = _cfg(tmp_path)
    before = {t.ident for t in threading.enumerate()}
    args = t_cli.make_parser().parse_args([
        "--config", str(cfg), "--device", "cpu", "--insecure", "--secure-port", "0",
        "--metrics-port", "0", "--adaptive-batching", "--slo-availability-target", "0"])
    with pytest.raises(ValueError, match="--adaptive-batching requires the SLO tracker"):
        t_cli.build_server(args)
    assert {t.ident for t in threading.enumerate()} <= before


def test_cli_server_wires_gate_and_tuners(tmp_path):
    """A CPU server built with the plane: the gate with the flags' sizes,
    one tuner per batcher of the fast paths, each supervised as
    tuner.<path> and on /debug/load; every answer of the idle gate equals
    a plain server's, and stop() stops the tuners."""
    cfg = _cfg(tmp_path)
    base = ["--config", str(cfg), "--device", "cpu", "--insecure", "--secure-port", "0",
            "--metrics-port", "0", "--decision-cache-size", "0"]
    plane = ["--max-inflight", "64", "--client-qps", "5", "--adaptive-batching",
             "--max-batch", "64", "--tuner-max-batch", "4096", "--tuner-interval-seconds", "0.05"]
    srv = t_cli.build_server(t_cli.make_parser().parse_args(base + plane))
    plain = t_cli.build_server(t_cli.make_parser().parse_args(base))
    srv.start()
    plain.start()
    try:
        assert srv.reloader.max_batch == plain.reloader.max_batch == 1  # the CPU: one bucket
        assert srv.load.max_inflight == 64 and srv.load.client_qps == 5.0
        assert [t.path for t in srv.tuners] == ["authorization", "admission"]
        assert plain.load is None and plain.tuners == []
        comps = srv.supervisor.status()["components"]
        assert {"tuner.authorization", "tuner.admission"} <= set(comps)
        for t in srv.tuners:
            assert t.bounds.max_batch == 4096 and t.home_batch == 64
            assert t._thread.is_alive()
        for path, body in TRAFFIC:
            assert _post(srv.bound_port, path, body)[:2] == _post(plain.bound_port, path, body)[:2]
        doc = json.loads(_get(srv.bound_metrics_port, "/debug/load")[1])
        assert set(doc["tuning"]) == {"authorization", "admission"}
        assert doc["admission_control"]["offered"] == len(TRAFFIC)
        assert _get(srv.bound_metrics_port, "/readyz") == (200, b"ok", "ok")
    finally:
        srv.stop()
        plain.stop()
    assert all(not t._thread.is_alive() for t in srv.tuners)


def test_chip_smoke_storm_fires_only_once_every_client_connected():
    """chip_smoke.py phase 16's open-loop load generator (storm): its schedule's
    clock starts only once every client process has started and opened
    its keep-alive pool, so a slow start delays the storm and not its
    arrivals. Over a local HTTP server that stamps each accepted
    connection and each request: every initial connection was accepted
    before the first request came, every arrival is answered once, in
    order, with its fire lag and whether it opened a connection."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import chip_smoke

    accepts, requests = [], []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def setup(self):
            accepts.append(time.monotonic())
            super().setup()

        def do_POST(self):
            requests.append(time.monotonic())
            self.rfile.read(int(self.headers["Content-Length"]))
            body = json.dumps({"path": self.path}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        bodies = {"sar": ("/v1/authorize", b"{}"), "adm": ("/v1/admit", b"{}")}
        schedule = [(i * 0.004, "sar" if i % 3 else "adm") for i in range(200)]
        records, opened = chip_smoke.storm(srv.server_address[1], schedule, bodies,
                                           n_procs=2, n_conns=4)
    finally:
        srv.shutdown()
        srv.server_close()
    assert opened >= 8 and len(accepts) == opened
    assert sorted(accepts)[7] < min(requests)
    assert [r[0] for r in records] == list(range(len(schedule)))
    for (_due, key), rec in zip(schedule, records):
        assert len(rec) == 9 and rec[1] == 200 and rec[6] is None
        assert json.loads(rec[2]) == {"path": bodies[key][0]}
        assert isinstance(rec[8], bool)
