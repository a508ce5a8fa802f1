"""The port's resilience layer (cedar_tpu_torch: engine/breaker.py,
server/supervisor.py, the batchers' revive, the engine's rebuild, the
server's breaker posture) against the JAX package's, on the CPU, at
tolerance 0 (equal states, counts and documents).

What is held equal: the breaker's state after every step of scripted
allow / record_success / record_failure / force_open / half_open_now
sequences under one FakeClock, and its transition counts; the
supervisor's check_once outcomes (dead threads, wedged and idle
heartbeats, cooldown, failing restarts); the device-loss classifier on
the JAX markers; DeviceRecovery's rebuilds, failures, coalescing and
breaker state over a stub engine; a port and a JAX server under one
engine.dispatch fault scenario, request by request.

What only the port promises, checked directly: an open breaker or a
failed batch answers the failure posture and re-runs nothing on the
interpreter (JAX answers from the interpreter there, and the tests
assert that difference); rebuild_compiled gives byte-identical answers,
steps the generation and never publishes over a load; a failed batch's
staging comes back (outstanding 0 at rest); a killed stage is revived
with every request answered.
"""

import gc
import json
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from cedar_tpu.chaos import registry as j_chaos
from cedar_tpu.engine import breaker as j_breaker
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import AdmissionFastPath as JAdmissionFastPath
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.server import admission as j_adm
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.server import supervisor as j_sup
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores import store as j_store
from cedar_tpu_torch.chaos import registry as t_chaos
from cedar_tpu_torch.chaos.scenario import builtin_scenario
from cedar_tpu_torch.engine import breaker as t_breaker
from cedar_tpu_torch.engine.batcher import PipelinedBatcher
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import AdmissionFastPath, SARFastPath
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.server import admission as t_adm
from cedar_tpu_torch.server import supervisor as t_sup
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.http import WebhookServer
from cedar_tpu_torch.server.metrics import WebhookMetrics, process_metrics
from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

POLICIES = """
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
permit (principal in k8s::Group::"viewers", action == k8s::Action::"get",
        resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal, action, resource is k8s::Resource)
  when { resource.resource == "nodes" };
"""
ADM_POLICIES = """
forbid (principal, action == k8s::admission::Action::"delete", resource);
forbid (principal, action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when { resource has metadata.labels && resource.metadata.labels.contains({"key": "env", "value": "prod"}) };
"""


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _pristine_registries():
    """Both packages' chaos registries are module globals: every test
    starts and ends disarmed and unconfigured."""
    t_chaos.default_registry().reset()
    j_chaos.default_registry().reset()
    yield
    t_chaos.default_registry().reset()
    j_chaos.default_registry().reset()


def sar(user="sam", verb="get", resource="pods", groups=()) -> bytes:
    return json.dumps({
        "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
        "spec": {"user": user, "uid": "u", "groups": list(groups),
                 "resourceAttributes": {"verb": verb, "resource": resource,
                                        "version": "v1", "namespace": "default"}},
    }).encode()


def review(op="CREATE", kind="ConfigMap", labels=None, uid="r1") -> bytes:
    obj = {"apiVersion": "v1", "kind": kind,
           "metadata": {"name": "x", "namespace": "default", "labels": labels or {}}}
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
        "request": {
            "uid": uid, "kind": {"group": "", "version": "v1", "kind": kind},
            "resource": {"group": "", "version": "v1", "resource": kind.lower() + "s"},
            "namespace": "default", "operation": op, "name": "x",
            "userInfo": {"username": "sam", "uid": "u", "groups": []},
            "object": None if op == "DELETE" else obj,
            "oldObject": obj if op == "DELETE" else None,
        },
    }).encode()


def jax_native_ready(wait_s: float = 120.0) -> bool:
    """Load the JAX package's native library in this process (a pytest
    worker that lost its build race clears the cached failure and loads
    the winner's build)."""
    from cedar_tpu import native as jnative

    deadline = time.monotonic() + wait_s
    while not jnative.native_available():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        jnative._lib_error = None
    return True


def _transitions(counter, name: str) -> dict:
    """{to state: count} of one engine's breaker transitions."""
    out = {}
    for key, v in counter._values.items():
        d = dict(key)
        if d.get("engine") == name and v:
            out[d["to"]] = out.get(d["to"], 0) + v
    return out


# ------------------------------------------------------------------ breaker

# each step: (op, argument); "tick" advances the shared clock
BREAKER_SCRIPTS = {
    "trips-on-consecutive-failures": [("failure", None)] * 3 + [("allow", None)],
    "success-resets-streak": [("failure", None), ("failure", None), ("success", 0.001),
                              ("failure", None), ("failure", None), ("allow", None)],
    "half-open-then-closes": [("failure", None)] * 3 + [
        ("allow", None), ("tick", 10.0), ("allow", None), ("success", 0.001),
        ("success", 0.001), ("allow", None)],
    "probe-failure-reopens": [("failure", None)] * 3 + [
        ("tick", 10.0), ("allow", None), ("failure", None), ("tick", 9.9), ("allow", None),
        ("tick", 0.2), ("allow", None)],
    "latency-breaches-trip": [("success", 0.9), ("success", 0.9), ("allow", None)],
    "fast-success-resets-breaches": [("success", 0.9), ("success", 0.1), ("success", 0.9),
                                     ("allow", None)],
    "half-open-latency-breach-reopens": [("failure", None)] * 3 + [
        ("tick", 10.0), ("allow", None), ("success", 0.9)],
    "force-open-and-half-open-now": [
        ("force_open", None), ("allow", None), ("half_open_now", None), ("allow", None),
        ("success", 0.001), ("success", 0.001), ("force_open", None), ("tick", 3.0),
        ("half_open_now", None), ("failure", None)],
    "half-open-now-when-closed-is-a-no-op": [("half_open_now", None), ("failure", None),
                                             ("half_open_now", None), ("allow", None)],
    "lazy-decay-on-state-read": [("force_open", None), ("tick", 10.0), ("state", None),
                                 ("success", 0.001), ("tick", 100.0), ("success", 0.001)],
    "open-ignores-outcomes-until-decay": [("force_open", None), ("failure", None),
                                          ("success", 0.001), ("tick", 9.0), ("allow", None),
                                          ("tick", 1.0), ("failure", None), ("allow", None)],
}
_BREAKER_KW = {"failure_threshold": 3, "recovery_s": 10.0, "half_open_probes": 2,
               "latency_threshold_s": 0.5, "latency_breach_threshold": 2}


@pytest.mark.parametrize("script", sorted(BREAKER_SCRIPTS))
def test_breaker_script_equals_jax(script):
    """Same clock, same steps: the same state after every step, the same
    allow() answers and the same transition counts."""
    name = f"script-{script}"
    clock = FakeClock()
    jb = j_breaker.CircuitBreaker(name=name, clock=clock, **_BREAKER_KW)
    tb = t_breaker.CircuitBreaker(name=name, clock=clock, **_BREAKER_KW)
    for op, arg in BREAKER_SCRIPTS[script]:
        if op == "tick":
            clock.advance(arg)
            continue
        outs = []
        for b in (jb, tb):
            if op == "allow":
                outs.append(b.allow())
            elif op == "success":
                outs.append(b.record_success(arg))
            elif op == "failure":
                outs.append(b.record_failure())
            elif op == "state":
                outs.append(b.state)
            else:
                outs.append(getattr(b, op)())
        assert outs[0] == outs[1], (op, outs)
        assert tb.state == jb.state, (op, tb.state, jb.state)
    assert _transitions(process_metrics().breaker_transitions_total, name) == _transitions(
        j_metrics.breaker_transitions_total, name)


def test_breaker_state_gauge_on_every_servers_metrics():
    """The breaker families are process-wide, as in JAX: any server's
    /metrics shows them."""
    t_breaker.CircuitBreaker(name="gauge-test", clock=FakeClock()).force_open()
    text = WebhookMetrics().expose()
    assert 'cedar_authorizer_breaker_state{engine="gauge-test"} 1' in text
    assert 'cedar_authorizer_breaker_transitions_total{engine="gauge-test",to="open"} 1' in text
    assert "cedar_device_rebuilds_total 0" in text or "cedar_device_rebuilds_total " in text


def test_guarded_call_never_calls_a_fallback():
    """The port's guard: an open breaker raises BreakerOpen without the
    call (one breaker_open count); a raising call feeds the breaker and
    the observer and re-raises (one evaluator_error count); a success
    records its latency. No argument names a fallback."""
    import inspect

    assert "fallback_call" not in inspect.signature(t_breaker.guarded_call).parameters
    clock = FakeClock()
    br = t_breaker.CircuitBreaker(name="guard", failure_threshold=1, clock=clock)
    m = WebhookMetrics()
    seen, calls = [], []

    def boom():
        calls.append("device")
        raise RuntimeError("UNAVAILABLE: lost")

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        t_breaker.guarded_call(br, boom, "authorization", on_error=seen.append, metrics=m)
    assert br.state == t_breaker.OPEN and len(seen) == 1 and calls == ["device"]
    assert m.fallback_batches_total.value(path="authorization", reason="evaluator_error") == 1
    with pytest.raises(t_breaker.BreakerOpen, match="device breaker open"):
        t_breaker.guarded_call(br, boom, "authorization", metrics=m)
    assert calls == ["device"]
    assert m.fallback_batches_total.value(path="authorization", reason="breaker_open") == 1
    clock.advance(10.0)
    assert t_breaker.guarded_call(br, lambda: 7, "authorization", metrics=m) == 7
    assert br.state == t_breaker.HALF_OPEN


# --------------------------------------------------------------- supervisor


def _dead_thread():
    t = threading.Thread(target=lambda: None, name="worker-x")
    t.start()
    t.join()
    return t


def _sup_outcomes(mod, case):
    """Drive one supervisor case on package ``mod``; returns what it saw."""
    clock = FakeClock()
    sup = mod.Supervisor(interval_s=1.0, wedge_budget_s=10.0, clock=clock)
    out = []
    if case == "dead-thread-cooldown":
        dead = _dead_thread()
        calls = []
        sup.register("c", threads=lambda: [dead], restart=lambda r: calls.append(r) or True)
        out.append(sup.check_once())
        out.append(sup.check_once())  # cooldown
        clock.advance(10.0)
        out.append(sup.check_once())
        out.append(calls)
    elif case == "wedged-heartbeat":
        release = threading.Event()
        live = threading.Thread(target=release.wait, daemon=True, name="live")
        live.start()
        hb = mod.Heartbeat(clock=clock)
        hb.busy()
        reasons = []
        sup.register("w", threads=lambda: [live], restart=lambda r: reasons.append(r) or True,
                     heartbeat=hb)
        out.append(sup.check_once())
        clock.advance(11.0)
        out.append(sup.check_once())
        out.append(reasons)
        release.set()
    elif case == "idle-heartbeat":
        hb = mod.Heartbeat(clock=clock)
        hb.idle()
        clock.advance(1e6)
        sup.register("i", threads=lambda: [], restart=lambda r: True, heartbeat=hb)
        out.append(sup.check_once())
        out.append(hb.is_wedged(1.0))
    elif case == "heartbeat-group":
        beats = {"a": mod.Heartbeat(clock=clock), "b": mod.Heartbeat(clock=clock)}
        beats["a"].idle()
        beats["b"].busy()
        clock.advance(20.0)
        group = mod.HeartbeatGroup(lambda: beats)
        out.append(group.is_wedged(10.0))
        out.append(group.snapshot())
        sup.register("g", threads=lambda: [], restart=lambda r: False, heartbeat=group)
        out.append(sup.check_once())
    elif case == "failing-restart":
        dead = _dead_thread()

        def bad(reason):
            raise RuntimeError("revive exploded")

        sup.register("b", threads=lambda: [dead], restart=bad)
        out.append(sup.check_once())
        clock.advance(2.0)
        out.append(sup.check_once())
    elif case == "restart-returns-false":
        dead = _dead_thread()
        sup.register("n", threads=lambda: [dead], restart=lambda r: False)
        out.append(sup.check_once())
    elif case == "sick-probe":
        def probe():
            raise RuntimeError("probe exploded")

        sup.register("p", threads=probe, restart=lambda r: True)
        out.append(sup.check_once())
    st = sup.status()
    out.append({k: {kk: vv for kk, vv in v.items() if kk != "heartbeat"}
                for k, v in st["components"].items()})
    out.append((st["checks"], st["interval_s"]))
    return out


SUP_CASES = ["dead-thread-cooldown", "wedged-heartbeat", "idle-heartbeat", "heartbeat-group",
             "failing-restart", "restart-returns-false", "sick-probe"]


@pytest.mark.parametrize("case", SUP_CASES)
def test_supervisor_check_once_equals_jax(case):
    assert _sup_outcomes(t_sup, case) == _sup_outcomes(j_sup, case)


def test_supervisor_restart_metric():
    before = process_metrics().supervisor_restarts_total.value(component="metric-c")
    sup = t_sup.Supervisor(interval_s=1.0, clock=FakeClock())
    dead = _dead_thread()
    sup.register("metric-c", threads=lambda: [dead], restart=lambda r: True)
    sup.check_once()
    assert process_metrics().supervisor_restarts_total.value(component="metric-c") == before + 1
    assert 'cedar_supervisor_restarts_total{component="metric-c",replica=""}' in (
        WebhookMetrics().expose())


JAX_MARKER_TEXTS = [
    "UNAVAILABLE: socket closed", "DATA_LOSS: x", "INTERNAL: boom", "ABORTED: y",
    "device lost", "Device lost (game day)", "device is in an invalid state",
    "Socket closed", "Connection reset by peer", "failed to connect to all addresses",
    "XlaRuntimeError: whatever", "RESOURCE_EXHAUSTED: out of HBM", "policy id missing",
    "bad literal",
]


@pytest.mark.parametrize("text", JAX_MARKER_TEXTS)
def test_fatal_classifier_agrees_with_jax_on_its_markers(text):
    for exc in (RuntimeError(text), OSError(text)):
        assert t_sup.is_fatal_device_error(exc) == j_sup.is_fatal_device_error(exc)
    assert t_sup.is_fatal_device_error(j_chaos.ChaosError(f"engine.dispatch: {text}")) == (
        j_sup.is_fatal_device_error(j_chaos.ChaosError(f"engine.dispatch: {text}")))


CUDA_FATAL_TEXTS = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered",
    "CUDA error: unspecified launch failure",
    "CUDA driver error: unknown error",
    "cudaErrorLaunchFailure",
    "match_words_kernel launch failed: error 700 (an illegal memory access was encountered)",
    "match_groups_kernel launch failed: error 719 (unspecified launch failure)",
    "CUDA error: uncorrectable ECC error encountered",
]


@pytest.mark.parametrize("text", CUDA_FATAL_TEXTS)
def test_fatal_classifier_reads_cuda_faults(text):
    assert t_sup.is_fatal_device_error(RuntimeError(text))


def test_fatal_classifier_types():
    import torch

    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert not t_sup.is_fatal_device_error(oom)
    assert not t_sup.is_fatal_device_error(KeyError("policy0"))
    assert not t_sup.is_fatal_device_error(ValueError("invalid argument"))
    assert not t_sup.is_fatal_device_error(None)
    acc = getattr(torch, "AcceleratorError", None)
    if acc is not None:  # this torch raises CUDA errors as AcceleratorError
        assert t_sup.is_fatal_device_error(acc("an opaque CUDA message"))


class _StubEngine:
    """A DeviceRecovery target for both packages: counts rebuilds."""

    def __init__(self, ok=True, gate=None):
        self.ok = ok
        self.rebuilt = 0
        self.gate = gate

    def rebuild_compiled(self, max_batch=None):
        if self.gate is not None:
            self.gate.wait(10)
        if not self.ok:
            raise RuntimeError("rebuild exploded")
        self.rebuilt += 1
        return {"generation": self.rebuilt}

    def warmup(self, max_batch=None):
        return {}


def _wait(pred, timeout=10.0):
    """Poll a condition another thread brings about (a thread's result
    has no event to wait on)."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def _recovery_outcome(mod_sup, mod_breaker, case):
    """(what one DeviceRecovery case saw, its breaker's name)."""
    name = f"rec-{case}-{mod_sup.__name__.split('.')[0]}"
    breaker = mod_breaker.CircuitBreaker(name=name, failure_threshold=100, recovery_s=3600.0)
    gate = threading.Event() if case == "coalesce" else None
    engine = _StubEngine(ok=case != "failed-rebuild", gate=gate)
    rec = mod_sup.DeviceRecovery(engine, breaker=breaker, warm=False, cooldown_s=60.0)
    out = []
    if case == "non-fatal":
        out.append(rec.observe(ValueError("evaluation bug")))
    elif case == "coalesce":
        barrier = threading.Barrier(8)
        observed = []

        def fatal(i):
            barrier.wait()
            observed.append(rec.observe(RuntimeError(f"UNAVAILABLE: burst {i}")))

        threads = [threading.Thread(target=fatal, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        gate.set()
        assert _wait(lambda: rec.rebuilds == 1 and not rec.rebuilding)
        out.append(observed)
        out.append(rec.observe(RuntimeError("UNAVAILABLE: straggler")))
    else:
        out.append(rec.observe(RuntimeError("UNAVAILABLE: device lost")))
        assert _wait(lambda: (rec.rebuilds or rec.failures) and not rec.rebuilding)
    out.append((rec.rebuilds, rec.failures, engine.rebuilt, breaker.state))
    return out, name


@pytest.mark.parametrize("case", ["non-fatal", "fatal", "failed-rebuild", "coalesce"])
def test_device_recovery_equals_jax(case):
    """Rebuilds, failures, coalescing (eight racing fatals: one rebuild,
    and a straggler inside the cooldown none) and the breaker: equal, and
    the same breaker transitions."""
    t, t_name = _recovery_outcome(t_sup, t_breaker, case)
    j, j_name = _recovery_outcome(j_sup, j_breaker, case)
    assert t == j
    assert _transitions(process_metrics().breaker_transitions_total, t_name) == (
        _transitions(j_metrics.breaker_transitions_total, j_name))


def test_device_recovery_rebuild_counts_metric_and_status():
    before = process_metrics().device_rebuilds_total.value()
    rec = t_sup.DeviceRecovery(_StubEngine(), name="status", warm=False)
    assert rec.rebuild_now() is True
    assert process_metrics().device_rebuilds_total.value() == before + 1
    st = rec.status()
    assert (st["rebuilds"], st["failures"], st["last_rebuild"]) == (1, 0, {"generation": 1})


# ---------------------------------------------------------- engine rebuild


def _engine_and_traffic():
    from cedar_tpu_torch.corpus.synth import synth_corpus

    corpus = synth_corpus(60, seed=5)
    engine = TorchPolicyEngine(device="cpu")
    engine.load(corpus.tiers(), max_batch=1)
    rng = np.random.default_rng(3)
    cs = engine.compiled_set
    codes = rng.integers(0, cs.act_rows_dev.shape[0], size=(40, cs.packed.table.n_slots),
                         dtype=np.int32)
    extras = np.full((40, 4), cs.L, dtype=np.int32)
    return engine, codes, extras


def _answers(engine, codes, extras):
    words, _ = engine.match_arrays(codes, extras)
    _, (first, last) = engine.match_arrays(codes, extras, want_full=True)
    bits = engine.match_bits_arrays(codes, extras)
    return words.tobytes(), first.tobytes(), last.tobytes(), bits.tobytes()


def test_rebuild_compiled_is_byte_identical_and_steps_the_generation():
    engine, codes, extras = _engine_and_traffic()
    before = _answers(engine, codes, extras)
    old = engine.compiled_set
    old.host_state["probe"] = ("encoder", {}, {})
    gen = engine.load_generation
    stats = engine.rebuild_compiled(max_batch=8)
    new = engine.compiled_set
    assert new is not old and engine.load_generation == gen + 1
    assert stats["generation"] == gen + 1 and set(stats["seconds"]) == {"place", "warm", "total"}
    assert engine.stats["last_rebuild"]["generation"] == gen + 1
    # fresh device allocations and maps; the host state moved across
    assert new.Wt_dev.data_ptr() != old.Wt_dev.data_ptr()
    assert new.plane_maps is not old.plane_maps
    assert new.host_state["probe"] is old.host_state["probe"]
    assert new.packed is old.packed
    assert _answers(engine, codes, extras) == before
    # the old set is freed once nothing holds it
    ref = weakref.ref(old)
    del old
    gc.collect()
    assert ref() is None


def test_rebuild_with_nothing_loaded_returns_none():
    assert TorchPolicyEngine(device="cpu").rebuild_compiled() is None


def test_rebuild_waits_for_a_load_and_never_reverts_it():
    """A rebuild that starts while a load is running waits for it (the
    load lock) and re-places the set the load published: the policy edit
    stays."""
    engine = TorchPolicyEngine(device="cpu")
    engine.load([PolicySet.from_source(POLICIES, "v1")])
    in_load, release = threading.Event(), threading.Event()

    def hold(cs):
        in_load.set()
        release.wait(10)

    engine.load_hooks.append(hold)
    edited = POLICIES.replace('resource.resource == "nodes"', 'resource.resource == "pods"')
    loader = threading.Thread(target=engine.load, args=([PolicySet.from_source(edited, "v2")],))
    loader.start()
    assert in_load.wait(10)
    result = []
    rebuild_thread = threading.Thread(target=lambda: result.append(engine.rebuild_compiled()))
    rebuild_thread.start()
    rebuild_thread.join(0.2)
    assert rebuild_thread.is_alive()  # blocked behind the load
    engine.load_hooks.remove(hold)
    release.set()
    loader.join(10)
    rebuild_thread.join(10)
    assert result[0]["generation"] == 3 and engine.load_generation == 3
    forbids = [m.policy_id for m in engine.compiled_set.policy_meta]
    assert engine.compiled_set.packed.policy_meta[-1].filename == "v2"
    assert len(forbids) == 3


def test_load_waits_for_a_rebuild_and_stays_published():
    """A load that lands during a rebuild waits for it, then publishes
    on top: the rebuild's set never replaces the newer one."""
    engine = TorchPolicyEngine(device="cpu")
    engine.load([PolicySet.from_source(POLICIES, "v1")])
    in_rebuild, release = threading.Event(), threading.Event()

    def hold(cs):
        in_rebuild.set()
        release.wait(10)

    engine.load_hooks.append(hold)
    rebuild_thread = threading.Thread(target=engine.rebuild_compiled)
    rebuild_thread.start()
    assert in_rebuild.wait(10)
    engine.load_hooks.remove(hold)
    loader = threading.Thread(
        target=engine.load, args=([PolicySet.from_source(POLICIES, "v2")],))
    loader.start()
    loader.join(0.2)
    assert loader.is_alive()
    release.set()
    rebuild_thread.join(10)
    loader.join(10)
    assert engine.load_generation == 3
    assert engine.compiled_set.packed.policy_meta[0].filename == "v2"


def test_rebuild_does_not_publish_when_the_set_changed_under_it():
    """The publish re-checks that the set it re-placed is still current
    (belt and braces behind the load lock)."""
    engine = TorchPolicyEngine(device="cpu")
    engine.load([PolicySet.from_source(POLICIES, "v1")])
    other = TorchPolicyEngine(device="cpu")
    other.load([PolicySet.from_source(POLICIES, "v2")])

    def swap(cs):
        engine._compiled = other.compiled_set

    engine.load_hooks.append(swap)
    gen = engine.load_generation
    assert engine.rebuild_compiled() is None
    assert engine.load_generation == gen and engine.compiled_set is other.compiled_set


# -------------------------------------------------- staging after failures


def _sar_stack(breaker=None):
    ps = PolicySet.from_source(POLICIES, "p")
    engine = TorchPolicyEngine(device="cpu")
    engine.load([ps])
    stores = TieredPolicyStores([MemoryStore("p", ps)])
    authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    return engine, SARFastPath(engine, authz, breaker=breaker)


@pytest.mark.parametrize("seam", ["engine.encode", "engine.dispatch", "engine.decode"])
def test_failed_batch_in_each_stage_returns_its_staging(seam):
    """A batch that fails in encode, dispatch or decode answers its error
    and hands its staging back: outstanding is 0 at rest."""
    engine, fast = _sar_stack()
    b = PipelinedBatcher(fast, depth=2, encode_workers=1)
    reg = t_chaos.default_registry()
    try:
        reg.configure({"faults": [{"seam": seam, "kind": "error", "count": 2}]})
        reg.arm()
        for _ in range(2):
            with pytest.raises(RuntimeError, match="batch evaluation failed"):
                b.submit(sar(), timeout=30)
        reg.disarm()
        assert b.submit(sar(), timeout=30)[0] == "allow"
        st = engine.staging_stats()
        assert (st["outstanding"], st["pending"], st["retired"]) == (0, 0, 0)
        assert st["acquires"] > 0
    finally:
        b.stop()


def test_failed_serial_batch_returns_its_staging():
    engine, fast = _sar_stack()
    reg = t_chaos.default_registry()
    reg.configure({"faults": [{"seam": "engine.decode", "kind": "error", "count": 1}]})
    reg.arm()
    with pytest.raises(t_chaos.ChaosError):
        fast.authorize_raw([sar(), sar("bob")])
    assert engine.staging_stats()["outstanding"] == 0


def test_release_after_device_on_the_cpu_is_immediate():
    from cedar_tpu_torch.engine.evaluator import _StagingPool

    import torch

    pool = _StagingPool(pinned=False)
    a = pool.acquire((4, 2), np.int32)
    pool.release_after_device([a], torch.device("cpu"))
    st = pool.stats()
    assert (st["outstanding"], st["pending"]) == (0, 0)
    b = pool.acquire((4, 2), np.int32)
    assert b is a
    pool.retire(b)
    assert pool.stats()["retired"] == 1 and pool.stats()["outstanding"] == 0


# ----------------------------------------------------- the server pairs


@pytest.fixture(scope="module")
def pair_engines():
    """One port engine and one JAX engine per endpoint, over the same
    policies (no gated scope: one engine.dispatch fire per batch)."""
    assert jax_native_ready()
    ps_src = POLICIES + ADM_POLICIES
    t_ps = PolicySet.from_source(ps_src, "p")
    t_stores = TieredPolicyStores([MemoryStore("p", t_ps)])
    t_adm_stores = TieredPolicyStores(
        list(t_stores.stores) + [t_adm.allow_all_admission_policy_store()])
    from cedar_tpu.lang import PolicySet as JPolicySet

    j_ps = JPolicySet.from_source(ps_src, "p")
    j_stores = j_store.TieredPolicyStores([j_store.MemoryStore("p", j_ps)])
    j_adm_stores = j_store.TieredPolicyStores(
        list(j_stores.stores) + [j_adm.allow_all_admission_policy_store()])
    t_eng, t_adm_eng = TorchPolicyEngine(device="cpu"), TorchPolicyEngine(device="cpu")
    t_eng.load([s.policy_set() for s in t_stores])
    t_adm_eng.load([s.policy_set() for s in t_adm_stores])
    j_eng, j_adm_eng = TPUPolicyEngine(), TPUPolicyEngine()
    j_eng.load([s.policy_set() for s in j_stores], warm="off")
    j_adm_eng.load([s.policy_set() for s in j_adm_stores], warm="off")
    return {"t": (t_eng, t_adm_eng, t_stores, t_adm_stores),
            "j": (j_eng, j_adm_eng, j_stores, j_adm_stores)}


def _pair(pair_engines, clock, threshold=2, recovery=5.0, timeout_s=30.0, **kw):
    """(JAX server, port server), each with a breaker per endpoint under
    ``clock``. The JAX authorizer and handler are the pure interpreter,
    as its CLI's fallback is; the port's evaluate on its engines."""
    t_eng, t_adm_eng, t_stores, t_adm_stores = pair_engines["t"]
    j_eng, j_adm_eng, j_stores, j_adm_stores = pair_engines["j"]
    uid = f"{time.monotonic_ns()}"
    brk = {}
    for pkg, mod in (("t", t_breaker), ("j", j_breaker)):
        for path in ("authorization", "admission"):
            brk[pkg, path] = mod.CircuitBreaker(
                name=f"pair-{path}-{uid}", failure_threshold=threshold, recovery_s=recovery,
                clock=clock)
    t_authz = CedarWebhookAuthorizer(t_stores, evaluate_batch=t_eng.evaluate_batch)
    t_handler = t_adm.CedarAdmissionHandler(t_adm_stores,
                                            evaluate_batch=t_adm_eng.evaluate_batch)
    t_srv = WebhookServer(
        t_authz, address="127.0.0.1", port=0, metrics_port=0,
        fastpath=SARFastPath(t_eng, t_authz, breaker=brk["t", "authorization"]),
        admission_handler=t_handler,
        admission_fastpath=AdmissionFastPath(t_adm_eng, t_handler,
                                             breaker=brk["t", "admission"]),
        pipeline_depth=2, request_timeout_s=timeout_s, **kw)
    j_authz = j_auth.CedarWebhookAuthorizer(j_stores)
    j_handler = j_adm.CedarAdmissionHandler(j_adm_stores)
    j_srv = JWebhookServer(
        j_authz, j_handler, address="127.0.0.1", port=0, metrics_port=0,
        fastpath=JSARFastPath(j_eng, j_authz, breaker=brk["j", "authorization"]),
        admission_fastpath=JAdmissionFastPath(j_adm_eng, j_handler,
                                              breaker=brk["j", "admission"]),
        pipeline_depth=2, request_timeout_s=timeout_s)
    return j_srv, t_srv, brk


# one request per step; "tick" advances the breakers' clock
PAIR_SCRIPT = (["req"] * 6 + ["tick"] + ["req"] * 2 + ["tick"] + ["req"] * 5)
# calls 2, 3 and 4 of engine.dispatch fail: two trip the breaker (the
# threshold), the third fails the first half-open probe
DISPATCH_FAULT = {"name": "pair", "seed": 3, "faults": [
    {"seam": "engine.dispatch", "kind": "error", "after": 2, "count": 3,
     "message": "injected dispatch fault"}]}


def _run_pair_script(pair_engines, endpoint, bodies, handle):
    clock = FakeClock()
    j_srv, t_srv, brk = _pair(pair_engines, clock)
    path = "authorization" if endpoint == "authorize" else "admission"
    jb, tb = brk["j", path], brk["t", path]
    for reg in (t_chaos.default_registry(), j_chaos.default_registry()):
        reg.configure(DISPATCH_FAULT)
        reg.arm()
    steps = []
    try:
        k = 0
        for step in PAIR_SCRIPT:
            if step == "tick":
                clock.advance(5.0)
                continue
            body = bodies[k % len(bodies)]
            k += 1
            state = jb.state  # the JAX breaker as this request arrives
            want = handle(j_srv, body)
            got = handle(t_srv, body)
            assert tb.state == jb.state, (k, tb.state, jb.state)
            steps.append((state, want, got))
        t_calls = t_chaos.default_registry().stats()["seams"]["engine.dispatch"]["calls"]
        j_calls = j_chaos.default_registry().stats()["seams"]["engine.dispatch"]["calls"]
        assert t_calls == j_calls
        assert _transitions(process_metrics().breaker_transitions_total, tb.name) == (
            _transitions(j_metrics.breaker_transitions_total, jb.name))
        return steps, t_srv
    finally:
        j_srv.stop()
        t_srv.stop()


def test_server_pair_under_dispatch_faults_authorize(pair_engines):
    """Same scenario, same request order: both breakers take the same
    transitions. Where the JAX breaker is closed and the batch served,
    the answers are equal; every other port answer is the posture
    (NoOpinion with an evaluationError naming the cause), where JAX
    answered from its interpreter, never a different decision."""
    bodies = [sar(), sar("bob", resource="nodes"), sar("eve"), sar("v", groups=["viewers"])]
    steps, t_srv = _run_pair_script(
        pair_engines, "authorize", bodies, lambda s, b: json.dumps(s.handle_authorize(b)))
    kinds = {"equal": 0, "failed": 0, "open": 0}
    for state, want, got in steps:
        w, g = json.loads(want)["status"], json.loads(got)["status"]
        assert "evaluationError" not in w  # JAX always has an answer
        if g == w:
            kinds["equal"] += 1
            continue
        assert (g["allowed"], g["denied"], g["reason"]) == (False, False, "")
        if state == "open":
            assert g["evaluationError"] == "evaluation error: device breaker open"
            kinds["open"] += 1
        else:
            assert "injected dispatch fault" in g["evaluationError"]
            kinds["failed"] += 1
    # two failures trip it, two requests while open, a failed probe, one
    # more while open, two probes that close it, three served closed
    assert kinds == {"equal": 7, "failed": 3, "open": 3}
    m = t_srv.metrics.fallback_batches_total
    assert m.value(path="authorization", reason="evaluator_error") == 3
    assert m.value(path="authorization", reason="breaker_open") == 3


def test_server_pair_under_dispatch_faults_admit(pair_engines):
    """The same on /v1/admit: the posture is the fail-mode (allowed,
    code 500, the error)."""
    bodies = [review(), review(labels={"env": "prod"}, uid="r2"), review("DELETE", uid="r3"),
              review(kind="Secret", uid="r4")]
    steps, t_srv = _run_pair_script(
        pair_engines, "admit", bodies, lambda s, b: json.dumps(s.handle_admit(b)["response"]))
    kinds = {"equal": 0, "failed": 0, "open": 0}
    for state, want, got in steps:
        w, g = json.loads(want), json.loads(got)
        assert w["status"]["code"] == 200
        if g == w:
            kinds["equal"] += 1
            continue
        assert (g["uid"], g["allowed"], g["status"]["code"]) == (w["uid"], True, 500)
        msg = g["status"]["message"]
        if state == "open":
            assert msg == "evaluation error (allowed on error): device breaker open"
            kinds["open"] += 1
        else:
            assert "injected dispatch fault" in msg
            kinds["failed"] += 1
    assert kinds == {"equal": 7, "failed": 3, "open": 3}
    assert t_srv.metrics.fallback_batches_total.value(
        path="admission", reason="breaker_open") == 3


def test_open_breaker_answers_without_queueing(pair_engines):
    """While open, a request is answered before the batcher: no batch is
    formed, no seam fires."""
    clock = FakeClock()
    j_srv, t_srv, brk = _pair(pair_engines, clock)
    try:
        brk["t", "authorization"].force_open()
        batches = t_srv.debug_engine()["authorization"]["pipeline"]["batches_total"]
        t0 = time.monotonic()
        doc = t_srv.handle_authorize(sar())
        assert time.monotonic() - t0 < 1.0
        assert doc["status"]["evaluationError"] == "evaluation error: device breaker open"
        assert t_srv.debug_engine()["authorization"]["pipeline"]["batches_total"] == batches
        assert t_srv.debug_engine()["authorization"]["breaker"] == "open"
    finally:
        j_srv.stop()
        t_srv.stop()


def _hold_decode(fastpath, gate):
    real = fastpath.pipeline_decode

    def held(ctx):
        gate.wait(30)
        return real(ctx)

    fastpath.pipeline_decode = held


def test_hung_device_expiries_trip_the_breaker_and_stop_queueing(pair_engines):
    """A hung batch: the deadline is the only signal. Expiries that are
    not ``queued`` trip the breaker (in both servers); then requests stop
    queueing behind the stuck batcher. The port answers the posture
    within the budget; JAX answers from its interpreter."""
    clock = FakeClock()
    j_srv, t_srv, brk = _pair(pair_engines, clock, threshold=2, recovery=60.0,
                              timeout_s=0.15)
    gate = threading.Event()
    try:
        _hold_decode(t_srv.fastpath, gate)
        _hold_decode(j_srv.fastpath, gate)
        for srv in (t_srv, j_srv):
            for _ in range(2):
                doc = srv.handle_authorize(sar())
                assert "deadline" in doc["status"]["evaluationError"]
        assert brk["t", "authorization"].state == brk["j", "authorization"].state == "open"
        before = t_srv.debug_engine()["authorization"]["pipeline"]["batches_total"]
        t0 = time.monotonic()
        got, want = t_srv.handle_authorize(sar()), j_srv.handle_authorize(sar())
        assert time.monotonic() - t0 < 1.0
        assert got["status"]["evaluationError"] == "evaluation error: device breaker open"
        assert want["status"]["allowed"] is True  # the JAX interpreter's answer
        assert t_srv.debug_engine()["authorization"]["pipeline"]["batches_total"] == before
        assert t_srv.metrics.deadline_exceeded_total.value(path="authorization") == 2
    finally:
        gate.set()
        j_srv.stop()
        t_srv.stop()


@pytest.mark.parametrize("queued", [True, False])
def test_only_device_held_expiries_feed_the_breaker(pair_engines, queued):
    """An expiry whose budget burned in the submit queue of a moving
    plane (``DeadlineExceeded.queued``) is overload, not a sick device:
    it spares the breaker, on both endpoints; one the device held feeds
    it."""
    from cedar_tpu_torch.engine.batcher import DeadlineExceeded

    clock = FakeClock()
    j_srv, t_srv, brk = _pair(pair_engines, clock, threshold=1)
    j_srv.stop()

    def expire(*a, **k):
        e = DeadlineExceeded("deadline of 0.100s exceeded waiting for batch result")
        e.queued = queued
        raise e

    try:
        t_srv._batcher.submit = expire
        t_srv._adm_raw_batcher.submit = expire
        doc = t_srv.handle_authorize(sar())
        assert "deadline" in doc["status"]["evaluationError"]
        adm = t_srv.handle_admit(review())["response"]
        assert adm["status"]["code"] == 500 and "deadline" in adm["status"]["message"]
        want = "closed" if queued else "open"
        assert brk["t", "authorization"].state == brk["t", "admission"].state == want
    finally:
        t_srv.stop()


@pytest.mark.parametrize("held,want", [(None, "open"), (0.0, "closed"), (14.999, "closed"),
                                       (15.0, "open"), (60.0, "open")])
def test_a_card_that_holds_no_batch_spares_the_breaker(pair_engines, held, want):
    """A claimed request's expiry feeds the breaker unless the card says
    it held no batch for half the budget (30 s here) or longer
    (``device_held_s``): then the budget burned on a starved host, the
    request answers the deadline and the breaker stays closed. None (a
    CPU engine, no event tells) feeds it, as the JAX package does."""
    from cedar_tpu_torch.engine.batcher import DeadlineExceeded

    clock = FakeClock()
    j_srv, t_srv, brk = _pair(pair_engines, clock, threshold=1)
    j_srv.stop()

    def expire(*a, **k):
        e = DeadlineExceeded("deadline of 0.100s exceeded waiting for batch result")
        e.queued = False
        raise e

    try:
        for fp in (t_srv.fastpath, t_srv.admission_fastpath):
            assert fp.device_held_s() is None  # the CPU engines
            fp.device_held_s = lambda: held
        t_srv._batcher.submit = expire
        t_srv._adm_raw_batcher.submit = expire
        doc = t_srv.handle_authorize(sar())
        assert "deadline" in doc["status"]["evaluationError"]
        adm = t_srv.handle_admit(review())["response"]
        assert adm["status"]["code"] == 500 and "deadline" in adm["status"]["message"]
        assert brk["t", "authorization"].state == brk["t", "admission"].state == want
    finally:
        t_srv.stop()


# ---------------------------------------------------- kill and revive


def _served_stack(tmp_path, refresh_s=3600.0):
    """A port server with a supervisor whose own thread is not started
    (the test calls check_once), over a directory store with a running
    ticker."""
    d = tmp_path / "policies"
    d.mkdir()
    (d / "p.cedar").write_text(POLICIES)
    store = DirectoryPolicyStore(str(d), refresh_interval_s=refresh_s)
    stores = TieredPolicyStores([store])
    engine = TorchPolicyEngine(device="cpu")
    engine.load([s.policy_set() for s in stores])
    authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    sup = t_sup.Supervisor(interval_s=3600.0)
    srv = WebhookServer(authz, address="127.0.0.1", port=0, metrics_port=0,
                        fastpath=SARFastPath(engine, authz), pipeline_depth=2,
                        request_timeout_s=30.0, supervisor=sup)
    from cedar_tpu_torch.cli.webhook import _register_supervised

    _register_supervised(sup, srv)
    return srv, sup, engine, store


@pytest.mark.parametrize("seam,stage", [("pipeline.decode_q", "pipe-decode"),
                                        ("pipeline.dispatch_q", "pipe-dispatch"),
                                        ("pipeline.collect", "pipe-collect")])
def test_killed_stage_is_revived_and_every_request_answered(tmp_path, seam, stage):
    srv, sup, engine, _store = _served_stack(tmp_path)
    batcher = srv._batcher
    reg = t_chaos.default_registry()
    try:
        old = next(t for t in batcher._threads if t.name == stage)
        reg.configure({"faults": [{"seam": seam, "kind": "kill", "after": 3, "count": 1}]})
        reg.arm()
        answers = [srv.handle_authorize(sar()) for _ in range(3)]
        # the fourth batch kills the stage, holding its batch
        with ThreadPoolExecutor(1) as pool:
            held = pool.submit(srv.handle_authorize, sar("v", groups=["viewers"]))
            old.join(10)
            assert not old.is_alive()
            events = sup.check_once()
            answers.append(held.result(30))
        assert [e["component"] for e in events] == ["batcher.authorization"]
        assert events[0]["ok"] and "dead thread" in events[0]["reason"]
        err = answers[-1]["status"]["evaluationError"]
        assert "restarted" in err or "batcher dead" in err
        # the revived pipeline serves again
        answers += [srv.handle_authorize(sar()) for _ in range(3)]
        assert [a["status"]["allowed"] for a in answers] == [True] * 3 + [False] + [True] * 3
        assert batcher.revives == 1
        assert sup.status()["components"]["batcher.authorization"]["restarts"] == 1
        assert _wait(lambda: engine.staging_stats()["outstanding"] == 0)
    finally:
        srv.stop_batchers()
        srv.close_stores()


def test_killed_store_ticker_is_revived(tmp_path):
    """A kill on store.load unwinds the ticker; the supervisor restarts
    it, and serving never noticed."""
    reg = t_chaos.default_registry()
    reg.configure({"faults": [{"seam": "store.load", "kind": "kill", "count": 1}]})
    srv, sup, _engine, store = _served_stack(tmp_path, refresh_s=0.02)
    try:
        old = store._ticker
        reg.arm()
        old.join(10)  # its next re-read fires the kill
        assert not old.is_alive()
        events = sup.check_once()
        assert [e["component"] for e in events] == ["store.directory.FilePolicyStore"]
        assert events[0]["ok"] and store._ticker.is_alive()
        assert srv.handle_authorize(sar())["status"]["allowed"] is True
    finally:
        store.close()
        srv.stop_batchers()


def test_revive_of_a_live_pipeline_does_nothing_unless_forced():
    _engine, fast = _sar_stack()
    b = PipelinedBatcher(fast, depth=2, encode_workers=1)
    try:
        assert b.revive() is False and b.revives == 0
        old = list(b._threads)
        assert b.revive(force=True) is True
        assert all(t not in b._threads for t in old)
        assert b.submit(sar(), timeout=30)[0] == "allow"
        for t in old:
            t.join(5)
        assert not any(t.is_alive() for t in old)
    finally:
        b.stop()


def test_store_stall_keeps_serving_the_previous_set(tmp_path):
    srv, _sup, _engine, store = _served_stack(tmp_path)
    reg = t_chaos.default_registry()
    try:
        assert builtin_scenario("store-stall")["faults"][0]["seam"] == "store.load"
        reg.configure({"faults": [{"seam": "store.load", "kind": "latency", "count": 1,
                                   "delay_s": 0.3},
                                  {"seam": "store.load", "kind": "error", "count": 1}]})
        reg.arm()
        t0 = time.monotonic()
        store.load_policies()  # stalled, then loads
        assert time.monotonic() - t0 >= 0.3
        store.load_policies()  # injected failure: the previous set stays
        assert len(list(store.policy_set().policies())) == 3
        assert srv.handle_authorize(sar())["status"]["allowed"] is True
    finally:
        store.close()
        srv.stop_batchers()


# ------------------------------------------------------------- the CLI


def _cli_server(tmp_path, *flags):
    from cedar_tpu_torch.cli.webhook import build_server, make_parser

    d = tmp_path / "policies"
    d.mkdir(exist_ok=True)
    (d / "p.cedar").write_text(POLICIES)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(d)}}]}}))
    args = make_parser().parse_args(["--config", str(cfg), "--device", "cpu", "--insecure",
                                     "--secure-port", "0", "--metrics-port", "0", *flags])
    return build_server(args)


def test_cli_wires_a_breaker_and_recovery_per_engine_and_the_supervisor(tmp_path):
    srv = _cli_server(tmp_path)
    try:
        for fast, name in ((srv.fastpath, "authorization"),
                           (srv.admission_fastpath, "admission")):
            b = fast.breaker
            assert (b.name, b.failure_threshold, b.recovery_s, b.half_open_probes) == (
                name, 5, 10.0, 2)
            assert b.latency_threshold_s == 2.0  # the request budget
            assert fast.on_device_error.__self__.engine is fast.engine
        st = srv.supervisor.status()
        assert set(st["device_recovery"]) == {"authorization", "admission"}
        assert set(st["components"]) == {"batcher.authorization", "batcher.admission",
                                         "store.directory.FilePolicyStore", "shadow.worker"}
        assert (srv.supervisor.interval_s, srv.supervisor.wedge_budget_s) == (1.0, 10.0)
        assert srv.chaos_control_enabled is False
    finally:
        srv.stop_batchers()
        srv.close_stores()


def test_cli_disables_breaker_and_supervisor_at_zero(tmp_path):
    srv = _cli_server(tmp_path, "--breaker-failure-threshold", "0",
                      "--supervisor-interval-seconds", "0")
    try:
        assert srv.fastpath.breaker is None and srv.fastpath.on_device_error is None
        assert srv.supervisor is None
    finally:
        srv.stop_batchers()
        srv.close_stores()


def test_cli_chaos_scenario_needs_the_gate(tmp_path):
    with pytest.raises(ValueError, match="confirm-non-prod"):
        _cli_server(tmp_path, "--chaos-scenario", "kill-decode")
    srv = _cli_server(tmp_path, "--chaos-scenario", "kill-decode",
                      "--confirm-non-prod-inject-errors")
    try:
        st = t_chaos.default_registry().stats()
        assert st["armed"] and st["scenario"] == "kill-decode"
        assert srv.chaos_control_enabled is True
    finally:
        t_chaos.default_registry().reset()
        srv.stop_batchers()
        srv.close_stores()


def test_server_stop_stops_the_supervisor(tmp_path):
    srv = _cli_server(tmp_path, "--supervisor-interval-seconds", "0.05")
    srv.start()
    assert srv.supervisor._thread.is_alive()
    srv.stop()
    assert not srv.supervisor._thread.is_alive()


def test_rebuild_after_failed_batches_frees_the_old_set_by_refcount(caplog):
    """The set a device-loss rebuild replaces is freed by reference
    counting alone, with the cyclic collector off: a failed batch's
    errors (whose tracebacks hold frames that hold the old set) form no
    reference cycle through the waiter that raised them. Frozen or left
    to a rare full collection, such a cycle would keep the old plane's
    card memory."""
    import logging

    from cedar_tpu_torch.cli.webhook import _rebuild_paused

    # the test's log capture keeps every record, and a logged exception's
    # traceback with it: no records here
    caplog.set_level(logging.CRITICAL + 1, logger="cedar_tpu_torch")
    engine, _ = _sar_stack()
    rec = t_sup.DeviceRecovery(engine, name="refcount", warm=False,
                               rebuild_context=_rebuild_paused)
    ps = engine.compiled_set.packed
    authz = CedarWebhookAuthorizer(TieredPolicyStores([MemoryStore("p", PolicySet.from_source(
        POLICIES, "p"))]), evaluate_batch=engine.evaluate_batch)
    fast = SARFastPath(engine, authz, on_device_error=rec.observe)
    b = PipelinedBatcher(fast, depth=2, encode_workers=1)
    reg = t_chaos.default_registry()
    gc.collect()
    gc.disable()
    try:
        assert b.submit(sar(), timeout=30)[0] == "allow"
        old = weakref.ref(engine.compiled_set)
        reg.configure({"faults": [{"seam": "engine.dispatch", "kind": "error", "count": 1,
                                   "message": "UNAVAILABLE: device lost"}]})
        reg.arm()
        # caught here rather than by pytest.raises, whose record of the
        # error (and its traceback) outlives the block
        failed = None
        try:
            b.submit(sar(), timeout=30)
        except RuntimeError as e:
            failed = str(e)
        assert "device lost" in failed
        assert _wait(lambda: rec.rebuilds == 1 and not rec.rebuilding)
        assert engine.compiled_set.packed is ps
        assert b.submit(sar(), timeout=30)[0] == "allow"
        assert old() is None
    finally:
        gc.enable()
        b.stop()


def test_an_idle_pipeline_holds_no_retired_set():
    """Once a batch is answered, the idle stage threads keep nothing of it:
    a set swapped out (by a load or a rebuild) is freed at once, not when
    the next batch happens to pass."""
    engine, fast = _sar_stack()
    b = PipelinedBatcher(fast, depth=2, encode_workers=1)
    gc.collect()
    gc.disable()
    try:
        assert b.submit(sar(), timeout=30)[0] == "allow"
        old = weakref.ref(engine.compiled_set)
        assert engine.rebuild_compiled() is not None
        assert _wait(lambda: old() is None, timeout=5)
    finally:
        gc.enable()
        b.stop()


def test_chip_smoke_phase_11_reads_its_own_pauses_and_the_servers_slow_requests():
    """What phase 11 of chip_smoke.py prints beside its breaker-window
    check: the smoke's own collections (ClientPauses, every full one
    recorded with its start and length), its heap frozen before traffic
    (freeze_client_heap; in a child process, so this one's collector is
    left as it was), and the authorizations the server itself timed over
    0.7 s (metric_above on the port's /metrics text)."""
    import os
    import subprocess
    import sys

    import chip_smoke

    root = os.path.dirname(os.path.abspath(chip_smoke.__file__))
    child = subprocess.run([sys.executable, "-c", """if True:
        import gc, json, time
        import chip_smoke
        pauses = chip_smoke.ClientPauses()
        pauses.install()
        keep = [[i] for i in range(100000)]
        t0 = time.time()
        gc.collect()
        took, n = chip_smoke.freeze_client_heap()
        t1 = time.time()
        print(json.dumps({"took": took, "n": n, "frozen": gc.get_freeze_count(),
                          "full": [e for e in pauses.between(t0, t1) if e[2] == 2],
                          "later": pauses.between(t1 + 1, t1 + 2), "span": t1 - t0}))
        """], cwd=root, capture_output=True, text=True, timeout=120, check=True)
    got = json.loads(child.stdout.strip().splitlines()[-1])
    assert got["took"] > 0 and got["n"] > 100000 and got["frozen"] >= got["n"]
    assert len(got["full"]) == 2 and all(0 <= e[1] <= got["span"] for e in got["full"])
    assert got["later"] == []
    family = "cedar_authorizer_request_duration_seconds"
    m = WebhookMetrics()
    before = m.expose()
    for seconds, decision in ((0.1, "allow"), (0.7, "allow"), (0.71, "deny"), (2.0, "allow")):
        m.record_request(decision, seconds)
    after = m.expose()
    assert chip_smoke.metric_above(before, family, "0.7") == 0
    assert chip_smoke.metric_above(after, family, "0.7") == 2
    assert chip_smoke.metric_above(after, family, "0.25") == 3
