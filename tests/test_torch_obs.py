"""The port's observability plane (cedar_tpu_torch/obs/, server/error_injector.py,
server/recorder.py, cli/trace.py) and its wiring in the webhook server,
against the JAX package's, on the CPU, at tolerance 0.

  * W3C traceparent parsing, ingestion and formatting over 1,000 seeded
    headers, malformed ones included; span_tree_coverage and cedar-trace's
    dominant_stage on seeded random span trees;
  * the Tracer: one scripted sequence of requests (sampled draws from a
    seeded rng, fixed ids and durations, errors, posture answers, nested
    spans, batch windows, events) gives the same keep decisions, ring,
    listing, lookups, stats and JSONL export (start times normalised);
  * audit_entry (minus ``ts``); determining_policies on the reasons the
    port's interpreter gives the 1,200 seeded bodies of
    test_torch_cache.py, and the decision cache's stamps read them through
    it; the AuditLog's rotation file set, byte for byte;
  * SLOTracker.status() and its published gauges after one seeded record
    stream under a fake clock; slo_from_histogram;
  * ErrorInjector and BatchFaultInjector under one clock script, with the
    chaos injection counts; the recorder's file names minus the
    nanoseconds; cedar-trace's stdout, stderr and exit codes on one log;
  * the servers: the port's response bodies byte for byte the same with
    tracing disarmed (--no-trace, no SLO), armed at rate 0 (the CLI's
    defaults) and at rate 1 with the audit log and the recorder on, and
    the same documents as the JAX server's; audit lines equal to the JAX
    server's (both with a decision cache) minus ``ts``, ``latency_us`` and
    ``traceId``, each joined to a recorder file by its fingerprint; a
    miss's span names equal to the JAX server's (to the JAX batcher's
    names where the JAX server answered from its interpreter); the
    injector's answers and the SLO counts equal to the JAX server's; a
    posture answer tail-kept at rate 0; cedar-trace --url on the live
    ring.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import pathlib
import random
import sys
import time
import urllib.request
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from cedar_tpu import cache as jcache
from cedar_tpu.cache.generation import plane_composite as j_plane_composite
from cedar_tpu.cli import trace as j_cli
from cedar_tpu.engine.batcher import PipelinedBatcher as JPipelinedBatcher
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.obs import audit as j_audit
from cedar_tpu.obs import slo as j_slo
from cedar_tpu.obs import trace as j_trace
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.server import error_injector as j_inj
from cedar_tpu.server import metrics as j_metrics
from cedar_tpu.server import recorder as j_rec
from cedar_tpu.server.http import WebhookServer as JWebhookServer
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.store import TieredPolicyStores as JTieredPolicyStores
from cedar_tpu_torch import cache as t_cache
from cedar_tpu_torch.cache import generation as t_generation
from cedar_tpu_torch.cli import trace as t_cli
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.corpus.synth import synth_corpus, synth_source
from cedar_tpu_torch.engine.batcher import PipelinedBatcher
from cedar_tpu_torch.entities.admission import AdmissionRequest
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.obs import audit as t_audit
from cedar_tpu_torch.obs import slo as t_slo
from cedar_tpu_torch.obs import trace as t_trace
from cedar_tpu_torch.server import error_injector as t_inj
from cedar_tpu_torch.server import metrics as t_metrics
from cedar_tpu_torch.server import recorder as t_rec
from cedar_tpu_torch.server.admission import (
    CedarAdmissionHandler,
    allow_all_admission_policy_store,
)
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.sar import get_authorizer_attributes, sar_response
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402 — the gated and admission policies, admission traffic
import test_torch_cache as cache_tests  # noqa: E402 — the 1,200 seeded bodies
from test_torch_cache import _jax_counters_restored  # noqa: E402,F401 — JAX counters put back

HEX = "0123456789abcdef"


def _series(counter, **labels) -> float:
    """A counter series of either package (both key series the same way)."""
    key = tuple((k, labels.get(k, "")) for k in counter.label_names)
    with counter._lock:
        return counter._values.get(key, 0.0)


# ------------------------------------------------------------ traceparent


def _hex(rng, n: int) -> str:
    return "".join(HEX[i] for i in rng.integers(0, 16, n))


def _traceparents(seed: int, n: int) -> list:
    """Seeded traceparent headers: well-formed ones and each malformed
    shape (absent, all-zero ids, non-hex, short fields, few fields,
    extra fields, padding, upper case, other versions)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ver, tid, sid = "00", _hex(rng, 32), _hex(rng, 16)
        flags = "01" if rng.random() < 0.5 else "00"
        k = int(rng.integers(12))
        if k == 0:
            out.append(None if rng.random() < 0.5 else "")
            continue
        if k == 1:
            tid = "0" * 32
        elif k == 2:
            sid = "0" * 16
        elif k == 3:
            i = int(rng.integers(32))
            tid = tid[:i] + "xg"[int(rng.integers(2))] + tid[i + 1:]
        elif k == 4:
            tid = tid[: int(rng.integers(1, 32))]
        elif k == 5:
            sid = sid[: int(rng.integers(1, 16))] + _hex(rng, 2)
        elif k == 6:
            out.append("-".join([ver, tid, sid][: int(rng.integers(1, 4))]))
            continue
        elif k == 7:
            flags += "-" + _hex(rng, int(rng.integers(1, 8)))
        elif k == 8:
            out.append(" " * int(rng.integers(3)) + f"{ver}-{tid}-{sid}-{flags}" + "\t ")
            continue
        elif k == 9:
            tid, sid = tid.upper(), sid.upper()
        elif k == 10:
            ver = _hex(rng, int(rng.integers(1, 4)))
        out.append(f"{ver}-{tid}-{sid}-{flags}")
    return out


@pytest.mark.parametrize("chunk", range(10))
def test_traceparent_equals_jax(chunk):
    """100 seeded headers per chunk: parse_traceparent gives the JAX
    result; ingest_request_id keeps an ingested id and makes a fresh
    32-hex one otherwise, as JAX's does; format_traceparent round-trips."""
    for header in _traceparents(chunk, 100):
        got = t_trace.parse_traceparent(header)
        assert got == j_trace.parse_traceparent(header), header
        rid, parent = t_trace.ingest_request_id(header)
        jrid, jparent = j_trace.ingest_request_id(header)
        if got is None:
            assert parent is None and jparent is None
            assert len(rid) == len(jrid) == 32 and rid != jrid
            int(rid, 16)
        else:
            assert (rid, parent) == (jrid, jparent) == got
            for sampled in (False, True):
                hdr = t_trace.format_traceparent(rid, parent, sampled)
                assert hdr == j_trace.format_traceparent(rid, parent, sampled)
                assert t_trace.parse_traceparent(hdr) == got
    assert len(t_trace.new_span_id()) == len(j_trace.new_span_id()) == 16


# -------------------------------------------------------------- span trees


def _random_tree(seed: int) -> dict:
    """A trace document with seeded spans: nested, overlapping, disjoint,
    zero-length and overhanging ones."""
    rng = np.random.default_rng(seed)
    total = float(np.round(rng.uniform(0.0, 5000.0), 1)) if seed % 7 else 0.0
    spans = [{"name": "authorization", "spanId": "r", "parent": None, "start_us": 0.0,
              "duration_us": total, "attrs": {}}]
    for i in range(int(rng.integers(0, 12))):
        start = float(np.round(rng.uniform(0, max(total, 1.0)), 1))
        dur = 0.0 if rng.random() < 0.15 else float(np.round(rng.uniform(0, total / 2 + 1), 1))
        spans.append({"name": f"stage.{int(rng.integers(5))}", "spanId": f"{i + 1:x}",
                      "parent": "r", "start_us": start, "duration_us": dur, "attrs": {}})
    return {"traceId": f"{seed:032x}", "path": "authorization", "duration_us": total,
            "spans": spans}


@pytest.mark.parametrize("seed", range(20))
def test_span_tree_coverage_equals_jax(seed):
    doc = _random_tree(seed)
    assert t_trace.span_tree_coverage(doc) == j_trace.span_tree_coverage(doc)
    assert t_cli.dominant_stage(doc) == j_cli.dominant_stage(doc)
    bare = {"duration_us": doc["duration_us"]}
    assert t_trace.span_tree_coverage(bare) == j_trace.span_tree_coverage(bare)


# ------------------------------------------------------------------ tracer


def _normalised(doc: dict) -> dict:
    return {k: v for k, v in doc.items() if k != "start_unix"}


def _run_script(mod, seed: int, sample_rate: float, tail_s, ring: int, log_file):
    """One scripted request sequence through a Tracer of `mod` (either
    package's obs.trace) -> (keep reasons, ring listing, lookups, stats,
    exported lines)."""
    tracer = mod.Tracer(sample_rate=sample_rate, ring_capacity=ring, tail_latency_s=tail_s,
                        log_file=log_file, rng=random.Random(seed))
    rng = np.random.default_rng(seed)
    reasons, ids = [], []
    base = 1000.0
    for i in range(40):
        path = "admission" if i % 5 == 4 else "authorization"
        sampled = None if i % 3 else bool(rng.random() < 0.5)
        tr = tracer.begin(path, trace_id=f"{seed:08x}{i:024x}",
                          parent_span_id=None if i % 2 else f"{i:016x}",
                          root_span_id=f"{i + 1:016x}", sampled=sampled)
        tr.root.t0 = base
        mod.set_current(tr)
        try:
            with mod.span("cache.lookup") as sp:
                sp.set_attr("hit", bool(i % 4 == 0))
                sp.t0, sp.t1 = base + 0.0001, base + 0.0002
            mod.annotate(lambda t: t.add_span("batch.queue_wait", base + 0.0002, base + 0.0005))
            if i % 6 == 1:
                tr.add_span("batch.dispatch", base + 0.0005, base + 0.0009, rows=int(i))
            if i % 7 == 3:
                tr.add_span("skipped", None, base)
            if i % 8 == 5:
                for k in range(20):
                    tr.root.set_attr(f"k{k}", "v" * (150 + 10 * k))
        finally:
            mod.set_current(None)
        assert mod.current_trace() is None
        if i % 9 == 2:
            tr.fallback = True
        dur = float(rng.choice([0.0001, 0.002, 0.3, 1.5]))
        tr.root.t1 = base + dur
        label = ["Allow", "Deny", "NoOpinion", "<error>"][int(rng.integers(4))]
        reasons.append(tracer.finish(tr, decision=label, error=label == "<error>"))
        ids.append(tr.trace_id)
        base += 10.0
    listing = [_normalised(t) for t in tracer.list_traces(limit=0)]
    lookups = [None if (d := tracer.get(tid[:12])) is None else _normalised(d)
               for tid in ids[::3]]
    stats = tracer.stats()
    stats["log_file"] = bool(stats["log_file"])
    tracer.close()
    lines = []
    if log_file:
        with open(log_file) as f:
            lines = [_normalised(json.loads(ln)) for ln in f]
    return reasons, listing, lookups, stats, lines, tracer.get("")


TRACER_CONFIGS = {
    "rate0-tail1s": (0.0, 1.0, 64),
    "rate0-no-tail": (0.0, None, 64),
    "rate0.3-tail250ms": (0.3, 0.25, 64),
    "rate1-small-ring": (1.0, 1.0, 8),
    "rate0.5-zero-tail": (0.5, 0.0, 16),
    "rate0.7-tail1ms": (0.7, 0.001, 4),
}


@pytest.mark.parametrize("config", sorted(TRACER_CONFIGS))
def test_tracer_script_equals_jax(tmp_path, config):
    """The scripted sequence gives the same keep reasons, ring listing,
    prefix lookups, stats and exported JSONL on both packages, and the
    same cedar_trace_kept_total increments."""
    rate, tail, ring = TRACER_CONFIGS[config]
    before = {(p, r): (_series(t_metrics.process_metrics().trace_kept_total, path=p, reason=r),
                       _series(j_metrics.trace_kept_total, path=p, reason=r))
              for p in ("authorization", "admission")
              for r in ("sampled", "slow", "error", "fallback")}
    got = _run_script(t_trace, 5, rate, tail, ring, str(tmp_path / "t.jsonl"))
    want = _run_script(j_trace, 5, rate, tail, ring, str(tmp_path / "j.jsonl"))
    assert got == want
    assert any(got[0]) and (rate >= 1.0 or None in got[0])
    for (p, r), (t0, j0) in before.items():
        t1 = _series(t_metrics.process_metrics().trace_kept_total, path=p, reason=r)
        j1 = _series(j_metrics.trace_kept_total, path=p, reason=r)
        assert t1 - t0 == j1 - j0


def test_span_api_equals_jax():
    """Nested span() contexts, events and finish() on both packages give
    the same tree shape, parents and attributes; with no active trace
    span() is the shared no-op."""
    shapes = []
    for mod in (t_trace, j_trace):
        tr = mod.Trace("authorization", trace_id="a" * 32, root_span_id="b" * 16)
        mod.set_current(tr)
        try:
            with mod.span("outer") as o:
                o.set_attr("x", 1)
                with mod.span("inner"):
                    tr.event("deadline_exceeded", where="inner")
                tr.add_span("batch.encode", tr.root.t0, tr.root.t0)
        finally:
            mod.set_current(None)
        tr.finish(decision="Allow")
        doc = tr.to_dict(kept="sampled")
        shapes.append([(s["name"], s["spanId"], s["parent"], s["attrs"]) for s in doc["spans"]]
                      + [sorted(doc)])
        with mod.span("nothing") as none:
            assert none is None
    assert shapes[0] == shapes[1]
    assert t_trace.MAX_SPAN_ATTRS == j_trace.MAX_SPAN_ATTRS
    assert t_trace.MAX_ATTR_CHARS == j_trace.MAX_ATTR_CHARS


# ------------------------------------------------------------------- audit

AUDIT_CASES = {
    "allow": dict(reason='{"reasons":[{"policy":"p1"},{"policy":"p2"}]}', cached=True),
    "deny-admission": dict(path="admission", decision="denied",
                           reason='[{"policy":"forbid-1","position":{}}]'),
    "error": dict(decision="<error>", error="evaluation error: " + "x" * 900),
    "unkeyed": dict(fingerprint=None, reason="Encountered decoding error"),
    "posture": dict(breaker_state="open", fallback=True, decision="NoOpinion"),
    "latency-rounding": dict(latency_s=0.0123456789, reason="{not json"),
    "admission-error": dict(path="admission", decision="<error>", fingerprint="unkeyed",
                            reason="failed parsing body: x", error="failed parsing body: x"),
    "empty-reason": dict(reason="", error=""),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_entry_equals_jax(case):
    kw = dict(path="authorization", trace_id="c" * 32, fingerprint="f" * 32,
              decision="Allow", latency_s=0.0004)
    kw.update(AUDIT_CASES[case])
    got, want = t_audit.audit_entry(**kw), j_audit.audit_entry(**kw)
    assert abs(got.pop("ts") - want.pop("ts")) < 60
    assert got == want
    assert list(got) == list(want)


def _reasons(chunk: int) -> list:
    """The port interpreter's reasons for 100 of the 1,200 seeded bodies of
    test_torch_cache.py: chunks 0-5 the SARs, 6-11 the AdmissionReviews
    (a deny's message; a review that does not convert its error)."""
    if chunk < 6:
        bodies = cache_tests._sar_bodies(chunk, 100)
        attrs = [get_authorizer_attributes(json.loads(b)) for b in bodies]
        return [r for _d, r in _sar_authorizer().authorize_batch(attrs)]
    out = []
    for body in cache_tests._adm_bodies(50 + chunk, 100):
        try:
            req = AdmissionRequest.from_admission_review(json.loads(body))
            out.append(_adm_handler().handle(req).to_admission_review()
                       ["response"]["status"]["message"])
        except Exception as e:  # noqa: BLE001 — the error text is a reason too
            out.append(str(e))
    return out


_ORACLES: dict = {}


def _sar_authorizer():
    if "sar" not in _ORACLES:
        src = synth_source(48, seed=7) + chip_smoke.FALLBACK_POLICY + _DEMO
        ps = PolicySet.from_source(src, "obs")
        _ORACLES["sar"] = CedarWebhookAuthorizer(TieredPolicyStores([MemoryStore("obs", ps)]))
    return _ORACLES["sar"]


def _adm_handler():
    if "adm" not in _ORACLES:
        ps = PolicySet.from_source(chip_smoke.ADM_POLICIES + chip_smoke.ADM_DEMO_OWNER_POLICY,
                                   "adm")
        _ORACLES["adm"] = CedarAdmissionHandler(TieredPolicyStores(
            [MemoryStore("adm", ps), allow_all_admission_policy_store()]))
    return _ORACLES["adm"]


_DEMO = (
    'permit (principal is k8s::User, action == k8s::Action::"get", '
    'resource is k8s::Resource) when { principal.name == "sam" && '
    'resource.resource == "pods" };\n'
    'forbid (principal, action, resource is k8s::Resource) when '
    '{ resource.resource == "nodes" };\n'
)


@pytest.mark.parametrize("chunk", range(12))
def test_determining_policies_equal_jax(chunk):
    reasons = _reasons(chunk)
    named = 0
    for reason in reasons + ["", "{", "[", "{}", "[1, 2]", '{"reasons": 3}', "null"]:
        got = t_audit.determining_policies(reason)
        assert got == j_audit.determining_policies(reason), reason
        named += bool(got)
    assert named, "no reason named a policy"


def test_cache_stamps_read_the_audit_helper():
    """The decision cache's shard-scoped stamps read the determining
    policies through obs/audit.py: no private copy is left."""
    assert t_generation._determining_policies is t_audit.determining_policies


ROTATIONS = {
    "1-file": (4096, 1, 120), "2-files": (4096, 2, 120), "3-files": (4096, 3, 200),
    "min-bytes-clamped": (100, 3, 400), "no-rotation": (1 << 20, 3, 150),
    "big-lines": (8192, 2, 100),
}


@pytest.mark.parametrize("case", sorted(ROTATIONS))
def test_audit_rotation_equals_jax(tmp_path, case):
    """The same entries through both AuditLogs: the same file set, each
    file byte for byte, the same stats and rotation counts."""
    max_bytes, max_files, n = ROTATIONS[case]
    rng = np.random.default_rng(len(case))
    entries = [{"path": "authorization", "n": i,
                "pad": "x" * int(rng.integers(10, 400 if case == "big-lines" else 80))}
               for i in range(n)]
    sides = {}
    for name, mod, metric in (("t", t_audit, t_metrics.process_metrics().audit_rotations_total),
                              ("j", j_audit, j_metrics.audit_rotations_total)):
        d = tmp_path / name
        d.mkdir()
        before = _series(metric)
        log = mod.AuditLog(str(d / "audit.jsonl"), max_bytes=max_bytes, max_files=max_files)
        for e in entries:
            log.record(e)
        log.close()
        stats = log.stats()
        stats["path"] = os.path.basename(stats["path"])
        files = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
        sides[name] = (files, stats, _series(metric) - before)
    assert sides["t"] == sides["j"]
    assert len(sides["t"][0]) == (1 if case == "no-rotation" else max_files + 1)


def test_audit_log_disables_itself_on_io_error(tmp_path):
    for mod in (t_audit, j_audit):
        log = mod.AuditLog(str(tmp_path / "missing" / "audit.jsonl"))
        log.record({"a": 1})
        log.record({"a": 2})
        assert log.stats()["disabled"] and log.stats()["records"] == 0


# --------------------------------------------------------------------- SLO


class FakeClock:
    def __init__(self, now: float = 1_700_000_000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def _slo_run(mod, seed: int, path_prefix: str):
    """One seeded record stream under a fake clock -> status() snapshots
    along the way."""
    clock = FakeClock()
    rng = np.random.default_rng(seed)
    tracker = mod.SLOTracker(availability_target=[0.999, 0.99, 0.9][seed % 3],
                             latency_target=[0.99, 0.95][seed % 2],
                             latency_budget_s=[0.05, 0.2, 2.0][seed % 3], clock=clock)
    paths = [f"{path_prefix}authorization", f"{path_prefix}admission"]
    out = []
    for i in range(600):
        tracker.record(paths[int(rng.integers(2))], float(rng.exponential(0.1)),
                       bool(rng.random() < 0.03 * (1 + seed % 4)))
        clock.now += float(rng.choice([0.0, 0.5, 3.0, 40.0, 900.0]))
        if i % 97 == 0:
            out.append(tracker.status())
    out.append(tracker.status())
    tracker.publish()
    return out


def _slo_gauges(lines: list, prefix: str) -> list:
    return sorted(ln for ln in lines if f'path="{prefix}' in ln)


@pytest.mark.parametrize("seed", range(10))
def test_slo_status_equals_jax(seed):
    prefix = f"slo-test-{seed}-"
    assert _slo_run(t_slo, seed, prefix) == _slo_run(j_slo, seed, prefix)
    pm = t_metrics.process_metrics()
    for t_fam, j_fam in ((pm.slo_burn_rate, j_metrics.slo_burn_rate),
                         (pm.slo_target, j_metrics.slo_target)):
        got = _slo_gauges(t_fam.collect(), prefix)
        assert got and got == _slo_gauges(j_fam.collect(), prefix)
    assert t_slo.WINDOWS == j_slo.WINDOWS


@pytest.mark.parametrize("budget", [0.0005, 0.25, 1.0, 10.0])
def test_slo_from_histogram_equals_jax(budget):
    """The tracker's offline cross-check over each package's histogram,
    fed the same seeded latencies."""
    rng = np.random.default_rng(3)
    buckets = [0.25, 0.5, 0.7, 1, 1.5, 3, 5, 10]
    th = t_metrics.Histogram("h", "h", ["path"], buckets)
    jh = j_metrics.Histogram("h", "h", ["path"], buckets)
    for i in range(500):
        v, p = float(rng.exponential(0.6)), ["authorization", "admission"][i % 2]
        th.observe(v, path=p)
        jh.observe(v, path=p)
    for label in (None, "authorization", "admission", "other"):
        assert (t_slo.slo_from_histogram(th, budget, label)
                == j_slo.slo_from_histogram(jh, budget, label))


# --------------------------------------------------------------- injectors


class ScriptClock:
    """A monotonic clock stepped by the test."""

    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


INJECTOR_CONFIGS = {
    "disabled": (False, 5.0, 5.0), "errors": (True, 2.0, 0.0), "denies": (True, 0.0, 3.0),
    "both": (True, 2.0, 2.0), "fast": (True, 1e9, 0.5), "zero-rates": (True, 0.0, 0.0),
}
ANSWERS = [("allow", '{"reasons":[{"policy":"p"}]}', None), ("deny", "", None),
           ("no_opinion", "", None), ("allow", "", None)]


@pytest.mark.parametrize("config", sorted(INJECTOR_CONFIGS))
def test_error_injector_equals_jax(config):
    """One clock script through both injectors: the same swaps in the same
    order (errors consulted first, a deny overriding), the same
    cedar_chaos_injections_total{seam="response"} increments."""
    enabled, err, deny = INJECTOR_CONFIGS[config]
    kinds = ("response_error", "response_deny")
    before = [(_series(t_metrics.process_metrics().chaos_injections_total, seam="response",
                       kind=k),
               _series(j_metrics.chaos_injections_total, seam="response", kind=k))
              for k in kinds]
    outs = []
    for mod in (t_inj, j_inj):
        clock = ScriptClock()
        inj = mod.ErrorInjector(mod.ErrorInjectionConfig(
            enabled=enabled, artificial_error_rate=err, artificial_deny_rate=deny), now=clock)
        rng = np.random.default_rng(9)
        out = []
        for i in range(300):
            clock.now += float(rng.choice([0.0, 0.05, 0.2, 0.6, 1.3]))
            decision, reason, error = ANSWERS[i % len(ANSWERS)]
            out.append(inj.inject_if_enabled(decision, reason, error))
        outs.append(out)
    assert outs[0] == outs[1]
    swapped = sum(o != ANSWERS[i % len(ANSWERS)] for i, o in enumerate(outs[0]))
    assert (swapped > 0) == (enabled and (err > 0 or deny > 0))
    for k, (t0, j0) in zip(kinds, before):
        t1 = _series(t_metrics.process_metrics().chaos_injections_total, seam="response", kind=k)
        j1 = _series(j_metrics.chaos_injections_total, seam="response", kind=k)
        assert t1 - t0 == j1 - j0


@pytest.mark.parametrize("latency", [0.0, 0.25])
def test_batch_fault_injector_equals_jax(latency):
    """BatchFaultInjector under one clock script: the same raised faults,
    stalls (a recorded fake sleep) and results."""
    outs = []
    for mod in (t_inj, j_inj):
        clock, slept = ScriptClock(), []
        inj = mod.BatchFaultInjector(lambda items: [2 * i for i in items], latency_s=latency,
                                     latency_rate=1.5, error_rate=0.7, now=clock,
                                     sleep=slept.append)
        out = []
        for i in range(80):
            clock.now += 0.3
            try:
                out.append(inj([i, i + 1]))
            except mod.InjectedFault as e:
                out.append(str(e))
        outs.append((out, slept, inj.injected_errors, inj.injected_stalls))
    assert outs[0] == outs[1]
    assert outs[0][2] > 0


# ---------------------------------------------------------------- recorder

RECORD_PATHS = ["/v1/authorize", "/v1/admit", "/v1/authorize?dryRun=1", "/", "/deep/x/y",
                "/v1/authorization"]


def _record_bodies() -> list:
    return (cache_tests._sar_bodies(77, 8) + chip_smoke.admission_bodies(8, 5)
            + [b'{"spec": {"user": ', b"[1, 2]", b"null", b""])


@pytest.mark.parametrize("url", RECORD_PATHS)
def test_recorder_names_equal_jax(tmp_path, url):
    """Each body recorded by both recorders: the same file names up to the
    nanosecond stamp, the same bytes; an empty body writes nothing."""
    sides = []
    for name, mod in (("t", t_rec), ("j", j_rec)):
        rec = mod.RequestRecorder(str(tmp_path / name / "rec"))
        for body in _record_bodies():
            rec.record(url, body)
        files = sorted((f.name.rsplit("-", 1)[0], f.read_bytes())
                       for f in (tmp_path / name / "rec").iterdir())
        sides.append(files)
    assert sides[0] == sides[1]
    assert len(sides[0]) == len(_record_bodies()) - 1


def test_recorder_refuses_a_file_as_its_directory(tmp_path):
    f = tmp_path / "file"
    f.write_text("x")
    for mod in (t_rec, j_rec):
        with pytest.raises(ValueError):
            mod.RequestRecorder(str(f))


# -------------------------------------------------------------- cedar-trace


@pytest.fixture(scope="module")
def trace_log(tmp_path_factory):
    """A trace log of six requests with fixed ids and timings, and one
    unparseable line."""
    d = tmp_path_factory.mktemp("tracelog")
    log = d / "traces.jsonl"
    tracer = t_trace.Tracer(sample_rate=1.0, log_file=str(log))
    for i in range(6):
        tr = tracer.begin("admission" if i == 3 else "authorization", trace_id=f"{i:x}" * 32,
                          parent_span_id="e" * 16 if i == 1 else None)
        t0 = tr.root.t0
        tr.add_span("cache.lookup", t0, t0 + 0.00002 * (i + 1), hit=i % 2 == 0)
        if i % 2:
            tr.add_span("batch.queue_wait", t0 + 0.0001, t0 + 0.0003)
            tr.add_span("batch.dispatch", t0 + 0.0003, t0 + 0.0021 + i * 0.001)
        tr.root.t1 = t0 + 0.004 + i * 0.0015
        tracer.finish(tr, decision=["Allow", "Deny", "NoOpinion", "allowed"][i % 4])
    tracer.close()
    log.write_text(log.read_text() + "not json\n")
    empty = d / "empty.jsonl"
    empty.write_text("")
    return d


CLI_ARGV = {
    "list": ["--log", "{d}/traces.jsonl"],
    "list-json": ["--log", "{d}/traces.jsonl", "--json"],
    "list-limit": ["--log", "{d}/traces.jsonl", "--limit", "2"],
    "fetch-prefix": ["--log", "{d}/traces.jsonl", "1111"],
    "fetch-json": ["--log", "{d}/traces.jsonl", "5" * 32, "--json"],
    "fetch-bare": ["--log", "{d}/traces.jsonl", "0000"],
    "no-match": ["--log", "{d}/traces.jsonl", "deadbeef"],
    "empty-source": ["--log", "{d}/empty.jsonl"],
    "unreadable": ["--log", "{d}/missing.jsonl"],
}


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("case", sorted(CLI_ARGV))
def test_cedar_trace_cli_equals_jax(trace_log, case):
    argv = [a.format(d=trace_log) for a in CLI_ARGV[case]]
    got = _run_cli(t_cli.main, argv)
    assert got == _run_cli(j_cli.main, argv)
    assert got[0] == {"no-match": 2, "empty-source": 2, "unreadable": 1}.get(case, 0)


# ---------------------------------------------------------------- servers


def _policy_dir(tmp_path) -> pathlib.Path:
    d = tmp_path / "policies"
    d.mkdir()
    (d / "synth.cedar").write_text(synth_source(48, seed=7))
    (d / "gated.cedar").write_text(chip_smoke.FALLBACK_POLICY + chip_smoke.NATIVE_OPAQUE_POLICY)
    (d / "demo.cedar").write_text(_DEMO)
    (d / "admission.cedar").write_text(chip_smoke.ADM_POLICIES)
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


def jax_native_ready(wait_s: float = 120.0) -> bool:
    """The JAX package's native library loaded in this process, so its
    fast path serves natively (test_torch_server.py's helper)."""
    from cedar_tpu import native as jnative

    deadline = time.monotonic() + wait_s
    while not jnative.native_available():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.5)
        jnative._lib_error = None
    return True


def _jax(policy_dir, cache: bool = True, **kw):
    """The JAX server over the same directory: its fast path behind the
    pipelined batcher, the admission stack, a DecisionCache as its CLI
    wires a compiled backend's, and the given obs objects."""
    from cedar_tpu.server import admission as j_adm

    stores = JTieredPolicyStores([JDirectoryPolicyStore(str(policy_dir), start_ticker=False)])
    engine = TPUPolicyEngine()
    engine.load([s.policy_set() for s in stores], warm="off")
    authz = j_auth.CedarWebhookAuthorizer(
        stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch)
    handler = j_adm.CedarAdmissionHandler(JTieredPolicyStores(
        [JDirectoryPolicyStore(str(policy_dir), start_ticker=False),
         j_adm.allow_all_admission_policy_store()]))
    decision_cache = None
    if cache:
        decision_cache = jcache.DecisionCache(
            generation_fn=lambda: j_plane_composite(stores, engine), path="authorization")
    srv = JWebhookServer(authz, handler, address="127.0.0.1", port=0, metrics_port=0,
                         fastpath=JSARFastPath(engine, authz), pipeline_depth=2,
                         request_timeout_s=60.0, decision_cache=decision_cache, **kw)
    srv.start()
    return srv


def _post(port, path, body, headers=None):
    """-> (status, raw body bytes, response headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Length": str(len(body)), **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


# the traffic: synth and generated SARs (some repeated, so the cache
# answers), gated ones, undecodable bodies, admission reviews
SERVER_SARS = (synth_corpus(48, seed=7).sar_bodies(24, seed=11) + cache_tests._sar_bodies(4, 24)
               + chip_smoke.gated_bodies(synth_corpus(48, seed=7), 8, seed=2))
SERVER_BODIES = (
    [("/v1/authorize", b) for b in SERVER_SARS + SERVER_SARS[:16]]
    + [("/v1/authorize", b) for b in (b'{"spec": {"user": ', b"[1, 2]", b"")]
    + [("/v1/admit", b) for b in chip_smoke.admission_bodies(48, 9)]
)
GROUPS = 6
MODES = {
    "disarmed": ("--no-trace", "--slo-availability-target", "0"),
    "armed-rate0": (),
    "armed-rate1": ("--trace-sample-rate", "1", "--audit-log-file", "{d}/audit.jsonl",
                    "--enable-recording", "--recording-dir", "{d}/rec"),
}


@pytest.fixture(scope="module")
def mode_servers(tmp_path_factory):
    """A port server per tracing mode over one directory, and a JAX server
    with no tracer."""
    d = tmp_path_factory.mktemp("obs-modes")
    pdir = _policy_dir(d)
    servers = {m: _port(pdir, *(f.format(d=d) for f in flags)) for m, flags in MODES.items()}
    servers["jax"] = _jax(pdir)
    yield servers
    for s in servers.values():
        s.stop()


@pytest.mark.parametrize("group", range(GROUPS))
@pytest.mark.parametrize("mode", ["armed-rate0", "armed-rate1"])
def test_response_bytes_identical_across_trace_modes(mode_servers, mode, group):
    """The port's response bytes with tracing armed at rate 0 or 1 equal
    the disarmed server's byte for byte, and their documents the JAX
    server's; every response carries X-Cedar-Trace-Id, and a traceparent
    (sampled flag = the head rate) only when a tracer is armed."""
    bodies = SERVER_BODIES[group::GROUPS]
    for path, body in bodies:
        st, data, hdrs = _post(mode_servers[mode].bound_port, path, body)
        st0, data0, hdrs0 = _post(mode_servers["disarmed"].bound_port, path, body)
        stj, dataj, _ = _post(mode_servers["jax"].bound_port, path, body)
        assert (st, data) == (st0, data0)
        assert (st, json.loads(data)) == (stj, json.loads(dataj))
        assert len(hdrs["X-Cedar-Trace-Id"]) == len(hdrs0["X-Cedar-Trace-Id"]) == 32
        assert "traceparent" not in hdrs0
        flag = "01" if mode == "armed-rate1" else "00"
        assert t_trace.parse_traceparent(hdrs["traceparent"])[0] == hdrs["X-Cedar-Trace-Id"]
        assert hdrs["traceparent"].endswith("-" + flag)
    assert t_trace.current_trace() is None


def test_disarmed_server_has_no_trace_or_slo_endpoints(mode_servers):
    srv = mode_servers["disarmed"]
    assert srv.tracer is None and srv.slo is None and srv.audit_log is None
    for path in ("/debug/traces", "/debug/slo"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.bound_metrics_port, path)
        assert ei.value.code == 404
    armed = mode_servers["armed-rate0"]
    assert (armed.tracer.sample_rate, armed.tracer.tail_latency_s, armed.slo.latency_budget_s) \
        == (0.0, 60.0, 60.0)


def test_rate1_server_traces_every_request(mode_servers):
    """At rate 1 every request's trace is in the ring under its
    X-Cedar-Trace-Id: a miss has cache.lookup and the four pipelined
    batch spans, a hit cache.lookup only, an admission review its batch
    spans; an ingested traceparent's id is echoed and kept as upstream."""
    srv = mode_servers["armed-rate1"]
    port, mport = srv.bound_port, srv.bound_metrics_port
    body = cache_tests._sar_bodies(991, 1)[0]
    tid, sid = "9" * 32, "8" * 16
    _, _, h1 = _post(port, "/v1/authorize", body, {"traceparent": f"00-{tid}-{sid}-00"})
    _, _, h2 = _post(port, "/v1/authorize", body)
    _, _, h3 = _post(port, "/v1/admit", chip_smoke.admission_bodies(3, 4)[1])
    assert h1["X-Cedar-Trace-Id"] == tid
    miss, hit, adm = (_get(mport, f"/debug/traces/{h['X-Cedar-Trace-Id']}") for h in (h1, h2, h3))
    assert miss["upstreamParent"] == sid and miss["spans"][0]["parent"] == sid
    assert [s["name"] for s in miss["spans"]] == [
        "authorization", "cache.lookup", "batch.queue_wait", "batch.encode", "batch.dispatch",
        "batch.decode"]
    assert miss["spans"][1]["attrs"] == {"hit": False}
    assert [s["name"] for s in hit["spans"]] == ["authorization", "cache.lookup"]
    assert hit["spans"][1]["attrs"] == {"hit": True}
    assert adm["path"] == "admission" and {"batch.dispatch", "batch.decode"} <= {
        s["name"] for s in adm["spans"]}
    listing = _get(mport, "/debug/traces")
    assert listing["traces"][0]["traceId"] == h3["X-Cedar-Trace-Id"]
    assert listing["sample_rate"] == 1.0 and listing["kept"] >= 3


@pytest.fixture(scope="module")
def audit_pair(tmp_path_factory):
    """The port's CLI server and a JAX server, each with an audit log (and
    the port's recorder), both with a decision cache; breakers off on the
    port's side, as the JAX fast path is built without one."""
    d = tmp_path_factory.mktemp("obs-audit")
    pdir = _policy_dir(d)
    t = _port(pdir, "--audit-log-file", str(d / "t-audit.jsonl"), "--breaker-failure-threshold",
              "0", "--enable-recording", "--recording-dir", str(d / "rec"))
    native = jax_native_ready()
    jlog = j_audit.AuditLog(str(d / "j-audit.jsonl"))
    j = _jax(pdir, audit_log=jlog, tracer=j_trace.Tracer(sample_rate=1.0))
    yield t, j, d, native
    t.stop()
    j.stop()


def _audit_lines(path) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def _strip(line: dict) -> dict:
    return {k: v for k, v in line.items() if k not in ("ts", "latency_us", "traceId")}


@pytest.mark.parametrize("group", range(3))
def test_audit_lines_equal_jax(audit_pair, group):
    """One request at a time to both servers: the same response documents
    and audit lines equal to the JAX server's but for ts, latency_us and
    traceId (the cached flag included: both caches hit the same keys);
    each line's traceId is its response's X-Cedar-Trace-Id and its
    fingerprint names the recorder file that holds the body."""
    t, j, d, native = audit_pair
    if not native:
        pytest.skip("the JAX package's native library did not load: its server would "
                    "answer from its interpreter with the fallback mark")
    bodies = SERVER_BODIES[group::3]
    bodies += bodies[:6]  # its own repeats: the caches answer them
    n0 = len(_audit_lines(d / "t-audit.jsonl")) if (d / "t-audit.jsonl").exists() else 0
    m0 = len(_audit_lines(d / "j-audit.jsonl")) if (d / "j-audit.jsonl").exists() else 0
    ids = []
    for path, body in bodies:
        st, data, hdrs = _post(t.bound_port, path, body)
        stj, dataj, _ = _post(j.bound_port, path, body)
        assert (st, json.loads(data)) == (stj, json.loads(dataj))
        ids.append(hdrs["X-Cedar-Trace-Id"])
    got = _audit_lines(d / "t-audit.jsonl")[n0:]
    want = _audit_lines(d / "j-audit.jsonl")[m0:]
    assert len(got) == len(want) == len(bodies)
    assert [_strip(g) for g in got] == [_strip(w) for w in want]
    assert [g["traceId"] for g in got] == ids
    assert any(g["cached"] for g in got) and any(g["policies"] for g in got)
    recorded = {}
    for f in (d / "rec").iterdir():
        recorded.setdefault(f.name.split("-")[2], []).append(f.read_bytes())
    for g, (path, body) in zip(got, bodies):
        if body:
            assert body in recorded[g["fingerprint"]]


def test_miss_span_names_equal_jax(audit_pair):
    """A miss's span names on the port's server equal the JAX server's
    fast path's; where the JAX server answered from its interpreter, they
    equal the names the JAX batcher attaches to a pipelined batch."""
    t, j, _d, _native = audit_pair
    t.tracer.sample_rate = 1.0
    body = cache_tests._sar_bodies(4242, 1)[0]
    _, _, th = _post(t.bound_port, "/v1/authorize", body)
    _, _, jh = _post(j.bound_port, "/v1/authorize", body)
    tnames = [s["name"] for s in t.tracer.get(th["X-Cedar-Trace-Id"])["spans"]]
    jnames = [s["name"] for s in j.tracer.get(jh["X-Cedar-Trace-Id"])["spans"]]
    if "interpreter" in jnames:
        jnames = ["authorization", "cache.lookup"] + _jax_batch_span_names()
    assert tnames == jnames


def _jax_batch_span_names() -> list:
    class Stages:
        def pipeline_encode(self, items):
            return list(items)

        def pipeline_dispatch(self, ctx):
            return ctx

        def pipeline_decode(self, ctx):
            return ctx

    batcher = JPipelinedBatcher(Stages())
    tr = j_trace.Trace("authorization")
    j_trace.set_current(tr)
    try:
        batcher.submit(1, timeout=30)
    finally:
        j_trace.set_current(None)
        batcher.stop()
    return [s.name for s in tr.spans[1:]]


@pytest.mark.parametrize("batcher_kind", ["pipelined", "serial"])
def test_batch_spans_equal_jax(batcher_kind):
    """The port's batchers attach JAX's batch span names to the active
    trace, each window inside the request's root span; with no active
    trace nothing is recorded."""
    from cedar_tpu.engine.batcher import MicroBatcher as JMicroBatcher
    from cedar_tpu_torch.engine.batcher import MicroBatcher

    class Stages:
        def pipeline_encode(self, items):
            return list(items)

        def pipeline_dispatch(self, ctx):
            return ctx

        def pipeline_decode(self, ctx):
            return ctx

    names = []
    for mod, micro, piped in ((t_trace, MicroBatcher, PipelinedBatcher),
                              (j_trace, JMicroBatcher, JPipelinedBatcher)):
        batcher = piped(Stages()) if batcher_kind == "pipelined" else micro(
            lambda items: list(items))
        tr = mod.Trace("authorization")
        mod.set_current(tr)
        try:
            assert batcher.submit(7, timeout=30) == 7
        finally:
            mod.set_current(None)
        assert batcher.submit(8, timeout=30) == 8
        batcher.stop()
        tr.finish()
        names.append([s.name for s in tr.spans])
        for s in tr.spans[1:]:
            assert tr.root.t0 <= s.t0 <= s.t1 <= tr.root.t1
    assert names[0] == names[1]
    assert len(names[0]) == (5 if batcher_kind == "pipelined" else 3)


INJECT = {
    "errors": ("--artificial-error-rate", "1e9"),
    "denies": ("--artificial-deny-rate", "1e9"),
    "both": ("--artificial-error-rate", "1e9", "--artificial-deny-rate", "1e9"),
}


@pytest.mark.parametrize("case", sorted(INJECT))
def test_injected_answers_and_slo_equal_jax(tmp_path, case):
    """The injector at a rate that fires on every call, behind the
    non-prod gate: the port's answers equal the JAX server's (its
    ErrorInjector at the same rates), an injected answer is never cached
    (the cache's entries hold the real answers), and /debug/slo counts
    the same requests and errors on both; without the gate the rates do
    nothing."""
    from cedar_tpu.obs.slo import SLOTracker as JSLOTracker

    flags = INJECT[case]
    rates = dict(zip(flags[::2], (float(v) for v in flags[1::2])))
    pdir = _policy_dir(tmp_path)
    t = _port(pdir, "--confirm-non-prod-inject-errors", *flags)
    ungated = _port(pdir, *flags)
    j = _jax(pdir, slo=JSLOTracker(latency_budget_s=60.0), error_injector=j_inj.ErrorInjector(
        j_inj.ErrorInjectionConfig(
            enabled=True, artificial_error_rate=rates.get("--artificial-error-rate", 0.0),
            artificial_deny_rate=rates.get("--artificial-deny-rate", 0.0))))
    try:
        bodies = SERVER_SARS[:12] + SERVER_SARS[:4]
        want = (("deny", "Authorization denied", None) if "--artificial-deny-rate" in rates
                else ("no_opinion", "", "encountered error"))
        real = {}
        for body in bodies:
            _, data, _ = _post(t.bound_port, "/v1/authorize", body)
            _, dataj, _ = _post(j.bound_port, "/v1/authorize", body)
            _, data_real, _ = _post(ungated.bound_port, "/v1/authorize", body)
            doc = json.loads(data)
            assert doc == json.loads(dataj) == sar_response(*want)
            real[body] = json.loads(data_real)
            assert real[body] != doc
        keys = {t_cache.fingerprint_body("authorize", b) for b in bodies}
        assert t.decision_cache.stats()["hits"] == len(bodies) - len(keys)
        for body in bodies[:12]:
            decision, reason = t.decision_cache.get(t_cache.fingerprint_body("authorize", body))
            assert sar_response(decision, reason) == real[body]
        st, sj = _get(t.bound_metrics_port, "/debug/slo"), _get(j.bound_metrics_port, "/debug/slo")
        got, ref = st["paths"]["authorization"]["5m"], sj["paths"]["authorization"]["5m"]
        assert (got["requests"], got["errors"]) == (ref["requests"], ref["errors"])
        assert got["requests"] == len(bodies)
        assert got["errors"] == (0 if "--artificial-deny-rate" in rates else len(bodies))
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{t.bound_metrics_port}/metrics", timeout=30).read().decode()
        assert 'cedar_slo_burn_rate{path="authorization",slo="availability",window="5m"}' in metrics
    finally:
        for s in (t, ungated, j):
            s.stop()


def test_posture_answer_is_tail_kept_at_rate_0(tmp_path):
    """An open breaker's answer at sample rate 0: the trace is kept (as an
    error, marked fallback), the audit line says fallback and the breaker's
    state, the SLO counts the error; a clean answer is not kept."""
    pdir = _policy_dir(tmp_path)
    t = _port(pdir, "--audit-log-file", str(tmp_path / "audit.jsonl"))
    try:
        body = SERVER_SARS[0]
        _, _, h_clean = _post(t.bound_port, "/v1/authorize", SERVER_SARS[1])
        t.fastpath.breaker.allow = lambda: False
        _, data, h = _post(t.bound_port, "/v1/authorize", body)
        assert json.loads(data)["status"]["evaluationError"].endswith("device breaker open")
        assert t.tracer.get(h_clean["X-Cedar-Trace-Id"]) is None
        doc = t.tracer.get(h["X-Cedar-Trace-Id"])
        assert (doc["kept"], doc["fallback"], doc["error"], doc["sampled"]) == (
            "error", True, True, False)
        line = _audit_lines(tmp_path / "audit.jsonl")[-1]
        assert (line["fallback"], line["decision"], line["traceId"]) == (
            True, "<error>", h["X-Cedar-Trace-Id"])
        assert t.slo.status()["paths"]["authorization"]["5m"]["errors"] == 1
    finally:
        t.stop()


def test_cedar_trace_url_mode_against_the_port_ring(mode_servers):
    """cedar-trace --url lists the live port ring and prints one tree; an
    unknown id exits 2, as against the JAX server."""
    srv = mode_servers["armed-rate1"]
    _, _, h = _post(srv.bound_port, "/v1/authorize", SERVER_SARS[2])
    tid = h["X-Cedar-Trace-Id"]
    base = f"http://127.0.0.1:{srv.bound_metrics_port}"
    rc, out, _ = _run_cli(t_cli.main, ["--url", base])
    assert rc == 0 and tid in out
    rc, out, _ = _run_cli(t_cli.main, ["--url", base, tid])
    assert rc == 0 and "e2e=" in out and "cache.lookup" in out
    assert _run_cli(t_cli.main, ["--url", base, "f" * 32])[0] == 2
    assert _run_cli(j_cli.main, ["--url", base, "f" * 32])[0] == 2
