"""Prometheus metrics of the webhook, with the text exposition.

The families this slice records, with the JAX package's names, labels and
buckets (its server/metrics.py; request families as the reference's
internal/server/metrics/metrics.go):

  * ``cedar_authorizer_request_total{decision}`` and
    ``cedar_authorizer_request_duration_seconds{decision}``;
  * ``cedar_authorizer_deadline_exceeded_total{path}``,
    ``cedar_authorizer_requests_shed_total{path}`` (drain) and
    ``cedar_authorizer_fallback_batches_total{path,reason}``: the JAX
    name and reasons, so dashboards carry over, but in the port the work
    it counts was answered with the failure posture (NoOpinion +
    evaluationError, the admission fail-mode), never re-run on the
    interpreter. ``breaker_open``: a request the open breaker answered
    before it reached the batcher, or a queued batch it stopped at encode;
    ``evaluator_error``: a batch whose device evaluation raised;
  * ``cedar_batch_occupancy{path}``,
    ``cedar_pipeline_stall_seconds_total{path,stage}`` and
    ``cedar_pipeline_stage_seconds{path,stage}`` from the batcher;
  * ``cedar_authorizer_row_routing_total{path,row_class}`` and
    ``cedar_packed_decode_{transfers,chunks}_total{path}``, read from the
    fast path's own counts at scrape time;
  * ``cedar_native_encode_threads``;
  * ``cedar_compile_seconds{phase,scope}``: one observation per phase
    (analyze, hash, lower, pack, place, warm, total) of every engine
    load, the initial ones and each reload's; scope ``full`` (the whole corpus
    lowered) or ``incremental`` (only the dirty shards); ``hash`` only
    from incremental engines; ``analyze`` (the validationMode gate, which
    ``total`` leaves out) only from loads the gate analyzed;
  * ``cedar_policy_shards{engine}`` and ``cedar_dirty_shards{engine}``:
    the shards of each engine's serving plane and those its last load
    re-lowered (0 from an engine without incremental compile).

The batch, pipeline, deadline, shed, routing and packed-decode families
carry a ``path`` label: ``authorization`` for /v1/authorize and
``admission`` for /v1/admit. The request families stay
authorization-only, as in the JAX package.

Each server owns one ``WebhookMetrics`` (its own registry), so two servers
in one process never mix their counts. The resilience families belong to
objects of the process rather than of one server (the breakers, the
supervisor, the device recoveries, the chaos registry's seams), so they
are process-wide, as in the JAX package, with its module-level record
functions; every server's /metrics renders them:

  * ``cedar_authorizer_breaker_state{engine}`` (0 closed, 1 open, 2
    half-open) and ``cedar_authorizer_breaker_transitions_total{engine,to}``;
  * ``cedar_supervisor_restarts_total{component,replica}``;
  * ``cedar_device_rebuilds_total``;
  * ``cedar_chaos_injections_total{seam,kind}``;
  * ``cedar_worker_deaths_total{component,replica}`` (a CRD store's
    list+watch thread that died: ``crd.watch``).

The analysis families are process-wide as well (the load-time gate,
analysis/loadgate.py, and the CRD store's per-object check publish them,
as in the JAX package), and so is the served fallback tally the engines
count at their interpreter merge:

  * ``cedar_policy_fastpath_lowerable{tier}`` and
    ``cedar_policy_analysis_findings_total{kind}`` (``kind`` is the
    finding's reason code);
  * ``cedar_fallback_decisions_total{code,engine}``, read per engine by
    /debug/engine and /debug/analysis (``fallback_decision_counts``).

So are the decision cache's families, which the cache objects
(cache/decision_cache.py, cache/singleflight.py) record through the
module-level ``record_cache_*`` / ``set_cache_*`` functions, as in the
JAX package:

  * ``cedar_decision_cache_hits_total{path}``,
    ``cedar_decision_cache_misses_total{path}``,
    ``cedar_decision_cache_evictions_total{path,reason}`` and
    ``cedar_decision_cache_coalesced_total{path}``;
  * ``cedar_decision_cache_size{path}`` and
    ``cedar_decision_cache_hit_ratio{path}``.

And so are the observability plane's (obs/), recorded by the tracer, the
audit log and the SLO tracker, and by the server once per audit line:

  * ``cedar_trace_kept_total{path,reason}`` (reason: sampled, slow, error,
    fallback);
  * ``cedar_audit_records_total{path}`` and
    ``cedar_audit_rotations_total``;
  * ``cedar_slo_burn_rate{path,slo,window}`` and
    ``cedar_slo_target{path,slo}``, refreshed at each /metrics scrape.

And so are the overload-control plane's (load/), recorded by the
admission controller and the adaptive batch tuners:

  * ``cedar_load_shed_total{priority,reason}``,
    ``cedar_inflight_requests{path,priority}`` and ``cedar_load_state``;
  * ``cedar_batch_tuning{path,param}``;
  * ``cedar_client_throttled_total{client}``, its client label capped at
    64 distinct ids (later ones fold into ``other``, counted by
    ``cedar_client_label_overflow_total``).

And so are the explain plane's (explain/), recorded by the server's
``?explain=1`` handlers and the explain plane:

  * ``cedar_explain_requests_total{path}`` and
    ``cedar_explain_compiles_total`` (in the port: explain calls that
    built the float plane of a set that was never warmed; 0 on a server,
    whose loads all warm).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

SUBSYSTEM = "cedar_authorizer"

_Key = Tuple[Tuple[str, str], ...]


def _fmt_label(labels: _Key) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _fmt_value(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


class Counter:
    def __init__(self, name: str, help_text: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._values: Dict[_Key, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple((k, labels.get(k, "")) for k in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple((k, labels.get(k, "")) for k in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key in sorted(self._values):
                out.append(f"{self.name}{_fmt_label(key)} {_fmt_value(self._values[key])}")
        return out


class Gauge:
    def __init__(self, name: str, help_text: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._values: Dict[_Key, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels) -> None:
        key = tuple((k, labels.get(k, "")) for k in self.label_names)
        with self._lock:
            self._values[key] = value

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key in sorted(self._values):
                out.append(f"{self.name}{_fmt_label(key)} {_fmt_value(self._values[key])}")
        return out


class Histogram:
    def __init__(
        self,
        name: str,
        help_text: str,
        label_names: Sequence[str],
        buckets: Sequence[float],
    ):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[_Key, List[int]] = {}
        self._sums: Dict[_Key, float] = {}
        self._totals: Dict[_Key, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = tuple((k, labels.get(k, "")) for k in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def fraction_over(self, bound: float) -> Dict[_Key, float]:
        """Per-label-set fraction of observations strictly above the
        largest bucket <= ``bound``: the public read of the SLO plane's
        histogram cross-check (obs/slo.py slo_from_histogram)."""
        out: Dict[_Key, float] = {}
        with self._lock:
            for key, counts in self._counts.items():
                total = self._totals.get(key, 0)
                if not total:
                    continue
                under = 0
                for b, c in zip(self.buckets, counts):
                    if b <= bound:
                        under = c
                out[key] = 1.0 - under / total
        return out

    def totals(self, **labels) -> Tuple[int, float]:
        """(observation count, sum) of one label set."""
        key = tuple((k, labels.get(k, "")) for k in self.label_names)
        with self._lock:
            return self._totals.get(key, 0), self._sums.get(key, 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key in sorted(self._counts):
                for i, b in enumerate(self.buckets):
                    labels = key + (("le", _fmt_value(b)),)
                    out.append(f"{self.name}_bucket{_fmt_label(labels)} {self._counts[key][i]}")
                inf_labels = key + (("le", "+Inf"),)
                out.append(f"{self.name}_bucket{_fmt_label(inf_labels)} {self._totals[key]}")
                out.append(f"{self.name}_sum{_fmt_label(key)} {_fmt_value(self._sums[key])}")
                out.append(f"{self.name}_count{_fmt_label(key)} {self._totals[key]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def expose(self) -> str:
        with self._lock:
            metrics = list(self._metrics)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


class _FastPathFamilies:
    """The fast path's row routing and packed-decode counts
    (engine/fastpath.py ``routing``, ``packed_transfers``,
    ``packed_chunks``) rendered as counters at scrape time. Zero rows
    are left out, as the JAX package records only nonzero increments."""

    def __init__(self, path: str, fastpath):
        self.path = path
        self.fastpath = fastpath

    def collect(self) -> List[str]:
        fp = self.fastpath
        routing = Counter(
            f"{SUBSYSTEM}_row_routing_total",
            "Fast-path rows partitioned by routing class: clean_native rows "
            "decode on device verdicts alone; gated rows matched the scope of "
            "a fallback/native-opaque policy and re-ran the exact Python path; "
            "flagged rows needed a rule-bitset fetch (multi-policy/error "
            "verdicts); encoder_fallback rows the C++ encoder could not prove "
            "equivalent (parse quirks, extras overflow); encoder_gate rows "
            "short-circuited in the encoder (self-allow, system skip).",
            ["path", "row_class"],
        )
        for row_class, n in dict(fp.routing).items():
            if n:
                routing.inc(n, path=self.path, row_class=row_class)
        transfers = Counter(
            "cedar_packed_decode_transfers_total",
            "Batch-wide packed verdict-word D2H transfers (one per native "
            "batch), partitioned by serving path.",
            ["path"],
        )
        chunks = Counter(
            "cedar_packed_decode_chunks_total",
            "Chunk word arrays folded into packed D2H transfers; divide by "
            "transfers for the fold factor.",
            ["path"],
        )
        if fp.packed_transfers:
            transfers.inc(fp.packed_transfers, path=self.path)
        if fp.packed_chunks:
            chunks.inc(fp.packed_chunks, path=self.path)
        return routing.collect() + transfers.collect() + chunks.collect()


class _ProcessFamilies:
    """The process-wide resilience families (module docstring)."""

    def __init__(self):
        self.breaker_state = Gauge(
            f"{SUBSYSTEM}_breaker_state",
            "Circuit breaker state per evaluation engine: 0 closed (device "
            "plane healthy), 1 open (requests answer the failure posture "
            "without reaching the device), 2 half-open (probing recovery).",
            ["engine"],
        )
        self.breaker_transitions_total = Counter(
            f"{SUBSYSTEM}_breaker_transitions_total",
            "Circuit breaker state transitions partitioned by engine and "
            "destination state.",
            ["engine", "to"],
        )
        self.supervisor_restarts_total = Counter(
            "cedar_supervisor_restarts_total",
            "Component restarts performed by the supervisor watchdog, "
            "partitioned by component and replica (empty on the single-engine "
            "path). Dead threads and wedged (stale busy heartbeat) stages "
            "both count; batches held by a restarted stage are answered with "
            "the failure posture rather than stranded.",
            ["component", "replica"],
        )
        self.device_rebuilds_total = Counter(
            "cedar_device_rebuilds_total",
            "Engine rebuilds performed by the device-loss recovery: a fatal "
            "device error tripped the breaker, the compiled set was re-placed "
            "on the card from its retained host-side pack and warmed there "
            "before it was published, and the breaker re-armed half-open.",
            [],
        )
        self.chaos_injections_total = Counter(
            "cedar_chaos_injections_total",
            "Faults injected by the chaos plane, partitioned by seam and kind "
            "(error / latency / corrupt / kill / response_error / "
            "response_deny). Nonzero only while a game-day scenario is armed; "
            "it should never move outside game days.",
            ["seam", "kind"],
        )
        self.worker_deaths_total = Counter(
            "cedar_worker_deaths_total",
            "Long-lived worker threads that exited on an uncaught exception, "
            "partitioned by component (crd.watch: a CRD store's list+watch "
            "thread) and replica (empty on the single-engine path). Any "
            "nonzero rate is a bug or an injected fault; the supervisor "
            "restarts the worker.",
            ["component", "replica"],
        )
        self.device_rebuilds_total.inc(0)
        self.fallback_decisions_total = Counter(
            "cedar_fallback_decisions_total",
            "Decisions whose evaluation was interpreter-merged because the "
            "serving plane carries unlowerable policies, partitioned by "
            "Unlowerable reason code (one increment per decision per distinct "
            "code present) and serving engine (authorization/admission/"
            "replica — names come from code, never request data, so the "
            "label set is bounded). The burn-down signal for the "
            "lowerability coverage drive: lowering a construct family drops "
            "its code's rate to zero (docs/analysis.md; tallied on "
            "/debug/engine).",
            ["code", "engine"],
        )
        # the static-analysis families describe the POLICY SET, not
        # request traffic, and are re-published at every analyzed load
        self.policy_fastpath_lowerable = Gauge(
            "cedar_policy_fastpath_lowerable",
            "Policies per tier the compiler lowers to the TPU fast path; the "
            "remainder evaluate on the per-row Python interpreter fallback. A "
            "drop after a policy deploy is the early signal of a latency "
            "regression (docs/analysis.md).",
            ["tier"],
        )
        self.policy_analysis_findings_total = Counter(
            "cedar_policy_analysis_findings_total",
            "Static-analysis findings observed at policy load, partitioned by "
            "reason code (docs/analysis.md catalog). Counted per load pass: "
            "alert on new codes appearing, not on magnitude.",
            ["kind"],
        )
        # the decision cache's families (cache/): each cache object
        # records its own path's series, as the JAX package's does
        self.decision_cache_hits_total = Counter(
            "cedar_decision_cache_hits_total",
            "Decision cache lookups answered from cache, partitioned by path "
            "(authorization / admission). A hit returns without any engine or "
            "interpreter evaluation.",
            ["path"],
        )
        self.decision_cache_misses_total = Counter(
            "cedar_decision_cache_misses_total",
            "Decision cache lookups that fell through to evaluation, "
            "partitioned by path. Expired-TTL and stale-generation entries "
            "count as misses (and as evictions).",
            ["path"],
        )
        self.decision_cache_evictions_total = Counter(
            "cedar_decision_cache_evictions_total",
            "Decision cache entries dropped, partitioned by path and reason "
            "(lru: capacity pressure; ttl: decision-class TTL elapsed; "
            "generation: policy-set reload invalidated the entry; flush: "
            "operator/test invalidate_all). A persistent lru rate means the "
            "working set exceeds --decision-cache-size.",
            ["path", "reason"],
        )
        self.decision_cache_coalesced_total = Counter(
            "cedar_decision_cache_coalesced_total",
            "Requests that attached to an in-flight identical evaluation "
            "(singleflight followers), partitioned by path. These requests "
            "neither hit nor evaluated: they waited for a concurrent leader.",
            ["path"],
        )
        self.decision_cache_size = Gauge(
            "cedar_decision_cache_size",
            "Current decision cache entry count, partitioned by path.",
            ["path"],
        )
        self.decision_cache_hit_ratio = Gauge(
            "cedar_decision_cache_hit_ratio",
            "Lifetime hits / (hits + misses), partitioned by path. Alert on a "
            "sustained drop: repetitive apiserver traffic should hold a high "
            "ratio, and a collapse usually means TTLs are too short or policy "
            "reloads are churning generations.",
            ["path"],
        )
        # the observability plane's families (obs/)
        self.trace_kept_total = Counter(
            "cedar_trace_kept_total",
            "Finished request traces kept into the /debug/traces ring, "
            "partitioned by path and keep reason (sampled: head sampling; "
            "slow: tail-keep past the tail latency budget; error: the "
            "request answered with an evaluation error; fallback: answered "
            "with the failure posture). A rising error/fallback rate with "
            "sampled flat is the tracing plane catching exactly the requests "
            "head sampling would have missed.",
            ["path", "reason"],
        )
        self.audit_records_total = Counter(
            "cedar_audit_records_total",
            "Decision audit log lines appended, partitioned by path. Compare "
            "with the requests answered: a persistent gap means audit "
            "appends are failing (the log disables itself on I/O errors "
            "rather than slowing serving).",
            ["path"],
        )
        self.audit_rotations_total = Counter(
            "cedar_audit_rotations_total",
            "Size-based audit log rotations (<path> -> <path>.1 shifts).",
            [],
        )
        self.slo_burn_rate = Gauge(
            "cedar_slo_burn_rate",
            "Error-budget burn rate per path, objective (availability / "
            "latency) and trailing window (5m / 1h / 6h): bad-request "
            "fraction over the window divided by the objective's error "
            "budget. 1.0 consumes the budget exactly at the sustain rate; "
            "the canonical fast-burn page is rate > 14.4 on the short window "
            "AND > 1 on the long one.",
            ["path", "slo", "window"],
        )
        self.slo_target = Gauge(
            "cedar_slo_target",
            "Configured SLO target per path and objective (availability: "
            "non-error answer fraction; latency: fraction answered within "
            "the latency budget).",
            ["path", "slo"],
        )
        # the overload-control plane's families (load/)
        self.load_shed_total = Counter(
            "cedar_load_shed_total",
            "Requests refused by the overload-control plane, by priority and "
            "reason (load_pressure / load_overload / saturated / client_quota "
            "/ eval_saturated / chaos). Sheds answer honestly — SAR NoOpinion "
            "+ Retry-After, admission per the fail-open/closed flag — and "
            "offered == admitted + shed holds exactly at the ingress gate.",
            ["priority", "reason"],
        )
        self.inflight_requests = Gauge(
            "cedar_inflight_requests",
            "Admitted requests currently in flight (queue wait + evaluation), "
            "per path and priority — the load signal the admission "
            "controller's graduated states derive from.",
            ["path", "priority"],
        )
        self.load_state = Gauge(
            "cedar_load_state",
            "Graduated overload state: 0 ok, 1 pressure (sheddable traffic "
            "shedding), 2 overload (normal traffic shedding), 3 saturated "
            "(everything sheds; /readyz reads 503).",
            [],
        )
        self.batch_tuning = Gauge(
            "cedar_batch_tuning",
            "Live value of each adaptive-batching knob per serving path "
            "(param: max_batch, linger_us) — watch the SLO-adaptive "
            "controller move during a storm (decision log at /debug/load).",
            ["path", "param"],
        )
        self.client_throttled_total = Counter(
            "cedar_client_throttled_total",
            "Requests shed by a per-client fair-share quota, by client "
            "(the SAR/admission username; CAPPED at 64 distinct ids, later "
            "ids fold into `other` — cedar_client_label_overflow_total "
            "counts the folds).",
            ["client"],
        )
        self.client_label_overflow_total = Counter(
            "cedar_client_label_overflow_total",
            "Client-labeled throttle observations folded into `other` "
            "because the bounded client label set was full.",
            [],
        )
        self._client_labels: set = set()
        self._client_label_lock = threading.Lock()
        # the explain plane's families (explain/): the JAX names and help
        self.explain_requests_total = Counter(
            "cedar_explain_requests_total",
            "?explain=1 requests answered, partitioned by path (authorization "
            "/ admission). Explain traffic bypasses the decision cache and "
            "the batchers by design — a sustained high rate is an operator "
            "debugging session, not serving load (docs/explainability.md).",
            ["path"],
        )
        self.explain_compiles_total = Counter(
            "cedar_explain_compiles_total",
            "Fresh kernel traces paid by the lazily-compiled explain plane "
            "(the standalone bits shape, on first ?explain use per compiled "
            "set). Zero until the first explain request per (engine, "
            "generation) — the pay-for-use contract; nonzero growth outside "
            "policy reloads means explain traffic is hitting cold sets.",
            [],
        )
        self.explain_compiles_total.inc(0)
        self._families = (
            self.breaker_state, self.breaker_transitions_total,
            self.supervisor_restarts_total, self.device_rebuilds_total,
            self.chaos_injections_total, self.worker_deaths_total,
            self.fallback_decisions_total, self.policy_fastpath_lowerable,
            self.policy_analysis_findings_total,
            self.decision_cache_hits_total, self.decision_cache_misses_total,
            self.decision_cache_evictions_total, self.decision_cache_coalesced_total,
            self.decision_cache_size, self.decision_cache_hit_ratio,
            self.trace_kept_total, self.audit_records_total, self.audit_rotations_total,
            self.slo_burn_rate, self.slo_target,
            self.load_shed_total, self.inflight_requests, self.load_state,
            self.batch_tuning, self.client_throttled_total,
            self.client_label_overflow_total,
            self.explain_requests_total, self.explain_compiles_total,
        )

    def collect(self) -> List[str]:
        out: List[str] = []
        for family in self._families:
            out.extend(family.collect())
        return out


_PROCESS = _ProcessFamilies()


def process_metrics() -> _ProcessFamilies:
    """The process-wide resilience families (module docstring)."""
    return _PROCESS


def set_breaker_state(engine: str, state_code: int) -> None:
    _PROCESS.breaker_state.set(state_code, engine=engine)


def record_breaker_transition(engine: str, to_state: str) -> None:
    _PROCESS.breaker_transitions_total.inc(engine=engine, to=to_state)


def record_supervisor_restart(component: str, replica: str = "") -> None:
    _PROCESS.supervisor_restarts_total.inc(component=component, replica=replica)


def record_device_rebuild() -> None:
    _PROCESS.device_rebuilds_total.inc()


def record_chaos_injection(seam: str, kind: str) -> None:
    _PROCESS.chaos_injections_total.inc(seam=seam, kind=kind)


def record_worker_death(component: str, replica: str = "") -> None:
    _PROCESS.worker_deaths_total.inc(component=component, replica=replica)


def record_fallback_decision(codes, engine: str = "") -> None:
    """One interpreter-merged decision under each distinct Unlowerable
    code it was served with (precomputed tuple, compiler/pack.py), on the
    named serving engine."""
    eng = engine or "unknown"
    for code in codes or ("unlowerable",):
        _PROCESS.fallback_decisions_total.inc(code=code, engine=eng)


def fallback_decision_counts(engine=None) -> dict:
    """Per-code snapshot of cedar_fallback_decisions_total for
    /debug/engine and /debug/analysis: codes aggregated across all
    engines by default, or one serving plane's slice when ``engine`` is
    given (``<engine>`` and its replicas ``<engine>-r<i>``), so an
    authorization plane's served fallback traffic never reads as the
    admission plane's burn-down signal."""
    family = _PROCESS.fallback_decisions_total
    with family._lock:
        out: dict = {}
        for key, v in family._values.items():
            kd = dict(key)
            if engine is not None:
                got = kd.get("engine", "")
                if got != engine and not got.startswith(f"{engine}-r"):
                    continue
            code = kd.get("code", "")
            out[code] = out.get(code, 0) + int(v)
        return out


def set_fastpath_lowerable(tier: int, count: int) -> None:
    _PROCESS.policy_fastpath_lowerable.set(count, tier=str(tier))


def record_analysis_findings(kind: str, n: int) -> None:
    if n:
        _PROCESS.policy_analysis_findings_total.inc(n, kind=kind)


def record_cache_hit(path: str) -> None:
    _PROCESS.decision_cache_hits_total.inc(path=path)


def record_cache_miss(path: str) -> None:
    _PROCESS.decision_cache_misses_total.inc(path=path)


def record_cache_evictions(path: str, reason: str, n: int = 1) -> None:
    if n:
        _PROCESS.decision_cache_evictions_total.inc(n, path=path, reason=reason)


def record_cache_coalesced(path: str) -> None:
    _PROCESS.decision_cache_coalesced_total.inc(path=path)


def set_cache_size(path: str, size: int) -> None:
    _PROCESS.decision_cache_size.set(size, path=path)


def set_cache_hit_ratio(path: str, ratio: float) -> None:
    _PROCESS.decision_cache_hit_ratio.set(round(ratio, 6), path=path)


def record_trace_kept(path: str, reason: str) -> None:
    _PROCESS.trace_kept_total.inc(path=path, reason=reason)


def record_audit_record(path: str) -> None:
    _PROCESS.audit_records_total.inc(path=path)


def record_audit_rotation() -> None:
    _PROCESS.audit_rotations_total.inc()


def set_slo_burn_rate(path: str, slo: str, window: str, rate: float) -> None:
    _PROCESS.slo_burn_rate.set(round(rate, 4), path=path, slo=slo, window=window)


def set_slo_target(path: str, slo: str, value: float) -> None:
    _PROCESS.slo_target.set(value, path=path, slo=slo)


# the client label of cedar_client_throttled_total is bounded: a reconnect
# storm minting principals must not explode the exposition
_CLIENT_LABEL_CAP = 64


def record_load_shed(priority: str, reason: str) -> None:
    _PROCESS.load_shed_total.inc(priority=priority, reason=reason)


def set_inflight(path: str, priority: str, n: int) -> None:
    _PROCESS.inflight_requests.set(n, path=path, priority=priority)


def set_load_state(code: int) -> None:
    _PROCESS.load_state.set(code)


def set_batch_tuning(path: str, param: str, value: float) -> None:
    _PROCESS.batch_tuning.set(value, path=path, param=param)


def record_client_throttled(client: str) -> None:
    with _PROCESS._client_label_lock:
        labels = _PROCESS._client_labels
        if client != "other" and client not in labels:
            if len(labels) >= _CLIENT_LABEL_CAP:
                _PROCESS.client_label_overflow_total.inc()
                client = "other"
            else:
                labels.add(client)
    _PROCESS.client_throttled_total.inc(client=client)


def record_explain_request(path: str) -> None:
    _PROCESS.explain_requests_total.inc(path=path)


def record_explain_compiles(n: int) -> None:
    if n:
        _PROCESS.explain_compiles_total.inc(n)


class WebhookMetrics:
    """One server's metric families (module docstring) and the record
    functions its serving code calls."""

    def __init__(self):
        self.registry = Registry()
        reg = self.registry.register
        self.request_total = reg(Counter(
            f"{SUBSYSTEM}_request_total",
            "Number of HTTP requests partitioned by authorization decision.",
            ["decision"],
        ))
        self.request_latency = reg(Histogram(
            f"{SUBSYSTEM}_request_duration_seconds",
            "Request latency in seconds partitioned by authorization decision.",
            ["decision"],
            [0.25, 0.5, 0.7, 1, 1.5, 3, 5, 10],
        ))
        self.deadline_exceeded_total = reg(Counter(
            f"{SUBSYSTEM}_deadline_exceeded_total",
            "Requests whose per-request deadline budget elapsed before a batch "
            "result arrived; authorization answers NoOpinion+evaluationError, "
            "admission the configured fail-mode.",
            ["path"],
        ))
        self.requests_shed_total = reg(Counter(
            f"{SUBSYSTEM}_requests_shed_total",
            "Requests refused with 503 because the server is draining for shutdown.",
            ["path"],
        ))
        self.fallback_batches_total = reg(Counter(
            f"{SUBSYSTEM}_fallback_batches_total",
            "Evaluation work the device plane did not serve, partitioned by "
            "path and reason (breaker_open: the circuit breaker rejected the "
            "work, per request before the batcher or per queued batch at "
            "encode; evaluator_error: the device evaluation raised, per "
            "batch). The port has no interpreter fallback: this work was "
            "answered with the failure posture (NoOpinion + evaluationError, "
            "the admission fail-mode), not re-run.",
            ["path", "reason"],
        ))
        for path in ("admission", "authorization"):
            for reason in ("breaker_open", "evaluator_error"):
                self.fallback_batches_total.inc(0, path=path, reason=reason)
        self.batch_occupancy = reg(Histogram(
            "cedar_batch_occupancy",
            "Rows per formed micro-batch, partitioned by path.",
            ["path"],
            [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384],
        ))
        self.pipeline_stall_seconds_total = reg(Counter(
            "cedar_pipeline_stall_seconds_total",
            "Seconds a pipeline stage spent stalled, partitioned by path and "
            "stage: collect = the collector blocked on a full dispatch queue "
            "(device/decode backpressure); dispatch = the dispatch thread "
            "waited on an encode worker (encode-bound); decode = the decode "
            "thread sat idle while batches were in flight (starvation).",
            ["path", "stage"],
        ))
        self.pipeline_stage_seconds = reg(Histogram(
            "cedar_pipeline_stage_seconds",
            "Per-batch pipeline stage latency partitioned by path and stage "
            "(queue_wait: oldest submit -> batch claim; encode / dispatch / "
            "decode on the pipelined batcher; evaluate on the serial one).",
            ["path", "stage"],
            [
                0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            ],
        ))
        self.native_encode_threads = reg(Gauge(
            "cedar_native_encode_threads",
            "Resolved per-batch native encoder worker-pool width "
            "(CEDAR_NATIVE_THREADS / --native-encode-threads / cpu count).",
            [],
        ))

        self.compile_seconds = reg(Histogram(
            "cedar_compile_seconds",
            "Policy-set compilation latency partitioned by phase (analyze = "
            "the load-time analysis gate, hash = the "
            "shard plan's content hashes, lower = lowering, pack = plane "
            "assembly, place = device placement, warm = the new plane's "
            "warm-up on the device before the swap, total) and scope (full = "
            "the whole corpus lowered, incremental = only the dirty shards).",
            ["phase", "scope"],
            [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120],
        ))
        self.policy_shards = reg(Gauge(
            "cedar_policy_shards",
            "Tier/bucket shards in the engine's current compiled plane, "
            "partitioned by engine.",
            ["engine"],
        ))
        self.dirty_shards = reg(Gauge(
            "cedar_dirty_shards",
            "Shards recompiled by the engine's LAST reload (0 after a no-op "
            "reload, 1 after a single-policy CRD edit, = cedar_policy_shards "
            "after a full compile), partitioned by engine.",
            ["engine"],
        ))

        reg(_PROCESS)

    def add_fastpath(self, path: str, fastpath) -> None:
        """Render this fast path's routing and packed-decode counts."""
        self.registry.register(_FastPathFamilies(path, fastpath))

    def expose(self) -> str:
        return self.registry.expose()

    # ------------------------------------------------------------ recording

    def record_request(self, decision: str, latency_s: float) -> None:
        self.request_total.inc(decision=decision)
        self.request_latency.observe(latency_s, decision=decision)

    def record_deadline_exceeded(self, path: str) -> None:
        self.deadline_exceeded_total.inc(path=path)

    def record_shed(self, path: str) -> None:
        self.requests_shed_total.inc(path=path)

    def record_fallback_batch(self, path: str, reason: str) -> None:
        self.fallback_batches_total.inc(path=path, reason=reason)

    def record_batch_occupancy(self, path: str, n: int) -> None:
        self.batch_occupancy.observe(n, path=path)

    def record_pipeline_stall(self, path: str, stage: str, seconds: float) -> None:
        if seconds > 0:
            self.pipeline_stall_seconds_total.inc(seconds, path=path, stage=stage)

    def record_pipeline_stage(self, path: str, stage: str, seconds: float) -> None:
        if seconds >= 0:
            self.pipeline_stage_seconds.observe(seconds, path=path, stage=stage)

    def record_compile(self, stats: dict, engine: str = "authorization") -> None:
        """One engine load's compile stats (TorchPolicyEngine.load): its
        phase seconds and the engine's shard gauges."""
        scope = stats.get("compile_scope", "full")
        for phase, seconds in stats["compile_seconds"].items():
            self.compile_seconds.observe(seconds, phase=phase, scope=scope)
        self.policy_shards.set(stats.get("shards", 0), engine=engine)
        self.dirty_shards.set(stats.get("dirty_shards", 0), engine=engine)

    def set_native_encode_threads(self, n: int) -> None:
        self.native_encode_threads.set(n)
