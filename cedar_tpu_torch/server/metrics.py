"""Prometheus metrics of the webhook, with the text exposition.

The families this slice records, with the JAX package's names, labels and
buckets (its server/metrics.py; request families as the reference's
internal/server/metrics/metrics.go):

  * ``cedar_authorizer_request_total{decision}`` and
    ``cedar_authorizer_request_duration_seconds{decision}``;
  * ``cedar_authorizer_deadline_exceeded_total{path}``,
    ``cedar_authorizer_requests_shed_total{path}`` (drain) and
    ``cedar_authorizer_fallback_batches_total{path,reason}``, which the
    port never increments (no path re-runs a batch on the interpreter), so
    /metrics shows it at 0;
  * ``cedar_batch_occupancy{path}``,
    ``cedar_pipeline_stall_seconds_total{path,stage}`` and
    ``cedar_pipeline_stage_seconds{path,stage}`` from the batcher;
  * ``cedar_authorizer_row_routing_total{path,row_class}`` and
    ``cedar_packed_decode_{transfers,chunks}_total{path}``, read from the
    fast path's own counts at scrape time;
  * ``cedar_native_encode_threads``;
  * ``cedar_compile_seconds{phase,scope}``: one observation per phase
    (lower, pack, place, warm, total) of every engine load, the initial
    ones and each reload's; scope is always ``full`` (every load
    recompiles the whole corpus).

The batch, pipeline, deadline, shed, routing and packed-decode families
carry a ``path`` label: ``authorization`` for /v1/authorize and
``admission`` for /v1/admit. The request families stay
authorization-only, as in the JAX package.

Each server owns one ``WebhookMetrics`` (its own registry), so two servers
in one process never mix their counts.
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
            "Evaluation work served by the Python interpreter fallback instead "
            "of the device plane, partitioned by path and reason. The port has "
            "no such fallback: it stays 0.",
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
            "Policy-set compilation latency partitioned by phase (lower = "
            "lowering, pack = plane assembly, place = device placement, warm = "
            "the new plane's warm-up on the device before the swap, total) and "
            "scope (full = the whole corpus recompiled).",
            ["phase", "scope"],
            [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120],
        ))

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

    def record_compile(self, stats: dict) -> None:
        """One engine load's compile stats (TorchPolicyEngine.load)."""
        scope = stats.get("compile_scope", "full")
        for phase, seconds in stats["compile_seconds"].items():
            self.compile_seconds.observe(seconds, phase=phase, scope=scope)

    def set_native_encode_threads(self, n: int) -> None:
        self.native_encode_threads.set(n)
