"""cedar-webhook (port): the authorization and admission webhook on the card.

    python -m cedar_tpu_torch.cli.webhook --config store-config.json --insecure

Wiring of the JAX package's cli/webhook.py for two engines and two entry
points: read the store config, build the tiered stores (directory, CRD and
Verified Permissions stores in any tier order; a CRD store watches the
apiserver of ``--kubeconfig``, which may be JSON and then needs no
PyYAML), wait for their initial loads, and compile two
tier stacks on ``--device`` (CUDA unless ``--device cpu`` is given;
without CUDA the start fails), each into its own TorchPolicyEngine: the
authorization stack (the stores) and the admission stack (the same stores
plus the constant allow-all final tier, as the reference's
cmd/cedar-webhook/main.go:111-116 builds it). In front of each, its native
fast path and micro-batcher; the server answers ``POST /v1/authorize``
and ``POST /v1/admit`` (TLS with self-signed certs unless ``--insecure``
or cert files are given) plus the plain health and metrics server.

``--backend device`` (the default) serves from the engines;
``--backend interpreter`` serves from the Python interpreter only, with no
engine. ``--admission-fail-mode`` says what /v1/admit answers when an
evaluation fails or outlives its deadline.

Policy reload: each directory store re-reads its files every
refreshInterval (StoreConfig), a CRD store applies each Policy object
event of its watch, and one TorchReloader polls the stores' content
generations every ``--reload-seconds``. When they change it reloads both
engines, the authorization engine first. Both engines compile
incrementally (``--shard-buckets`` buckets per tier): only the (tier,
bucket) shards whose content changed are re-lowered, so a one-object CRD
edit re-lowers only its own shards; ``--no-incremental-compile``
recompiles the whole corpus on every reload. Each new plane is packed,
placed and warmed on the device and only then swapped in. A reload that
fails is logged and leaves the previous plane (and its shard map)
serving; the next tick tries again. A relist or a metadata-only Policy
update leaves the content generations, so nothing reloads. With
``--backend interpreter`` the stores alone keep the answers current.

Resilience, as the JAX CLI deploys it: a circuit breaker per engine
(``--breaker-*``; 0 failures disables it), a DeviceRecovery per engine
that rebuilds the plane on the card after a fatal device error, and the
Supervisor watchdog (``--supervisor-*``; interval 0 disables both) over
both batchers, every directory store's reload ticker and every CRD
store's list+watch thread. While a breaker
is open its endpoint answers the failure posture (NoOpinion +
evaluationError, the admission fail-mode); nothing re-runs on the
interpreter. ``--confirm-non-prod-inject-errors`` opens the
``/chaos/*`` control endpoints and allows ``--chaos-scenario`` (a builtin
name or a scenario JSON file, armed at start).

Load-time analysis: ``--validation-mode`` (else the config's
``spec.validationMode``, default permissive) gates every engine load of
both stacks (analysis/loadgate.py) and each CRD Policy object. Strict
rejects a corpus with blocking findings: a reload keeps the previous
plane, and at start-up the CLI exits 1 with the rejection, since there
is no previous plane and no interpreter fallback (the JAX CLI serves the
raw stores from its interpreter then). Partial compiles the corpus
without the offending policies; permissive publishes the findings.
``/debug/analysis`` serves the last report of each stack.

Decision cache: ``--decision-cache-size`` (default 65536, 0 disables it)
puts a canonical-fingerprint LRU+TTL cache with per-class TTLs
(``--decision-cache-{allow,deny,no-opinion}-ttl-seconds``) in front of
/v1/authorize, read before the breaker and the batcher; its entries are
stamped with the authorization engine's shard lineage, so an incremental
reload kills only the entries its dirty shards decided or that a policy
it added could decide.
``--decision-cache-admission`` gives the admission handler its own cache
for CONNECT and dry-run reviews. ``/debug/cache`` serves their stats.

Observability, with the JAX CLI's defaults: tracing is armed at sample
rate 0 (``--trace-sample-rate``; slow, errored and posture-answered
requests are still tail-kept past ``--trace-tail-ms``, 0 = the request
budget) into a ring of ``--trace-ring`` traces behind ``/debug/traces``,
appended to ``--trace-log-file`` when given (``--no-trace`` drops the
plane); the SLO tracker is on (``--slo-availability-target``, 0 disables
it; ``--slo-latency-target``, ``--slo-latency-budget-ms``, 0 = the
request budget) behind ``/debug/slo`` and ``cedar_slo_*``;
``--audit-log-file`` writes one line per decision, rotated by size.
``--enable-recording`` writes every POST body under ``--recording-dir``;
``--artificial-error-rate`` and ``--artificial-deny-rate`` swap
/v1/authorize answers at those rates per second, only with
``--confirm-non-prod-inject-errors``.

Overload control, with the JAX CLI's flags and defaults: ``--max-inflight``
(0, the default, wires no gate) sizes the priority-aware ingress gate
(load/admission.py: ``--shed-sheddable-at``, ``--shed-normal-at``, the
per-client quota ``--client-qps`` / ``--client-burst`` /
``--client-enforce-at``, ``--shed-retry-after-seconds``) in front of both
endpoints; ``--adaptive-batching`` runs one SLO-adaptive batch tuner per
batcher (load/tuner.py, ``--tuner-*``), under the supervisor as
``tuner.<path>``, and needs the SLO tracker. On the card every load and
rebuild then warms each engine up to ``max(--max-batch,
--tuner-max-batch)`` (at most 32768 rows), so no batch the tuner grows to
meets a cold bucket. ``/debug/load`` serves both.

Shadow rollout, with the JAX CLI's flags and defaults: with the device
backend a RolloutController (rollout/) stands beside both engines.
``--rollout-candidate-dir`` stages a candidate directory at start; ``POST
/rollout/stage|promote|rollback`` on the metrics port drive the lifecycle
(``{"crd": true}`` stages the CRD stores' candidate-labelled objects) and
answer 403 unless ``--rollout-control-token-file`` (then as a bearer
token; an empty file refuses to start) or ``--rollout-insecure-control``
is given. The shadow worker evaluates ``--shadow-sample-rate`` of the live
answers on the candidate engines through a queue of
``--shadow-queue-depth`` at a duty cycle of ``--shadow-duty-cycle``, under
the supervisor as ``shadow.worker``; lifecycle steps land in the audit
log. ``/debug/rollout`` serves its state and diff report.

Declarative lifecycle, with the JAX CLI's flags and defaults:
``--lifecycle-spec-dir DIR`` loads every PolicyRollout manifest there
(lifecycle/spec.py) and drives each through verify -> [analyze] -> shadow
-> promote on the rollout controller (lifecycle/controller.py), ticking
every ``--lifecycle-interval-seconds``; the analyze gate diffs the
candidate against the tiers the authorization engine compiles from. It
needs the rollout plane (the device backend). ``--lifecycle-journal-file``
is the transitions' write-ahead journal: a restart replays it, unwinds
what was in flight and restarts it from pending. ``/debug/lifecycle``
serves the controller's status and ``POST /lifecycle/approve`` gives a
manual promotion its consent, behind the rollout control gate.
``--profiling`` serves ``/debug/pprof/profile`` (a one-second sampler of
every thread) and ``/debug/pprof/*`` (a dump of every thread) on the
webhook listener.

Multi-tenant shared plane, with the JAX CLI's flags and defaults:
``--tenant NAME=POLICY_DIR`` (repeatable) registers a tenant served from a
directory store that re-reads its files every ``max(1, --reload-seconds)``
seconds; the tenants' policies fuse (tenancy/ TenantRegistry: per-tenant
clones with a tenant guard, each tenant's own validationMode gate on its
originals) into the one tier stack both engines compile, in place of the
config's stores, so one pair of card engines and one batcher per path
serve every tenant. The front end (tenancy/ TenantResolver) resolves each
request's tenant from the ``/t/<name>/...`` path prefix, the
``--tenant-header`` header, a ``--tenant-host HOST=NAME`` map or
``--tenant-default``, trusting only ``--tenant-sources``; an unresolved,
unknown or conflicting tenant is refused before evaluation.
``/debug/tenancy`` serves the front end and the registry. ``--tenant``
refuses to start with the shadow-rollout flags and with
``--enable-recording``, as the JAX CLI does.

The general PDP front end (pdp/), with the JAX CLI's flags:
``--pdp-listen [ADDR:]PORT`` starts a plain-HTTP listener (ADDR defaults
to ``--bind-address``) on which ``POST /v1/batch-authorize`` is the
AVP-style batch API and every other request an Envoy ext_authz check;
both map into synthetic SARs served by the same engines, batchers, cache
and admission gate as the webhook. ``--pdp-schema FILE`` is its mapping
and fail-posture JSON (pdp/config.py; unknown keys refused). Both are
read before any store starts, so a bad file or address fails the start.

Flags of the JAX CLI that this port does not serve (fleet, partition
specs, ...) do not exist here, so argparse rejects them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import logging
import signal
import sys
import threading
import time
from typing import List, Optional

from ..server.admission import CedarAdmissionHandler, allow_all_admission_policy_store
from ..server.authorizer import CedarWebhookAuthorizer
from ..server.certs import maybe_self_signed_certs
from ..server.http import DEFAULT_ADDRESS, DEFAULT_PORT, METRICS_PORT, WebhookServer
from ..server.metrics import WebhookMetrics
from ..stores.config import cedar_config_stores, parse_config
from ..stores.store import TieredPolicyStores

log = logging.getLogger(__name__)

# Loads run one at a time in the process, with the cyclic garbage
# collector paused, and what survives a load is frozen (gc.freeze)
# afterwards. A full collection walks every tracked object (the corpus
# and every compiled set) in one call that holds the interpreter lock, so
# all serving threads stop for it, and a compile allocates enough to set
# off such collections. A load makes no cyclic garbage (its old set is
# freed by reference counting), so pausing the collector loses nothing,
# and once frozen the long-lived sets are skipped by every later
# collection. After a failed load nothing is frozen: its traceback's
# cycles must stay collectable. A device rebuild (server/supervisor.py
# DeviceRecovery) runs under the same lock with the collector paused and
# freezes nothing (_rebuild_paused).
_load_lock = threading.Lock()


@contextlib.contextmanager
def _collector_paused(freeze: bool = True):
    with _load_lock:
        enabled = gc.isenabled()
        gc.disable()
        try:
            yield
            if freeze:
                gc.freeze()
        finally:
            if enabled:
                gc.enable()


def _rebuild_paused():
    """A device rebuild's context: serialized with the loads and with the
    collector paused, but nothing frozen after it. A rebuild follows
    failed batches, whose exceptions may still be garbage in reference
    cycles holding the set it replaces; frozen, they would keep that
    set's card memory for the life of the process."""
    return _collector_paused(freeze=False)


def _fingerprint(stores: TieredPolicyStores) -> tuple:
    """Cheap change detector: each store's content generation, a counter
    bumped only on a real content change, so an unchanged tick costs a
    few method calls. A store without the counter contributes
    TieredPolicyStores.cache_generation()'s proxy, which steps when its
    policy_set() object changes."""
    return stores.cache_generation()


class TorchReloader:
    """Reloads the engines whenever the stores' contents change.

    One reloader drives any number of (engine, tier stores) targets, in
    order, off one fingerprint of the shared dynamic stores (the
    authorization and admission stacks differ only by the constant
    allow-all tail). Each target's load (incremental or full, as the
    engine was built) is placed and warmed on the device before the
    engine publishes it (TorchPolicyEngine.load with ``max_batch``); each
    is logged with its compile scope and dirty shards, and ``on_load`` is
    called with its stats and ``engine=`` the engine's name. A failed load is logged,
    the target keeps its previous set, and the next tick tries it again;
    the fingerprint is kept per target, so a healthy target does not
    recompile while another keeps failing.

    Each target's tiers pass the load-time analysis gate first when its
    tier stores carry a validation mode
    (TieredPolicyStores.analyzed_policy_sets; the gate's seconds are the
    load's ``analyze`` phase). A strict rejection (AnalysisRejected) is
    logged, the target keeps its previous set, and its fingerprint is
    remembered: an unchanged rejected corpus is not analyzed again every
    tick. Any other failure of the gate fails the load like a compile
    error, so it is retried; no load skips the analysis."""

    def __init__(self, stores: TieredPolicyStores, targets=None, interval_s: float = 5.0,
                 max_batch: Optional[int] = None, on_load=None):
        self.stores = stores  # the dynamic stores: fingerprint and readiness gate
        self.targets = list(targets or [])  # [(engine, tier stores)]
        self.interval_s = interval_s
        self.max_batch = max_batch  # the warm-up's top batch (engine.load)
        self.on_load = on_load  # called with each successful load's stats
        self._fps: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _tiers_for(tier_stores: TieredPolicyStores) -> tuple:
        """(tiers to compile, the gate's seconds or None): through the
        load-time analysis gate when the tier stack has a validation
        mode."""
        if not tier_stores.validation_mode:
            return [s.policy_set() for s in tier_stores], None
        t0 = time.monotonic()
        tiers = tier_stores.analyzed_policy_sets()
        return tiers, time.monotonic() - t0

    def reload_if_changed(self, raise_errors: bool = False) -> bool:
        """Load every target whose fingerprint is stale; True when one
        was loaded. ``raise_errors`` (the initial load) raises a failed
        load, a strict rejection included, instead of logging it."""
        from ..analysis import AnalysisRejected

        if not all(s.initial_policy_load_complete() for s in self.stores):
            return False
        fp = _fingerprint(self.stores)
        changed = False
        for idx, (engine, tier_stores) in enumerate(self.targets):
            if self._fps.get(idx) == fp:
                continue
            try:
                with _collector_paused():
                    tiers, gate_s = self._tiers_for(tier_stores)
                    stats = engine.load(tiers, max_batch=self.max_batch,
                                        analysis_seconds=gate_s)
            except AnalysisRejected as e:
                if raise_errors:
                    raise
                # strict validation: the new corpus is rejected wholesale;
                # keep serving the previous plane AND remember the
                # fingerprint, so an unchanged bad corpus is not analyzed
                # again every tick
                log.error("engine [%d] load rejected by policy analysis; "
                          "serving the previous set: %s", idx, e)
                self._fps[idx] = fp
                continue
            except Exception:
                if raise_errors:
                    raise
                log.exception("engine [%d] reload failed; serving the previous set", idx)
                continue
            self._fps[idx] = fp
            changed = True
            log.info("engine [%d] loaded generation %d (%s compile, %d of %d shards dirty): %s",
                     idx, engine.load_generation, stats["compile_scope"],
                     stats["dirty_shards"], stats["shards"], stats)
            if self.on_load is not None:
                self.on_load(stats, engine=engine.name)
        return changed

    def run_forever(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.reload_if_changed()
            except Exception:  # noqa: BLE001 — the previous sets keep serving
                log.exception("reload failed; serving the previous compiled sets")

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run_forever, name="reloader", daemon=True)
        self._thread.start()

    def stop(self, join_timeout_s: float = 30.0) -> None:
        """Stop the polling thread, waiting up to join_timeout_s for a
        load in progress to finish."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)


def _make_breaker(args, name: str):
    """The circuit breaker of one engine (engine/breaker.py); None when
    --breaker-failure-threshold is 0."""
    if args.breaker_failure_threshold <= 0:
        return None
    from ..engine.breaker import CircuitBreaker

    latency_ms = args.breaker_latency_threshold_ms
    if latency_ms <= 0:
        # the request budget: a device that "succeeds" slower than any
        # caller waits is breaching (without it a uniformly slow device
        # never trips: each expiry's failure would be erased by the late
        # batch completing as a success)
        latency_ms = args.request_timeout_ms
    return CircuitBreaker(
        name=name,
        failure_threshold=args.breaker_failure_threshold,
        latency_threshold_s=latency_ms / 1e3 if latency_ms > 0 else None,
        recovery_s=args.breaker_recovery_seconds,
        half_open_probes=args.breaker_half_open_probes,
    )


def _arm_startup_scenario(args) -> None:
    """--chaos-scenario: configure and arm the registry at start, behind
    the non-prod gate (an armed scenario exists to break serving)."""
    if not args.chaos_scenario:
        return
    if not args.confirm_non_prod_inject_errors:
        raise ValueError(
            "--chaos-scenario requires --confirm-non-prod-inject-errors "
            "(fault injection is never a production default)"
        )
    from ..chaos import builtin_scenario, default_registry, load_scenario_file

    scenario = builtin_scenario(args.chaos_scenario)
    if scenario is None:
        scenario = load_scenario_file(args.chaos_scenario)
    default_registry().configure(scenario)
    default_registry().arm()
    log.warning("chaos scenario %r ARMED at startup (non-prod gate confirmed)",
                scenario.get("name", args.chaos_scenario))


def _register_supervised(supervisor, server) -> None:
    """Put the long-lived workers under the watchdog: both paths'
    batchers, the adaptive batch tuners (``tuner.<path>``), every
    directory store's reload ticker and every CRD store's list+watch
    thread (``store.crd.<name>``). The ``threads``
    providers re-read the live objects, so a revived generation stays
    covered; a restart abandons live workers only when the probe read a
    wedge."""
    from ..server.supervisor import HeartbeatGroup

    def _force(reason: str) -> bool:
        return reason.startswith("wedged")

    for name, batcher in (
        ("batcher.authorization", server._batcher),
        ("batcher.admission", server._adm_raw_batcher),
        ("batcher.admission_python", server._admission_batcher),
    ):
        if batcher is None:
            continue
        supervisor.register(
            name,
            threads=lambda b=batcher: list(b._threads),
            restart=lambda reason, b=batcher: b.revive(force=_force(reason)),
            heartbeat=HeartbeatGroup(lambda b=batcher: b.heartbeats),
        )
    rollout = server.rollout
    if rollout is not None:
        supervisor.register(
            "shadow.worker",
            threads=rollout.shadow_worker_threads,
            restart=lambda reason: rollout.revive_shadow(force=_force(reason)),
            heartbeat=HeartbeatGroup(rollout.shadow_heartbeats),
            # a shadow batch launches on the card beside serving and may
            # wait behind it: the wedge probe gets extra slack
            wedge_budget_s=max(60.0, 4 * supervisor.wedge_budget_s),
        )
    for tuner in server.tuners:
        # a dead or wedged tuner restarts (start() is idempotent on a
        # live thread) rather than silently stop tuning
        supervisor.register(
            f"tuner.{tuner.path}",
            threads=lambda t=tuner: [t._thread] if t._thread is not None else [],
            restart=lambda reason, t=tuner: (t.start(), True)[1],
            heartbeat=HeartbeatGroup(lambda t=tuner: {"tick": t.heartbeat}),
        )
    stacks = [server.authorizer.stores]
    if server.admission_handler is not None:
        stacks.append(server.admission_handler.stores)
    if server.tenancy is not None:
        # the fused tier stores wrap the tenants' directory stores
        stacks.append(server.tenancy.registry.tenant_stores())
    seen = set()
    for stores in stacks:
        for store in stores:
            if id(store) in seen:
                continue
            seen.add(id(store))
            if hasattr(store, "watch_threads"):
                supervisor.register(
                    f"store.crd.{store.name()}",
                    threads=store.watch_threads,
                    restart=lambda reason, s=store: s.revive(force=_force(reason)),
                )
            elif hasattr(store, "ticker_threads"):
                supervisor.register(
                    f"store.directory.{store.name()}",
                    threads=store.ticker_threads,
                    restart=lambda reason, s=store: s.revive(force=_force(reason)),
                )


def _generation_fn(tier_stores: TieredPolicyStores, tier_engine):
    """The composite cache generation of one tier stack. Served by the
    interpreter, the stores' CONTENT generations (any reload kills every
    entry). Served by an engine, its plane's SHARD lineage
    (cache/generation.py plane_composite): entries stamp the generations
    of their determining policies' shards and their request's action, so
    an incremental reload kills the entries whose shard changed or that
    a policy it added could decide, while a full compile or a device
    rebuild changes the structural plane id and kills all."""
    if tier_engine is None:
        return tier_stores.cache_generation
    from ..cache.generation import plane_composite

    return lambda: plane_composite(tier_stores, tier_engine)


def _decision_cache(args, tier_stores, tier_engine, path: str):
    """The decision cache of one path (--decision-cache-*); None when
    --decision-cache-size is 0."""
    if args.decision_cache_size <= 0:
        return None
    from ..cache import DecisionCache

    return DecisionCache(
        max_entries=args.decision_cache_size,
        allow_ttl_s=args.decision_cache_allow_ttl_seconds,
        deny_ttl_s=args.decision_cache_deny_ttl_seconds,
        no_opinion_ttl_s=args.decision_cache_no_opinion_ttl_seconds,
        generation_fn=_generation_fn(tier_stores, tier_engine),
        path=path,
    )


def _admission_cache(args, tier_stores, tier_engine):
    """The admission handler's cache: only with --decision-cache-admission
    (read-only idempotent reviews; the native admission fast path does
    not read it, as in the JAX package)."""
    if not args.decision_cache_admission:
        return None
    return _decision_cache(args, tier_stores, tier_engine, "admission")


def _observability(args) -> dict:
    """The observability plane's WebhookServer arguments, as the JAX CLI
    builds them: the tracer (armed at the sample rate, 0 by default, unless
    --no-trace; its tail-keep threshold defaults to the request budget, a
    request that burned its budget being the one worth keeping), the
    audit log (with --audit-log-file), the SLO tracker (unless its
    availability target is 0; the latency budget defaults to the request
    budget), the error injector (its rates behind the non-prod gate) and
    the request recorder (--enable-recording)."""
    from ..obs import AuditLog, SLOTracker, Tracer
    from ..server.error_injector import ErrorInjectionConfig, ErrorInjector
    from ..server.recorder import RequestRecorder

    budget_ms = args.request_timeout_ms if args.request_timeout_ms > 0 else None
    tracer = None
    if not args.no_trace:
        tail_ms = args.trace_tail_ms if args.trace_tail_ms > 0 else (budget_ms or 1000.0)
        tracer = Tracer(sample_rate=args.trace_sample_rate, ring_capacity=args.trace_ring,
                        tail_latency_s=tail_ms / 1e3, log_file=args.trace_log_file or None)
    audit_log = None
    if args.audit_log_file:
        audit_log = AuditLog(args.audit_log_file, max_bytes=args.audit_max_bytes,
                             max_files=args.audit_max_files)
    slo = None
    if args.slo_availability_target > 0:
        latency_ms = args.slo_latency_budget_ms if args.slo_latency_budget_ms > 0 else (
            budget_ms or 2000.0)
        slo = SLOTracker(availability_target=args.slo_availability_target,
                         latency_target=args.slo_latency_target,
                         latency_budget_s=latency_ms / 1e3)
    injector = ErrorInjector(ErrorInjectionConfig(
        enabled=args.confirm_non_prod_inject_errors
        and (args.artificial_error_rate > 0 or args.artificial_deny_rate > 0),
        artificial_error_rate=args.artificial_error_rate,
        artificial_deny_rate=args.artificial_deny_rate,
    ))
    recorder = RequestRecorder(args.recording_dir) if args.enable_recording else None
    return dict(tracer=tracer, audit_log=audit_log, slo=slo, error_injector=injector,
                recorder=recorder)


def _client_enforce_at(args) -> float:
    """The load fraction where per-client quota enforcement starts: the
    flag, or by default (--client-enforce-at < 0) the pressure threshold,
    so the quota acts across the band below --shed-normal-at (above it
    normal traffic sheds wholesale anyway)."""
    if args.client_enforce_at >= 0:
        return args.client_enforce_at
    return args.shed_sheddable_at


def _load_controller(args):
    """The overload gate (load/admission.py), sized by --max-inflight;
    None when it is 0."""
    if args.max_inflight <= 0:
        return None
    from ..load import AdmissionController

    return AdmissionController(
        max_inflight=args.max_inflight,
        shed_sheddable_at=args.shed_sheddable_at,
        shed_normal_at=args.shed_normal_at,
        client_qps=args.client_qps,
        client_burst=args.client_burst,
        client_enforce_at=_client_enforce_at(args),
        retry_after_s=args.shed_retry_after_seconds,
    )


def _warm_top(args) -> int:
    """The largest batch each load and rebuild warms on the card: the
    batcher's --max-batch, or with --adaptive-batching the tuner's clamp
    when larger, so no batch the tuner grows to meets a bucket whose
    first-use costs (pinned staging, TMA maps, the float product's shape)
    would land inside a request's deadline; at most one pipeline chunk."""
    from ..engine.evaluator import _PIPELINE_SB

    top = args.max_batch
    if args.adaptive_batching:
        top = max(top, args.tuner_max_batch)
    return min(top, _PIPELINE_SB)


def _start_tuners(args, server: WebhookServer) -> None:
    """--adaptive-batching: one tuner per batcher of the fast paths,
    sensing the SLO tracker's latency burn, appended to server.tuners."""
    from ..load import AdaptiveBatchTuner, TuningBounds

    bounds = TuningBounds(
        min_batch=args.tuner_min_batch,
        max_batch=args.tuner_max_batch,
        min_window_s=args.tuner_min_linger_us / 1e6,
        max_window_s=args.tuner_max_linger_us / 1e6,
    )
    for path, batcher in (("authorization", server._batcher),
                          ("admission", server._adm_raw_batcher)):
        if batcher is None:
            continue
        tuner = AdaptiveBatchTuner(
            batcher, server.slo, path=path, bounds=bounds,
            interval_s=args.tuner_interval_seconds,
            window_s=args.tuner_burn_window_seconds,
        )
        tuner.start()
        server.tuners.append(tuner)


def _rollout_control(args) -> tuple:
    """(control enabled, bearer token or None) of the rollout lifecycle
    POSTs, as the JAX CLI decides them: a token file's token (an empty one
    refuses to start), else enabled only with --rollout-insecure-control."""
    if args.rollout_control_token_file:
        with open(args.rollout_control_token_file) as f:
            token = f.read().strip()
        if not token:
            raise ValueError(
                "--rollout-control-token-file is empty: refusing to serve "
                "unauthenticated rollout control by accident"
            )
        return True, token
    return bool(args.rollout_insecure_control), None


def _rollout_controller(args, stores: TieredPolicyStores, engine, admission_engine):
    """The shadow-rollout controller over both engines (None without
    engines: promotion swaps compiled sets), with the CRD stores'
    candidate-labelled objects as its CRD source; stages
    --rollout-candidate-dir when given (a bad candidate is logged and
    serving goes on)."""
    if engine is None:
        if args.rollout_candidate_dir:
            log.warning("--rollout-candidate-dir requires --backend device; ignoring")
        return None
    from ..rollout import RolloutController

    def _crd_candidates():
        """Candidate-labelled Policy objects across every CRD store tier
        (the stores withhold them from live serving)."""
        out = []
        for s in stores.stores:
            candidates = getattr(s, "candidate_objects", None)
            if candidates is not None:
                out.extend(candidates())
        return out

    rollout = RolloutController(
        authz_engine=engine,
        admission_engine=admission_engine,
        sample_rate=args.shadow_sample_rate,
        queue_depth=args.shadow_queue_depth,
        duty_cycle=args.shadow_duty_cycle,
        crd_candidate_provider=_crd_candidates,
        # compiled as a load is: one at a time, the collector paused
        compile_context=_collector_paused,
    )
    if args.rollout_candidate_dir:
        try:
            rollout.stage(directory=args.rollout_candidate_dir)
            log.info("staged rollout candidate from %s", args.rollout_candidate_dir)
        except Exception:  # noqa: BLE001 — a bad candidate must not block serving
            log.exception("failed to stage rollout candidate from %s",
                          args.rollout_candidate_dir)
    return rollout


def _lifecycle_specs(args) -> Optional[list]:
    """The PolicyRollout specs of --lifecycle-spec-dir (None without it),
    loaded before anything starts: a bad manifest (SpecError) or a
    backend without the rollout plane (ValueError) refuses to start."""
    if not args.lifecycle_spec_dir:
        return None
    if args.backend == "interpreter":
        raise ValueError(
            "--lifecycle-spec-dir requires the shadow-rollout plane "
            "(--backend device): the lifecycle controller drives "
            "stage/promote/rollback on the rollout controller"
        )
    from ..lifecycle import load_specs_dir

    return load_specs_dir(args.lifecycle_spec_dir)


def _lifecycle_controller(args, specs, rollout, stores: TieredPolicyStores, obs: dict):
    """The declarative lifecycle over the rollout controller, as the JAX
    CLI wires it: resume() from the journal first, then apply() every spec
    the journal does not hold, then the reconcile loop. None without
    --lifecycle-spec-dir."""
    if specs is None:
        if args.lifecycle_journal_file:
            log.warning("--lifecycle-journal-file without --lifecycle-spec-dir is "
                        "inert; ignoring")
        return None
    from ..lifecycle import LifecycleController, LifecycleJournal, RolloutLifecycleDriver

    def _driver(spec):
        # a server has no in-process canary router on the live path
        # (live_eval None): its specs should promote on verify and shadow
        # evidence, with an empty canary ladder
        if spec.canary_ladder:
            log.warning(
                "lifecycle spec %r has a canary ladder but the webhook server "
                "has no embedded canary router; the canary quorum will never "
                "fill and the stage deadline will halt the rollout — use "
                '"promotion": {"canary_ladder": []} in server deployments', spec.tenant)
        return RolloutLifecycleDriver(
            spec.tenant, rollout, slo=obs["slo"], warm="async",
            sample_rate=args.shadow_sample_rate,
            # the analyze gate diffs the candidate against what the
            # authorization engine serves: the tiers the reloader compiles
            live_tiers=lambda: TorchReloader._tiers_for(stores)[0],
        )

    journal = LifecycleJournal(args.lifecycle_journal_file or None)
    lifecycle = LifecycleController(journal=journal, audit_log=obs["audit_log"])
    by_tenant = {s.tenant: s for s in specs}
    resumed = lifecycle.resume({t: _driver(s) for t, s in by_tenant.items()}, specs=by_tenant)
    for spec in specs:
        if spec.tenant not in resumed:
            lifecycle.apply(spec, _driver(spec))
    if len(specs) > 1:
        log.warning(
            "%d lifecycle specs share one rollout controller: the shadow plane "
            "holds ONE candidate at a time, so rollouts serialize (a second "
            "stage while one is in flight retries under its deadline)", len(specs))
    lifecycle.start(args.lifecycle_interval_seconds)
    return lifecycle


def _refuse_with_tenants(args) -> None:
    """--tenant with the shadow-rollout flags or --enable-recording refuses
    to start, with the JAX CLI's messages: a candidate corpus carries no
    tenant guards (every shadow diff on a fused plane would be vacuous),
    and a recorded body loses the tenant its TenantBody carried."""
    if not args.tenant:
        return
    if (args.rollout_candidate_dir or args.rollout_control_token_file
            or args.rollout_insecure_control):
        raise ValueError(
            "--tenant cannot combine with shadow-rollout flags "
            "(--rollout-candidate-dir/--rollout-control-token-file/"
            "--rollout-insecure-control): the candidate corpus carries "
            "no tenant guards, so every shadow diff on a fused plane "
            "would be vacuous (docs/multitenancy.md)"
        )
    if args.enable_recording:
        raise ValueError(
            "--enable-recording cannot combine with --tenant: recorded "
            "bodies lose the resolved tenant and cannot replay against "
            "a fused plane (docs/multitenancy.md)"
        )


def _tenancy(args, config, stores: TieredPolicyStores) -> tuple:
    """--tenant NAME=POLICY_DIR (repeatable): (the fused tier stores in
    place of the config's, the TenantResolver) as the JAX CLI builds them;
    (stores, None) without the flag. Each tenant is a directory store
    re-read every max(1, --reload-seconds) s, so an edit reaches the fused
    plane within one reloader tick, behind its own validationMode gate
    (the registry fuses each tenant's analyzed tiers; the fused stack
    itself stays ungated, since the tenant guards' context access would
    distort the analysis). A malformed flag raises ValueError before any
    store starts."""
    if not args.tenant:
        return stores, None
    from ..stores.directory import DirectoryPolicyStore
    from ..tenancy import TenantRegistry, TenantResolver, fused_tier_stores

    specs = []
    for spec in args.tenant:
        name, sep, tdir = spec.partition("=")
        if not sep or not name or not tdir:
            raise ValueError(f"--tenant wants NAME=POLICY_DIR, got {spec!r}")
        specs.append((name, tdir))
    hosts = {}
    for spec in args.tenant_host:
        host, sep, name = spec.partition("=")
        if not sep or not host or not name:
            raise ValueError(f"--tenant-host wants HOST=TENANT, got {spec!r}")
        hosts[host] = name
    sources = tuple(s.strip() for s in args.tenant_sources.split(",") if s.strip())
    validation = (config.validation_mode if config is not None
                  else args.validation_mode or None)
    registry = TenantRegistry()
    resolver = TenantResolver(registry, header=args.tenant_header, hosts=hosts,
                              default=args.tenant_default or None, sources=sources)
    try:
        for name, tdir in specs:
            registry.add_tenant(name, stores=TieredPolicyStores(
                [DirectoryPolicyStore(tdir, refresh_interval_s=max(1.0, float(args.reload_seconds)))],
                validation_mode=validation,
            ))
    except Exception:
        for store in registry.tenant_stores():
            store.close()
        raise
    if len(stores.stores):
        log.warning("--tenant set: the config's policy stores are replaced by the fused "
                    "tenant stack")
        for store in stores:
            close = getattr(store, "close", None)
            if close is not None:
                close()
    log.info("multi-tenant plane: %d tenant(s) fused (%s)", len(registry),
             ", ".join(registry.tenants()))
    return fused_tier_stores(registry), resolver


def _pdp_listener(args):
    """--pdp-listen [ADDR:]PORT (ADDR defaults to --bind-address) and
    --pdp-schema FILE -> the PdpListener the server binds and starts, as
    the JAX CLI builds it; None without --pdp-listen. A malformed address
    or schema file raises before any store starts."""
    if not args.pdp_listen:
        return None
    from ..pdp import PdpConfig, PdpListener

    config = PdpConfig.load(args.pdp_schema) if args.pdp_schema else PdpConfig()
    listen = str(args.pdp_listen)
    if ":" in listen:
        host, _, port = listen.rpartition(":")
        address, port = (host or args.bind_address), int(port)
    else:
        address, port = args.bind_address, int(listen)
    return PdpListener(config=config, address=address, port=port)


def _wait_for_stores(stores: TieredPolicyStores, poll_s: float = 0.1) -> None:
    """Block until every store's initial load is complete (a CRD store's
    first list, made from its own thread), logging every 10 s while one
    is not."""
    t0 = last = time.monotonic()
    while not all(s.initial_policy_load_complete() for s in stores):
        if time.monotonic() - last >= 10.0:
            last = time.monotonic()
            waiting = [s.name() for s in stores if not s.initial_policy_load_complete()]
            log.info("waiting %.0f s for the initial policy load of %s", last - t0, waiting)
        time.sleep(poll_s)


def build_server(args) -> WebhookServer:
    """stores -> the authorization and admission stacks, each an engine
    loaded from its stores behind its fast path -> WebhookServer. With the
    device backend it first waits for the stores' initial loads. Raises
    when the device is unavailable, the native encoder or the kernels
    cannot be built, or strict validation rejects the initial corpus
    (AnalysisRejected), and refuses --adaptive-batching without the SLO
    tracker, an empty --rollout-control-token-file,
    --lifecycle-spec-dir on the interpreter backend, and --tenant with
    the shadow-rollout flags or --enable-recording before anything starts
    (ValueError; a bad PolicyRollout manifest raises its SpecError there
    too, a malformed --tenant* value its ValueError or TenantError,
    with every tenant store it started closed, and a bad --pdp-listen
    address or --pdp-schema file its ValueError or OSError)."""
    if args.adaptive_batching and args.slo_availability_target <= 0:
        # before any store ticker or worker thread exists: an error here
        # leaks nothing
        raise ValueError(
            "--adaptive-batching requires the SLO tracker "
            "(--slo-availability-target > 0): the burn rate is the "
            "control signal"
        )
    _refuse_with_tenants(args)
    pdp = _pdp_listener(args)
    rollout_control_enabled, rollout_control_token = _rollout_control(args)
    specs = _lifecycle_specs(args)
    certfile, keyfile = args.tls_cert_file, args.tls_private_key_file
    if args.insecure:
        certfile = keyfile = None
    elif not (certfile and keyfile):
        certfile, keyfile = maybe_self_signed_certs(args.cert_dir)

    config = None
    if args.config:
        with open(args.config) as f:
            config = parse_config(f.read())
    if config is not None and args.validation_mode:
        # the flag overrides the config file's spec.validationMode
        config.validation_mode = args.validation_mode
    stores = cedar_config_stores(config, kubeconfig_path=args.kubeconfig or None)
    stores, tenancy = _tenancy(args, config, stores)
    # admission gets the allow-all final tier (main.go:111-116); it shares
    # the authorization stack's validation posture (the allow-all tail is
    # trivially lowerable, so the gate treats both stacks alike)
    admission_stores = TieredPolicyStores(
        list(stores.stores) + [allow_all_admission_policy_store()],
        validation_mode=stores.validation_mode,
    )

    def analysis_provider() -> dict:
        """The last load-time analysis report per tier stack, for
        /debug/analysis; {} until the first analyzed load."""
        out = {}
        for name, ts in (("authorization", stores), ("admission", admission_stores)):
            if ts.last_analysis is not None:
                out[name] = ts.last_analysis.to_dict()
        return out
    admission_fail_open = args.admission_fail_mode == "open"

    _arm_startup_scenario(args)
    metrics = WebhookMetrics()
    fastpath = admission_fastpath = reloader = None
    engine = admission_engine = None
    recoveries = []
    if args.backend == "interpreter":
        if not len(stores.stores):
            log.warning("no policy stores configured; authorizer will no-opinion")
        authorizer = CedarWebhookAuthorizer(stores)
        admission_handler = CedarAdmissionHandler(
            admission_stores, allow_on_error=admission_fail_open,
            cache=_admission_cache(args, admission_stores, None),
        )
    else:
        if not len(stores.stores):
            raise ValueError("--backend device needs at least one policy store (--config)")
        from ..engine.evaluator import TorchPolicyEngine

        incremental = not args.no_incremental_compile
        engine = TorchPolicyEngine(device=args.device, incremental=incremental,
                                   shard_buckets=args.shard_buckets, name="authorization")
        admission_engine = TorchPolicyEngine(device=args.device, incremental=incremental,
                                             shard_buckets=args.shard_buckets, name="admission")
        # every load warms its plane on the device before the swap: nvcc
        # and every first-use cost of the device paths then, not inside
        # the first requests' deadlines, up to the largest batch a
        # batcher can form (_warm_top: the tuner's clamp with adaptive
        # batching). The CPU's plain versions have no per-shape first-use
        # cost, so one bucket does there; the warm-ups' launches count in
        # engine.stats["warmup_launches"], apart from the served ones
        reloader = TorchReloader(
            stores,
            targets=[(engine, stores), (admission_engine, admission_stores)],
            interval_s=args.reload_seconds,
            max_batch=_warm_top(args) if engine.device.type == "cuda" else 1,
            on_load=metrics.record_compile,
        )
        _wait_for_stores(stores)
        reloader.reload_if_changed(raise_errors=True)
        log.info("engines on %s loaded and warmed up: warm-up launches %s / %s",
                 engine.device, engine.warmup_launches, admission_engine.warmup_launches)
        authorizer = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
        admission_handler = CedarAdmissionHandler(
            admission_stores,
            allow_on_error=admission_fail_open,
            evaluate_batch=admission_engine.evaluate_batch,
            cache=_admission_cache(args, admission_stores, admission_engine),
        )
        if not args.no_native:
            from ..engine.fastpath import AdmissionFastPath, SARFastPath
            from ..native import set_encode_threads

            if args.native_encode_threads > 0:
                set_encode_threads(args.native_encode_threads)
            guards = {}
            for name, eng in (("authorization", engine), ("admission", admission_engine)):
                breaker = _make_breaker(args, name)
                recovery = None
                if args.supervisor_interval_seconds > 0:
                    from ..server.supervisor import DeviceRecovery

                    # the rebuild runs as a load does: one at a time with
                    # the collector paused, warmed before it is published
                    recovery = DeviceRecovery(
                        eng, breaker=breaker, name=name,
                        warm_max_batch=reloader.max_batch,
                        rebuild_context=_rebuild_paused,
                    )
                    recoveries.append(recovery)
                guards[name] = {
                    "breaker": breaker,
                    "on_device_error": recovery.observe if recovery is not None else None,
                }
            fastpath = SARFastPath(engine, authorizer, **guards["authorization"])
            fastpath.prepare()
            admission_fastpath = AdmissionFastPath(
                admission_engine, admission_handler, **guards["admission"]
            )
            admission_fastpath.prepare()
            log.info("native SAR and admission fast paths enabled")

    rollout = _rollout_controller(args, stores, engine, admission_engine)
    obs = _observability(args)
    if rollout is not None and obs["audit_log"] is not None:
        # stage / promote / rollback and refusals land in the audit stream
        rollout.set_audit_sink(obs["audit_log"].record)
    lifecycle = _lifecycle_controller(args, specs, rollout, stores, obs)
    supervisor = None
    if args.supervisor_interval_seconds > 0:
        from ..server.supervisor import Supervisor

        supervisor = Supervisor(
            interval_s=args.supervisor_interval_seconds,
            wedge_budget_s=args.supervisor_wedge_seconds,
        )
        for recovery in recoveries:
            supervisor.register_recovery(recovery)

    server = WebhookServer(
        authorizer=authorizer,
        address=args.bind_address,
        port=args.secure_port,
        metrics_port=args.metrics_port,
        certfile=certfile,
        keyfile=keyfile,
        fastpath=fastpath,
        batch_window_s=args.batch_window_us / 1e6,
        max_batch=args.max_batch,
        request_timeout_s=args.request_timeout_ms / 1e3 if args.request_timeout_ms > 0 else None,
        drain_grace_s=args.shutdown_grace_seconds,
        pipeline_depth=args.pipeline_depth,
        encode_workers=args.encode_workers,
        admission_handler=admission_handler,
        admission_fastpath=admission_fastpath,
        admission_fail_open=admission_fail_open,
        metrics=metrics,
        reloader=reloader,
        supervisor=supervisor,
        analysis_provider=analysis_provider,
        chaos_control_enabled=args.confirm_non_prod_inject_errors,
        decision_cache=_decision_cache(args, stores, engine, "authorization"),
        load=_load_controller(args),
        rollout=rollout,
        rollout_control_enabled=rollout_control_enabled,
        rollout_control_token=rollout_control_token,
        lifecycle=lifecycle,
        enable_profiling=args.profiling,
        tenancy=tenancy,
        pdp=pdp,
        **obs,
    )
    if args.adaptive_batching:
        _start_tuners(args, server)
    if supervisor is not None:
        _register_supervised(supervisor, server)
    if fastpath is not None:
        from ..native import _default_encode_threads

        server.metrics.set_native_encode_threads(_default_encode_threads())
    return server


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cedar-webhook",
        description="Cedar authorization webhook for Kubernetes (PyTorch/CUDA port)",
    )
    cedar = parser.add_argument_group("cedar")
    cedar.add_argument("--config", default="", help="Cedar store config file (YAML/JSON)")
    cedar.add_argument(
        "--kubeconfig", default="",
        help="kubeconfig for the CRD policy store (JSON needs no PyYAML; "
        "empty = $KUBECONFIG)",
    )
    cedar.add_argument(
        "--backend",
        default="device",
        choices=["interpreter", "device"],
        help="authorization evaluation backend: device serves from the "
        "compiled engine on --device, interpreter from the Python "
        "interpreter only",
    )
    cedar.add_argument(
        "--reload-seconds",
        type=float,
        default=5.0,
        help="poll interval of the reloader: when a store's content changed, "
        "both engines recompile (incrementally unless "
        "--no-incremental-compile) and swap in their new planes",
    )
    cedar.add_argument(
        "--shard-buckets",
        type=int,
        default=0,
        help="tier/bucket shards per tier for incremental compilation "
        "(compiler/shard.py): a CRD edit re-lowers only its own shard, "
        "so finer sharding = faster edits, coarser = fewer shards to "
        "hash. 0 = the default, 64",
    )
    cedar.add_argument(
        "--no-incremental-compile",
        action="store_true",
        help="disable shard-granular incremental compilation: every "
        "reload re-lowers the whole corpus (the pre-shard behavior; "
        "escape hatch)",
    )
    cedar.add_argument(
        "--validation-mode",
        default="",
        choices=["", "strict", "permissive", "partial"],
        help="load-time policy-analysis posture, overriding the config "
        "file's spec.validationMode: strict rejects loads with blocking "
        "findings, permissive annotates, partial drops only the offending "
        "policies (docs/analysis.md)",
    )
    cedar.add_argument(
        "--device",
        default="cuda",
        help="torch device of the engine (cuda, cuda:N or cpu); the server "
        "fails at start when CUDA is asked for and absent",
    )
    cedar.add_argument(
        "--batch-window-us",
        type=float,
        default=200.0,
        help="micro-batch forming window for the fast path",
    )
    cedar.add_argument("--max-batch", type=int, default=8192, help="micro-batch row ceiling")
    cedar.add_argument(
        "--pipeline-depth",
        type=int,
        default=2,
        help="batches in flight through the three-stage evaluation "
        "pipeline (encode / dispatch / decode overlap); 0 restores the "
        "serial batch loop",
    )
    cedar.add_argument(
        "--encode-workers",
        type=int,
        default=0,
        help="host encode threads feeding the pipelined batcher (only used "
        "with --pipeline-depth > 0); 0 auto-sizes from the native encoder "
        "pool width",
    )
    cedar.add_argument(
        "--native-encode-threads",
        type=int,
        default=0,
        help="native (C++) encoder worker-pool width per batch, overriding "
        "CEDAR_NATIVE_THREADS; 0 = env var, else cpu count (capped at 16)",
    )
    cedar.add_argument(
        "--no-native",
        action="store_true",
        help="disable the C++ fast paths (python encode; one device "
        "evaluation per /v1/authorize request, one per admission batch)",
    )

    serving = parser.add_argument_group("secure serving")
    serving.add_argument("--bind-address", default=DEFAULT_ADDRESS)
    serving.add_argument("--secure-port", type=int, default=DEFAULT_PORT)
    serving.add_argument("--metrics-port", type=int, default=METRICS_PORT)
    serving.add_argument(
        "--cert-dir",
        default="/var/run/cedar-authorizer/certs",
        help="directory for (generated) serving certs",
    )
    serving.add_argument("--tls-cert-file", default="")
    serving.add_argument("--tls-private-key-file", default="")
    serving.add_argument("--insecure", action="store_true", help="serve plain HTTP (testing only)")

    resilience = parser.add_argument_group("resilience")
    resilience.add_argument(
        "--request-timeout-ms",
        type=float,
        default=2000.0,
        help="per-request deadline budget; on expiry /v1/authorize answers "
        "NoOpinion+evaluationError and /v1/admit answers the configured "
        "fail-mode (0 disables)",
    )
    resilience.add_argument(
        "--admission-fail-mode",
        default="open",
        choices=["open", "closed"],
        help="admission answer when evaluation crashes or exceeds its "
        "deadline: open allows (keeps the cluster write path alive), "
        "closed denies (nothing unevaluated is admitted)",
    )
    resilience.add_argument(
        "--breaker-failure-threshold",
        type=int,
        default=5,
        help="consecutive evaluator errors that trip an engine's circuit "
        "breaker; while it is open the endpoint answers the failure "
        "posture without reaching the device (0 disables the breaker)",
    )
    resilience.add_argument(
        "--breaker-latency-threshold-ms",
        type=float,
        default=0.0,
        help="device evaluation latency counted as a breach; consecutive "
        "breaches also trip the breaker (0 = default to "
        "--request-timeout-ms: slower than any caller waits is breaching)",
    )
    resilience.add_argument(
        "--breaker-recovery-seconds",
        type=float,
        default=10.0,
        help="how long a tripped breaker stays open before half-open "
        "recovery probes",
    )
    resilience.add_argument(
        "--breaker-half-open-probes",
        type=int,
        default=2,
        help="consecutive successful probes that close a half-open breaker",
    )
    resilience.add_argument(
        "--supervisor-interval-seconds",
        type=float,
        default=1.0,
        help="watchdog poll interval: dead or wedged worker threads "
        "(batcher stages, store reload tickers) are restarted, the "
        "batches they held answered with the failure posture, and fatal "
        "device errors trigger an engine rebuild on the card (0 disables "
        "supervision and the rebuild)",
    )
    resilience.add_argument(
        "--supervisor-wedge-seconds",
        type=float,
        default=10.0,
        help="busy-heartbeat age after which a live worker thread counts "
        "as wedged and is force-restarted (idle workers never trip this)",
    )
    resilience.add_argument(
        "--shutdown-grace-seconds",
        type=float,
        default=5.0,
        help="drain window on SIGTERM: /readyz flips to 503, new requests "
        "are shed, in-flight requests get this long to finish",
    )

    overload = parser.add_argument_group("overload control")
    overload.add_argument(
        "--max-inflight",
        type=int,
        default=0,
        help="size of the overload-control plane (load/): requests are "
        "classified at ingress (kubelet/system SARs high, controller and "
        "admission traffic normal) and shed by priority as "
        "inflight/max-inflight crosses the graduated load states; sheds "
        "answer honestly (NoOpinion + Retry-After / the admission "
        "fail-mode) and /readyz reports the state (0 disables admission "
        "control entirely)",
    )
    overload.add_argument(
        "--shed-sheddable-at",
        type=float,
        default=0.5,
        help="load fraction at which sheddable (explain/operator) traffic "
        "sheds: the `pressure` state",
    )
    overload.add_argument(
        "--shed-normal-at",
        type=float,
        default=0.8,
        help="load fraction at which normal (controller/admission) "
        "traffic sheds: the `overload` state; high-priority traffic "
        "sheds only at saturation (load >= 1.0)",
    )
    overload.add_argument(
        "--client-qps",
        type=float,
        default=0.0,
        help="per-client fair-share quota (tokens/second) enforced under "
        "pressure so one hot controller cannot starve the kubelets; keyed "
        "by the SAR/admission username, high priority exempt (0 disables)",
    )
    overload.add_argument(
        "--client-burst",
        type=float,
        default=0.0,
        help="per-client quota burst headroom (0 = qps/2, min 1)",
    )
    overload.add_argument(
        "--client-enforce-at",
        type=float,
        default=-1.0,
        help="load fraction at which the per-client quota starts being "
        "enforced; default (-1) derives it from --shed-sheddable-at so "
        "the quota acts across the whole pressure band",
    )
    overload.add_argument(
        "--shed-retry-after-seconds",
        type=float,
        default=1.0,
        help="the Retry-After hint shed answers carry",
    )
    overload.add_argument(
        "--adaptive-batching",
        action="store_true",
        help="SLO-adaptive batch tuning (load/tuner.py): a control loop "
        "reads the SLO latency burn rate and retunes each batcher's "
        "max-batch/linger inside the bounds below (grow batches while the "
        "latency objective has headroom, shrink linger the moment it "
        "burns; decisions at /debug/load); on the card every bucket up to "
        "--tuner-max-batch is warmed. Requires the SLO tracker "
        "(--slo-availability-target > 0)",
    )
    overload.add_argument(
        "--tuner-interval-seconds",
        type=float,
        default=1.0,
        help="adaptive-batching control cadence (one knob move per tick)",
    )
    overload.add_argument(
        "--tuner-burn-window-seconds",
        type=float,
        default=60.0,
        help="trailing window the tuner reads the latency burn rate over "
        "(floored to one 10s SLO ring bucket)",
    )
    overload.add_argument(
        "--tuner-min-batch", type=int, default=64,
        help="adaptive-batching lower clamp on max-batch",
    )
    overload.add_argument(
        "--tuner-max-batch", type=int, default=16384,
        help="adaptive-batching upper clamp on max-batch",
    )
    overload.add_argument(
        "--tuner-min-linger-us", type=float, default=50.0,
        help="adaptive-batching lower clamp on the batch linger window",
    )
    overload.add_argument(
        "--tuner-max-linger-us", type=float, default=2000.0,
        help="adaptive-batching upper clamp on the batch linger window",
    )

    obs = parser.add_argument_group("observability")
    obs.add_argument(
        "--trace-sample-rate",
        type=float,
        default=0.0,
        help="head-sample fraction of requests fully traced into "
        "/debug/traces (0.0-1.0). Independent of the rate, slow "
        "(past --trace-tail-ms), errored and posture-answered requests "
        "are TAIL-KEPT: the default 0.0 still captures the requests "
        "worth looking at",
    )
    obs.add_argument(
        "--trace-tail-ms",
        type=float,
        default=0.0,
        help="tail-keep latency threshold: finished traces slower than "
        "this are kept even when unsampled; 0 defaults to "
        "--request-timeout-ms (a request that burned its budget is the "
        "one worth keeping)",
    )
    obs.add_argument(
        "--trace-ring",
        type=int,
        default=256,
        help="bounded in-memory ring of kept traces behind /debug/traces",
    )
    obs.add_argument(
        "--trace-log-file",
        default="",
        help="append kept traces as JSONL for offline cedar-trace "
        "(python -m cedar_tpu_torch.cli.trace); empty disables export, "
        "the ring still serves",
    )
    obs.add_argument(
        "--no-trace",
        action="store_true",
        help="disable the tracing plane entirely (no ring, no "
        "/debug/traces, no per-request span bookkeeping)",
    )
    obs.add_argument(
        "--audit-log-file",
        default="",
        help="decision audit log (JSONL): one line per answered decision "
        "carrying the end-to-end trace id and the canonical request "
        "fingerprint shared with the recorder and the decision cache "
        "(empty disables)",
    )
    obs.add_argument(
        "--audit-max-bytes",
        type=int,
        default=64 * 1024 * 1024,
        help="size-based audit rotation threshold per file",
    )
    obs.add_argument(
        "--audit-max-files",
        type=int,
        default=3,
        help="rotated audit generations kept beside the live file",
    )
    obs.add_argument(
        "--slo-availability-target",
        type=float,
        default=0.999,
        help="availability SLO target (non-error answer fraction) behind "
        "/debug/slo and the cedar_slo_* burn-rate gauges; 0 disables "
        "the SLO plane",
    )
    obs.add_argument(
        "--slo-latency-target",
        type=float,
        default=0.99,
        help="latency SLO target: the fraction of requests that must "
        "answer within the latency budget",
    )
    obs.add_argument(
        "--slo-latency-budget-ms",
        type=float,
        default=0.0,
        help="latency SLO budget per request; 0 defaults to "
        "--request-timeout-ms",
    )

    gameday = parser.add_argument_group("gameday")
    gameday.add_argument(
        "--artificial-error-rate",
        type=float,
        default=0.0,
        help="answers per second swapped for NoOpinion with an error on "
        "/v1/authorize (requires --confirm-non-prod-inject-errors)",
    )
    gameday.add_argument(
        "--artificial-deny-rate",
        type=float,
        default=0.0,
        help="answers per second swapped for a deny on /v1/authorize "
        "(requires --confirm-non-prod-inject-errors)",
    )
    gameday.add_argument(
        "--confirm-non-prod-inject-errors",
        action="store_true",
        help="required gate for fault injection: the artificial error and "
        "deny rates, the /chaos/* control endpoints and --chaos-scenario "
        "(never set in production)",
    )
    gameday.add_argument(
        "--chaos-scenario",
        default="",
        help="arm a chaos scenario at startup: a built-in name "
        "(kill-decode, device-loss, store-stall, ...) or a scenario JSON "
        "file; requires --confirm-non-prod-inject-errors",
    )

    rollout = parser.add_argument_group("shadow rollout")
    rollout.add_argument(
        "--rollout-candidate-dir",
        default="",
        help="stage a candidate policy set from this directory of *.cedar "
        "files at startup (shadow evaluation starts immediately; promotion "
        "stays manual via POST /rollout/promote on the metrics port). "
        "Requires --backend device",
    )
    rollout.add_argument(
        "--shadow-sample-rate",
        type=float,
        default=1.0,
        help="fraction of live traffic shadow-evaluated against the staged "
        "candidate (0.0-1.0); sampling happens before the queue, so lower "
        "rates also shrink shadow cost proportionally",
    )
    rollout.add_argument(
        "--shadow-queue-depth",
        type=int,
        default=1024,
        help="bounded shadow-evaluation queue; full-queue offers are shed "
        "(cedar_shadow_shed_total) rather than ever delaying live answers",
    )
    rollout.add_argument(
        "--shadow-duty-cycle",
        type=float,
        default=0.1,
        help="max fraction of one core the shadow worker may consume; "
        "under pressure the queue backs up and sheds so live serving "
        "never loses cpu to shadow evaluation",
    )
    rollout.add_argument(
        "--rollout-control-token-file",
        default="",
        help="file holding a bearer token required by the mutating "
        "rollout endpoints (POST /rollout/stage|promote|rollback). With "
        "neither this nor --rollout-insecure-control, those endpoints "
        "answer 403 — a staged allow-all + promote is a cluster "
        "authorization takeover, and the metrics listener is plain HTTP",
    )
    rollout.add_argument(
        "--rollout-insecure-control",
        action="store_true",
        help="allow UNAUTHENTICATED rollout lifecycle POSTs on the "
        "metrics listener (trusted-loopback deployments only)",
    )
    rollout.add_argument(
        "--lifecycle-spec-dir",
        default="",
        help="directory of PolicyRollout manifests (*.json) driven by the "
        "declarative lifecycle controller: verify -> [analyze] -> shadow -> "
        "promote with evidence gates, automatic halt + rollback on breach. "
        "Requires the shadow-rollout plane (--backend device); server specs "
        'should set "promotion": {"canary_ladder": []} (the canary router is '
        "embedded only)",
    )
    rollout.add_argument(
        "--lifecycle-journal-file",
        default="",
        help="JSONL write-ahead journal for lifecycle transitions; on "
        "restart the controller replays it, unwinds anything in flight to "
        "the live-only plane and restarts those rollouts from pending. "
        "Default: in-memory (no resume across restarts)",
    )
    rollout.add_argument(
        "--lifecycle-interval-seconds",
        type=float,
        default=1.0,
        help="reconcile-loop period of the lifecycle controller",
    )

    cache = parser.add_argument_group("decision cache")
    cache.add_argument(
        "--decision-cache-size",
        type=int,
        default=65536,
        help="max cached decisions (sharded LRU; 0 disables the cache). "
        "Keys are canonical request fingerprints; entries die on policy "
        "reload (generation bump) or their decision-class TTL",
    )
    cache.add_argument(
        "--decision-cache-allow-ttl-seconds",
        type=float,
        default=300.0,
        help="TTL for cached Allow decisions (mirrors kube-apiserver's "
        "--authorization-webhook-cache-authorized-ttl posture; 0 disables "
        "caching allows)",
    )
    cache.add_argument(
        "--decision-cache-deny-ttl-seconds",
        type=float,
        default=30.0,
        help="TTL for cached Deny decisions (shorter than allows: a newly "
        "granted permission should take effect quickly; 0 disables)",
    )
    cache.add_argument(
        "--decision-cache-no-opinion-ttl-seconds",
        type=float,
        default=5.0,
        help="TTL for cached NoOpinion decisions (shortest: these usually "
        "fall through to RBAC and carry the least signal; 0 disables)",
    )
    cache.add_argument(
        "--decision-cache-admission",
        action="store_true",
        help="opt-in admission decision caching, gated to read-only "
        "idempotent reviews (CONNECT operations and dryRun requests); "
        "mutating reviews always evaluate",
    )

    tenancy = parser.add_argument_group("multi-tenancy")
    tenancy.add_argument(
        "--tenant",
        action="append",
        default=[],
        metavar="NAME=POLICY_DIR",
        help="register a tenant served from the fused shared plane "
        "(repeatable): NAME becomes the tenant id (DNS-label-ish), "
        "POLICY_DIR its *.cedar policy directory. All tenants compile "
        "into ONE engine with per-rule tenant discriminators; requests "
        "route by /t/<name>/v1/... path, the tenant header, or a host "
        "map (docs/multitenancy.md)",
    )
    tenancy.add_argument(
        "--tenant-header",
        default="x-cedar-tenant",
        help="HTTP header carrying the tenant id (default %(default)s)",
    )
    tenancy.add_argument(
        "--tenant-host",
        action="append",
        default=[],
        metavar="HOST=TENANT",
        help="map a Host/SNI hostname to a tenant (repeatable) — the "
        "shape a TLS-terminating LB hands multi-SNI traffic over in",
    )
    tenancy.add_argument(
        "--tenant-default",
        default="",
        help="tenant to assume when no path/header/host resolves one "
        "(default: refuse such requests)",
    )
    tenancy.add_argument(
        "--tenant-sources",
        default="path,header,host",
        metavar="SRC[,SRC...]",
        help="which resolution sources to trust, comma-separated subset "
        "of path,header,host (default %(default)s). Path and header are "
        "CLIENT-supplied: restrict to 'host' when tenants are "
        "authenticated by per-tenant SNI/LB routes, or a tenant could "
        "name a neighbor and evaluate under its policy slice. Enabled "
        "sources that disagree on a request are rejected (conflict)",
    )

    pdp = parser.add_argument_group("pdp front end")
    pdp.add_argument(
        "--pdp-listen",
        default="",
        metavar="[ADDR:]PORT",
        help="start the general PDP front end (pdp/, docs/pdp.md) on this "
        "address: Envoy ext_authz HTTP-service checks on every path plus "
        "AVP-style POST /v1/batch-authorize; both map into the same planes, "
        "batcher ticks, cache and admission gate the webhook serves from "
        "(ADDR defaults to --bind-address; empty disables)",
    )
    pdp.add_argument(
        "--pdp-schema",
        default="",
        metavar="FILE",
        help="JSON attribute-mapping/fail-posture config for the PDP front "
        "end (identity/context headers, extauthz_deny_on_unavailable, "
        "tenant stamp, batch tuple cap); omitted = defaults (see docs/pdp.md)",
    )

    debug = parser.add_argument_group("debug")
    debug.add_argument("--profiling", action="store_true",
                       help="serve /debug/pprof/profile (a one-second sampler of "
                       "every thread's stack) and /debug/pprof/* (a dump of "
                       "every thread) on the webhook listener")
    debug.add_argument("-v", "--verbosity", type=int, default=0)
    debug.add_argument("--enable-recording", action="store_true",
                       help="write every POST body to --recording-dir as "
                       "req-<endpoint>-<fingerprint>-<unixnano>.json")
    debug.add_argument("--recording-dir", default="/tmp/cedar-recordings")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = make_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 5 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    from ..analysis import AnalysisRejected

    try:
        server = build_server(args)
    except AnalysisRejected as e:
        # strict validation rejected the initial corpus: with no previous
        # plane and no interpreter fallback there is nothing to serve
        log.error("not serving: %s", e)
        return 1
    server.start()

    stop = threading.Event()

    def _signal(signum, frame):
        log.info("received signal %d, shutting down", signum)
        stop.set()

    signal.signal(signal.SIGTERM, _signal)
    signal.signal(signal.SIGINT, _signal)
    while not stop.wait(1.0):
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
