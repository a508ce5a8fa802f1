"""Rollout lifecycle: stage -> shadow -> inspect -> promote / rollback (the
JAX package's rollout/controller.py, without its fleet branch).

The controller owns at most one CANDIDATE. Staging compiles the candidate
tiers into two fresh TorchPolicyEngines on the live engines' device
(``_clone_engine``: same schema, device, incremental compile and shard
buckets), warms each up to the live engine's top warmed bucket on a
background thread, and starts shadow evaluation of live traffic
(shadow.py) through them, so the match kernels run for the candidate on
a second plane beside the serving one. None of it touches the live
engines, batchers or caches until promotion.

Promotion is an atomic swap per engine: the candidate's warmed compiled
set moves into the live engine through ``adopt_compiled``, which runs the
live engine's load hooks (the fast path's native encoder for the set) and
compiles and warms nothing. The swap changes the serving plane's
structural id, so every decision-cache entry of the pre-promotion plane
misses from then on. The prior set stays on the card; ``rollback`` hands
it back the same way.

The store reloader recompiles only when store CONTENT changes, so a
promotion (which changes no store) keeps serving the candidate until the
operator commits its content to the store. A store reload between promote
and rollback makes the saved set stale, and rollback refuses rather than
revive it; a reload after a promotion starts a fresh shard lineage
(engine/evaluator.py _next_plane), since the plane its engine last loaded
no longer serves.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import List, Optional

from ..analysis.loadgate import AnalysisRejected, enforce
from ..chaos.registry import chaos_fire
from ..engine.evaluator import track_warm_thread, untrack_warm_thread, warm_shutdown_set
from ..server import metrics
from ..server.admission import CedarAdmissionHandler, allow_all_admission_policy_store
from ..server.authorizer import CedarWebhookAuthorizer
from ..stores.store import MemoryStore, TieredPolicyStores
from .report import DiffReport
from .shadow import DEFAULT_DUTY_CYCLE, DEFAULT_QUEUE_DEPTH, ShadowEvaluator
from .source import (
    candidate_tiers_from_directory,
    candidate_tiers_from_objects,
    candidate_tiers_from_source,
)

log = logging.getLogger(__name__)

STATE_IDLE = "idle"
STATE_STAGED = "staged"
STATE_PROMOTED = "promoted"


class RolloutError(RuntimeError):
    """A lifecycle operation could not be performed (bad state, rejected
    candidate, diverged lineage). ``detail``, when present, is a JSON
    document the HTTP layer returns in the 409 body (the lineage
    breakdown of a refused rollback)."""

    def __init__(self, message: str, detail: Optional[dict] = None):
        super().__init__(message)
        self.detail = detail


def _clone_engine(name: str, template):
    """A fresh TorchPolicyEngine with the template's settings: the
    candidate compiles for the live engine's device and shard layout, or
    promotion would swap in a set the serving paths cannot take."""
    from ..engine.evaluator import TorchPolicyEngine

    return TorchPolicyEngine(
        schema=template.schema,
        device=template.device,
        incremental=template.incremental,
        shard_buckets=template.shard_buckets,
        name=name,
    )


def _warm_top(live) -> int:
    """The largest batch bucket the live engine warmed (1 when it never
    warmed): the candidate warms up to it, so no batch the live batcher or
    its tuner forms after a promotion meets a cold bucket."""
    return max(getattr(live, "warm_buckets", ()) or (1,))


def candidate_stores(tiers):
    """(authorization TieredPolicyStores, admission TieredPolicyStores)
    over candidate tiers: a MemoryStore per tier, and for admission the
    allow-all tail. The one candidate stack assembly, shared by the live
    stage (_build_stack) and the offline CLIs."""
    authz = TieredPolicyStores(
        [MemoryStore(f"candidate-tier{i}", ps) for i, ps in enumerate(tiers)]
    )
    admission = TieredPolicyStores(list(authz.stores) + [allow_all_admission_policy_store()])
    return authz, admission


class _Candidate:
    """Everything staged for one candidate: tiers, engines, and the stacks
    the shadow evaluator answers through."""

    def __init__(self, tiers, description: str):
        self.tiers = tiers
        self.description = description
        self.staged_at = time.time()
        self.analysis = None  # AnalysisReport of the stage gate
        self.authz_engine = None
        self.admission_engine = None
        self.authorizer = None
        self.admission_handler = None
        self.warm_state = "unwarmed"  # unwarmed | warming | ready | failed
        self.warm_stats: dict = {}


class RolloutController:
    """Owns the staged candidate, the shadow evaluator, and the promote /
    rollback swap points of the live engines."""

    def __init__(
        self,
        authz_engine=None,
        admission_engine=None,
        sample_rate: float = 1.0,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        exemplar_cap: int = 64,
        stage_validation_mode: str = "strict",
        engine_factory=None,
        duty_cycle: float = DEFAULT_DUTY_CYCLE,
        crd_candidate_provider=None,
        audit_sink=None,
        compile_context=None,
    ):
        # the live engines (None on an interpreter deployment: staging and
        # shadowing still work there through the interpreter; promotion
        # needs the engines and refuses without them)
        self.authz_engine = authz_engine
        self.admission_engine = admission_engine
        self.sample_rate = sample_rate
        self.queue_depth = queue_depth
        self.exemplar_cap = exemplar_cap
        self.duty_cycle = duty_cycle
        # the analysis posture at STAGE time, whatever the serving stack's:
        # a candidate that cannot lower (or has permit/forbid conflicts) is
        # rejected before it shadows anything
        self.stage_validation_mode = stage_validation_mode
        self._engine_factory = engine_factory or _clone_engine
        # () -> [PolicyObject]: the CRD stores' candidate-labelled objects;
        # stage(crd=True) builds the candidate from them (cli/webhook.py
        # wires it)
        self._crd_candidate_provider = crd_candidate_provider
        # dict sink (AuditLog.record): every stage / promote / rollback and
        # refusal lands one record; best-effort
        self._audit_sink = audit_sink
        # () -> context manager the candidate compile runs in (the CLI's:
        # serialized with the store reloads, the cyclic collector paused,
        # as every load of the live engines is)
        self._compile_context = compile_context or contextlib.nullcontext
        self._lock = threading.Lock()
        self._state = STATE_IDLE
        self._candidate: Optional[_Candidate] = None
        self._shadow: Optional[ShadowEvaluator] = None
        self._report: Optional[DiffReport] = None
        self._promoted: Optional[_Candidate] = None
        # role -> (live engine, prior compiled set, generation after swap)
        self._rollback_points: dict = {}
        # monotonic lifecycle counter (cedar_rollout_generation)
        self.generation = 0

    # ------------------------------------------------------------ lifecycle

    def stage(
        self,
        tiers: Optional[List] = None,
        directory: Optional[str] = None,
        source: Optional[str] = None,
        crd: bool = False,
        description: str = "",
        warm: str = "async",
        sample_rate: Optional[float] = None,
    ) -> dict:
        """Stage a candidate: resolve its tiers, run the analysis gate,
        compile the candidate engines off the hot path, start warming them
        and begin shadow evaluation. Replaces a staged candidate (its
        report is dropped). Raises RolloutError when the candidate fails
        to load or the gate rejects it."""
        chaos_fire("rollout.stage")
        if tiers is None:
            if directory:
                tiers = candidate_tiers_from_directory(directory)
                description = description or f"directory:{directory}"
            elif source is not None:
                tiers = candidate_tiers_from_source(source)
                description = description or "inline-source"
            elif crd:
                if self._crd_candidate_provider is None:
                    raise RolloutError(
                        "no CRD candidate provider wired (the webhook CLI "
                        "wires one when a CRD store is configured)"
                    )
                tiers = candidate_tiers_from_objects(self._crd_candidate_provider())
                description = description or "crd-label"
            else:
                raise RolloutError(
                    "stage requires tiers, a directory, a source string, or crd=True"
                )
        if not tiers:
            raise RolloutError("stage: candidate has no tiers")

        self._finalize_or_refuse_promotion()
        cand = _Candidate(tiers, description)
        gated_tiers = self._gate(cand, tiers)
        self._build_stack(cand, gated_tiers)
        with self._lock:
            if self._state == STATE_PROMOTED:
                # a promote() landed while this stage compiled outside the
                # lock; installing now would strand its rollback point
                raise RolloutError(
                    "a promotion landed while the candidate was compiling: "
                    "rollback or commit it before staging"
                )
            old_shadow = self._detach_shadow_locked()
            self._candidate = cand
            self._report = DiffReport(exemplar_cap=self.exemplar_cap)
            self._shadow = ShadowEvaluator(
                cand,
                self._report,
                sample_rate=self.sample_rate if sample_rate is None else sample_rate,
                queue_depth=self.queue_depth,
                duty_cycle=self.duty_cycle,
                attributor=self._build_attributor(cand),
            )
            self._state = STATE_STAGED
            self._bump_generation_locked()
        self._stop_shadow(old_shadow)
        self._start_warm(cand, warm)
        log.info("staged candidate %r (%d tier(s), warm=%s)", cand.description, len(tiers), warm)
        self._audit("staged", description=cand.description, tiers=len(tiers))
        return self.status()

    def set_audit_sink(self, sink) -> None:
        """Late-bind the audit sink (the CLI builds the audit log after the
        controller)."""
        self._audit_sink = sink

    def _audit(self, event: str, **fields) -> None:
        sink = self._audit_sink
        if sink is None:
            return
        try:
            sink({"kind": "rollout", "event": event, "ts": time.time(),
                  "generation": self.generation, **fields})
        except Exception:  # noqa: BLE001 — audit never gates the lifecycle
            log.exception("rollout audit record failed")

    def _finalize_or_refuse_promotion(self) -> None:
        """Staging over an active promotion would strand its rollback
        point. Either a store reload landed on a swapped engine since (the
        promotion is superseded, and rollback refuses on the same test):
        finalize it and stage; or it still serves: refuse."""
        with self._lock:
            if self._state != STATE_PROMOTED:
                return
            superseded = any(
                live.load_generation != generation
                for live, _prior, generation in self._rollback_points.values()
            )
            if superseded and self._rollback_points:
                log.info("previous promotion superseded by store reloads; "
                         "finalizing it (rollback point discarded)")
                self._rollback_points = {}
                self._promoted = None
                self._state = STATE_IDLE
                return
            raise RolloutError(
                "a promotion is still active: rollback first, or commit "
                "the promoted content to the policy store (the reload "
                "finalizes the promotion) before staging a new candidate"
            )

    def _gate(self, cand: _Candidate, tiers) -> list:
        """The stage gate (analysis/loadgate.py) over the candidate's tier
        stack; blocking findings reject it under the default strict
        posture. publish=False keeps the candidate's findings out of the
        live set's cedar_policy_* metrics."""
        try:
            gated, report = enforce(tiers, self.stage_validation_mode, publish=False)
        except AnalysisRejected as e:
            cand.analysis = e.report
            raise RolloutError(f"candidate rejected by analysis: {e}")
        cand.analysis = report
        return gated

    def _build_stack(self, cand: _Candidate, gated_tiers) -> None:
        """Compile the candidate engines (when the live side has engines)
        and build the stacks the shadow evaluator answers through."""
        authz_stores, admission_stores = candidate_stores(cand.tiers)
        admission_tail = allow_all_admission_policy_store().policy_set()
        evaluate = evaluate_batch = None
        adm_evaluate = adm_evaluate_batch = None
        try:
            with self._compile_context():
                self._compile_engines(cand, gated_tiers, admission_tail)
        except Exception as e:
            raise RolloutError(f"candidate failed to compile: {e}")
        if cand.authz_engine is not None:
            evaluate = cand.authz_engine.evaluate
            evaluate_batch = cand.authz_engine.evaluate_batch
        if cand.admission_engine is not None:
            adm_evaluate = cand.admission_engine.evaluate
            adm_evaluate_batch = cand.admission_engine.evaluate_batch
        cand.authorizer = CedarWebhookAuthorizer(
            authz_stores, evaluate=evaluate, evaluate_batch=evaluate_batch)
        cand.admission_handler = CedarAdmissionHandler(
            admission_stores, evaluate=adm_evaluate, evaluate_batch=adm_evaluate_batch)

    def _compile_engines(self, cand: _Candidate, gated_tiers, admission_tail) -> None:
        """A candidate engine per live engine, loaded (not warmed) with the
        gated tiers (admission: plus the allow-all tail)."""
        if self.authz_engine is not None:
            cand.authz_engine = self._engine_factory("candidate-authorization", self.authz_engine)
            cand.authz_engine.load(list(gated_tiers))
        if self.admission_engine is not None:
            cand.admission_engine = self._engine_factory(
                "candidate-admission", self.admission_engine)
            cand.admission_engine.load(list(gated_tiers) + [admission_tail])

    def _build_attributor(self, cand: _Candidate):
        """The explain plane's DiffAttributor for this candidate (on a
        shadow diff the exemplar gains both sides' determining policies).
        Best-effort: a failure here never gates staging."""
        try:
            from ..explain import DiffAttributor

            return DiffAttributor(
                live_authz_engine=self.authz_engine,
                live_admission_engine=self.admission_engine,
                candidate=cand,
            )
        except Exception:  # noqa: BLE001 — attribution is optional
            log.exception("diff attributor construction failed")
            return None

    def _start_warm(self, cand: _Candidate, warm: str) -> None:
        """Warm each candidate engine up to its live engine's top bucket,
        on a background thread ("async"), inline ("sync") or not at all
        ("off"). A superseded candidate stops warming between buckets."""
        pairs = [
            (c, live)
            for c, live in ((cand.authz_engine, self.authz_engine),
                            (cand.admission_engine, self.admission_engine))
            if c is not None
        ]
        if warm == "off" or not pairs:
            cand.warm_state = "ready"
            return

        def _live():
            # polled per bucket inside warmup() too: warming a superseded
            # candidate would take the card and the host from live serving
            return self._candidate is cand and not warm_shutdown_set()

        def _warm_all():
            try:
                for engine, live in pairs:
                    if not _live():
                        return  # superseded mid-warm; the new stage owns it
                    t0 = time.monotonic()
                    launches = engine.warmup(_warm_top(live), should_continue=_live)
                    cand.warm_stats[engine.name] = {
                        "compile_seconds": engine.last_load.get("compile_seconds"),
                        "buckets": list(engine.warm_buckets),
                        "seconds": round(time.monotonic() - t0, 4),
                        "launches": launches,
                    }
                if not _live():
                    return  # stopped mid-ladder: never claim readiness
                cand.warm_state = "ready"
            except Exception:  # noqa: BLE001 — an unwarmed candidate still shadows
                log.exception("candidate warm-up failed")
                cand.warm_state = "failed"
            finally:
                untrack_warm_thread(threading.current_thread())

        cand.warm_state = "warming"
        if warm == "sync":
            _warm_all()
        else:
            t = threading.Thread(target=_warm_all, name="rollout-warm", daemon=True)
            # joined at exit: a thread torn down inside a CUDA call at
            # interpreter teardown can abort the process
            track_warm_thread(t)
            t.start()

    def warm_ready(self) -> bool:
        cand = self._candidate
        return cand is not None and cand.warm_state == "ready"

    def promote(self, force: bool = False) -> dict:
        """Swap the candidate's warmed compiled sets into the live engines
        and end shadowing. Needs a staged candidate whose warm-up finished
        (``force=True`` promotes it cold). The prior sets are kept for
        rollback()."""
        chaos_fire("rollout.promote")
        with self._lock:
            cand = self._candidate
            if self._state != STATE_STAGED or cand is None:
                raise RolloutError("promote: no staged candidate")
            if self.authz_engine is None:
                raise RolloutError(
                    "promote requires the device backend (no live engine to "
                    "swap); interpreter deployments change the store content "
                    "instead"
                )
            if cand.warm_state != "ready" and not force:
                raise RolloutError(
                    f"promote: candidate warm-up is {cand.warm_state} "
                    "(pass force=True to promote cold)"
                )
            swaps = []
            for role, live, staged in (
                ("authorization", self.authz_engine, cand.authz_engine),
                ("admission", self.admission_engine, cand.admission_engine),
            ):
                if live is None or staged is None:
                    continue
                if staged.compiled_set is None:
                    raise RolloutError(f"promote: candidate {role} engine empty")
                swaps.append((role, live, staged))
            rollback_points = {}
            done = []
            failed_role = None
            try:
                for role, live, staged in swaps:
                    failed_role = role
                    prior, generation = live.adopt_compiled(staged.compiled_set, donor=staged)
                    done.append((role, live, prior))
                    rollback_points[role] = (live, prior, generation)
            except Exception as e:
                # across roles: an admission swap failing after the
                # authorization swap landed must not leave the two roles on
                # different sets; restore and refuse
                for _role, live, prior in reversed(done):
                    try:
                        live.adopt_compiled(prior)
                    except Exception:  # noqa: BLE001 — keep restoring
                        log.exception("promote: restore of %s after a failed swap "
                                      "also failed", _role)
                raise RolloutError(
                    f"promote: {failed_role} swap failed; every engine "
                    f"restored to the prior set: {e}"
                )
            self._rollback_points = rollback_points
            self._promoted = cand
            self._candidate = None
            old_shadow = self._detach_shadow_locked()
            self._state = STATE_PROMOTED
            self._bump_generation_locked()
        self._stop_shadow(old_shadow)
        log.info("promoted candidate %r into %d live engine(s)", cand.description,
                 len(self._rollback_points))
        self._audit("promoted", description=cand.description,
                    roles=sorted(self._rollback_points))
        return self.status()

    def rollback(self) -> dict:
        """Staged: discard the candidate (nothing live changed). Promoted:
        hand the prior compiled sets back through adopt_compiled, unless a
        store reload landed on a live engine since the promotion (the
        saved set is then stale and rollback refuses)."""
        old_shadow = None
        with self._lock:
            if self._state == STATE_STAGED:
                old_shadow = self._detach_shadow_locked()
                self._candidate = None
                # nothing left to inspect: a discarded candidate's report
                # would read as the diffs of a current rollout
                self._report = None
                self._state = STATE_IDLE
                self._bump_generation_locked()
                log.info("discarded staged candidate")
                discarded = True
            else:
                discarded = False
        if discarded:
            self._stop_shadow(old_shadow)
            self._audit("rollback_discarded")
            return self.status()
        with self._lock:
            if self._state != STATE_PROMOTED:
                raise RolloutError("rollback: nothing staged or promoted")
            diverged = [
                {"role": role, "expected_generation": generation,
                 "live_generation": live.load_generation}
                for role, (live, _prior, generation) in self._rollback_points.items()
                if live.load_generation != generation
            ]
            if diverged:
                classification = ("partial_promotion_wedge"
                                  if len(diverged) < len(self._rollback_points)
                                  else "store_reload_superseded")
                detail = {"diverged": diverged, "classification": classification}
                self._audit("rollback_refused", detail=detail)
                raise RolloutError(
                    "rollback: live engine(s) reloaded since promotion "
                    "(store content changed); the saved set is stale — "
                    "restore by reverting the store content ("
                    + ", ".join(e["role"] for e in diverged)
                    + " diverged)",
                    detail=detail,
                )
            for role, (live, prior, _generation) in self._rollback_points.items():
                if prior is None:
                    raise RolloutError(f"rollback: no prior compiled set for {role}")
            for role, (live, prior, _generation) in self._rollback_points.items():
                live.adopt_compiled(prior)
            self._rollback_points = {}
            self._promoted = None
            self._state = STATE_IDLE
            self._bump_generation_locked()
        log.info("rolled back to the pre-promotion compiled sets")
        self._audit("rolled_back")
        return self.status()

    def stop(self) -> None:
        self._stop_shadow(self._detach_shadow())

    def shadow_worker_threads(self) -> list:
        """The current shadow worker thread (supervisor liveness probe;
        empty with nothing staged, which reads healthy)."""
        shadow = self._shadow
        return shadow.worker_threads() if shadow is not None else []

    def revive_shadow(self, force: bool = False) -> bool:
        """Supervisor restart hook of the current shadow worker."""
        shadow = self._shadow
        return shadow.revive(force) if shadow is not None else False

    def shadow_heartbeats(self) -> dict:
        """The current shadow worker's heartbeat (supervisor wedge probe;
        re-read per check so a re-stage stays covered)."""
        shadow = self._shadow
        return {"shadow": shadow.heartbeat} if shadow is not None else {}

    def _detach_shadow(self):
        """Unhook the shadow evaluator under the lock for the caller to
        stop outside it: stop() joins the worker (up to 5 s), and holding
        the lock across that would block /debug/rollout and every
        lifecycle call."""
        with self._lock:
            return self._detach_shadow_locked()

    def _detach_shadow_locked(self):
        shadow, self._shadow = self._shadow, None
        return shadow

    @staticmethod
    def _stop_shadow(shadow) -> None:
        if shadow is not None:
            shadow.stop()

    def _bump_generation_locked(self) -> None:
        self.generation += 1
        try:
            metrics.set_rollout_generation(self.generation)
        except Exception:  # noqa: BLE001 — metrics never gate the lifecycle
            pass

    # -------------------------------------------------------------- serving

    def offer(self, endpoint: str, body: bytes, live) -> bool:
        """Hand one live (body, answer) pair to the shadow evaluator. Called
        from the serving paths: never raises, never blocks."""
        shadow = self._shadow
        if shadow is None:
            return False
        try:
            return shadow.offer(endpoint, body, live)
        except Exception:  # noqa: BLE001 — shadow must never hurt serving
            log.exception("shadow offer failed")
            return False

    def drain(self, timeout_s: float = 10.0) -> bool:
        shadow = self._shadow
        return True if shadow is None else shadow.drain(timeout_s)

    def candidate_stack(self):
        """(authorizer, admission handler) of the staged candidate, or
        None: the cache-bypassing stacks the shadow evaluator uses."""
        cand = self._candidate
        if cand is None:
            return None
        return cand.authorizer, cand.admission_handler

    @property
    def report(self) -> Optional[DiffReport]:
        return self._report

    def set_sample_rate(self, rate: float) -> None:
        self.sample_rate = max(0.0, min(1.0, float(rate)))
        shadow = self._shadow
        if shadow is not None:
            shadow.sample_rate = self.sample_rate

    def effective_sample_rate(self) -> float:
        """The rate in force: a per-stage override lives on the shadow
        evaluator, not on the controller default."""
        shadow = self._shadow
        return shadow.sample_rate if shadow is not None else self.sample_rate

    # -------------------------------------------------------------- status

    def status(self) -> dict:
        """The /debug/rollout document."""
        with self._lock:
            cand = self._candidate or self._promoted
            doc: dict = {
                "state": self._state,
                "generation": self.generation,
                "sample_rate": self.effective_sample_rate(),
            }
            if cand is not None:
                doc["candidate"] = {
                    "description": cand.description,
                    "staged_at": cand.staged_at,
                    "tiers": len(cand.tiers),
                    "policies": sum(len(ps.policies()) for ps in cand.tiers),
                    "warm_state": cand.warm_state,
                    "warm_stats": cand.warm_stats,
                    "analysis_findings": cand.analysis.counts() if cand.analysis else {},
                }
            engines = {}
            for role, live in (("authorization", self.authz_engine),
                               ("admission", self.admission_engine)):
                if live is not None:
                    engines[role] = {"load_generation": live.load_generation, **live.stats}
            if engines:
                doc["live_engines"] = engines
            if self._report is not None:
                doc["diff"] = self._report.to_dict()
            shadow = self._shadow
            if shadow is not None:
                doc["shadow_queue"] = shadow.queue_depth()
                # the port's own: the candidate engines' launches made by
                # the shadow worker (kept out of the served counts)
                doc["shadow_launches"] = dict(shadow.launches)
            return doc
