"""The lifecycle controller's hands: one tenant's serving-stack binding
(the JAX package's lifecycle/driver.py over the port's RolloutController
and its candidate engines on the card).

The controller (controller.py) is a pure evidence-driven state machine —
it never touches an engine. Everything stateful it needs doing goes
through a driver:

  * ``verify``        — analyze the candidate tiers (permissive mode) and
                        return lowerability-coverage evidence;
  * ``start_shadow``  — stage the candidate on the tenant's
                        RolloutController (strict analysis gate, candidate
                        engines, shadow evaluator);
  * ``shadow_evidence`` — the DiffReport rollup (samples + diffs);
  * ``set_canary``    — move the canary traffic split to a ladder rung;
  * ``canary_evidence`` — canary decisions, avoided flips, and the SLO
                        availability burn over the gate window;
  * ``promote`` / ``rollback`` / ``reset`` — the terminal actions.

Transient failures raise ``DriverError`` (the controller retries them
with decorrelated-jitter backoff under the stage deadline); permanent
gate rejections raise ``GateBreach`` (the controller halts + rolls back).

The canary split lives here too: ``serve()`` is the tenant's live
authorize path in embedded deployments (chip_smoke.py --only-lifecycle, tests). A
deterministic per-body hash routes ``fraction`` of traffic through the
candidate stack; the candidate's answer serves ONLY when its decision
agrees with the live engine's — a disagreeing canary answer is served
from the LIVE engine and counted as an avoided flip (fail-safe canary:
the rung proves the candidate plane's operational health, while decision
deltas are the shadow gate's evidence, and a flip that shadow missed
halts the rollout via ``canary_max_flips``). Candidate latency/errors
land in the SLO tracker under ``canary:<tenant>``, which is what the
burn-rate gate reads. The ``lifecycle.canary`` chaos seam fires per
canary-slice evaluation — an injected error burns the canary SLO without
touching live answers (the lifecycle-breach game day).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import zlib
from typing import Callable, Optional, Tuple

from ..chaos.registry import chaos_fire

log = logging.getLogger(__name__)


class DriverError(RuntimeError):
    """A transient stage failure — retry under the stage budget."""


class GateBreach(RuntimeError):
    """A permanent gate rejection — halt and roll back."""

    def __init__(self, gate: str, evidence: Optional[dict] = None):
        super().__init__(f"gate breach: {gate}")
        self.gate = gate
        self.evidence = evidence or {}


class RolloutLifecycleDriver:
    """Binds one tenant's lifecycle to a RolloutController + SLOTracker
    (+ an optional live-eval callable for the embedded canary router)."""

    def __init__(
        self,
        tenant: str,
        rollout,
        slo=None,
        live_eval: Optional[Callable[[bytes], Tuple[str, str]]] = None,
        warm: str = "off",
        promote_force: bool = False,
        sample_rate: float = 1.0,
        clock: Callable[[], float] = time.perf_counter,
        live_tiers: Optional[Callable[[], list]] = None,
    ):
        self.tenant = tenant
        self.rollout = rollout
        self.slo = slo
        self.live_eval = live_eval
        # provider of the LIVE tier PolicySets, required only when the
        # spec enables the analyze gate (the semantic diff needs both
        # sides; the rollout controller only knows the candidate)
        self.live_tiers = live_tiers
        self.warm = warm
        self.promote_force = promote_force
        self.sample_rate = sample_rate
        self._clock = clock
        self.slo_path = f"canary:{tenant}"
        self.canary_fraction = 0.0
        self._counter_lock = threading.Lock()
        self._canary_decisions = 0
        self._canary_flips = 0

    # --------------------------------------------------- controller side

    def _resolve_tiers(self, spec) -> list:
        """The candidate tiers, from whichever source the spec names —
        the same resolution stage() performs, run early so verify() can
        gate on analysis evidence before anything compiles."""
        c = spec.candidate
        if c.get("tiers"):
            return list(c["tiers"])
        from ..rollout.source import (
            candidate_tiers_from_directory,
            candidate_tiers_from_objects,
            candidate_tiers_from_source,
        )

        if c.get("directory"):
            return candidate_tiers_from_directory(c["directory"])
        if c.get("source"):
            return candidate_tiers_from_source(c["source"])
        provider = getattr(self.rollout, "_crd_candidate_provider", None)
        if provider is None:
            raise DriverError(
                "verify: candidate names crd=true but no CRD candidate "
                "provider is wired on the rollout controller"
            )
        return candidate_tiers_from_objects(provider())

    def verify(self, spec) -> dict:
        """Tier-1 evidence: permissive-mode analysis of the candidate —
        blocking-finding count and fully-lowerable coverage percent."""
        from ..analysis.loadgate import enforce

        try:
            tiers = self._resolve_tiers(spec)
            _, report = enforce(tiers, "permissive", publish=False)
        except Exception as e:  # noqa: BLE001 — source/analysis hiccups retry
            raise DriverError(f"verify: {e}") from e
        cov = report.coverage or {}
        return {
            "policies": cov.get("policies", 0),
            "lowerable_pct": float(cov.get("lowerable_pct", 0.0)),
            "blocking": len(report.blocking()),
        }

    def analyze(self, spec) -> dict:
        """Tier-1.5 evidence (opt-in): the device-exact semantic diff
        between the live and candidate tiers (analysis/semdiff.py), run
        entirely host-side BEFORE any live traffic touches the
        candidate. Returns flip counts split by allowed-intent coverage
        plus the interpreter-oracle cross-check; the controller breaches
        on out-of-intent flips over the budget or any disagreement."""
        from ..analysis.semdiff import semantic_diff

        if self.live_tiers is None:
            raise DriverError(
                "analyze: spec enables the analyze gate but no live_tiers "
                "provider is wired on the driver"
            )
        try:
            live = list(self.live_tiers())
            cand = self._resolve_tiers(spec)
            diff = semantic_diff(
                live,
                cand,
                budget=spec.analyze_universe_budget,
                oracle_sample=spec.analyze_oracle_sample,
            )
        except DriverError:
            raise
        except Exception as e:  # noqa: BLE001 — compile/source hiccups retry
            raise DriverError(f"analyze: {e}") from e
        out_of_intent = diff.out_of_intent(spec.analyze_allowed_intents)
        try:
            from ..server.metrics import record_semdiff_flips

            for kind, n in diff.flip_counts.items():
                record_semdiff_flips(self.tenant, kind, n)
        except Exception:  # noqa: BLE001 — metrics never gate the machine
            pass
        return {
            "requests": diff.n_requests,
            "exhaustive": diff.exact,
            "flips": dict(diff.flip_counts),
            "total_flips": diff.total_flips,
            "out_of_intent_flips": out_of_intent,
            "oracle_sampled": diff.oracle.get("sampled", 0),
            "oracle_disagreements": diff.oracle.get("disagreements", 0),
            # a few concrete flipped requests for the WAL/audit evidence
            "exemplars": diff.flips[:5],
            "seconds": round(diff.seconds, 3),
        }

    def start_shadow(self, spec) -> None:
        """Stage the candidate (strict analysis gate, candidate engines,
        shadow evaluator). An analysis rejection here is a lowerability
        breach — verify() already measured the same corpus, so reaching
        it means the floor passed but strict blocking findings exist."""
        from ..rollout.controller import RolloutError

        try:
            self.rollout.stage(
                description=f"lifecycle:{self.tenant}",
                warm=self.warm,
                sample_rate=self.sample_rate,
                **spec.stage_kwargs(),
            )
        except RolloutError as e:
            if "rejected by analysis" in str(e):
                raise GateBreach("lowerability", {"error": str(e)}) from e
            raise DriverError(f"stage: {e}") from e
        except Exception as e:  # noqa: BLE001 — compile/source hiccups retry
            raise DriverError(f"stage: {e}") from e

    def shadow_evidence(self) -> dict:
        report = self.rollout.report
        if report is None:
            raise DriverError("shadow evidence: no diff report (not staged)")
        return {
            "samples": report.total_evaluations,
            "diffs": report.total_diffs,
        }

    def set_canary(self, percent: float) -> None:
        """Move the canary split to a ladder rung. Decision counts reset
        per rung (each rung earns its own quorum); avoided-flip counts
        are cumulative — the candidate didn't change between rungs."""
        self.canary_fraction = max(0.0, min(1.0, percent / 100.0))
        with self._counter_lock:
            self._canary_decisions = 0

    def canary_evidence(self, window_s: float) -> dict:
        with self._counter_lock:
            decisions = self._canary_decisions
            flips = self._canary_flips
        burn = 0.0
        if self.slo is not None:
            burn = self.slo.availability_burn(self.slo_path, window_s)
        return {"decisions": decisions, "flips": flips, "burn": burn}

    def promote(self) -> None:
        from ..rollout.controller import RolloutError

        try:
            self.rollout.promote(force=self.promote_force)
        except RolloutError as e:
            # warm-up still running, concurrent stage, … — all retryable
            raise DriverError(f"promote: {e}") from e
        self.canary_fraction = 0.0

    def rollback(self) -> None:
        from ..rollout.controller import RolloutError

        self.canary_fraction = 0.0
        if self.rollout.status().get("state") == "idle":
            return  # nothing staged or promoted: rollback is a no-op
        try:
            self.rollout.rollback()
        except RolloutError as e:
            err = DriverError(f"rollback: {e}")
            err.detail = getattr(e, "detail", None)
            raise err from e

    def reset(self) -> None:
        """Crash-resume cleanup: whatever the dead controller left staged
        or promoted is unwound so the machine can restart from a clean
        live-only serving plane (no mixed-generation window: the live
        engines serve exactly one lineage after this returns)."""
        self.canary_fraction = 0.0
        with self._counter_lock:
            self._canary_decisions = 0
            self._canary_flips = 0
        state = self.rollout.status().get("state")
        if state in ("staged", "promoted"):
            self.rollback()

    # ------------------------------------------------------ serving side

    def serve(self, body: bytes, endpoint: str = "authorize"):
        """The tenant's live authorize path in embedded deployments:
        evaluate live, then either feed the shadow evaluator or run the
        canary slice. Returns the served (decision, reason)."""
        if self.live_eval is None:
            raise DriverError("serve: no live_eval wired")
        live = self.live_eval(body)
        fraction = self.canary_fraction
        if fraction > 0.0 and self._in_canary_slice(body, fraction):
            return self._canary_eval(body, live)
        # not canary traffic: offer to the shadow evaluator (no-op with
        # nothing staged; never raises, never blocks)
        self.rollout.offer(endpoint, body, live)
        return live

    @staticmethod
    def _in_canary_slice(body: bytes, fraction: float) -> bool:
        # stable per-body hash: the same request always lands on the same
        # side of the split, and a rung increase only ADDS bodies to the
        # slice (crc in [0,1) compared against the growing fraction)
        return (zlib.crc32(body) % 10000) / 10000.0 < fraction

    def _canary_eval(self, body: bytes, live):
        t0 = self._clock()
        error = False
        served = live
        try:
            chaos_fire(
                "lifecycle.canary", payload={"tenant": self.tenant}
            )
            cand = self._candidate_answer(body)
            if cand is not None:
                if cand[0] != live[0]:
                    # fail-safe: the disagreeing answer does NOT serve
                    with self._counter_lock:
                        self._canary_flips += 1
                else:
                    served = cand
        except Exception:  # noqa: BLE001 — chaos + candidate failures burn SLO
            error = True
        with self._counter_lock:
            self._canary_decisions += 1
        if self.slo is not None:
            try:
                self.slo.record(self.slo_path, self._clock() - t0, error)
            except Exception:  # noqa: BLE001 — SLO must never hurt serving
                log.exception("canary SLO record failed")
        return served

    def _candidate_answer(self, body: bytes):
        stack = self.rollout.candidate_stack()
        if stack is None:
            return None
        authorizer, _admission = stack
        if authorizer is None:
            return None
        from ..server.sar import get_authorizer_attributes

        attributes = get_authorizer_attributes(json.loads(body))
        return authorizer.authorize_batch([attributes])[0]


__all__ = ["DriverError", "GateBreach", "RolloutLifecycleDriver"]
