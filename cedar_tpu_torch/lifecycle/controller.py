"""The declarative lifecycle controller: a self-driving, self-healing
author → verify → shadow → canary → promote loop (a copy of the JAX
package's lifecycle/controller.py over the port's rollout controller: the
same stages, codes, journal records, retries and deadlines).

Every rollout primitive in the repo is evidence-producing but
operator-driven; this controller closes the loop. Each tenant's
``PolicyRolloutSpec`` (spec.py) compiles into a per-tenant state machine:

    pending → verifying → [analyzing] → shadowing → canary (ladder rungs)
            → promoting → promoted
    any gate breach → halted → rolled_back       (automatic)
    rollback failure / retry exhaustion → failed

Stages advance ONLY on recorded evidence — the analysis report's
lowerability coverage, the shadow DiffReport's sample/diff counts, the
canary slice's SLO availability burn — and every transition is
write-ahead journaled (journal.py), audited, and exported
(cedar_lifecycle_stage{tenant} + transition counters; /debug/lifecycle
renders ``status()``).

Self-healing: transient stage failures (DriverError, injected
ChaosError) retry with decorrelated-jitter backoff (server/backoff.py)
as a NON-BLOCKING per-tenant retry-at timestamp — one tenant's flapping
stage never delays a neighbor's tick — bounded by the spec's
``max_retries`` and per-stage deadline; exhaustion is a ``deadline`` /
``retry_exhausted`` breach like any other, so the machine halts and
rolls back instead of wedging. A controller crash (the
``lifecycle.journal`` kill drill) resumes via ``resume()``: terminal
stages stay terminal, anything in flight has its driver unwound to the
live-only serving plane (no mixed-generation window) and restarts from
``pending`` to re-earn promotion from fresh evidence.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from ..chaos.registry import ChaosError, chaos_fire
from ..server.backoff import Backoff
from .driver import DriverError, GateBreach
from .journal import TERMINAL_STAGES, LifecycleJournal
from .spec import PROMOTION_MANUAL, PolicyRolloutSpec, spec_from_dict

log = logging.getLogger(__name__)

STAGE_PENDING = "pending"
STAGE_VERIFYING = "verifying"
STAGE_ANALYZING = "analyzing"
STAGE_SHADOWING = "shadowing"
STAGE_CANARY = "canary"
STAGE_PROMOTING = "promoting"
STAGE_PROMOTED = "promoted"
STAGE_HALTED = "halted"
STAGE_ROLLED_BACK = "rolled_back"
STAGE_FAILED = "failed"

# gauge codes (cedar_lifecycle_stage help text mirrors this table)
STAGE_CODES = {
    STAGE_PENDING: 0,
    STAGE_VERIFYING: 1,
    STAGE_SHADOWING: 2,
    STAGE_CANARY: 3,
    STAGE_PROMOTING: 4,
    STAGE_PROMOTED: 5,
    STAGE_HALTED: 6,
    STAGE_ROLLED_BACK: 7,
    STAGE_FAILED: 8,
    # appended (not renumbered) so dashboards keyed on 0-8 stay valid:
    # the opt-in semantic-diff gate between verifying and shadowing
    STAGE_ANALYZING: 9,
}


class LifecycleError(RuntimeError):
    """A controller-level operation was invalid (unknown tenant,
    conflicting apply, …)."""


class _TenantRollout:
    """One tenant's in-flight rollout: spec + driver + machine state."""

    def __init__(self, spec: PolicyRolloutSpec, driver, backoff: Backoff,
                 now: float):
        self.spec = spec
        self.driver = driver
        self.stage = STAGE_PENDING
        self.stage_entered = now
        self.backoff = backoff
        self.attempts = 0
        self.next_retry_at = 0.0
        self.rung = -1  # index into spec.canary_ladder; -1 = not started
        self.approved = False
        self.awaiting_approval = False
        self.evidence: dict = {}
        self.halt: Optional[dict] = None
        self.error: Optional[str] = None


class LifecycleController:
    """Owns every tenant's rollout machine; ``tick()`` advances them all
    (each at most one step), isolating tenants from one another."""

    def __init__(
        self,
        journal: Optional[LifecycleJournal] = None,
        audit_log=None,
        clock: Callable[[], float] = time.monotonic,
        backoff_base_s: float = 0.5,
        backoff_cap_s: float = 30.0,
        backoff_uniform=None,
    ):
        self.journal = journal or LifecycleJournal()
        self.audit_log = audit_log
        self._clock = clock
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._backoff_uniform = backoff_uniform
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantRollout] = {}
        self._loop: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -------------------------------------------------------- spec admin

    def _new_backoff(self) -> Backoff:
        kwargs = {}
        if self._backoff_uniform is not None:
            kwargs["uniform"] = self._backoff_uniform
        return Backoff(self._backoff_base_s, self._backoff_cap_s, **kwargs)

    def apply(self, spec: PolicyRolloutSpec, driver) -> dict:
        """Admit one tenant's rollout. Re-applying over a TERMINAL
        machine restarts it (a new journal epoch for the tenant);
        re-applying over an in-flight one is refused — halt it first
        (delete) or let it finish."""
        with self._lock:
            existing = self._tenants.get(spec.tenant)
            if existing is not None and existing.stage not in TERMINAL_STAGES:
                raise LifecycleError(
                    f"apply: tenant {spec.tenant!r} already has a rollout "
                    f"in flight (stage {existing.stage}); delete it first"
                )
            m = _TenantRollout(
                spec, driver, self._new_backoff(), self._clock()
            )
            self._tenants[spec.tenant] = m
        self.journal.append(
            {"event": "applied", "tenant": spec.tenant,
             "spec": spec.to_dict()}
        )
        self._publish_stage(spec.tenant, STAGE_PENDING)
        self._audit(spec.tenant, "applied", stage=STAGE_PENDING)
        return {"tenant": spec.tenant, "stage": STAGE_PENDING}

    def delete(self, tenant: str) -> None:
        """Remove a tenant's rollout spec: unwind anything in flight,
        drop the stage gauge row, free the tenant's metric label slot."""
        with self._lock:
            m = self._tenants.pop(tenant, None)
        if m is None:
            raise LifecycleError(f"delete: no rollout for tenant {tenant!r}")
        if m.stage not in TERMINAL_STAGES:
            try:
                m.driver.reset()
            except Exception:  # noqa: BLE001 — deletion must complete
                log.exception(
                    "lifecycle delete(%s): driver reset failed", tenant
                )
        self.journal.append({"event": "deleted", "tenant": tenant})
        self._audit(tenant, "deleted", stage=m.stage)
        try:
            from ..server.metrics import clear_lifecycle_tenant

            clear_lifecycle_tenant(tenant)
        except Exception:  # noqa: BLE001 — metrics never gate admin
            pass

    def approve(self, tenant: str) -> dict:
        """Manual-promotion consent; the next tick promotes (a rollout
        holding at the last canary rung keeps gating burn/flips until
        then)."""
        with self._lock:
            m = self._tenants.get(tenant)
            if m is None:
                raise LifecycleError(
                    f"approve: no rollout for tenant {tenant!r}"
                )
            m.approved = True
        self.journal.append({"event": "approved", "tenant": tenant})
        self._audit(tenant, "approved", stage=m.stage)
        return {"tenant": tenant, "stage": m.stage, "approved": True}

    # ------------------------------------------------------- the machine

    def tick(self) -> Dict[str, str]:
        """Advance every tenant's machine at most one step. Per-tenant
        containment: an unexpected exception in one machine becomes that
        machine's transient failure, never a neighbor's problem. Chaos
        ``kill`` rules (ThreadKilled, a BaseException) DO propagate —
        that is the controller-crash drill."""
        with self._lock:
            machines = list(self._tenants.values())
        out: Dict[str, str] = {}
        for m in machines:
            try:
                self._advance(m)
            except Exception as e:  # noqa: BLE001 — tenant isolation
                log.exception(
                    "lifecycle tick(%s) raised; treating as transient",
                    m.spec.tenant,
                )
                try:
                    self._note_transient(m, e)
                except Exception:  # noqa: BLE001 — isolation, always
                    log.exception(
                        "lifecycle tick(%s) containment failed",
                        m.spec.tenant,
                    )
            out[m.spec.tenant] = m.stage
        return out

    def _advance(self, m: _TenantRollout) -> None:
        if m.stage in TERMINAL_STAGES:
            return
        now = self._clock()
        if now < m.next_retry_at:
            return
        try:
            self._advance_stage(m, now)
        except GateBreach as b:
            self._breach(m, b.gate, b.evidence)
        except (DriverError, ChaosError) as e:
            self._note_transient(m, e)

    def _advance_stage(self, m: _TenantRollout, now: float) -> None:
        spec = m.spec
        tenant = spec.tenant
        if m.stage == STAGE_PENDING:
            self._transition(m, STAGE_VERIFYING)
            return

        if m.stage == STAGE_VERIFYING:
            chaos_fire(
                "lifecycle.gate",
                payload={"tenant": tenant, "stage": m.stage},
            )
            ev = m.driver.verify(spec)
            m.evidence["verify"] = ev
            if ev.get("blocking", 0) > 0 or (
                ev.get("lowerable_pct", 0.0) < spec.lowerability_floor_pct
            ):
                raise GateBreach("lowerability", ev)
            if spec.analyze_enabled:
                # opt-in semantic-diff gate runs BEFORE any live traffic
                # (shadow mirroring included) sees the candidate
                self._transition(m, STAGE_ANALYZING, evidence=ev)
                return
            m.driver.start_shadow(spec)
            self._transition(m, STAGE_SHADOWING, evidence=ev)
            return

        if m.stage == STAGE_ANALYZING:
            chaos_fire(
                "lifecycle.gate",
                payload={"tenant": tenant, "stage": m.stage},
            )
            ev = m.driver.analyze(spec)
            m.evidence["analyze"] = ev
            if ev.get("oracle_disagreements", 0) > 0:
                # the plane and the interpreter disagreed on a sampled
                # request: a compiler bug, never promotable evidence
                raise GateBreach("analyze_oracle", ev)
            if ev.get("out_of_intent_flips", 0) > spec.analyze_flip_budget:
                raise GateBreach("semantic_diff", ev)
            m.driver.start_shadow(spec)
            self._transition(m, STAGE_SHADOWING, evidence=ev)
            return

        if m.stage == STAGE_SHADOWING:
            chaos_fire(
                "lifecycle.gate",
                payload={"tenant": tenant, "stage": m.stage},
            )
            ev = m.driver.shadow_evidence()
            m.evidence["shadow"] = ev
            if ev["samples"] >= spec.shadow_min_samples:
                if ev["diffs"] > spec.shadow_diff_budget:
                    raise GateBreach("shadow_diff", ev)
                if spec.canary_ladder:
                    m.rung = 0
                    m.driver.set_canary(spec.canary_ladder[0])
                    self._transition(
                        m, STAGE_CANARY, evidence=ev,
                        rung=0, percent=spec.canary_ladder[0],
                    )
                else:
                    # no canary rungs configured: shadow evidence is the
                    # final gate (webhook-server posture, spec.py)
                    self._enter_promotion(m, ev)
            elif now - m.stage_entered >= spec.stage_deadline_s:
                raise GateBreach("deadline", ev)
            return

        if m.stage == STAGE_CANARY:
            chaos_fire(
                "lifecycle.gate",
                payload={"tenant": tenant, "stage": m.stage},
            )
            ev = m.driver.canary_evidence(spec.slo_burn_window_s)
            m.evidence["canary"] = ev
            if ev["burn"] > spec.slo_burn_ceiling:
                raise GateBreach("slo_burn", ev)
            if ev["flips"] > spec.canary_max_flips:
                raise GateBreach("canary_flip", ev)
            if ev["decisions"] < spec.canary_min_decisions:
                if (
                    not m.awaiting_approval
                    and now - m.stage_entered >= spec.stage_deadline_s
                ):
                    raise GateBreach("deadline", ev)
                return
            if m.rung + 1 < len(spec.canary_ladder):
                m.rung += 1
                m.driver.set_canary(spec.canary_ladder[m.rung])
                # canary → canary: each rung re-earns its quorum under a
                # fresh per-stage deadline
                self._transition(
                    m, STAGE_CANARY, evidence=ev,
                    rung=m.rung, percent=spec.canary_ladder[m.rung],
                )
            else:
                self._enter_promotion(m, ev)
            return

        if m.stage == STAGE_PROMOTING:
            chaos_fire(
                "lifecycle.gate",
                payload={"tenant": tenant, "stage": m.stage},
            )
            m.driver.promote()
            self._transition(m, STAGE_PROMOTED)
            return

        if m.stage == STAGE_HALTED:
            # automatic rollback; its own retry budget started at the
            # halted transition
            try:
                m.driver.rollback()
            except DriverError as e:
                detail = getattr(e, "detail", None)
                if detail is not None:
                    # lineage divergence is permanent — retrying cannot
                    # un-diverge the serving plane
                    self._transition(
                        m, STAGE_FAILED, reason=str(e), detail=detail
                    )
                    return
                raise
            self._transition(m, STAGE_ROLLED_BACK, halt=m.halt)
            return

    def _enter_promotion(self, m: _TenantRollout, evidence: dict) -> None:
        if m.spec.promotion == PROMOTION_MANUAL and not m.approved:
            if not m.awaiting_approval:
                m.awaiting_approval = True
                self.journal.append(
                    {"event": "awaiting_approval",
                     "tenant": m.spec.tenant, "evidence": evidence}
                )
                self._audit(
                    m.spec.tenant, "awaiting_approval", stage=m.stage
                )
            return
        m.awaiting_approval = False
        self._transition(m, STAGE_PROMOTING, evidence=evidence)

    # ------------------------------------------------- breach + retries

    def _breach(self, m: _TenantRollout, gate: str, evidence: dict) -> None:
        tenant = m.spec.tenant
        try:
            from ..server.metrics import record_lifecycle_gate_breach

            record_lifecycle_gate_breach(tenant, gate)
        except Exception:  # noqa: BLE001 — metrics never gate the machine
            pass
        if m.stage == STAGE_HALTED:
            # the automatic rollback itself exhausted its budget
            self._transition(m, STAGE_FAILED, gate=gate, evidence=evidence)
            return
        m.halt = {"gate": gate, "stage": m.stage, "evidence": evidence}
        self._transition(m, STAGE_HALTED, gate=gate, evidence=evidence)

    def _note_transient(self, m: _TenantRollout, e: BaseException) -> None:
        if m.stage in TERMINAL_STAGES:
            return
        m.attempts += 1
        m.error = str(e)
        try:
            from ..server.metrics import record_lifecycle_retry

            record_lifecycle_retry(m.spec.tenant, m.stage)
        except Exception:  # noqa: BLE001
            pass
        now = self._clock()
        deadline = m.stage_entered + m.spec.stage_deadline_s
        if m.attempts > m.spec.max_retries:
            self._breach(
                m, "retry_exhausted",
                {"error": str(e), "attempts": m.attempts},
            )
        elif now >= deadline:
            self._breach(
                m, "deadline", {"error": str(e), "attempts": m.attempts}
            )
        else:
            m.next_retry_at = now + m.backoff.next()

    def _transition(self, m: _TenantRollout, to: str, **fields) -> None:
        """Write-ahead journal, then mutate, then publish: a crash inside
        the append resumes from the PRE-transition stage; a crash after
        it resumes from ``to`` — both restart cleanly (resume())."""
        frm = m.stage
        tenant = m.spec.tenant
        self.journal.append(
            {"event": "transition", "tenant": tenant, "from": frm,
             "to": to, **fields}
        )
        m.stage = to
        m.stage_entered = self._clock()
        m.attempts = 0
        m.next_retry_at = 0.0
        m.backoff.reset()
        m.error = None
        try:
            from ..server.metrics import record_lifecycle_transition

            record_lifecycle_transition(tenant, frm, to)
        except Exception:  # noqa: BLE001
            pass
        self._publish_stage(tenant, to)
        self._audit(tenant, "transition", frm=frm, to=to, **fields)
        log.info("lifecycle %s: %s -> %s", tenant, frm, to)

    @staticmethod
    def _publish_stage(tenant: str, stage: str) -> None:
        try:
            from ..server.metrics import set_lifecycle_stage

            set_lifecycle_stage(tenant, STAGE_CODES[stage])
        except Exception:  # noqa: BLE001
            pass

    def _audit(self, tenant: str, event: str, **fields) -> None:
        if self.audit_log is None:
            return
        try:
            self.audit_log.record(
                {"kind": "lifecycle", "tenant": tenant, "event": event,
                 "ts": time.time(), **fields}
            )
        except Exception:  # noqa: BLE001 — audit never gates the machine
            log.exception("lifecycle audit record failed")

    # ----------------------------------------------------- crash resume

    def resume(self, drivers: dict, specs: Optional[dict] = None) -> dict:
        """Rebuild the per-tenant machines from the journal after a
        controller crash. ``drivers`` maps tenant → driver bound to the
        (surviving or rebuilt) serving stack; ``specs`` optionally
        overrides the journaled spec documents (REQUIRED for candidates
        staged from opaque in-memory tiers, which don't journal).

        Terminal stages stay terminal. Anything in flight — including a
        crash mid-canary — has its driver unwound to the live-only plane
        (canary split zeroed, staged candidate discarded, un-finalized
        promotion restored) and restarts from ``pending``: the machine
        re-earns promotion from fresh evidence, which trivially
        guarantees no mixed-generation serving window survives the
        crash."""
        out = {}
        for tenant, entry in self.journal.replay().items():
            driver = drivers.get(tenant)
            if driver is None:
                log.warning(
                    "lifecycle resume: no driver for journaled tenant "
                    "%s; skipping", tenant,
                )
                continue
            spec = (specs or {}).get(tenant)
            if spec is None:
                if not entry.get("spec"):
                    log.warning(
                        "lifecycle resume: no spec for tenant %s", tenant
                    )
                    continue
                spec = spec_from_dict(entry["spec"])
            m = _TenantRollout(spec, driver, self._new_backoff(),
                               self._clock())
            stage = entry["stage"]
            if stage in TERMINAL_STAGES:
                m.stage = stage
            else:
                try:
                    driver.reset()
                except Exception as e:  # noqa: BLE001 — must not wedge resume
                    log.exception(
                        "lifecycle resume(%s): driver reset failed", tenant
                    )
                    m.stage = STAGE_FAILED
                    self.journal.append(
                        {"event": "transition", "tenant": tenant,
                         "from": stage, "to": STAGE_FAILED,
                         "reason": f"resume reset failed: {e}"}
                    )
                else:
                    m.stage = STAGE_PENDING
                    self.journal.append(
                        {"event": "resumed", "tenant": tenant,
                         "from": stage, "to": STAGE_PENDING}
                    )
                    self._audit(tenant, "resumed", frm=stage)
            with self._lock:
                self._tenants[tenant] = m
            self._publish_stage(tenant, m.stage)
            out[tenant] = m.stage
        return out

    # -------------------------------------------------- loop + reporting

    def start(self, interval_s: float = 0.25) -> None:
        """Background reconcile loop (the webhook CLI's wiring); tests
        and embedded runs call tick() directly instead."""
        if self._loop is not None:
            return
        self._stop_evt.clear()

        def _run():
            while not self._stop_evt.is_set():
                try:
                    self.tick()
                except BaseException:  # noqa: BLE001 — incl. ThreadKilled
                    log.exception(
                        "lifecycle loop crashed; controller needs resume()"
                    )
                    return
                self._stop_evt.wait(interval_s)

        self._loop = threading.Thread(
            target=_run, name="lifecycle-controller", daemon=True
        )
        self._loop.start()

    def stop(self) -> None:
        self._stop_evt.set()
        loop, self._loop = self._loop, None
        if loop is not None:
            loop.join(timeout=5.0)
        self.journal.close()

    def stages(self) -> Dict[str, str]:
        with self._lock:
            return {t: m.stage for t, m in self._tenants.items()}

    def status(self) -> dict:
        """The /debug/lifecycle document."""
        with self._lock:
            machines = dict(self._tenants)
        tenants = {}
        for tenant, m in machines.items():
            doc = {
                "stage": m.stage,
                "stage_code": STAGE_CODES[m.stage],
                "promotion": m.spec.promotion,
                "canary_ladder": list(m.spec.canary_ladder),
                "rung": m.rung,
                "attempts": m.attempts,
                "awaiting_approval": m.awaiting_approval,
                "evidence": m.evidence,
            }
            if m.halt is not None:
                doc["halt"] = m.halt
            if m.error is not None:
                doc["last_error"] = m.error
            tenants[tenant] = doc
        return {
            "tenants": tenants,
            "journal": self.journal.path or "memory",
        }


__all__ = [
    "LifecycleController",
    "LifecycleError",
    "STAGE_CODES",
    "STAGE_PENDING",
    "STAGE_VERIFYING",
    "STAGE_SHADOWING",
    "STAGE_CANARY",
    "STAGE_PROMOTING",
    "STAGE_PROMOTED",
    "STAGE_HALTED",
    "STAGE_ROLLED_BACK",
    "STAGE_FAILED",
]
