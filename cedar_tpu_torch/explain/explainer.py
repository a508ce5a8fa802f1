"""Request-level explanation for both webhooks, plus the rollout diff
attributor (the JAX package's explain/explainer.py over the port's
engine and stacks).

``Explainer`` answers ``?explain=1`` requests end to end: it re-derives
the decision through an attribution-capable plane AND renders why:
determining policy id, effect, clause, per-test attribute/operator/value
with source spans, the tier, and whether the interpreter fallback
answered. Three planes, chosen per path:

  * DEVICE: an engine holds a compiled set and its circuit breaker (when
    one is wired) is closed: one bits fetch on the engine's device
    (plane.py);
  * HOST: an engine holds a compiled set but its breaker is open, so the
    device must not be touched: numpy matching over the retained
    host-side pack (same tables, same semantics, no device call);
  * INTERPRETER: no compiled set at all (``--backend interpreter``):
    per-tier interpreter walk; policy-level attribution, no clause tests.

Every plane merges interpreter-fallback policy verdicts as the serving
engine's host tier walk does, so the explained decision and reason bytes
match what the non-explain path answers for the same request.

One difference from the JAX package, by design: a device explain that
fails while the breaker is closed is not re-run on the host plane. It
answers ``explain-error`` (NoOpinion with the error on /v1/authorize, the
handler's code-500 review on /v1/admit), logged with the exception, so an
answer labelled ``device`` always came from the device.

Explain requests BYPASS the decision cache (never read, never filled:
cached entries carry no clause indices) and the error injector: this is
an operator debugging surface, not serving traffic.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Tuple

from ..lang.authorize import Diagnostics
from .attribution import (
    SOURCE_DEVICE,
    SOURCE_GATE,
    SOURCE_HOST,
    attribution_summary,
    build_explanation,
    host_sat,
    interpreter_explanation,
    sat_from_bits,
)
from .plane import ExplainPlane, encode_single

log = logging.getLogger(__name__)


def engine_of(evaluate) -> Optional[object]:
    """The TorchPolicyEngine behind a bound ``evaluate`` (or
    ``evaluate_batch``) callable, if any: lets the webhook server find the
    engine on stacks wired through ``CedarWebhookAuthorizer(evaluate_batch=
    engine.evaluate_batch)`` without a fast path."""
    from ..engine.evaluator import TorchPolicyEngine

    owner = getattr(evaluate, "__self__", None)
    return owner if isinstance(owner, TorchPolicyEngine) else None


def _gate_explanation(label: str, **extra) -> dict:
    doc = {
        "decision": None,
        "tier": None,
        "source": SOURCE_GATE,
        "fallback": False,
        "determining": None,
        "reasons": [],
        "errors": [],
        "shortCircuit": label,
    }
    doc.update(extra)
    return doc


class Explainer:
    """Explanation engine for one server's authorization + admission
    stacks. Construction is cheap (no compiles, no device access); all
    device work happens lazily inside the per-engine ExplainPlane."""

    def __init__(
        self,
        authorizer=None,
        admission_handler=None,
        authz_engine=None,
        admission_engine=None,
        authz_breaker=None,
        admission_breaker=None,
    ):
        self.authorizer = authorizer
        self.admission_handler = admission_handler
        self._engines = {
            "authorization": (authz_engine, authz_breaker),
            "admission": (admission_engine, admission_breaker),
        }
        self._planes: dict = {}

    # ------------------------------------------------------------ plumbing

    def _plane(self, engine) -> ExplainPlane:
        plane = self._planes.get(id(engine))
        if plane is None:
            plane = self._planes[id(engine)] = ExplainPlane(engine)
        return plane

    def _interpreter_tiers(self, path: str) -> list:
        stack = (
            self.authorizer if path == "authorization" else self.admission_handler
        )
        stores = getattr(stack, "stores", None)
        if stores is None:
            return []
        return [s.policy_set() for s in stores]

    def _explain_eval(
        self, path: str, entities, request
    ) -> Tuple[str, Diagnostics, dict]:
        """(cedar decision, Diagnostics, explanation) through the best
        available plane for ``path``."""
        engine, breaker = self._engines[path]
        cs = engine._compiled if engine is not None else None
        if cs is not None and (breaker is None or breaker.allow()):
            # a failure here raises to the caller's explain-error answer:
            # no re-run on the host plane while the breaker is closed
            codes_arr, extras_arr = encode_single(engine, cs, entities, request)
            bits = self._plane(engine).explain_row(codes_arr, extras_arr, cs=cs)
            sat = sat_from_bits(cs.packed, bits[0])
            return build_explanation(
                cs.packed, sat, entities, request, source=SOURCE_DEVICE
            )
        packed = cs.packed if cs is not None else None
        if packed is not None:
            from ..compiler.table import encode_request_codes

            codes, extras = encode_request_codes(
                packed.plan, packed.table, entities, request
            )
            sat = host_sat(packed, codes, extras)
            return build_explanation(
                packed, sat, entities, request, source=SOURCE_HOST
            )
        return interpreter_explanation(
            self._interpreter_tiers(path), entities, request
        )

    # ----------------------------------------------------- authorization

    def explain_authorize(self, body: bytes):
        """(decision, reason, error, explanation) for one raw SAR body —
        decision/reason/error carry the exact webhook answer semantics of
        the uncached python path; explanation is the ``?explain`` payload."""
        from ..server.authorizer import (
            CedarWebhookAuthorizer,
            DECISION_NO_OPINION,
        )
        from ..server.sar import get_authorizer_attributes

        try:
            sar = json.loads(body)
            attributes = get_authorizer_attributes(sar)
            # tenant stamp: on a fused multi-tenant plane the explain
            # answer must evaluate under the same context.tenantId the
            # serving paths stamp (empty until the port serves tenants)
            attributes.tenant = getattr(body, "tenant", "")
        except Exception as e:  # noqa: BLE001 — mirror the decode-error answer
            return (
                DECISION_NO_OPINION,
                "Encountered decoding error",
                f"failed parsing request body: {e}",
                _gate_explanation("decode-error", error=str(e)),
            )
        if self.authorizer is not None:
            # labeled at the gate itself (authorizer._short_circuit_labeled)
            # so this surface can never mislabel a gate it only saw the
            # (decision, reason) of
            short = self.authorizer._short_circuit_labeled(attributes)
            if short is not None:
                decision, reason, label = short
                return decision, reason, None, _gate_explanation(label)
        try:
            from ..server.authorizer import record_to_cedar_resource

            entities, request = record_to_cedar_resource(attributes)
            decision, diag, explanation = self._explain_eval(
                "authorization", entities, request
            )
        except Exception as e:  # noqa: BLE001 — always answer the operator
            # a device explain failure lands here too (explain-error)
            log.exception("explain authorize failed")
            return (
                DECISION_NO_OPINION,
                "",
                f"evaluation error: {e}",
                _gate_explanation("explain-error", error=str(e)),
            )
        mapped, reason = CedarWebhookAuthorizer._map_verdict(decision, diag)
        explanation["webhookDecision"] = mapped
        return mapped, reason, None, explanation

    # --------------------------------------------------------- admission

    def explain_admit(self, body: bytes):
        """(AdmissionResponse, explanation) for one raw AdmissionReview
        body, mirroring the handler's gates and response rendering."""
        from ..entities.admission import AdmissionRequest
        from ..server.admission import SKIPPED_NAMESPACES, AdmissionResponse

        handler = self.admission_handler
        try:
            review = json.loads(body)
        except (ValueError, TypeError, RecursionError) as e:
            return (
                AdmissionResponse(
                    uid="", allowed=False, code=400,
                    error=f"failed parsing body: {e}",
                ),
                _gate_explanation("decode-error", error=str(e)),
            )
        try:
            req = AdmissionRequest.from_admission_review(review)
        except Exception as e:  # noqa: BLE001 — fail-open like the handler
            allowed = bool(getattr(handler, "allow_on_error", True))
            return (
                AdmissionResponse(
                    uid="", allowed=allowed, code=200,
                    error=f"evaluation error "
                    f"({'allowed' if allowed else 'denied'} on error): {e}",
                ),
                _gate_explanation("conversion-error", error=str(e)),
            )
        if req.namespace in SKIPPED_NAMESPACES:
            return (
                AdmissionResponse(uid=req.uid, allowed=True),
                _gate_explanation("namespace-skip"),
            )
        if handler is not None and not handler._ready():
            return (
                AdmissionResponse(uid=req.uid, allowed=True),
                _gate_explanation("stores-not-ready"),
            )
        try:
            # tenant stamp: same contract as explain_authorize
            req.tenant = getattr(body, "tenant", "")
            entities, cedar_req = handler._build(req)
            decision, diag, explanation = self._explain_eval(
                "admission", entities, cedar_req
            )
        except Exception as e:  # noqa: BLE001 — mirror the handler's 500
            # a device explain failure lands here too (explain-error)
            log.exception("explain admit failed")
            return (
                AdmissionResponse(
                    uid=req.uid,
                    allowed=bool(getattr(handler, "allow_on_error", True)),
                    code=500,
                    error=str(e),
                ),
                _gate_explanation("explain-error", error=str(e)),
            )
        response = handler._decide(req, decision, diag)
        explanation["webhookDecision"] = (
            "allow" if response.allowed else "deny"
        )
        return response, explanation


class DiffAttributor:
    """Determining-policy attribution for rollout diff exemplars: on a
    decision flip, explain the SAME request against the live and the
    candidate packs so the report says which policy (and clause) decided
    each side. Host-plane only: a shadow worker must never launch device
    work beside the serving engine's; engines without a compiled set fall
    back to the interpreter walk over the candidate's store tiers. The
    candidate is duck-typed (``authz_engine``, ``tiers``,
    ``admission_engine``, ``admission_handler``); the port has no rollout
    controller yet to hand it one."""

    def __init__(
        self,
        live_authz_engine=None,
        live_admission_engine=None,
        candidate=None,
        live_authz_tiers=None,
        live_admission_tiers=None,
    ):
        self.live_authz = live_authz_engine
        self.live_admission = live_admission_engine
        self.candidate = candidate
        # interpreter-walk fallbacks for the live side (offline
        # cedar-shadow replay, interpreter deployments): policy-level
        # attribution when no live engine holds a compiled pack
        self.live_authz_tiers = list(live_authz_tiers or ())
        self.live_admission_tiers = list(live_admission_tiers or ())

    @staticmethod
    def _summary(engine, tiers, entities, request) -> Optional[dict]:
        try:
            cs = engine.compiled_set if engine is not None else None
            if cs is not None:
                from ..compiler.table import encode_request_codes

                packed = cs.packed
                codes, extras = encode_request_codes(
                    packed.plan, packed.table, entities, request
                )
                sat = host_sat(packed, codes, extras)
                _d, _diag, expl = build_explanation(
                    packed, sat, entities, request, source=SOURCE_HOST
                )
                return attribution_summary(expl)
            if tiers:
                _d, _diag, expl = interpreter_explanation(
                    tiers, entities, request
                )
                return attribution_summary(expl)
        except Exception:  # noqa: BLE001 — attribution is best-effort
            log.exception("diff attribution failed")
        return None

    def authorization(self, attributes) -> Optional[dict]:
        from ..server.authorizer import record_to_cedar_resource

        try:
            entities, request = record_to_cedar_resource(attributes)
        except Exception:  # noqa: BLE001 — best-effort
            return None
        cand = self.candidate
        cand_engine = getattr(cand, "authz_engine", None)
        cand_tiers = list(getattr(cand, "tiers", ()) or ())
        out = {}
        live = self._summary(
            self.live_authz, self.live_authz_tiers, entities, request
        )
        if live is not None:
            out["live"] = live
        c = self._summary(cand_engine, cand_tiers, entities, request)
        if c is not None:
            out["candidate"] = c
        return out or None

    def admission(self, req) -> Optional[dict]:
        cand = self.candidate
        handler = getattr(cand, "admission_handler", None)
        if handler is None:
            return None
        try:
            entities, cedar_req = handler._build(req)
        except Exception:  # noqa: BLE001 — best-effort
            return None
        cand_engine = getattr(cand, "admission_engine", None)
        cand_tiers = [s.policy_set() for s in handler.stores]
        out = {}
        live = self._summary(
            self.live_admission, self.live_admission_tiers, entities, cedar_req
        )
        if live is not None:
            out["live"] = live
        c = self._summary(cand_engine, cand_tiers, entities, cedar_req)
        if c is not None:
            out["candidate"] = c
        return out or None
