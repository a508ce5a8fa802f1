"""Validating admission handler over the tiered policy stores.

The port's counterpart of the JAX package's server/admission.py. Behavior
parity with the upstream project's internal/server/admission/handler.go
and admit_all_policy.go:
  * requests in ``kube-system`` / ``cedar-k8s-authz-system`` are allowed
    without evaluation (:45)
  * every request is allowed until all stores report their initial policy
    load complete (:49-57)
  * DELETE evaluates the oldObject as the resource entity (:95-99)
  * UPDATE (and any request carrying an oldObject) re-IDs the old entity by
    the review UID, links it from the new object's ``oldObject`` attribute,
    and exposes its attributes as ``context.oldObject`` (:107-123, :135-139)
  * conversion errors yield an HTTP 500 errored response whose ``allowed``
    carries the allow-on-error posture (allowOnError wired true at
    cmd/cedar-webhook/main.go:116). As in the JAX package, the flag sets
    the errored response's ``allowed`` directly (the reference returns
    admission.Errored and leaves the posture to the apiserver's
    failurePolicy), so the posture holds under a strict failurePolicy too
  * the decision is Deny iff evaluation returns Deny; the final tier is the
    programmatic allow-all admission policy, so an unmatched request is
    allowed (:157-166)

Evaluation backend: with ``evaluate_batch`` wired (the engine), every
evaluation goes through it, per item too; the interpreter
(``stores.is_authorized``) is the backend only when nothing else is wired.
A failed batched evaluation is never re-run on another path: every member
it carried answers the allow-on-error response with the error, or, with
``raise_errors``, the failure propagates to the caller (the fast path and
the server's batcher, which answer the server's fail-mode).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass
from typing import Optional

from ..entities.admission import (
    AdmissionRequest,
    admission_action_entities,
    admission_action_uid,
    principal_entities_from_admission_request,
    resource_entity_from_admission_request,
)
from ..lang.authorize import DENY, PolicySet
from ..lang.entities import Entity
from ..lang.eval import Request
from ..lang.values import CedarRecord, EntityUID
from ..schema import consts
from ..stores.store import StaticStore, TieredPolicyStores

log = logging.getLogger(__name__)

SKIPPED_NAMESPACES = ("kube-system", "cedar-k8s-authz-system")

ALLOW_ALL_ADMISSION_POLICY_SOURCE = (
    "permit (\n"
    "    principal,\n"
    "    action in [\n"
    f'        {consts.ADMISSION_ACTION_ENTITY_TYPE}::"{consts.ADMISSION_ACTION_CREATE}",\n'
    f'        {consts.ADMISSION_ACTION_ENTITY_TYPE}::"{consts.ADMISSION_ACTION_UPDATE}",\n'
    f'        {consts.ADMISSION_ACTION_ENTITY_TYPE}::"{consts.ADMISSION_ACTION_DELETE}",\n'
    f'        {consts.ADMISSION_ACTION_ENTITY_TYPE}::"{consts.ADMISSION_ACTION_CONNECT}"\n'
    "    ],\n"
    "    resource\n"
    ");"
)


def allow_all_admission_policy_store() -> StaticStore:
    """The default-allow final tier (reference admit_all_policy.go:10-19,
    appended at cmd/cedar-webhook/main.go:111-116)."""
    return StaticStore(
        PolicySet.from_source(ALLOW_ALL_ADMISSION_POLICY_SOURCE, "allow-all-admission")
    )


def cacheable_admission_request(req: AdmissionRequest) -> bool:
    """The read-only-idempotent gate of the opt-in admission decision
    cache: only reviews with no write effect may be answered from cache,
    CONNECT checks (exec/attach/port-forward connection gating, re-issued
    per session) and dry-run reviews (evaluation-identical to the real
    write by definition). Mutating CREATE/UPDATE/DELETE reviews always
    evaluate: their repeat rate is low and a stale answer on a write is
    the wrong trade even bounded by a TTL."""
    return req.operation == "CONNECT" or req.dry_run


@dataclass
class AdmissionResponse:
    uid: str
    allowed: bool
    message: str = ""
    code: int = 200
    error: Optional[str] = None

    def to_admission_review(self) -> dict:
        """Render as an admission.k8s.io/v1 AdmissionReview response body."""
        if self.error is not None:
            status = {"code": 500, "message": self.error}
        else:
            status = {"code": self.code, "message": self.message}
        return {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": {
                "uid": self.uid,
                "allowed": self.allowed,
                "status": status,
            },
        }


class CedarAdmissionHandler:
    def __init__(
        self,
        stores: TieredPolicyStores,
        allow_on_error: bool = True,
        evaluate=None,
        evaluate_batch=None,
        cache=None,
    ):
        self.stores = stores
        self.allow_on_error = allow_on_error
        self._all_stores_ready = False
        # opt-in decision cache (cache/decision_cache.py DecisionCache),
        # consulted only for requests passing cacheable_admission_request
        # (admission traffic is write-shaped and rarely repeats); as in the
        # JAX package, only this handler reads it, not the native
        # admission fast path
        self.cache = cache
        # optional batched backend: [(entities, request)] -> [(decision,
        # diagnostics)], one device call per batch; when wired, every
        # evaluation goes through it (never the interpreter behind an
        # engine's back)
        self._evaluate_batch = evaluate_batch
        # per-item backend when no batched one is wired: the given one,
        # else the tiered interpreter
        self._evaluate = evaluate or stores.is_authorized

    @property
    def supports_batch(self) -> bool:
        """True when a batched evaluation backend is wired; the server keys
        admission micro-batching on this."""
        return self._evaluate_batch is not None

    def _ready(self) -> bool:
        if self._all_stores_ready:
            return True
        for i, store in enumerate(self.stores):
            if not store.initial_policy_load_complete():
                log.info(
                    "policy store [%d] (%s) not ready, emitting allow response",
                    i,
                    store.name(),
                )
                return False
        self._all_stores_ready = True
        return True

    def handle(self, req: AdmissionRequest, raise_errors: bool = False) -> AdmissionResponse:
        return self.handle_batch([req], raise_errors=raise_errors)[0]

    def handle_batch(self, reqs, raise_errors: bool = False) -> list:
        """Evaluate a batch of AdmissionRequests, in one backend call when a
        batched backend is wired; per-request semantics are handle()'s.

        A request whose entities cannot be built answers the allow-on-error
        response. An evaluation failure (a raising backend, or a batch
        backend returning the wrong number of verdicts) answers every
        request it carried the allow-on-error response with the error; with
        ``raise_errors`` it raises instead. Nothing is re-run."""
        responses: list = [None] * len(reqs)
        ready = self._ready() if reqs else True
        build: list = []  # (index, entities, cedar_request)
        cache_keys: dict = {}  # index -> (fingerprint, generation snapshot, action)
        for i, req in enumerate(reqs):
            if req.namespace in SKIPPED_NAMESPACES or not ready:
                responses[i] = AdmissionResponse(uid=req.uid, allowed=True)
                continue
            if self.cache is not None and cacheable_admission_request(req):
                keyed, hit = self._cache_lookup(req)
                if hit is not None:
                    # cached values carry no uid (the fingerprint leaves
                    # the per-review nonce out): rebuilt around this one
                    responses[i] = AdmissionResponse(uid=req.uid, allowed=hit[0], message=hit[1])
                    continue
                if keyed is not None:
                    cache_keys[i] = keyed
            try:
                entities, cedar_req = self._build(req)
            except Exception as e:  # conversion error
                log.error("error during review: %s", e)
                responses[i] = self._error(req, e)
                continue
            build.append((i, entities, cedar_req))
        if not build:
            return responses
        if self._evaluate_batch is None:
            for i, em, cr in build:
                try:
                    decision, diagnostics = self._evaluate(em, cr)
                except Exception as e:  # evaluation plumbing error
                    if raise_errors:
                        raise
                    log.error("error during review: %s", e)
                    responses[i] = self._error(reqs[i], e)
                    continue
                responses[i] = self._decide(reqs[i], decision, diagnostics)
                self._cache_put(cache_keys.get(i), responses[i], diagnostics,
                                tenant=getattr(reqs[i], "tenant", ""))
            return responses
        try:
            verdicts = self._evaluate_batch([(em, cr) for _, em, cr in build])
            if len(verdicts) != len(build):
                raise RuntimeError(
                    f"evaluate_batch returned {len(verdicts)} results for {len(build)} items"
                )
        except Exception as e:
            if raise_errors:
                raise
            log.error("error during review: %s", e)
            for i, _, _ in build:
                responses[i] = self._error(reqs[i], e)
            return responses
        for (i, _, _), (decision, diagnostics) in zip(build, verdicts):
            responses[i] = self._decide(reqs[i], decision, diagnostics)
            self._cache_put(cache_keys.get(i), responses[i], diagnostics,
                            tenant=getattr(reqs[i], "tenant", ""))
        return responses

    def _cache_lookup(self, req: AdmissionRequest):
        """((fingerprint, generation snapshot, action uid) or None, cached
        value or None) of a cacheable request. The generation is taken BEFORE the
        evaluation (DecisionCache.current_generation); a raising cache is
        a miss that is not inserted afterwards."""
        from ..cache.fingerprint import fingerprint_admission_request

        key = fingerprint_admission_request(req)
        try:
            gen = self.cache.current_generation()
            hit = self.cache.get(key)
        except Exception:  # noqa: BLE001 — a sick cache is a miss
            log.exception("admission cache lookup failed; evaluating")
            return None, None
        return (key, gen, repr(admission_action_uid(req))), hit

    def _cache_put(self, keyed, response: AdmissionResponse, diagnostics,
                   tenant: str = "") -> None:
        """Insert a clean decision of a cacheable request. Errored
        responses (the allow-on-error posture) and verdicts carrying
        evaluation-error diagnostics are transient: caching either would
        pin a transient failure for its TTL."""
        if keyed is None or self.cache is None or response.error is not None:
            return
        if diagnostics is not None and diagnostics.errors:
            return
        key, generation, action = keyed
        try:
            # shard-scoped stamp when the message names the determining
            # policies (cache/generation.py): an incremental reload then
            # kills the entries whose shard changed or that a policy it
            # added can apply to
            scoped = getattr(generation, "scoped", None)
            if scoped is not None and response.message:
                generation = scoped(response.message, tenant=tenant, action=action)
            self.cache.put(
                key,
                (response.allowed, response.message),
                "allow" if response.allowed else "deny",
                generation=generation,
            )
        except Exception:  # noqa: BLE001 — a sick cache only costs re-evaluation
            log.exception("admission cache insert failed; decision served")

    def _error(self, req: AdmissionRequest, e: Exception) -> AdmissionResponse:
        return AdmissionResponse(
            uid=req.uid, allowed=self.allow_on_error, code=500, error=str(e)
        )

    def _decide(self, req, decision, diagnostics) -> AdmissionResponse:
        if decision == DENY:
            if not diagnostics.reasons and not diagnostics.errors:
                log.error(
                    "request denied without reasons; the default permit "
                    "policy was not evaluated"
                )
            message = ""
            if diagnostics.reasons:
                message = json.dumps(
                    [r.to_dict() for r in diagnostics.reasons],
                    separators=(",", ":"),
                )
            return AdmissionResponse(uid=req.uid, allowed=False, message=message)
        return AdmissionResponse(uid=req.uid, allowed=True)

    def _build(self, req: AdmissionRequest):
        principal_uid, request_entities = principal_entities_from_admission_request(
            req
        )

        if req.operation == "DELETE":
            resource_entity = resource_entity_from_admission_request(req, old=True)
        else:
            resource_entity = resource_entity_from_admission_request(req)

        old_entity: Optional[Entity] = None
        if req.old_object is not None and req.operation != "DELETE":
            old = resource_entity_from_admission_request(req, old=True)
            # Old and new objects share the same path-derived UID; re-ID the
            # old one by the (unique) review UID and link it from the new
            # object's oldObject attribute (reference handler.go:107-123).
            old_entity = Entity(
                EntityUID(old.uid.type, req.uid), old.attrs, old.parents
            )
            new_attrs = dict(resource_entity.attrs.attrs)
            new_attrs["oldObject"] = old_entity.uid
            resource_entity = Entity(
                resource_entity.uid, CedarRecord(new_attrs), resource_entity.parents
            )
            request_entities.add(old_entity)

        request_entities.add(resource_entity)
        action_uid = admission_action_uid(req)
        request_entities = request_entities.merged_with(admission_action_entities())

        context = {}
        if old_entity is not None:
            context["oldObject"] = old_entity.attrs
        if getattr(req, "tenant", ""):
            # fused multi-tenant plane (tenancy/): the context carries the
            # tenant id the discriminator literals test
            from ..compiler.pack import TENANT_CONTEXT_KEY

            context[TENANT_CONTEXT_KEY] = req.tenant

        cedar_req = Request(
            principal_uid, action_uid, resource_entity.uid, CedarRecord(context)
        )
        return request_entities, cedar_req
