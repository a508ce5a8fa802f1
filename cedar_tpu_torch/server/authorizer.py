"""The authorization decision engine (SubjectAccessReview path).

Behavior parity with reference internal/server/authorizer/authorizer.go:
  * hard-coded self-allow for the authorizer's own policy/RBAC reads (:38-49)
  * system:* users skipped (NoOpinion) except service accounts and nodes (:51-57)
  * NoOpinion until every store reports initial load complete (:58-66)
  * tiered evaluation and Allow/Deny/NoOpinion mapping (:73-84)

The engine is backend-pluggable: the default path evaluates through the
tiered stores' interpreter PolicySets; the PyTorch engine
(engine/evaluator.py TorchPolicyEngine) plugs in as a drop-in `evaluate` /
`evaluate_batch` callable with identical semantics.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple

from ..entities.attributes import Attributes
from ..entities.builders import (
    action_entities,
    impersonated_resource_to_cedar_entity,
    non_resource_to_cedar_entity,
    resource_to_cedar_entity,
)
from ..entities.user import user_to_cedar_entity
from ..lang.authorize import ALLOW, DENY, Diagnostics
from ..lang.entities import EntityMap
from ..lang.eval import Request
from ..lang.values import CedarRecord
from ..schema import consts
from ..stores.store import TieredPolicyStores

log = logging.getLogger(__name__)

# Decisions mirror k8s.io/apiserver authorizer.Decision
DECISION_ALLOW = "allow"
DECISION_DENY = "deny"
DECISION_NO_OPINION = "no_opinion"

# The authorizer's own identity (reference options.go:14-15)
CEDAR_AUTHORIZER_IDENTITY_NAME = "system:authorizer:cedar-authorizer"

# Evaluate callable signature: (entities, request) -> (cedar decision, diagnostics)
EvaluateFn = Callable[[EntityMap, Request], Tuple[str, Diagnostics]]


def record_to_cedar_resource(attributes: Attributes) -> Tuple[EntityMap, Request]:
    """Attributes -> (entity map, Cedar request). Parity with
    RecordToCedarResource (reference authorizer.go:89-111)."""
    action_uid, req_entities = action_entities(attributes.verb)
    principal_uid, principal_entities = user_to_cedar_entity(attributes.user)
    req_entities = req_entities.merged_with(principal_entities)

    if attributes.resource_request:
        if attributes.verb == consts.AUTHORIZATION_ACTION_IMPERSONATE:
            entity = impersonated_resource_to_cedar_entity(attributes)
        else:
            entity = resource_to_cedar_entity(attributes)
    else:
        entity = non_resource_to_cedar_entity(attributes)
    req_entities.add(entity)

    ctx = CedarRecord()
    if getattr(attributes, "tenant", ""):
        # fused multi-tenant plane: the context carries
        # the tenant id the discriminator literals test — on the Python
        # engine path via encode_request_codes, on the interpreter paths
        # via the clones' guard conditions
        from ..compiler.pack import TENANT_CONTEXT_KEY

        ctx = CedarRecord({TENANT_CONTEXT_KEY: attributes.tenant})
    req = Request(principal_uid, action_uid, entity.uid, ctx)
    return req_entities, req


class CedarWebhookAuthorizer:
    def __init__(
        self,
        stores: TieredPolicyStores,
        evaluate: Optional[EvaluateFn] = None,
        evaluate_batch=None,
        cache=None,
    ):
        self.stores = stores
        self._stores_loaded = False
        # optional decision cache (cache/decision_cache.py DecisionCache)
        # consulted by authorize() AFTER the short-circuits and the
        # readiness gate, as in the JAX package: with attributes already
        # parsed, the self-allows and system:* skips are cheaper than a
        # fingerprint. The webhook server keys its own cache on the raw
        # body and calls authorize() with use_cache=False when it has one;
        # this seam serves direct embedders
        self.cache = cache
        # optional batched backend ([(entities, request)] -> [(decision,
        # diagnostics)]): authorize_batch funnels every non-short-circuited
        # item through ONE call (one device dispatch on the engine)
        self._evaluate_batch = evaluate_batch
        # pluggable per-item backend. Without one it is the batched backend
        # when that is wired (never the interpreter behind an engine's
        # back), else the tiered interpreter
        if evaluate is None and evaluate_batch is not None:
            evaluate = lambda em, req: evaluate_batch([(em, req)])[0]  # noqa: E731
        self._evaluate: EvaluateFn = evaluate or stores.is_authorized

    def ready(self) -> bool:
        """True once every store reports initial load complete; latches
        (reference authorizer.go:58-66 — the latch is benignly racy there
        too)."""
        if self._stores_loaded:
            return True
        for store in self.stores:
            if not store.initial_policy_load_complete():
                log.info(
                    "Policies not yet loaded, returning no opinion: store=%s",
                    store.name(),
                )
                return False
        self._stores_loaded = True
        return True

    def _short_circuit(self, attributes: Attributes) -> Optional[Tuple[str, str]]:
        """The pre-evaluation gates shared by authorize() and
        authorize_batch(): identity self-allows, system:* skips, and the
        store-readiness NoOpinion. None means the request must evaluate."""
        labeled = self._short_circuit_labeled(attributes)
        return None if labeled is None else labeled[:2]

    def _short_circuit_labeled(
        self, attributes: Attributes
    ) -> Optional[Tuple[str, str, str]]:
        """(decision, reason, gate label) — the same gates with a stable
        label naming WHICH gate fired, classified at the gate itself so
        the explain surface (cedar_tpu/explain) can never mislabel a
        short-circuit it only saw the result of."""
        user_name = attributes.user.name
        if (
            user_name == CEDAR_AUTHORIZER_IDENTITY_NAME
            and attributes.is_read_only()
            and attributes.api_group == "cedar.k8s.aws"
            and attributes.resource == "policies"
        ):
            return (
                DECISION_ALLOW,
                "cedar authorizer is always allowed to access policies",
                "authorizer-self-allow",
            )
        if (
            user_name == CEDAR_AUTHORIZER_IDENTITY_NAME
            and attributes.is_read_only()
            and attributes.api_group == "rbac.authorization.k8s.io"
        ):
            return (
                DECISION_ALLOW,
                "cedar authorizer is always allowed to read RBAC policies",
                "authorizer-self-allow",
            )

        # Skip system users (internal identities) except SAs and nodes
        if (
            user_name.startswith("system:")
            and not user_name.startswith("system:serviceaccount:")
            and not user_name.startswith("system:node:")
        ):
            return DECISION_NO_OPINION, "", "system-user-skip"

        if not self.ready():
            return DECISION_NO_OPINION, "", "stores-not-ready"
        return None

    @staticmethod
    def _map_verdict(decision: str, diagnostic: Diagnostics) -> Tuple[str, str]:
        """Cedar verdict -> (webhook decision, reason) — the mapping at
        reference authorizer.go:73-84."""
        if decision == ALLOW:
            return DECISION_ALLOW, _diagnostic_to_reason(diagnostic)
        if decision == DENY and diagnostic.reasons:
            return DECISION_DENY, _diagnostic_to_reason(diagnostic)
        if diagnostic.errors:
            log.error("Authorize errors: %s", diagnostic.errors)
        return DECISION_NO_OPINION, ""

    def authorize_batch(self, attributes_list) -> list:
        """Batched authorize with per-item semantics identical to
        authorize(): same gates, readiness check, and verdict mapping. The
        non-short-circuited items evaluate through ONE evaluate_batch call
        when a batched backend is wired (one device dispatch), per item
        otherwise. An item whose entities cannot be built answers
        NoOpinion; an evaluation failure (a failed kernel launch among
        them) raises to the caller, with no re-answer on another path."""
        results: list = [None] * len(attributes_list)
        build = []  # (index, entities, cedar request)
        for i, attributes in enumerate(attributes_list):
            short = self._short_circuit(attributes)
            if short is not None:
                results[i] = short
                continue
            try:
                entities, request = record_to_cedar_resource(attributes)
            except Exception:  # noqa: BLE001 — one bad item must not kill the batch
                log.exception("authorize_batch entity build failed")
                results[i] = (DECISION_NO_OPINION, "")
                continue
            build.append((i, entities, request))
        if build:
            pairs = [(em, req) for _, em, req in build]
            if self._evaluate_batch is not None:
                verdicts = self._evaluate_batch(pairs)
                if len(verdicts) != len(build):
                    # zip would silently truncate and leave None rows
                    raise RuntimeError(
                        f"evaluate_batch returned {len(verdicts)} results "
                        f"for {len(build)} items"
                    )
            else:
                verdicts = [self._evaluate(em, req) for em, req in pairs]
            for (i, _, _), (decision, diag) in zip(build, verdicts):
                results[i] = self._map_verdict(decision, diag)
        return results

    def authorize(self, attributes: Attributes, use_cache: bool = True) -> Tuple[str, str]:
        """Returns (decision, reason). ``use_cache=False`` bypasses the
        authorizer's decision cache for callers that already looked up
        the same canonical key (the webhook server). An errored
        evaluation is never cached; a raising cache is a miss."""
        short = self._short_circuit(attributes)
        if short is not None:
            return short

        cache_key = None
        cache_gen = None
        if use_cache and self.cache is not None:
            from ..cache.fingerprint import fingerprint_attributes

            cache_key = fingerprint_attributes(attributes)
            try:
                # snapshot before evaluating: a reload landing meanwhile
                # must not let this result survive under its generation
                cache_gen = self.cache.current_generation()
                hit = self.cache.get(cache_key)
            except Exception:  # noqa: BLE001 — a sick cache is a miss
                log.exception("authorizer cache lookup failed; evaluating")
                cache_key = None
                hit = None
            if hit is not None:
                return hit

        entities, request = record_to_cedar_resource(attributes)
        decision, diagnostic = self._evaluate(entities, request)
        result = self._map_verdict(decision, diagnostic)
        if cache_key is not None and not diagnostic.errors:
            try:
                self.cache.put(cache_key, result, result[0], generation=cache_gen)
            except Exception:  # noqa: BLE001 — the answer still serves
                log.exception("authorizer cache insert failed")
        return result


def _diagnostic_to_reason(diagnostic: Diagnostics) -> str:
    if not diagnostic.reasons:
        return ""
    return diagnostic.to_json()
