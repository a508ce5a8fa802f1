"""Policy store interface and tiered evaluation semantics.

Behavior parity with reference internal/server/store/store.go:
  * PolicyStore = {initial_policy_load_complete, policy_set, name}
  * TieredPolicyStores.is_authorized walks stores first-to-last and stops at
    the first store yielding an explicit signal (any reasons OR any errors);
    the last store's decision applies otherwise (store.go:25-42).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Protocol, Tuple, runtime_checkable

from ..lang.authorize import DENY, Diagnostics, PolicySet
from ..lang.entities import EntityMap
from ..lang.eval import Request

log = logging.getLogger(__name__)


@runtime_checkable
class PolicyStore(Protocol):
    def initial_policy_load_complete(self) -> bool:
        """While False the authorizer emits NoOpinion (admission allows)."""
        ...

    def policy_set(self) -> PolicySet:
        ...

    def name(self) -> str:
        ...


class TieredPolicyStores:
    def __init__(
        self,
        stores: List[PolicyStore],
        validation_mode: Optional[str] = None,
    ):
        self.stores = list(stores)
        # load-time analysis posture (CedarConfig.validationMode); None
        # disables the gate entirely (tests, bare construction)
        self.validation_mode = validation_mode
        # the last AnalysisReport the gate produced (served by the
        # /debug/analysis endpoint); None until the first analyzed load
        self.last_analysis = None
        # cache_generation() proxy state for stores without a
        # content_generation counter: store index -> [last PolicySet,
        # monotonic counter]. The strong reference is the point — it keeps
        # the last-seen set alive so an identity change can never be
        # confused with id() reuse after garbage collection.
        self._gen_lock = threading.Lock()
        self._gen_proxies: dict = {}

    def analyzed_policy_sets(self) -> List[PolicySet]:
        """Tiers for ENGINE COMPILATION after the load-time analysis gate
        (analysis/loadgate.py): strict raises AnalysisRejected (callers
        keep serving their previous compiled set), partial returns tiers
        with the offending policies dropped, permissive returns the tiers
        unchanged but publishes findings/metrics. With no validation mode
        set, this is exactly the raw policy_set() list.

        The gate shapes what the compiler sees; the interpreter walk
        below (is_authorized) always evaluates the stores' raw sets. The
        engines serve decisions from the compiled set, so partial REMOVES
        dropped policies from served decisions — a dropped forbid weakens
        enforcement (docs/analysis.md)."""
        tiers = [s.policy_set() for s in self.stores]
        if not self.validation_mode:
            return tiers
        from ..analysis.loadgate import enforce

        try:
            tiers, report = enforce(tiers, self.validation_mode)
        except Exception as e:
            # strict rejection carries its report for the debug endpoint
            report = getattr(e, "report", None)
            if report is not None:
                self.last_analysis = report
            raise
        self.last_analysis = report
        return tiers

    def cache_generation(self) -> tuple:
        """Composite policy-set generation for decision-cache invalidation
        (cedar_tpu/cache): the tuple of every tier's content generation.
        ANY store reload changes the tuple, so cached decisions computed
        under the old corpus die lazily at their next lookup — no scan.

        Stores without a content_generation counter contribute a proxy
        counter that bumps whenever their policy_set() IDENTITY changes:
        reloaders swap the set object on content change, so identity moves
        with content. The last-seen set is held by strong reference, so the
        ``is`` comparison can never be fooled by id() reuse after garbage
        collection — a swap always invalidates. A store that builds a
        fresh PolicySet per call bumps every lookup, which safely disables
        caching for that tier rather than serving stale entries."""
        parts = []
        for i, store in enumerate(self.stores):
            gen = getattr(store, "content_generation", None)
            if gen is not None:
                parts.append(gen())
                continue
            ps = store.policy_set()
            with self._gen_lock:
                proxy = self._gen_proxies.get(i)
                if proxy is None or proxy[0] is not ps:
                    proxy = [ps, (proxy[1] + 1) if proxy else 0]
                    self._gen_proxies[i] = proxy
                parts.append(proxy[1])
        return tuple(parts)

    def __iter__(self):
        return iter(self.stores)

    def __len__(self):
        return len(self.stores)

    def is_authorized(
        self, entities: EntityMap, req: Request
    ) -> Tuple[str, Diagnostics]:
        decision, diagnostic = DENY, Diagnostics()
        for i, store in enumerate(self.stores):
            try:
                decision, diagnostic = store.policy_set().is_authorized(
                    entities, req
                )
            except Exception as e:  # noqa: BLE001 — one sick tier must not 500
                # a raising store reads as Deny-with-error for its tier: the
                # error is an explicit signal (the walk stops here, matching
                # the evaluator's per-policy error semantics), and the
                # authorizer maps errors-without-reasons to NoOpinion — so a
                # crashing tier degrades to "no opinion, error recorded"
                # instead of crashing the handler
                log.exception("policy store %s evaluation failed", store.name())
                decision, diagnostic = DENY, Diagnostics(
                    errors=[f"store {store.name()}: {e}"]
                )
            if i == len(self.stores) - 1:
                break
            if decision == DENY and not diagnostic.reasons and not diagnostic.errors:
                continue  # no explicit signal in this tier; fall through
            break
        return decision, diagnostic


class MemoryStore:
    """Immutable in-memory store, always or never ready — the test fake and
    the building block for static policy holders (reference memory.go:17)."""

    def __init__(self, name: str, policy_set: PolicySet, load_complete: bool = True):
        self._name = name
        self._policies = policy_set
        self._load_complete = load_complete

    @classmethod
    def from_source(
        cls, filename: str, document: str, load_complete: bool = True
    ) -> "MemoryStore":
        return cls(filename, PolicySet.from_source(document, filename), load_complete)

    def policy_set(self) -> PolicySet:
        return self._policies

    def initial_policy_load_complete(self) -> bool:
        return self._load_complete

    def name(self) -> str:
        return self._name

    def content_generation(self) -> int:
        """Monotonic counter bumped on content change; immutable stores are
        always generation 0. Reloaders key recompilation on this instead of
        re-hashing the policy corpus every tick."""
        return 0


class StaticStore(MemoryStore):
    """A bare PolicySet holder, always ready (reference memory.go:42-54)."""

    def __init__(self, policy_set: PolicySet):
        super().__init__("StaticStore", policy_set, True)
