"""Shadow rollout: staged candidate policy sets, live-traffic decision
diffing, and atomic promotion (the JAX package's rollout/).

A policy edit in the live store flips real decisions the moment the store
reloads. The rollout plane ships a change in three steps instead:

  1. **stage**: compile a *candidate* set beside the live one, into its own
     pair of engines on the card (the live engines' device and shard
     layout), warmed off the hot path and gated by the static analyzer
     (analysis/loadgate.py), so a candidate that cannot lower is rejected
     before it shadows anything;
  2. **shadow**: evaluate a sample of live authorize / admit traffic on the
     candidate engines, asynchronously, and gather a decision-diff report
     (allow -> deny, deny -> allow, decision and reason changes, with a
     capped ring of exemplars keyed by the decision cache's canonical
     fingerprints). Shadow work rides a bounded queue, bypasses the
     decision cache and is shed first: it never adds latency to a live
     answer;
  3. **promote / rollback**: promotion swaps the candidate's warmed
     compiled sets into the live engines (engine adopt_compiled: no
     compile, no warm-up) and so changes the plane every pre-promotion
     cache entry was stamped with; rollback hands the prior sets back the
     same way.
"""

from .controller import RolloutController, RolloutError
from .report import (
    DIFF_ALLOW_TO_DENY,
    DIFF_DECISION_CHANGED,
    DIFF_DENY_TO_ALLOW,
    DIFF_REASON_CHANGED,
    DiffReport,
    classify_decision_diff,
)
from .shadow import ShadowEvaluator
from .source import (
    candidate_tiers_from_directory,
    candidate_tiers_from_objects,
    candidate_tiers_from_source,
)

__all__ = [
    "RolloutController",
    "RolloutError",
    "DiffReport",
    "ShadowEvaluator",
    "classify_decision_diff",
    "candidate_tiers_from_directory",
    "candidate_tiers_from_objects",
    "candidate_tiers_from_source",
    "DIFF_ALLOW_TO_DENY",
    "DIFF_DENY_TO_ALLOW",
    "DIFF_DECISION_CHANGED",
    "DIFF_REASON_CHANGED",
]
