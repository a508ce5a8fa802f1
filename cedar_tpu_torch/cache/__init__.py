"""Decision cache and request coalescing ahead of both engines.

A canonical request fingerprinter (fingerprint.py) keys a sharded LRU+TTL
decision cache (decision_cache.py) with generation-based invalidation
over the serving plane's shard lineage (generation.py), and a
singleflight coalescer (singleflight.py) collapses concurrent identical
misses into one evaluation. The same modules, names and keys as the JAX
package's cache/.
"""

from .decision_cache import (
    CLASS_ALLOW,
    CLASS_DENY,
    CLASS_NO_OPINION,
    DecisionCache,
    classify_decision,
)
from .fingerprint import (
    FINGERPRINT_VERSION,
    FingerprintMemo,
    fingerprint_admission_request,
    fingerprint_attributes,
    fingerprint_body,
    recorded_name_parts,
)
from .generation import (
    PlaneGenerations,
    ShardScopedStamp,
    plane_composite,
)
from .singleflight import SingleFlight

__all__ = [
    "PlaneGenerations",
    "ShardScopedStamp",
    "plane_composite",
    "CLASS_ALLOW",
    "CLASS_DENY",
    "CLASS_NO_OPINION",
    "DecisionCache",
    "classify_decision",
    "FINGERPRINT_VERSION",
    "FingerprintMemo",
    "fingerprint_admission_request",
    "fingerprint_attributes",
    "fingerprint_body",
    "recorded_name_parts",
    "SingleFlight",
]
