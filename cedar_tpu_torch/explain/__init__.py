"""Decision explainability plane (the JAX package's explain/).

``?explain=1`` on /v1/authorize and /v1/admit answers through this
package: the compiled clause IR's per-rule back-map (``compiler.pack
PackedPolicySet.rule_clause``) turns the satisfied rules into the
determining policy, its clause, and the matched attribute tests with
source spans. Strictly pay-for-use: importing the serving stack never
imports this package (the server imports it at the first explain
request), and nothing here touches the device until then.
"""

from .attribution import (
    SOURCE_DEVICE,
    SOURCE_GATE,
    SOURCE_HOST,
    SOURCE_INTERPRETER,
    attribution_summary,
    build_explanation,
    clause_tests,
    host_sat,
    interpreter_explanation,
    literal_test,
    sat_from_bits,
)
from .explainer import DiffAttributor, Explainer, engine_of
from .plane import ExplainPlane

__all__ = [
    "SOURCE_DEVICE",
    "SOURCE_GATE",
    "SOURCE_HOST",
    "SOURCE_INTERPRETER",
    "DiffAttributor",
    "ExplainPlane",
    "Explainer",
    "attribution_summary",
    "build_explanation",
    "clause_tests",
    "engine_of",
    "host_sat",
    "interpreter_explanation",
    "literal_test",
    "sat_from_bits",
]
