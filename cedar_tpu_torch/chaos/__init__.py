"""cedar_tpu_torch.chaos — fault injection + game-day scenarios.

The registry (registry.py) holds the named seams threaded through the
serving layers; scenario.py holds the scenario file format and the
built-in game days. The webhook arms a scenario at start
(``--chaos-scenario``) or over ``POST /chaos/{configure,arm,disarm,reset}``
on its metrics listener, both gated by ``--confirm-non-prod-inject-errors``.
"""

from .registry import (
    SEAMS,
    ChaosError,
    ChaosRegistry,
    InjectionRule,
    Seam,
    ThreadKilled,
    TokenBucket,
    chaos_fire,
    default_registry,
)
from .scenario import (
    BUILTIN_SCENARIOS,
    DEFAULT_SLO,
    ScenarioError,
    builtin_scenario,
    load_scenario,
    load_scenario_file,
)

__all__ = [
    "SEAMS",
    "ChaosError",
    "ChaosRegistry",
    "InjectionRule",
    "Seam",
    "ThreadKilled",
    "TokenBucket",
    "chaos_fire",
    "default_registry",
    "BUILTIN_SCENARIOS",
    "DEFAULT_SLO",
    "ScenarioError",
    "builtin_scenario",
    "load_scenario",
    "load_scenario_file",
]
