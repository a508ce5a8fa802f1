"""cedar_tpu_torch.lifecycle — the declarative policy-lifecycle controller
(the JAX package's lifecycle/ over the port's rollout controller).

author → verify → [analyze] → shadow → canary → promote as a
self-driving, self-healing control loop: a per-tenant ``PolicyRollout``
spec (spec.py) names a candidate source, ordered evidence gates, and a
promotion policy; the controller (controller.py) drives the port's
rollout / analysis / SLO primitives through a driver binding (driver.py),
journals every transition (journal.py) for crash resume, and halts +
rolls back automatically on any gate breach. The webhook CLI wires it
with ``--lifecycle-spec-dir``; ``chip_smoke.py`` phase 19 drives it on
the card.
"""

from .controller import (
    STAGE_ANALYZING,
    STAGE_CANARY,
    STAGE_CODES,
    STAGE_FAILED,
    STAGE_HALTED,
    STAGE_PENDING,
    STAGE_PROMOTED,
    STAGE_PROMOTING,
    STAGE_ROLLED_BACK,
    STAGE_SHADOWING,
    STAGE_VERIFYING,
    LifecycleController,
    LifecycleError,
)
from .driver import DriverError, GateBreach, RolloutLifecycleDriver
from .journal import TERMINAL_STAGES, LifecycleJournal
from .spec import (
    PROMOTION_AUTO,
    PROMOTION_MANUAL,
    PolicyRolloutSpec,
    SpecError,
    load_spec_file,
    load_specs_dir,
    spec_from_dict,
)

__all__ = [
    "LifecycleController",
    "LifecycleError",
    "LifecycleJournal",
    "RolloutLifecycleDriver",
    "DriverError",
    "GateBreach",
    "PolicyRolloutSpec",
    "SpecError",
    "spec_from_dict",
    "load_spec_file",
    "load_specs_dir",
    "PROMOTION_AUTO",
    "PROMOTION_MANUAL",
    "TERMINAL_STAGES",
    "STAGE_CODES",
    "STAGE_PENDING",
    "STAGE_VERIFYING",
    "STAGE_ANALYZING",
    "STAGE_SHADOWING",
    "STAGE_CANARY",
    "STAGE_PROMOTING",
    "STAGE_PROMOTED",
    "STAGE_HALTED",
    "STAGE_ROLLED_BACK",
    "STAGE_FAILED",
]
