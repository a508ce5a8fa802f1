"""Overload-control plane of the port (a copy of the JAX package's load/).

The layer between the HTTP front end and the batchers that keeps the
server honest when offered load exceeds what the card serves:

  * ``admission``: priority-aware ingress gating with graduated load
    states and per-client fair-share quotas; sheds answer honestly and
    ``offered == admitted + shed`` is exact by construction;
  * ``tuner``: SLO-adaptive batching, a control loop that grows a
    batcher's ``max_batch`` for throughput while the latency objective
    has headroom and shrinks its linger the moment it starts burning;
  * ``arrivals``: seeded open-loop arrival schedules (Poisson, burst,
    flash crowd) for storm clients and their tests.
"""

from .admission import (
    PRIORITIES,
    PRIORITY_HIGH,
    PRIORITY_NORMAL,
    PRIORITY_SHEDDABLE,
    STATE_CODES,
    STATE_OK,
    STATE_OVERLOAD,
    STATE_PRESSURE,
    STATE_SATURATED,
    AdmissionController,
    RequestShed,
    Shed,
    classify,
)
from .arrivals import (
    burst_schedule,
    flash_crowd_schedule,
    poisson_schedule,
)
from .tuner import AdaptiveBatchTuner, TuningBounds

__all__ = [
    "AdaptiveBatchTuner",
    "AdmissionController",
    "PRIORITIES",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_SHEDDABLE",
    "RequestShed",
    "STATE_CODES",
    "STATE_OK",
    "STATE_OVERLOAD",
    "STATE_PRESSURE",
    "STATE_SATURATED",
    "Shed",
    "TuningBounds",
    "burst_schedule",
    "classify",
    "flash_crowd_schedule",
    "poisson_schedule",
]
