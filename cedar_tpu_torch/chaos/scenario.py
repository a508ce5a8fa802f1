"""Game-day scenario files and the built-in scenario library (a copy of
the JAX package's chaos/scenario.py).

A scenario is a JSON document:

    {
      "name": "kill-decode",
      "seed": 7,
      "description": "decode stage dies mid-traffic",
      "faults": [
        {"seam": "pipeline.decode_q", "kind": "kill", "after": 25, "count": 1}
      ],
      "slo": {"availability": 0.99, "recovery_p99_ratio": 3.0}
    }

``faults`` entries take the InjectionRule fields (after/count/probability/
rate/delay_s/message/replacement). ``slo`` thresholds are for a game-day
runner (none in the port yet); absent fields take the DEFAULT_SLO values.
Scheduling is fully deterministic (seeded PRNG, call indices, token
buckets) so a failing game day replays bit-for-bit. The builtins are the
JAX package's; their descriptions state the port's posture where it
differs (no path re-runs work on the interpreter).
"""

from __future__ import annotations

import json
from typing import Optional

DEFAULT_SLO = {
    # fraction of in-fault requests that must get a clean (no
    # evaluationError) answer
    "availability": 0.99,
    # recovered p99 may be at most this multiple of the pre-fault p99
    # (plus the absolute floor below — µs-scale p99s are all noise)
    "recovery_p99_ratio": 3.0,
    "recovery_p99_floor_ms": 20.0,
}


class ScenarioError(ValueError):
    """A scenario document failed validation."""


def load_scenario(doc) -> dict:
    """Validate a scenario dict (or parse a JSON string) into the shape
    configure()/the runners expect; raises ScenarioError on problems."""
    from .registry import SEAMS, _KINDS

    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except ValueError as e:
            raise ScenarioError(f"scenario is not valid JSON: {e}") from None
    if not isinstance(doc, dict):
        raise ScenarioError("scenario must be a JSON object")
    faults = doc.get("faults")
    if not isinstance(faults, list) or not faults:
        raise ScenarioError('scenario needs a non-empty "faults" list')
    for i, f in enumerate(faults):
        if not isinstance(f, dict):
            raise ScenarioError(f"faults[{i}] must be an object")
        if f.get("seam") not in SEAMS:
            raise ScenarioError(
                f"faults[{i}]: unknown seam {f.get('seam')!r} "
                f"(known: {sorted(SEAMS)})"
            )
        if f.get("kind") not in _KINDS:
            raise ScenarioError(
                f"faults[{i}]: unknown kind {f.get('kind')!r} "
                f"(known: {_KINDS})"
            )
    out = dict(doc)
    out["slo"] = {**DEFAULT_SLO, **(doc.get("slo") or {})}
    return out


def load_scenario_file(path: str) -> dict:
    with open(path) as f:
        return load_scenario(f.read())


# ---------------------------------------------------------------- builtins

# the canonical game days: each is a ready-to-run scenario that
# --chaos-scenario resolves by name.
BUILTIN_SCENARIOS = {
    "kill-decode": {
        "name": "kill-decode",
        "seed": 7,
        "description": "pipeline decode thread dies mid-traffic; the "
        "supervisor must revive the stage and shed its queued batches",
        "faults": [
            {"seam": "pipeline.decode_q", "kind": "kill", "after": 5,
             "count": 1, "message": "decode stage killed (game day)"},
        ],
    },
    "device-loss": {
        "name": "device-loss",
        "seed": 11,
        "description": "device dispatch starts failing fatally; the "
        "breaker must trip, requests must answer the failure posture "
        "(NoOpinion + evaluationError, the admission fail-mode) within "
        "their budget, and the device recovery must rebuild the engine "
        "on the card and re-arm",
        "faults": [
            {"seam": "engine.dispatch", "kind": "error", "after": 3,
             "count": 8,
             "message": "UNAVAILABLE: device lost (game day)"},
        ],
    },
    "poison-crd": {
        "name": "poison-crd",
        "seed": 13,
        "description": "one CRD Policy object turns to garbage; it must "
        "be quarantined and serving must continue on the last-known-good "
        "content with /readyz still 200",
        "faults": [
            {"seam": "store.crd.object", "kind": "corrupt", "count": 3,
             "replacement": "permit (principal galaxy-brain;;; %%"},
        ],
    },
    "store-stall": {
        "name": "store-stall",
        "seed": 17,
        "description": "the policy store stalls on reload; serving must "
        "continue on the previous set with no availability dip",
        "faults": [
            {"seam": "store.load", "kind": "latency", "count": 2,
             "delay_s": 2.0},
        ],
        "slo": {"availability": 0.995},
    },
    "replica-loss": {
        "name": "replica-loss",
        "seed": 19,
        "description": "one fleet replica's batcher worker dies "
        "mid-traffic; the router must route around it with zero decision "
        "flips, and the supervisor must revive it (requires a fleet of "
        ">= 2 replicas — cedar-chaos --spawn starts one)",
        "faults": [
            {"seam": "fleet.replica_dispatch", "kind": "kill", "after": 10,
             "count": 1, "message": "replica killed (game day)"},
        ],
        "slo": {"availability": 0.995},
        # hints for cedar-chaos --spawn: the scenario needs a replicated
        # serving topology (ignored by /chaos/configure)
        "spawn_args": ["--fleet-replicas", "2"],
    },
    "shed-storm": {
        "name": "shed-storm",
        "seed": 23,
        "description": "the admission-control gate starts force-shedding "
        "a slice of admitted-looking traffic (the storm shape without "
        "needing real overload); every shed must answer honestly "
        "(NoOpinion + Retry-After / admission fail-mode), the device "
        "breaker must stay CLOSED throughout, and accounting must stay "
        "exact (offered == admitted + shed)",
        "faults": [
            {"seam": "load.shed", "kind": "corrupt", "after": 5,
             "probability": 0.5, "count": 200},
        ],
        "slo": {"availability": 0.0},  # sheds ARE the scenario: the gates
        # that matter are zero decision flips among served answers and a
        # closed breaker, asserted by the runner/tests directly
        "spawn_args": ["--max-inflight", "64"],
    },
    "lifecycle-breach": {
        "name": "lifecycle-breach",
        "seed": 29,
        "description": "a staged candidate goes bad mid-canary: canary-"
        "slice evaluations start erroring, the lifecycle controller's SLO "
        "burn gate must halt the rollout and roll the candidate back "
        "automatically, and live traffic must see zero decision flips "
        "(the canary slice answers from the live engine on candidate "
        "error, so availability holds)",
        "faults": [
            {"seam": "lifecycle.canary", "kind": "error", "after": 5,
             "probability": 0.8, "count": 200,
             "message": "candidate evaluation failed (game day)"},
        ],
        "slo": {"availability": 0.0},  # canary errors ARE the scenario:
        # the gates that matter — automatic rollback, zero decision flips
        # on live traffic — are asserted by bench --lifecycle / tests
    },
}


def builtin_scenario(name: str) -> Optional[dict]:
    doc = BUILTIN_SCENARIOS.get(name)
    return load_scenario(dict(doc)) if doc is not None else None
