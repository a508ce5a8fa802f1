"""PolicyRollout specs: the declarative input to the lifecycle controller
(a copy of the JAX package's lifecycle/spec.py: the same manifests, the
same validation, the same errors).

A spec names ONE tenant's candidate source, the ordered evidence gates
(lowerability floor → shadow diff budget → canary SLO burn), and the
promotion policy. It is deliberately a plain dataclass + JSON manifest
loader rather than a CRD client: the same document shape works as a
config-dir manifest today and as a CRD ``spec`` block when an apiserver
watch is wired (apis/v1alpha1.py holds the serving CRD conventions this
follows).

Manifest shape:

    {
      "kind": "PolicyRollout",
      "metadata": {"name": "tenant-a"},
      "spec": {
        "candidate": {"directory": "/etc/cedar/candidate"},
        "gates": {
          "lowerability_floor_pct": 95.0,
          "analyze": {"flip_budget": 0, "allowed_intents": []},
          "shadow": {"min_samples": 200, "diff_budget": 0},
          "canary": {"min_decisions": 50, "max_flips": 0},
          "slo": {"burn_ceiling": 2.0, "window_s": 300}
        },
        "promotion": {"mode": "auto", "canary_ladder": [10, 50, 100]},
        "stage_deadline_s": 300,
        "max_retries": 3
      }
    }

``candidate`` takes exactly one of ``directory`` / ``source`` (inline
policy text) / ``crd: true`` — the RolloutController staging sources —
or, programmatically only, ``tiers`` (a list of PolicySet, opaque to the
journal). An empty ``canary_ladder`` skips the canary stage entirely
(shadow evidence promotes directly) — the posture for webhook-server
deployments where no in-process canary router sits on the live path.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Tuple

# same DNS-label-ish shape the tenancy registry enforces (tenant ids
# become metric label values and journal keys)
_TENANT_RE = re.compile(r"^[a-z0-9]([a-z0-9._-]{0,62}[a-z0-9])?$", re.I)

_SOURCE_KEYS = ("directory", "source", "crd", "tiers")

PROMOTION_AUTO = "auto"
PROMOTION_MANUAL = "manual"


class SpecError(ValueError):
    """A PolicyRollout document failed validation."""


@dataclass(frozen=True)
class PolicyRolloutSpec:
    """One tenant's declarative rollout: candidate + gates + promotion."""

    tenant: str
    candidate: dict
    # gate tier 1: verify — blocking findings always halt; additionally
    # the fully-lowerable coverage percent must meet the floor
    lowerability_floor_pct: float = 0.0
    # gate tier 1.5 (opt-in via gates.analyze in the manifest): the
    # device-exact semantic diff between the live and candidate sets
    # (analysis/semdiff.py). Decision flips outside the allowed-intent
    # selectors beyond the flip budget breach BEFORE any live traffic
    # sees the candidate; an oracle disagreement always breaches.
    analyze_enabled: bool = False
    analyze_flip_budget: int = 0
    # each selector is a dict of optional keys: kind
    # ("allow_to_deny"/"deny_to_allow") matched exactly; principal/
    # action/resource globs matched against the exemplar's Type::id
    analyze_allowed_intents: Tuple[dict, ...] = ()
    analyze_universe_budget: int = 2048
    analyze_oracle_sample: int = 32
    # gate tier 2: shadow — evidence window and diff budget
    shadow_min_samples: int = 100
    shadow_diff_budget: int = 0
    # gate tier 3: canary — per-rung decision quorum, flip tolerance, and
    # the SLO availability-burn ceiling over the trailing window
    canary_min_decisions: int = 50
    canary_max_flips: int = 0
    slo_burn_ceiling: float = 2.0
    slo_burn_window_s: float = 300.0
    # promotion policy
    promotion: str = PROMOTION_AUTO
    canary_ladder: Tuple[int, ...] = (10, 50, 100)
    # per-stage resilience budget
    stage_deadline_s: float = 300.0
    max_retries: int = 3

    def __post_init__(self):
        if not _TENANT_RE.match(self.tenant or ""):
            raise SpecError(f"invalid tenant id {self.tenant!r}")
        keys = [k for k in _SOURCE_KEYS if self.candidate.get(k)]
        if len(keys) != 1:
            raise SpecError(
                "candidate must name exactly one of "
                f"{_SOURCE_KEYS} (got {sorted(self.candidate)})"
            )
        if self.promotion not in (PROMOTION_AUTO, PROMOTION_MANUAL):
            raise SpecError(
                f"promotion must be {PROMOTION_AUTO!r} or "
                f"{PROMOTION_MANUAL!r}, not {self.promotion!r}"
            )
        ladder = tuple(self.canary_ladder)
        if any(not (0 < p <= 100) for p in ladder):
            raise SpecError(f"canary_ladder percents must be in (0, 100]: {ladder}")
        if list(ladder) != sorted(ladder):
            raise SpecError(f"canary_ladder must ascend: {ladder}")
        object.__setattr__(self, "canary_ladder", ladder)
        for name in ("shadow_min_samples", "canary_min_decisions",
                     "max_retries", "analyze_flip_budget"):
            if getattr(self, name) < 0:
                raise SpecError(f"{name} must be >= 0")
        if self.analyze_universe_budget <= 0 or self.analyze_oracle_sample < 0:
            raise SpecError(
                "analyze universe_budget must be > 0 and oracle_sample >= 0"
            )
        intents = tuple(dict(s) for s in self.analyze_allowed_intents)
        for s in intents:
            bad = set(s) - {"kind", "principal", "action", "resource"}
            if bad:
                raise SpecError(
                    f"unknown allowed-intent selector keys: {sorted(bad)}"
                )
        object.__setattr__(self, "analyze_allowed_intents", intents)
        if self.stage_deadline_s <= 0:
            raise SpecError("stage_deadline_s must be > 0")

    def stage_kwargs(self) -> dict:
        """The RolloutController.stage(...) source kwargs."""
        c = self.candidate
        if c.get("tiers"):
            return {"tiers": c["tiers"]}
        if c.get("directory"):
            return {"directory": c["directory"]}
        if c.get("source"):
            return {"source": c["source"]}
        return {"crd": True}

    def to_dict(self) -> dict:
        """Manifest-shaped dict (journal + /debug/lifecycle). An opaque
        ``tiers`` candidate serializes as a marker — resume() needs the
        caller to re-supply such specs."""
        cand = dict(self.candidate)
        if cand.get("tiers"):
            cand["tiers"] = f"<opaque:{len(cand['tiers'])} tier(s)>"
        return {
            "kind": "PolicyRollout",
            "metadata": {"name": self.tenant},
            "spec": {
                "candidate": cand,
                "gates": {
                    "lowerability_floor_pct": self.lowerability_floor_pct,
                    **(
                        {
                            "analyze": {
                                "flip_budget": self.analyze_flip_budget,
                                "allowed_intents": [
                                    dict(s)
                                    for s in self.analyze_allowed_intents
                                ],
                                "universe_budget": self.analyze_universe_budget,
                                "oracle_sample": self.analyze_oracle_sample,
                            }
                        }
                        if self.analyze_enabled
                        else {}
                    ),
                    "shadow": {
                        "min_samples": self.shadow_min_samples,
                        "diff_budget": self.shadow_diff_budget,
                    },
                    "canary": {
                        "min_decisions": self.canary_min_decisions,
                        "max_flips": self.canary_max_flips,
                    },
                    "slo": {
                        "burn_ceiling": self.slo_burn_ceiling,
                        "window_s": self.slo_burn_window_s,
                    },
                },
                "promotion": {
                    "mode": self.promotion,
                    "canary_ladder": list(self.canary_ladder),
                },
                "stage_deadline_s": self.stage_deadline_s,
                "max_retries": self.max_retries,
            },
        }


def spec_from_dict(doc: dict) -> PolicyRolloutSpec:
    """Parse + validate one PolicyRollout manifest document."""
    if not isinstance(doc, dict):
        raise SpecError("PolicyRollout must be a JSON object")
    kind = doc.get("kind", "PolicyRollout")
    if kind != "PolicyRollout":
        raise SpecError(f"kind must be PolicyRollout, not {kind!r}")
    tenant = ((doc.get("metadata") or {}).get("name")) or doc.get("tenant")
    if not tenant:
        raise SpecError("metadata.name (the tenant id) is required")
    spec = doc.get("spec") or {}
    if not isinstance(spec, dict):
        raise SpecError("spec must be an object")
    gates = spec.get("gates") or {}
    shadow = gates.get("shadow") or {}
    canary = gates.get("canary") or {}
    slo = gates.get("slo") or {}
    analyze = gates.get("analyze")
    promotion = spec.get("promotion") or {}
    try:
        return PolicyRolloutSpec(
            tenant=tenant,
            candidate=dict(spec.get("candidate") or {}),
            lowerability_floor_pct=float(
                gates.get("lowerability_floor_pct", 0.0)
            ),
            analyze_enabled=analyze is not None,
            analyze_flip_budget=int((analyze or {}).get("flip_budget", 0)),
            analyze_allowed_intents=tuple(
                (analyze or {}).get("allowed_intents", ())
            ),
            analyze_universe_budget=int(
                (analyze or {}).get("universe_budget", 2048)
            ),
            analyze_oracle_sample=int(
                (analyze or {}).get("oracle_sample", 32)
            ),
            shadow_min_samples=int(shadow.get("min_samples", 100)),
            shadow_diff_budget=int(shadow.get("diff_budget", 0)),
            canary_min_decisions=int(canary.get("min_decisions", 50)),
            canary_max_flips=int(canary.get("max_flips", 0)),
            slo_burn_ceiling=float(slo.get("burn_ceiling", 2.0)),
            slo_burn_window_s=float(slo.get("window_s", 300.0)),
            promotion=promotion.get("mode", PROMOTION_AUTO),
            canary_ladder=tuple(
                promotion.get("canary_ladder", (10, 50, 100))
            ),
            stage_deadline_s=float(spec.get("stage_deadline_s", 300.0)),
            max_retries=int(spec.get("max_retries", 3)),
        )
    except (TypeError, ValueError) as e:
        if isinstance(e, SpecError):
            raise
        raise SpecError(f"malformed PolicyRollout for {tenant!r}: {e}")


def load_spec_file(path: str) -> PolicyRolloutSpec:
    with open(path) as f:
        try:
            doc = json.load(f)
        except ValueError as e:
            raise SpecError(f"{path}: not valid JSON: {e}") from None
    try:
        return spec_from_dict(doc)
    except SpecError as e:
        raise SpecError(f"{path}: {e}") from None


def load_specs_dir(directory: str) -> list:
    """Every ``*.json`` PolicyRollout in the directory, sorted by
    filename; duplicate tenants are an error (two manifests driving one
    tenant's rollout would fight)."""
    specs = []
    seen = {}
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".json") or name.startswith("."):
            continue
        path = os.path.join(directory, name)
        spec = load_spec_file(path)
        if spec.tenant in seen:
            raise SpecError(
                f"{path}: duplicate PolicyRollout for tenant "
                f"{spec.tenant!r} (also in {seen[spec.tenant]})"
            )
        seen[spec.tenant] = path
        specs.append(spec)
    return specs


__all__ = [
    "PolicyRolloutSpec",
    "SpecError",
    "PROMOTION_AUTO",
    "PROMOTION_MANUAL",
    "spec_from_dict",
    "load_spec_file",
    "load_specs_dir",
]
