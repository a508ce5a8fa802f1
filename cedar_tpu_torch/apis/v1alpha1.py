"""API types: the cedar.k8s.aws/v1alpha1 Policy CRD and CedarConfig.

Behavior parity with the upstream project's api/v1alpha1/policy_types.go
and config_types.go (the JAX package's apis/v1alpha1.py): Go-style
Duration JSON (accepts "1m30s" strings or integer nanoseconds), the
store-config union with defaulting, and validation including the
30s–168h refresh bounds.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

GROUP = "cedar.k8s.aws"
VERSION = "v1alpha1"

STORE_TYPE_DIRECTORY = "directory"
STORE_TYPE_CRD = "crd"
STORE_TYPE_VERIFIED_PERMISSIONS = "verifiedPermissions"

VALIDATION_MODE_STRICT = "strict"
VALIDATION_MODE_PERMISSIVE = "permissive"
VALIDATION_MODE_PARTIAL = "partial"
VALIDATION_MODES = (
    VALIDATION_MODE_STRICT,
    VALIDATION_MODE_PERMISSIVE,
    VALIDATION_MODE_PARTIAL,
)


class ValidationError(ValueError):
    pass


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)")
_DUR_UNITS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60 * 1_000_000_000,
    "h": 3600 * 1_000_000_000,
}


def parse_duration(v: Any) -> int:
    """Go-style duration -> nanoseconds. Accepts numbers (ns) or strings
    like "1m", "30s", "1h30m" (reference config_types.go:24-43)."""
    if isinstance(v, bool):
        raise ValidationError("invalid duration")
    if isinstance(v, (int, float)):
        return int(v)
    if isinstance(v, str):
        s = v.strip()
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        if s in ("0", ""):
            return 0
        pos = 0
        total = 0
        for m in _DUR_RE.finditer(s):
            if m.start() != pos:
                raise ValidationError(f"invalid duration {v!r}")
            total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
            pos = m.end()
        if pos != len(s) or pos == 0:
            raise ValidationError(f"invalid duration {v!r}")
        return -int(total) if neg else int(total)
    raise ValidationError("invalid duration")


SECOND = 1_000_000_000
MINUTE = 60 * SECOND
HOUR = 3600 * SECOND


# --------------------------------------------------------------- Policy CRD


@dataclass
class PolicyValidation:
    """spec.validation (reference policy_types.go:30-44)."""

    enforced: bool = False
    validation_mode: str = VALIDATION_MODE_STRICT

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "PolicyValidation":
        d = d or {}
        return cls(
            enforced=bool(d.get("enforced", False)),
            validation_mode=d.get("validationMode", VALIDATION_MODE_STRICT),
        )


@dataclass
class PolicySpec:
    content: str = ""
    validation: PolicyValidation = field(default_factory=PolicyValidation)


@dataclass
class PolicyObject:
    """The cluster-scoped Policy CRD (reference policy_types.go:71)."""

    name: str = ""
    uid: str = ""
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    spec: PolicySpec = field(default_factory=PolicySpec)

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyObject":
        meta = d.get("metadata", {}) or {}
        spec = d.get("spec", {}) or {}
        return cls(
            name=meta.get("name", ""),
            uid=meta.get("uid", ""),
            annotations=dict(meta.get("annotations", {}) or {}),
            labels=dict(meta.get("labels", {}) or {}),
            spec=PolicySpec(
                content=spec.get("content", ""),
                validation=PolicyValidation.from_dict(spec.get("validation")),
            ),
        )



# -------------------------------------------------------------- CedarConfig


@dataclass
class DirectoryStoreConfig:
    path: str = ""
    refresh_interval_ns: Optional[int] = None


@dataclass
class CRDStoreConfig:
    kubeconfig_context: str = ""


@dataclass
class VerifiedPermissionsStoreConfig:
    policy_store_id: str = ""
    refresh_interval_ns: Optional[int] = None
    aws_region: str = ""
    aws_profile: str = ""


@dataclass
class StoreConfig:
    type: str = ""
    directory_store: DirectoryStoreConfig = field(default_factory=DirectoryStoreConfig)
    crd_store: CRDStoreConfig = field(default_factory=CRDStoreConfig)
    verified_permissions_store: VerifiedPermissionsStoreConfig = field(
        default_factory=VerifiedPermissionsStoreConfig
    )

    @classmethod
    def from_dict(cls, d: dict) -> "StoreConfig":
        ds = d.get("directoryStore", {}) or {}
        cs = d.get("crdStore", {}) or {}
        vs = d.get("verifiedPermissionsStore", {}) or {}
        return cls(
            type=d.get("type", ""),
            directory_store=DirectoryStoreConfig(
                path=ds.get("path", ""),
                refresh_interval_ns=(
                    parse_duration(ds["refreshInterval"])
                    if "refreshInterval" in ds
                    else None
                ),
            ),
            crd_store=CRDStoreConfig(
                kubeconfig_context=cs.get("kubeconfigContext", "")
            ),
            verified_permissions_store=VerifiedPermissionsStoreConfig(
                policy_store_id=vs.get("policyStoreId", ""),
                refresh_interval_ns=(
                    parse_duration(vs["refreshInterval"])
                    if "refreshInterval" in vs
                    else None
                ),
                aws_region=vs.get("awsRegion", ""),
                aws_profile=vs.get("awsProfile", ""),
            ),
        )

    def validate(self) -> None:
        """Validation + defaulting (reference config_types.go:106-145)."""
        if self.type == STORE_TYPE_DIRECTORY:
            if not self.directory_store.path:
                raise ValidationError("directory store path is required")
            ri = self.directory_store.refresh_interval_ns
            if ri is not None:
                if ri < 30 * SECOND:
                    raise ValidationError(
                        "directory store refresh interval must be at least 30s"
                    )
                if ri > 168 * HOUR:
                    raise ValidationError(
                        "directory store refresh interval must be under 1 week (168h)"
                    )
            else:
                self.directory_store.refresh_interval_ns = 1 * MINUTE
        elif self.type == STORE_TYPE_CRD:
            pass
        elif self.type == STORE_TYPE_VERIFIED_PERMISSIONS:
            if not self.verified_permissions_store.policy_store_id:
                raise ValidationError(
                    "verified permissions store policy store id is required"
                )
            ri = self.verified_permissions_store.refresh_interval_ns
            if ri is not None:
                if ri < 30 * SECOND:
                    raise ValidationError(
                        "verified permissions refresh interval must be at least 30s"
                    )
                if ri > 168 * HOUR:
                    raise ValidationError(
                        "verified permissions refresh interval must be under 1 week (168h)"
                    )
            else:
                self.verified_permissions_store.refresh_interval_ns = 5 * MINUTE
        else:
            raise ValidationError("invalid store type")


@dataclass
class CedarConfig:
    stores: List[StoreConfig] = field(default_factory=list)
    # spec.validationMode: load-time posture of the static policy-set
    # analysis (the JAX package's analysis/; not in the port yet): strict
    # rejects a load carrying blocking findings, permissive annotates
    # only, partial drops just the offending policies from the compiled
    # set (docs/analysis.md).
    validation_mode: str = VALIDATION_MODE_PERMISSIVE

    @classmethod
    def from_dict(cls, d: dict) -> "CedarConfig":
        spec = d.get("spec", {}) or {}
        return cls(
            stores=[StoreConfig.from_dict(s) for s in spec.get("stores", []) or []],
            validation_mode=spec.get(
                "validationMode", VALIDATION_MODE_PERMISSIVE
            ),
        )

    def validate(self) -> None:
        if self.validation_mode not in VALIDATION_MODES:
            raise ValidationError(
                f".spec.validationMode: {self.validation_mode!r} is not one "
                f"of {list(VALIDATION_MODES)}"
            )
        for i, store in enumerate(self.stores):
            try:
                store.validate()
            except ValidationError as e:
                raise ValidationError(f".spec.stores[{i}]: {e}") from None
