"""PDP front-end configuration: the ``--pdp-schema`` file (a copy of the
JAX package's pdp/config.py).

A small JSON document describing how wire requests become Cedar-evaluable
attributes (which headers carry the principal, which headers join the
context) and the ext_authz fail posture. Loaded once at start-up and
immutable afterwards, like the rest of the serving configuration.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Tuple

# every key the schema file may carry; anything else is a configuration
# typo the operator should hear about at start-up, not a knob silently
# ignored
_KNOWN_KEYS = frozenset(
    {
        "principal_header",
        "uid_header",
        "groups_header",
        "context_headers",
        "extauthz_deny_on_unavailable",
        "tenant",
        "batch_max_tuples",
    }
)


@dataclass(frozen=True)
class PdpConfig:
    # ext_authz identity headers (Envoy's HTTP-service mode forwards the
    # original request's headers; an authenticating filter earlier in the
    # chain is expected to have stamped these)
    principal_header: str = "x-forwarded-user"
    uid_header: str = "x-forwarded-uid"
    groups_header: str = "x-forwarded-groups"
    # request headers copied into the Cedar context (spec.extra) as
    # ``pdp:header:<name>``; every other header is dropped, so a policy
    # sees only what the operator declared
    context_headers: Tuple[str, ...] = ()
    # the ext_authz answer when evaluation fails (docs/pdp.md's
    # fail-posture matrix): True = deny (403), False = allow (200, flagged
    # degraded). The batch API answers per tuple either way
    extauthz_deny_on_unavailable: bool = True
    # the tenant stamped on every PDP body (a fused multi-tenant plane,
    # tenancy/); empty = single-tenant
    tenant: str = ""
    # batch bodies above this many tuples are refused before any
    # evaluation: one POST must not buy an unbounded amount of card work
    batch_max_tuples: int = 256

    def __post_init__(self):
        object.__setattr__(
            self, "context_headers", tuple(h.lower() for h in self.context_headers)
        )
        object.__setattr__(self, "principal_header", self.principal_header.lower())
        object.__setattr__(self, "uid_header", self.uid_header.lower())
        object.__setattr__(self, "groups_header", self.groups_header.lower())
        if self.batch_max_tuples < 1:
            raise ValueError("batch_max_tuples must be >= 1")

    @classmethod
    def from_dict(cls, doc: dict) -> "PdpConfig":
        if not isinstance(doc, dict):
            raise ValueError("pdp schema must be a JSON object")
        unknown = sorted(set(doc) - _KNOWN_KEYS)
        if unknown:
            raise ValueError(f"unknown pdp schema key(s): {', '.join(unknown)}")
        kwargs = dict(doc)
        if "context_headers" in kwargs:
            if not isinstance(kwargs["context_headers"], list):
                raise ValueError("context_headers must be a list of strings")
            kwargs["context_headers"] = tuple(str(h) for h in kwargs["context_headers"])
        return cls(**kwargs)

    @classmethod
    def load(cls, path: str) -> "PdpConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


__all__ = ["PdpConfig"]
