"""The general PDP front end of the port (a copy of the JAX package's
pdp/ package; docs/pdp.md).

A second front end over the same serving stack: Envoy external
authorization in its HTTP-service mode plus an AVP-style
``POST /v1/batch-authorize`` JSON API. Both protocols map request
attributes into the SubjectAccessReview attribute shape (value-disjoint:
schema/consts.py's PDP verb prefixes) and ride the server's
``serve_authorize`` end to end: the admission gate, the decision cache,
the pipelined batcher, the native fast path and the card's
``match_words_kernel`` (gated rows also ``match_groups_kernel``), audit,
traces and metrics. SAR, ext_authz and batch-authorize requests that
share a batcher claim land in ONE launch (engine/batcher.py's
``protocol_mix`` is the evidence).
"""

from .config import PdpConfig
from .listener import PdpListener
from .mapper import (
    PROTOCOL_BATCH,
    PROTOCOL_EXTAUTHZ,
    PdpBody,
    PdpMappingError,
    batch_tuple_to_sar,
    extauthz_to_sar,
)
from .oracle import PdpOracle

__all__ = [
    "PROTOCOL_BATCH",
    "PROTOCOL_EXTAUTHZ",
    "PdpBody",
    "PdpConfig",
    "PdpListener",
    "PdpMappingError",
    "PdpOracle",
    "batch_tuple_to_sar",
    "extauthz_to_sar",
]
