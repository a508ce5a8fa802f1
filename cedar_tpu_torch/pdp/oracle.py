"""Interpreter oracle for PDP-mapped requests (a copy of the JAX package's
pdp/oracle.py).

The referee of the PDP front end: an interpreter evaluation (no card
plane, no batcher, no cache) of the EXACT mapped attributes a PDP body
carries. chip_smoke.py's phase 21 and tests/test_torch_pdp.py hold every
served decision to it, and any divergence points at the serving pipeline
(encode, plane, cache), because both sides read the same mapped document.
"""

from __future__ import annotations

import json
from typing import Tuple


class PdpOracle:
    def __init__(self, stores):
        # an authorizer with no evaluate backend: the interpreter over the
        # policy stores, the reference the device plane is held to
        from ..server.authorizer import CedarWebhookAuthorizer

        self._authorizer = CedarWebhookAuthorizer(stores)

    def authorize_body(self, body: bytes) -> Tuple[str, str]:
        """(decision, reason) of one raw synthetic-SAR body, with the
        tenant and protocol stamps the serving path applies. Uncached by
        construction: an oracle re-derives every answer."""
        from ..server.sar import get_authorizer_attributes

        attributes = get_authorizer_attributes(json.loads(body))
        attributes.tenant = getattr(body, "tenant", "")
        attributes.protocol = getattr(body, "protocol", "")
        return self._authorizer.authorize(attributes, use_cache=False)


__all__ = ["PdpOracle"]
