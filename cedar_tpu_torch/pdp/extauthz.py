"""Envoy ext_authz protocol rendering, HTTP-service mode (a copy of the
JAX package's pdp/extauthz.py).

Envoy's HTTP authorization service contract is status-code driven: any
2xx response allows the request, anything else denies it and the status
and body go downstream. The JSON bodies here are for operators and
tests; Envoy itself reads only the status line on allow.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .mapper import PROTOCOL_EXTAUTHZ, PdpMappingError, encode_pdp_body
from .mapper import extauthz_to_sar as _map_check


def check_body(method: str, path: str, headers: dict, config):
    """The mapped and stamped wire body of one ext_authz check. Raises
    PdpMappingError for a request that cannot be mapped."""
    doc = _map_check(method, path, headers, config)
    return encode_pdp_body(doc, PROTOCOL_EXTAUTHZ, config)


def render_check_response(sar_response: dict, config) -> Tuple[int, dict]:
    """(status, body) of a served check, read back from the rendered SAR
    response so the wire answer never disagrees with what the serving
    stack decided. The fail-posture matrix (docs/pdp.md): allow -> 200;
    deny and no-opinion -> 403 (the PDP is the final authority on its
    routes, with no authorizer chain to fall through to, so abstention
    denies); an evaluation error (an overload shed, an open breaker, a
    failed batch) -> the configured unavailable posture: deny (403, the
    default) or allow (200, flagged ``degraded`` so the choice shows in
    the answer and in the ``<error>`` decision label of the metrics)."""
    status = (sar_response or {}).get("status") or {}
    reason = str(status.get("reason") or "")
    error: Optional[str] = status.get("evaluationError")
    if error is not None:
        if config.extauthz_deny_on_unavailable:
            return 403, {
                "decision": "deny",
                "reason": "evaluation unavailable (deny-on-unavailable)",
                "error": error,
            }
        return 200, {
            "decision": "allow",
            "reason": "evaluation unavailable (allow-on-unavailable)",
            "degraded": True,
            "error": error,
        }
    if status.get("allowed"):
        return 200, {"decision": "allow", "reason": reason}
    return 403, {"decision": "deny", "reason": reason}


def render_malformed(e: PdpMappingError) -> Tuple[int, dict]:
    """An unmappable check is a client error, never an evaluation: 403
    (deny) whatever the unavailable posture. Allow-on-unavailable exists
    to survive an outage, not to approve a request that cannot even name
    a principal, an action and a resource."""
    return 403, {"decision": "deny", "reason": f"unmappable request: {e}"}


__all__ = ["check_body", "render_check_response", "render_malformed"]
