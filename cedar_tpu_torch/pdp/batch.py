"""AVP-style batch authorization, ``POST /v1/batch-authorize`` (a copy of
the JAX package's pdp/batch.py).

Request body::

    {"requests": [{"principal": ..., "action": ..., "resource": ...,
                   "context": {...}}, ...]}

Response body: one entry per tuple, in order, with PARTIAL-ANSWER
semantics: a malformed or failing tuple answers for itself (an ``errors``
list and the deny-safe decision) and never poisons its neighbours. Only a
body that cannot be parsed at all, lacks ``requests`` or exceeds the tuple
cap is refused whole, before any evaluation.

The tuples are submitted concurrently, so one batch POST lands in as few
batcher claims as the window allows, beside whatever SAR and ext_authz
traffic shares them.
"""

from __future__ import annotations

import json
import logging
from typing import List, Tuple

from ..obs.audit import determining_policies
from .mapper import PROTOCOL_BATCH, PdpMappingError, batch_tuple_to_sar, encode_pdp_body

log = logging.getLogger(__name__)


def parse_batch(raw: bytes, config) -> List:
    """A raw POST body -> its list of tuple entries. Raises
    PdpMappingError when the BODY is malformed (a whole-request refusal;
    a tuple's own problems are answered per tuple)."""
    try:
        doc = json.loads(raw)
    except (ValueError, TypeError, RecursionError) as e:
        raise PdpMappingError(f"body is not valid JSON: {e}") from e
    if not isinstance(doc, dict) or not isinstance(doc.get("requests"), list):
        raise PdpMappingError('body must be {"requests": [...]}')
    requests = doc["requests"]
    if not requests:
        raise PdpMappingError("requests must be non-empty")
    if len(requests) > config.batch_max_tuples:
        raise PdpMappingError(
            f"{len(requests)} tuples exceeds the cap of {config.batch_max_tuples}"
        )
    return requests


def _decision_of(sar_response: dict) -> Tuple[str, str, List[str]]:
    """(decision, reason, errors) from a rendered SAR response: the wire
    answer read back, so the batch answer never disagrees with what the
    serving stack said."""
    status = (sar_response or {}).get("status") or {}
    errors = []
    if status.get("evaluationError"):
        errors.append(str(status["evaluationError"]))
    if status.get("allowed"):
        decision = "ALLOW"
    elif status.get("denied"):
        decision = "DENY"
    else:
        decision = "NO_OPINION"
    return decision, str(status.get("reason") or ""), errors


def _render_item(index: int, sar_response: dict) -> dict:
    decision, reason, errors = _decision_of(sar_response)
    item = {
        "index": index,
        "decision": decision,
        "determiningPolicies": [{"policyId": pid} for pid in determining_policies(reason)],
    }
    if reason:
        item["reason"] = reason
    if errors:
        item["errors"] = errors
    return item


def handle_batch(serve, raw: bytes, config, pool) -> Tuple[int, dict]:
    """Serve one batch POST: ``serve`` is the WebhookServer's
    serve_authorize (behind the ingress gate), ``pool`` an executor shared
    across requests -> (http status, response document)."""
    try:
        requests = parse_batch(raw, config)
    except PdpMappingError as e:
        return 400, {"error": str(e)}
    # map first (cheap, no card work): a malformed tuple answers at once
    # and never takes an executor slot
    bodies: List = []
    results: List = [None] * len(requests)
    for i, entry in enumerate(requests):
        try:
            doc = batch_tuple_to_sar(entry, config)
            bodies.append((i, encode_pdp_body(doc, PROTOCOL_BATCH, config)))
        except PdpMappingError as e:
            results[i] = {"index": i, "decision": "DENY", "errors": [f"unmappable tuple: {e}"]}
    futures = [(i, pool.submit(serve, body)) for i, body in bodies]
    for i, fut in futures:
        try:
            results[i] = _render_item(i, fut.result())
        except Exception as e:  # noqa: BLE001 — partial answers by contract
            log.exception("batch tuple %d evaluation failed", i)
            results[i] = {
                "index": i,
                "decision": "NO_OPINION",
                "errors": [f"evaluation error: {e}"],
            }
    return 200, {"responses": results}


__all__ = ["handle_batch", "parse_batch"]
