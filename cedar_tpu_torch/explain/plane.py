"""The device explain plane (the JAX package's explain/plane.py).

One ``ExplainPlane`` wraps a ``TorchPolicyEngine`` and answers explain
requests with one bits fetch (``match_bits_arrays``): its per-rule
satisfaction bitset carries every attribution payload, the complete
per-group policy sets AND the winning rule, so one launch explains the
whole request. The bits plane is the plain tensor product of
ops/match.py (``match_rules_codes_bits`` over the set's float plane), as
in the JAX package, where it runs in XLA outside any Pallas kernel: an
explain launches neither hand-written kernel, and the served launch
counts (cuda_match.launch_counts) never move for one.

PAY-FOR-USE: nothing here runs until the first explain request. The port
traces nothing, so its only first-use cost is the set's float plane
(``_CompiledSet.W_f32``), which every warmed set already holds (the
engine's warmup takes the bits product once). ``cedar_explain_compiles_total``
therefore counts one per explain call that had to build the float plane
of a set that was never warmed, and reads 0 on a server, whose loads all
warm (the JAX package counts fresh XLA traces there instead).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class ExplainPlane:
    """Per-engine explain dispatch with first-use accounting."""

    def __init__(self, engine):
        self.engine = engine

    def explain_row(
        self, codes_arr: np.ndarray, extras_arr: np.ndarray, cs=None
    ) -> np.ndarray:
        """Rule-satisfaction bitsets [n, ceil(R / 32)] uint32 for
        pre-encoded rows: one bits fetch through the engine's entry point,
        pinned to the compiled set ``cs`` (default: the serving one)."""
        engine = self.engine
        cs = cs or engine._compiled
        if cs is None:
            raise RuntimeError("ExplainPlane: no policy set loaded")
        cold = cs._W_f32 is None
        bits = engine.match_bits_arrays(codes_arr, extras_arr, cs=cs)
        if cold:
            # a set that was never warmed: this call built its float plane
            try:
                from ..server.metrics import record_explain_compiles

                record_explain_compiles(1)
            except Exception:  # noqa: BLE001 — metrics never break explain
                pass
        return bits


def encode_single(engine, cs, entities, request) -> Optional[tuple]:
    """One request through the Python encoder into the engine's
    (codes [1, S], extras [1, E]) arrays: the explain plane's encode (hard
    literals host-evaluated, the activation table of the serving path)."""
    from ..compiler.table import encode_request_codes

    packed = cs.packed
    encoded = encode_request_codes(packed.plan, packed.table, entities, request)
    return engine._encode_batch_arrays(cs, [encoded], 1)
