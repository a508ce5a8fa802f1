"""Carrying a packed policy plane across: host numpy arrays -> the
engine's device-resident ``_CompiledSet``.

``packed_arrays`` reads the arrays (and the little metadata the decoders
need) off any PackedPolicySet-shaped object -- this package's own or the
JAX package's -- so tests can feed both engines the identical plane.
``compiled_set_from_numpy`` lays the plane out for the kernels and places
it on a device: W goes K-major once, Wt [R, L] (``k_major_plane``).
Hopper's int8 tensor-core instruction reads both operands K-major and has
no transpose for 8-bit types. The kernels take L in multiples of 64; the
packer's literal buckets already are, so only hand-built arrays are
padded, by zero columns of Wt and act_rows. A zero column adds 0 to every
score, so a literal id that lands in it (an extra padded with the unpadded
L) changes nothing.

Arrays (all numpy):
  W            [L, R] int8    +1 required-true / -1 required-false literal
  thresh       [R]    int32   positive-literal count (1e9 on padding rules)
  rule_group   [R]    int32   tier * 3 + effect (gate group n_tiers * 3)
  rule_policy  [R]    int32   policy_meta index (INT32_MAX on padding)
  act_rows     [V, L] uint8   feature-code activation table (row 0 zero)
Metadata: n_tiers, has_gate, n_rules, policy_meta (objects with
policy_id / filename / position / tier / effect).
"""

from __future__ import annotations

import numpy as np

from ..compiler.pack import PolicyMeta
from ..ops.cuda_match import L_MULTIPLE


def padded_literals(L: int) -> int:
    """L rounded up to the kernels' literal multiple (at least one)."""
    return max(-(-L // L_MULTIPLE), 1) * L_MULTIPLE


def k_major_plane(W: np.ndarray) -> np.ndarray:
    """W [L, R] -> contiguous Wt [R, L_pad] int8, zero past L."""
    L, R = W.shape
    Wt = np.zeros((R, padded_literals(L)), dtype=np.int8)
    Wt[:, :L] = W.T
    return Wt


def pad_literal_columns(a: np.ndarray) -> np.ndarray:
    """[V, L] -> contiguous [V, L_pad], zero past L."""
    out = np.zeros((a.shape[0], padded_literals(a.shape[1])), dtype=a.dtype)
    out[:, : a.shape[1]] = a
    return out


def packed_arrays(packed) -> dict:
    """The plane of a PackedPolicySet as numpy arrays + decoder metadata.
    thresh is float32 in the pack (1e9 padding is exact there) and int32
    here: the int8 plane accumulates in int32."""
    return {
        "W": np.ascontiguousarray(packed.W, dtype=np.int8),
        "thresh": np.asarray(packed.thresh).astype(np.int32),
        "rule_group": np.asarray(packed.rule_group).astype(np.int32),
        "rule_policy": np.asarray(packed.rule_policy).astype(np.int32),
        "act_rows": np.ascontiguousarray(packed.table.rows, dtype=np.uint8),
        "n_tiers": int(packed.n_tiers),
        "has_gate": bool(packed.has_gate),
        "n_rules": int(packed.n_rules),
        "policy_meta": list(packed.policy_meta),
    }


def compiled_set_from_numpy(arrays: dict, device, packed=None):
    """Place a plane given as numpy arrays (see module docstring) on
    ``device``. ``packed`` is this package's PackedPolicySet the arrays
    came from, when there is one: the Python encoder and the
    interpreter-fallback merge read it. Without it the set serves
    match_arrays / match_bits_arrays on pre-encoded codes only."""
    from .evaluator import _CompiledSet

    meta = [
        PolicyMeta(m.policy_id, m.filename, tuple(m.position), m.tier, m.effect)
        for m in arrays["policy_meta"]
    ]
    return _CompiledSet(
        Wt=k_major_plane(np.asarray(arrays["W"], dtype=np.int8)),
        thresh=np.asarray(arrays["thresh"]).astype(np.int32),
        rule_group=np.asarray(arrays["rule_group"]).astype(np.int32),
        rule_policy=np.asarray(arrays["rule_policy"]).astype(np.int32),
        act_rows=pad_literal_columns(np.asarray(arrays["act_rows"], dtype=np.uint8)),
        n_tiers=int(arrays["n_tiers"]),
        has_gate=bool(arrays["has_gate"]),
        n_rules=int(arrays.get("n_rules", arrays["W"].shape[1])),
        policy_meta=meta,
        device=device,
        packed=packed,
    )
