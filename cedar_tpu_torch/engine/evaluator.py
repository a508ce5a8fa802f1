"""PyTorch policy-evaluation engine: compile, place on the card,
batch-evaluate.

The engine owns the compiled tensor form of a tiered policy set and
evaluates batches of requests on the device. It is a drop-in `evaluate` /
`evaluate_batch` backend for CedarWebhookAuthorizer (same (entities,
request) -> (decision, diagnostics) contract as
TieredPolicyStores.is_authorized), with:

  * hybrid verdict merge: policies the compiler can't lower are evaluated
    by the interpreter per request and merged into a host-side tier walk
    over the device's per-group (first, last) matrices (want_full, the
    first-match kernel);
  * packed fast path: without interpreter fallback the tier walk runs ON
    THE DEVICE and the readback is one uint32 word per request (the words
    path: one match_words_kernel launch per chunk);
  * diagnostics: exact matched-policy sets. The verdict word's multi/err
    bits flag the rows whose word cannot carry every reason; only those
    rows fetch their per-rule bitsets (match_bits_arrays), from which the
    host recovers every determining policy.

Devices: constructed with ``device=None`` the engine runs on CUDA and
raises when CUDA is absent; only an explicit ``device="cpu"`` selects the
CPU, where every kernel wrapper takes its plain version.

Tier semantics mirror the reference's TieredPolicyStores
(internal/server/store/store.go:25-42): first tier with any explicit
signal (reasons or errors) wins; the last tier's default applies.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compiler.lower import AUTHZ_SCHEMA_INFO, SchemaInfo, lower_tiers
from ..compiler.pack import ERROR_IDX, FORBID_IDX, GROUPS_PER_TIER, PERMIT_IDX, pack
from ..compiler.table import encode_request_codes
from ..lang.authorize import ALLOW, DENY, Diagnostics, PolicySet, Reason
from ..lang.entities import EntityMap
from ..lang.eval import Env, Request, policy_matches
from ..lang.values import EvalError
from ..ops import cuda_match
from ..ops.match import (
    CODE_DENY,
    CODE_ERROR,
    CODE_NONE,
    INT32_MAX,
    POLICY_NONE,
    WORD_ERR,
    WORD_MULTI,
    lit_matrix_codes,
    match_rules_codes_bits,
    n_groups_of,
    words_to_numpy,
)
from .weights import compiled_set_from_numpy, packed_arrays

_BATCH_BUCKETS = (1, 8, 32, 128, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# rows per device launch; larger batches run as several launches
_PIPELINE_SB = 32768


def _round_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_device(device=None) -> torch.device:
    """None -> CUDA (raises without it); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchPolicyEngine: CUDA is not available; pass device='cpu' "
                "to run the plain versions on the CPU"
            )
        return torch.device("cuda")
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"TorchPolicyEngine: {d} requested but CUDA is not available")
    return d


def _bits_rule_indices(bits_row: np.ndarray, n_rules: int) -> np.ndarray:
    """Set-bit positions of one uint32 rule-bitset row (little-endian bit
    order), bounded by n_rules."""
    bits = np.unpackbits(
        np.ascontiguousarray(bits_row).view(np.uint8), bitorder="little"
    )
    return np.nonzero(bits[:n_rules])[0]


class _CompiledSet:
    """Immutable device-resident compiled policy set (the swap unit): the
    K-major rule plane Wt int8 [R, L], thresh / rule_group / rule_policy
    int32 [R] and the activation table act_rows uint8 [V, L] on the
    device, plus the host metadata the decoders read, and the TMA maps of
    the plane that the match kernels encode once (``plane_maps``). Build it
    with engine/weights.py compiled_set_from_numpy."""

    def __init__(
        self, *, Wt, thresh, rule_group, rule_policy, act_rows, n_tiers,
        has_gate, n_rules, policy_meta, device, packed=None,
    ):
        self.packed = packed
        self.device = torch.device(device)
        self.R, self.L = Wt.shape
        self.n_tiers = n_tiers
        self.has_gate = has_gate
        self.n_groups = n_groups_of(n_tiers, has_gate)
        self.n_rules = n_rules
        self.policy_meta = policy_meta
        # host copies for the bitset decode (_bits_groups)
        self.rule_group = rule_group
        self.rule_policy = rule_policy
        self.fallback = list(packed.fallback) if packed is not None else []
        dev = self.device
        self.Wt_dev = torch.from_numpy(Wt).to(dev)
        self.thresh_dev = torch.from_numpy(thresh).to(dev)
        self.rule_group_dev = torch.from_numpy(rule_group).to(dev)
        self.rule_policy_dev = torch.from_numpy(rule_policy).to(dev)
        self.act_rows_dev = torch.from_numpy(act_rows).to(dev)
        self.plane_maps: dict = {}

    @property
    def W_dev(self) -> torch.Tensor:
        """The plane as the match functions take it: W [L, R], the
        transposed view of Wt_dev (no copy)."""
        return self.Wt_dev.t()


class TorchPolicyEngine:
    def __init__(
        self,
        schema: Optional[SchemaInfo] = None,
        device=None,
    ):
        self.schema = schema or AUTHZ_SCHEMA_INFO
        self.device = resolve_device(device)
        self._compiled: Optional[_CompiledSet] = None
        self.load_generation = 0
        self._lock = threading.Lock()
        # rows whose diagnostics came from rule bitsets (resolve_flagged
        # and the want_full multi rows) since construction
        self.flagged_rows = 0

    # ------------------------------------------------------------ lifecycle

    def load(self, tiers: Sequence[PolicySet]) -> dict:
        """Full compile (lower_tiers + pack) of a tiered policy set, placed
        on the device and atomically swapped in. Returns compile stats."""
        if not tiers:
            raise ValueError("TorchPolicyEngine.load: at least one tier required")
        t0 = time.monotonic()
        compiled = lower_tiers(list(tiers), self.schema)
        t1 = time.monotonic()
        packed = pack(compiled)
        t2 = time.monotonic()
        new = compiled_set_from_numpy(packed_arrays(packed), self.device, packed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.monotonic()
        with self._lock:
            self._compiled = new
            self.load_generation += 1
        return {
            **compiled.stats(),
            "L": packed.L,
            "R": packed.R,
            "native_opaque_policies": packed.native_opaque,
            "compile_scope": "full",
            "compile_seconds": {
                "lower": round(t1 - t0, 4),
                "pack": round(t2 - t1, 4),
                "place": round(t3 - t2, 4),
                "total": round(t3 - t0, 4),
            },
        }

    @property
    def loaded(self) -> bool:
        return self._compiled is not None

    @property
    def compiled_set(self) -> Optional[_CompiledSet]:
        return self._compiled

    # ----------------------------------------------------------- evaluation

    def evaluate(
        self, entities: EntityMap, request: Request
    ) -> Tuple[str, Diagnostics]:
        return self.evaluate_batch([(entities, request)])[0]

    def evaluate_batch(
        self, items: Sequence[Tuple[EntityMap, Request]]
    ) -> List[Tuple[str, Diagnostics]]:
        cs = self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        if cs.packed is None:
            raise RuntimeError(
                "TorchPolicyEngine: this compiled set carries no encoder "
                "plan; evaluate pre-encoded codes with match_arrays"
            )
        if not items:
            return []
        packed = cs.packed
        encoded = [
            encode_request_codes(packed.plan, packed.table, em, req)
            for em, req in items
        ]
        codes_arr, extras_arr = self._encode_batch_arrays(cs, encoded, len(encoded))

        if cs.fallback:
            # interpreter-fallback policies can flip earlier tiers, so the
            # device tier walk is not authoritative: walk tiers host-side
            # over the (first, last) matrices — exact per-group sets
            # wherever min == max; genuinely multi rows fetch their bitsets
            _, full = self.match_arrays(codes_arr, extras_arr, want_full=True, cs=cs)
            first, last = full
            multi = np.nonzero(((first != last) & (first != INT32_MAX)).any(axis=1))[0]
            bits_groups = {}
            missing = multi.tolist()
            if missing:
                bits = self.match_bits_arrays(
                    codes_arr[missing], extras_arr[missing], cs=cs
                )
                self.flagged_rows += len(missing)
                for k, i in enumerate(missing):
                    bits_groups[i] = self._bits_groups(cs, bits[k])
            return [
                self._finalize_sets(
                    cs,
                    bits_groups.get(i) or self._first_groups(first[i]),
                    em,
                    req,
                )
                for i, (em, req) in enumerate(items)
            ]

        words, _ = self.match_arrays(codes_arr, extras_arr, cs=cs)
        resolved = self.resolve_flagged(words, codes_arr, extras_arr, cs=cs)
        return [
            resolved[i] if i in resolved else self._finalize_packed(cs, int(words[i]))
            for i in range(len(items))
        ]

    def resolve_flagged(
        self,
        words: np.ndarray,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        cs: Optional[_CompiledSet] = None,
    ) -> dict:
        """Resolve rows whose verdict word cannot carry complete
        diagnostics — multiple distinct policies matched the deciding group
        (multi bit) or a policy errored alongside a real match (err bit).
        The flagged rows fetch their rule bitsets in one batched call.
        Returns {row index: (decision, Diagnostics)} with the full
        reason/error sets; rows not in the dict are exactly described by
        their word."""
        cs = cs or self._compiled
        w = words.astype(np.uint32)
        # WORD_GATE is ignored on purpose: this path runs on the Python-
        # encoded side, where hard literals were host-evaluated
        need = np.nonzero((w & (WORD_ERR | WORD_MULTI)) != 0)[0]
        out: dict = {}
        if not need.size:
            return out
        bits = self.match_bits_arrays(codes_arr[need], extras_arr[need], cs=cs)
        self.flagged_rows += int(need.size)
        for k, i in enumerate(need.tolist()):
            groups = self._bits_groups(cs, bits[k])
            out[i] = self._finalize_sets(cs, groups, None, None)
        return out

    def _pad_to_bucket(self, chunk_c, chunk_e, pad_L: int):
        """Pad a (codes, extras) chunk up to the next batch bucket. Codes
        pad with 0 (the all-zero activation row), extras with L, so padding
        rows activate nothing."""
        m = chunk_c.shape[0]
        B = _round_bucket(m, _BATCH_BUCKETS)
        if B == m:
            return chunk_c, chunk_e
        pc = np.zeros((B, chunk_c.shape[1]), dtype=chunk_c.dtype)
        pe = np.full((B, chunk_e.shape[1]), pad_L, dtype=chunk_e.dtype)
        pc[:m] = chunk_c
        pe[:m] = chunk_e
        return pc, pe

    @staticmethod
    def _check_codes(cs: _CompiledSet, codes_arr: np.ndarray) -> None:
        """Feature codes index the activation table on the device, where
        an out-of-range gather is a device-side fault: check on the host."""
        if codes_arr.size and (
            codes_arr.min() < 0 or codes_arr.max() >= cs.act_rows_dev.shape[0]
        ):
            raise ValueError(
                f"feature codes outside [0, {cs.act_rows_dev.shape[0]}): "
                "encoded against another compiled set?"
            )

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(self.device)

    def match_arrays(
        self,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        want_full: bool = False,
        cs: Optional[_CompiledSet] = None,
    ):
        """Device-match pre-encoded feature codes: codes [n, S], extras
        [n, E] (padded with >= L). Returns (words, full):

          * plain: words [n] uint32 from one match_words_kernel launch
            per chunk, full None;
          * want_full: words None, full the ([n, G] first, [n, G] last)
            int32 pair from match_groups_kernel alone — never a words
            launch; the caller walks the tiers on the host.

        `cs` pins the compiled set the codes were encoded against."""
        cs = cs or self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        self._check_codes(cs, codes_arr)
        n = codes_arr.shape[0]
        words_parts, first_parts, last_parts = [], [], []
        for lo in range(0, n, _PIPELINE_SB):
            hi = min(lo + _PIPELINE_SB, n)
            m = hi - lo
            c, e = self._pad_to_bucket(codes_arr[lo:hi], extras_arr[lo:hi], cs.L)
            lit = lit_matrix_codes(self._to_device(c), self._to_device(e), cs.act_rows_dev)
            if want_full:
                first, last = cuda_match.match_groups(
                    lit, cs.W_dev, cs.thresh_dev, cs.rule_group_dev,
                    cs.rule_policy_dev, cs.n_groups, plane_maps=cs.plane_maps,
                )
                first_parts.append(first[:m].cpu().numpy())
                last_parts.append(last[:m].cpu().numpy())
            else:
                words = cuda_match.match_words(
                    lit, cs.W_dev, cs.thresh_dev, cs.rule_group_dev,
                    cs.rule_policy_dev, cs.n_tiers, cs.has_gate,
                    plane_maps=cs.plane_maps,
                )
                words_parts.append(words_to_numpy(words[:m]))
        if want_full:
            if n == 0:
                return None, (np.zeros((0, cs.n_groups), np.int32),) * 2
            return None, (np.concatenate(first_parts), np.concatenate(last_parts))
        if n == 0:
            return np.zeros((0,), np.uint32), None
        return np.concatenate(words_parts), None

    def match_bits_arrays(
        self,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        cs: Optional[_CompiledSet] = None,
    ) -> np.ndarray:
        """Per-rule satisfaction bitsets [n, ceil(R / 32)] uint32 for the
        given pre-encoded rows (the diagnostics path; plain tensor plane,
        as in the JAX package, where it runs in XLA)."""
        cs = cs or self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        self._check_codes(cs, codes_arr)
        n = codes_arr.shape[0]
        if n == 0:
            return np.zeros((0, -(-cs.R // 32)), dtype=np.uint32)
        out = []
        for lo in range(0, n, _PIPELINE_SB):
            hi = min(lo + _PIPELINE_SB, n)
            bits = match_rules_codes_bits(
                self._to_device(codes_arr[lo:hi]),
                self._to_device(extras_arr[lo:hi]),
                cs.act_rows_dev,
                cs.W_dev,
                cs.thresh_dev,
            )
            out.append(bits.cpu().numpy().view(np.uint32))
        return np.concatenate(out)

    def _encode_batch_arrays(
        self, cs: _CompiledSet, encoded, B: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad (codes, extras) pairs into [B, S] and [B, E] int32 arrays."""
        S = cs.packed.table.n_slots
        codes_arr = np.zeros((B, S), dtype=np.int32)
        max_e = max((len(e) for _, e in encoded), default=0)
        if max_e == 0:
            E = 0
        elif max_e <= 256:
            E = _round_bucket(max_e, (8, 16, 32, 64, 128, 256))
        else:  # never truncate: dropping an extra would drop an activation
            E = -(-max_e // 128) * 128
        extras_arr = np.full((B, max(E, 1)), cs.L, dtype=np.int32)
        for i, (c, e) in enumerate(encoded):
            codes_arr[i] = c
            if e:
                extras_arr[i, : len(e)] = e
        return codes_arr, extras_arr

    # ------------------------------------------------- fallback + tier walk

    def _finalize_packed(self, cs: _CompiledSet, word: int) -> Tuple[str, Diagnostics]:
        """Decode one device verdict word (no-fallback fast path)."""
        code = (word >> 30) & 0x3
        pol = word & POLICY_NONE
        if code == CODE_NONE:
            return DENY, Diagnostics()
        meta = cs.policy_meta[pol]
        if code == CODE_ERROR:
            return DENY, Diagnostics(
                reasons=[],
                errors=[f"while evaluating policy `{meta.policy_id}`: evaluation error"],
            )
        reason = Reason(meta.policy_id, meta.filename, meta.position)
        decision = DENY if code == CODE_DENY else ALLOW
        return decision, Diagnostics(reasons=[reason])

    @staticmethod
    def _first_groups(first_row: np.ndarray) -> dict:
        """{group id: [policy index]} from one first-match row — exact when
        every group matched at most one policy (the caller checks)."""
        return {
            g: [int(p)] for g, p in enumerate(first_row.tolist()) if p != INT32_MAX
        }

    @staticmethod
    def _bits_groups(cs: _CompiledSet, bits_row: np.ndarray) -> dict:
        """Decode one rule bitset row -> {group id: [policy indices,
        ascending]} with every matched policy (deduped across the several
        DNF rules one policy may lower to)."""
        idx = _bits_rule_indices(bits_row, cs.R)
        pols = cs.rule_policy[idx]
        grps = cs.rule_group[idx]
        valid = pols != INT32_MAX  # padding rules never match; belt and braces
        out: dict = {}
        for g, p in zip(grps[valid].tolist(), pols[valid].tolist()):
            out.setdefault(g, set()).add(p)
        return {g: sorted(s) for g, s in out.items()}

    def _finalize_sets(
        self,
        cs: _CompiledSet,
        groups: dict,
        entities: Optional[EntityMap],
        request: Optional[Request],
    ) -> Tuple[str, Diagnostics]:
        """Host tier walk over COMPLETE per-group policy sets, merged with
        interpreter-fallback verdicts when entities/request are given.
        Mirrors PolicySet.is_authorized + TieredPolicyStores semantics with
        full reason lists."""
        T = cs.n_tiers
        fb_allow: List[List[Reason]] = [[] for _ in range(T)]
        fb_deny: List[List[Reason]] = [[] for _ in range(T)]
        fb_errors: List[List[str]] = [[] for _ in range(T)]
        if cs.fallback and entities is not None:
            env = Env(request, entities)
            for fp in cs.fallback:
                p = fp.policy
                try:
                    if not policy_matches(p, env):
                        continue
                except EvalError as e:
                    fb_errors[fp.tier].append(
                        f"while evaluating policy `{p.policy_id}`: {e}"
                    )
                    continue
                reason = Reason(p.policy_id, p.filename, p.position)
                (fb_deny if p.effect == "forbid" else fb_allow)[fp.tier].append(reason)

        for t in range(T):
            base = t * GROUPS_PER_TIER
            deny_reasons = [
                self._meta_reason(cs, i) for i in groups.get(base + FORBID_IDX, ())
            ] + fb_deny[t]
            allow_reasons = [
                self._meta_reason(cs, i) for i in groups.get(base + PERMIT_IDX, ())
            ] + fb_allow[t]
            errors = [
                f"while evaluating policy "
                f"`{cs.policy_meta[i].policy_id}`: evaluation error"
                for i in groups.get(base + ERROR_IDX, ())
            ] + fb_errors[t]
            if deny_reasons:
                return DENY, Diagnostics(reasons=deny_reasons, errors=errors)
            if allow_reasons:
                return ALLOW, Diagnostics(reasons=allow_reasons, errors=errors)
            if errors:
                # explicit signal: stops tier descent with a reasonless deny
                return DENY, Diagnostics(reasons=[], errors=errors)
        return DENY, Diagnostics()

    @staticmethod
    def _meta_reason(cs: _CompiledSet, idx: int) -> Reason:
        meta = cs.policy_meta[int(idx)]
        return Reason(meta.policy_id, meta.filename, meta.position)
