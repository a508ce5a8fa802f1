"""Batched rule matching in PyTorch: the verdict-word layout, the literal
expansion, and the plain versions of the fused match kernels.

The policy set is a matrix W [L, R] over literals x rules (+1 required-true,
-1 required-false) with per-rule positive-literal counts `thresh`. The
engine stores it K-major, Wt [R, L] (engine/weights.py), and hands these
functions the view W = Wt.t(); every function here takes W of any
strides. A request batch arrives as feature codes (rows of the
activation table) plus a few raw literal ids ("extras"); the match:

  1. expands them into a {0,1} literal matrix lit [B, L] int8
     (`lit_matrix_codes`);
  2. scores every rule of every request at once, score = lit @ W;
  3. sat = score >= thresh (a rule is satisfied iff all its positive
     literals are active and none of its negated literals are);
  4. reduces the satisfied rules into per-(tier, effect) first/last
     matched policy indices (`group_reduce`) and walks the tiers into one
     packed verdict word per request (`tier_walk`).

Steps 2-4 are what the hand-written CUDA kernels compute on the card
(ops/cuda_match.py, csrc/match.cu: match_groups_kernel for steps 2-3,
match_words_kernel for 2-4 in one launch). The functions here are their plain
versions: every CPU tensor takes them, and chip_smoke.py holds the kernels
against them on the card. Scores are computed in float32, which is exact:
lit entries are 0/1, W entries are +/-1, and |score| <= L << 2**24. (An
int8 x int8 `torch.mm` on the CPU returns int8 and wraps above 127.)

Packed verdict word layout (uint32; torch has no uint32 arithmetic, so
words travel as int32 tensors holding the same bit pattern and reach the
host as ``np.uint32`` views):

    bits 30..31  code: 0 = no signal in any tier (caller's default applies)
                       1 = allow   (policy = first matching permit)
                       2 = deny    (policy = first matching forbid)
                       3 = deny-on-error (policy = first erroring policy;
                           no permit/forbid matched in the winning tier)
    bit  29      err:  the winning tier ALSO had an error-group match
    bit  28      multi: more than one distinct policy matched the group
                       that produced the verdict; the complete reason set
                       needs the rule bitset (match_rules_codes_bits)
    bit  27      gate: a gate rule (group n_tiers * 3) matched
    bits 0..23   policy index into PackedPolicySet.policy_meta
                 (POLICY_NONE = 0xFFFFFF when no policy applies)
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

INT32_MAX = 2**31 - 1

POLICY_NONE = 0xFFFFFF
CODE_NONE = 0
CODE_ALLOW = 1
CODE_DENY = 2
CODE_ERROR = 3
WORD_ERR = 1 << 29
WORD_MULTI = 1 << 28
WORD_GATE = 1 << 27

# group-per-tier layout (mirrors compiler.pack)
_PERMIT, _FORBID, _ERROR = 0, 1, 2
_GPT = 3

def n_groups_of(n_tiers: int, has_gate: bool) -> int:
    return n_tiers * _GPT + (1 if has_gate else 0)


def lit_matrix_codes(
    codes: torch.Tensor, extras: Optional[torch.Tensor], act_rows: torch.Tensor
) -> torch.Tensor:
    """codes [B, S] (row indices into act_rows [V, L] uint8) + extras
    [B, E] (raw literal ids; ids outside [0, L) are padding) -> {0,1}
    literal matrix [B, L] int8. Activation rows are OR-combined: a literal
    activated by two features counts once."""
    L = act_rows.shape[1]
    codes = codes.long()
    acc = act_rows[codes[:, 0]]
    for s in range(1, codes.shape[1]):
        acc = acc | act_rows[codes[:, s]]
    if extras is not None and extras.shape[1] > 0:
        e = extras.long()
        # padding ids land in a scratch column past L that is dropped
        e = torch.where((e < 0) | (e >= L), torch.full_like(e, L), e)
        hit = torch.zeros(
            (e.shape[0], L + 1), dtype=acc.dtype, device=acc.device
        )
        hit.scatter_(1, e, 1)
        acc = acc | hit[:, :L]
    return acc.to(torch.int8)


def sat_matrix(
    lit: torch.Tensor, W: torch.Tensor, thresh: torch.Tensor
) -> torch.Tensor:
    """[B, R] bool: rule r is satisfied by request b. float32 scores are
    exact here (see module docstring); padding rules carry thresh 1e9 and
    never match."""
    scores = lit.to(torch.float32) @ W.to(torch.float32)
    return scores.to(torch.int32) >= thresh.to(torch.int32).view(1, -1)


def group_reduce(
    sat: torch.Tensor,
    group: torch.Tensor,
    policy: torch.Tensor,
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group (min, max) matched policy index: first [B, G] int32
    (INT32_MAX = none), last [B, G] int32 (-1 = none). min != max detects
    multiple DISTINCT matched policies exactly: a policy lowered to several
    DNF rules shares one index. Rules whose group lies outside [0, G)
    never contribute."""
    pol = policy.to(torch.int32).view(1, -1)
    grp = group.to(torch.int32).view(1, -1)
    masked_min = torch.where(sat, pol, INT32_MAX)
    masked_max = torch.where(sat, pol, -1)
    B = sat.shape[0]
    if n_groups == 0 or sat.shape[1] == 0:
        return (
            torch.full((B, n_groups), INT32_MAX, dtype=torch.int32, device=sat.device),
            torch.full((B, n_groups), -1, dtype=torch.int32, device=sat.device),
        )
    mins, maxs = [], []
    for g in range(n_groups):
        in_g = grp == g
        mins.append(torch.where(in_g, masked_min, INT32_MAX).amin(dim=1))
        maxs.append(torch.where(in_g, masked_max, -1).amax(dim=1))
    return (
        torch.stack(mins, dim=1).to(torch.int32),
        torch.stack(maxs, dim=1).to(torch.int32),
    )


def first_match_ref(
    lit: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
    group: torch.Tensor,
    policy: torch.Tensor,
    n_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the first-match kernel (csrc/match.cu
    match_groups_kernel; the port of pallas_first_match): lit [B, L] int8,
    W [L, R] int8 (any strides), thresh/group/policy [R] int32 -> (first,
    last) [B, G] int32."""
    return group_reduce(sat_matrix(lit, W, thresh), group, policy, n_groups)


def _to_word32(word: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same low 32
    bits (the uint32 word's bit pattern)."""
    word = word & 0xFFFFFFFF
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def tier_walk(
    first: torch.Tensor,
    last: Optional[torch.Tensor],
    n_tiers: int,
    has_gate: bool = False,
) -> torch.Tensor:
    """Plain version of the tier walk in match_words_kernel's epilogue (and
    the want_full path's host walk): first/last [B, G] -> packed verdict
    words [B] (int32 bit pattern). First tier with any explicit
    signal (reason or error) wins, like TieredPolicyStores; err only
    alongside a permit/forbid; multi only in the deciding group; gate bit
    from group n_tiers * 3. `last` may be None (multi never set). The word
    is built in int64 because codes 2 and 3 set bit 31."""
    f = first.long()
    l = last.long() if last is not None else None
    B = f.shape[0]
    zeros = torch.zeros((B,), dtype=torch.int64, device=f.device)
    code, err, multi = zeros, zeros, zeros
    pol = torch.full((B,), POLICY_NONE, dtype=torch.int64, device=f.device)
    done = torch.zeros((B,), dtype=torch.bool, device=f.device)
    for t in range(n_tiers):
        p_f = f[:, t * _GPT + _PERMIT]
        f_f = f[:, t * _GPT + _FORBID]
        e_f = f[:, t * _GPT + _ERROR]
        has_p, has_f, has_e = p_f != INT32_MAX, f_f != INT32_MAX, e_f != INT32_MAX
        c_t = torch.where(
            has_f,
            CODE_DENY,
            torch.where(has_p, CODE_ALLOW, torch.where(has_e, CODE_ERROR, CODE_NONE)),
        )
        win_first = torch.where(has_f, f_f, torch.where(has_p, p_f, e_f))
        sig = c_t != CODE_NONE
        new = (~done) & sig
        code = torch.where(new, c_t, code)
        pol = torch.where(new, win_first, pol)
        err = torch.where(new & has_e & (has_p | has_f), 1, err)
        if l is not None:
            l_p = l[:, t * _GPT + _PERMIT]
            l_f = l[:, t * _GPT + _FORBID]
            l_e = l[:, t * _GPT + _ERROR]
            win_last = torch.where(has_f, l_f, torch.where(has_p, l_p, l_e))
            multi = torch.where(new & (win_first != win_last), 1, multi)
        done = done | sig
    word = (code << 30) | (err << 29) | (multi << 28) | (pol & POLICY_NONE)
    if has_gate:
        gate = (f[:, n_tiers * _GPT] != INT32_MAX).long()
        word = word | (gate << 27)
    return _to_word32(word)


def match_words_ref(
    lit: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
    group: torch.Tensor,
    policy: torch.Tensor,
    n_tiers: int,
    has_gate: bool = False,
) -> torch.Tensor:
    """Plain version of match_words_kernel (the port of
    pallas_match_words): -> words [B] int32 bit pattern."""
    first, last = first_match_ref(
        lit, W, thresh, group, policy, n_groups_of(n_tiers, has_gate)
    )
    return tier_walk(first, last, n_tiers, has_gate)


def pack_sat_bits(sat: torch.Tensor) -> torch.Tensor:
    """sat [B, R] bool -> [B, ceil(R / 32)] int32 bit pattern of the
    uint32 bitset, little-endian bit order (rule r lives in word r // 32,
    bit r % 32)."""
    B, R = sat.shape
    pad = -R % 32
    if pad:
        sat = torch.cat(
            [sat, torch.zeros((B, pad), dtype=torch.bool, device=sat.device)],
            dim=1,
        )
    s = sat.view(B, -1, 32).long()
    weights = torch.ones(32, dtype=torch.int64, device=sat.device) << torch.arange(
        32, dtype=torch.int64, device=sat.device
    )
    return _to_word32((s * weights).sum(dim=2))


def match_rules_codes_bits(
    codes: torch.Tensor,
    extras: Optional[torch.Tensor],
    act_rows: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
) -> torch.Tensor:
    """Per-rule satisfaction bitsets [B, R // 32] (int32 bit pattern) for
    diagnostic rendering: the host maps set bits through rule_policy /
    rule_group to recover the COMPLETE matched-policy set per (tier,
    effect). Runs only for rows whose verdict word carries the multi or
    err flag."""
    lit = lit_matrix_codes(codes, extras, act_rows)
    return pack_sat_bits(sat_matrix(lit, W, thresh))


# flagged-row compaction width: a words launch with want_bits returns the
# rule bitsets of up to this many flagged rows, fetched with the words in
# the same readback. Rows past it (overflow) fetch theirs through
# match_rules_codes_bits.
BITS_TOPK = 128


def flagged_rows(
    words: Optional[torch.Tensor], full: Optional[Tuple[torch.Tensor, torch.Tensor]]
) -> torch.Tensor:
    """[B] bool: the rows whose diagnostics need their rule bitset. With
    the (first, last) matrices (want_full: the host walks the tiers and
    merges interpreter verdicts, so ANY group may decide) a row is flagged
    when some group matched more than one distinct policy; otherwise when
    its verdict word carries the multi or err bit."""
    if full is not None:
        first, last = full
        return ((first != last) & (first != INT32_MAX)).any(dim=1)
    return (words & (WORD_ERR | WORD_MULTI)) != 0


def compact_flagged_bits(
    lit: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
    flagged: torch.Tensor,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rule bitsets of the flagged rows, compacted into a fixed
    [K, ceil(R / 32)] buffer on the device (K = min(B, BITS_TOPK)): a
    top-k over a keep-key (B - row for flagged rows, 0 otherwise) selects
    the first K flagged rows, then only those rows' literal rows are
    gathered and scored. Returns (vals [K] int32, > 0 where the slot is
    live; idx [K] int32 row indices; kbits [K, ceil(R / 32)] int32 bit
    pattern). Rows at or past n_valid (bucket padding) are never selected.
    No host synchronisation: everything stays on lit's device and stream."""
    B = flagged.shape[0]
    K = min(B, BITS_TOPK)
    iota = torch.arange(B, dtype=torch.int32, device=flagged.device)
    if n_valid is not None:
        flagged = flagged & (iota < n_valid)
    key = torch.where(flagged, B - iota, 0)
    vals, idx = torch.topk(key, K)
    kbits = pack_sat_bits(sat_matrix(lit[idx], W, thresh))
    return vals.to(torch.int32), idx.to(torch.int32), kbits


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Device int32 words -> host uint32 verdict words."""
    return words.cpu().numpy().view(np.uint32)

