"""The port's K-major padded rule plane and the match kernels' operand
checks, against the JAX package.

The engine stores the plane once, K-major: Wt [R, L_pad] int8 with L_pad
a multiple of 64 (engine/weights.py; the packer's L already is, a
hand-built plane gets zero columns), and hands the match functions the
view W = Wt.t(). Literal matrices come out [B, L_pad] with a zero tail. Held here against the Pallas kernels in interpret mode on the
same seeded numpy inputs, at L and R that are not multiples of 64 or 128;
every value is an exact integer, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cedar_tpu.ops import match as jmatch
from cedar_tpu.ops.pallas_match import pallas_first_match, pallas_match_words
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.weights import (
    compiled_set_from_numpy,
    k_major_plane,
    pad_literal_columns,
    padded_literals,
)
from cedar_tpu_torch.ops import cuda_match
from cedar_tpu_torch.ops import match as tmatch

INT32_MAX = 2**31 - 1

# (L, R): neither a multiple of the kernels' 64-literal pad nor of a
# 128-rule tile; R stays within one Pallas rule tile (512) so the
# interpret-mode reference takes it whole
SHAPES = [(200, 300), (1000, 500)]
TIERS = [(1, False), (1, True), (3, False)]  # G = 3, 4 (gate), 9


def _ruleset(rng, L, R, G):
    """Sparse rules (1-2 positive literals, occasional negation) so random
    requests match, multi-match and hit every group; a few padding rules
    (thresh 1e9, policy INT32_MAX) never match."""
    W = np.zeros((L, R), np.int8)
    n_pos = rng.integers(1, 3, size=R)
    for k in range(2):
        cols = np.nonzero(n_pos > k)[0]
        W[rng.integers(0, L, size=cols.size), cols] = 1
    neg = np.nonzero(rng.random(R) < 0.3)[0]
    rows = rng.integers(0, L, size=neg.size)
    keep = W[rows, neg] == 0
    W[rows[keep], neg[keep]] = -1
    thresh = np.maximum((W > 0).sum(0), 1).astype(np.int32)
    group = rng.integers(0, G, size=R).astype(np.int32)
    policy = rng.integers(0, 10000, size=R).astype(np.int32)
    thresh[-8:] = 10**9
    policy[-8:] = INT32_MAX
    return W, thresh, group, policy


def _lit(rng, B, L, active=16):
    lit = np.zeros((B, L), np.int8)
    np.put_along_axis(lit, rng.integers(0, L, size=(B, active)), 1, axis=1)
    return lit


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _padded(lit, L_pad):
    out = np.zeros((lit.shape[0], L_pad), np.int8)
    out[:, : lit.shape[1]] = lit
    return out


def _jax_first(lit, W, thresh, group, policy, G):
    f, l = pallas_first_match(
        jnp.asarray(lit), jnp.asarray(W), jnp.asarray(thresh)[None, :],
        jnp.asarray(group)[None, :], jnp.asarray(policy)[None, :], G, interpret=True,
    )
    return np.asarray(f), np.asarray(l)


def _jax_words(lit, W, thresh, group, policy, T, gate):
    return np.asarray(
        pallas_match_words(
            jnp.asarray(lit), jnp.asarray(W), jnp.asarray(thresh)[None, :],
            jnp.asarray(group)[None, :], jnp.asarray(policy)[None, :], T, gate,
            interpret=True,
        )
    )


@pytest.mark.parametrize("T,gate", TIERS)
@pytest.mark.parametrize("L,R", SHAPES)
def test_k_major_plane_first_match_equals_pallas(L, R, T, gate):
    G = tmatch.n_groups_of(T, gate)
    rng = np.random.default_rng(L + R + G)
    W, thresh, group, policy = _ruleset(rng, L, R, G)
    lit = _lit(rng, 200, L)
    Wt = k_major_plane(W)
    L_pad = padded_literals(L)
    assert Wt.shape == (R, L_pad) and L_pad % 64 == 0 and L_pad - L < 64
    assert Wt.flags.c_contiguous and not Wt[:, L:].any()
    np.testing.assert_array_equal(Wt[:, :L], W.T)
    lit_t, Wt_t, th, grp, pol = _t(_padded(lit, L_pad), Wt, thresh, group, policy)
    # the padded operands are what the kernel takes
    assert cuda_match.kernel_operands(lit_t, Wt_t.t(), th, grp, pol, G) == (200, L_pad, R)
    j_first, j_last = _jax_first(lit, W, thresh, group, policy, G)
    for fn in (tmatch.first_match_ref, cuda_match.match_groups):
        t_first, t_last = fn(lit_t, Wt_t.t(), th, grp, pol, G)
        np.testing.assert_array_equal(t_first.numpy(), j_first)
        np.testing.assert_array_equal(t_last.numpy(), j_last)
    assert (j_first != INT32_MAX).any() and (j_first != j_last).any()


@pytest.mark.parametrize("T,gate", TIERS)
@pytest.mark.parametrize("L,R", SHAPES)
def test_k_major_plane_words_equal_pallas(L, R, T, gate):
    G = tmatch.n_groups_of(T, gate)
    rng = np.random.default_rng(7 * L + R + G)
    W, thresh, group, policy = _ruleset(rng, L, R, G)
    lit = _lit(rng, 200, L)
    lit_t, Wt_t, th, grp, pol = _t(_padded(lit, padded_literals(L)), k_major_plane(W), thresh, group, policy)
    j_words = _jax_words(lit, W, thresh, group, policy, T, gate)
    for fn in (tmatch.match_words_ref, cuda_match.match_words):
        t_words = tmatch.words_to_numpy(fn(lit_t, Wt_t.t(), th, grp, pol, T, gate))
        np.testing.assert_array_equal(t_words, j_words)
    # deny words (bit 31) and the multi/err flags occur
    assert ((j_words >> 31) & 1).any() and ((j_words >> 28) & 3).any()


def _plane_arrays(rng, L, R, T, gate, V=48):
    G = tmatch.n_groups_of(T, gate)
    W, thresh, group, policy = _ruleset(rng, L, R, G)
    act_rows = (rng.random((V, L)) < 0.01).astype(np.uint8)
    act_rows[0] = 0
    return {
        "W": W, "thresh": thresh, "rule_group": group, "rule_policy": policy,
        "act_rows": act_rows, "n_tiers": T, "has_gate": gate, "n_rules": R,
        "policy_meta": [],
    }


@pytest.mark.parametrize("L,R,T,gate", [(200, 300, 1, True), (1000, 500, 3, False), (1000, 300, 1, False)])
def test_engine_match_arrays_on_padded_plane_equals_pallas(L, R, T, gate):
    """The engine's own path over a plane placed by compiled_set_from_numpy:
    words, the want_full matrices and the flagged-row bitsets."""
    rng = np.random.default_rng(L * R + T)
    arrays = _plane_arrays(rng, L, R, T, gate)
    cs = compiled_set_from_numpy(arrays, "cpu")
    L_pad = padded_literals(L)
    assert (cs.L, cs.R) == (L_pad, R)
    assert tuple(cs.Wt_dev.shape) == (R, L_pad) and cs.Wt_dev.is_contiguous()
    assert tuple(cs.act_rows_dev.shape) == (arrays["act_rows"].shape[0], L_pad)
    n, S = 200, 5
    codes = rng.integers(0, arrays["act_rows"].shape[0], size=(n, S)).astype(np.int32)
    # extras past L are padding: those in [L, L_pad) land in the zero tail,
    # whose plane columns add 0 to every score; the rest are dropped
    extras = rng.integers(0, L + 90, size=(n, 8)).astype(np.int32)
    engine = TorchPolicyEngine(device="cpu")
    words, _ = engine.match_arrays(codes, extras, cs=cs)
    _, (first, last) = engine.match_arrays(codes, extras, want_full=True, cs=cs)
    jlit = np.asarray(
        jmatch._lit_matrix_codes(
            jnp.asarray(codes), jnp.asarray(extras), jnp.asarray(arrays["act_rows"]), jnp.int8
        )
    )
    a = arrays
    np.testing.assert_array_equal(
        words, _jax_words(jlit, a["W"], a["thresh"], a["rule_group"], a["rule_policy"], T, gate)
    )
    j_first, j_last = _jax_first(
        jlit, a["W"], a["thresh"], a["rule_group"], a["rule_policy"], tmatch.n_groups_of(T, gate)
    )
    np.testing.assert_array_equal(first, j_first)
    np.testing.assert_array_equal(last, j_last)
    assert (j_first != INT32_MAX).any()
    # the bitset plane reads the same Wt: rule r of row b is set iff it is
    # satisfied (numpy reference over the unpadded plane)
    bits = engine.match_bits_arrays(codes, extras, cs=cs)
    sat = (jlit.astype(np.int32) @ a["W"].astype(np.int32)) >= a["thresh"][None, :]
    want = np.packbits(
        np.pad(sat, ((0, 0), (0, -R % 32))), axis=1, bitorder="little"
    ).view(np.uint32)
    np.testing.assert_array_equal(bits, want)


@pytest.mark.parametrize("E", [0, 8])
def test_lit_matrix_codes_leaves_pad_tail_zero(E):
    """Codes and real extras activate nothing in the zero tail, and the
    engine's padding ids (its L is the padded width) are dropped."""
    rng = np.random.default_rng(31 + E)
    B, S, V, L = 64, 6, 40, 200
    act_rows = (rng.random((V, L)) < 0.05).astype(np.uint8)
    act_rows[0] = 0
    act_pad = pad_literal_columns(act_rows)
    assert act_pad.shape == (V, 256) and not act_pad[:, L:].any()
    codes = rng.integers(0, V, size=(B, S)).astype(np.int32)
    extras = rng.integers(0, L, size=(B, max(E, 1))).astype(np.int32)[:, :E]
    if E:
        pad = rng.random(extras.shape) < 0.3
        extras[pad] = rng.choice([-1, 256, 300], size=int(pad.sum()))
        assert pad.any() and (~pad).any()
    out = tmatch.lit_matrix_codes(*_t(codes, extras, act_pad))
    assert out.dtype == torch.int8 and tuple(out.shape) == (B, 256)
    assert not out[:, L:].any()
    ref = jmatch._lit_matrix_codes(
        jnp.asarray(codes), jnp.asarray(extras), jnp.asarray(act_rows), jnp.int8
    )
    np.testing.assert_array_equal(out[:, :L].numpy(), np.asarray(ref))


def _good(B=4, L=256, R=96):
    lit = torch.zeros((B, L), dtype=torch.int8)
    Wt = torch.zeros((R, L), dtype=torch.int8)
    r = torch.zeros((R,), dtype=torch.int32)
    return lit, Wt.t(), r, r.clone(), r.clone()


def _misaligned(shape, offset):
    n = int(np.prod(shape))
    return torch.zeros((n + 64,), dtype=torch.int8)[offset : offset + n].view(*shape)


BAD_OPERANDS = {
    # L not padded to a multiple of 64
    "unpadded_L": (lambda: (torch.zeros((4, 200), dtype=torch.int8), torch.zeros((96, 200), dtype=torch.int8).t()), ValueError, "multiple of 64"),
    # a contiguous [L, R] plane: the kernel needs the K-major plane's view
    "W_not_k_major": (lambda: (_good()[0], torch.zeros((256, 96), dtype=torch.int8)), ValueError, "K-major"),
    "lit_misaligned": (lambda: (_misaligned((4, 256), 1), _good()[1]), ValueError, "aligned"),
    "W_misaligned": (lambda: (_good()[0], _misaligned((96, 256), 8).t()), ValueError, "aligned"),
    "lit_not_contiguous": (lambda: (torch.zeros((256, 4), dtype=torch.int8).t(), _good()[1]), ValueError, "contiguous"),
    "lit_dtype": (lambda: (_good()[0].float(), _good()[1]), TypeError, "int8"),
    "W_dtype": (lambda: (_good()[0], _good()[1].to(torch.int16)), TypeError, "int8"),
    "L_mismatch": (lambda: (torch.zeros((4, 128), dtype=torch.int8), _good()[1]), ValueError, "shape"),
    "empty_plane": (lambda: (_good()[0], torch.zeros((0, 256), dtype=torch.int8).t()), ValueError, "empty"),
}


@pytest.mark.parametrize("case", sorted(BAD_OPERANDS))
def test_kernel_operand_checks_raise_before_any_device(case):
    """The checks run on CPU tensors too: they raise before a kernel would
    see the operands."""
    make, exc, match = BAD_OPERANDS[case]
    lit, W = make()
    R = W.shape[1]
    r = torch.zeros((R,), dtype=torch.int32)
    with pytest.raises(exc, match=match):
        cuda_match.kernel_operands(lit, W, r, r, r, 3)


def test_kernel_operand_checks_accept_the_plane_and_check_rule_columns():
    lit, W, th, grp, pol = _good()
    assert cuda_match.kernel_operands(lit, W, th, grp, pol, 3) == (4, 256, 96)
    with pytest.raises(ValueError, match="thresh"):
        cuda_match.kernel_operands(lit, W, th[:-1], grp, pol, 3)
    with pytest.raises(TypeError, match="policy"):
        cuda_match.kernel_operands(lit, W, th, grp, pol.long(), 3)
    with pytest.raises(ValueError, match="n_groups"):
        cuda_match.kernel_operands(lit, W, th, grp, pol, cuda_match.MAX_GROUPS + 1)


def test_rule_tile_follows_the_grid():
    # the serving plane (R = 10240 rules) on a card of 132 SMs
    assert cuda_match.rule_tile(1, 10240, 132) == 64
    assert cuda_match.rule_tile(128, 10240, 132) == 64
    assert cuda_match.rule_tile(512, 10240, 132) == 128
    assert cuda_match.rule_tile(1024, 10240, 132) == 128
    assert cuda_match.rule_tile(4096, 10240, 132) == 256
    assert cuda_match.rule_tile(32768, 10240, 132) == 256
    # waves are counted in the card's own SMs
    assert cuda_match.rule_tile(1024, 10240, 66) == 256
    assert cuda_match.rule_tile(128, 10240, 16) == 128
    assert cuda_match.rule_tile(128, 10240, 10) == 256


def test_compiled_set_holds_one_plane():
    """One K-major plane per compiled set: W_dev is a view of Wt_dev, not a
    second copy."""
    arrays = _plane_arrays(np.random.default_rng(3), 200, 300, 1, False)
    cs = compiled_set_from_numpy(arrays, "cpu")
    assert "W_dev" not in vars(cs)
    W = cs.W_dev
    assert tuple(W.shape) == (cs.L, cs.R)
    assert W.untyped_storage().data_ptr() == cs.Wt_dev.untyped_storage().data_ptr()
    assert W.t().is_contiguous()
    planes = [v for v in vars(cs).values() if isinstance(v, torch.Tensor) and v.dtype == torch.int8]
    assert len(planes) == 1
