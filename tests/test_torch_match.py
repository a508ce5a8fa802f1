"""The port's match plane (cedar_tpu_torch/ops) against the JAX package.

The port's plain versions of the two fused match kernels must equal the
Pallas kernels (interpret mode on the CPU) bit for bit: first/last
matrices and packed verdict words. Every value is an exact integer, so the
tolerance is 0. Inputs come from seeded numpy and go to both frameworks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cedar_tpu.ops import match as jmatch
from cedar_tpu.ops.pallas_match import pallas_first_match, pallas_match_words
from cedar_tpu_torch.ops import cuda_match
from cedar_tpu_torch.ops import match as tmatch

INT32_MAX = 2**31 - 1


def _sparse_ruleset(rng, L, R, n_groups):
    """Sparse rules (1-2 positive literals, occasional negation) so random
    requests actually match, multi-match and hit error groups."""
    W = np.zeros((L, R), np.int8)
    for r in range(R):
        pos = rng.choice(L, size=int(rng.integers(1, 3)), replace=False)
        W[pos, r] = 1
        if rng.random() < 0.3:
            W[int(rng.integers(0, L)), r] = -1
    thresh = np.maximum((W > 0).sum(0), 1).astype(np.int32)
    group = rng.integers(0, n_groups, size=R).astype(np.int32)
    policy = rng.integers(0, 10000, size=R).astype(np.int32)
    return W, thresh, group, policy


def _lit(rng, B, L):
    active = rng.integers(0, L + 1, size=(B, 16))
    lit = np.zeros((B, L + 1), np.int8)
    np.put_along_axis(lit, active, 1, axis=1)
    return lit[:, :L]


def _jax_plane(plane, lit, W, thresh):
    if plane == "int8":
        return jnp.asarray(lit, jnp.int8), jnp.asarray(W, jnp.int8), jnp.asarray(thresh)[None, :]
    return (
        jnp.asarray(lit, jnp.bfloat16),
        jnp.asarray(W, jnp.bfloat16),
        jnp.asarray(thresh.astype(np.float32))[None, :],
    )


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("plane", ["int8", "bf16"])
@pytest.mark.parametrize(
    "B,L,R,G",
    [
        (256, 128, 512, 3),
        (256, 256, 1024, 6),  # multi-R-tile, two tiers
        (512, 128, 512, 3),  # multi-B-tile
        (256, 128, 512, 9),  # three tiers
    ],
)
def test_first_match_ref_equals_pallas_first_match(B, L, R, G, plane):
    rng = np.random.default_rng(B + L + R + G)
    W, thresh, group, policy = _sparse_ruleset(rng, L, R, G)
    lit = _lit(rng, B, L)
    jl, jW, jt = _jax_plane(plane, lit, W, thresh)
    j_first, j_last = pallas_first_match(
        jl, jW, jt, jnp.asarray(group)[None, :], jnp.asarray(policy)[None, :],
        G, interpret=True,
    )
    t_first, t_last = tmatch.first_match_ref(*_torch(lit, W, thresh, group, policy), G)
    assert t_first.dtype == torch.int32 and t_last.dtype == torch.int32
    np.testing.assert_array_equal(t_first.numpy(), np.asarray(j_first))
    np.testing.assert_array_equal(t_last.numpy(), np.asarray(j_last))
    # the random sets exercise matches and multi-policy groups
    assert (t_first != INT32_MAX).any() and (t_first != t_last).any()


@pytest.mark.parametrize("plane", ["int8", "bf16"])
@pytest.mark.parametrize(
    "B,L,R,T,gate",
    [
        (256, 128, 512, 1, False),
        (256, 256, 1024, 2, False),
        (256, 128, 512, 2, True),  # gate group rides bit 27
        (512, 128, 512, 3, False),
        (256, 128, 512, 3, True),
    ],
)
def test_match_words_ref_equals_pallas_match_words(B, L, R, T, gate, plane):
    n_groups = T * 3 + (1 if gate else 0)
    rng = np.random.default_rng(B + L + R + T)
    W, thresh, group, policy = _sparse_ruleset(rng, L, R, n_groups)
    lit = _lit(rng, B, L)
    jl, jW, jt = _jax_plane(plane, lit, W, thresh)
    j_words = np.asarray(
        pallas_match_words(
            jl, jW, jt, jnp.asarray(group)[None, :], jnp.asarray(policy)[None, :],
            T, gate, interpret=True,
        )
    )
    t_words = tmatch.match_words_ref(*_torch(lit, W, thresh, group, policy), T, gate)
    assert t_words.dtype == torch.int32
    t_host = tmatch.words_to_numpy(t_words)
    assert t_host.dtype == np.uint32
    np.testing.assert_array_equal(t_host, j_words)
    # the CPU wrapper is the plain version, word for word
    np.testing.assert_array_equal(
        tmatch.words_to_numpy(
            cuda_match.match_words(*_torch(lit, W, thresh, group, policy), T, gate)
        ),
        j_words,
    )
    # flags and codes 2/3 (bit 31) are exercised, not just allow/none
    assert ((t_host >> 28) & 3).any()
    assert ((t_host >> 31) & 1).any()
    if gate:
        assert ((t_host >> 27) & 1).any()


@pytest.mark.parametrize("T,gate", [(1, False), (2, True), (3, False)])
def test_tier_walk_equals_jax_tier_walk(T, gate):
    """The tier walk alone, on hand-shaped first/last rows covering every
    code, the err/multi flags and the gate bit."""
    rng = np.random.default_rng(7 + T)
    G = T * 3 + (1 if gate else 0)
    B = 512
    first = np.where(
        rng.random((B, G)) < 0.35, rng.integers(0, 50, (B, G)), INT32_MAX
    ).astype(np.int32)
    last = np.where(
        first == INT32_MAX, -1, first + (rng.random((B, G)) < 0.3) * rng.integers(1, 5, (B, G))
    ).astype(np.int32)
    ref = jmatch._tier_walk(jnp.asarray(first), jnp.asarray(last), T)
    if gate:
        ref = ref | ((jnp.asarray(first)[:, T * 3] != INT32_MAX).astype(jnp.uint32) << 27)
    ref = np.asarray(ref)
    out = tmatch.tier_walk(*_torch(first, last), T, gate)
    np.testing.assert_array_equal(tmatch.words_to_numpy(out), ref)
    # the same rows through the words entry point (the tier walk fused
    # after the match): literal b is row b's own, and each nonempty
    # (row, group) gets one rule for its first and one for its last policy
    rows, groups = np.nonzero(first != INT32_MAX)
    pols = np.concatenate([first[rows, groups], last[rows, groups]])
    rows, groups = np.tile(rows, 2), np.tile(groups, 2)
    W = np.zeros((B, rows.size), np.int8)
    W[rows, np.arange(rows.size)] = 1
    lit = np.eye(B, dtype=np.int8)
    thresh = np.ones(rows.size, np.int32)
    words = cuda_match.match_words(
        *_torch(lit, W, thresh, groups.astype(np.int32), pols.astype(np.int32)), T, gate
    )
    np.testing.assert_array_equal(tmatch.words_to_numpy(words), ref)


def test_word_with_bit31_survives_int32_transport():
    """Codes 2 (deny) and 3 (error) set bit 31: the int32 bit pattern must
    come back as the exact uint32 word, not a sign-extended or clipped
    value."""
    first = torch.tensor(
        [
            [INT32_MAX, 5, INT32_MAX],  # deny, policy 5
            [INT32_MAX, INT32_MAX, 0xABCDE],  # error, policy 0xABCDE
            [3, INT32_MAX, INT32_MAX],  # allow, policy 3
        ],
        dtype=torch.int32,
    )
    last = torch.where(first == INT32_MAX, torch.tensor(-1, dtype=torch.int32), first)
    last[0, 1] = 9  # multi in the deciding forbid group
    words = tmatch.words_to_numpy(tmatch.tier_walk(first, last, 1))
    assert words.dtype == np.uint32
    assert words[0] == (2 << 30) | (1 << 28) | 5
    assert words[1] == (3 << 30) | 0xABCDE
    assert words[2] == (1 << 30) | 3
    assert words[0] > 2**31 and words[1] > 2**31


@pytest.mark.parametrize("E", [0, 8])
def test_lit_matrix_codes_equals_jax(E):
    rng = np.random.default_rng(11 + E)
    B, S, V, L = 64, 6, 40, 256
    act_rows = (rng.random((V, L)) < 0.05).astype(np.uint8)
    act_rows[0] = 0  # code 0 gathers the all-zero row
    codes = rng.integers(0, V, size=(B, S)).astype(np.int32)
    codes[:, -1] = 0
    extras = rng.integers(0, L + 40, size=(B, max(E, 1))).astype(np.int32)
    extras = extras[:, :E] if E else np.zeros((B, 0), np.int32)
    ref = np.asarray(
        jmatch._lit_matrix_codes(
            jnp.asarray(codes), jnp.asarray(extras), jnp.asarray(act_rows), jnp.int8
        )
    )
    out = tmatch.lit_matrix_codes(*_torch(codes, extras, act_rows))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)
    if E:
        # extras at or past L are padding and activate nothing
        assert (extras >= L).any()


def test_bitset_plane_equals_match_rules_codes_bits():
    rng = np.random.default_rng(23)
    B, S, V, L, R = 40, 4, 32, 128, 512
    W, thresh, group, policy = _sparse_ruleset(rng, L, R, 3)
    thresh[-64:] = 10**9  # padding rules never match
    act_rows = (rng.random((V, L)) < 0.08).astype(np.uint8)
    act_rows[0] = 0
    codes = rng.integers(0, V, size=(B, S)).astype(np.int32)
    extras = rng.integers(0, L + 8, size=(B, 8)).astype(np.int32)
    W3, t3, g3, p3 = jmatch.chunk_rules(W, thresh, group, policy, chunk=128)
    ref = np.asarray(
        jmatch.match_rules_codes_bits(
            jnp.asarray(codes), jnp.asarray(extras), jnp.asarray(act_rows),
            jnp.asarray(W3), jnp.asarray(t3), jnp.asarray(g3), jnp.asarray(p3),
        )
    )
    out = tmatch.match_rules_codes_bits(*_torch(codes, extras, act_rows, W, thresh))
    host = out.numpy().view(np.uint32)
    assert host.shape == (B, R // 32)
    np.testing.assert_array_equal(host, ref)
    assert (host != 0).any()
    assert (host[:, -2:] == 0).all()


def test_pack_sat_bits_high_bit():
    """Rule 31 of each word sets bit 31: the word must read back as a
    uint32 above 2**31."""
    sat = torch.zeros((2, 64), dtype=torch.bool)
    sat[0, 31] = True
    sat[1, 0] = sat[1, 63] = True
    words = tmatch.pack_sat_bits(sat).numpy().view(np.uint32)
    assert words.tolist() == [[2**31, 0], [1, 2**31]]


def test_cuda_wrappers_reject_mixed_devices_and_bad_dtypes():
    lit = torch.zeros((4, 8), dtype=torch.int8)
    W = torch.zeros((8, 16), dtype=torch.int8)
    r = torch.zeros((16,), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_match.match_groups(lit, W, r, r, r.to("meta"), 3)
    # CPU tensors take the plain version and never count a launch
    cuda_match.reset_launch_counts()
    first, last = cuda_match.match_groups(lit, W, r + 1, r, r, 3)
    assert first.shape == (4, 3) and (first == INT32_MAX).all()
    cuda_match.match_words(lit, W, r + 1, r, r, 1)
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 0}
