"""The port's CUDA kernels on the card, against their plain versions.

Needs a CUDA device: every test is marked `cuda` and skips here with a
reason where there is none. This file imports neither jax nor cedar_tpu,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cedar_tpu_torch.engine.weights import k_major_plane, padded_literals
from cedar_tpu_torch.ops import cuda_match
from cedar_tpu_torch.ops import match as plain

INT32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest --noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _plane(rng, L, R, G, dev):
    """Sparse random rules on the card as the kernels take them: W is the
    [L_pad, R] view of the K-major plane Wt [R, L_pad]."""
    W = np.zeros((L, R), np.int8)
    n_pos = rng.choice([1, 2, 3], size=R, p=[0.1, 0.6, 0.3])
    for k in range(3):
        cols = np.nonzero(n_pos > k)[0]
        W[rng.integers(0, L, size=cols.size), cols] = 1
    neg = np.nonzero(rng.random(R) < 0.3)[0]
    rows = rng.integers(0, L, size=neg.size)
    keep = W[rows, neg] == 0
    W[rows[keep], neg[keep]] = -1
    thresh = np.maximum((W > 0).sum(0), 1).astype(np.int32)
    thresh[-max(R // 16, 1):] = 10**9  # padding rules never match
    group = rng.integers(0, G, size=R).astype(np.int32)
    policy = rng.integers(0, 5000, size=R).astype(np.int32)
    Wt = torch.from_numpy(k_major_plane(W)).to(dev)
    return [Wt.t()] + [torch.from_numpy(a).to(dev) for a in (thresh, group, policy)]


def _lit(rng, B, L, dev, active=20):
    lit = np.zeros((B, padded_literals(L)), np.int8)
    np.put_along_axis(lit, rng.integers(0, L, size=(B, active)), 1, axis=1)
    return torch.from_numpy(lit).to(dev)


# tile edges: rows around the 64-row warpgroup and 128-row CTA tile, L
# below / not a multiple of / far above one 128-literal stage, R at one
# rule tile, ragged and the serving plane's width; G 3, 4 (gate) and 9
TILE_EDGE = [
    (1, 64, 128, 1, False),
    (1, 6144, 10240, 1, True),
    (63, 200, 1000, 1, True),
    (64, 6144, 10240, 3, False),
    (65, 64, 1000, 1, True),
    (65, 6144, 128, 3, False),
    (129, 200, 128, 3, False),
    (129, 64, 10240, 1, False),
    (4096, 200, 1000, 3, False),
    (4096, 6144, 10240, 1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,R,T,gate", TILE_EDGE)
def test_kernels_equal_plain_versions(cuda, B, L, R, T, gate):
    rng = np.random.default_rng(B + L + R)
    G = plain.n_groups_of(T, gate)
    W, th, grp, pol = _plane(rng, L, R, G, cuda)
    lit = _lit(rng, B, L, cuda)
    cuda_match.reset_launch_counts()
    f_k, l_k = cuda_match.match_groups(lit, W, th, grp, pol, G)
    w_k = cuda_match.match_words(lit, W, th, grp, pol, T, gate)
    f_p, l_p = plain.first_match_ref(lit, W, th, grp, pol, G)
    torch.cuda.synchronize()
    assert torch.equal(f_k, f_p) and torch.equal(l_k, l_p)
    assert torch.equal(w_k, plain.tier_walk(f_p, l_p, T, gate))
    assert cuda_match.launch_counts() == {"match_groups_kernel": 1, "match_words_kernel": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,R", [(129, 200, 1000), (4096, 1024, 10240)])
def test_kernels_at_the_group_limit(cuda, B, L, R):
    """G = 32 (match_groups' limit) and 10 tiers with the gate (31 groups)
    for the words kernel."""
    rng = np.random.default_rng(B + R)
    W, th, grp, pol = _plane(rng, L, R, cuda_match.MAX_GROUPS, cuda)
    lit = _lit(rng, B, L, cuda, active=60)
    f_k, l_k = cuda_match.match_groups(lit, W, th, grp, pol, cuda_match.MAX_GROUPS)
    f_p, l_p = plain.first_match_ref(lit, W, th, grp, pol, cuda_match.MAX_GROUPS)
    assert torch.equal(f_k, f_p) and torch.equal(l_k, l_p)
    w_k = cuda_match.match_words(lit, W, th, grp, pol, 10, True)
    assert torch.equal(w_k, plain.match_words_ref(lit, W, th, grp, pol, 10, True))


@pytest.mark.cuda
def test_word_above_2_31_on_card(cuda):
    """Codes 2 (deny) and 3 (error) set bit 31: the kernel's words come
    back as the exact uint32 values."""
    L, R = 64, 128
    W = np.zeros((L, R), np.int8)
    W[0, 0] = 1  # literal 0 -> forbid rule, policy 5
    W[1, 1] = 1  # literal 1 -> error rule, policy 0xABCDE
    W[2, 2] = 1  # literal 2 -> permit rule, policy 3
    W[2, 3] = 1  # ... and a second permit, policy 9 (multi)
    thresh = np.full(R, 10**9, np.int32)
    thresh[:4] = 1
    group = np.array([1, 2, 0, 0] + [0] * (R - 4), np.int32)
    policy = np.array([5, 0xABCDE, 3, 9] + [INT32_MAX] * (R - 4), np.int32)
    lit = np.zeros((3, L), np.int8)
    lit[0, 0] = lit[1, 1] = lit[2, 2] = 1
    Wt = torch.from_numpy(k_major_plane(W)).to(cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (lit, thresh, group, policy)]
    words = cuda_match.match_words(args[0], Wt.t(), *args[1:], 1, False)
    host = plain.words_to_numpy(words)
    assert host.tolist() == [(2 << 30) | 5, (3 << 30) | 0xABCDE, (1 << 30) | (1 << 28) | 3]
    assert host[0] > 2**31 and host[1] > 2**31


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    lit = torch.zeros((4, 256), dtype=torch.int8, device=cuda)
    Wt = torch.zeros((96, 256), dtype=torch.int8, device=cuda)
    W = Wt.t()
    r = torch.ones((96,), dtype=torch.int32, device=cuda)
    for call in (
        lambda *a: cuda_match.match_groups(*a, 3),
        lambda *a: cuda_match.match_words(*a, 1, False),
    ):
        with pytest.raises(TypeError):
            call(lit.float(), W, r, r, r)
        with pytest.raises(ValueError):
            call(lit, W[:128], r, r, r)  # L disagrees with lit
        with pytest.raises(ValueError, match="K-major"):
            call(lit, W.contiguous(), r, r, r)  # [L, R] row-major: no transpose per call
        with pytest.raises(ValueError, match="multiple of 64"):
            call(lit[:, :200].contiguous(), Wt[:, :200].contiguous().t(), r, r, r)
        with pytest.raises(ValueError, match="aligned"):
            buf = torch.zeros((4 * 256 + 16,), dtype=torch.int8, device=cuda)
            call(buf[1 : 1 + 4 * 256].view(4, 256), W, r, r, r)
        with pytest.raises(ValueError):
            call(lit, W, r, r, r.cpu())  # mixed devices
    with pytest.raises(ValueError):
        cuda_match.match_groups(lit, W, r, r, r, cuda_match.MAX_GROUPS + 1)
    with pytest.raises(ValueError):
        cuda_match.match_words(lit, W, r, r, r, 11, False)  # 33 groups


@pytest.mark.cuda
def test_engine_on_card_equals_engine_on_cpu(cuda):
    """Decisions and reason sets equal the CPU engine's; the serving path
    is one match_words_kernel launch, want_full one match_groups_kernel
    launch and no words launch."""
    from cedar_tpu_torch.corpus.synth import coverage_corpus, synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine

    key = lambda r: (r[0], sorted(x.policy for x in r[1].reasons), sorted(r[1].errors))  # noqa: E731
    corpus = synth_corpus(400, seed=5, clusters=2)
    items = corpus.sar_items(300, seed=1)
    gpu, cpu = TorchPolicyEngine(), TorchPolicyEngine(device="cpu")
    assert gpu.device.type == "cuda"
    gpu.load(corpus.tiers())
    cpu.load(corpus.tiers())
    cuda_match.reset_launch_counts()
    got = gpu.evaluate_batch(items)
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 1}
    # the plane's TMA map was encoded once and is kept with the compiled set
    assert len(gpu.compiled_set.plane_maps) == 1
    want = cpu.evaluate_batch(items)
    assert [key(r) for r in got] == [key(r) for r in want]

    cov = coverage_corpus(per_family=2, base=16, seed=1)
    gpu, cpu = TorchPolicyEngine(), TorchPolicyEngine(device="cpu")
    gpu.load(cov.tiers())
    cpu.load(cov.tiers())
    assert gpu.compiled_set.fallback
    items = cov.items(160, seed=3)
    cuda_match.reset_launch_counts()
    got = gpu.evaluate_batch(items)
    assert cuda_match.launch_counts() == {"match_groups_kernel": 1, "match_words_kernel": 0}
    assert [key(r) for r in got] == [key(r) for r in cpu.evaluate_batch(items)]
