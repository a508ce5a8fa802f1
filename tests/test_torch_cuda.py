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


def _fast_paths(tiers):
    """SARFastPath over a card engine and over a CPU engine, one policy set."""
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import SARFastPath
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    stores = TieredPolicyStores([MemoryStore(f"t{i}", t) for i, t in enumerate(tiers)])
    out = []
    for device in (None, "cpu"):
        engine = TorchPolicyEngine(device=device)
        engine.load(tiers)
        authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
        out.append(SARFastPath(engine, authz))
    assert out[0].engine.device.type == "cuda"
    return out


# a tier in front of the synth corpus: two permits on (get, pods) and an
# interpreter-fallback policy (an alternation product past the lowering's
# clause ceiling), so multi-match, flagged and gated rows sit beside the
# synth traffic's clean ones
_EXTRA_TIER = """
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { resource.resource == "pods" };
permit (principal, action in [k8s::Action::"get", k8s::Action::"list"],
        resource is k8s::Resource)
  when { resource.resource == "pods" };
permit (principal in k8s::Group::"joiners", action == k8s::Action::"get",
        resource is k8s::Resource)
  when { """ + " && ".join(
    '(resource.resource == "widgets" || resource.name == "10.0.0.1")' for _ in range(12)
) + " };\n"


def _mixed_bodies(corpus, n, seed):
    import json

    bodies = corpus.sar_bodies(n, seed=seed)
    for i in range(0, n, 7):
        doc = json.loads(bodies[i])
        ra = doc["spec"]["resourceAttributes"]
        if i % 3 == 0:
            ra["resource"] = "pods"
            ra["verb"] = "get"
        elif i % 3 == 1:
            doc["spec"]["groups"] = ["joiners"]
            ra.update(verb="get", resource="widgets", name="10.0.0.1")
        else:
            doc["spec"]["user"] = "system:kube-scheduler"
        bodies[i] = json.dumps(doc).encode()
    return bodies + [b'{"not": "json', b"[]"]


@pytest.mark.cuda
def test_fastpath_on_card_equals_fastpath_on_cpu(cuda):
    """The same bodies through the fast path on the card and on the CPU:
    identical (decision, reason, error) triples, routed alike; the staging
    buffers are pinned on the card."""
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.lang import PolicySet

    corpus = synth_corpus(400, seed=5)
    tiers = [PolicySet.from_source(_EXTRA_TIER, "extra"), corpus.tiers()[0]]
    gpu, cpu = _fast_paths(tiers)
    bodies = _mixed_bodies(corpus, 900, seed=2)
    got = gpu.authorize_raw(bodies)
    assert got == cpu.authorize_raw(bodies)
    assert gpu.routing == cpu.routing
    assert gpu.routing["gated"] > 0 and gpu.routing["flagged"] > 0
    assert gpu.routing["encoder_gate"] > 0 and gpu.routing["encoder_fallback"] == 2
    pool = [a for bufs in gpu.engine._staging._free.values() for a in bufs]
    assert pool and all(torch.from_numpy(a).is_pinned() and a.base.is_pinned() for a in pool)
    assert gpu.engine.staging_stats()["pinned"] and gpu.engine.staging_stats()["outstanding"] == 0


@pytest.mark.cuda
def test_repeated_batches_give_identical_words(cuda):
    """The words come back through a non_blocking copy into pinned memory:
    reading before the copy lands would return stale words that differ
    from run to run. Twenty identical launches, back to back, agree with
    each other and with the CPU."""
    from cedar_tpu_torch.corpus.synth import synth_corpus

    corpus = synth_corpus(400, seed=6)
    gpu, cpu = _fast_paths(corpus.tiers())
    snap = gpu._current_snapshot()
    bodies = corpus.sar_bodies(3000, seed=4)
    codes, extras, _counts, flags = snap.encoder.encode_batch(bodies)
    assert (flags == 0).all()
    want = cpu.engine.match_arrays(codes, extras)[0]
    fins = [gpu.engine.match_arrays_launch(codes, extras) for _ in range(20)]
    for fin in fins:
        np.testing.assert_array_equal(fin()[0], want)
    first = gpu.authorize_raw(bodies)
    for _ in range(3):
        assert gpu.authorize_raw(bodies) == first


@pytest.mark.cuda
def test_fastpath_launches_as_predicted(cuda):
    """A batch of 1 is one words launch; 65536 bodies are five chunks
    (16384 x 3, then the last 16384 split in halves), five words launches;
    no first-match launch without gated rows."""
    from cedar_tpu_torch.corpus.synth import synth_corpus

    corpus = synth_corpus(400, seed=7)
    gpu, cpu = _fast_paths(corpus.tiers())
    bodies = corpus.sar_bodies(65536, seed=8)
    cuda_match.reset_launch_counts()
    one = gpu.authorize_raw(bodies[:1])
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 1}
    cuda_match.reset_launch_counts()
    got = gpu.authorize_raw(bodies)
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 5}
    assert got[:1] == one
    assert got[::97] == cpu.authorize_raw(bodies[::97])


@pytest.mark.cuda
def test_webhook_server_on_card_equals_cpu_engine(cuda):
    """The port's WebhookServer in-process on the card, behind its
    pipelined batcher: a few hundred synth SARs (gated, flagged and
    malformed rows among them) from 32 client threads answer as the CPU engine's fast path does, and
    both kernels were launched by the server's traffic."""
    import http.client
    import json
    from concurrent.futures import ThreadPoolExecutor

    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.server.http import WebhookServer
    from cedar_tpu_torch.server.sar import sar_response

    corpus = synth_corpus(400, seed=9)
    gpu, cpu = _fast_paths([PolicySet.from_source(_EXTRA_TIER, "extra"), corpus.tiers()[0]])
    bodies = _mixed_bodies(corpus, 384, seed=10)
    srv = WebhookServer(gpu.authorizer, address="127.0.0.1", port=0, metrics_port=0,
                        fastpath=gpu, pipeline_depth=2, request_timeout_s=60.0)
    srv.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", srv.bound_port, timeout=60)
        try:
            conn.request("POST", "/v1/authorize", body=body)
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    try:
        post(bodies[1])  # the kernels' library loads on the first launch
        cuda_match.reset_launch_counts()
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(post, bodies))
        launches = cuda_match.launch_counts()
    finally:
        srv.stop()
    want = [json.loads(json.dumps(sar_response(*r))) for r in cpu.authorize_raw(bodies)]
    assert got == want
    assert launches["match_words_kernel"] > 0 and launches["match_groups_kernel"] > 0
    assert srv.metrics.fallback_batches_total.value(path="authorization", reason="evaluator_error") == 0


@pytest.mark.cuda
def test_decision_cache_hits_launch_no_kernel(cuda):
    """The WebhookServer on the card with a DecisionCache over the
    engine's shard lineage (the CLI's wiring): each distinct SAR misses
    once and its batch launches match_words_kernel; every repeat answers
    from the cache with no kernel launch; hits and misses answer as the
    CPU engine's fast path does."""
    import http.client
    import json

    from cedar_tpu_torch.cache import DecisionCache, plane_composite
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.server.http import WebhookServer
    from cedar_tpu_torch.server.sar import sar_response

    corpus = synth_corpus(400, seed=9)
    gpu, cpu = _fast_paths([PolicySet.from_source(_EXTRA_TIER, "extra"), corpus.tiers()[0]])
    bodies = [b for b in _mixed_bodies(corpus, 96, seed=12) if b.startswith(b"{\"")][:64]
    cache = DecisionCache(generation_fn=lambda: plane_composite(gpu.authorizer.stores, gpu.engine))
    srv = WebhookServer(gpu.authorizer, address="127.0.0.1", port=0, metrics_port=0,
                        fastpath=gpu, pipeline_depth=2, request_timeout_s=60.0,
                        decision_cache=cache)
    srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.bound_port, timeout=60)

    def post(body):
        conn.request("POST", "/v1/authorize", body=body)
        return json.loads(conn.getresponse().read())

    try:
        warm = _mixed_bodies(corpus, 1, seed=13)[0]
        post(warm)  # the kernels' library loads
        cuda_match.reset_launch_counts()
        first = [post(b) for b in bodies]
        miss_launches = cuda_match.launch_counts()
        cuda_match.reset_launch_counts()
        again = [post(b) for b in bodies]
        hit_launches = cuda_match.launch_counts()
        stats = cache.stats()
    finally:
        conn.close()
        srv.stop()
    want = [json.loads(json.dumps(sar_response(*r))) for r in cpu.authorize_raw(bodies)]
    assert first == want and again == want
    assert miss_launches["match_words_kernel"] > 0
    assert hit_launches == {"match_groups_kernel": 0, "match_words_kernel": 0}
    from cedar_tpu_torch.cache import fingerprint_body

    distinct = {fingerprint_body("authorize", b) for b in bodies}
    keys = distinct | {fingerprint_body("authorize", warm)}
    assert stats["size"] == stats["misses"] == len(keys)
    assert stats["hits"] == 2 * len(bodies) + 1 - len(keys)


@pytest.mark.cuda
def test_traced_miss_on_card_carries_the_batch_spans(cuda):
    """The WebhookServer on the card with a tracer at rate 1 and the
    decision cache: each miss's trace (under its X-Cedar-Trace-Id) holds
    cache.lookup and the four pipelined batch spans, in that order, each
    inside the root span, and the misses launched match_words_kernel; a
    repeat's trace holds cache.lookup alone and launches nothing."""
    import http.client
    import json

    from cedar_tpu_torch.cache import DecisionCache, fingerprint_body, plane_composite
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.obs import Tracer
    from cedar_tpu_torch.server.http import WebhookServer

    corpus = synth_corpus(400, seed=9)
    gpu, _cpu = _fast_paths([PolicySet.from_source(_EXTRA_TIER, "extra"), corpus.tiers()[0]])
    bodies, keys = [], set()
    for b in _mixed_bodies(corpus, 64, seed=14):
        key = fingerprint_body("authorize", b)
        if key is not None and key not in keys and len(bodies) < 16:
            keys.add(key)
            bodies.append(b)
    cache = DecisionCache(generation_fn=lambda: plane_composite(gpu.authorizer.stores, gpu.engine))
    tracer = Tracer(sample_rate=1.0, ring_capacity=64)
    srv = WebhookServer(gpu.authorizer, address="127.0.0.1", port=0, metrics_port=0,
                        fastpath=gpu, pipeline_depth=2, request_timeout_s=60.0,
                        decision_cache=cache, tracer=tracer)
    srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.bound_port, timeout=60)

    def post(body):
        conn.request("POST", "/v1/authorize", body=body)
        resp = conn.getresponse()
        resp.read()
        return resp.getheader("X-Cedar-Trace-Id")

    try:
        post(_mixed_bodies(corpus, 1, seed=15)[0])  # the kernels' library loads
        cuda_match.reset_launch_counts()
        misses = [post(b) for b in bodies]
        miss_launches = cuda_match.launch_counts()
        cuda_match.reset_launch_counts()
        hits = [post(b) for b in bodies]
        hit_launches = cuda_match.launch_counts()
    finally:
        conn.close()
        srv.stop()
    assert miss_launches["match_words_kernel"] > 0
    assert hit_launches == {"match_groups_kernel": 0, "match_words_kernel": 0}
    for tid in misses:
        doc = tracer.get(tid)
        names = [s["name"] for s in doc["spans"]]
        assert names == ["authorization", "cache.lookup", "batch.queue_wait", "batch.encode",
                         "batch.dispatch", "batch.decode"], names
        for s in doc["spans"][1:]:
            assert 0.0 <= s["start_us"] and s["start_us"] + s["duration_us"] <= (
                doc["duration_us"] + 0.2), s
        dispatch = doc["spans"][4]
        assert dispatch["duration_us"] > 0
    for tid in hits:
        assert [s["name"] for s in tracer.get(tid)["spans"]] == ["authorization", "cache.lookup"]


@pytest.mark.cuda
def test_engine_warmup_launches_per_bucket(cuda):
    """warmup(128) takes buckets 1, 8, 32 and 128: per bucket one words
    launch, one groups launch (want_full) and one words launch with the
    in-launch bitset compaction. They count into the engine's
    warmup_launches, not into the served launch counts; the answers after
    it equal the CPU engine's."""
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine

    key = lambda r: (r[0], sorted(x.policy for x in r[1].reasons), sorted(r[1].errors))  # noqa: E731
    corpus = synth_corpus(400, seed=5, clusters=2)
    gpu, cpu = TorchPolicyEngine(), TorchPolicyEngine(device="cpu")
    gpu.load(corpus.tiers())
    cpu.load(corpus.tiers())
    cuda_match.reset_launch_counts()
    want_launches = {"match_groups_kernel": 4, "match_words_kernel": 8}
    assert gpu.warmup(128) == want_launches
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 0}
    assert gpu.stats["warmup_launches"] == want_launches
    items = corpus.sar_items(300, seed=1)
    assert [key(r) for r in gpu.evaluate_batch(items)] == [key(r) for r in cpu.evaluate_batch(items)]


def _admission_paths(n_policies: int = 400, seed: int = 11):
    """(card, cpu) AdmissionFastPath pairs over one admission stack: a
    synth corpus and the admission policies of chip_smoke.py's phase 9
    (the interpreter-fallback forbid among them, so rows gate), plus the
    allow-all final tier."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import AdmissionFastPath
    from cedar_tpu_torch.server.admission import (
        CedarAdmissionHandler,
        allow_all_admission_policy_store,
    )
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    src = (chip_smoke.ADM_POLICIES + chip_smoke.ADM_DEMO_OWNER_POLICY
           + chip_smoke.ADM_FALLBACK_POLICY)
    stores = TieredPolicyStores([
        MemoryStore("synth", synth_corpus(n_policies, seed=seed).tiers()[0]),
        MemoryStore.from_source("admission", src),
        allow_all_admission_policy_store(),
    ])
    out = []
    for device in ("cuda", "cpu"):
        engine = TorchPolicyEngine(device=device)
        engine.load([s.policy_set() for s in stores])
        handler = CedarAdmissionHandler(stores, evaluate_batch=engine.evaluate_batch)
        out.append(AdmissionFastPath(engine, handler))
    return (*out, chip_smoke.admission_bodies)


@pytest.mark.cuda
def test_admission_fastpath_on_card_equals_cpu(cuda):
    """AdmissionFastPath on the card answers the generated AdmissionReview
    bodies (gated, flagged, namespace-skipped and Python-path rows among
    them) exactly as the same fast path over the CPU's plain versions,
    and launches both kernels."""
    gpu, cpu, bodies_of = _admission_paths()
    bodies = bodies_of(2048, 21)
    cuda_match.reset_launch_counts()
    got = [r.to_admission_review() for r in gpu.handle_raw(bodies)]
    launches = cuda_match.launch_counts()
    assert got == [r.to_admission_review() for r in cpu.handle_raw(bodies)]
    assert launches["match_words_kernel"] > 0 and launches["match_groups_kernel"] > 0
    assert all(gpu.routing[k] > 0 for k in ("gated", "flagged", "encoder_fallback", "encoder_gate"))


@pytest.mark.cuda
def test_admit_server_on_card_launches_both_kernels(cuda):
    """The port's WebhookServer serving /v1/admit in-process on the card
    behind its pipelined batcher: bodies from 32 client threads answer as
    the CPU fast path does, with both kernels launched by the traffic and
    no fallback batch."""
    import http.client
    import json
    from concurrent.futures import ThreadPoolExecutor

    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.server.http import WebhookServer

    gpu, cpu, bodies_of = _admission_paths(seed=12)
    bodies = bodies_of(512, 22)
    srv = WebhookServer(CedarWebhookAuthorizer(gpu.handler.stores), address="127.0.0.1",
                        port=0, metrics_port=0, pipeline_depth=2, request_timeout_s=60.0,
                        admission_handler=gpu.handler, admission_fastpath=gpu)
    srv.start()

    def post(body):
        conn = http.client.HTTPConnection("127.0.0.1", srv.bound_port, timeout=60)
        try:
            conn.request("POST", "/v1/admit", body=body)
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    try:
        post(bodies[1])  # the kernels' library loads on the first launch
        cuda_match.reset_launch_counts()
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(post, bodies))
        launches = cuda_match.launch_counts()
    finally:
        srv.stop()
    assert got == [r.to_admission_review() for r in cpu.handle_raw(bodies)]
    assert launches["match_words_kernel"] > 0 and launches["match_groups_kernel"] > 0
    assert srv.metrics.fallback_batches_total.value(path="admission", reason="evaluator_error") == 0


@pytest.mark.cuda
def test_reload_publishes_a_warmed_plane(cuda):
    """A reload on the card (TorchPolicyEngine.load with max_batch, as
    the webhook's reloader calls it) publishes a set that is already
    warm: its float plane W_f32 exists and its TMA maps are encoded, the
    warm-up's launches counted apart from the served ones, so the first
    served call on it encodes no map and answers as the CPU engine; the
    old set is released once nothing serves from it."""
    import gc
    import weakref

    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.lang import PolicySet

    key = lambda r: (r[0], sorted(x.policy for x in r[1].reasons), sorted(r[1].errors))  # noqa: E731
    corpus = synth_corpus(400, seed=6)
    gpu, cpu = TorchPolicyEngine(), TorchPolicyEngine(device="cpu")
    gpu.load(corpus.tiers(), max_batch=128)
    old = weakref.ref(gpu.compiled_set)
    tiers = [PolicySet.from_source(_EXTRA_TIER, "extra"), corpus.tiers()[0]]
    cuda_match.reset_launch_counts()
    stats = gpu.load(tiers, max_batch=128)
    cpu.load(tiers)
    assert gpu.load_generation == 2 and stats["compile_seconds"]["warm"] > 0
    cs = gpu.compiled_set
    assert cs._W_f32 is not None and cs.plane_maps
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 0}
    maps = dict(cs.plane_maps)
    items = corpus.sar_items(64, seed=2)
    assert [key(r) for r in gpu.evaluate_batch(items)] == [key(r) for r in cpu.evaluate_batch(items)]
    assert cs.plane_maps == maps
    assert cuda_match.launch_counts()["match_groups_kernel"] + \
        cuda_match.launch_counts()["match_words_kernel"] > 0
    gc.collect()
    assert old() is None


@pytest.mark.cuda
def test_rebuild_compiled_on_the_10k_plane(cuda):
    """The device-loss rebuild on the card, at the serving plane's size:
    the set is re-placed into new allocations with its own TMA maps (none
    carried over from the old set's plane), warmed before it is
    published; both kernels are bit-equal to their plain versions on the
    rebuilt plane, the engine's answers equal the CPU engine's, and the
    old set's memory is freed (the allocator stays within one plane)."""
    import gc
    import weakref

    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine

    key = lambda r: (r[0], sorted(x.policy for x in r[1].reasons), sorted(r[1].errors))  # noqa: E731
    corpus = synth_corpus(10000, seed=0)
    gpu, cpu = TorchPolicyEngine(), TorchPolicyEngine(device="cpu")
    gpu.load(corpus.tiers(), max_batch=128)
    cpu.load(corpus.tiers())
    old = gpu.compiled_set
    old_maps = set(old.plane_maps)
    old_ptr = old.Wt_dev.data_ptr()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    plane = old.device_bytes
    gen = gpu.load_generation
    cuda_match.reset_launch_counts()
    stats = gpu.rebuild_compiled(max_batch=128)
    assert cuda_match.launch_counts() == {"match_groups_kernel": 0, "match_words_kernel": 0}
    new = gpu.compiled_set
    assert stats["generation"] == gen + 1 and gpu.load_generation == gen + 1
    assert new.Wt_dev.data_ptr() != old_ptr and new.plane_maps and new._W_f32 is not None
    assert not (set(new.plane_maps) & old_maps)
    assert all(k[0] == new.Wt_dev.data_ptr() for k in new.plane_maps)
    ref = weakref.ref(old)
    del old
    gc.collect()
    torch.cuda.synchronize()
    assert ref() is None
    assert torch.cuda.memory_allocated() - before <= plane
    # both kernels against their plain versions on the rebuilt plane
    rng = np.random.default_rng(11)
    codes = rng.integers(0, new.act_rows_dev.shape[0], size=(64, new.packed.table.n_slots),
                         dtype=np.int32)
    extras = np.full((64, 1), new.L, dtype=np.int32)
    lit = plain.lit_matrix_codes(torch.from_numpy(codes).to(cuda),
                                 torch.from_numpy(extras).to(cuda), new.act_rows_dev)
    ops = (new.W_dev, new.thresh_dev, new.rule_group_dev, new.rule_policy_dev)
    cpu_ops = [t.cpu() for t in ops]
    w_k = cuda_match.match_words(lit, *ops, new.n_tiers, new.has_gate, plane_maps=new.plane_maps)
    w_p = cuda_match.match_words(lit.cpu(), *cpu_ops, new.n_tiers, new.has_gate)
    assert torch.equal(w_k.cpu(), w_p)
    f_k, l_k = cuda_match.match_groups(lit, *ops, new.n_groups, plane_maps=new.plane_maps)
    f_p, l_p = cuda_match.match_groups(lit.cpu(), *cpu_ops, new.n_groups)
    assert torch.equal(f_k.cpu(), f_p) and torch.equal(l_k.cpu(), l_p)
    items = corpus.sar_items(256, seed=4)
    assert [key(r) for r in gpu.evaluate_batch(items)] == [key(r) for r in cpu.evaluate_batch(items)]


_STICKY_FAULT = r"""
import json
import torch
from cedar_tpu_torch.corpus.synth import synth_corpus
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.server.supervisor import DeviceRecovery, is_fatal_device_error

engine = TorchPolicyEngine()
engine.load(synth_corpus(200, seed=1).tiers(), max_batch=8)
out = {"raised": None}
try:
    x = torch.zeros(4, device="cuda")
    x[torch.tensor([1 << 20], device="cuda")] += 1  # out of range: a device-side assert
    torch.cuda.synchronize()
except Exception as e:
    out["raised"] = f"{type(e).__name__}: {e}"[:400]
    out["fatal"] = is_fatal_device_error(e)
try:
    engine.rebuild_compiled(max_batch=8)
    out["rebuild"] = "ok"
except Exception as e:
    out["rebuild"] = f"{type(e).__name__}: {e}"[:400]
    out["rebuild_fatal"] = is_fatal_device_error(e)
rec = DeviceRecovery(engine, name="sticky", warm_max_batch=8)
out["recovery"] = [rec.rebuild_now(), rec.rebuilds, rec.failures]
print("RESULT " + json.dumps(out))
"""


@pytest.mark.cuda
def test_sticky_fault_is_fatal_and_the_rebuild_fails(cuda):
    """A real sticky fault, in a subprocess (it poisons the CUDA context
    for the life of the process): the raised error classifies as fatal,
    and a following rebuild raises, so DeviceRecovery counts a failure
    and leaves the breaker open; nothing in-process can recover it."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _STICKY_FAULT], env=env, cwd=str(repo),
                          capture_output=True, text=True, timeout=600)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert lines, proc.stdout[-2000:] + proc.stderr[-4000:]
    out = json.loads(lines[-1][len("RESULT "):])
    print(out)
    assert out["raised"] and out["fatal"] is True, out
    assert out["rebuild"] != "ok", out
    assert out["recovery"] == [False, 0, 1], out


@pytest.mark.cuda
def test_incremental_reload_on_the_card_equals_a_full_load(cuda):
    """An incremental reload on the card (one policy edited, re-lowered
    alone: a one-policy Policy object's edit) publishes a warmed plane
    whose verdict words and first/last matrices equal those of a full
    load of the same corpus on the card, bit for bit, and both kernels
    launch on the swapped plane."""
    from cedar_tpu_torch.compiler.table import encode_request_codes
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine

    corpus = synth_corpus(2000, seed=5)
    edited = corpus.with_edit()
    inc = TorchPolicyEngine(incremental=True, shard_buckets=64)
    full = TorchPolicyEngine()
    inc.load(corpus.tiers(), max_batch=128)
    stats = inc.load(edited.tiers(), max_batch=128)
    full.load(edited.tiers(), max_batch=128)
    assert (stats["compile_scope"], stats["dirty_shards"]) == ("incremental", 1)
    assert stats["compile_seconds"]["warm"] > 0
    a, b = inc.compiled_set, full.compiled_set
    assert (a.L, a.R) == (b.L, b.R)
    items = corpus.sar_items(256, seed=3) + [edited.probe_request()]
    enc = [encode_request_codes(a.packed.plan, a.packed.table, em, r) for em, r in items]
    codes, extras = inc._encode_batch_arrays(a, enc, len(enc))
    cuda_match.reset_launch_counts()
    w_inc, _ = inc.match_arrays(codes, extras)
    _, (f_inc, l_inc) = inc.match_arrays(codes, extras, want_full=True)
    launched = cuda_match.launch_counts()
    w_full, _ = full.match_arrays(codes, extras)
    _, (f_full, l_full) = full.match_arrays(codes, extras, want_full=True)
    np.testing.assert_array_equal(w_inc, w_full)
    np.testing.assert_array_equal(f_inc, f_full)
    np.testing.assert_array_equal(l_inc, l_full)
    assert launched["match_words_kernel"] >= 1 and launched["match_groups_kernel"] >= 1
    assert inc.evaluate(*edited.probe_request())[0] == "deny"


@pytest.mark.cuda
def test_partial_gate_on_the_card_equals_plain_versions(cuda):
    """The gated synth set loaded on the card under validationMode
    partial: the gate drops the interpreter-fallback policy (and only
    it), and the trimmed plane's verdict words and first/last matrices on
    the card equal the plain versions' (a CPU engine over the same
    trimmed tiers) bit for bit, with both kernels launched."""
    from cedar_tpu_torch.compiler.table import encode_request_codes
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    fallback = (
        'permit (principal in k8s::Group::"joiners", action == k8s::Action::"get",\n'
        "        resource is k8s::Resource)\n  when { "
        + " && ".join('(resource.resource == "widgets" || resource.name == "10.0.0.1")'
                      for _ in range(12))
        + " };\n"
    )
    opaque = ('forbid (principal, action == k8s::Action::"deletecollection", '
              "resource is k8s::Resource)\n"
              "  when { resource has name && ip(resource.name).isLoopback() };\n")
    corpus = synth_corpus(2000, seed=5)
    extra = PolicySet.from_source(fallback + opaque, "gated")
    gated = PolicySet(list(corpus.policies) + extra.policies())
    stores = TieredPolicyStores([MemoryStore("gated", gated)], validation_mode="partial")
    (tier,) = stores.analyzed_policy_sets()
    assert len(tier) == len(gated) - 1
    assert {f.code for f in stores.last_analysis.blocking()} == {"clause_limit"}
    gpu, cpu = TorchPolicyEngine(), TorchPolicyEngine(device="cpu")
    gpu.load([tier], max_batch=128)
    cpu.load([tier])
    a = gpu.compiled_set
    assert a.fallback == [] and (a.L, a.R) == (cpu.compiled_set.L, cpu.compiled_set.R)
    items = corpus.sar_items(256, seed=3)
    enc = [encode_request_codes(a.packed.plan, a.packed.table, em, r) for em, r in items]
    codes, extras = gpu._encode_batch_arrays(a, enc, len(enc))
    cuda_match.reset_launch_counts()
    w_gpu, _ = gpu.match_arrays(codes, extras)
    _, (f_gpu, l_gpu) = gpu.match_arrays(codes, extras, want_full=True)
    launched = cuda_match.launch_counts()
    w_cpu, _ = cpu.match_arrays(codes, extras)
    _, (f_cpu, l_cpu) = cpu.match_arrays(codes, extras, want_full=True)
    np.testing.assert_array_equal(w_gpu, w_cpu)
    np.testing.assert_array_equal(f_gpu, f_cpu)
    np.testing.assert_array_equal(l_gpu, l_cpu)
    assert launched["match_words_kernel"] >= 1 and launched["match_groups_kernel"] >= 1


@pytest.mark.cuda
def test_tuner_grows_a_card_batcher_to_its_warmed_clamp(cuda):
    """An SLO-adaptive tuner over a card engine's pipelined batcher, the
    engine warmed up to the tuner's clamp (4096) as the CLI warms it:
    with dispatch held, 2,304 submitted requests are the backlog, and six
    ticks at no burn grow max_batch 64 -> 4096. Released, the next claim
    takes the rest in one batch; every answer equals the CPU engine's,
    and no batch met a bucket above the warmed top."""
    import threading
    import time

    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.engine.batcher import PipelinedBatcher
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.load import AdaptiveBatchTuner, TuningBounds
    from cedar_tpu_torch.obs.slo import SLOTracker

    corpus = synth_corpus(400, seed=5)
    tiers = [PolicySet.from_source(_EXTRA_TIER, "extra"), corpus.tiers()[0]]
    gpu, cpu = _fast_paths(tiers)
    gpu.engine.warmup(4096)
    assert gpu.engine.warm_buckets == (1, 8, 32, 128, 512, 1024, 2048, 4096)
    gate = threading.Event()

    class Held:
        def pipeline_encode(self, items):
            return gpu.pipeline_encode(items)

        def pipeline_dispatch(self, ctx):
            gate.wait(120)
            return gpu.pipeline_dispatch(ctx)

        def pipeline_decode(self, ctx):
            return gpu.pipeline_decode(ctx)

        def pipeline_discard(self, ctx):
            gpu.pipeline_discard(ctx)

    batcher = PipelinedBatcher(Held(), max_batch=64, window_s=0.0002, depth=2, encode_workers=2)
    tuner = AdaptiveBatchTuner(batcher, SLOTracker(), bounds=TuningBounds(min_batch=64,
                                                                          max_batch=4096))
    bodies = _mixed_bodies(corpus, 2302, seed=3)
    results = [None] * len(bodies)

    def one(i):
        results[i] = batcher.submit(bodies[i], timeout=120.0)

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(len(bodies))]
    try:
        for th in threads:
            th.start()
        deadline = time.monotonic() + 60
        while batcher.backlog() < len(bodies) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert batcher.backlog() == len(bodies)
        # (a seventh tick would see the backlog within the batch and decay
        # home: the grown knob is released at once)
        moves = [tuner.tick() for _ in range(6)]
        assert [(d["param"], d["from"], d["to"]) for d in moves] == [
            ("max_batch", 64 * 2**k, 128 * 2**k) for k in range(6)]
        assert batcher.max_batch == 4096
        gate.set()
        for th in threads:
            th.join(120)
    finally:
        gate.set()
        batcher.stop()
    assert results == cpu.authorize_raw(bodies)
    assert batcher.backlog() == 0
    assert 64 < batcher.debug_stats()["largest_batch"] <= 4096
    assert max(gpu.engine.staging_stats()["buckets"]) <= 4096


# the explain plane's test policies (tests/test_torch_explain.py): two
# overlapping pods permits, a forbid, an admission forbid on a label, and
# an interpreter-fallback permit of every pods SAR
EXPLAIN_POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name == "alice" && resource.resource == "pods" };
forbid (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name == "carol" && resource.resource == "secrets" };
permit (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal is k8s::User, action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when { resource.metadata has labels &&
         resource.metadata.labels.contains({key: "env", value: "prod"}) };
""" + "permit (principal, action, resource) when { " + " && ".join(
    f'(resource.resource == "pods" || resource.name == "z{i}")' for i in range(12)) + " };"


@pytest.mark.cuda
def test_explain_on_card_equals_cpu(cuda):
    """256 SARs and 128 AdmissionReviews explained by a card engine and by
    a CPU engine over the same stacks: equal answers and explanations,
    the card's labelled ``device`` (or the gate it met); the explain plane
    is the plain bits product, so the served launch counts of both
    kernels do not move."""
    import json
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.explain import Explainer
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.server.admission import (
        CedarAdmissionHandler,
        allow_all_admission_policy_store,
    )
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    src = EXPLAIN_POLICIES + chip_smoke.ADM_POLICIES + chip_smoke.ADM_FALLBACK_POLICY
    stores = TieredPolicyStores([MemoryStore("explain", PolicySet.from_source(src, "explain"))])
    adm_stores = TieredPolicyStores(list(stores.stores) + [allow_all_admission_policy_store()])
    explainers = []
    for device in ("cuda", "cpu"):
        engine = TorchPolicyEngine(device=device, name="authorization")
        engine.load([s.policy_set() for s in stores], max_batch=1)
        adm = TorchPolicyEngine(device=device, name="admission")
        adm.load([s.policy_set() for s in adm_stores], max_batch=1)
        explainers.append(Explainer(
            authorizer=CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch),
            admission_handler=CedarAdmissionHandler(adm_stores, evaluate_batch=adm.evaluate_batch),
            authz_engine=engine, admission_engine=adm))
    users, resources = ["alice", "bob", "carol", "dave"], ["pods", "secrets", "services", "nodes"]
    sars = [json.dumps({"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
                        "spec": {"user": users[i % 4], "groups": [],
                                 "resourceAttributes": {"verb": ("get", "list")[i // 128],
                                                        "resource": resources[(i // 4) % 4],
                                                        "namespace": f"ns-{i % 7}",
                                                        "name": f"z{i % 13}"}}}).encode()
            for i in range(256)]
    reviews = chip_smoke.admission_bodies(128, 23)
    before = cuda_match.launch_counts()
    sources = {}
    for path, bodies in (("authorize", sars), ("admit", reviews)):
        for body in bodies:
            if path == "authorize":
                got, want = (list(e.explain_authorize(body)) for e in explainers)
            else:
                (rg, eg), (rw, ew) = (e.explain_admit(body) for e in explainers)
                got, want = [rg.to_admission_review(), eg], [rw.to_admission_review(), ew]
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), body
            sources[got[-1]["source"]] = sources.get(got[-1]["source"], 0) + 1
    assert set(sources) <= {"device", "gate"} and sources["device"] > 300, sources
    assert cuda_match.launch_counts() == before
