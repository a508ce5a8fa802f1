#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cedar_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0] [--policies 10000] [--sars 300]

Phases, each a hard failure with a nonzero exit:

  1. card: name and power limit (nvidia-smi).
  2. build: the match kernels from cedar_tpu_torch/csrc with nvcc (sm_90a);
     prints ptxas's register and spill lines and the count of
     warpgroup-MMA instructions (IGMMA) in the library's SASS, which must
     be above 0 (the kernels run on the tensor cores).
  3. kernel parity: match_groups_kernel and match_words_kernel against
     their plain PyTorch versions on the card, bit for bit, on random
     sparse rule sets at L = 1024, R = 10240 (B in 8 / 128 / 1024 / 4096,
     G in 3 / 4 with gate / 9 for three tiers), plus ragged B, L and R
     (B = 100, 65 and 1, L = 1000 and 200, R = 10000 and 1000).
  4. serving path: a synthesized 10k-policy corpus loaded on the card;
     SubjectAccessReview bodies answered through the port's authorizer
     (launch counts reset just before, read just after: one
     match_words_kernel launch per chunk, no match_groups_kernel); every
     decision and reason set held against the port's interpreter (0
     flips); decisions/s and batch latency at batch 1 / 128 / 4096. Both
     kernels are then held against their plain versions, bit for bit, on
     the serving plane itself: the padded batch just served (its 512
     bucket) and rows of the batch-4096 traffic at B = 4096, 128, 32, 8
     and 1 (the buckets the timed batches and small requests take; below
     128 rows each is its own lit box of B rounded up to 8).
  4b. fast path: the same corpus served from raw SAR bytes through
     engine/fastpath.py SARFastPath (the C++ encoder built with g++, pinned
     staging, one asynchronous match_words_kernel launch per pipeline
     chunk, one packed D2H) over the phase's 300 bodies, its batch-4096
     bodies and 65536 more; launch counts reset before and read after each
     batch ({words 1, groups 0} up to 16384 rows; at 65536 five words
     launches: chunks of 16384 x 3 + 8192 x 2); routing counts (encoder_fallback held to the CPU
     test's count at the defaults); staging stats; every answer held
     against the authorizer path and, in spawned worker processes, the
     interpreter (0 flips); decisions/s and batch latency at batch 1 /
     128 / 4096 / 65536 beside the authorizer path's; the encode / device
     / decode split of a batch-1, a batch-4096 and a batch-65536 answer
     (--profile: the device's idle share and top kernels over each). Both kernels held
     against their plain versions on a native-encoded 16384-row chunk.
     Gated sub-phase: the corpus plus an interpreter-fallback and a
     native-opaque policy, traffic that hits their scopes: gated rows re-run
     through evaluate_batch (match_groups_kernel), the rest take the words
     launch; 0 flips; both kernels held against their plain versions on
     that plane.
  5. want_full path: a set with interpreter-fallback policies (the
     coverage corpus' blowup family) served through match_groups_kernel
     (counts reset just before, read just after; match_words_kernel never
     launched), 0 flips; both kernels held against their plain versions on
     that plane and batch.
  6. diagnostics: a request matching two permits comes back through
     resolve_flagged with both reasons.
  7. timing: each kernel at the serving plane's shape (B = 4096, 128 and
     1) and at L = 1024 (B = 4096 and 128), beside its plain version, its
     bound and two library yardsticks (float32 torch.matmul, and
     torch._int_mm, the same int8 contraction without the epilogue, where
     its shape rules allow: B > 16). A kernel's "ms" is its wrapper called
     back to back (the host's cost per call included where it is the
     slower side); "device_ms" the same calls replayed from a CUDA graph.
     Then a rule-tile probe: match_groups_kernel's device time at B = 4096
     on both planes with the tile forced to 64, 128 and 256 rules (the
     choice cuda_match.rule_tile makes from the grid size).

Prints the card line, then one {"kernels": [...]} line, then, last,
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when
CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

INT32_MAX = 2**31 - 1
# published H100 SXM peaks (700 W): HBM bytes/s and dense int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of one fn() over `iters` back-to-back calls (CUDA
    events, after warm-up; inputs stay L2-resident as in steady serving)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_gmma_count(lib_path) -> dict:
    """Warpgroup-MMA instructions in the built library's SASS, by opcode
    (IGMMA is the integer one), from the toolkit's cuobjdump."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()[:500]}")
    ops = {}
    for line in out.stdout.splitlines():
        for tok in line.replace(";", " ").split():
            if "GMMA" in tok:
                op = tok.split(".")[0]
                ops[op] = ops.get(op, 0) + 1
    return ops


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of one fn() with the host out of the way: `iters` calls
    captured in one CUDA graph and replayed once (CUDA events). fn's
    allocations come from the graph's pool; its launches are counted once,
    at capture."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_plane(torch, rng, L, R, G, n_pad=0):
    """Sparse random rules (mostly 2-3 positive literals, a few with one,
    occasional negation) so a row matches a handful of rules: groups with
    no, one and several matched policies all occur. The last n_pad columns
    are padding (thresh 1e9, policy INT32_MAX). On the card as the kernels
    take them: W is the [L_pad, R] view of the K-major plane Wt [R, L_pad]
    (L padded to a multiple of 64 with zero columns, as for a hand-built
    plane)."""
    from cedar_tpu_torch.engine.weights import k_major_plane

    W = np.zeros((L, R), np.int8)
    n_pos = rng.choice([1, 2, 3], size=R, p=[0.05, 0.6, 0.35])
    for k in range(3):
        cols = np.nonzero(n_pos > k)[0]
        W[rng.integers(0, L, size=cols.size), cols] = 1
    neg = np.nonzero(rng.random(R) < 0.3)[0]
    neg_rows = rng.integers(0, L, size=neg.size)
    keep = W[neg_rows, neg] == 0
    W[neg_rows[keep], neg[keep]] = -1
    thresh = np.maximum((W > 0).sum(0), 1).astype(np.int32)
    group = rng.integers(0, G, size=R).astype(np.int32)
    policy = rng.integers(0, 20000, size=R).astype(np.int32)
    if n_pad:
        thresh[-n_pad:] = 10**9
        group[-n_pad:] = 0
        policy[-n_pad:] = INT32_MAX
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    return dev(k_major_plane(W)).t(), dev(thresh), dev(group), dev(policy)


def random_lit(torch, rng, B, L, active=24):
    """[B, L_pad] literal matrix: `active` literals below L per row, zero
    tail."""
    from cedar_tpu_torch.engine.weights import padded_literals

    idx = rng.integers(0, L, size=(B, active))
    lit = np.zeros((B, padded_literals(L)), np.int8)
    np.put_along_axis(lit, idx, 1, axis=1)
    return torch.from_numpy(lit).cuda()


# the policy texts of the JAX package's server fast-path tests that the
# native plane gates: an interpreter-fallback policy (an alternation
# product past the lowering's clause ceiling) and a native-opaque one (an
# extension call on a request value, which only the Python encoder
# evaluates)
FALLBACK_POLICY = (
    'permit (principal in k8s::Group::"joiners", '
    'action == k8s::Action::"get",\n'
    "        resource is k8s::Resource)\n"
    "  when { "
    + " && ".join(
        '(resource.resource == "widgets" || resource.name == "10.0.0.1")'
        for _ in range(12)
    )
    + " };\n"
)
NATIVE_OPAQUE_POLICY = """
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""

# encoder_fallback rows of each fast-path batch at the defaults (--seed 0
# --policies 10000 --sars 300): tests/test_torch_fastpath.py computes the
# same counts on the CPU from the same seeded corpus
EXPECTED_ENCODER_FALLBACK = {"300": 0, "4096": 0, "65536": 0}


def gated_policy_set(corpus):
    """The synth corpus with the two gated policies appended."""
    from cedar_tpu_torch.lang import PolicySet

    extra = PolicySet.from_source(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY, "gated")
    return PolicySet(list(corpus.policies) + extra.policies())


def gated_bodies(corpus, n: int, seed: int) -> list:
    """n synth SAR bodies, every eighth replaced by one that hits a gated
    scope (joiners reading widgets; deletecollection with an ip-like or
    other name)."""
    out = corpus.sar_bodies(n, seed=seed)
    hits = [
        {"user": "jo", "groups": ["joiners"], "verb": "get", "resource": "widgets", "name": nm}
        for nm in ("10.0.0.1", "x", "")
    ] + [
        {"user": u, "groups": [], "verb": "deletecollection", "resource": "pods", "name": nm}
        for u in ("sam", "c0-user-1") for nm in ("127.0.0.1", "10.0.0.1", "not-an-ip")
    ]
    for k, i in enumerate(range(0, n, 8)):
        h = hits[k % len(hits)]
        ra = {"verb": h["verb"], "version": "v1", "resource": h["resource"], "namespace": "c0-ns-0"}
        if h["name"]:
            ra["name"] = h["name"]
        out[i] = json.dumps({
            "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": {"user": h["user"], "uid": "u", "groups": h["groups"], "resourceAttributes": ra},
        }).encode()
    return out


def canon(resp):
    """A SAR response with its reason list as a set: what must agree
    between paths (the order of several reasons is not a contract)."""
    st = dict(resp["status"])
    if st["reason"]:
        doc = json.loads(st["reason"])
        st["reason"] = sorted(
            json.dumps(r, sort_keys=True) for r in doc.get("reasons", [])
        )
    return st


_ORACLES: dict = {}


def _oracle_init(n_policies: int, seed: int) -> None:
    """Worker initializer: the port's interpreter over the serving corpus
    and over its gated twin."""
    from cedar_tpu_torch.corpus.synth import synth_corpus
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

    corpus = synth_corpus(n_policies, seed=seed)
    for name, ps in (("synth", corpus.tiers()[0]), ("gated", gated_policy_set(corpus))):
        _ORACLES[name] = CedarWebhookAuthorizer(TieredPolicyStores([MemoryStore(name, ps)]))


def _oracle_answers(task):
    from cedar_tpu_torch.server.sar import get_authorizer_attributes, sar_response

    name, bodies = task
    attrs = [get_authorizer_attributes(json.loads(b)) for b in bodies]
    return [canon(sar_response(d, r)) for d, r in _ORACLES[name].authorize_batch(attrs)]


def interpreter_answers(tasks: dict, n_policies: int, seed: int) -> dict:
    """{label: (policy set name, bodies)} -> {label: [canon response]} from
    the port's interpreter, spread over one spawned worker per core (it
    takes milliseconds per request at 10k policies); the pool is torn
    down before returning."""
    import multiprocessing as mp

    piece = 512
    work = [(label, i, name, bodies[i:i + piece])
            for label, (name, bodies) in tasks.items() for i in range(0, len(bodies), piece)]
    n_workers = max(1, min(os.cpu_count() or 1, len(work)))
    with mp.get_context("spawn").Pool(
        n_workers, initializer=_oracle_init, initargs=(n_policies, seed)
    ) as pool:
        answers = pool.map(_oracle_answers, [(name, b) for _, _, name, b in work], chunksize=1)
    out = {label: [] for label in tasks}
    for (label, _, _, _), ans in zip(work, answers):
        out[label].extend(ans)
    return out


def profile_answer(torch, fn, label: str) -> None:
    """One call of fn under torch.profiler: the device's busy and idle
    share of its wall time and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kern = {}  # device-side events only (ops would count twice), summed
    launches = 0  # by the first 60 characters of their names
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            kern[ev.key[:60]] = kern.get(ev.key[:60], 0.0) + ev.self_device_time_total
            launches += ev.count
    busy = sum(kern.values()) / 1e6
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {label}: wall {wall:.4f} s, device busy {busy:.6f} s, "
          f"idle share {1 - busy / wall:.4f}, {launches} device kernels and copies; "
          "top device time (us): "
          + json.dumps({k: round(v, 1) for k, v in top}), flush=True)


def diag_key(decision, diag):
    """Decision and reason set: what must agree with the interpreter
    (error message texts differ by design: the device plane reports
    "evaluation error")."""
    return decision, sorted(r.policy for r in diag.reasons)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policies", type=int, default=10000)
    ap.add_argument("--sars", type=int, default=300)
    ap.add_argument("--profile", action="store_true",
                    help="trace one batch-4096 answer of the authorizer path and "
                         "a batch-1, a batch-4096 and a batch-65536 answer of the fast path "
                         "with torch.profiler and print the device's busy and "
                         "idle share")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        from cedar_tpu_torch.corpus.synth import coverage_corpus, synth_corpus
        from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
        from cedar_tpu_torch.lang import PolicySet
        from cedar_tpu_torch.ops import cuda_match
        from cedar_tpu_torch.ops import match as plain
        from cedar_tpu_torch.server.authorizer import (
            CedarWebhookAuthorizer,
            record_to_cedar_resource,
        )
        from cedar_tpu_torch.server.sar import get_authorizer_attributes, sar_response
        from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores
    except ImportError as e:
        fail(f"the cedar_tpu_torch package is not importable here: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    kinds = {
        "match_groups_kernel": {
            "route": "cuda",
            "source": "cedar_tpu_torch/csrc/match.cu",
            "replaces": "cedar_tpu/ops/pallas_match.py:276",
        },
        "match_words_kernel": {
            "route": "cuda",
            "source": "cedar_tpu_torch/csrc/match.cu",
            "replaces": "cedar_tpu/ops/pallas_match.py:361",
        },
    }

    # ---- 1. card
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)

    # ---- 2. build
    t0 = time.monotonic()
    lib = cuda_match.build()
    print(f"build: {lib.relative_to(cuda_match.BUILD_ROOT.parent.parent)} "
          f"in {time.monotonic() - t0:.2f} s", flush=True)
    for line in cuda_match.build_log().splitlines():
        if "ptxas info" in line and ("Compiling entry" in line or "Used" in line) \
                or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    gmma = sass_gmma_count(lib)
    print(f"sass: warpgroup-MMA instructions {json.dumps(gmma)}", flush=True)
    if gmma.get("IGMMA", 0) < 1:
        fail("the built library has no IGMMA instruction: the kernels do not use "
             "the int8 tensor cores")

    # ---- 3. kernel parity (launches here are not main-path launches)
    err = {"match_groups_kernel": 0, "match_words_kernel": 0}

    n_sm = cuda_match.sm_count(0)

    def parity(label, lit, W, th, grp, pol, T, gate, need_mix, maps=None):
        """Both kernels against their plain versions on the same inputs,
        bit for bit; folds the error into err and fails on any difference.
        maps: the plane's TMA map cache, as the engine passes it."""
        G = plain.n_groups_of(T, gate)
        (B, L), R = lit.shape, W.shape[1]
        f_k, l_k = cuda_match.match_groups(lit, W, th, grp, pol, G, plane_maps=maps)
        f_p, l_p = plain.first_match_ref(lit, W, th, grp, pol, G)
        w_k = cuda_match.match_words(lit, W, th, grp, pol, T, gate, plane_maps=maps)
        w_p = plain.tier_walk(f_p, l_p, T, gate)
        torch.cuda.synchronize()
        e_g = max(
            int((f_k.long() - f_p.long()).abs().max()),
            int((l_k.long() - l_p.long()).abs().max()),
        )
        # words compared as the uint32 values they encode
        e_w = int(((w_k.long() & 0xFFFFFFFF) - (w_p.long() & 0xFFFFFFFF)).abs().max())
        err["match_groups_kernel"] = max(err["match_groups_kernel"], e_g)
        err["match_words_kernel"] = max(err["match_words_kernel"], e_w)
        matched = int((f_p != INT32_MAX).sum())
        multi = int(((f_p != l_p) & (f_p != INT32_MAX)).sum())
        print(f"parity {label} B={B} L={L} R={R} G={G} rule tile "
              f"{cuda_match.rule_tile(B, R, n_sm)}: groups err {e_g}, words err {e_w} "
              f"({B * G - matched} empty / {matched - multi} single / {multi} multi "
              "groups)", flush=True)
        if e_g or e_w:
            fail(f"kernel disagrees with its plain version ({label} B={B} L={L} R={R} G={G})")
        if need_mix and (not multi or matched == multi or matched == B * G):
            fail(f"parity case {label} B={B} G={G} did not exercise empty, single "
                 "and multi groups")

    cases = [(B, 1024, 10240, T, gate) for B in (8, 128, 1024, 4096)
             for T, gate in ((1, False), (1, True), (3, False))]
    cases += [(100, 1024, 10000, 1, True), (100, 1000, 10000, 3, False),
              (65, 1000, 10000, 1, True), (1, 200, 1000, 1, False)]
    t0 = time.monotonic()
    for B, L, R, T, gate in cases:
        G = plain.n_groups_of(T, gate)
        W, th, grp, pol = random_plane(torch, rng, L, R, G, n_pad=R // 20)
        lit = random_lit(torch, rng, B, L)
        parity("random", lit, W, th, grp, pol, T, gate, need_mix=B >= 128)
    print(f"parity: {len(cases)} random cases exact in {time.monotonic() - t0:.1f} s",
          flush=True)

    # ---- 4. serving path: 10k-policy corpus, SAR bodies -> authorizer
    t0 = time.monotonic()
    corpus = synth_corpus(args.policies, seed=args.seed)
    tiers = corpus.tiers()
    engine = TorchPolicyEngine()
    if engine.device.type != "cuda":
        fail(f"engine chose {engine.device}, not cuda")
    stats = engine.load(tiers)
    cs = engine.compiled_set
    if cs.Wt_dev.device.type != "cuda" or cs.Wt_dev.dtype != torch.int8 \
            or not cs.Wt_dev.is_contiguous() or tuple(cs.Wt_dev.shape) != (cs.R, cs.L):
        fail("compiled plane is not a K-major int8 tensor [R, L] on the card")
    print(f"serving: {args.policies} policies -> L={cs.L} R={cs.R} "
          f"rules={cs.n_rules} "
          f"G={cs.n_groups} fallback={len(cs.fallback)}; corpus+load "
          f"{time.monotonic() - t0:.1f} s ({stats['compile_seconds']})", flush=True)
    if cs.fallback:
        fail("the serving corpus must lower fully (no interpreter fallback)")
    stores = TieredPolicyStores([MemoryStore("synth", tiers[0])])
    authz = CedarWebhookAuthorizer(
        stores, evaluate=engine.evaluate, evaluate_batch=engine.evaluate_batch
    )
    oracle = CedarWebhookAuthorizer(stores)  # the port's interpreter
    bodies = corpus.sar_bodies(args.sars, seed=args.seed + 1)

    def answer(authorizer, batch):
        attrs = [get_authorizer_attributes(json.loads(b)) for b in batch]
        return [sar_response(d, r) for d, r in authorizer.authorize_batch(attrs)]

    flagged0 = engine.flagged_rows
    cuda_match.reset_launch_counts()
    got = answer(authz, bodies)
    torch.cuda.synchronize()
    serving_launches = cuda_match.launch_counts()
    want = answer(oracle, bodies)
    flips = sum(canon(a) != canon(b) for a, b in zip(got, want))
    allow = sum(r["status"]["allowed"] for r in got)
    deny = sum(r["status"]["denied"] for r in got)
    print(f"serving: {len(bodies)} SARs, {allow} allow / {deny} deny / "
          f"{len(bodies) - allow - deny} no-opinion, flagged rows "
          f"{engine.flagged_rows - flagged0}, flips vs interpreter: {flips}", flush=True)
    print(f"serving launches: {serving_launches}", flush=True)
    if flips:
        fail(f"{flips} decisions differ from the interpreter")
    # one batch of fewer than 32768 rows: one words launch, nothing else
    if serving_launches != {"match_groups_kernel": 0, "match_words_kernel": 1}:
        fail(f"the serving path should launch match_words_kernel once: {serving_launches}")
    if allow == 0 or allow == len(bodies):
        fail("serving traffic did not exercise both allow and non-allow answers")

    from cedar_tpu_torch.compiler.table import encode_request_codes

    def engine_lit(eng, c_s, items_, pad):
        """The literal matrix the engine builds for these items (padded to
        its batch bucket when pad), with the codes and extras."""
        enc_ = [encode_request_codes(c_s.packed.plan, c_s.packed.table, em, rq)
                for em, rq in items_]
        c, e = eng._encode_batch_arrays(c_s, enc_, len(enc_))
        if pad:
            c, e = eng._pad_to_bucket(c, e, c_s.L)
        return c, e, plain.lit_matrix_codes(
            eng._to_device(c), eng._to_device(e), c_s.act_rows_dev)

    # parity at the serving plane's shapes: the padded batch phase 4 served
    # (its bucket), and rows of the batch-4096 traffic at every bucket the
    # timed batches below and small requests take
    serve_plane = (cs.W_dev, cs.thresh_dev, cs.rule_group_dev, cs.rule_policy_dev,
                   cs.n_tiers, cs.has_gate)
    items300 = [record_to_cedar_resource(get_authorizer_attributes(json.loads(b)))
                for b in bodies]
    _, _, lit300 = engine_lit(engine, cs, items300, pad=True)
    parity("serving", lit300, *serve_plane, need_mix=False, maps=cs.plane_maps)
    big = corpus.sar_bodies(4096, seed=args.seed + 2)
    items4096 = [record_to_cedar_resource(get_authorizer_attributes(json.loads(b)))
                 for b in big]
    codes, extras, serve_lit = engine_lit(engine, cs, items4096, pad=False)
    for B in (4096, 128, 32, 8, 1):
        parity("serving", serve_lit[:B].contiguous(), *serve_plane, need_mix=False,
               maps=cs.plane_maps)

    perf = {}
    for batch, reps in ((1, 20), (128, 5), (4096, 2)):
        lat = []
        for i in range(reps):
            lo = (i * batch) % 4096
            chunk = big[lo:lo + batch]
            t = time.perf_counter()
            answer(authz, chunk)
            lat.append(time.perf_counter() - t)
        med = float(np.median(lat))
        perf[batch] = {"batch_latency_ms": med * 1e3, "decisions_per_s": batch / med}
    print("serving throughput (SAR JSON -> SAR response, host clock, "
          f"{card}): " + json.dumps(perf), flush=True)

    # where one batch-4096 answer's time goes (host clock; every stage
    # ends on the host, so device work is included where it runs)
    split = {}
    t = time.perf_counter()
    attrs = [get_authorizer_attributes(json.loads(b)) for b in big]
    split["json_to_attributes"] = time.perf_counter() - t
    t = time.perf_counter()
    items = [record_to_cedar_resource(a) for a in attrs]
    split["entities"] = time.perf_counter() - t
    t = time.perf_counter()
    enc = [encode_request_codes(cs.packed.plan, cs.packed.table, em, rq) for em, rq in items]
    codes, extras = engine._encode_batch_arrays(cs, enc, len(enc))
    split["encode"] = time.perf_counter() - t
    t = time.perf_counter()
    words, _ = engine.match_arrays(codes, extras, cs=cs)
    split["device_match"] = time.perf_counter() - t
    t = time.perf_counter()
    resolved = engine.resolve_flagged(words, codes, extras, cs=cs)
    verdicts = [
        resolved[i] if i in resolved else engine._finalize_packed(cs, int(words[i]))
        for i in range(len(words))
    ]
    split["resolve_and_decode"] = time.perf_counter() - t
    t = time.perf_counter()
    [sar_response(*authz._map_verdict(d, dg)) for d, dg in verdicts]
    split["render"] = time.perf_counter() - t
    total = sum(split.values())
    print("batch 4096 split (host clock, s): " + json.dumps(
        {k: round(v, 6) for k, v in split.items()}) + f" total {total:.4f}", flush=True)
    if args.profile:
        profile_answer(torch, lambda: answer(authz, big), "batch 4096")

    # ---- 4b. the native fast path: raw SAR bytes -> C++ encoder -> pinned
    # staging -> one words launch per chunk -> one packed D2H
    from cedar_tpu_torch.engine.fastpath import SARFastPath, _chunk_sizes
    from cedar_tpu_torch.native import build as native_build

    so = native_build.library_path()
    built = not so.is_file()
    t0 = time.monotonic()
    native_build.ensure_built()
    cmd = " ".join(native_build.compile_command(native_build.glue_include(), so.name))
    print(f"native build: {cmd} in {time.monotonic() - t0:.2f} s"
          + ("" if built else " (already built)"), flush=True)
    fast = SARFastPath(engine, authz)
    big64k = corpus.sar_bodies(65536, seed=args.seed + 5)
    batches = {"300": bodies, "4096": big, "65536": big64k}
    # one words launch per pipeline chunk: 16384-row chunks, the last one
    # split in two halves (the JAX package's chunk plan), so 65536 rows
    # are 16384 x 3 + 8192 x 2, five launches
    want_words = {label: len(_chunk_sizes(len(b), fast._CHUNK, fast._TAIL_CHUNK))
                  for label, b in batches.items()}
    fast_answers, fast_launches = {}, {}
    defaults = (args.seed, args.policies, args.sars) == (0, 10000, 300)
    for label, batch in batches.items():
        before = dict(fast.routing)
        cuda_match.reset_launch_counts()
        res = fast.authorize_raw(batch)
        torch.cuda.synchronize()
        fast_launches[label] = cuda_match.launch_counts()
        routing = {k: fast.routing[k] - before[k] for k in before}
        fast_answers[label] = [canon(sar_response(*r)) for r in res]
        print(f"fastpath batch {label}: launches {fast_launches[label]}, routing "
              f"{json.dumps(routing)}, stages (s) "
              f"{json.dumps({k: round(v, 6) for k, v in fast.last_stage_s.items()})}", flush=True)
        if fast_launches[label] != {"match_groups_kernel": 0,
                                    "match_words_kernel": want_words[label]}:
            fail(f"fast path batch {label}: launches {fast_launches[label]}, want "
                 f"{want_words[label]} match_words_kernel and no match_groups_kernel")
        if defaults and routing["encoder_fallback"] != EXPECTED_ENCODER_FALLBACK[label]:
            fail(f"fast path batch {label}: {routing['encoder_fallback']} encoder_fallback "
                 f"rows, the CPU test counts {EXPECTED_ENCODER_FALLBACK[label]}")
    authz_answers = {"300": [canon(r) for r in got]}
    for label in ("4096", "65536"):
        authz_answers[label] = [canon(r) for r in answer(authz, batches[label])]
    for label in batches:
        flips = sum(a != b for a, b in zip(fast_answers[label], authz_answers[label]))
        print(f"fastpath batch {label}: flips vs the authorizer path {flips}", flush=True)
        if flips or len(fast_answers[label]) != len(batches[label]):
            fail(f"fast path batch {label}: {flips} answers differ from the authorizer path")
    print(f"staging: {json.dumps(engine.staging_stats())}", flush=True)

    # both kernels on the fast path's own operands: native codes of a
    # 16384-row chunk (its bucket), pinned-staged and expanded on the card
    snap = fast._current_snapshot()
    c16, e16, _n16, f16 = snap.encoder.encode_batch(big64k[:16384])
    if not (f16 == 0).all():
        fail("the 16384-row parity chunk holds rows the encoder did not pass")
    c16, e16 = engine._pad_to_bucket(c16, e16, cs.L)
    lit16k = plain.lit_matrix_codes(engine._to_device(c16), engine._to_device(e16),
                                    cs.act_rows_dev)
    parity("fastpath", lit16k, *serve_plane, need_mix=False, maps=cs.plane_maps)

    def fast_answer(batch):
        return [sar_response(*r) for r in fast.authorize_raw(batch)]

    fperf = {}
    for batch, reps in ((1, 20), (128, 10), (4096, 5), (65536, 3)):
        row = {}
        for path, fn, n_reps in (("fastpath", fast_answer, reps),
                                 ("authorizer", lambda b: answer(authz, b),
                                  1 if batch == 65536 else reps)):
            lat = []
            for i in range(n_reps):
                lo = (i * batch) % 65536
                chunk = big64k[lo:lo + batch]
                t = time.perf_counter()
                fn(chunk)
                lat.append(time.perf_counter() - t)
            med = float(np.median(lat))
            row[path] = {"batch_latency_ms": med * 1e3, "decisions_per_s": batch / med}
        fperf[batch] = row
    print("fastpath throughput vs the authorizer path (SAR JSON -> SAR response, host "
          f"clock, {card}): " + json.dumps(fperf), flush=True)
    for label, batch in (("1", big[:1]), ("4096", big), ("65536", big64k)):
        fast.authorize_raw(batch)
        print(f"fastpath batch {label} stages (host clock, s, {card}): " + json.dumps(
            {k: round(v, 6) for k, v in fast.last_stage_s.items()}), flush=True)
        if args.profile:
            profile_answer(torch, lambda: fast_answer(batch), f"fastpath batch {label}")

    # gated sub-phase: the corpus with an interpreter-fallback and a
    # native-opaque policy; rows in their scopes re-run through
    # evaluate_batch (want_full: match_groups_kernel), the rest stay native
    g_ps = gated_policy_set(corpus)
    g_engine = TorchPolicyEngine()
    g_engine.load([g_ps])
    gcs = g_engine.compiled_set
    if not (gcs.fallback and gcs.has_gate):
        fail("the gated set should carry interpreter-fallback policies and gate rules")
    g_authz = CedarWebhookAuthorizer(
        TieredPolicyStores([MemoryStore("gated", g_ps)]), evaluate_batch=g_engine.evaluate_batch)
    g_fast = SARFastPath(g_engine, g_authz)
    g_batch = gated_bodies(corpus, 4096, seed=args.seed + 6)
    cuda_match.reset_launch_counts()
    g_res = g_fast.authorize_raw(g_batch)
    torch.cuda.synchronize()
    gated_launches = cuda_match.launch_counts()
    g_answers = [canon(sar_response(*r)) for r in g_res]
    g_flips = sum(a != canon(b) for a, b in zip(g_answers, answer(g_authz, g_batch)))
    print(f"fastpath gated: {len(gcs.fallback)} fallback policies, G={gcs.n_groups}, "
          f"launches {gated_launches}, routing {json.dumps(g_fast.routing)}, flips vs the "
          f"authorizer path {g_flips}", flush=True)
    if g_fast.routing["gated"] < 1:
        fail("no row of the gated traffic was gated")
    if gated_launches["match_groups_kernel"] < 1 or gated_launches["match_words_kernel"] < 1:
        fail(f"gated traffic should launch both kernels: {gated_launches}")
    if g_flips:
        fail(f"gated traffic: {g_flips} answers differ from the authorizer path")
    g_snap = g_fast._current_snapshot()
    gc, ge, _gn, gf = g_snap.encoder.encode_batch(g_batch)
    ok = gf == 0
    gc, ge = g_engine._pad_to_bucket(gc[ok], ge[ok], gcs.L)
    g_lit = plain.lit_matrix_codes(g_engine._to_device(gc), g_engine._to_device(ge),
                                   gcs.act_rows_dev)
    parity("gated", g_lit, gcs.W_dev, gcs.thresh_dev, gcs.rule_group_dev,
           gcs.rule_policy_dev, gcs.n_tiers, gcs.has_gate, need_mix=False,
           maps=gcs.plane_maps)

    # every answer of the phase against the port's interpreter
    t0 = time.monotonic()
    oracle_answers = interpreter_answers(
        {**{label: ("synth", b) for label, b in batches.items()}, "gated": ("gated", g_batch)},
        args.policies, args.seed)
    for label, mine in list(fast_answers.items()) + [("gated", g_answers)]:
        flips = sum(a != b for a, b in zip(mine, oracle_answers[label]))
        print(f"fastpath {label}: flips vs the interpreter {flips}", flush=True)
        if flips or len(mine) != len(oracle_answers[label]):
            fail(f"fast path {label}: {flips} answers differ from the interpreter")
    print(f"interpreter check: {sum(map(len, oracle_answers.values()))} answers in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    # ---- 5. want_full path: interpreter-fallback policies
    cov = coverage_corpus(per_family=4, base=64, seed=args.seed)
    fb_engine = TorchPolicyEngine()
    fb_engine.load(cov.tiers())
    if not fb_engine.compiled_set.fallback:
        fail("coverage corpus produced no interpreter-fallback policy")
    items = cov.items(256, seed=args.seed + 3)
    words_calls = []
    real_words = cuda_match.match_words

    def spy(*a, **k):
        words_calls.append(1)
        return real_words(*a, **k)

    cuda_match.match_words = spy
    cuda_match.reset_launch_counts()
    try:
        res = fb_engine.evaluate_batch(items)
        torch.cuda.synchronize()
    finally:
        cuda_match.match_words = real_words
    full_launches = cuda_match.launch_counts()
    ps = cov.tiers()[0]
    fb_flips = sum(
        diag_key(*r) != diag_key(*ps.is_authorized(em, req)) for r, (em, req) in zip(res, items)
    )
    print(f"want_full: {len(fb_engine.compiled_set.fallback)} fallback policies, "
          f"{len(items)} requests, launches {full_launches}, flips {fb_flips}", flush=True)
    if fb_flips:
        fail(f"want_full path: {fb_flips} answers differ from the interpreter")
    if words_calls:
        fail("want_full path took the words-only launch")
    if full_launches["match_groups_kernel"] < 1 or full_launches["match_words_kernel"]:
        fail(f"want_full path should launch match_groups_kernel only: {full_launches}")
    fcs = fb_engine.compiled_set
    _, _, fb_lit = engine_lit(fb_engine, fcs, items, pad=True)
    parity("want_full", fb_lit, fcs.W_dev, fcs.thresh_dev, fcs.rule_group_dev,
           fcs.rule_policy_dev, fcs.n_tiers, fcs.has_gate, need_mix=False,
           maps=fcs.plane_maps)

    # ---- 6. diagnostics: two permits match one request
    src = """
permit (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
permit (principal, action == k8s::Action::"get", resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal, action == k8s::Action::"delete", resource is k8s::Resource)
  when { resource.resource == "pods" };
"""
    d_engine = TorchPolicyEngine()
    d_engine.load([PolicySet.from_source(src, "diag")])
    body = {"spec": {"user": "sam", "uid": "u", "resourceAttributes": {
        "verb": "get", "resource": "pods", "version": "v1", "namespace": "default"}}}
    em, req = record_to_cedar_resource(get_authorizer_attributes(body))
    decision, diag = d_engine.evaluate(em, req)
    want_d = diag_key(*PolicySet.from_source(src, "diag").is_authorized(em, req))
    print(f"diagnostics: {decision} reasons {[r.policy for r in diag.reasons]} "
          f"flagged rows {d_engine.flagged_rows}", flush=True)
    if diag_key(decision, diag) != want_d or len(diag.reasons) != 2 or d_engine.flagged_rows != 1:
        fail("the two-permit request did not come back through resolve_flagged with both reasons")

    # ---- 7. timing at the main path's shapes
    # the serving plane's literal matrix for the batch-4096 SARs above
    # (held against the plain versions in phase 4)
    S = cs.packed.table.n_slots
    print(f"serving lit: [{serve_lit.shape[0]}, {serve_lit.shape[1]}] from {S} slots, "
          f"{float(serve_lit.float().sum(1).mean()):.1f} active literals per row", flush=True)
    # each plane with its TMA map cache, as the engine keeps it
    planes = {"serving": (serve_lit, cs.W_dev, cs.thresh_dev, cs.rule_group_dev,
                          cs.rule_policy_dev, cs.n_tiers, cs.has_gate, (4096, 128, 1),
                          cs.plane_maps)}
    W1, th1, g1, p1 = random_plane(torch, rng, 1024, 10240, 3, n_pad=10240 // 20)
    planes["L1024"] = (random_lit(torch, rng, 4096, 1024), W1, th1, g1, p1, 1, False,
                       (4096, 128), {})
    shapes = {k: [] for k in kinds}
    for plane_name, (lit_all, W, th, grp, pol, T, gate, batches, maps) in planes.items():
        G = plain.n_groups_of(T, gate)
        L, R = W.shape
        Wf = W.float()
        for B in batches:
            lit = lit_all[:B].contiguous()
            litf = lit.float()
            iters = 20 if B == 4096 else 100
            lib_ms = time_ms(torch, lambda: torch.matmul(litf, Wf), iters)
            # the same int8 contraction, without the epilogue; cuBLASLt's
            # rules: more than 16 rows
            int_mm_ms = None
            if B > 16:
                try:
                    int_mm_ms = time_ms(torch, lambda: torch._int_mm(lit, W), iters)
                except RuntimeError as e:
                    print(f"torch._int_mm refused B={B} L={L} R={R}: {e}", flush=True)
            rows = {
                "match_groups_kernel": (
                    lambda: cuda_match.match_groups(lit, W, th, grp, pol, G, plane_maps=maps),
                    lambda: plain.first_match_ref(lit, W, th, grp, pol, G),
                    2 * 4 * B * G,
                ),
                "match_words_kernel": (
                    lambda: cuda_match.match_words(lit, W, th, grp, pol, T, gate,
                                                   plane_maps=maps),
                    lambda: plain.match_words_ref(lit, W, th, grp, pol, T, gate),
                    4 * B,
                ),
            }
            for k, (kernel_fn, plain_fn, out_bytes) in rows.items():
                ms = time_ms(torch, kernel_fn, iters)
                device_ms = graph_ms(torch, kernel_fn, iters)
                plain_ms = time_ms(torch, plain_fn, 5 if B == 4096 else 20)
                # lit, the plane and the rule columns read once, the
                # output written once; 2 ops per multiply-add
                b_ms, b_by = bound_ms(B * L + L * R + 3 * 4 * R + out_bytes, 2.0 * B * L * R)
                shapes[k].append({
                    "plane": plane_name, "B": B, "L": L, "R": R, "G": G,
                    "rule_tile": cuda_match.rule_tile(B, R, n_sm), "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "library_int_mm_ms": int_mm_ms,
                })
    # the rule-tile choice: each tile forced in turn (rule_tile replaced
    # for the probe only; these launches are not main-path launches)
    real_tile = cuda_match.rule_tile
    tiles = {}
    try:
        for plane_name, (lit_all, W, th, grp, pol, T, gate, _, maps) in planes.items():
            G = plain.n_groups_of(T, gate)
            for bn in (64, 128, 256):
                cuda_match.rule_tile = lambda B, R, n, bn=bn: bn  # noqa: E731
                tiles[f"{plane_name} B=4096 tile {bn}"] = graph_ms(
                    torch, lambda: cuda_match.match_groups(
                        lit_all, W, th, grp, pol, G, plane_maps=maps), 20)
    finally:
        cuda_match.rule_tile = real_tile
    print(f"rule-tile probe, match_groups_kernel device ms ({card}): "
          + json.dumps(tiles), flush=True)

    # each kernel's launches on this slice's main path, the fast path: the
    # words launch of its batch-4096 answer, the first-match launches of
    # its gated rows; and on the earlier paths
    own_path = {"match_groups_kernel": gated_launches, "match_words_kernel": fast_launches["4096"]}
    kernels = []
    for k, meta in kinds.items():
        head = shapes[k][0]  # the serving plane at B = 4096
        if own_path[k][k] < 1:
            fail(f"{k} was not launched on the fast path")
        kernels.append({
            "name": k, **meta,
            "launches": own_path[k][k],
            "launches_fastpath": {label: c[k] for label, c in fast_launches.items()},
            "launches_fastpath_gated": gated_launches[k],
            "launches_serving": serving_launches[k],
            "launches_want_full": full_launches[k],
            "max_abs_err": err[k],
            "ms": head["ms"], "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_int_mm_ms": head["library_int_mm_ms"],
            "shape": {d: head[d] for d in ("B", "L", "R", "G")},
            "shapes": shapes[k],
        })
    for k in kinds:
        for s in shapes[k]:
            print(f"time {k} {s['plane']} B={s['B']} L={s['L']} R={s['R']} "
                  f"(rule tile {s['rule_tile']}): {s['ms']:.4f} ms, device {s['device_ms']:.4f} "
                  f"ms (plain "
                  f"{s['plain_ms']:.4f}, bound {s['bound_ms']:.4f} by {s['bound_by']}, "
                  f"float32 matmul {s['library_ms']:.4f}, int8 _int_mm "
                  f"{s['library_int_mm_ms']})", flush=True)

    card = card_line()
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
