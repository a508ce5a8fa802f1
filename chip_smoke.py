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
  8. webhook (the /v1/authorize path): the gated sub-phase's policy set
     written to a directory with a JSON StoreConfig, and
     `python3 -m cedar_tpu_torch.cli.webhook --insecure` started on it as
     a subprocess on the card (default --device cuda, pipelined batcher);
     the expected answers from the library SARFastPath over a store built
     from the same directory, held against the interpreter's answers of
     phase 4b (decision and reason set, 0 flips); then the first 300
     gated bodies POSTed one at a time on one keep-alive connection, all
     4096 from 64 client threads, and phase 4's 4096 synth bodies (no
     gated scope forced) from 64 threads, every response's status equal
     to the expected one (a flip prints its body's latency and both
     answers). From the server's /debug/engine (launch counts 0 before
     the traffic: the server resets them after its start-up warm-up,
     whose launches it reports apart) and /metrics: both kernels
     launched, no fallback batch, a mean batch above 1 under 64 clients.
     Prints, per window, requests/s, p50 / p99 / first-body / max
     latency, the mean batch, the mean
     stage times per batch and the launches; the largest batch; and the
     server's peak RSS (its rusage, reaped after SIGTERM, which must end
     it with code 0 within --shutdown-grace-seconds + 5 s). Then the
     CLI's two other serving modes, each a new server on the same store:
     --pipeline-depth 0 (serial batch loop; both kernels launched) and
     --no-native (one engine call per request thread), each answering
     the first 300 gated bodies from 16 clients with 0 flips and exiting
     0 on SIGTERM. No client request is retried: a reset or dropped
     connection fails the phase. --profile: then a lone request's stage
     split in this process (one thread, torch.profiler, and an
     in-process PipelinedBatcher).
  9. admission (this slice's main path): phase 8's policy files plus
     admission policies (the forbid set of the JAX package's native
     admission tests, the repo demo's demo-require-owner-label, and an
     interpreter-fallback forbid whose scope the plane gates) in one
     directory store, and 4096 seeded AdmissionReview bodies (CREATE 50%,
     UPDATE 30%, DELETE 15%, CONNECT 5%; ConfigMap, Secret, Deployment and
     Pod objects; about 10% in kube-system; every sixteenth in the
     fallback forbid's scope; every 25th matching two forbids; a few
     conversion errors and one uid over 255 bytes). The expected answers
     come from the library AdmissionFastPath over the same stores plus the
     allow-all tier, held against the port's interpreter handler in the
     oracle pool (0 flips; a deny's reasons compared as a set). Then the webhook CLI, which builds both
     engines, serves 300 bodies on /v1/admit at concurrency 1, all 4096
     at concurrency 64, and a mixed window: 2048 admission bodies from 32
     clients while 32 others POST 2048 of phase 8's SAR bodies, every
     answer equal to its expected one. Over the admission-only windows
     (/debug/engine and /metrics before and after): both kernels
     launched, the admission rows routed gated, flagged, encoder_fallback
     and encoder_gate, no fallback batch, a mean batch above 1 at
     concurrency 64, and an `admission` entry in /debug/engine. Prints
     requests/s, p50 / p99, mean and largest batch, the mixed window per
     endpoint, both engines' plane shapes, the server's peak RSS and the
     phase's wall time; SIGTERM must end the server with code 0.
  10. live policy reload (this slice's main path): phase 9's files in one
     directory store with refreshInterval 30s (its minimum), served by the
     CLI with --reload-seconds 1, --request-timeout-ms 10000 and both
     engines. While 32 clients POST
     SARs (phase 8's gated bodies) and 32 POST AdmissionReviews without
     pause, three edits land, each an atomic swap of the store's directory
     (a symlink re-pointed, as a Kubernetes ConfigMap volume updates): add
     a forbid file (every watch SAR and every admission delete), edit
     admission.cedar (its first forbid dropped), revert both. After each,
     the phase waits for /debug/engine's load_generation to step on both
     engines (the directory ticker re-reads within 30 s, the reloader
     recompiles in full, warms the new plane on the card and swaps it in).
     The expected answers come from the oracle pool over each version's
     directory. Checks: every answer is the answer of a version live while
     the request was in flight (a request sent after an engine published
     a version gets that version's: 0 flips; a deadline expiry counts as
     a flip); each edit changed answers;
     both kernels' served launch counts rise after each swap; no fallback
     batch; the server's card memory after the third reload no more than
     one plane above its memory after the first; SIGTERM ends the server
     with code 0. Prints per reload and engine the time from the write to
     the swap and the compile seconds by phase (lower, pack, place, warm);
     per endpoint requests/s and p99 in the 5 s before each write and
     while each reload compiles, and the latency of the first request sent
     after each swap; the server's card memory after reloads 1 and 3
     (nvidia-smi's per-process figure where it lists the server, and the
     server's allocator counts from /debug/engine); the phase's wall time.

``--only-reload`` runs phases 1, 2 and 10 alone (a quick check of the
reload phase); it prints no result lines.

Prints the card line, then one {"kernels": [...]} line, then, last,
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when
CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

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


# admission policies of phase 9: the forbid set of the JAX package's
# native admission tests (tests/test_admission_native.py ADM_POLICIES)
ADM_POLICIES = """
forbid (
    principal,
    action == k8s::admission::Action::"create",
    resource is core::v1::ConfigMap
) when {
    resource.metadata has labels &&
    resource.metadata.labels.contains({key: "env", value: "prod"})
};
forbid (
    principal in k8s::Group::"tenants",
    action in [k8s::admission::Action::"update", k8s::admission::Action::"delete"],
    resource is core::v1::Secret
) when {
    resource.metadata has namespace &&
    resource.metadata.namespace == "protected"
};
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is apps::v1::Deployment
) when {
    resource has spec && resource.spec has replicas &&
    resource.spec.replicas > 50
};
forbid (
    principal,
    action == k8s::admission::Action::"update",
    resource is core::v1::ConfigMap
) when {
    context has oldObject && context.oldObject has metadata &&
    context.oldObject.metadata has namespace &&
    context.oldObject.metadata.namespace == "locked"
};
forbid (
    principal is k8s::ServiceAccount,
    action in k8s::admission::Action::"all",
    resource is core::v1::Pod
) when {
    resource.spec has hostNetwork && resource.spec.hostNetwork == true
};
"""
# the repo demo's demo-require-owner-label (demo/admission-policy.yaml),
# inline: the card may have no PyYAML
ADM_DEMO_OWNER_POLICY = """
forbid (
    principal is k8s::User in k8s::Group::"tenants",
    action == k8s::admission::Action::"create",
    resource is core::v1::ConfigMap
) unless {
    resource.metadata has labels &&
    resource.metadata.labels.contains({ key: "owner", value: principal.name })
};
"""
# an admission-scoped interpreter-fallback forbid (an alternation product
# past the lowering's clause ceiling, as the JAX package's hybrid admission
# test builds it): true in the "default" namespace, so a service account's
# create there is denied through the gated exact path
ADM_FALLBACK_POLICY = (
    "forbid (principal is k8s::ServiceAccount,\n"
    '        action == k8s::admission::Action::"create",\n'
    "        resource is core::v1::ConfigMap)\n"
    "  when { "
    + " && ".join(
        '(resource.metadata.namespace == "default" || resource.metadata.name == "zzz")'
        for _ in range(12)
    )
    + " };\n"
)
ADM_GATED_USER = "system:serviceaccount:default:ci-runner"


def _adm_object(rng, kind: str, i: int, ns: str) -> dict:
    """A realistic object of `kind`: metadata with labels and annotations,
    and the kind's data, spec and status."""
    labels = rng.choice([
        None, {}, {"app": f"svc-{i % 7}"}, {"app": f"svc-{i % 7}", "env": rng.choice(["dev", "prod"])},
        {"owner": rng.choice(["bob", "alice", "ci-bot"]), "team": "a"},
    ])
    meta = {"name": f"{kind.lower()}-{i}", "namespace": ns, "uid": f"obj-{i:06d}",
            "resourceVersion": str(1000 + i), "creationTimestamp": "2026-01-01T00:00:00Z"}
    if labels is not None:
        meta["labels"] = labels
    if rng.random() < 0.3:
        meta["annotations"] = {"kubectl.kubernetes.io/last-applied-configuration": "{}",
                               "note": f"n{i % 5}"}
    obj = {"apiVersion": "apps/v1" if kind == "Deployment" else "v1", "kind": kind,
           "metadata": meta}
    if kind == "ConfigMap":
        obj["data"] = {f"key{j}": f"value-{i}-{j}" for j in range(rng.randint(0, 5))}
    elif kind == "Secret":
        obj["type"] = "Opaque"
        obj["data"] = {"username": "YWRtaW4=", "password": "c2VjcmV0"}
    elif kind == "Deployment":
        sel = {"app": f"svc-{i % 7}"}
        obj["spec"] = {
            "replicas": rng.choice([1, 2, 3, 50, 51, 200]),
            "selector": {"matchLabels": sel},
            "template": {"metadata": {"labels": sel}, "spec": {"containers": [{
                "name": "app", "image": f"registry.example/app:{i % 9}",
                "ports": [{"containerPort": 8080}],
                "resources": {"limits": {"cpu": "500m", "memory": "256Mi"}}}]}},
        }
        obj["status"] = {"replicas": 2, "readyReplicas": rng.choice([0, 1, 2])}
    else:  # Pod
        obj["spec"] = {
            "hostNetwork": rng.random() < 0.2,
            "nodeSelector": {"disk": rng.choice(["ssd", "hdd"])},
            "serviceAccountName": "default",
            "containers": [{"name": "app", "image": f"registry.example/app:{i % 9}",
                            "args": ["--port", "8080"]}],
        }
        obj["status"] = {"phase": rng.choice(["Pending", "Running"]),
                         "podIP": rng.choice(["10.0.3.7", "fe80::1", "not-an-ip"]),
                         "hostIP": "192.168.1.20"}
    return obj


def admission_bodies(n: int, seed: int) -> list:
    """n seeded AdmissionReview bodies (module docstring, phase 9): the
    operation and kind mix, the kube-system share, and the rows that take
    each route (gated, flagged multi-forbid, encoder fallback)."""
    rng = random.Random(seed)
    kinds = {"ConfigMap": ("", "configmaps"), "Secret": ("", "secrets"),
             "Deployment": ("apps", "deployments"), "Pod": ("", "pods")}
    users = ["alice", "bob", "ci-bot", "system:serviceaccount:team-a:deployer",
             "system:node:node-1"]
    out = []
    for i in range(n):
        # the forced rows below are creates: these weights keep the whole
        # mix near CREATE 50%, UPDATE 30%, DELETE 15%, CONNECT 5%
        op = rng.choices(["CREATE", "UPDATE", "DELETE", "CONNECT"], weights=[44, 33, 17, 6])[0]
        kind = rng.choice(list(kinds))
        ns = "kube-system" if rng.random() < 0.11 else rng.choice(
            ["default", "protected", "locked", "team-a"])
        user = rng.choice(users)
        groups = rng.choice([[], ["tenants"], ["tenants", "dev"], ["system:authenticated"]])
        sub = ""
        if i % 16 == 3:  # the fallback forbid's scope: a gated row
            op, kind, user, groups = "CREATE", "ConfigMap", ADM_GATED_USER, []
            ns = rng.choice(["default", "team-a"])
        elif i % 25 == 7:  # two forbids match: a flagged (multi) row
            op, kind, user, groups, ns = "CREATE", "ConfigMap", "bob", ["tenants"], "default"
        group, resource = kinds[kind]
        if op == "CONNECT":
            kind, group, resource, sub = "PodExecOptions", "", "pods", "exec"
            obj = {"apiVersion": "v1", "kind": kind, "container": "app", "stdin": True,
                   "tty": rng.random() < 0.5,
                   "command": rng.choice([["/bin/sh"], ["ls", "-l"], ["cat", "/etc/hosts"]])}
        else:
            obj = _adm_object(rng, kind, i, ns)
        if i % 25 == 7:
            obj["metadata"]["labels"] = {"env": "prod", "app": "web"}
        old = None
        if op in ("UPDATE", "DELETE"):
            old = json.loads(json.dumps(obj))
            old["metadata"]["namespace"] = rng.choice([ns, "locked"])
            if kind == "Deployment":
                old["spec"]["replicas"] = 3
        req = {
            "uid": f"adm-{seed}-{i:06d}",
            "kind": {"group": group, "version": "v1", "kind": kind},
            "resource": {"group": group, "version": "v1", "resource": resource},
            "name": obj.get("metadata", {}).get("name", f"pod-{i}"), "namespace": ns,
            "operation": op,
            "userInfo": {"username": user, "uid": f"uid-{user}", "groups": groups},
            "dryRun": False,
        }
        if sub:
            req["subResource"] = sub
        if rng.random() < 0.1:
            req["userInfo"]["extra"] = {"scopes": ["read", "write"]}
        if op != "DELETE":
            req["object"] = obj
        if old is not None:
            req["oldObject"] = old
        # conversion errors (the Python path answers allow-on-error) and a
        # uid longer than the encoder's 255-byte passback
        if i % 97 == 11:
            req["object"] = dict(obj, weight=1.5)  # a float leaf
            req["operation"] = "CREATE"
        elif i % 97 == 43:
            req["operation"] = "EVICT"
        elif i % 97 == 77:
            req["operation"] = "CREATE"
            req.pop("object", None)
        elif i == 5:
            req["uid"] = "u" * 300
        out.append(json.dumps({"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                               "request": req}).encode())
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
_ORACLE_ARGS: dict = {}


def _oracle_init(n_policies: int, seed: int, adm_dir=None) -> None:
    """Worker initializer: what the oracles are built from (each is built
    at its first use in the worker)."""
    _ORACLE_ARGS.update(n_policies=n_policies, seed=seed, adm_dir=adm_dir)


def _oracle(name: str):
    """The port's interpreter over the serving corpus ("synth"), its gated
    twin ("gated"), or, for "admission", the interpreter admission handler
    over phase 9's directory plus the allow-all tier; "dir-authorize:<dir>"
    and "dir-admit:<dir>" name the authorizer and the admission handler
    over a directory store of <dir> (phase 10's versions)."""
    if name not in _ORACLES:
        from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

        if name.startswith("dir-"):
            from cedar_tpu_torch.server.admission import (
                CedarAdmissionHandler,
                allow_all_admission_policy_store,
            )
            from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
            from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

            kind, path = name[len("dir-"):].split(":", 1)
            store = DirectoryPolicyStore(path, start_ticker=False)
            if kind == "admit":
                _ORACLES[name] = CedarAdmissionHandler(TieredPolicyStores(
                    [store, allow_all_admission_policy_store()]))
            else:
                _ORACLES[name] = CedarWebhookAuthorizer(TieredPolicyStores([store]))
        elif name == "admission":
            from cedar_tpu_torch.server.admission import (
                CedarAdmissionHandler,
                allow_all_admission_policy_store,
            )
            from cedar_tpu_torch.stores.directory import DirectoryPolicyStore

            _ORACLES[name] = CedarAdmissionHandler(TieredPolicyStores([
                DirectoryPolicyStore(_ORACLE_ARGS["adm_dir"], start_ticker=False),
            allow_all_admission_policy_store()]))
        else:
            from cedar_tpu_torch.corpus.synth import synth_corpus
            from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer

            corpus = synth_corpus(_ORACLE_ARGS["n_policies"], seed=_ORACLE_ARGS["seed"])
            ps = corpus.tiers()[0] if name == "synth" else gated_policy_set(corpus)
            _ORACLES[name] = CedarWebhookAuthorizer(TieredPolicyStores([MemoryStore(name, ps)]))
    return _ORACLES[name]


def admission_oracle(handler, body: bytes) -> dict:
    """The interpreter's AdmissionReview response for one raw body, with
    the webhook's answers to a body that does not decode (400) or a review
    that does not convert (allow-on-error)."""
    from cedar_tpu_torch.entities.admission import AdmissionRequest, review_request_uid
    from cedar_tpu_torch.server.admission import AdmissionResponse

    try:
        review = json.loads(body)
    except ValueError as e:
        return AdmissionResponse(uid="", allowed=False, code=400,
                                 error=f"failed parsing body: {e}").to_admission_review()
    try:
        return handler.handle(AdmissionRequest.from_admission_review(review)).to_admission_review()
    except Exception as e:  # noqa: BLE001 — every body gets an answer
        return AdmissionResponse(uid=review_request_uid(review), allowed=True,
                                 error=f"evaluation error (allowed on error): {e}"
                                 ).to_admission_review()


def adm_key(resp: dict) -> tuple:
    """An admission response with a deny's reason list as a set: what must
    agree with the interpreter (the engine lists the device plane's
    reasons before the interpreter-fallback policies', the interpreter in
    policy order; the served answers equal the expected ones byte for
    byte)."""
    msg = resp["status"]["message"]
    if msg.startswith("[{"):
        msg = sorted(json.dumps(r, sort_keys=True) for r in json.loads(msg))
    return resp["uid"], resp["allowed"], resp["status"]["code"], msg


def _oracle_answers(task):
    from cedar_tpu_torch.server.sar import get_authorizer_attributes, sar_response

    name, bodies = task
    if name == "admission" or name.startswith("dir-admit:"):
        return [admission_oracle(_oracle(name), b) for b in bodies]
    attrs = [get_authorizer_attributes(json.loads(b)) for b in bodies]
    return [canon(sar_response(d, r)) for d, r in _oracle(name).authorize_batch(attrs)]


def interpreter_answers(tasks: dict, n_policies: int, seed: int, adm_dir=None,
                        piece: int = 512) -> dict:
    """{label: (oracle name, bodies)} -> {label: [answer]} from the port's
    interpreter (canon SAR responses; admission response documents),
    spread in pieces of `piece` bodies over one spawned worker per core
    (it takes milliseconds per request at 10k policies); the pool is torn
    down before returning."""
    import multiprocessing as mp

    work = [(label, i, name, bodies[i:i + piece])
            for label, (name, bodies) in tasks.items() for i in range(0, len(bodies), piece)]
    n_workers = max(1, min(os.cpu_count() or 1, len(work)))
    with mp.get_context("spawn").Pool(
        n_workers, initializer=_oracle_init, initargs=(n_policies, seed, adm_dir)
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


def reason_key(status: dict, rename: dict) -> tuple:
    """(allowed, denied, evaluationError, sorted policy ids) of a SAR
    response status, raw or canon()'d; ids mapped through `rename` (a
    directory store names a policy <file>.policy<N>)."""
    reason = status["reason"]
    if isinstance(reason, list):
        reasons = [json.loads(r) for r in reason]
    elif reason.startswith("{"):
        reasons = json.loads(reason).get("reasons", [])
    else:
        reasons = [{"policy": reason}]
    ids = sorted(rename.get(r["policy"], r["policy"]) for r in reasons)
    return status["allowed"], status["denied"], status.get("evaluationError"), ids


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read()


class Client:
    """One keep-alive connection to the webhook; post() -> (answer,
    seconds): a SAR's status on /v1/authorize, an AdmissionReview's
    response on /v1/admit. A request that fails in any way (a reset or
    dropped connection, a non-200 answer) raises: nothing is retried."""

    def __init__(self, port: int, path: str = "/v1/authorize"):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        self.path = path
        self.key = "response" if path == "/v1/admit" else "status"

    def post(self, body: bytes):
        t = time.perf_counter()
        self.conn.request("POST", self.path, body=body,
                          headers={"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        data = resp.read()
        dt = time.perf_counter() - t
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {data[:200]!r}")
        if resp.will_close:
            raise RuntimeError("the webhook closed a keep-alive connection")
        return json.loads(data)[self.key], dt

    def close(self):
        self.conn.close()


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


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
    ap.add_argument("--only-reload", action="store_true",
                    help="run phases 1, 2 and 10 only (a quick check of the reload phase); "
                         "prints no result lines")
    ap.add_argument("--profile", action="store_true",
                    help="trace one batch-4096 answer of the authorizer path and "
                         "a batch-1, a batch-4096 and a batch-65536 answer of the fast path "
                         "with torch.profiler and print the device's busy and "
                         "idle share; after phase 8, split a lone request's time over "
                         "the pipeline stages in-process")
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

    if args.only_reload:
        corpus = synth_corpus(args.policies, seed=args.seed)
        reload_phase(args, card, gated_bodies(corpus, 4096, seed=args.seed + 6))
        return

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

    # ---- 8. webhook: the CLI entry point on the card, over HTTP
    webhook_launches, big_expected = webhook_phase(
        args, card, corpus, g_batch, oracle_answers["gated"], big)

    # ---- 9. admission: /v1/admit on the same CLI, beside /v1/authorize
    admission_launches = admission_phase(args, card, big, big_expected)

    # ---- 10. live policy reload under traffic on both endpoints
    reload_launches = reload_phase(args, card, g_batch)

    # each kernel's launches on this slice's main path, the traffic across
    # phase 10's reloads (counted in the server process); and on the
    # earlier paths
    kernels = []
    for k, meta in kinds.items():
        head = shapes[k][0]  # the serving plane at B = 4096
        kernels.append({
            "name": k, **meta,
            "launches": reload_launches[k],
            "launches_reload": reload_launches[k],
            "launches_admission": admission_launches[k],
            "launches_webhook": webhook_launches[k],
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


def profile_stages(card: str, fast, bodies: list) -> None:
    """--profile: where a lone request's time goes, in this process (the
    webhook is stopped). The three pipeline stages called one body at a
    time on this thread (median ms each), fifty of those under
    torch.profiler (this thread's top host-side ops by self CPU time, and
    the device's busy time), then the same bodies submitted one at a
    time to an in-process PipelinedBatcher (p50 and mean stage ms from
    its histograms): the same work on the pipeline's threads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cedar_tpu_torch.engine.batcher import PipelinedBatcher
    from cedar_tpu_torch.server.metrics import WebhookMetrics

    def one(body, split):
        t0 = time.perf_counter()
        ctx = fast.pipeline_encode([body])
        t1 = time.perf_counter()
        ctx = fast.pipeline_dispatch(ctx)
        t2 = time.perf_counter()
        fast.pipeline_decode(ctx)
        t3 = time.perf_counter()
        for k, a, b in (("encode", t0, t1), ("dispatch", t1, t2), ("decode", t2, t3)):
            split[k].append(b - a)

    split = {"encode": [], "dispatch": [], "decode": []}
    for body in bodies:
        one(body, split)
    print(f"profile webhook stages, one thread, batch 1 ({card}): median ms "
          + json.dumps({k: round(pct(v, 50) * 1e3, 4) for k, v in split.items()}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for body in bodies[:50]:
            one(body, {"encode": [], "dispatch": [], "decode": []})
        wall = time.perf_counter() - t
    cpu, dev, n_dev = {}, 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev += ev.self_device_time_total
            n_dev += ev.count
        else:
            cpu[ev.key[:50]] = (ev.self_cpu_time_total, ev.count)
    top = sorted(cpu.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"profile webhook stages, 50 bodies one at a time on one thread ({card}): wall "
          f"{wall:.4f} s, device busy {dev / 1e6:.6f} s over {n_dev} device kernels and "
          "copies; top host ops by self CPU us (calls): "
          + json.dumps({k: [round(v[0], 1), v[1]] for k, v in top}), flush=True)
    m = WebhookMetrics()
    b = PipelinedBatcher(fast, depth=2, encode_workers=0, metrics=m, metrics_path="authorization")
    try:
        lat = []
        for body in bodies:
            t = time.perf_counter()
            b.submit(body, timeout=60)
            lat.append(time.perf_counter() - t)
    finally:
        b.stop()
    stages = {k: round(v[0] / max(v[1], 1) * 1e3, 4) for k, v in stage_totals(m.expose()).items()}
    print(f"profile webhook stages, in-process PipelinedBatcher, concurrency 1 ({card}): "
          f"p50 {pct(lat, 50) * 1e3:.3f} ms; mean stage ms {json.dumps(stages)}", flush=True)


def stage_totals(metrics_text: str) -> dict:
    """{stage: (sum s, count)} of cedar_pipeline_stage_seconds."""
    out: dict = {}
    for line in metrics_text.splitlines():
        for part, k in (("_sum{", 0), ("_count{", 1)):
            if line.startswith("cedar_pipeline_stage_seconds" + part):
                stage = line.split('stage="')[1].split('"')[0]
                vals = out.setdefault(stage, [0.0, 0.0])
                vals[k] = float(line.rsplit(" ", 1)[1])
    return out


def drive(port: int, bodies: list, concurrency: int, path: str = "/v1/authorize"):
    """POST every body from `concurrency` client threads, one keep-alive
    connection each -> (wall s, [latency s], [answer], [client error])."""
    lat = [0.0] * len(bodies)
    got = [None] * len(bodies)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        c = Client(port, path)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    next_i[0] += 1
                if i >= len(bodies):
                    return
                got[i], lat[i] = c.post(bodies[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish within 600 s")
    return wall, lat, got, errors


def count_flips(label: str, got: list, expected: list, lat: list) -> int:
    """Answers unlike the expected ones; prints the first three."""
    flips = [i for i, (g, e) in enumerate(zip(got, expected)) if g != e]
    for i in flips[:3]:
        print(f"webhook {label}: body {i} took {lat[i] * 1e3:.3f} ms, "
              f"expected {json.dumps(expected[i])}, got {json.dumps(got[i])}", flush=True)
    return len(flips)


def run_window(port: int, bodies: list, expected: list, concurrency: int,
               path: str = "/v1/authorize"):
    """drive(), failing on any client error -> (wall s, [latency s], flips
    vs expected)."""
    wall, lat, got, errors = drive(port, bodies, concurrency, path)
    if errors:
        fail(f"webhook {path} concurrency {concurrency}: client errors {errors[:3]}")
    return wall, lat, count_flips(f"{path} concurrency {concurrency}", got, expected, lat)


class Webhook:
    """One `python3 -m cedar_tpu_torch.cli.webhook --insecure` subprocess
    on free ports, its output in a log file under `tmp`."""

    def __init__(self, cfg: str, tmp: str, name: str, grace: float, flags=()):
        self.port, self.mport = free_port(), free_port()
        self.grace = grace
        self.log_path = os.path.join(tmp, f"{name}.log")
        self.cmd = [sys.executable, "-m", "cedar_tpu_torch.cli.webhook", "--config", cfg,
                    "--insecure", "--bind-address", "127.0.0.1", "--secure-port",
                    str(self.port), "--metrics-port", str(self.mport),
                    "--shutdown-grace-seconds", str(grace), *flags]
        self.t0 = time.monotonic()
        with open(self.log_path, "w") as log_f:
            self.proc = subprocess.Popen(self.cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                         cwd=os.path.dirname(os.path.abspath(__file__)))

    def log(self) -> str:
        with open(self.log_path) as f:
            lines = f.read().splitlines()
        return "\n".join(line for line in lines if "requestId=" not in line)[-4000:]

    def wait_ready(self, card: str) -> None:
        """Poll /readyz; a server that exits or is not ready in 600 s fails."""
        deadline = time.monotonic() + 600
        while True:
            if self.proc.poll() is not None:
                fail(f"the webhook exited with code {self.proc.returncode} before it was "
                     f"ready:\n{self.log()}")
            try:
                if http_get(self.mport, "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail(f"the webhook was not ready within 600 s:\n{self.log()}")
            time.sleep(0.2)
        print(f"webhook: ready in {time.monotonic() - self.t0:.1f} s ({card}): "
              f"{' '.join(self.cmd[1:])}", flush=True)

    def debug_engine(self) -> dict:
        return json.loads(http_get(self.mport, "/debug/engine")[1])

    def terminate(self):
        """SIGTERM; reaped with wait4 -> (seconds to exit, peak RSS text).
        It must exit with code 0 within the grace window + 5 s."""
        t = time.monotonic()
        self.proc.send_signal(signal.SIGTERM)
        while True:
            pid, status, usage = os.wait4(self.proc.pid, os.WNOHANG)
            if pid:
                self.proc.returncode = os.waitstatus_to_exitcode(status)
                break
            if time.monotonic() - t > self.grace + 5:
                fail(f"the webhook did not exit within {self.grace + 5:g} s of SIGTERM")
            time.sleep(0.05)
        took = time.monotonic() - t
        if self.proc.returncode != 0:
            fail(f"the webhook exited with code {self.proc.returncode} on SIGTERM:\n{self.log()}")
        return took, (f"{usage.ru_maxrss / 1024:.1f} MiB" if usage.ru_maxrss else "not measured")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def webhook_phase(args, card: str, corpus, bodies: list, oracle: list, clean: list) -> dict:
    """Phase 8 (module docstring): `bodies` are the gated sub-phase's,
    with the interpreter's answers `oracle`; `clean` more synth bodies
    (no gated scope forced). Returns the server's kernel launch counts
    over the phase's traffic."""
    from cedar_tpu_torch.corpus.synth import synth_source
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import SARFastPath
    from cedar_tpu_torch.lang import PolicySet
    from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
    from cedar_tpu_torch.server.sar import sar_response
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
    from cedar_tpu_torch.stores.store import TieredPolicyStores

    grace = 5.0
    with tempfile.TemporaryDirectory(prefix="cedar-webhook-") as tmp:
        pol_dir = os.path.join(tmp, "policies")
        os.mkdir(pol_dir)
        # the gated set: the corpus in one file, the two gated policies in
        # another; a directory store names policy i of a file
        # <file>.policy<i>, the interpreter's set its own ids
        with open(os.path.join(pol_dir, "synth.cedar"), "w") as f:
            f.write(synth_source(args.policies, seed=args.seed))
        with open(os.path.join(pol_dir, "gated.cedar"), "w") as f:
            f.write(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY)
        rename = {f"synth.cedar.policy{i}": p.policy_id for i, p in enumerate(corpus.policies)}
        extra = PolicySet.from_source(FALLBACK_POLICY + NATIVE_OPAQUE_POLICY, "gated").policies()
        rename.update({f"gated.cedar.policy{j}": p.policy_id for j, p in enumerate(extra)})
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "directory",
                                            "directoryStore": {"path": pol_dir}}]}}, f)
        srv = Webhook(cfg, tmp, "webhook", grace)
        port, mport = srv.port, srv.mport
        try:
            # the expected answers meanwhile, in this process: the library
            # fast path over a store built from the same directory
            stores = TieredPolicyStores([DirectoryPolicyStore(pol_dir, start_ticker=False)])
            x_engine = TorchPolicyEngine()
            x_engine.load([s.policy_set() for s in stores])
            x_fast = SARFastPath(x_engine, CedarWebhookAuthorizer(
                stores, evaluate_batch=x_engine.evaluate_batch))
            expected = [sar_response(*r)["status"] for r in x_fast.authorize_raw(bodies)]
            expected_clean = [sar_response(*r)["status"] for r in x_fast.authorize_raw(clean)]
            lib_flips = sum(reason_key(e, rename) != reason_key(o, {})
                            for e, o in zip(expected, oracle))
            print(f"webhook expected answers: library fast path over the directory store, "
                  f"flips vs the interpreter {lib_flips}", flush=True)
            if lib_flips or len(expected) != len(oracle):
                fail(f"webhook phase: {lib_flips} expected answers differ from the interpreter")

            srv.wait_ready(card)

            def snapshot():
                doc = srv.debug_engine()["authorization"]
                return doc, http_get(mport, "/metrics")[1].decode()

            doc, text = snapshot()
            if any(doc["engine"]["launches"].values()) or doc["engine"]["device"] != "cuda":
                fail(f"webhook before traffic: {doc['engine']}")
            print(f"webhook start-up warm-up launches: "
                  f"{json.dumps(doc['engine']['warmup_launches'])}", flush=True)
            flips = 0
            for label, win_bodies, win_expected, conc in (
                ("concurrency 1", bodies[:300], expected[:300], 1),
                ("concurrency 64", bodies, expected, 64),
                ("concurrency 64, no gated body", clean, expected_clean, 64),
            ):
                wall, lat, n_flips = run_window(port, win_bodies, win_expected, conc)
                flips += n_flips
                doc2, text2 = snapshot()
                p1, p2 = doc["pipeline"], doc2["pipeline"]
                n_batches = p2["batches_total"] - p1["batches_total"]
                mean = (p2["rows_total"] - p1["rows_total"]) / max(n_batches, 1)
                st1, st2 = stage_totals(text), stage_totals(text2)
                stages = {k: round((st2[k][0] - st1.get(k, [0, 0])[0])
                                   / max(st2[k][1] - st1.get(k, [0, 0])[1], 1) * 1e3, 4)
                          for k in sorted(st2)}
                l1, l2 = doc["engine"]["launches"], doc2["engine"]["launches"]
                print(f"webhook {label} ({card}): {len(win_bodies) / wall:.1f} requests/s, "
                      f"p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms, "
                      f"first body {lat[0] * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms, "
                      f"mean batch {mean:.2f} over {n_batches} batches, flips vs expected "
                      f"{n_flips} / {len(win_bodies)}; mean stage ms per batch "
                      f"{json.dumps(stages)}; launches "
                      f"{json.dumps({k: l2[k] - l1[k] for k in l2})}", flush=True)
                if label == "concurrency 64" and not mean > 1:
                    fail(f"webhook: mean batch {mean:.2f} under 64 clients, want above 1")
                doc, text = doc2, text2
            launches = doc["engine"]["launches"]
            fallback = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith("cedar_authorizer_fallback_batches_total{"))
            routing = {line.split('row_class="')[1].split('"')[0]: int(float(line.rsplit(" ", 1)[1]))
                       for line in text.splitlines()
                       if line.startswith("cedar_authorizer_row_routing_total{")}
            pipe = doc["pipeline"]
            print(f"webhook launches {json.dumps(launches)}, fallback batches {fallback:g}, "
                  f"routing {json.dumps(routing)}", flush=True)
            print("webhook pipeline: " + json.dumps({k: pipe[k] for k in (
                "batches_total", "rows_total", "largest_batch", "inflight_peak",
                "stall_seconds", "depth", "encode_workers")}), flush=True)
            print(f"webhook largest batch ({card}): {pipe['largest_batch']}", flush=True)
            if flips:
                fail(f"webhook: {flips} answers differ from the expected ones")
            if launches["match_words_kernel"] < 1 or launches["match_groups_kernel"] < 1:
                fail(f"webhook traffic should launch both kernels: {launches}")
            if fallback:
                fail(f"webhook: {fallback:g} fallback batches")

            took, rss = srv.terminate()
            print(f"webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()

        # the two other serving modes of the CLI, on the card: the serial
        # batch loop (--pipeline-depth 0), and --no-native (no fast path:
        # each request thread evaluates its own SAR on the engine). The
        # first 300 gated bodies from 16 clients, 0 flips.
        for flags in (("--pipeline-depth", "0"), ("--no-native",)):
            alt = Webhook(cfg, tmp, "webhook" + "".join(flags), grace, flags)
            try:
                alt.wait_ready(card)
                wall, lat, n_flips = run_window(alt.port, bodies[:300], expected[:300], 16)
                doc = alt.debug_engine()
                mode = (f"{doc['authorization']['pipeline']['mode']} batcher, launches "
                        f"{json.dumps(doc['authorization']['engine']['launches'])}"
                        if doc else "no batcher")
                print(f"webhook {' '.join(flags)}, concurrency 16 ({card}): "
                      f"{300 / wall:.1f} requests/s, p50 {pct(lat, 50) * 1e3:.3f} ms, "
                      f"p99 {pct(lat, 99) * 1e3:.3f} ms, first body {lat[0] * 1e3:.3f} ms, "
                      f"max {max(lat) * 1e3:.3f} ms, {mode}, flips vs expected "
                      f"{n_flips} / 300", flush=True)
                if n_flips:
                    fail(f"webhook {' '.join(flags)}: {n_flips} answers differ from the "
                         "expected ones")
                if doc and not all(doc["authorization"]["engine"]["launches"].values()):
                    fail(f"webhook {' '.join(flags)} should launch both kernels: {mode}")
                alt.terminate()
            finally:
                alt.kill()
        if args.profile:
            profile_stages(card, x_fast, bodies[:200])
        return launches, expected_clean


def metric_values(text: str, family: str, label: str, path: str) -> dict:
    """{label value: value} of one family's series with path="<path>"."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") and f'path="{path}"' in line:
            out[line.split(f'{label}="')[1].split('"')[0]] = float(line.rsplit(" ", 1)[1])
    return out


def admission_phase(args, card: str, sars: list, sar_expected: list) -> dict:
    """Phase 9 (module docstring): `sars` and `sar_expected` are phase 8's
    SAR bodies and expected answers, for the mixed window. Returns the
    server's kernel launch counts over the admission-only windows."""
    from cedar_tpu_torch.corpus.synth import synth_source
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
    from cedar_tpu_torch.engine.fastpath import AdmissionFastPath
    from cedar_tpu_torch.server.admission import (
        CedarAdmissionHandler,
        allow_all_admission_policy_store,
    )
    from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
    from cedar_tpu_torch.stores.store import TieredPolicyStores

    t_phase = time.monotonic()
    grace = 5.0
    with tempfile.TemporaryDirectory(prefix="cedar-admission-") as tmp:
        pol_dir = os.path.join(tmp, "policies")
        os.mkdir(pol_dir)
        # one store holding both policy kinds, as the reference documents
        # its deployment: phase 8's files plus the admission policies
        files = {
            "synth.cedar": synth_source(args.policies, seed=args.seed),
            "gated.cedar": FALLBACK_POLICY + NATIVE_OPAQUE_POLICY,
            "admission.cedar": ADM_POLICIES,
            "admission-demo.cedar": ADM_DEMO_OWNER_POLICY,
            "admission-gated.cedar": ADM_FALLBACK_POLICY,
        }
        for fname, text in files.items():
            with open(os.path.join(pol_dir, fname), "w") as f:
                f.write(text)
        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "directory",
                                            "directoryStore": {"path": pol_dir}}]}}, f)
        bodies = admission_bodies(4096, args.seed + 9)
        srv = Webhook(cfg, tmp, "webhook-admission", grace)
        port, mport = srv.port, srv.mport
        try:
            # the expected answers meanwhile, in this process: the library
            # admission fast path over the same directory plus the allow-all
            # tier, held against the port's interpreter handler
            stores = TieredPolicyStores([DirectoryPolicyStore(pol_dir, start_ticker=False),
                                         allow_all_admission_policy_store()])
            x_engine = TorchPolicyEngine()
            x_engine.load([s.policy_set() for s in stores])
            x_fast = AdmissionFastPath(x_engine, CedarAdmissionHandler(
                stores, evaluate_batch=x_engine.evaluate_batch))
            t0 = time.monotonic()
            expected = [r.to_admission_review()["response"] for r in x_fast.handle_raw(bodies)]
            print(f"admission expected answers: library fast path in "
                  f"{time.monotonic() - t0:.2f} s, routing {json.dumps(x_fast.routing)}", flush=True)
            t0 = time.monotonic()
            oracle = [d["response"] for d in interpreter_answers(
                {"admission": ("admission", bodies)}, args.policies, args.seed,
                adm_dir=pol_dir)["admission"]]
            lib_flips = sum(adm_key(e) != adm_key(o) for e, o in zip(expected, oracle))
            print(f"admission interpreter check: {len(oracle)} answers in "
                  f"{time.monotonic() - t0:.1f} s, flips vs the library fast path "
                  f"{lib_flips}", flush=True)
            if lib_flips or len(expected) != len(oracle):
                fail(f"admission phase: {lib_flips} expected answers differ from the interpreter")
            del x_fast, x_engine

            srv.wait_ready(card)

            def snapshot():
                return srv.debug_engine(), http_get(mport, "/metrics")[1].decode()

            doc0, text0 = snapshot()
            if "admission" not in doc0:
                fail(f"/debug/engine has no admission entry: {sorted(doc0)}")
            for path in ("authorization", "admission"):
                eng = doc0[path]["engine"]
                print(f"admission phase {path} engine plane ({card}): L={eng['L']} R={eng['R']} "
                      f"rules={eng['rules']} fallback={eng['fallback_policies']} "
                      f"warm-up launches {json.dumps(eng['warmup_launches'])}", flush=True)
            if any(doc0["admission"]["engine"]["launches"].values()):
                fail(f"admission engine before traffic: {doc0['admission']['engine']}")
            flips = 0
            doc, text = doc0, text0
            for label, n, conc in (("concurrency 1", 300, 1), ("concurrency 64", 4096, 64)):
                wall, lat, n_flips = run_window(port, bodies[:n], expected[:n], conc, "/v1/admit")
                flips += n_flips
                doc2, text2 = snapshot()
                p1, p2 = doc["admission"]["pipeline"], doc2["admission"]["pipeline"]
                n_batches = p2["batches_total"] - p1["batches_total"]
                mean = (p2["rows_total"] - p1["rows_total"]) / max(n_batches, 1)
                l1, l2 = doc["admission"]["engine"]["launches"], doc2["admission"]["engine"]["launches"]
                print(f"admission {label} ({card}): {n / wall:.1f} requests/s, "
                      f"p50 {pct(lat, 50) * 1e3:.3f} ms, p99 {pct(lat, 99) * 1e3:.3f} ms, "
                      f"max {max(lat) * 1e3:.3f} ms, mean batch {mean:.2f} over {n_batches} "
                      f"batches, flips vs expected {n_flips} / {n}; launches "
                      f"{json.dumps({k: l2[k] - l1[k] for k in l2})}", flush=True)
                if label == "concurrency 64" and not mean > 1:
                    fail(f"admission: mean batch {mean:.2f} under 64 clients, want above 1")
                doc, text = doc2, text2
            l0, l1 = doc0["admission"]["engine"]["launches"], doc["admission"]["engine"]["launches"]
            launches = {k: l1[k] - l0[k] for k in l1}
            r0, r1 = (metric_values(t, "cedar_authorizer_row_routing_total", "row_class",
                                    "admission") for t in (text0, text))
            routing = {k: int(r1.get(k, 0) - r0.get(k, 0)) for k in
                       ("clean_native", "gated", "flagged", "encoder_fallback", "encoder_gate")}
            fallback = sum(v for line in text.splitlines()
                           if line.startswith("cedar_authorizer_fallback_batches_total{")
                           for v in [float(line.rsplit(" ", 1)[1])])
            pipe = doc["admission"]["pipeline"]
            print(f"admission windows: launches {json.dumps(launches)}, routing "
                  f"{json.dumps(routing)}, fallback batches {fallback:g}", flush=True)
            print(f"admission batches ({card}): mean "
                  f"{pipe['rows_total'] / max(pipe['batches_total'], 1):.2f}, largest "
                  f"{pipe['largest_batch']}", flush=True)
            if launches["match_words_kernel"] < 1 or launches["match_groups_kernel"] < 1:
                fail(f"admission traffic should launch both kernels: {launches}")
            missing = [k for k in ("gated", "flagged", "encoder_fallback", "encoder_gate")
                       if routing[k] < 1]
            if missing:
                fail(f"admission traffic took no row down {missing}: {routing}")
            if fallback:
                fail(f"admission: {fallback:g} fallback batches")

            # the mixed window: both endpoints at once, from 32 clients each
            n_mix = 2048
            out = {}

            def one(key, path, win):
                out[key] = drive(port, win, 32, path)

            threads = [threading.Thread(target=one, args=("admit", "/v1/admit", bodies[:n_mix])),
                       threading.Thread(target=one, args=("authorize", "/v1/authorize",
                                                          sars[:n_mix]))]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            mixed_wall = time.perf_counter() - t
            for key, want in (("admit", expected), ("authorize", sar_expected)):
                wall, lat, got, errors = out[key]
                if errors:
                    fail(f"mixed window /v1/{key}: client errors {errors[:3]}")
                n_flips = count_flips(f"mixed /v1/{key}", got, want[:n_mix], lat)
                flips += n_flips
                print(f"admission mixed window /v1/{key}, 32 clients ({card}): "
                      f"{n_mix / wall:.1f} requests/s, p50 {pct(lat, 50) * 1e3:.3f} ms, "
                      f"p99 {pct(lat, 99) * 1e3:.3f} ms, flips vs expected {n_flips} / "
                      f"{n_mix}", flush=True)
            print(f"admission mixed window ({card}): {2 * n_mix} requests in {mixed_wall:.3f} s "
                  f"({2 * n_mix / mixed_wall:.1f} requests/s)", flush=True)
            print(f"admission flips over the three windows: {flips}", flush=True)
            if flips:
                fail(f"admission: {flips} answers differ from the expected ones")

            took, rss = srv.terminate()
            print(f"admission webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
        finally:
            srv.kill()
    print(f"admission phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches


# phase 10's edits: a forbid file that flips every watch SAR and every
# admission delete, then admission.cedar without its first forbid
RELOAD_FLIP_POLICY = """
forbid (principal, action == k8s::Action::"watch", resource is k8s::Resource);
forbid (principal, action == k8s::admission::Action::"delete", resource);
"""
ADM_POLICIES_EDITED = "forbid (" + ADM_POLICIES.split("forbid (", 2)[2]


def gpu_memory_mib(pid: int):
    """The card memory of process `pid` in MiB (nvidia-smi
    --query-compute-apps), or None when nvidia-smi does not list it (in a
    container it may see no process of its own)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0] == str(pid):
            return float(parts[1].split()[0])
    return None


def reload_phase(args, card: str, sars: list) -> dict:
    """Phase 10 (module docstring): `sars` are phase 8's gated SAR bodies.
    Returns the server's kernel launch counts over the phase's traffic
    (its served counts: they start at 0, warm-ups count apart)."""
    from cedar_tpu_torch.corpus.synth import synth_source

    t_phase = time.monotonic()
    grace = 5.0
    n_pool = 512
    sars = sars[:n_pool]
    adms = admission_bodies(n_pool, args.seed + 10)
    with tempfile.TemporaryDirectory(prefix="cedar-reload-") as tmp:
        base = {
            "synth.cedar": synth_source(args.policies, seed=args.seed),
            "gated.cedar": FALLBACK_POLICY + NATIVE_OPAQUE_POLICY,
            "admission.cedar": ADM_POLICIES,
            "admission-demo.cedar": ADM_DEMO_OWNER_POLICY,
            "admission-gated.cedar": ADM_FALLBACK_POLICY,
        }
        # versions 0..3: the base, + the flip file, + admission.cedar
        # edited, and the base again (both reverted)
        versions = [base, {**base, "flip.cedar": RELOAD_FLIP_POLICY},
                    {**base, "flip.cedar": RELOAD_FLIP_POLICY,
                     "admission.cedar": ADM_POLICIES_EDITED}, base]
        vdirs = []
        for k, files in enumerate(versions):
            vdir = os.path.join(tmp, f"v{k}")
            os.mkdir(vdir)
            for fname, text in files.items():
                with open(os.path.join(vdir, fname), "w") as f:
                    f.write(text)
            vdirs.append(vdir)
        pol_dir = os.path.join(tmp, "policies")
        os.symlink(vdirs[0], pol_dir)

        def swap_to(k):
            """Re-point the store's directory at version k atomically."""
            link = os.path.join(tmp, "policies.new")
            os.symlink(vdirs[k], link)
            os.replace(link, pol_dir)

        cfg = os.path.join(tmp, "store-config.json")
        with open(cfg, "w") as f:
            json.dump({"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig",
                       "spec": {"stores": [{"type": "directory", "directoryStore": {
                           "path": pol_dir, "refreshInterval": "30s"}}]}}, f)
        # a 10 s request budget, the Kubernetes default for an admission
        # webhook: the phase holds the swap contract, and the serving cost
        # of a reload (the compile shares the interpreter lock with 64
        # closed-loop clients) is reported as latency, with no target
        srv = Webhook(cfg, tmp, "webhook-reload", grace,
                      ("--reload-seconds", "1", "--request-timeout-ms", "10000"))
        port, mport = srv.port, srv.mport
        stop = threading.Event()
        threads = []
        try:
            # the expected answers meanwhile: the interpreter over each
            # version's directory (version 3 is version 0)
            t0 = time.monotonic()
            tasks = {}
            for k in range(3):
                tasks[(k, "/v1/authorize")] = (f"dir-authorize:{vdirs[k]}", sars)
                tasks[(k, "/v1/admit")] = (f"dir-admit:{vdirs[k]}", adms)
            answers = interpreter_answers(tasks, args.policies, args.seed, piece=64)
            keyf = {"/v1/authorize": lambda a: reason_key(a, {}),
                    "/v1/admit": adm_key}
            # the oracle's admission answers are whole AdmissionReviews
            oracle_of = {"/v1/authorize": lambda a: a, "/v1/admit": lambda a: a["response"]}
            want = {path: [[keyf[path](oracle_of[path](a)) for a in answers[(k % 3, path)]]
                           for k in range(4)]
                    for path in ("/v1/authorize", "/v1/admit")}
            print(f"reload oracle: {len(tasks) * n_pool} interpreter answers over 3 versions in "
                  f"{time.monotonic() - t0:.1f} s", flush=True)
            for path in want:
                for k in (1, 2):
                    n = sum(a != b for a, b in zip(want[path][k], want[path][k - 1]))
                    print(f"reload version {k} changes {n} of {n_pool} {path} answers", flush=True)
            srv.wait_ready(card)

            def engines():
                doc = srv.debug_engine()
                return {path: doc[path]["engine"] for path in ("authorization", "admission")}

            eng0 = engines()
            if any(eng0["authorization"]["launches"].values()):
                fail(f"reload: served launches before traffic: {eng0['authorization']['launches']}")

            # traffic: 32 + 32 clients, without pause, until stopped
            records = {"/v1/authorize": [], "/v1/admit": []}
            pools = {"/v1/authorize": sars, "/v1/admit": adms}
            errors = []
            lock = threading.Lock()
            counters = {"/v1/authorize": 0, "/v1/admit": 0}

            def client(path):
                c = Client(port, path)
                try:
                    while not stop.is_set():
                        with lock:
                            i = counters[path] % n_pool
                            counters[path] += 1
                        sent = time.time()
                        got, dt = c.post(pools[path][i])
                        records[path].append((sent, time.time(), i, got, dt))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(f"{path}: {e!r}")
                finally:
                    c.close()

            for path in records:
                for _ in range(32):
                    threads.append(threading.Thread(target=client, args=(path,)))
            for th in threads:
                th.start()
            time.sleep(6.0)
            writes, publishes, mem, launch_marks = [], [], {}, []
            for k in (1, 2, 3):
                gens = {p: e["load_generation"] for p, e in engines().items()}
                t_write = time.time()
                swap_to(k)
                deadline = time.monotonic() + 150
                while True:
                    eng = engines()
                    if all(eng[p]["load_generation"] > gens[p] for p in gens):
                        break
                    if errors or time.monotonic() > deadline:
                        fail(f"reload {k}: the engines did not step within 150 s "
                             f"(generations {gens}, client errors {errors[:3]}):\n{srv.log()}")
                    time.sleep(0.2)
                if any(eng[p]["load_generation"] != gens[p] + 1 for p in gens):
                    fail(f"reload {k}: a generation stepped twice: {gens} -> "
                         f"{ {p: eng[p]['load_generation'] for p in eng} }")
                writes.append(t_write)
                publishes.append({p: eng[p]["last_load"] for p in eng})
                launch_marks.append(eng["authorization"]["launches"])
                for p in ("authorization", "admission"):
                    last = eng[p]["last_load"]
                    print(f"reload {k} {p} engine ({card}): write to swap "
                          f"{last['published_unix'] - t_write:.3f} s, compile seconds "
                          f"{json.dumps(last['compile_seconds'])}", flush=True)
                if k in (1, 3):
                    dm = eng["authorization"]["device_memory"]
                    mem[k] = {"nvidia-smi": gpu_memory_mib(srv.proc.pid),
                              "allocated": dm["allocated"] / 2**20,
                              "reserved": dm["reserved"] / 2**20}
                time.sleep(4.0)
            launch_marks.append(engines()["authorization"]["launches"])
            stop.set()
            for th in threads:
                th.join(timeout=120)
            if any(th.is_alive() for th in threads):
                fail("reload: a client thread did not finish within 120 s")
            if errors:
                fail(f"reload: client errors {errors[:3]}")

            # every answer is that of a version live while it was in flight
            engine_of = {"/v1/authorize": "authorization", "/v1/admit": "admission"}
            problems = []  # every check's failure, reported together at the end
            flips = 0
            for path, recs in records.items():
                pubs = [pb[engine_of[path]]["published_unix"] for pb in publishes]
                bounds = [float("-inf")] + pubs + [float("inf")]
                changed = [0, 0, 0, 0]
                # answers no live version gives, by the version live at
                # their answer: deadline expiries apart from the rest
                odd = {}
                for sent, done, i, got, _dt in recs:
                    live = [v for v in range(4) if bounds[v] < done and bounds[v + 1] > sent]
                    key = keyf[path](got)
                    if not any(key == want[path][v][i] for v in live):
                        flips += 1
                        kind = "deadline" if "deadline of" in json.dumps(got) else "other"
                        at = odd.setdefault(f"version {live[-1]}", {})
                        at[kind] = at.get(kind, 0) + 1
                        if flips <= 3:
                            print(f"reload flip {path} body {i}: live versions {live}, got "
                                  f"{json.dumps(got)}", flush=True)
                    if len(live) == 1 and live[0] and key != want[path][live[0] - 1][i]:
                        changed[live[0]] += 1
                if odd:
                    print(f"reload {path}: answers of no live version {json.dumps(odd)}",
                          flush=True)
                print(f"reload {path}: {len(recs)} answers, answers unlike the previous "
                      f"version's after reloads 1-3: {changed[1:]}", flush=True)
                need = (1, 2, 3) if path == "/v1/admit" else (1, 3)
                if any(changed[k] < 1 for k in need):
                    problems.append(f"{path}: a reload changed no answer: {changed[1:]}")
            print(f"reload flips: {flips}", flush=True)
            if flips:
                problems.append(f"{flips} answers are no version's live while in flight")

            # serving before each write and while each reload compiled,
            # and the first request sent after each swap
            for k, (t_write, pub) in enumerate(zip(writes, publishes), start=1):
                c0 = min(pub[p]["started_unix"] for p in pub)
                c1 = max(pub[p]["published_unix"] for p in pub)
                for path, recs in records.items():
                    row = []
                    for label, lo, hi in (("before", t_write - 5.0, t_write),
                                          ("compiling", c0, c1)):
                        lat = [dt for _s, done, _i, _g, dt in recs if lo <= done < hi]
                        row.append(f"{label} {len(lat) / max(hi - lo, 1e-9):.1f} requests/s "
                                   f"p99 {pct(lat, 99) * 1e3 if lat else float('nan'):.3f} ms "
                                   f"max {max(lat, default=float('nan')) * 1e3:.3f} ms")
                    p_swap = pub[engine_of[path]]["published_unix"]
                    first = min((r for r in recs if r[0] > p_swap), key=lambda r: r[0],
                                default=None)
                    fb = f"{first[4] * 1e3:.3f} ms" if first else "none"
                    print(f"reload {k} {path} ({card}): {'; '.join(row)} (compile window "
                          f"{c1 - c0:.3f} s); first request after the swap {fb}", flush=True)

            # both kernels launched on each new plane
            for k in (1, 2, 3):
                a, b = launch_marks[k - 1], launch_marks[k]
                if not all(b[n] > a[n] for n in a):
                    problems.append(f"reload {k}: launches did not rise after the swap: "
                                    f"{a} -> {b}")
            launches = launch_marks[-1]
            text = http_get(mport, "/metrics")[1].decode()
            fallback = sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                           if line.startswith("cedar_authorizer_fallback_batches_total{"))
            compiles = [line for line in text.splitlines()
                        if line.startswith("cedar_compile_seconds_count{")]
            print(f"reload launches {json.dumps(launches)}, fallback batches {fallback:g}, "
                  f"{'; '.join(compiles)}", flush=True)
            if fallback:
                problems.append(f"{fallback:g} fallback batches")
            plane = max(e["device_bytes"] for e in engines().values()) / 2**20
            print(f"reload card memory of the server, MiB ({card}; nvidia-smi's per-process "
                  f"figure where it lists the server, and the server's allocator): after reload "
                  f"1 {json.dumps(mem[1])}, after reload 3 {json.dumps(mem[3])}; one plane "
                  f"{plane:.1f} MiB", flush=True)
            for what in ("nvidia-smi", "allocated", "reserved"):
                if mem[1][what] is not None and mem[3][what] - mem[1][what] > plane:
                    problems.append(f"card memory ({what}) grew by "
                                    f"{mem[3][what] - mem[1][what]:.1f} MiB over reloads 2-3, "
                                    f"more than one plane ({plane:.1f} MiB)")
            took, rss = srv.terminate()
            print(f"reload webhook: SIGTERM -> exit code 0 in {took:.2f} s; server peak RSS "
                  f"({card}): {rss}", flush=True)
            if problems:
                fail("reload: " + "; ".join(problems))
        finally:
            stop.set()
            srv.kill()
    print(f"reload phase wall time ({card}): {time.monotonic() - t_phase:.1f} s", flush=True)
    return launches

if __name__ == "__main__":
    main()
