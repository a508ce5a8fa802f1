"""The port's native SAR encoder (cedar_tpu_torch/native) against the JAX
package and against the port's own Python encoder, exactly (tolerance 0).

  * serialize_table: the activation-table blob the C++ side loads equals
    the JAX package's byte for byte, over the same policy sets (the JAX
    serializer is pure Python: importing cedar_tpu.native builds nothing);
  * NativeEncoder: codes, extras, counts and flags equal the port's Python
    pipeline (server/sar.py -> authorizer.record_to_cedar_resource ->
    compiler/table.py encode_request_codes) on randomized SARs, whatever
    the thread count; parse-error, extras-overflow, self-allow and
    system-skip rows get their flags;
  * native/build.py: concurrent builders in several processes share one
    build, and a failed build raises.

Nothing here needs the JAX package's compiled native library.
"""

import json
import os
import pathlib
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import yaml

from cedar_tpu import native as jnative
from cedar_tpu.compiler.lower import AUTHZ_SCHEMA_INFO as J_SCHEMA
from cedar_tpu.compiler.lower import lower_tiers as j_lower
from cedar_tpu.compiler.pack import pack as j_pack
from cedar_tpu.corpus import synth as j_synth
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu_torch import native as tnative
from cedar_tpu_torch.compiler.lower import AUTHZ_SCHEMA_INFO as T_SCHEMA
from cedar_tpu_torch.compiler.lower import lower_tiers as t_lower
from cedar_tpu_torch.compiler.pack import pack as t_pack
from cedar_tpu_torch.compiler.table import encode_request_codes
from cedar_tpu_torch.corpus import synth as t_synth
from cedar_tpu_torch.lang import PolicySet as TPolicySet
from cedar_tpu_torch.native import build as tbuild
from cedar_tpu_torch.server.authorizer import record_to_cedar_resource
from cedar_tpu_torch.server.sar import get_authorizer_attributes

REPO = pathlib.Path(__file__).resolve().parent.parent

# the policy texts of the JAX package's server fast-path tests
SRV_POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
forbid (principal, action, resource is k8s::Resource)
  when { resource.resource == "nodes" };
forbid (principal is k8s::User,
        action == k8s::admission::Action::"create",
        resource is core::v1::ConfigMap)
  when { resource.metadata has labels &&
         resource.metadata.labels.contains({key: "env", value: "prod"}) };
"""
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
JOIN_POLICY = """
permit (principal is k8s::ServiceAccount, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.namespace == resource.namespace };
"""
RESOURCE_JOIN_POLICY = """
permit (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && resource has namespace &&
         resource.name == resource.namespace };
"""
NATIVE_OPAQUE_POLICY = """
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""
SRV_TEXTS = {
    "srv": SRV_POLICIES,
    "fallback": FALLBACK_POLICY,
    "join": JOIN_POLICY,
    "resource_join": RESOURCE_JOIN_POLICY,
    "native_opaque": NATIVE_OPAQUE_POLICY,
}

# the JAX package's native-encoder test policies: principal typing, like
# patterns, set membership, selectors, impersonation, non-resource URLs
ENC_POLICIES = """
permit (
    principal,
    action in [k8s::Action::"get", k8s::Action::"list", k8s::Action::"watch"],
    resource is k8s::Resource
) when { principal.name == "test-user" && resource.resource == "pods" };

forbid (principal, action, resource is k8s::Resource)
    when { resource.resource == "nodes" && principal.name like "dev-*" };

permit (principal in k8s::Group::"viewers", action == k8s::Action::"get",
        resource is k8s::Resource)
    unless { resource.resource == "secrets" && resource.apiGroup == "" };

permit (principal is k8s::ServiceAccount, action, resource is k8s::Resource)
    when { principal.namespace == "kube-system" };

permit (principal is k8s::Node, action == k8s::Action::"get",
        resource is k8s::Resource)
    when { resource has namespace && resource.namespace == "ns-1" };

permit (principal, action == k8s::Action::"get", resource is k8s::NonResourceURL)
    when { resource.path == "/healthz" };

permit (principal, action == k8s::Action::"get", resource is k8s::NonResourceURL)
    when { resource.path like "/metrics*" };

permit (principal, action == k8s::Action::"impersonate",
        resource is k8s::ServiceAccount)
    when { resource.namespace == "default" };

permit (principal, action == k8s::Action::"impersonate", resource is k8s::Node);

forbid (principal, action in [k8s::Action::"list", k8s::Action::"watch"],
        resource is k8s::Resource)
    when {
        resource.resource == "secrets" &&
        !(resource has labelSelector &&
          resource.labelSelector.contains({
              key: "confidentiality", operator: "in", values: ["public"]}))
    };

permit (principal == k8s::User::"exact-uid-user", action, resource is k8s::Resource)
    when { resource.resource == "configmaps" };

permit (principal, action, resource is k8s::Resource)
    when { ["pods", "services"].contains(resource.resource) &&
           principal.name == "multi" };
"""

USERS = [
    {"user": "test-user", "uid": "u1", "groups": ["viewers", "devs"]},
    {"user": "dev-alice", "uid": "", "groups": ["devs"]},
    {"user": "multi", "uid": "m", "groups": []},
    {"user": "exact-uid-user", "uid": "exact-uid-user", "groups": ["g%d" % i for i in range(12)]},
    {"user": "system:serviceaccount:kube-system:builder", "uid": "sa9",
     "groups": ["system:serviceaccounts"]},
    {"user": "system:serviceaccount:default:app", "uid": "", "groups": []},
    {"user": "system:node:node-7", "uid": "n7", "groups": ["system:nodes"]},
    {"user": "system:kube-scheduler", "uid": "", "groups": []},  # gate: skip
    {"user": "system:authorizer:cedar-authorizer", "uid": "", "groups": []},
    {"user": "üser-ünïcode", "uid": "", "groups": ["tëam"]},
]
RESOURCES = ["pods", "nodes", "secrets", "configmaps", "services", "zzz"]
VERBS = ["get", "list", "watch", "create", "delete", "impersonate"]
NAMESPACES = ["", "default", "ns-1", "kube-system"]


def random_sar(rng: random.Random) -> dict:
    """A randomized SubjectAccessReview: principal kinds, extra, resource
    and non-resource requests, impersonation, label and field selectors,
    and the users the authorizer's gates short-circuit."""
    user = rng.choice(USERS)
    spec = {"user": user["user"], "uid": user["uid"], "groups": list(user["groups"])}
    if rng.random() < 0.3:
        spec["extra"] = {
            "Authentication.K8s.IO/Node-Name": ["node-%d" % rng.randint(0, 3)],
            "scopes": ["a", "b"] if rng.random() < 0.5 else [],
        }
    if rng.random() < 0.15:
        spec["nonResourceAttributes"] = {
            "path": rng.choice(["/healthz", "/metrics", "/metrics/cadvisor", "/version"]),
            "verb": rng.choice(["get", "post"]),
        }
    else:
        verb = rng.choice(VERBS)
        ra = {
            "verb": verb,
            "version": "v1",
            "resource": rng.choice(
                ["serviceaccounts", "users", "groups", "uids", "userextras", "pods"]
            )
            if verb == "impersonate"
            else rng.choice(RESOURCES),
            "group": rng.choice(["", "apps", "cedar.k8s.aws", "rbac.authorization.k8s.io"]),
        }
        ns = rng.choice(NAMESPACES)
        if ns:
            ra["namespace"] = ns
        if rng.random() < 0.5:
            ra["name"] = rng.choice(["app-1", "system:node:node-7", "policies"])
        if rng.random() < 0.3:
            ra["subresource"] = rng.choice(["status", "log", "node-name"])
        if rng.random() < 0.35:
            ra["labelSelector"] = {"requirements": [{
                "key": "confidentiality",
                "operator": rng.choice(["In", "NotIn", "Exists", "DoesNotExist", "Bogus"]),
                "values": rng.choice([["public"], ["secret", "public"], []]),
            }]}
        if rng.random() < 0.2:
            ra["fieldSelector"] = {"requirements": [{
                "key": "spec.nodeName",
                "operator": rng.choice(["In", "NotIn", "Exists"]),
                "values": rng.choice([["node-7"], ["a", "b"], []]),
            }]}
        spec["resourceAttributes"] = ra
    return {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview", "spec": spec}


def gate_expected(sar: dict):
    """The encoder flag the authorizer's gates give this SAR, or None."""
    spec = sar["spec"]
    name = spec["user"]
    ra = spec.get("resourceAttributes") or {}
    read_only = ra.get("verb") in ("get", "list", "watch") if ra else \
        (spec.get("nonResourceAttributes") or {}).get("verb") in ("get", "list", "watch")
    if name == "system:authorizer:cedar-authorizer" and read_only and ra:
        if ra.get("group") == "cedar.k8s.aws" and ra.get("resource") == "policies":
            return tnative.F_SELF_ALLOW_POLICIES
        if ra.get("group") == "rbac.authorization.k8s.io":
            return tnative.F_SELF_ALLOW_RBAC
    if name.startswith("system:") and not name.startswith(
        ("system:serviceaccount:", "system:node:")
    ):
        return tnative.F_SYSTEM_SKIP
    return None


def demo_source() -> str:
    docs = [d for d in yaml.safe_load_all((REPO / "demo/authorization-policy.yaml").read_text()) if d]
    return "\n".join(d["spec"]["content"] for d in docs)


# ------------------------------------------------------------ serialize_table


def _source_sets():
    sets = {"demo": demo_source(), "encoder": ENC_POLICIES}
    for name, text in SRV_TEXTS.items():
        sets[name] = text
        if name != "srv":
            sets[f"srv+{name}"] = SRV_POLICIES + text
    return sets


SOURCE_SETS = _source_sets()


@pytest.mark.parametrize("name", sorted(SOURCE_SETS))
def test_serialize_table_matches_jax_on_policy_text(name):
    src = SOURCE_SETS[name]
    j = j_pack(j_lower([JPolicySet.from_source(src, "p")], J_SCHEMA))
    t = t_pack(t_lower([TPolicySet.from_source(src, "p")], T_SCHEMA))
    jb = jnative.serialize_table(j.plan, j.table)
    tb = tnative.serialize_table(t.plan, t.table)
    assert tb is not None
    assert tb == jb


@pytest.mark.parametrize("corpus", ["synth0", "synth1", "synth2", "synth3", "coverage"])
def test_serialize_table_matches_jax_on_corpus(corpus):
    if corpus == "coverage":
        jt = j_synth.coverage_corpus(per_family=2, base=16, seed=0).tiers()
        tt = t_synth.coverage_corpus(per_family=2, base=16, seed=0).tiers()
    else:
        seed = int(corpus[-1])
        jt = j_synth.synth_corpus(200, seed=seed).tiers()
        tt = t_synth.synth_corpus(200, seed=seed).tiers()
    j = j_pack(j_lower(jt, J_SCHEMA))
    t = t_pack(t_lower(tt, T_SCHEMA))
    assert tnative.serialize_table(t.plan, t.table) == jnative.serialize_table(j.plan, j.table)


def test_jax_serializer_builds_nothing():
    """The blob comparisons above use only the JAX package's pure-Python
    serializer: in a fresh process, importing cedar_tpu.native and
    serializing a table loads (and builds) no library."""
    code = (
        "from cedar_tpu import native\n"
        "from cedar_tpu.compiler.lower import AUTHZ_SCHEMA_INFO, lower_tiers\n"
        "from cedar_tpu.compiler.pack import pack\n"
        "from cedar_tpu.lang import PolicySet\n"
        f"p = pack(lower_tiers([PolicySet.from_source({JOIN_POLICY!r}, 'p')], AUTHZ_SCHEMA_INFO))\n"
        "assert native.serialize_table(p.plan, p.table)\n"
        "assert native._lib is None and native._lib_error is None\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -------------------------------------------------------------- the encoder


def _packed(src):
    return t_pack(t_lower([TPolicySet.from_source(src, "native-test")], T_SCHEMA))


@pytest.fixture(scope="module")
def enc_packed():
    return _packed(ENC_POLICIES)


def _check_against_python(packed, sars, codes, extras, counts, flags):
    n_ok = 0
    for i, sar in enumerate(sars):
        gate = gate_expected(sar)
        if gate is not None:
            assert flags[i] == gate, sar
            continue
        assert flags[i] == tnative.F_OK, (flags[i], sar)
        em, req = record_to_cedar_resource(get_authorizer_attributes(sar))
        py_codes, py_extras = encode_request_codes(packed.plan, packed.table, em, req)
        assert codes[i].tolist() == py_codes, sar
        assert sorted(extras[i, : counts[i]].tolist()) == sorted(py_extras), sar
        assert (extras[i, counts[i]:] == packed.L).all()
        n_ok += 1
    return n_ok


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_encoder_matches_python_encoder(enc_packed, seed):
    enc = tnative.NativeEncoder.create(enc_packed)
    rng = random.Random(seed)
    sars = [random_sar(rng) for _ in range(400)]
    codes, extras, counts, flags = enc.encode_batch([json.dumps(s).encode() for s in sars])
    assert _check_against_python(enc_packed, sars, codes, extras, counts, flags) > 200
    assert counts.max() > 0  # like patterns and set membership made extras


@pytest.mark.parametrize("name", ["demo", "srv+join", "srv+resource_join", "srv+fallback"])
def test_encoder_matches_python_encoder_per_policy_set(name):
    packed = _packed(SOURCE_SETS[name])
    enc = tnative.NativeEncoder.create(packed)
    rng = random.Random(name)
    sars = [random_sar(rng) for _ in range(150)]
    for i, s in enumerate(sars[:40]):  # joins: principal/resource namespaces
        s["spec"]["user"] = "system:serviceaccount:%s:app" % ("default", "ns-1")[i % 2]
        s["spec"].pop("nonResourceAttributes", None)
        s["spec"]["resourceAttributes"] = {
            "verb": ("get", "deletecollection")[i % 2], "version": "v1", "resource": "pods",
            "namespace": "default", "name": ("default", "127.0.0.1", "x")[i % 3],
        }
    codes, extras, counts, flags = enc.encode_batch([json.dumps(s).encode() for s in sars])
    assert _check_against_python(packed, sars, codes, extras, counts, flags) > 60


def test_encoder_on_synth_traffic():
    corpus = t_synth.synth_corpus(200, seed=0)
    packed = t_pack(t_lower(corpus.tiers(), T_SCHEMA))
    enc = tnative.NativeEncoder.create(packed)
    bodies = corpus.sar_bodies(300, seed=1)
    codes, extras, counts, flags = enc.encode_batch(bodies)
    sars = [json.loads(b) for b in bodies]
    assert _check_against_python(packed, sars, codes, extras, counts, flags) == 300


@pytest.mark.parametrize("n_threads", [2, 3, 4, 8, 16])
def test_encode_thread_count_invariance(enc_packed, n_threads):
    """The encoder's thread pool is a throughput knob only: any thread
    count gives the same bytes."""
    enc = tnative.NativeEncoder.create(enc_packed)
    rng = random.Random(11)
    bodies = [json.dumps(random_sar(rng)).encode() for _ in range(500)]
    base = enc.encode_batch(bodies, n_threads=1)
    for a, b in zip(base, enc.encode_batch(bodies, n_threads=n_threads)):
        np.testing.assert_array_equal(a, b)


def test_encode_batch_into_pads_only_the_live_rows(enc_packed):
    """encode_batch_into over larger (bucket-sized) buffers writes the first
    n rows as encode_batch does and leaves the rest to the caller; both
    entries (the bodies list and any other sequence) agree."""
    enc = tnative.NativeEncoder.create(enc_packed)
    rng = random.Random(5)
    bodies = [json.dumps(random_sar(rng)).encode() for _ in range(50)]
    want = enc.encode_batch(bodies)
    for seq in (list(bodies), tuple(bodies)):
        codes = np.full((64, enc.n_slots), -7, np.int32)
        extras = np.full((64, enc.DEFAULT_EXTRAS_CAP), -7, np.int32)
        counts = np.empty(50, np.int32)
        flags = np.empty(50, np.uint8)
        assert enc.encode_batch_into(seq, codes, extras, counts, flags) == 50
        for a, b in zip(want, (codes[:50], extras[:50], counts, flags)):
            np.testing.assert_array_equal(a, b)
        assert (codes[50:] == -7).all() and (extras[50:] == -7).all()


def test_encode_batch_into_rejects_bad_buffers(enc_packed):
    enc = tnative.NativeEncoder.create(enc_packed)
    body = [json.dumps(random_sar(random.Random(1))).encode()]
    ok = dict(
        codes=np.empty((1, enc.n_slots), np.int32),
        extras=np.empty((1, 8), np.int32),
        counts=np.empty(1, np.int32),
        flags=np.empty(1, np.uint8),
    )
    bad = [
        ("codes", np.empty((1, enc.n_slots), np.int64)),
        ("codes", np.empty((1, enc.n_slots + 1), np.int32)),
        ("extras", np.empty((4, 8), np.int32)[::2]),
        ("flags", np.empty(0, np.uint8)),
    ]
    for name, arr in bad:
        args = dict(ok, **{name: arr})
        with pytest.raises(ValueError):
            enc.encode_batch_into(body, **args)


def _flag_bodies():
    good = {"apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
            "spec": {"user": "test-user", "uid": "u", "groups": ["viewers"],
                     "resourceAttributes": {"verb": "get", "version": "v1",
                                            "resource": "pods", "namespace": "default"}}}
    me = "system:authorizer:cedar-authorizer"

    def with_(**kw):
        s = json.loads(json.dumps(good))
        s["spec"].update(kw.pop("spec", {}))
        s["spec"]["resourceAttributes"].update(kw)
        return json.dumps(s).encode()

    return {
        "parse_error": [b'{"not": "valid json', b"[" * 100_000, b"", b"\xff\xfe"],
        "self_allow_policies": [with_(spec={"user": me}, group="cedar.k8s.aws",
                                      resource="policies", verb=v) for v in ("get", "list")],
        "self_allow_rbac": [with_(spec={"user": me}, group="rbac.authorization.k8s.io",
                                  resource="roles", verb=v) for v in ("get", "watch")],
        "system_skip": [with_(spec={"user": u}) for u in ("system:kube-scheduler", "system:apiserver")],
        "ok": [json.dumps(good).encode()],
    }


@pytest.mark.parametrize("family,flag", [
    ("parse_error", tnative.F_PARSE_ERROR),
    ("self_allow_policies", tnative.F_SELF_ALLOW_POLICIES),
    ("self_allow_rbac", tnative.F_SELF_ALLOW_RBAC),
    ("system_skip", tnative.F_SYSTEM_SKIP),
    ("ok", tnative.F_OK),
])
def test_encoder_flags(enc_packed, family, flag):
    enc = tnative.NativeEncoder.create(enc_packed)
    bodies = _flag_bodies()[family]
    _c, _e, _n, flags = enc.encode_batch(bodies)
    assert flags.tolist() == [flag] * len(bodies)


def test_encoder_flags_extras_overflow(enc_packed):
    """A row whose extras do not fit the buffer's width is flagged for the
    Python path; rows that fit are not."""
    enc = tnative.NativeEncoder.create(enc_packed)
    rng = random.Random(3)
    bodies = [json.dumps(random_sar(rng)).encode() for _ in range(300)]
    _c, _e, counts, flags = enc.encode_batch(bodies)
    ok = flags == tnative.F_OK
    assert (counts[ok] >= 2).any() and (counts[ok] <= 1).any()
    _c1, _e1, counts1, flags1 = enc.encode_batch(bodies, extras_cap=1)
    over = ok & (counts >= 2)
    assert (flags1[over] == tnative.F_EXTRAS_OVERFLOW).all()
    assert (flags1[ok & (counts <= 1)] == tnative.F_OK).all()
    assert (flags1[~ok] == flags[~ok]).all()


def test_unsupported_value_kind_raises():
    """A table holding a value kind outside the blob's canonical format
    has no native encoder: create() raises instead of answering wrong."""

    class Odd:
        pass

    packed = _packed(ENC_POLICIES)
    slot = next(iter(packed.table.scalar_vocab))
    packed.table.scalar_vocab[slot][("x", Odd())] = 1
    assert tnative.serialize_table(packed.plan, packed.table) is None
    with pytest.raises(ValueError, match="value kind"):
        tnative.NativeEncoder.create(packed)


# ------------------------------------------------------------------ the build

FAKE_CXX = textwrap.dedent("""\
    #!/bin/sh
    # stands in for g++: sleeps, counts the call, writes the -o file
    out=""
    while [ $# -gt 0 ]; do
      if [ "$1" = "-o" ]; then out="$2"; fi
      shift
    done
    sleep 0.5
    echo call >> "$FAKE_CXX_LOG"
    printf 'built' > "$out"
""")


def test_concurrent_builds_share_one_compile(tmp_path):
    """Six processes build into one empty directory at once: every one
    gets the finished library, and the compiler ran once (the flock
    serializes the builders; each looks again under the lock)."""
    cxx = tmp_path / "fake-cxx"
    cxx.write_text(FAKE_CXX)
    cxx.chmod(0o755)
    build_dir = tmp_path / "_build"
    log = tmp_path / "calls.log"
    env = dict(os.environ, CXX=str(cxx), FAKE_CXX_LOG=str(log))
    code = (
        "import pathlib, sys\n"
        "from cedar_tpu_torch.native import build\n"
        f"print(build.ensure_built(pathlib.Path({str(build_dir)!r})))\n"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    lib = pathlib.Path(paths.pop())
    assert lib.parent == build_dir and lib.read_text() == "built"
    assert log.read_text().splitlines() == ["call"]
    # no temporary file is left behind
    assert sorted(p.name for p in build_dir.iterdir()) == sorted([lib.name, "lock"])


def test_failed_build_raises_and_is_not_remembered(tmp_path, monkeypatch):
    build_dir = tmp_path / "_build"
    monkeypatch.setenv("CXX", "false")
    for _ in range(2):  # the failure is not cached: each call compiles again
        with pytest.raises(RuntimeError, match="native encoder build .* failed"):
            tbuild.ensure_built(build_dir)
    assert not tbuild.library_path(build_dir).exists()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        tbuild.ensure_built(build_dir)
    assert [p.name for p in build_dir.iterdir()] == ["lock"]


def test_library_path_names_the_glue_state():
    path = tbuild.library_path()
    assert path.parent == tbuild.BUILD_DIR
    assert path.name.startswith("libcedar_native_glue_" if tbuild.glue_include() else "libcedar_native_")
    assert tbuild.SRC == REPO / "cedar_tpu_torch" / "native" / "encoder.cpp"
