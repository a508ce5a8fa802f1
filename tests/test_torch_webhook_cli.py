"""The port's webhook CLI (cedar_tpu_torch/cli/webhook.py) and the config
and store modules under it, against the JAX package's, on the CPU.

  * every flag the port serves has the JAX parser's default, except
    --backend (the port serves from the card by default) and the port's
    own --device; each decision cache, observability and game-day flag
    parses as the JAX parser parses it; a JAX flag the port does not
    serve is rejected;
  * --pdp-listen and --pdp-schema parse as the JAX parser parses them,
    PDP is off by default, a bad schema file or address fails
    build_server before any store starts, and [ADDR:]PORT binds the
    listener where the JAX CLI binds it; the listener answers a check;
  * --device cuda (the default) without CUDA exits nonzero at start; a
    spawned --device cpu --insecure server (JAX blocked at import) answers
    a SAR and exits 0 on SIGTERM; build_server wires each backend and
    takes every device path once before it serves;
  * a StoreConfig parses to the same CedarConfig as the JAX parse_config,
    JSON and YAML; every validation mode builds stores that carry it, and
    --validation-mode overrides it; strict ends the CLI with exit code 1
    on a corpus with a blocking finding, partial and permissive serve;
  * the directory store loads, names and quarantines policies as the JAX
    one does.
"""

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from cedar_tpu.apis.v1alpha1 import ValidationError as JValidationError
from cedar_tpu.cli.webhook import make_parser as j_make_parser
from cedar_tpu.stores.config import cedar_config_stores as j_cedar_config_stores
from cedar_tpu.stores.config import parse_config as j_parse_config
from cedar_tpu.stores.directory import DirectoryPolicyStore as JDirectoryPolicyStore
from cedar_tpu.stores.quarantine import quarantine_registry as j_quarantine_registry
from cedar_tpu_torch.apis.v1alpha1 import ValidationError
from cedar_tpu_torch.cli.webhook import build_server, make_parser
from cedar_tpu_torch.engine.fastpath import SARFastPath
from cedar_tpu_torch.stores.config import cedar_config_stores, parse_config
from cedar_tpu_torch.stores.directory import DirectoryPolicyStore
from cedar_tpu_torch.stores.quarantine import quarantine_registry

REPO = pathlib.Path(__file__).resolve().parent.parent

PORTED_FLAGS = [
    "--config", "--batch-window-us", "--max-batch", "--pipeline-depth",
    "--encode-workers", "--native-encode-threads", "--no-native", "--bind-address",
    "--secure-port", "--metrics-port", "--cert-dir", "--tls-cert-file",
    "--tls-private-key-file", "--insecure", "--request-timeout-ms",
    "--shutdown-grace-seconds", "--admission-fail-mode", "-v",
    "--breaker-failure-threshold", "--breaker-latency-threshold-ms",
    "--breaker-recovery-seconds", "--breaker-half-open-probes",
    "--supervisor-interval-seconds", "--supervisor-wedge-seconds",
    "--confirm-non-prod-inject-errors", "--chaos-scenario", "--validation-mode",
    "--decision-cache-size", "--decision-cache-allow-ttl-seconds",
    "--decision-cache-deny-ttl-seconds", "--decision-cache-no-opinion-ttl-seconds",
    "--decision-cache-admission",
    "--trace-sample-rate", "--trace-tail-ms", "--trace-ring", "--trace-log-file", "--no-trace",
    "--audit-log-file", "--audit-max-bytes", "--audit-max-files", "--slo-availability-target",
    "--slo-latency-target", "--slo-latency-budget-ms", "--artificial-error-rate",
    "--artificial-deny-rate", "--enable-recording", "--recording-dir",
    "--lifecycle-spec-dir", "--lifecycle-journal-file", "--lifecycle-interval-seconds",
    "--profiling", "--tenant", "--tenant-header", "--tenant-host", "--tenant-default",
    "--tenant-sources", "--pdp-listen", "--pdp-schema",
]
# JAX flags of subsystems the port does not serve yet, each with a value
UNPORTED_FLAGS = [
    ["--pod-num-processes", "2"], ["--fleet-replicas", "2"], ["--partition-spec", "/tmp/p.json"],
    ["--aot-cache-dir", "/tmp/aot"], ["--pallas", "on"], ["--hedge-delay-ms", "5"],
    ["--fanout-workers", "2"], ["--tpu-reload-seconds", "1"],
]
POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get", resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
forbid (principal, action, resource is k8s::Resource)
  when { resource.resource == "nodes" };
"""
SAM_PODS = json.dumps({"spec": {"user": "sam", "uid": "u", "resourceAttributes": {
    "verb": "get", "resource": "pods", "version": "v1"}}}).encode()
BOB_NODES = json.dumps({"spec": {"user": "bob", "uid": "u", "resourceAttributes": {
    "verb": "get", "resource": "nodes", "version": "v1"}}}).encode()

# runs the CLI module as __main__ with jax and the JAX package unimportable
BLOCKED_MAIN = (
    "import runpy, sys\n"
    "BLOCKED = ('jax', 'jaxlib', 'cedar_tpu')\n"
    "for m in list(sys.modules):\n"
    "    if m.split('.')[0] in BLOCKED:\n"
    "        del sys.modules[m]\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in BLOCKED:\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv[0] = 'cedar-webhook'\n"
    "runpy.run_module('cedar_tpu_torch.cli.webhook', run_name='__main__', alter_sys=True)\n"
)


@pytest.mark.parametrize("flag", PORTED_FLAGS)
def test_ported_flag_defaults_equal_jax(flag):
    jp, tp = j_make_parser(), make_parser()
    j_args, t_args = jp.parse_args([]), tp.parse_args([])
    j_act, t_act = jp._option_string_actions[flag], tp._option_string_actions[flag]
    assert getattr(t_args, t_act.dest) == getattr(j_args, j_act.dest)
    assert (t_act.type, t_act.nargs, type(t_act).__name__) == (
        j_act.type, j_act.nargs, type(j_act).__name__)


def test_backend_and_device_defaults():
    """The deliberate differences: the device backend by default (the
    JAX CLI defaults to its interpreter), on CUDA unless told otherwise."""
    args = make_parser().parse_args([])
    assert (args.backend, args.device) == ("device", "cuda")
    assert j_make_parser().parse_args([]).backend == "interpreter"
    assert set(make_parser()._option_string_actions["--backend"].choices) == {"interpreter", "device"}


# each decision cache flag with a value other than its default
CACHE_FLAGS = [
    ["--decision-cache-size", "8"], ["--decision-cache-allow-ttl-seconds", "12.5"],
    ["--decision-cache-deny-ttl-seconds", "0"], ["--decision-cache-no-opinion-ttl-seconds", "1.5"],
    ["--decision-cache-admission"],
]


@pytest.mark.parametrize("argv", CACHE_FLAGS, ids=lambda a: a[0])
def test_cache_flag_parses_as_jax(argv):
    """A decision cache flag parses to the JAX CLI's value, and its
    defaults are the JAX CLI's (size 65536, TTLs 300 / 30 / 5 s, no
    admission cache)."""
    jp, tp = j_make_parser(), make_parser()
    dest = tp._option_string_actions[argv[0]].dest
    assert getattr(tp.parse_args(argv), dest) == getattr(jp.parse_args(argv), dest)
    assert getattr(tp.parse_args([]), dest) == getattr(jp.parse_args([]), dest)
    defaults = tp.parse_args([])
    assert (defaults.decision_cache_size, defaults.decision_cache_allow_ttl_seconds,
            defaults.decision_cache_deny_ttl_seconds,
            defaults.decision_cache_no_opinion_ttl_seconds,
            defaults.decision_cache_admission) == (65536, 300.0, 30.0, 5.0, False)


# each observability and game-day flag with a value other than its default
OBS_FLAGS = [
    ["--trace-sample-rate", "0.25"], ["--trace-tail-ms", "40"], ["--trace-ring", "64"],
    ["--trace-log-file", "t.jsonl"], ["--no-trace"], ["--audit-log-file", "a.jsonl"],
    ["--audit-max-bytes", "8192"], ["--audit-max-files", "5"],
    ["--slo-availability-target", "0.99"], ["--slo-latency-target", "0.9"],
    ["--slo-latency-budget-ms", "250"], ["--artificial-error-rate", "0.1"],
    ["--artificial-deny-rate", "2"], ["--enable-recording"], ["--recording-dir", "rec"],
]


@pytest.mark.parametrize("argv", OBS_FLAGS, ids=lambda a: a[0])
def test_obs_flag_parses_as_jax(argv):
    """An observability or game-day flag parses to the JAX CLI's value;
    the defaults arm tracing at rate 0 and the SLO tracker, as the JAX
    CLI's do."""
    jp, tp = j_make_parser(), make_parser()
    dest = tp._option_string_actions[argv[0]].dest
    assert getattr(tp.parse_args(argv), dest) == getattr(jp.parse_args(argv), dest)
    defaults = tp.parse_args([])
    assert (defaults.no_trace, defaults.trace_sample_rate, defaults.slo_availability_target,
            defaults.audit_log_file, defaults.enable_recording) == (False, 0.0, 0.999, "", False)


@pytest.mark.parametrize("argv", UNPORTED_FLAGS, ids=lambda a: a[0])
def test_unported_jax_flag_is_rejected(argv):
    j_make_parser().parse_args(argv)  # a real JAX flag
    with pytest.raises(SystemExit) as ei:
        make_parser().parse_args(argv)
    assert ei.value.code == 2


def _config(tmp_path, stores=None, **spec):
    d = tmp_path / "policies"
    d.mkdir(exist_ok=True)
    (d / "p.cedar").write_text(POLICIES)
    doc = {"apiVersion": "cedar.k8s.aws/v1alpha1", "kind": "StoreConfig", "spec": {
        "stores": stores if stores is not None else [
            {"type": "directory", "directoryStore": {"path": str(d)}}],
        **spec,
    }}
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(doc))
    return cfg


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_default_device_without_cuda_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device starts")
    cfg = _config(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_MAIN, "--config", str(cfg), "--insecure",
         "--secure-port", "0", "--metrics-port", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/authorize", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["status"]


@pytest.mark.parametrize("depth", ["0", "2"])
def test_spawned_cpu_server_answers_and_exits_on_sigterm(tmp_path, depth):
    """The entry point a user runs, with jax and the JAX package blocked at
    import: it starts, answers, and exits 0 on SIGTERM within the grace."""
    cfg = _config(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-c", BLOCKED_MAIN, "--config", str(cfg), "--device", "cpu",
         "--insecure", "--secure-port", "0", "--metrics-port", "0",
         "--pipeline-depth", depth, "--shutdown-grace-seconds", "2"],
        cwd=tmp_path, env=_env(), stderr=subprocess.PIPE, text=True,
    )
    try:
        port = mport = None
        deadline = time.monotonic() + 120
        lines = []
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "serving on http://" in line:
                port = int(line.split("serving on http://127.0.0.1:")[1].split()[0])
                mport = int(line.split("metrics http://127.0.0.1:")[1].rstrip(")\n"))
        assert port is not None, "".join(lines)
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/readyz", timeout=30) as r:
            assert r.status == 200
        assert _post(port, SAM_PODS)["allowed"] is True
        assert _post(port, BOB_NODES)["denied"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=2 + 5) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


@pytest.mark.parametrize("flags,fast", [
    (["--backend", "interpreter"], False),
    (["--device", "cpu"], True),
    (["--device", "cpu", "--no-native"], False),
])
def test_build_server_backends(tmp_path, flags, fast):
    cfg = _config(tmp_path)
    args = make_parser().parse_args(
        ["--config", str(cfg), "--insecure", "--secure-port", "0", "--metrics-port", "0", *flags])
    srv = build_server(args)
    srv.start()
    try:
        assert isinstance(srv.fastpath, SARFastPath) == fast
        assert _post(srv.bound_port, SAM_PODS)["allowed"] is True
        assert _post(srv.bound_port, BOB_NODES)["denied"] is True
    finally:
        srv.stop()


@pytest.mark.parametrize("flags", [[], ["--pipeline-depth", "0"], ["--no-native"]],
                         ids=["pipelined", "serial", "no-native"])
def test_build_server_warms_every_device_path_before_serving(tmp_path, monkeypatch, flags):
    """build_server takes the words, want_full, in-launch bitset and plain
    bitset paths before the server exists, so the first requests'
    deadlines never pay their first-use costs; the warm-up leaves the
    answers and the flagged-row count as they were."""
    from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine

    taken = []
    launch, bits = TorchPolicyEngine.match_arrays_launch, TorchPolicyEngine.match_bits_arrays_launch

    def spy_launch(self, *a, want_full=False, want_bits=False, **k):
        taken.append("full" if want_full else "bits_incall" if want_bits else "words")
        return launch(self, *a, want_full=want_full, want_bits=want_bits, **k)

    def spy_bits(self, *a, **k):
        taken.append("bits")
        return bits(self, *a, **k)

    monkeypatch.setattr(TorchPolicyEngine, "match_arrays_launch", spy_launch)
    monkeypatch.setattr(TorchPolicyEngine, "match_bits_arrays_launch", spy_bits)
    cfg = _config(tmp_path)
    args = make_parser().parse_args(["--config", str(cfg), "--device", "cpu", "--insecure",
                                     "--secure-port", "0", "--metrics-port", "0", *flags])
    srv = build_server(args)
    # on the CPU one bucket (engine_warmup_ladder below covers the ladder),
    # for each of the two engines (authorization and admission)
    assert sorted(taken) == sorted(["bits", "bits_incall", "full", "words"] * 2)
    engines = (srv.authorizer._evaluate_batch.__self__,
               srv.admission_handler._evaluate_batch.__self__)
    assert engines[0] is not engines[1]
    for engine in engines:
        assert engine.flagged_rows == 0
        assert engine.stats["warmup_launches"] == {"match_groups_kernel": 0,
                                                   "match_words_kernel": 0}
    srv.start()
    try:
        assert _post(srv.bound_port, SAM_PODS)["allowed"] is True
        assert _post(srv.bound_port, BOB_NODES)["denied"] is True
    finally:
        srv.stop()


@pytest.mark.parametrize("max_batch", [1, 100, 128, 5000])
def test_engine_warmup_ladder(tmp_path, monkeypatch, max_batch):
    """TorchPolicyEngine.warmup(max_batch) takes the words and want_full
    launches at every batch bucket up to max_batch's, the in-launch bitset
    compaction at those up to BITS_INCALL_MAX, and the plain bitset
    product once; it changes no answer, counter or staging figure."""
    from cedar_tpu_torch.engine.evaluator import (
        _BATCH_BUCKETS, BITS_INCALL_MAX, TorchPolicyEngine, _round_bucket)
    from cedar_tpu_torch.lang import PolicySet

    rows = []
    launch, bits = TorchPolicyEngine.match_arrays_launch, TorchPolicyEngine.match_bits_arrays_launch

    def spy_launch(self, codes, *a, want_full=False, want_bits=False, **k):
        rows.append(("full" if want_full else "bits_incall" if want_bits else "words",
                     codes.shape[0]))
        return launch(self, codes, *a, want_full=want_full, want_bits=want_bits, **k)

    def spy_bits(self, codes, *a, **k):
        rows.append(("bits", codes.shape[0]))
        return bits(self, codes, *a, **k)

    engine = TorchPolicyEngine(device="cpu")
    engine.load([PolicySet.from_source(POLICIES, "p")])
    staging = engine.staging_stats()
    monkeypatch.setattr(TorchPolicyEngine, "match_arrays_launch", spy_launch)
    monkeypatch.setattr(TorchPolicyEngine, "match_bits_arrays_launch", spy_bits)
    assert engine.warmup(max_batch) == {"match_groups_kernel": 0, "match_words_kernel": 0}
    ladder = [b for b in _BATCH_BUCKETS if b <= _round_bucket(max_batch, _BATCH_BUCKETS)]
    want = [(kind, b) for b in ladder for kind in ("words", "full", "bits_incall")
            if kind != "bits_incall" or b <= BITS_INCALL_MAX] + [("bits", 1)]
    assert rows == want
    assert engine.flagged_rows == 0 and engine.staging_stats() == staging


def test_device_backend_needs_a_store(tmp_path):
    cfg = _config(tmp_path, stores=[])
    args = make_parser().parse_args(["--config", str(cfg), "--device", "cpu", "--insecure"])
    with pytest.raises(ValueError, match="at least one policy store"):
        build_server(args)


@pytest.mark.parametrize("store", [
    {"type": "crd", "crdStore": {}},
    {"type": "verifiedPermissions", "verifiedPermissionsStore": {"policyStoreId": "ps-1"}},
])
def test_unported_store_types_raise(store, tmp_path):
    """The CRD and Verified Permissions store types are ported now: the
    config no longer raises for them and builds the port's own store, of
    the JAX config's store class name, without starting anything it
    cannot (no kubeconfig yet: the CRD store waits, unready)."""

    class NoPolicies:
        def list_policy_ids(self, store_id):
            return []

        def get_policy_statement(self, store_id, pid):
            return ""

    config = parse_config(json.dumps({"spec": {"stores": [store]}}))
    stores = cedar_config_stores(config, kubeconfig_path=str(tmp_path / "absent"),
                                 avp_client=NoPolicies())
    try:
        (built,) = stores.stores
        assert built.name() == {"crd": "CRDPolicyStore",
                                "verifiedPermissions": "VerifiedPermissionsStore"}[store["type"]]
        assert built.initial_policy_load_complete() is (store["type"] != "crd")
    finally:
        for s in stores:
            s.close()


@pytest.mark.parametrize("mode", ["strict", "partial"])
def test_validation_modes_needing_analysis_raise(tmp_path, mode):
    """The modes that need the load-time analysis no longer raise: the
    config builds tiered stores that carry the mode, as the JAX config
    does, and their gate passes the directory's clean set with the JAX
    gate's report."""
    text = _config(tmp_path, validationMode=mode).read_text()
    stores = cedar_config_stores(parse_config(text))
    j_stores = j_cedar_config_stores(j_parse_config(text))
    try:
        assert stores.validation_mode == j_stores.validation_mode == mode
        got, want = stores.analyzed_policy_sets(), j_stores.analyzed_policy_sets()
        assert [[p.policy_id for p in t.policies()] for t in got] == \
            [[p.policy_id for p in t.policies()] for t in want]
        assert stores.last_analysis.to_dict() == j_stores.last_analysis.to_dict()
    finally:
        for s in list(stores) + list(j_stores):
            s.close()


# policies strict rejects: the demo set plus an alternation product past
# the lowering's clause ceiling (a clause_limit finding, severity error)
CLAUSE_LIMIT = (
    "forbid (principal, action, resource) when { "
    + " && ".join(f'(resource.name == "a{i}" || resource.namespace == "b{i}")'
                  for i in range(12))
    + " };\n"
)


def _gated_config(tmp_path, **spec):
    cfg = _config(tmp_path, **spec)
    (tmp_path / "policies" / "gated.cedar").write_text(CLAUSE_LIMIT)
    return cfg


@pytest.mark.parametrize("config_mode,flag,want", [
    (None, "", "permissive"),
    ("strict", "", "strict"),
    ("strict", "partial", "partial"),
    ("partial", "permissive", "permissive"),
    (None, "strict", "strict"),
])
def test_validation_mode_flag_overrides_the_config(tmp_path, config_mode, flag, want):
    """--validation-mode, when given, overrides the config's
    spec.validationMode (whose default is permissive), for both stacks,
    as the JAX CLI applies it."""
    spec = {} if config_mode is None else {"validationMode": config_mode}
    cfg = _config(tmp_path, **spec)
    argv = ["--config", str(cfg), "--backend", "interpreter", "--insecure",
            "--secure-port", "0", "--metrics-port", "0"]
    if flag:
        argv += ["--validation-mode", flag]
    srv = build_server(make_parser().parse_args(argv))
    try:
        assert srv.authorizer.stores.validation_mode == want
        assert srv.admission_handler.stores.validation_mode == want
    finally:
        srv.stop()


def test_validation_mode_flag_as_jax():
    jp, tp = j_make_parser(), make_parser()
    j_act = jp._option_string_actions["--validation-mode"]
    t_act = tp._option_string_actions["--validation-mode"]
    assert t_act.choices == j_act.choices == ["", "strict", "permissive", "partial"]
    assert t_act.default == j_act.default == ""


@pytest.mark.parametrize("mode", ["strict", "partial", "permissive"])
def test_served_modes_over_a_gated_directory(tmp_path, mode):
    """Each mode on a directory with a clause_limit policy: strict ends
    the CLI with exit code 1 and the rejection (there is no previous
    plane and no interpreter fallback); partial compiles both engines
    without the policy; permissive compiles it as an interpreter-fallback
    policy. /debug/analysis names the finding; the answers are the
    demo's."""
    from cedar_tpu_torch.cli.webhook import main

    cfg = _gated_config(tmp_path)
    argv = ["--config", str(cfg), "--device", "cpu", "--insecure", "--secure-port", "0",
            "--metrics-port", "0", "--validation-mode", mode]
    if mode == "strict":
        assert main(argv) == 1
        return
    srv = build_server(make_parser().parse_args(argv))
    srv.start()
    try:
        for path in ("authorization", "admission"):
            engine = srv.debug_engine()[path]["engine"]
            assert engine["fallback"]["policies"] == (mode == "permissive")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.bound_metrics_port}/debug/analysis", timeout=30) as r:
            doc = json.loads(r.read())
        assert set(doc) == {"authorization", "admission"}
        assert doc["authorization"]["counts"]["clause_limit"] == 1
        assert _post(srv.bound_port, SAM_PODS)["allowed"] is True
        assert _post(srv.bound_port, BOB_NODES)["denied"] is True
    finally:
        srv.stop()


def test_startup_strict_rejection_exits_nonzero(tmp_path):
    """The entry point, with jax and the JAX package blocked: strict
    validation of a corpus with a blocking finding exits 1 and says why."""
    cfg = _gated_config(tmp_path, validationMode="strict")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_MAIN, "--config", str(cfg), "--device", "cpu",
         "--insecure", "--secure-port", "0", "--metrics-port", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    assert "not serving: policy-set analysis rejected the load" in proc.stderr
    assert "[clause_limit]" in proc.stderr


CONFIG_DOCS = {
    "directory": {"spec": {"stores": [{"type": "directory", "directoryStore": {"path": "/p"}}]}},
    "refresh-5m": {"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": "/p", "refreshInterval": "5m"}}]}},
    "refresh-ns": {"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": "/p", "refreshInterval": 45000000000}}]}},
    "two-stores": {"spec": {"validationMode": "partial", "stores": [
        {"type": "directory", "directoryStore": {"path": "/a"}},
        {"type": "verifiedPermissions", "verifiedPermissionsStore": {
            "policyStoreId": "ps", "refreshInterval": "1h", "awsRegion": "eu-west-1"}}]}},
    "empty": {},
    "refresh-too-short": {"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": "/p", "refreshInterval": "10s"}}]}},
    "no-path": {"spec": {"stores": [{"type": "directory", "directoryStore": {}}]}},
    "bad-type": {"spec": {"stores": [{"type": "s3"}]}},
    "bad-mode": {"spec": {"validationMode": "lenient"}},
}


@pytest.mark.parametrize("name", sorted(CONFIG_DOCS))
def test_json_config_parses_as_jax(name):
    text = json.dumps(CONFIG_DOCS[name])
    try:
        want = dataclasses.asdict(j_parse_config(text))
    except JValidationError as e:
        with pytest.raises(ValidationError) as ei:
            parse_config(text)
        assert str(ei.value) == str(e)
        return
    assert dataclasses.asdict(parse_config(text)) == want


def test_yaml_config_parses_as_jax():
    text = (REPO / "mount/cedar-config.yaml").read_text()
    assert dataclasses.asdict(parse_config(text)) == dataclasses.asdict(j_parse_config(text))


@pytest.mark.parametrize("scenario", ["load", "poison-new", "poison-after-good", "fixed"])
def test_directory_store_equals_jax(tmp_path, scenario):
    """Policy ids, sources and quarantine state of the port's directory
    store against the JAX one's, over the same files and edits."""
    d = tmp_path / "p"
    d.mkdir()
    # file names unique to the scenario: both quarantine registries are
    # process-wide
    good, bad = f"a-{scenario}.cedar", f"bad-{scenario}.cedar"
    (d / good).write_text(POLICIES)
    (d / "ignored.txt").write_text("not a policy")
    if scenario == "poison-new":
        (d / bad).write_text("permit (")
    stores = [JDirectoryPolicyStore(str(d), start_ticker=False), DirectoryPolicyStore(str(d))]
    if scenario in ("poison-after-good", "fixed"):
        (d / good).write_text("forbid (")
        for s in stores:
            s.load_policies()
    if scenario == "fixed":
        (d / good).write_text(POLICIES)
        for s in stores:
            s.load_policies()
    j, t = stores
    assert [p.policy_id for p in t.policy_set().policies()] == [
        p.policy_id for p in j.policy_set().policies()]
    assert [p.effect for p in t.policy_set().policies()] == [
        p.effect for p in j.policy_set().policies()]
    assert t.content_generation() == j.content_generation()
    for name in (good, bad):
        assert quarantine_registry().is_quarantined("directory", name) == \
            j_quarantine_registry().is_quarantined("directory", name)
    assert quarantine_registry().is_quarantined("directory", good) == (scenario == "poison-after-good")
    assert t.name() == j.name() and t.initial_policy_load_complete()


# --pdp-listen / --pdp-schema values, as the JAX CLI's tests and docs give them
PDP_ARGV = [["--pdp-listen", "127.0.0.1:9191"], ["--pdp-listen", "9191"],
            ["--pdp-listen", ":9191"], ["--pdp-schema", "/tmp/pdp.json"]]


@pytest.mark.parametrize("argv", PDP_ARGV, ids=lambda a: "=".join(a))
def test_pdp_flag_parses_as_jax(argv):
    jp, tp = j_make_parser(), make_parser()
    dest = tp._option_string_actions[argv[0]].dest
    assert getattr(tp.parse_args(argv), dest) == getattr(jp.parse_args(argv), dest) == argv[1]


def test_pdp_off_by_default(tmp_path):
    args = make_parser().parse_args([])
    assert (args.pdp_listen, args.pdp_schema) == ("", "")
    cfg = _config(tmp_path)
    srv = build_server(make_parser().parse_args(
        ["--config", str(cfg), "--insecure", "--backend", "interpreter"]))
    try:
        assert srv.pdp is None
    finally:
        srv.stop_batchers()
        srv.close_stores()


# a --pdp-schema file that must fail the start, with what the JAX
# PdpConfig.load raises for it
BAD_PDP = {
    "unknown-key": ('{"principal_headr": "x"}', ValueError),
    "zero-cap": ('{"batch_max_tuples": 0}', ValueError),
    "not-json": ("{nope", ValueError),
    "missing-file": (None, OSError),
    "bad-port": ("{}", ValueError),
}


@pytest.mark.parametrize("name", BAD_PDP)
def test_bad_pdp_schema_fails_at_startup(tmp_path, monkeypatch, name):
    """A bad schema file (or port) raises from build_server before any
    store is built: the directory store's constructor is never reached."""
    from cedar_tpu.pdp import PdpConfig as JPdpConfig
    from cedar_tpu_torch.stores import config as t_config

    text, exc = BAD_PDP[name]
    schema = tmp_path / "pdp.json"
    if text is not None:
        schema.write_text(text)
    if name != "bad-port":
        with pytest.raises(exc):
            JPdpConfig.load(str(schema))
    built = []
    real = t_config.cedar_config_stores
    monkeypatch.setattr("cedar_tpu_torch.cli.webhook.cedar_config_stores",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    listen = "127.0.0.1:http" if name == "bad-port" else "127.0.0.1:0"
    args = make_parser().parse_args(
        ["--config", str(_config(tmp_path)), "--insecure", "--backend", "interpreter",
         "--pdp-listen", listen, "--pdp-schema", str(schema)])
    with pytest.raises(exc):
        build_server(args)
    assert built == []


@pytest.mark.parametrize("listen,want", [
    ("127.0.0.2:0", "127.0.0.2"), ("0", "127.0.0.1"), (":0", "127.0.0.1"),
], ids=["addr-port", "port", "empty-addr"])
def test_pdp_listen_binds_addr_port(tmp_path, listen, want):
    """[ADDR:]PORT: ADDR defaults to --bind-address; the listener starts
    with the server, answers an ext_authz check from the device backend
    (on the CPU here) and stops with it."""
    schema = tmp_path / "pdp.json"
    schema.write_text(json.dumps({"principal_header": "x-user"}))
    args = make_parser().parse_args(
        ["--config", str(_config(tmp_path)), "--insecure", "--device", "cpu",
         "--secure-port", "0", "--metrics-port", "0", "--bind-address", "127.0.0.1",
         "--pdp-listen", listen, "--pdp-schema", str(schema)])
    srv = build_server(args)
    assert srv.pdp.address == want and srv.pdp.config.principal_header == "x-user"
    srv.start()
    try:
        import http.client

        conn = http.client.HTTPConnection(want, srv.pdp.bound_port, timeout=30)
        conn.request("GET", "/healthz", headers={"x-user": "sam"})
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        # no policy speaks http:get: the PDP's abstention denies
        assert (r.status, doc) == (403, {"decision": "deny", "reason": ""})
    finally:
        srv.stop()
