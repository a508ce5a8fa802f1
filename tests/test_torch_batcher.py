"""The port's micro-batchers (cedar_tpu_torch/engine/batcher.py) on the CPU.

Mirrors the JAX package's tests/test_pipeline.py for both batchers, serial
and pipelined: results in order under concurrent submits, coalesce keys,
DeadlineExceeded (queued vs running, and withdrawal), drain on stop, stage
failures that fail their batch and nothing more, and the metrics the
batchers record. Then the pipelined stage API of the port's SARFastPath
(engine/fastpath.py) through PipelinedBatcher, against the serial
MicroBatcher over authorize_raw and against the JAX package's fast path,
byte for byte (tolerance 0), and the encode stage's promise to touch no
device.
"""

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.engine.fastpath import SARFastPath as JSARFastPath
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.server import authorizer as j_auth
from cedar_tpu.stores import store as j_store
from cedar_tpu_torch.engine.batcher import DeadlineExceeded, MicroBatcher, PipelinedBatcher
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.fastpath import SARFastPath
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.server.authorizer import CedarWebhookAuthorizer
from cedar_tpu_torch.server.metrics import WebhookMetrics
from cedar_tpu_torch.server.sar import sar_response
from cedar_tpu_torch.stores.store import MemoryStore, TieredPolicyStores

MODES = ["serial", "pipelined"]


class _Stages:
    """Controllable batch work for both batchers: the serial batcher calls
    ``fn`` (encode + dispatch + decode in one call), the pipelined one the
    three stages. Each stage can sleep or raise on a marked item; decode
    doubles each item."""

    def __init__(self, sleep=None, fail=None):
        self.sleep = sleep or {}  # stage -> seconds
        self.fail = fail or {}  # stage -> item that makes it raise
        self.batches = []

    def _step(self, stage, items):
        if self.sleep.get(stage):
            time.sleep(self.sleep[stage])
        if stage in self.fail and self.fail[stage] in items:
            raise ValueError(f"{stage} stage bug")

    def pipeline_encode(self, items):
        self.batches.append(list(items))
        self._step("encode", items)
        return list(items)

    def pipeline_dispatch(self, ctx):
        self._step("dispatch", ctx)
        return ctx

    def pipeline_decode(self, ctx):
        self._step("decode", ctx)
        return [x * 2 for x in ctx]

    def fn(self, items):
        ctx = self.pipeline_dispatch(self.pipeline_encode(items))
        return self.pipeline_decode(ctx)


def _batcher(mode, stages, **kw):
    if mode == "serial":
        return MicroBatcher(stages.fn, **kw)
    return PipelinedBatcher(stages, **kw)


def _submit_all(batcher, items, workers=16, timeout=30.0):
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda x: batcher.submit(x, timeout=timeout), items))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("workers", [1, 8, 32])
def test_results_in_order_under_concurrent_submits(mode, workers):
    stages = _Stages(sleep={"dispatch": 0.002})
    b = _batcher(mode, stages, max_batch=16, window_s=0.0005)
    try:
        assert _submit_all(b, list(range(200)), workers=workers) == [2 * i for i in range(200)]
        # every item went through exactly one batch, no batch above max_batch
        seen = sorted(x for batch in stages.batches for x in batch)
        assert seen == list(range(200))
        assert max(len(batch) for batch in stages.batches) <= 16
        stats = b.debug_stats()
        assert stats["rows_total"] == 200
        assert stats["batches_total"] == len(stages.batches)
        assert stats["largest_batch"] == max(len(batch) for batch in stages.batches)
        if workers > 1:
            assert stats["largest_batch"] > 1  # concurrent submits coalesced
    finally:
        b.stop()


@pytest.mark.parametrize("mode", MODES)
def test_coalesce_key_shares_one_slot(mode):
    """Submits with one coalesce key while its entry is queued share the
    slot: the batch evaluates the item once, every waiter gets it."""
    stages = _Stages()
    # a long forming window keeps the first entry queued while the others
    # arrive
    b = _batcher(mode, stages, max_batch=64, window_s=1.0)
    try:
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(lambda _: b.submit(7, timeout=10, coalesce_key="k"), range(8)))
        assert outs == [14] * 8
        assert stages.batches == [[7]]
    finally:
        b.stop()


@pytest.mark.parametrize("mode", MODES)
def test_coalesced_follower_timeout_keeps_leader(mode):
    stages = _Stages(sleep={"dispatch": 0.15})
    b = _batcher(mode, stages, max_batch=8, window_s=0.0002)
    try:
        blocker = threading.Thread(target=lambda: b.submit(-1, timeout=10))
        blocker.start()
        time.sleep(0.03)
        out = {}
        leader = threading.Thread(target=lambda: out.setdefault("r", b.submit(5, timeout=10, coalesce_key="k")))
        leader.start()
        time.sleep(0.01)
        with pytest.raises(DeadlineExceeded):
            b.submit(5, timeout=0.0, coalesce_key="k")
        leader.join(timeout=10)
        blocker.join(timeout=10)
        assert out["r"] == 10
    finally:
        b.stop()


@pytest.mark.parametrize("mode", MODES)
def test_deadline_queued_behind_a_moving_plane(mode):
    """An item that waits its whole budget in the submit queue while other
    batches finish: DeadlineExceeded with queued True, and the withdrawn
    item never reaches a batch."""
    stages = _Stages(sleep={"dispatch": 0.15})
    # one-row batches, one in the dispatch queue: eight items ahead of the
    # probe keep it in the submit queue for about a second, while a batch
    # finishes every 0.15 s
    b = _batcher(mode, stages, max_batch=1, window_s=0.0, **({} if mode == "serial" else {"depth": 1}))
    try:
        threads = [threading.Thread(target=lambda i=i: b.submit(i, timeout=10)) for i in range(8)]
        for t in threads:
            t.start()
        time.sleep(0.05)
        with pytest.raises(DeadlineExceeded) as ei:
            b.submit(99, timeout=0.3)
        assert ei.value.queued is True
        for t in threads:
            t.join(timeout=10)
        assert not any(99 in batch for batch in stages.batches)
    finally:
        b.stop()


@pytest.mark.parametrize("mode", MODES)
def test_deadline_while_running(mode):
    """An item whose own batch holds it past the budget: DeadlineExceeded
    with queued False (nothing finished since it enqueued), and the
    batcher goes on serving."""
    stages = _Stages(sleep={"decode": 0.3})
    b = _batcher(mode, stages, max_batch=4, window_s=0.0)
    try:
        with pytest.raises(DeadlineExceeded) as ei:
            b.submit(3, timeout=0.1)
        assert ei.value.queued is False
        assert b.submit(4, timeout=10) == 8
    finally:
        b.stop()


@pytest.mark.parametrize("mode", MODES)
def test_stop_drains_every_accepted_item(mode):
    stages = _Stages(sleep={"dispatch": 0.02})
    b = _batcher(mode, stages, max_batch=4, window_s=0.0002)
    results, errors = [], []

    def one(i):
        try:
            results.append((i, b.submit(i, timeout=30)))
        except RuntimeError as e:
            errors.append((i, e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(40)]
    for t in threads:
        t.start()
    time.sleep(0.03)
    b.stop(drain_timeout_s=30)
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "a submitter hung"
    # accepted items got their answer; late ones were refused at submit
    assert all(r == 2 * i for i, r in results)
    assert all("stopped" in str(e) for _, e in errors)
    assert len(results) + len(errors) == 40
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(1, timeout=1)


def test_drain_with_slow_decode_outlives_liveness_poll():
    """The collector exits at the drain sentinel while decode still works;
    a waiter whose liveness poll fires then keeps waiting."""
    stages = _Stages(sleep={"decode": 0.7})
    b = PipelinedBatcher(stages, max_batch=2, window_s=0.0002, depth=2)
    results = {}
    threads = [
        threading.Thread(target=lambda i=i: results.__setitem__(i, b.submit(i, timeout=30)))
        for i in range(4)
    ]
    for t in threads:
        t.start()
    time.sleep(0.05)
    b.stop(drain_timeout_s=30)
    for t in threads:
        t.join(timeout=30)
    assert results == {i: 2 * i for i in range(4)}


@pytest.mark.parametrize(
    "mode,stage", [("serial", "dispatch"), ("pipelined", "encode"),
                   ("pipelined", "dispatch"), ("pipelined", "decode")]
)
def test_stage_failure_fails_its_batch_only(mode, stage):
    """A raising stage fails that batch's submitters with a RuntimeError
    carrying the cause; the workers live on and serve the next batch."""
    stages = _Stages(fail={stage: "boom"})
    b = _batcher(mode, stages, max_batch=4, window_s=0.0002)
    try:
        with pytest.raises(RuntimeError, match="batch evaluation failed") as ei:
            b.submit("boom", timeout=5)
        assert isinstance(ei.value.__cause__, ValueError)
        assert b.submit("ok", timeout=5) == "okok"
        assert b._alive()
    finally:
        b.stop()


def test_pipelined_linger_only_when_idle():
    stages = _Stages()
    b = PipelinedBatcher(stages, max_batch=8, window_s=0.05)
    try:
        assert b._linger_window_s() == 0.05
        b._inflight_add(1)
        assert b._linger_window_s() == 0.0
        b._inflight_add(-1)
        assert b.debug_stats()["inflight_peak"] >= 1
    finally:
        b.stop()


@pytest.mark.parametrize("mode", MODES)
def test_batch_metrics_recorded(mode):
    m = WebhookMetrics()
    stages = _Stages(sleep={"dispatch": 0.01})
    b = _batcher(mode, stages, max_batch=8, window_s=0.001, metrics=m, metrics_path="authorization")
    try:
        _submit_all(b, list(range(40)), workers=8)
    finally:
        b.stop()
    text = m.expose()
    n, total = m.batch_occupancy.totals(path="authorization")
    assert total == 40 and n == len(stages.batches)
    assert 'cedar_batch_occupancy_count{path="authorization"}' in text
    want = ("queue_wait", "evaluate") if mode == "serial" else ("queue_wait", "encode", "dispatch", "decode")
    for stage in want:
        assert f'cedar_pipeline_stage_seconds_count{{path="authorization",stage="{stage}"}}' in text
    stats = b.debug_stats()
    assert stats["mode"] == mode
    assert set(stats["heartbeats"]) == ({"worker"} if mode == "serial" else {"collect", "dispatch", "decode"})


def test_auto_encode_workers():
    b = PipelinedBatcher(_Stages(), encode_workers=0)
    try:
        assert 2 <= b.encode_workers <= 4
    finally:
        b.stop()


# --------------------------------------------------- the SAR fast path

POLICIES = """
permit (principal is k8s::User, action == k8s::Action::"get",
        resource is k8s::Resource)
  when { principal.name == "sam" && resource.resource == "pods" };
permit (principal in k8s::Group::"viewers", action == k8s::Action::"get",
        resource is k8s::Resource)
  when { resource.resource == "pods" };
forbid (principal, action, resource is k8s::Resource)
  when { resource.resource == "nodes" };
forbid (principal, action == k8s::Action::"deletecollection",
        resource is k8s::Resource)
  when { resource has name && ip(resource.name).isLoopback() };
"""


def _sar_body(i: int) -> bytes:
    """Mixed traffic: clean allow / deny / no-opinion rows, multi-match
    rows, system users (encoder gate), gated rows (loopback
    deletecollection) and parse errors."""
    k = i % 9
    if k == 8:
        return b'{"not json' + str(i).encode()
    user, groups, verb, resource, name = f"user-{i % 5}", [], "get", "pods", ""
    if k == 0:
        user = "sam"
    elif k == 1:
        user, groups = "sam", ["viewers"]
    elif k == 2:
        resource = "nodes"
    elif k == 3:
        user = "system:kube-scheduler"
    elif k == 4:
        verb, name = "deletecollection", "127.0.0.1"
    elif k == 5:
        verb, name = "deletecollection", "box"
    ra = {"verb": verb, "version": "v1", "resource": resource, "namespace": f"ns-{i % 3}"}
    if name:
        ra["name"] = name
    return json.dumps({
        "apiVersion": "authorization.k8s.io/v1", "kind": "SubjectAccessReview",
        "spec": {"user": user, "uid": "u", "groups": groups, "resourceAttributes": ra},
    }).encode()


BODIES = [_sar_body(i) for i in range(240)]


def _port_stack(ready=True):
    ps = PolicySet.from_source(POLICIES, "pipe")
    engine = TorchPolicyEngine(device="cpu")
    engine.load([ps])
    stores = TieredPolicyStores([MemoryStore("pipe", ps, load_complete=ready)])
    authz = CedarWebhookAuthorizer(stores, evaluate_batch=engine.evaluate_batch)
    return engine, authz, SARFastPath(engine, authz)


def _render(results):
    return [json.dumps(sar_response(*r), sort_keys=True) for r in results]


@pytest.fixture(scope="module")
def serial_answers():
    _, _, fast = _port_stack()
    return _render(fast.authorize_raw(BODIES))


@pytest.mark.parametrize("max_batch", [1, 16, 128])
def test_pipelined_fastpath_equals_serial(serial_answers, max_batch):
    engine, _, fast = _port_stack()
    b = PipelinedBatcher(fast, max_batch=max_batch, window_s=0.0005, depth=2, encode_workers=2)
    try:
        piped = _render(_submit_all(b, BODIES, workers=24))
    finally:
        b.stop()
    assert piped == serial_answers
    assert fast.routing["gated"] > 0 and fast.routing["encoder_gate"] > 0
    assert engine.staging_stats()["outstanding"] == 0


def test_serial_batcher_fastpath_equals_authorize_raw(serial_answers):
    _, _, fast = _port_stack()
    b = MicroBatcher(fast.authorize_raw, max_batch=32, window_s=0.0005)
    try:
        assert _render(_submit_all(b, BODIES, workers=24)) == serial_answers
    finally:
        b.stop()


def test_pipelined_fastpath_equals_jax_fastpath():
    """The JAX package's serial fast path over the same policies and
    bodies gives the same response bytes."""
    jps = JPolicySet.from_source(POLICIES, "pipe")
    jengine = TPUPolicyEngine()
    jengine.load([jps], warm="off")
    jauthz = j_auth.CedarWebhookAuthorizer(
        j_store.TieredPolicyStores([j_store.MemoryStore("pipe", jps)]), evaluate=jengine.evaluate
    )
    want = _render(JSARFastPath(jengine, jauthz).authorize_raw(BODIES))
    _, _, fast = _port_stack()
    b = PipelinedBatcher(fast, max_batch=64, window_s=0.0005, depth=2, encode_workers=2)
    try:
        assert _render(_submit_all(b, BODIES, workers=24)) == want
    finally:
        b.stop()


def test_encode_stage_touches_no_device():
    """Every launch and readback of the pipeline happens on the dispatch
    and decode threads; the encode workers only encode on the host."""
    engine, _, fast = _port_stack()
    seen = []
    for name in ("match_arrays_launch", "match_bits_arrays_launch", "evaluate_batch"):
        real = getattr(engine, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append((_name, threading.current_thread().name))
            return _real(*a, **k)

        setattr(engine, name, spy)
    b = PipelinedBatcher(fast, max_batch=32, window_s=0.0005, depth=2, encode_workers=2)
    try:
        _submit_all(b, BODIES, workers=16)
    finally:
        b.stop()
    threads = {t for _, t in seen}
    assert {n for n, _ in seen} >= {"match_arrays_launch", "evaluate_batch"}
    assert not any(t.startswith("pipe-encode") for t in threads), threads
    assert "pipe-dispatch" in threads


def test_encode_failure_returns_the_staging_buffers():
    engine, _, fast = _port_stack()
    fast._CHUNK = fast._TAIL_CHUNK = 8  # several chunks per batch
    calls = {"n": 0}
    real = fast._encode_into

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("encoder fault")
        return real(*a, **k)

    fast._encode_into = flaky
    with pytest.raises(RuntimeError, match="encoder fault"):
        fast.pipeline_encode(BODIES[:40])
    assert engine.staging_stats()["outstanding"] == 0


def test_unready_stores_answer_without_evaluating():
    """Before every store's initial load completes, the encode stage
    answers each row NoOpinion (the gates still apply) and nothing is
    launched."""
    engine, _, fast = _port_stack(ready=False)
    launches = []
    engine.match_arrays_launch = lambda *a, **k: launches.append(1)
    ctx = fast.pipeline_encode(BODIES[:9])
    assert ctx[0] == "direct"
    out = fast.pipeline_decode(fast.pipeline_dispatch(ctx))
    assert not launches
    assert [r[0] for r in out] == ["no_opinion"] * 9


def test_stress_shared_counters_survive_contention():
    """More submitters than cores and a tiny switch interval: the batch
    counts, the in-flight count, the kernels' launch counter (bumped
    from the dispatch and decode threads in serving) and the fast path's
    routing, packed-transfer and stage-time counters lose no update."""
    import sys

    from cedar_tpu_torch.ops import cuda_match

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stages = _Stages()
        b = PipelinedBatcher(stages, max_batch=8, window_s=0.0001, depth=2, encode_workers=3)
        try:
            n = 1500
            assert _submit_all(b, list(range(n)), workers=64) == [2 * i for i in range(n)]
            stats = b.debug_stats()
            assert stats["rows_total"] == n
            assert stats["inflight"] == 0
        finally:
            b.stop()
        before = cuda_match.launch_counts()["match_words_kernel"]

        def bump():
            for _ in range(2000):
                cuda_match._count_launch("match_words_kernel")

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert cuda_match.launch_counts()["match_words_kernel"] - before == 16 * 2000

        _, _, fast = _port_stack()
        pack = type("Pack", (), {"parts": 3})()

        def record():
            for _ in range(2000):
                fast._record_routing(7, 1, 5, 2, 1)
                fast._note_packed(pack)
                fast._add_stage_s("decode", 1.0)

        threads = [threading.Thread(target=record) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        n = 16 * 2000
        assert fast.routing == {
            "clean_native": 2 * n, "gated": 2 * n, "flagged": n,
            "encoder_fallback": n, "encoder_gate": n,
        }
        assert (fast.packed_transfers, fast.packed_chunks) == (n, 3 * n)
        assert fast.last_stage_s["decode"] == float(n)
    finally:
        sys.setswitchinterval(old)
