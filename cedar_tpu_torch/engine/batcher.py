"""Micro-batching bridge between request threads and the batch evaluator.

The webhook serves one HTTP request per thread, but the device wants
batches. ``MicroBatcher`` collects the items concurrent request threads
submit inside a short window and hands them to the batch function in one
call; each submitter blocks until its own result is ready.

Latency shape: a lone request waits at most ``window_s`` (default 200 µs)
before its batch fires, while a saturated server forms large batches (up
to ``max_batch``).

``PipelinedBatcher`` splits the serial worker loop into three stages:
batch N+1's host encode runs on a small worker pool while batch N's device
work is in flight, the dispatch thread launches each encoded batch
asynchronously and moves on, and the decode thread waits for the results
and completes each submitter's slot. Queues of ``depth`` batches between
the stages give backpressure: a slow device stalls the collector instead
of growing an unbounded backlog. Submission semantics (deadline
withdrawal, coalescing, drain on stop) are the serial batcher's: both
share one queue-and-slot front end.

A batch whose evaluation (or any stage) raises fails: each of its
submitters gets a RuntimeError. Nothing here re-runs it on another path.

Supervision (server/supervisor.py): every worker loop beats a
``Heartbeat``, and ``revive(force=)`` restarts dead (or, forced, wedged)
workers as a new generation: the superseded one exits at its next loop
iteration. The pipelined batcher's revive also fails the batches sitting
in the old generation's hand-off queues and the batch a dead stage held
when it died, so their submitters answer the failure posture at once, and
hands their staging back to the pool once no copy can read it
(``stages.pipeline_discard``). The chaos seams ``pipeline.collect``,
``pipeline.dispatch_q`` and ``pipeline.decode_q`` (chaos/registry.py)
fire after a worker takes its batch and before the per-batch
containment, so a ``kill`` rule unwinds the worker as a crash would.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, TypeVar

from ..chaos.registry import chaos_fire
from ..obs.trace import current_trace
from ..server.supervisor import Heartbeat

log = logging.getLogger(__name__)

T = TypeVar("T")
R = TypeVar("R")

# end-of-stream marker through the pipeline's hand-off queues on drain:
# the collector sends it after its last batch, and each stage forwards it
# after finishing all prior work, so every accepted item's slot is set
# before any worker thread exits
_SENTINEL = object()


class DeadlineExceeded(Exception):
    """A submitter's per-request budget elapsed before its batch result
    arrived. The batch may still evaluate the item; the caller has
    already answered, so the late result is discarded.

    ``queued`` is True when the budget demonstrably burned in the submit
    queue of a moving plane: some batch finished after this slot enqueued,
    and the slot was still unclaimed at expiry or was claimed only after
    more than half the budget was gone. False when its batch held it on
    the device (or nothing has finished since it enqueued)."""

    queued = False


class _StageTimes:
    """Per-batch monotonic stage stamps, shared by every slot the batch
    claimed: the source of the cedar_pipeline_stage_seconds histograms."""

    __slots__ = (
        "claimed", "first_enq",
        "encode0", "encode1", "dispatch0", "dispatch1",
        "decode0", "decode1", "eval0", "eval1",
    )

    def __init__(self, claimed: float):
        self.claimed = claimed
        self.first_enq: Optional[float] = None
        self.encode0 = self.encode1 = None
        self.dispatch0 = self.dispatch1 = None
        self.decode0 = self.decode1 = None
        self.eval0 = self.eval1 = None


class _Slot:
    __slots__ = ("event", "result", "error", "waiters", "key", "t_enq", "times")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        # coalescing: how many submitters share this slot, and the
        # coalesce key it is registered under while still queued
        self.waiters = 1
        self.key = None
        # when this slot was enqueued, and the claiming batch's stage
        # stamps (None until claimed)
        self.t_enq = time.monotonic()
        self.times: Optional[_StageTimes] = None


class MicroBatcher:
    # how often a blocked submitter re-checks the worker threads'
    # liveness: a worker that dies outside its per-batch try must not
    # strand its waiters
    LIVENESS_POLL_S = 0.5

    def __init__(
        self,
        fn: Optional[Callable[[Sequence[T]], List[R]]],
        max_batch: int = 8192,
        window_s: float = 0.0002,
        metrics=None,
        metrics_path: str = "",
    ):
        self._fn = fn
        self.max_batch = max_batch
        self.window_s = window_s
        # server/metrics.py WebhookMetrics (None records nothing) and the
        # `path` label of the batch families
        self.metrics = metrics
        self.metrics_path = metrics_path
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[tuple] = []
        # coalesce_key -> queued entry; entries leave this map when a
        # worker claims them (or their last waiter withdraws), so later
        # submitters enqueue fresh work
        self._pending: dict = {}
        self._stopped = False
        self._threads: List[threading.Thread] = []
        # when the last batch finished (monotonic; completion or failure):
        # DeadlineExceeded.queued tells overload (batches finishing, this
        # slot never got its turn) from a plane that finishes nothing
        self._last_batch_done = 0.0
        # batches formed, the rows they carried, and the largest one
        self._batches_total = 0
        self._rows_total = 0
        self._largest_batch = 0
        # batches claimed per protocol-mix signature ("sar" for an
        # unstamped body; a PDP body carries .protocol, pdp/): a
        # signature naming several protocols shows SAR, ext_authz and
        # batch-authorize rows that shared one claim, and so one launch
        self._protocol_mix: dict = {}
        # per-stage liveness beacons (server/supervisor.py)
        self.heartbeats: dict = {}
        # worker generation: revive() bumps it, and every worker loop
        # checks the epoch it started with, so a superseded (dead, or
        # wedged and abandoned) generation never races the fresh one for
        # queued work
        self._epoch = 0
        self.revives = 0
        # (stage, epoch) -> (batch, ctx) a worker holds outside the queues
        # (claimed, or taken off a hand-off queue, and not yet passed on
        # or answered): revive() answers the replaced generation's
        self._in_hand: dict = {}
        self._start_workers()

    def _start_workers(self) -> None:
        self.heartbeats.setdefault("worker", Heartbeat())
        self._thread = threading.Thread(target=self._run, name="micro-batcher", daemon=True)
        self._threads = [self._thread]
        self._thread.start()

    def revive(self, force: bool = False) -> bool:
        """Restart dead worker threads (the supervisor's hook). ``force``
        also abandons live-but-wedged workers: the epoch bump makes the old
        generation exit at its next loop iteration, and fresh workers take
        over the submit queue. Queued items survive (the new workers
        evaluate them); a batch a dead worker held is answered with a
        restart error. Returns False when nothing needed doing (or the
        batcher is stopped)."""
        with self._cv:
            if self._stopped:
                return False
            dead = [t for t in self._threads if not t.is_alive()]
            if not dead and not force:
                return False
            self._epoch += 1
            self.revives += 1
            self._cv.notify_all()
            stranded = self._take_in_hand(self._threads)
            self._start_workers()
        self._shed_stranded(stranded, force)
        log.warning(
            "micro-batcher revived (%d dead worker(s)%s)",
            len(dead),
            ", forced" if force else "",
        )
        return True

    def _hold(self, stage: str, epoch: int, batch: list, ctx=None) -> None:
        """Record the batch a worker holds outside the queues."""
        self._in_hand[(stage, epoch)] = (batch, ctx)

    def _drop(self, stage: str, epoch: int) -> None:
        self._in_hand.pop((stage, epoch), None)

    def _take_in_hand(self, old_threads) -> list:
        """Take the batches held by superseded generations (the caller
        has bumped the epoch), as (stage, batch, ctx, dead): dead when the
        stage's thread among ``old_threads`` (the generation just
        replaced) has exited."""
        alive = {t.name: t.is_alive() for t in old_threads}
        out = []
        for (stage, epoch), (batch, ctx) in list(self._in_hand.items()):
            if epoch == self._epoch:
                continue
            del self._in_hand[(stage, epoch)]
            name = "micro-batcher" if stage == "worker" else f"pipe-{stage}"
            out.append((stage, batch, ctx, epoch == self._epoch - 1 and not alive.get(name, True)))
        return out

    def _shed_stranded(self, stranded: list, force: bool) -> None:
        """Answer the batches held by the replaced generation with a
        restart error: a dead worker's (and its staging is handed back),
        and, on a forced revive, a wedged one's (its staging stays with
        the call that may still use it). A live worker of a revive that
        was not forced finishes or fails its batch itself."""
        for stage, batch, ctx, dead in stranded:
            if not (dead or force):
                continue
            self._fail_batch(batch, RuntimeError(f"pipeline {stage} stage restarted; batch shed"))
            if dead and ctx is not None:
                self._discard_ctx(ctx)

    def _discard_ctx(self, ctx) -> None:
        """The serial batcher holds no staging: nothing to hand back."""

    def _alive(self) -> bool:
        """True while every worker thread runs: a dead stage means
        accepted items may never complete, so submitters must bail."""
        return all(t.is_alive() for t in self._threads)

    def _heartbeat_stats(self) -> dict:
        out = {}
        for name, hb in self.heartbeats.items():
            age, busy = hb.snapshot()
            out[name] = {"age_s": round(age, 6), "busy": busy}
        return out

    def _batch_stats(self) -> dict:
        with self._cv:
            return {
                "queue": len(self._queue),
                "batches_total": self._batches_total,
                "rows_total": self._rows_total,
                "largest_batch": self._largest_batch,
                "protocol_mix": dict(self._protocol_mix),
            }

    def queue_fill(self) -> int:
        """Queued (unclaimed) items."""
        with self._cv:
            return len(self._queue)

    def debug_stats(self) -> dict:
        """Live queue, batch and configuration snapshot for /debug/engine."""
        return {
            "mode": "serial",
            **self._batch_stats(),
            "max_batch": self.max_batch,
            "window_us": round(self.window_s * 1e6, 1),
            "revives": self.revives,
            "heartbeats": self._heartbeat_stats(),
        }

    def submit(
        self,
        item: T,
        timeout: Optional[float] = None,
        coalesce_key: Optional[str] = None,
    ) -> R:
        """Enqueue one item and block until its result is available.

        ``timeout`` bounds the wait (queue + batch window + evaluation): on
        expiry the item is withdrawn from the queue when still pending and
        ``DeadlineExceeded`` is raised. A dead worker thread raises
        ``RuntimeError`` instead of stranding the submitter.

        ``coalesce_key``: while an entry for the same key is still queued
        (not yet claimed), a new submit attaches to its slot as one more
        waiter instead of enqueuing a duplicate; the batch evaluates the
        item once and every waiter gets the result. A timed-out waiter
        detaches only itself; the queued slot is withdrawn only when its
        last waiter leaves."""
        with self._cv:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            if not self._alive():
                raise RuntimeError("batcher dead: worker thread has exited")
            entry = self._pending.get(coalesce_key) if coalesce_key is not None else None
            if entry is not None:
                entry[1].waiters += 1
            else:
                slot = _Slot()
                entry = (item, slot)
                if coalesce_key is not None:
                    slot.key = coalesce_key
                    self._pending[coalesce_key] = entry
                self._queue.append(entry)
                self._cv.notify()
        return self._wait(entry, timeout)

    def _wait(self, entry: tuple, timeout: Optional[float]) -> R:
        slot = entry[1]
        deadline = None if timeout is None else time.monotonic() + timeout
        while not slot.event.is_set():
            wait = self.LIVENESS_POLL_S
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    with self._cv:
                        self._withdraw(entry)
                    if slot.event.is_set():
                        break  # the result landed while withdrawing
                    err = DeadlineExceeded(
                        f"deadline of {timeout:.3f}s exceeded waiting for batch result"
                    )
                    err.queued = self._last_batch_done > slot.t_enq and (
                        slot.times is None
                        or slot.times.claimed - slot.t_enq > 0.5 * timeout
                    )
                    raise err
                wait = min(wait, remaining)
            if slot.event.wait(wait):
                break
            if not self._alive():
                if slot.event.is_set():
                    break  # delivered as the worker exited
                raise RuntimeError("batcher dead: worker thread exited without delivering results")
        self.annotate_trace(slot)
        if slot.error is not None:
            if slot.key is not None:
                # a coalesced slot's waiters must not re-raise one shared
                # exception object from several threads (its traceback
                # would be mutated concurrently): one fresh error each
                err = RuntimeError(str(slot.error))
                err.__cause__ = slot.error
            else:
                # the slot's only waiter takes its error off it
                err, slot.error = slot.error, None
            # no reference cycle through the raised error: neither the
            # slot (held by the calling frames its traceback holds) nor
            # this frame keeps it. A cycle would keep the failed batch's
            # compiled set (its card memory) alive until a cyclic
            # collection
            try:
                raise err
            finally:
                del err
        return slot.result

    @staticmethod
    def annotate_trace(slot: _Slot) -> None:
        """Attach the slot's batch-stage windows to the calling thread's
        active request trace (obs/trace.py), as the JAX package's batcher
        does: the queue wait from the slot's own enqueue stamp, then the
        claiming batch's encode / dispatch / decode (pipelined) or evaluate
        (serial) windows, the stamps cedar_pipeline_stage_seconds
        observes. Runs in the request thread once the result landed; with
        no active trace the cost is one thread-local read."""
        tr = current_trace()
        if tr is None:
            return
        times = slot.times
        if times is None:
            return  # never claimed (withdrawn, or failed before a batch)
        tr.add_span("batch.queue_wait", slot.t_enq, times.claimed)
        for name, a, b in (
            ("batch.encode", times.encode0, times.encode1),
            ("batch.dispatch", times.dispatch0, times.dispatch1),
            ("batch.decode", times.decode0, times.decode1),
            ("batch.evaluate", times.eval0, times.eval1),
        ):
            if a is not None and b is not None:
                tr.add_span(name, a, b)

    def stop(self, drain_timeout_s: float = 2.0) -> None:
        """Stop accepting new work and drain: the workers process every
        queued item before exiting."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        deadline = time.monotonic() + drain_timeout_s
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.05))

    # ------------------------------------------------------------- internals

    def _withdraw(self, entry: tuple) -> None:
        """One waiter's deadline expired (caller holds the lock). Only the
        last departing waiter removes the still-queued entry, found by
        identity (identical request bodies are the norm under
        coalescing, so equality could remove another submitter's entry)."""
        slot = entry[1]
        slot.waiters -= 1
        if slot.waiters > 0:
            return
        for i, e in enumerate(self._queue):
            if e is entry:
                del self._queue[i]
                break
        if slot.key is not None and self._pending.get(slot.key) is entry:
            del self._pending[slot.key]

    def _form_batch(self, epoch: Optional[int] = None) -> Optional[list]:
        """Wait for work and claim one batch under the lock. Returns None
        when stopped with an empty queue (the worker exits) or when
        ``epoch`` is no longer current (revive() superseded this worker),
        else a possibly empty batch (every queued item withdrew during
        the window: never evaluate zero rows)."""
        with self._cv:
            while not self._queue and not self._stopped:
                if epoch is not None and self._epoch != epoch:
                    return None
                self._cv.wait()
            if epoch is not None and self._epoch != epoch:
                return None
            if self._stopped and not self._queue:
                return None
            # the knobs are read once per claim: a tuner (load/tuner.py)
            # writing max_batch or window_s from its own thread takes
            # effect at the next claim and never changes this one
            max_batch = int(self.max_batch)
            # the forming window lets concurrent submitters pile in
            window = self._linger_window_s()
            if window > 0:
                deadline = time.monotonic() + window
                while len(self._queue) < max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            batch = self._queue[:max_batch]
            del self._queue[:max_batch]
            # claimed entries leave the coalesce map: later submitters
            # must not attach to a result computed against an older set.
            # The batch's stage record takes the oldest member's enqueue
            # time as its queue-wait start
            times = _StageTimes(time.monotonic()) if batch else None
            if batch:
                self._batches_total += 1
                self._rows_total += len(batch)
                self._largest_batch = max(self._largest_batch, len(batch))
                sig = ",".join(sorted({getattr(item, "protocol", "") or "sar"
                                       for item, _ in batch}))
                self._protocol_mix[sig] = self._protocol_mix.get(sig, 0) + 1
                self._claimed(len(batch), epoch)
            for _, slot in batch:
                slot.times = times
                if times.first_enq is None or slot.t_enq < times.first_enq:
                    times.first_enq = slot.t_enq
                if slot.key is not None:
                    pending = self._pending.get(slot.key)
                    if pending is not None and pending[1] is slot:
                        del self._pending[slot.key]
        if batch and self.metrics is not None:
            self.metrics.record_batch_occupancy(self.metrics_path, len(batch))
        return batch

    def _linger_window_s(self) -> float:
        """The forming window of this claim; the pipelined batcher
        overrides it."""
        return self.window_s

    def _claimed(self, n: int, epoch: Optional[int]) -> None:
        """A batch of ``n`` entries left the submit queue (the caller
        holds the lock); the pipelined batcher counts it in flight."""

    def _record_batch_stages(self, times: _StageTimes) -> None:
        """One claimed batch's stage windows -> the stage histograms."""
        if self.metrics is None:
            return
        p = self.metrics_path
        if times.first_enq is not None:
            self.metrics.record_pipeline_stage(p, "queue_wait", times.claimed - times.first_enq)
        for stage, a, b in (
            ("encode", times.encode0, times.encode1),
            ("dispatch", times.dispatch0, times.dispatch1),
            ("decode", times.decode0, times.decode1),
            ("evaluate", times.eval0, times.eval1),
        ):
            if a is not None and b is not None:
                self.metrics.record_pipeline_stage(p, stage, b - a)

    def _complete_batch(self, batch: list, results: Sequence[R]) -> None:
        if len(results) != len(batch):
            raise RuntimeError(f"batch fn returned {len(results)} results for {len(batch)} items")
        self._last_batch_done = time.monotonic()
        for (_, slot), res in zip(batch, results):
            slot.result = res
            slot.event.set()

    def _fail_batch(self, batch: list, e: BaseException) -> None:
        # one fresh exception per slot: sharing one object (and its
        # traceback) across request threads would interleave them
        self._last_batch_done = time.monotonic()
        for _, slot in batch:
            err = RuntimeError(f"batch evaluation failed: {e!r}")
            err.__cause__ = e
            slot.error = err
            slot.event.set()

    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException:
            log.critical("micro-batcher worker died on an uncaught exception")
            raise

    def _run_loop(self) -> None:
        epoch = self._epoch
        hb = self.heartbeats["worker"]
        while True:
            # while idle, hold nothing of the last batch (its results and
            # errors reach its compiled set, which a swap may have retired)
            batch = results = None
            hb.idle()
            batch = self._form_batch(epoch)
            if batch is None:
                return
            if not batch:
                continue
            self._hold("worker", epoch, batch)
            # chaos seam outside the per-batch containment below: a kill
            # rule unwinds this worker as a crash would
            chaos_fire("pipeline.collect")
            hb.busy()
            self._drop("worker", epoch)
            times = batch[0][1].times
            times.eval0 = time.monotonic()
            # the end stamp lands before any waiter wakes
            try:
                results = self._fn([it for it, _ in batch])
                times.eval1 = time.monotonic()
                self._record_batch_stages(times)
                self._complete_batch(batch, results)
            except BaseException as e:  # noqa: BLE001 — fails this batch's slots
                if times.eval1 is None:
                    times.eval1 = time.monotonic()
                    self._record_batch_stages(times)
                self._fail_batch(batch, e)


class PipelinedBatcher(MicroBatcher):
    """Three-stage pipelined MicroBatcher (module docstring).

    ``stages`` provides the split surface of the raw fast path
    (engine/fastpath.py):

      * ``pipeline_encode(items) -> ctx``: host-only encode, on a pool of
        ``encode_workers`` threads, one batch per worker;
      * ``pipeline_dispatch(ctx) -> ctx``: launch the device work without
        waiting for it, on the one dispatch thread;
      * ``pipeline_decode(ctx) -> results``: wait for the device, decode,
        resolve deferred rows, on the decode thread, which completes each
        submitter's slot.

    The hand-off queues hold at most ``depth`` batches: when the device
    falls behind, the collector blocks on the dispatch queue (the blocked
    time is cedar_pipeline_stall_seconds_total{stage="collect"}).

    A stage that raises fails that batch's slots; the threads live on.
    stop() drains the submit queue through all three stages before the
    workers exit."""

    def __init__(
        self,
        stages,
        max_batch: int = 8192,
        window_s: float = 0.0002,
        depth: int = 2,
        encode_workers: int = 2,
        metrics=None,
        metrics_path: str = "",
    ):
        from concurrent.futures import ThreadPoolExecutor

        self.stages = stages
        self.depth = max(1, int(depth))
        if encode_workers <= 0:
            # auto-size: each worker's chunk encode fans out over the
            # native encoder's own thread pool, so a few Python-level
            # workers keep the dispatch stage fed without oversubscribing
            from ..native import _default_encode_threads

            encode_workers = max(2, min(4, _default_encode_threads() // 4))
        self.encode_workers = max(1, int(encode_workers))
        self._pool = ThreadPoolExecutor(self.encode_workers, thread_name_prefix="pipe-encode")
        # batches claimed off the submit queue and not yet decoded, and
        # the entries they carry (three threads update both, always under
        # _inflight_lock, and only for the current worker generation),
        # with the batch count's high-water mark: above 1 shows batch N+1
        # staged or launched while batch N was still in the pipeline
        self._inflight = 0
        self._inflight_entries = 0
        self._inflight_peak = 0
        self._inflight_lock = threading.Lock()
        self._stall_s = {"collect": 0.0, "dispatch": 0.0, "decode": 0.0}
        super().__init__(
            fn=None, max_batch=max_batch, window_s=window_s,
            metrics=metrics, metrics_path=metrics_path,
        )

    def _alive(self) -> bool:
        """During a drain the collector and then the dispatcher exit once
        they forward the sentinel; their work is already downstream, so a
        waiter must not read those exits as a dead batcher while the
        decoder still delivers. Before stop(), all three stages must
        live."""
        if self._stopped:
            return self._decoder.is_alive()
        return all(t.is_alive() for t in self._threads)

    def _start_workers(self) -> None:
        # fresh hand-off queues per worker generation: after a revive() a
        # superseded (possibly wedged) stage thread still holds ITS
        # generation's queues, so it can never consume, or block on, the
        # new stages' work; each stage gets its epoch, queues and
        # downstream consumer as arguments for the same reason
        for stage in ("collect", "dispatch", "decode"):
            self.heartbeats.setdefault(stage, Heartbeat())
        self._dispatch_q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._decode_q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        epoch = self._epoch
        self._decoder = threading.Thread(
            target=self._run_decode, name="pipe-decode", daemon=True,
            args=(epoch, self._decode_q),
        )
        self._dispatcher = threading.Thread(
            target=self._run_dispatch, name="pipe-dispatch", daemon=True,
            args=(epoch, self._dispatch_q, self._decode_q, self._decoder),
        )
        self._thread = threading.Thread(
            target=self._run_collect, name="pipe-collect", daemon=True,
            args=(epoch, self._dispatch_q, self._dispatcher),
        )
        self._threads = [self._thread, self._dispatcher, self._decoder]
        for t in self._threads:
            t.start()

    def revive(self, force: bool = False) -> bool:
        """Restart the pipeline after a stage death (or, forced, a wedge):
        supersede the old worker generation, fail every batch in the old
        hand-off queues and every batch an old stage held (their slots
        fail at once with a restart error, so the callers answer the
        failure posture instead of waiting out their deadlines), hand
        their staging back (stages.pipeline_discard: once no copy can read
        it), and start fresh stages with fresh queues. The submit queue
        survives: the new collector takes it over. Returns False when
        nothing needed doing (or the batcher is stopped)."""
        with self._cv:
            if self._stopped:
                return False
            dead = [t for t in self._threads if not t.is_alive()]
            if not dead and not force:
                return False
            self._epoch += 1
            self.revives += 1
            old_threads = list(self._threads)
            old_qs = [self._dispatch_q, self._decode_q]
            self._cv.notify_all()
        # wake and retire the surviving old stages: a sentinel unblocks a
        # blocked get, and the epoch check exits the loop
        shed = self._shed_queues(old_qs)
        for q in old_qs:
            try:
                q.put_nowait(_SENTINEL)
            except _queue.Full:
                pass
        for t in old_threads:
            if t.is_alive():
                t.join(timeout=0.5)
        # second pass: anything a still-live old stage pushed between the
        # first drain and its exit
        shed += self._shed_queues(old_qs)
        with self._cv:
            stranded = self._take_in_hand(old_threads)
        self._shed_stranded(stranded, force)
        with self._inflight_lock:
            self._inflight = self._inflight_entries = 0
        with self._cv:
            if self._stopped:
                return False
            self._start_workers()
        log.warning(
            "pipeline revived: %d dead stage(s)%s, %d queued and %d held batch(es) shed",
            len(dead),
            ", forced" if force else "",
            shed,
            len(stranded),
        )
        return True

    def _discard_ctx(self, ctx) -> None:
        """Hand a failed batch's staging back through the fast path: an
        encode future (dispatch queue) once it resolves, an encoded or
        launched context (decode queue, a held batch) now."""
        discard = getattr(self.stages, "pipeline_discard", None)
        if discard is None:
            return
        if isinstance(ctx, Future):
            def _done(fut):
                if not fut.cancelled() and fut.exception() is None:
                    discard(fut.result())
            ctx.add_done_callback(_done)
            return
        discard(ctx)

    def _shed_item(self, item) -> None:
        """Fail one hand-off queue item and hand back its staging."""
        batch, ctx = item
        self._fail_batch(batch, RuntimeError("pipeline stage restarted; batch shed"))
        self._discard_ctx(ctx)

    def _shed_queues(self, qs) -> int:
        """Fail every batch queued in ``qs`` (revive)."""
        shed = 0
        for q in qs:
            while True:
                try:
                    item = q.get_nowait()
                except _queue.Empty:
                    break
                if item is _SENTINEL:
                    continue
                self._shed_item(item)
                shed += 1
        return shed

    def debug_stats(self) -> dict:
        with self._inflight_lock:
            inflight, peak = self._inflight, self._inflight_peak
        return {
            "mode": "pipelined",
            **self._batch_stats(),
            "max_batch": self.max_batch,
            "window_us": round(self.window_s * 1e6, 1),
            "depth": self.depth,
            "encode_workers": self.encode_workers,
            "dispatch_queue": self._dispatch_q.qsize(),
            "decode_queue": self._decode_q.qsize(),
            "inflight": inflight,
            "inflight_peak": peak,
            "stall_seconds": {k: round(v, 6) for k, v in self._stall_s.items()},
            "revives": self.revives,
            "heartbeats": self._heartbeat_stats(),
        }

    # ------------------------------------------------------------- plumbing

    def _linger_window_s(self) -> float:
        """While batches are in flight the collector claims at once: the
        requests that arrived during batch N's device work are the next
        batch, and a host linger would only add latency. An idle pipeline
        keeps the forming window so a burst's first batch coalesces."""
        if self._inflight > 0:
            return 0.0
        return self.window_s

    def _inflight_add(self, n: int, entries: int = 0, epoch: Optional[int] = None) -> None:
        # a superseded generation's late update must not move the live
        # generation's counts (revive() resets them once it is retired);
        # no epoch: the live one's
        with self._inflight_lock:
            if epoch is not None and epoch != self._epoch:
                return
            self._inflight = max(0, self._inflight + n)
            self._inflight_entries = max(0, self._inflight_entries + entries)
            self._inflight_peak = max(self._inflight_peak, self._inflight)

    def _claimed(self, n: int, epoch: Optional[int]) -> None:
        # counted under the submit queue's lock, in the step that takes
        # the entries off it: backlog() never misses one in between
        self._inflight_add(1, n, epoch)

    def backlog(self) -> int:
        """Submitted and unanswered entries across the whole batcher:
        queued plus claimed into the pipeline stages. The adaptive batch
        tuner's demand signal (load/tuner.py): under saturation most of
        the waiting is in the stage hand-off queues, which queue_fill()
        does not see."""
        with self._cv:
            with self._inflight_lock:
                return len(self._queue) + self._inflight_entries

    def _encode_timed(self, items, times: _StageTimes):
        times.encode0 = time.monotonic()
        try:
            return self.stages.pipeline_encode(items)
        finally:
            times.encode1 = time.monotonic()

    def _stall(self, stage: str, seconds: float) -> None:
        if seconds <= 0:
            return
        self._stall_s[stage] += seconds
        if self.metrics is not None:
            self.metrics.record_pipeline_stall(self.metrics_path, stage, seconds)

    def _put(self, q: _queue.Queue, item, consumer: threading.Thread) -> bool:
        """Bounded put that cannot wedge on a dead consumer: False (and
        the caller fails the batch) once the consumer has exited."""
        while True:
            try:
                q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                if not consumer.is_alive():
                    return False

    # --------------------------------------------------------------- stages

    def _run_collect(self, epoch, dispatch_q, dispatcher) -> None:
        try:
            self._collect_loop(epoch, dispatch_q, dispatcher)
        except BaseException:
            log.critical("pipeline collect stage died on an uncaught exception")
            raise

    def _collect_loop(self, epoch, dispatch_q, dispatcher) -> None:
        hb = self.heartbeats["collect"]
        while True:
            batch = items = fut = None  # see _run_loop
            hb.idle()
            batch = self._form_batch(epoch)
            if batch is None:
                break
            if not batch:
                continue
            self._hold("collect", epoch, batch)
            # chaos seam outside the per-batch containment: a kill rule
            # unwinds this stage as a crash would
            chaos_fire("pipeline.collect")
            hb.busy()
            items = [it for it, _ in batch]
            try:
                fut = self._pool.submit(self._encode_timed, items, batch[0][1].times)
            except RuntimeError as e:  # the pool was shut down
                self._drop("collect", epoch)
                self._inflight_add(-1, -len(batch), epoch)
                self._fail_batch(batch, e)
                continue
            t0 = time.monotonic()
            self._hold("collect", epoch, batch, fut)
            ok = self._put(dispatch_q, (batch, fut), dispatcher)
            self._drop("collect", epoch)
            if self._epoch != epoch:
                # revived while this put was blocked: nothing consumes
                # this generation's queue any more
                self._shed_queues([dispatch_q])
            # blocked on a full dispatch queue: device or decode backpressure
            self._stall("collect", time.monotonic() - t0)
            if not ok:
                self._inflight_add(-1, -len(batch), epoch)
                self._fail_batch(batch, RuntimeError("pipeline dispatch stage died"))
                self._discard_ctx(fut)
        if self._epoch == epoch:
            self._put(dispatch_q, _SENTINEL, dispatcher)

    def _run_dispatch(self, epoch, dispatch_q, decode_q, decoder) -> None:
        try:
            self._dispatch_loop(epoch, dispatch_q, decode_q, decoder)
        except BaseException:
            log.critical("pipeline dispatch stage died on an uncaught exception")
            raise

    def _dispatch_loop(self, epoch, dispatch_q, decode_q, decoder) -> None:
        hb = self.heartbeats["dispatch"]
        while True:
            item = batch = fut = ctx = None  # see _run_loop
            hb.idle()
            item = dispatch_q.get()
            if self._epoch != epoch:
                # superseded by revive(): a batch this get raced away from
                # revive's queue drain must still fail at once
                if item is not _SENTINEL:
                    self._shed_item(item)
                return
            if item is not _SENTINEL:
                self._hold("dispatch", epoch, item[0], item[1])
            # chaos seam after the queue get, outside any per-batch try
            chaos_fire("pipeline.dispatch_q")
            hb.busy()
            if item is _SENTINEL:
                self._put(decode_q, _SENTINEL, decoder)
                return
            batch, fut = item
            t0 = time.monotonic()
            try:
                ctx = fut.result()  # the encode worker's result (or its error)
            except BaseException as e:  # noqa: BLE001 — fails this batch
                self._drop("dispatch", epoch)
                self._inflight_add(-1, -len(batch), epoch)
                self._fail_batch(batch, e)
                continue
            # waiting on the encode future: encode too slow to feed the device
            self._stall("dispatch", time.monotonic() - t0)
            times = batch[0][1].times
            times.dispatch0 = time.monotonic()
            try:
                ctx = self.stages.pipeline_dispatch(ctx)
            except BaseException as e:  # noqa: BLE001 — fails this batch
                # (the fast path handed its staging back)
                self._drop("dispatch", epoch)
                times.dispatch1 = time.monotonic()
                self._inflight_add(-1, -len(batch), epoch)
                self._fail_batch(batch, e)
                continue
            times.dispatch1 = time.monotonic()
            self._hold("dispatch", epoch, batch, ctx)
            ok = self._put(decode_q, (batch, ctx), decoder)
            self._drop("dispatch", epoch)
            if self._epoch != epoch:
                self._shed_queues([decode_q])  # see _collect_loop
            if not ok:
                self._inflight_add(-1, -len(batch), epoch)
                self._fail_batch(batch, RuntimeError("pipeline decode stage died"))
                self._discard_ctx(ctx)

    def _run_decode(self, epoch, decode_q) -> None:
        try:
            self._decode_loop(epoch, decode_q)
        except BaseException:
            log.critical("pipeline decode stage died on an uncaught exception")
            raise

    def _decode_loop(self, epoch, decode_q) -> None:
        hb = self.heartbeats["decode"]
        while True:
            item = batch = ctx = results = None  # see _run_loop
            busy = self._inflight > 0
            t0 = time.monotonic()
            hb.idle()
            item = decode_q.get()
            if self._epoch != epoch:
                if item is not _SENTINEL:
                    self._shed_item(item)  # see _dispatch_loop
                return
            if item is not _SENTINEL:
                self._hold("decode", epoch, item[0], item[1])
            # chaos seam after the queue get, outside any per-batch try
            chaos_fire("pipeline.decode_q")
            hb.busy()
            if busy:
                # idle while batches were in flight: the pipeline starved
                self._stall("decode", time.monotonic() - t0)
            if item is _SENTINEL:
                return
            batch, ctx = item
            times = batch[0][1].times
            times.decode0 = time.monotonic()
            try:
                results = self.stages.pipeline_decode(ctx)
                times.decode1 = time.monotonic()
                self._record_batch_stages(times)
                self._complete_batch(batch, results)
            except BaseException as e:  # noqa: BLE001 — fails this batch
                # (the fast path handed its staging back)
                if times.decode1 is None:
                    times.decode1 = time.monotonic()
                    self._record_batch_stages(times)
                self._fail_batch(batch, e)
            finally:
                self._drop("decode", epoch)
                self._inflight_add(-1, -len(batch), epoch)

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Drain the whole pipeline: the collector pushes every queued
        item through encode, dispatch and decode (trailed by the sentinel
        each stage forwards), so every accepted submitter gets an answer
        before the workers exit."""
        super().stop(drain_timeout_s=drain_timeout_s)
        self._pool.shutdown(wait=False)
