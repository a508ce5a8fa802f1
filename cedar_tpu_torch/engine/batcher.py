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
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from typing import Callable, List, Optional, Sequence, TypeVar

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
        # per-stage liveness beacons (server/supervisor.py)
        self.heartbeats: dict = {}
        self._start_workers()

    def _start_workers(self) -> None:
        self.heartbeats.setdefault("worker", Heartbeat())
        self._thread = threading.Thread(target=self._run, name="micro-batcher", daemon=True)
        self._threads = [self._thread]
        self._thread.start()

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
            }

    def debug_stats(self) -> dict:
        """Live queue, batch and configuration snapshot for /debug/engine."""
        return {
            "mode": "serial",
            **self._batch_stats(),
            "max_batch": self.max_batch,
            "window_us": round(self.window_s * 1e6, 1),
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
        if slot.error is not None:
            if slot.key is not None:
                # a coalesced slot's waiters must not re-raise one shared
                # exception object from several threads (its traceback
                # would be mutated concurrently): one fresh error each
                err = RuntimeError(str(slot.error))
                err.__cause__ = slot.error
                raise err
            raise slot.error
        return slot.result

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

    def _form_batch(self) -> Optional[list]:
        """Wait for work and claim one batch under the lock. Returns None
        when stopped with an empty queue (the worker exits), else a
        possibly empty batch (every queued item withdrew during the
        window: never evaluate zero rows)."""
        with self._cv:
            while not self._queue and not self._stopped:
                self._cv.wait()
            if self._stopped and not self._queue:
                return None
            # the forming window lets concurrent submitters pile in
            window = self._linger_window_s()
            if window > 0:
                deadline = time.monotonic() + window
                while len(self._queue) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            batch = self._queue[: self.max_batch]
            del self._queue[: self.max_batch]
            # claimed entries leave the coalesce map: later submitters
            # must not attach to a result computed against an older set.
            # The batch's stage record takes the oldest member's enqueue
            # time as its queue-wait start
            times = _StageTimes(time.monotonic()) if batch else None
            if batch:
                self._batches_total += 1
                self._rows_total += len(batch)
                self._largest_batch = max(self._largest_batch, len(batch))
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
        hb = self.heartbeats["worker"]
        while True:
            hb.idle()
            batch = self._form_batch()
            if batch is None:
                return
            if not batch:
                continue
            hb.busy()
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
        # batches accepted into the pipeline and not yet decoded (three
        # threads update it, always under _inflight_lock), and its
        # high-water mark: above 1 shows batch N+1 staged or launched
        # while batch N was still in the pipeline
        self._inflight = 0
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
        for stage in ("collect", "dispatch", "decode"):
            self.heartbeats.setdefault(stage, Heartbeat())
        self._dispatch_q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._decode_q: _queue.Queue = _queue.Queue(maxsize=self.depth)
        self._decoder = threading.Thread(target=self._run_decode, name="pipe-decode", daemon=True)
        self._dispatcher = threading.Thread(
            target=self._run_dispatch, name="pipe-dispatch", daemon=True
        )
        self._thread = threading.Thread(target=self._run_collect, name="pipe-collect", daemon=True)
        self._threads = [self._thread, self._dispatcher, self._decoder]
        for t in self._threads:
            t.start()

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

    def _inflight_add(self, n: int) -> None:
        with self._inflight_lock:
            self._inflight += n
            self._inflight_peak = max(self._inflight_peak, self._inflight)

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

    def _run_collect(self) -> None:
        try:
            self._collect_loop()
        except BaseException:
            log.critical("pipeline collect stage died on an uncaught exception")
            raise

    def _collect_loop(self) -> None:
        hb = self.heartbeats["collect"]
        while True:
            hb.idle()
            batch = self._form_batch()
            if batch is None:
                break
            if not batch:
                continue
            hb.busy()
            items = [it for it, _ in batch]
            try:
                fut = self._pool.submit(self._encode_timed, items, batch[0][1].times)
            except RuntimeError as e:  # the pool was shut down
                self._fail_batch(batch, e)
                continue
            t0 = time.monotonic()
            self._inflight_add(1)
            ok = self._put(self._dispatch_q, (batch, fut), self._dispatcher)
            # blocked on a full dispatch queue: device or decode backpressure
            self._stall("collect", time.monotonic() - t0)
            if not ok:
                self._inflight_add(-1)
                self._fail_batch(batch, RuntimeError("pipeline dispatch stage died"))
        self._put(self._dispatch_q, _SENTINEL, self._dispatcher)

    def _run_dispatch(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException:
            log.critical("pipeline dispatch stage died on an uncaught exception")
            raise

    def _dispatch_loop(self) -> None:
        hb = self.heartbeats["dispatch"]
        while True:
            hb.idle()
            item = self._dispatch_q.get()
            hb.busy()
            if item is _SENTINEL:
                self._put(self._decode_q, _SENTINEL, self._decoder)
                return
            batch, fut = item
            t0 = time.monotonic()
            try:
                ctx = fut.result()  # the encode worker's result (or its error)
            except BaseException as e:  # noqa: BLE001 — fails this batch
                self._inflight_add(-1)
                self._fail_batch(batch, e)
                continue
            # waiting on the encode future: encode too slow to feed the device
            self._stall("dispatch", time.monotonic() - t0)
            times = batch[0][1].times
            times.dispatch0 = time.monotonic()
            try:
                ctx = self.stages.pipeline_dispatch(ctx)
            except BaseException as e:  # noqa: BLE001 — fails this batch
                times.dispatch1 = time.monotonic()
                self._inflight_add(-1)
                self._fail_batch(batch, e)
                continue
            times.dispatch1 = time.monotonic()
            if not self._put(self._decode_q, (batch, ctx), self._decoder):
                self._inflight_add(-1)
                self._fail_batch(batch, RuntimeError("pipeline decode stage died"))

    def _run_decode(self) -> None:
        try:
            self._decode_loop()
        except BaseException:
            log.critical("pipeline decode stage died on an uncaught exception")
            raise

    def _decode_loop(self) -> None:
        hb = self.heartbeats["decode"]
        while True:
            busy = self._inflight > 0
            t0 = time.monotonic()
            hb.idle()
            item = self._decode_q.get()
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
                if times.decode1 is None:
                    times.decode1 = time.monotonic()
                    self._record_batch_stages(times)
                self._fail_batch(batch, e)
            finally:
                self._inflight_add(-1)

    def stop(self, drain_timeout_s: float = 5.0) -> None:
        """Drain the whole pipeline: the collector pushes every queued
        item through encode, dispatch and decode (trailed by the sentinel
        each stage forwards), so every accepted submitter gets an answer
        before the workers exit."""
        super().stop(drain_timeout_s=drain_timeout_s)
        self._pool.shutdown(wait=False)
