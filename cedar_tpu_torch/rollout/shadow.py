"""Asynchronous shadow evaluation of live traffic against a candidate set
(the JAX package's rollout/shadow.py).

The live serving paths hand each raw request body and the answer they
already gave to ``ShadowEvaluator.offer``: a sampling draw and a
``put_nowait``, so the live answer never waits on shadow work. One daemon
worker drains the bounded queue in batches and evaluates each body on the
CANDIDATE stack:

  * SubjectAccessReview bodies convert through the live server's
    ``get_authorizer_attributes`` and run the candidate's
    ``CedarWebhookAuthorizer.authorize_batch``, over the candidate
    authorization engine's ``evaluate_batch`` (the match kernels on the
    card) when staged with one;
  * AdmissionReview bodies convert through ``AdmissionRequest`` and run
    the candidate ``CedarAdmissionHandler.handle_batch`` over the
    candidate admission engine.

Shadow evaluation bypasses every decision cache: it measures what the
candidate decides, not what a cache remembers of the live set. A full
queue sheds (cedar_shadow_shed_total): shadow work is the first load
dropped. A candidate evaluation that raises (a failed kernel launch among
them) counts as a candidate error; it is never answered on another path.

The worker's kernel launches count into its own ``launches`` (by kernel
name), not into the served launch counts (ops/cuda_match.py
counting_into): shadow work is not served traffic.

Results land in the rollout's DiffReport (report.py) and the
cedar_shadow_* metrics. Live answers that were themselves errors (decode
failures, deadline expiries, fail-mode admissions) are skipped, not
diffed: they say nothing about the policy change.
"""

from __future__ import annotations

import json
import logging
import queue
import random
import threading
import time
from typing import Optional

from ..chaos.registry import chaos_fire
from ..engine.evaluator import track_warm_thread, untrack_warm_thread, warm_shutdown_set
from ..ops import cuda_match
from ..entities.admission import AdmissionRequest
from ..server import metrics
from ..server.sar import get_authorizer_attributes
from ..server.supervisor import Heartbeat
from .report import DiffReport, compare_admission, compare_authorization

log = logging.getLogger(__name__)

# queue endpoints -> metric path labels (those of the serving metrics)
_PATHS = {"authorize": "authorization", "admit": "admission"}

DEFAULT_QUEUE_DEPTH = 1024
# drain batch cap: large enough to amortize a batched candidate
# evaluation, small enough that one shadow batch cannot hold the host for
# a window a live request would see. The duty-cycle sleep lets a backlog
# build; draining it in one large batch would put a spike into the live
# p99, so many short batches interleave with serving instead
DEFAULT_BATCH_MAX = 16
# duty-cycle bound: after a drain batch of T seconds the worker sleeps
# T * (1/duty - 1), holding shadow work to about this share of one core.
# Unbounded, a saturated host lets the worker keep pace with live traffic
# by taking the CPU the live encode and decode need (the interpreter lock
# and the cores); bounded, the queue backs up and sheds instead
DEFAULT_DUTY_CYCLE = 0.1
# linger after the first dequeued item: the offering request is usually
# still in its serving tail (response rendering, metrics) when the offer
# lands; 2 ms lets it finish and lets bursts batch up
BATCH_LINGER_S = 0.002


class ShadowEvaluator:
    """Bounded best-effort queue and one worker evaluating live traffic on
    a candidate stack (rollout/controller.py builds the stack)."""

    def __init__(
        self,
        candidate,
        report: DiffReport,
        sample_rate: float = 1.0,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        batch_max: int = DEFAULT_BATCH_MAX,
        seed: Optional[int] = None,
        duty_cycle: float = DEFAULT_DUTY_CYCLE,
        attributor=None,
    ):
        self.candidate = candidate
        self.report = report
        # optional explain-plane DiffAttributor: on a decision diff the
        # exemplar gains the live and candidate determining policies
        # (host plane, diffing rows only)
        self.attributor = attributor
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self.batch_max = max(1, int(batch_max))
        self.duty_cycle = max(0.01, min(1.0, float(duty_cycle)))
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(queue_depth)))
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        # offered-but-unprocessed count; drain() waits on it
        self._pending = 0
        self._pending_cv = threading.Condition()
        # supervisor liveness beacon: idle while blocked on the queue, busy
        # only inside a drain batch
        self.heartbeat = Heartbeat()
        # the candidate engines' kernel launches made by this worker
        self.launches = dict.fromkeys(cuda_match.LAUNCHES, 0)
        self._worker: Optional[threading.Thread] = None
        self._start_worker()

    def _start_worker(self) -> None:
        worker = threading.Thread(target=self._run, name="shadow-eval", daemon=True)
        # the worker spends its life in candidate evaluate_batch calls on
        # the card: registered with the engine module's atexit join, and
        # its loop polls the shutdown flag
        track_warm_thread(worker)
        self._worker = worker
        worker.start()

    def worker_threads(self) -> list:
        """The drain worker thread (supervisor liveness probe)."""
        return [self._worker] if self._worker is not None else []

    def revive(self, force: bool = False) -> bool:
        """Restart a dead (or, forced, wedged) drain worker (supervisor
        hook). The queue and its pending offers survive: the fresh worker
        takes them; a superseded worker exits at its next loop check.
        Items lost inside a killed worker were already counted off
        pending by its drain's finally, so drain() cannot wedge on them."""
        if self._stop.is_set():
            return False
        w = self._worker
        if w is not None and w.is_alive() and not force:
            return False
        log.warning("shadow evaluator: restarting drain worker")
        self._start_worker()
        return True

    # --------------------------------------------------------------- intake

    def offer(self, endpoint: str, body: bytes, live) -> bool:
        """Enqueue one live (body, answer) pair. Never blocks and never
        raises into the caller: a sampled-out request returns False, a
        full queue sheds (counted), a stopped evaluator ignores the offer."""
        if self._stop.is_set():
            return False
        rate = self.sample_rate
        if rate <= 0.0:
            return False
        if rate < 1.0 and self._rng.random() >= rate:
            return False
        path = _PATHS.get(endpoint, endpoint)
        try:
            # chaos seam, contained: offer() runs on the serving thread, so
            # an injected error or kill sheds the observation and never
            # reaches the request (a latency rule does stall the caller:
            # that is what a slow offer path is)
            chaos_fire("shadow.offer")
        except BaseException:  # noqa: BLE001 — includes the injected kill
            self.report.record_shed(path)
            return False
        try:
            with self._pending_cv:
                self._q.put_nowait((endpoint, body, live))
                self._pending += 1
        except queue.Full:
            self.report.record_shed(path)
            metrics.record_shadow_shed(path)
            return False
        return True

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Wait until every offered item was processed; True when the queue
        drained within the timeout."""
        deadline = time.monotonic() + timeout_s
        with self._pending_cv:
            while self._pending > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._pending_cv.wait(timeout=remaining)
        return True

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5.0)

    def queue_depth(self) -> int:
        return self._q.qsize()

    # --------------------------------------------------------------- worker

    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException:  # noqa: BLE001 — visibility, then unwind
            try:
                metrics.record_worker_death("shadow.worker")
            except Exception:  # noqa: BLE001 — must not mask the death
                pass
            log.critical("shadow worker died on an uncaught exception")
            raise
        finally:
            untrack_warm_thread(threading.current_thread())

    def _run_loop(self) -> None:
        me = threading.current_thread()
        while not self._stop.is_set() and not warm_shutdown_set():
            if self._worker is not me:
                return  # superseded by revive(): a fresh worker owns the queue
            self.heartbeat.idle()
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            self.heartbeat.busy()
            self._stop.wait(BATCH_LINGER_S)
            items = [first]
            while len(items) < self.batch_max:
                try:
                    items.append(self._q.get_nowait())
                except queue.Empty:
                    break
            t0 = time.monotonic()
            try:
                with cuda_match.counting_into(self.launches):
                    self._process(items)
            except Exception:  # noqa: BLE001 — shadow must never die silently
                log.exception("shadow evaluation batch failed")
                self.report.record_error()
            finally:
                with self._pending_cv:
                    self._pending -= len(items)
                    self._pending_cv.notify_all()
            # duty-cycle bound (DEFAULT_DUTY_CYCLE)
            elapsed = time.monotonic() - t0
            duty = self.duty_cycle
            if duty < 1.0 and elapsed > 0.0005:
                self._stop.wait(min(1.0, elapsed * (1.0 / duty - 1.0)))

    def _process(self, items) -> None:
        # chaos seam: an error rule exercises the containment in the loop
        # above; a kill rule unwinds the worker (the supervisor's restart)
        chaos_fire("shadow.process")
        auth = [(body, live) for ep, body, live in items if ep == "authorize"]
        adm = [(body, live) for ep, body, live in items if ep == "admit"]
        if auth:
            self._process_authorize(auth)
        if adm:
            self._process_admission(adm)

    # ------------------------------------------------------- authorization

    def _process_authorize(self, pairs) -> None:
        parsed = []  # (attributes, live (decision, reason))
        for body, live in pairs:
            try:
                attributes = get_authorizer_attributes(json.loads(body))
            except Exception:  # noqa: BLE001 — unparseable: live erred too
                self.report.record_skipped("authorization")
                continue
            parsed.append((attributes, live))
        if not parsed:
            return
        try:
            results = self.candidate.authorizer.authorize_batch([a for a, _ in parsed])
        except Exception:  # noqa: BLE001 — count it, keep the worker alive
            log.exception("candidate authorize batch failed")
            self.report.record_error()
            return
        for (attributes, live), cand in zip(parsed, results):
            compare_authorization(self.report, attributes, live, cand,
                                  publish_metrics=True, attributor=self.attributor)

    # ----------------------------------------------------------- admission

    def _process_admission(self, pairs) -> None:
        parsed = []  # (AdmissionRequest, live (allowed, message))
        for body, live in pairs:
            extracted = self._extract_admission_live(live)
            if extracted is None:
                # live answered an error / fail-mode / parse response
                self.report.record_skipped("admission")
                continue
            try:
                req = AdmissionRequest.from_admission_review(json.loads(body))
            except Exception:  # noqa: BLE001 — live erred on these too
                self.report.record_skipped("admission")
                continue
            parsed.append((req, extracted))
        if not parsed:
            return
        try:
            # raise_errors: a failed candidate evaluation is a candidate
            # error, never the handler's allow-on-error answer diffed as if
            # it were a decision
            responses = self.candidate.admission_handler.handle_batch(
                [r for r, _ in parsed], raise_errors=True)
        except Exception:  # noqa: BLE001 — count it, keep the worker alive
            log.exception("candidate admission batch failed")
            self.report.record_error()
            return
        for (req, live), resp in zip(parsed, responses):
            compare_admission(self.report, req, live, (resp.allowed, resp.message or ""),
                              publish_metrics=True, attributor=self.attributor)

    @staticmethod
    def _extract_admission_live(review_doc) -> Optional[tuple]:
        """(allowed, message) of the live AdmissionReview response, or None
        when the live answer was an error or fail-mode response (status
        code other than 200), which is not diffed."""
        try:
            resp = review_doc.get("response") or {}
            status = resp.get("status") or {}
            if status.get("code", 200) != 200:
                return None
            return bool(resp.get("allowed")), status.get("message", "") or ""
        except Exception:  # noqa: BLE001 — malformed live payloads skip
            return None
