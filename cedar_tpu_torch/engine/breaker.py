"""Circuit breaker for the device evaluation plane (a copy of the JAX
package's engine/breaker.py; only the guard differs).

The device evaluator sits on the apiserver's critical path, where a sick
card (a hung launch, a lost device, a wedged stage) must not turn every
authorization request into a multi-second stall. The breaker watches
consecutive evaluator failures and latency breaches; while it is open,
requests answer the failure posture at once, without reaching the
batcher or the card: NoOpinion with an evaluationError on /v1/authorize,
the admission fail-mode on /v1/admit. The port has no interpreter
fallback, so nothing re-runs the work elsewhere (the JAX package's
guarded_call does). Half-open probes prove the device plane healthy again.

State machine (the classic three states):

  CLOSED      normal operation; every call allowed. ``failure_threshold``
              consecutive errors OR ``latency_breach_threshold`` consecutive
              calls slower than ``latency_threshold_s`` trip it OPEN.
  OPEN        all calls rejected (callers answer the posture) for
              ``recovery_s`` seconds, then the breaker half-opens.
  HALF_OPEN   calls are allowed as probes; ``half_open_probes`` consecutive
              successes close the breaker, any failure re-opens it and
              restarts the recovery clock.

Thread-safe: request threads, the micro-batcher thread, and the reloader
may all record outcomes concurrently. State changes publish to the
``cedar_authorizer_breaker_state`` gauge (server/metrics.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding: 0 = closed (healthy), 1 = open, 2 = half-open
STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


class CircuitBreaker:
    def __init__(
        self,
        name: str = "device",
        failure_threshold: int = 5,
        latency_threshold_s: Optional[float] = None,
        latency_breach_threshold: Optional[int] = None,
        recovery_s: float = 10.0,
        half_open_probes: int = 2,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.latency_threshold_s = latency_threshold_s
        self.latency_breach_threshold = int(
            latency_breach_threshold or failure_threshold
        ) or 1
        self.recovery_s = recovery_s
        self.half_open_probes = max(1, int(half_open_probes))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._breaches = 0
        self._probe_successes = 0
        self._opened_at = 0.0
        self._publish(CLOSED)

    # ----------------------------------------------------------------- state

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        # OPEN lazily decays to HALF_OPEN once the recovery window elapses;
        # there is no timer thread to die or wedge
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.recovery_s
        ):
            self._transition(HALF_OPEN)
        return self._state

    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        log.warning(
            "circuit breaker %r: %s -> %s", self.name, self._state, state
        )
        self._state = state
        if state == OPEN:
            self._opened_at = self._clock()
        self._failures = 0
        self._breaches = 0
        self._probe_successes = 0
        self._publish(state)

    def _publish(self, state: str) -> None:
        try:
            from ..server.metrics import record_breaker_transition, set_breaker_state

            set_breaker_state(self.name, STATE_CODES[state])
            if state != CLOSED or self._opened_at:
                record_breaker_transition(self.name, state)
        except Exception:  # noqa: BLE001 — metrics must never break serving
            log.exception("breaker metrics publish failed")

    # --------------------------------------------------------------- surface

    def allow(self) -> bool:
        """True when a call may go to the device plane (CLOSED, or a
        HALF_OPEN probe). False: the caller answers the failure posture."""
        with self._lock:
            return self._state_locked() != OPEN

    def record_success(self, latency_s: Optional[float] = None) -> None:
        with self._lock:
            state = self._state_locked()
            if (
                latency_s is not None
                and self.latency_threshold_s is not None
                and latency_s > self.latency_threshold_s
            ):
                # a "success" past the latency budget is a breach: a wedged
                # link serves correct answers arbitrarily slowly
                self._breaches += 1
                if state == HALF_OPEN or (
                    self._breaches >= self.latency_breach_threshold
                ):
                    self._transition(OPEN)
                return
            self._failures = 0
            self._breaches = 0
            if state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            state = self._state_locked()
            if state == HALF_OPEN:
                self._transition(OPEN)  # failed probe: full recovery wait
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._transition(OPEN)

    def force_open(self) -> None:
        """Trip immediately, bypassing the failure-streak accounting — the
        device-loss recovery (server/supervisor.py) calls this when an
        error is classified FATAL: waiting for threshold-1 more broken
        batches would only burn more callers' deadline budgets."""
        with self._lock:
            self._transition(OPEN)

    def half_open_now(self) -> None:
        """Skip the remaining recovery wait and start probing — the
        re-arm step after a successful engine rebuild. Half-open (not
        closed): live probes, not the rebuild's own warm calls, decide
        whether the new plane actually serves."""
        with self._lock:
            if self._state == OPEN:
                self._transition(HALF_OPEN)


class BreakerOpen(RuntimeError):
    """The device breaker is open: the work was not sent to the device."""

    MESSAGE = "device breaker open"


def record_device_failure(breaker, exc: BaseException, path: str,
                          on_error=None, metrics=None) -> None:
    """One failed device call: feed the breaker, the device-error observer
    (server/supervisor.py DeviceRecovery.observe: a fatal error trips the
    breaker and rebuilds the engine off the serving path; its failures
    never reach the caller) and the ``evaluator_error`` fallback count.
    The caller then fails the work with the posture."""
    if breaker is not None:
        breaker.record_failure()
    if on_error is not None:
        try:
            on_error(exc)
        except Exception:  # noqa: BLE001 — recovery must not break serving
            log.exception("%s device-error observer failed", path)
    if metrics is not None:
        metrics.record_fallback_batch(path, "evaluator_error")


def guarded_call(breaker, device_call, path: str, on_error=None, metrics=None):
    """Run ``device_call()`` behind an optional breaker (the serial fast
    path's batches, _RawFastPath._guarded_process). An open breaker raises
    BreakerOpen without calling it; a raising device call feeds the breaker
    and ``on_error`` (record_device_failure) and re-raises; a success's
    latency drives breach accounting and recovery probes. There is no
    fallback call: the caller answers a raised error with the posture.
    ``path`` labels the fallback count of ``metrics`` (server/metrics.py
    WebhookMetrics; None records nothing)."""
    if breaker is not None and not breaker.allow():
        if metrics is not None:
            metrics.record_fallback_batch(path, "breaker_open")
        raise BreakerOpen(BreakerOpen.MESSAGE)
    t0 = time.monotonic()
    try:
        result = device_call()
    except Exception as e:
        log.exception("%s device call failed", path)
        record_device_failure(breaker, e, path, on_error, metrics)
        raise
    if breaker is not None:
        breaker.record_success(time.monotonic() - t0)
    return result
