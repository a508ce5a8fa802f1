"""Singleflight request coalescing: N concurrent identical requests run ONE
evaluation and fan the result out to every waiter (a copy of the JAX
package's cache/singleflight.py).

Under a thundering herd of identical SubjectAccessReviews (a node drain
makes every kubelet re-check the same permission at once), a plain cache
still evaluates the request once per concurrent arrival: they all miss
before the first result lands. The coalescer closes that gap: the first
arrival for a key becomes the LEADER and runs the evaluation (one
batcher submit on the fast path); every concurrent duplicate becomes a
FOLLOWER that waits for the leader's result.

Deadline semantics are per waiter: a follower whose request budget
expires detaches with ``DeadlineExceeded`` and answers its caller's
fail-mode. It never cancels the leader, whose result still lands in the
decision cache for the next arrival. A leader failure is fanned out to
all waiters as a FRESH exception object per waiter (sharing one exception
across request threads interleaves tracebacks).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Tuple, TypeVar

from ..engine.batcher import DeadlineExceeded
from ..obs.trace import span as trace_span

log = logging.getLogger(__name__)

R = TypeVar("R")


class _Flight:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None


class SingleFlight:
    def __init__(self, path: str = "authorization"):
        self.path = path
        self._lock = threading.Lock()
        self._flights: dict = {}

    def do(
        self,
        key: str,
        fn: Callable[[], R],
        timeout: Optional[float] = None,
    ) -> Tuple[R, bool]:
        """Run ``fn`` once per concurrent ``key``; returns
        ``(result, is_leader)``.

        The leader's flight is unregistered BEFORE its event fires, so a
        request arriving after completion starts a fresh flight instead of
        being served an arbitrarily old result: freshness belongs to the
        decision cache, not the coalescer."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
            else:
                leader = False

        if leader:
            try:
                flight.value = fn()
            except BaseException as e:  # noqa: BLE001 — fanned out per waiter
                flight.error = e
            finally:
                # unregister, then publish, even if fn() raised something
                # unusual: a flight whose leader died without publishing
                # would strand every follower for its full deadline
                with self._lock:
                    self._flights.pop(key, None)
                flight.event.set()
            if flight.error is not None:
                raise flight.error
            return flight.value, True

        self._record_coalesced()
        # the follower's whole evaluation IS this wait: name it in the
        # request trace so a coalesced request's span tree accounts for
        # its latency (with no active trace: one thread-local read)
        with trace_span("coalesce.wait"):
            landed = flight.event.wait(timeout)
        if not landed:
            # per-waiter deadline: detach quietly; the leader keeps going
            raise DeadlineExceeded(
                "deadline exceeded waiting for coalesced result"
                + (f" (budget {timeout:.3f}s)" if timeout is not None else "")
            )
        if flight.error is not None:
            err = RuntimeError(f"coalesced evaluation failed: {flight.error!r}")
            err.__cause__ = flight.error
            raise err
        return flight.value, False

    def _record_coalesced(self) -> None:
        try:
            from ..server.metrics import record_cache_coalesced

            record_cache_coalesced(self.path)
        except Exception:  # noqa: BLE001 — metrics must never break serving
            log.debug("coalesce metrics publish failed", exc_info=True)

    def in_flight(self) -> int:
        with self._lock:
            return len(self._flights)
