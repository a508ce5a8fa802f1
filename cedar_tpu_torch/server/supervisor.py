"""Worker-liveness beacons of the serving threads.

The batcher's worker loops (engine/batcher.py) beat a ``Heartbeat`` each
iteration: ``busy()`` before work that must finish, ``idle()`` before
blocking on their intake, so an idle heartbeat never ages into a wedge.
``/debug/engine`` shows each stage's (age, busy). The watchdog that would
restart a wedged stage is not part of the port yet.
"""

from __future__ import annotations

import time


class Heartbeat:
    """Lock-free worker-liveness beacon: a single (monotonic ts, busy)
    tuple swap per beat (GIL-atomic)."""

    __slots__ = ("_state",)

    def __init__(self):
        self._state = (time.monotonic(), False)

    def busy(self) -> None:
        self._state = (time.monotonic(), True)

    def idle(self) -> None:
        self._state = (time.monotonic(), False)

    def snapshot(self) -> tuple:
        """(seconds since the last beat, busy)."""
        ts, busy = self._state
        return time.monotonic() - ts, busy
