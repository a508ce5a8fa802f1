"""Decorrelated-jitter retry backoff.

Shared by every reconnect loop that talks to the apiserver (the CRD store's
list+watch loop in stores/crd.py and the KubeConfigClient's idempotent GETs
in stores/kubeclient.py). The previous pattern — ``log.error(...); wait(2.0);
continue`` — retries every replica on the same fixed cadence, so an
apiserver blip comes back to a synchronized thundering herd. Decorrelated
jitter (the AWS architecture-blog variant) spreads retries across
``[base, prev*3]`` capped at ``cap``, which both desynchronizes clients and
backs off exponentially on persistent failure.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type


class Backoff:
    """``next()`` returns the seconds to sleep before the upcoming retry;
    ``reset()`` on success returns to the base delay. Not thread-safe: each
    retry loop owns its instance."""

    def __init__(
        self,
        base_s: float = 0.5,
        cap_s: float = 30.0,
        uniform: Callable[[float, float], float] = random.uniform,
    ):
        self.base_s = base_s
        self.cap_s = cap_s
        self._uniform = uniform
        self._sleep = base_s

    def next(self) -> float:
        # decorrelated jitter: each delay is drawn from [base, 3*prev]
        # (prev starts at base), so consecutive failures grow the window
        # exponentially while two clients that failed together decorrelate
        # from the very first retry — returning a deterministic base delay
        # first would re-synchronize the herd for the common single-blip case
        self._sleep = min(self.cap_s, self._uniform(self.base_s, self._sleep * 3))
        return self._sleep

    def reset(self) -> None:
        self._sleep = self.base_s


def retry_call(
    fn: Callable,
    attempts: int = 3,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    backoff: Optional[Backoff] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` up to ``attempts`` times, sleeping a decorrelated-jitter
    delay between failures; the final failure re-raises. Only for idempotent
    operations (GET/list)."""
    bo = backoff or Backoff()
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on:
            if attempt == attempts - 1:
                raise
            sleep(bo.next())
