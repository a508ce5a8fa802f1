"""Gameday fault injection: rate-limited artificial errors and denies (a
copy of the JAX package's server/error_injector.py).

Behavior parity with reference internal/server/error_injector.go: when
enabled, a token-bucket limiter (burst 1) per failure kind swaps the real
decision for a fake error (NoOpinion + error) or a fake deny, at most
``rate`` times per second each. Gated by --confirm-non-prod-inject-errors
(options.go:184-187).

A thin shim over the chaos seam registry (chaos/registry.py): the
ErrorInjector is a privately held ``response`` seam with two
rate-scheduled rules, the token bucket is chaos.registry.TokenBucket
(the JAX package re-exports it as RateLimiter), and every
artificial swap counts into ``cedar_chaos_injections_total{seam="response"}``.
Scenario files can script the same seam; this class keeps the
reference's flag surface and limiter semantics exactly. The server
applies it to /v1/authorize answers after the decision cache, so an
injected answer is never cached.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

from ..chaos.registry import (
    RESPONSE_SEAM,
    InjectionRule,
    Seam,
    TokenBucket,
    _record_injection,
)


@dataclass
class ErrorInjectionConfig:
    enabled: bool = False
    artificial_error_rate: float = 0.0
    artificial_deny_rate: float = 0.0


class InjectedFault(RuntimeError):
    """An artificial evaluator failure raised by BatchFaultInjector."""


class BatchFaultInjector:
    """Chaos hook for batch evaluation functions.

    Wraps a ``fn(items) -> results`` callable (the MicroBatcher's batch fn
    or a fast path's ``process_raw``) and injects faults at token-bucket
    rates, reusing the gameday TokenBucket machinery: ``error_rate``
    exceptions/second (raised before evaluation — exactly what a wedged
    device plane looks like to callers) and ``latency_rate`` artificial
    stalls of ``latency_s`` seconds. Very high rates (e.g. 1e9) fire on
    every call, which is what deterministic chaos tests want; production
    gamedays use small rates behind the same non-prod confirmation gate as
    ErrorInjector. Scenario-scripted equivalents live on the
    engine.encode/dispatch/decode seams (chaos/registry.py)."""

    def __init__(
        self,
        fn,
        latency_s: float = 0.0,
        latency_rate: float = 0.0,
        error_rate: float = 0.0,
        now=time.monotonic,
        sleep=time.sleep,
    ):
        self._fn = fn
        self.latency_s = latency_s
        self._latency_limiter = TokenBucket(latency_rate, now)
        self._error_limiter = TokenBucket(error_rate, now)
        self._sleep = sleep
        self.injected_errors = 0
        self.injected_stalls = 0

    def __call__(self, items):
        if self._error_limiter.allow():
            self.injected_errors += 1
            raise InjectedFault(
                f"injected evaluator fault #{self.injected_errors}"
            )
        if self.latency_s > 0 and self._latency_limiter.allow():
            self.injected_stalls += 1
            self._sleep(self.latency_s)
        return self._fn(items)


class ErrorInjector:
    """The reference-parity response injector: a privately held chaos
    ``response`` seam with ``response_error`` / ``response_deny`` rules at
    the configured token-bucket rates. Rule order matches the reference:
    the error limiter is consulted first, the deny limiter second, and a
    deny firing overrides the error swap."""

    def __init__(self, cfg: Optional[ErrorInjectionConfig], now=time.monotonic):
        cfg = cfg or ErrorInjectionConfig()
        self.enabled = cfg.enabled
        self._seam = Seam(RESPONSE_SEAM)
        self._seam.add_rule(
            InjectionRule(
                kind="response_error",
                rate=cfg.artificial_error_rate,
                now=now,
            )
        )
        self._seam.add_rule(
            InjectionRule(
                kind="response_deny",
                rate=cfg.artificial_deny_rate,
                now=now,
            )
        )

    def inject_if_enabled(
        self, decision: str, reason: str, error: Optional[str] = None
    ) -> Tuple[str, str, Optional[str]]:
        """(decision, reason, error) pass-through unless a limiter fires."""
        if not self.enabled:
            return decision, reason, error
        return self._seam.fire(
            (decision, reason, error), on_fire=_record_injection
        )
