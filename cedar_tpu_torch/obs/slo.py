"""SLO plane: availability + latency objectives with multi-window burn
rates (a copy of the JAX package's obs/slo.py, with the burn queries over
an arbitrary trailing window that the load tuner reads, load/tuner.py).

The serving path already histograms every request
(cedar_authorizer_request_duration_seconds); what an operator pages on is
not the histogram but the *error-budget burn rate* — how fast the current
bad-request fraction would exhaust the SLO's budget if it kept up. This
tracker is fed at the SAME call site (and from the same measured
latencies) as those histograms (server/http.py's per-request accounting),
bucketed into a fixed-size time ring, and computes the classic
multi-window burn rates (5m / 1h / 6h — the short window catches fast
burns, the long windows page only on sustained ones):

    burn = bad_fraction(window) / (1 - target)

``burn == 1`` means the budget is being consumed exactly at the sustain
rate; 14.4 over 1h is the canonical fast-burn page. Two objectives:

  * **availability** — a request is bad when it answered with an
    evaluation error (the ``<error>`` decision label: decode failures,
    deadline expiries, evaluator crashes);
  * **latency** — a request is bad when its e2e latency exceeded the
    latency budget (default: the per-request deadline budget).

Exposed at ``/debug/slo`` and as ``cedar_slo_*`` gauges refreshed at
scrape time (server/http.py /metrics). Pure host-side arithmetic — no
device work, no extra threads; recording is O(1) per request under one
lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

# window name -> seconds; ordered short to long
WINDOWS = (("5m", 300.0), ("1h", 3600.0), ("6h", 21600.0))

_BUCKET_S = 10.0


class _PathRing:
    """Fixed-size ring of (bucket epoch, total, errors, slow) counters —
    6h of 10s buckets."""

    __slots__ = ("epochs", "total", "errors", "slow", "n")

    def __init__(self):
        self.n = int(WINDOWS[-1][1] / _BUCKET_S) + 1
        self.epochs = [-1] * self.n
        self.total = [0] * self.n
        self.errors = [0] * self.n
        self.slow = [0] * self.n

    def add(self, epoch: int, error: bool, slow: bool) -> None:
        i = epoch % self.n
        if self.epochs[i] != epoch:
            self.epochs[i] = epoch
            self.total[i] = self.errors[i] = self.slow[i] = 0
        self.total[i] += 1
        if error:
            self.errors[i] += 1
        if slow:
            self.slow[i] += 1

    def window(self, now_epoch: int, seconds: float):
        """(total, errors, slow) over the trailing window."""
        span = int(seconds / _BUCKET_S)
        lo = now_epoch - span
        total = errors = slow = 0
        for i in range(self.n):
            e = self.epochs[i]
            if lo < e <= now_epoch:
                total += self.total[i]
                errors += self.errors[i]
                slow += self.slow[i]
        return total, errors, slow


class SLOTracker:
    def __init__(
        self,
        availability_target: float = 0.999,
        latency_target: float = 0.99,
        latency_budget_s: float = 2.0,
        clock: Callable[[], float] = time.time,
    ):
        self.availability_target = min(0.999999, max(0.0, availability_target))
        self.latency_target = min(0.999999, max(0.0, latency_target))
        self.latency_budget_s = latency_budget_s
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: Dict[str, _PathRing] = {}

    def record(self, path: str, latency_s: float, error: bool) -> None:
        """One answered request, from the same measured latency the
        request histogram observes."""
        epoch = int(self._clock() / _BUCKET_S)
        slow = latency_s > self.latency_budget_s
        with self._lock:
            ring = self._rings.get(path)
            if ring is None:
                ring = self._rings[path] = _PathRing()
            ring.add(epoch, error, slow)

    # ----------------------------------------------------------- burn queries

    def latency_burn(self, path: str, window_s: float) -> float:
        """Latency-objective burn rate over an arbitrary trailing window:
        the SLO-adaptive batch tuner's sensor (load/tuner.py). The window
        floors to one ring bucket so short storms still register; a path
        with no traffic reads 0.0 (nothing is burning)."""
        _, _, slow, total = self._window_counts(path, window_s)
        if not total:
            return 0.0
        return (slow / total) / (1.0 - self.latency_target)

    def availability_burn(self, path: str, window_s: float) -> float:
        """Availability-objective burn rate over an arbitrary trailing
        window (error answers / budget), with latency_burn's floor."""
        _, errors, _, total = self._window_counts(path, window_s)
        if not total:
            return 0.0
        return (errors / total) / (1.0 - self.availability_target)

    def _window_counts(self, path: str, window_s: float):
        """(epoch, errors, slow, total) over the trailing window, floored
        to one bucket."""
        epoch = int(self._clock() / _BUCKET_S)
        with self._lock:
            ring = self._rings.get(path)
        if ring is None:
            return epoch, 0, 0, 0
        total, errors, slow = ring.window(epoch, max(window_s, _BUCKET_S))
        return epoch, errors, slow, total

    # -------------------------------------------------------------- reporting

    def status(self) -> dict:
        """The /debug/slo document: targets plus per-path, per-window
        request counts, bad counts, and burn rates."""
        epoch = int(self._clock() / _BUCKET_S)
        avail_budget = 1.0 - self.availability_target
        lat_budget = 1.0 - self.latency_target
        with self._lock:
            rings = dict(self._rings)
        paths = {}
        for path, ring in rings.items():
            windows = {}
            for name, seconds in WINDOWS:
                total, errors, slow = ring.window(epoch, seconds)
                err_frac = errors / total if total else 0.0
                slow_frac = slow / total if total else 0.0
                windows[name] = {
                    "requests": total,
                    "errors": errors,
                    "slow": slow,
                    "availability_burn_rate": round(err_frac / avail_budget, 4),
                    "latency_burn_rate": round(slow_frac / lat_budget, 4),
                }
            paths[path] = windows
        return {
            "availability_target": self.availability_target,
            "latency_target": self.latency_target,
            "latency_budget_ms": round(self.latency_budget_s * 1e3, 3),
            "windows": dict(WINDOWS),
            "paths": paths,
        }

    def publish(self) -> None:
        """Refresh the cedar_slo_* gauges (called at /metrics scrape time,
        like the fleet replica-state gauge)."""
        try:
            from ..server.metrics import set_slo_burn_rate, set_slo_target
        except Exception:  # noqa: BLE001 — metrics must never break serving
            return
        doc = self.status()
        for path, windows in doc["paths"].items():
            set_slo_target(path, "availability", self.availability_target)
            set_slo_target(path, "latency", self.latency_target)
            for window, w in windows.items():
                set_slo_burn_rate(
                    path, "availability", window, w["availability_burn_rate"]
                )
                set_slo_burn_rate(
                    path, "latency", window, w["latency_burn_rate"]
                )


def slo_from_histogram(
    histogram, budget_s: float, path_label: Optional[str] = None
) -> dict:
    """Offline helper: bad-fraction estimate straight from a cumulative
    histogram (via its public ``fraction_over``) — the cross-check that
    the tracker and the histogram can never structurally disagree, used
    by tests and dashboards."""
    return {
        key: frac
        for key, frac in histogram.fraction_over(budget_s).items()
        if path_label is None or dict(key).get("path") == path_label
    }


__all__ = ["SLOTracker", "WINDOWS", "slo_from_histogram"]
