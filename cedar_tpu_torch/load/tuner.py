"""SLO-adaptive batching: a control loop that retunes a batcher from the
burn rates the serving path already measures (a copy of the JAX package's
load/tuner.py).

The micro-batcher's ``max_batch`` and ``window_s`` (linger) knobs trade a
lone request's latency against saturated throughput; the SLO tracker
(obs/slo.py) measures the latency burn rate from the same latencies the
request histograms observe. This controller closes the loop:

  * while the latency objective has headroom (burn <= ``burn_low``) and
    the backlog exceeds the current batch size, GROW ``max_batch``
    (bigger device dispatches amortize launch and readback);
  * the moment the latency objective starts burning (burn >=
    ``burn_high``), SHRINK the linger window: queued requests stop
    waiting for stragglers that overload supplies anyway;
  * when healthy and the demand is gone, decay both knobs back toward
    their configured home values, one knob per tick.

Every move is clamped to operator-set ``TuningBounds``, logged with the
measurement that justified it (served at ``/debug/load``), and published
to the ``cedar_batch_tuning{path,param}`` gauges. ``tick()`` is the whole
control step (tests drive it synchronously); ``start()`` runs it on a
daemon thread every ``interval_s`` for real serving. A batcher reads its
knobs once per claim, so a move takes effect at the next claimed batch
and never changes one already claimed. On the card the CLI warms every
batch bucket up to the tuner's clamp before serving (cli/webhook.py), so
no batch the tuner grows to meets a cold bucket.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ..server.supervisor import Heartbeat


class TuningBounds:
    """Operator-set clamps for the adaptive controller. The controller
    may move the knobs only inside [min, max]; home values (the batcher's
    configured settings) are captured at tuner construction."""

    def __init__(
        self,
        min_batch: int = 64,
        max_batch: int = 16384,
        min_window_s: float = 0.00005,
        max_window_s: float = 0.002,
    ):
        self.min_batch = max(1, int(min_batch))
        self.max_batch = max(self.min_batch, int(max_batch))
        self.min_window_s = max(0.0, float(min_window_s))
        self.max_window_s = max(self.min_window_s, float(max_window_s))

    def to_dict(self) -> dict:
        return {
            "min_batch": self.min_batch,
            "max_batch": self.max_batch,
            "min_window_us": round(self.min_window_s * 1e6, 1),
            "max_window_us": round(self.max_window_s * 1e6, 1),
        }


class AdaptiveBatchTuner:
    DECISION_LOG = 128

    def __init__(
        self,
        batcher,
        slo,
        path: str = "authorization",
        bounds: Optional[TuningBounds] = None,
        interval_s: float = 1.0,
        window_s: float = 60.0,
        burn_high: float = 1.0,
        burn_low: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.batcher = batcher
        self.slo = slo
        self.path = path
        self.bounds = bounds or TuningBounds()
        self.interval_s = max(0.01, float(interval_s))
        # burn measurement window (seconds of SLO ring history); the ring
        # floors this to one bucket, so short storms still register
        self.window_s = float(window_s)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self._clock = clock
        # home = the operator's configured settings: the point the
        # controller decays back to once the storm passes
        self.home_batch = int(batcher.max_batch)
        self.home_window_s = float(batcher.window_s)
        self._lock = threading.Lock()
        self.decisions: List[dict] = []
        self.moves = 0
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.heartbeat = Heartbeat()
        self._publish()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="batch-tuner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.heartbeat.busy()
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a sick controller must
                # never take serving down; it just stops tuning this tick
                import logging

                logging.getLogger(__name__).exception("tuner tick failed")
            self.heartbeat.idle()

    # ------------------------------------------------------------ control law

    def tick(self) -> Optional[dict]:
        """One control step; returns the decision applied (None when the
        measurements justified no move)."""
        self._ticks += 1
        burn = self.slo.latency_burn(self.path, self.window_s)
        # demand signal: backlog() (queued + claimed-into-the-pipeline
        # entries) where the batcher provides it — under saturation a
        # pipelined batcher's submit queue stays short while the demand
        # sits in its stage hand-off queues; queue_fill() alone would
        # blind the grow path exactly when it matters
        queue = getattr(self.batcher, "backlog", self.batcher.queue_fill)()
        cur_batch = int(self.batcher.max_batch)
        cur_window = float(self.batcher.window_s)
        decision = None
        if burn >= self.burn_high:
            # latency objective burning: stop lingering for stragglers.
            # One knob per tick — halving both at once overshoots and the
            # decision log stops explaining which measurement did what.
            new_window = max(self.bounds.min_window_s, cur_window / 2)
            if new_window < cur_window:
                self.batcher.window_s = new_window
                decision = self._log_move(
                    "linger_us", cur_window * 1e6, new_window * 1e6,
                    burn, queue,
                    f"latency burn {burn:.2f} >= {self.burn_high:g}: "
                    "shrink linger",
                )
        elif burn <= self.burn_low:
            if queue > cur_batch and cur_batch < self.bounds.max_batch:
                # headroom + queued demand beyond the batch size: grow the
                # dispatch for throughput
                new_batch = min(self.bounds.max_batch, cur_batch * 2)
                self.batcher.max_batch = new_batch
                decision = self._log_move(
                    "max_batch", cur_batch, new_batch, burn, queue,
                    f"headroom (burn {burn:.2f}) with queue {queue} > "
                    f"batch {cur_batch}: grow batch",
                )
            elif queue <= cur_batch and (
                abs(cur_window - self.home_window_s) > 1e-9
                or cur_batch != self.home_batch
            ):
                # storm passed: decay one knob per tick back to home
                if abs(cur_window - self.home_window_s) > 1e-9:
                    new_window = self._toward(
                        cur_window, self.home_window_s
                    )
                    self.batcher.window_s = new_window
                    decision = self._log_move(
                        "linger_us", cur_window * 1e6, new_window * 1e6,
                        burn, queue, "healthy: decay linger toward home",
                    )
                else:
                    new_batch = self.home_batch
                    self.batcher.max_batch = new_batch
                    decision = self._log_move(
                        "max_batch", cur_batch, new_batch, burn, queue,
                        "healthy: restore home batch size",
                    )
        if decision is not None:
            self._publish()
        return decision

    @staticmethod
    def _toward(cur: float, home: float) -> float:
        """Half the distance home (exact once within 1%, so the decay
        terminates instead of asymptoting forever)."""
        nxt = cur + (home - cur) / 2
        return home if abs(nxt - home) <= abs(home) * 0.01 else nxt

    def _log_move(
        self, param, frm, to, burn, queue, reason
    ) -> dict:
        decision = {
            "t": round(self._clock(), 3),
            "param": param,
            "from": round(float(frm), 2),
            "to": round(float(to), 2),
            "latency_burn": round(burn, 3),
            "queue_fill": int(queue),
            "reason": reason,
        }
        with self._lock:
            self.moves += 1
            self.decisions.append(decision)
            del self.decisions[: -self.DECISION_LOG]
        return decision

    # ------------------------------------------------------------- reporting

    def status(self) -> dict:
        with self._lock:
            decisions = list(self.decisions)
        return {
            "path": self.path,
            "max_batch": int(self.batcher.max_batch),
            "linger_us": round(float(self.batcher.window_s) * 1e6, 1),
            "home": {
                "max_batch": self.home_batch,
                "linger_us": round(self.home_window_s * 1e6, 1),
            },
            "bounds": self.bounds.to_dict(),
            "burn_thresholds": {
                "high": self.burn_high, "low": self.burn_low,
            },
            "window_s": self.window_s,
            "interval_s": self.interval_s,
            "ticks": self._ticks,
            "moves": self.moves,
            "decisions": decisions,
        }

    def _publish(self) -> None:
        try:
            from ..server.metrics import set_batch_tuning

            set_batch_tuning(self.path, "max_batch", self.batcher.max_batch)
            set_batch_tuning(
                self.path, "linger_us", self.batcher.window_s * 1e6
            )
        except Exception:  # noqa: BLE001 — metrics must never break tuning
            pass


__all__ = ["AdaptiveBatchTuner", "TuningBounds"]
