"""Self-healing supervision for the webhook's long-lived threads and the
device plane (the JAX package's server/supervisor.py, for the card).

The serving process is a small organism of worker threads — micro-batcher
stages (encode pool / dispatch / decode) and the directory stores' reload
tickers — any of which can die from an uncaught exception or wedge inside
a hung device call. Without supervision a dead decode thread leaves every
later request to expire, and a lost device fails every batch forever.

Three pieces:

  * ``Heartbeat`` — a (timestamp, busy) pair worker loops update each
    iteration. Idle-blocked workers park as *idle* (waiting for work is
    healthy forever); only a *busy* heartbeat growing stale reads as a
    wedge.
  * ``Supervisor`` — a watchdog thread polling registered components:
    any dead thread, or a busy heartbeat older than the wedge budget,
    triggers the component's ``restart`` callable (the batchers' and
    directory stores' ``revive()``: a batcher restarts its stages and
    answers the batches stranded in a dead stage with the failure
    posture). Restarts are cooldown-limited and counted
    (``cedar_supervisor_restarts_total{component}``).
  * ``DeviceRecovery`` — observes the fast paths' device errors; a fatal
    one (``is_fatal_device_error``: a lost device, a sticky CUDA fault)
    force-opens the breaker, so requests answer the posture at once, and
    rebuilds the engine's compiled set on the card from its retained
    host-side pack, warmed before it is published
    (``TorchPolicyEngine.rebuild_compiled``), then re-arms the breaker
    half-open so live probes confirm recovery
    (``cedar_device_rebuilds_total``). After a sticky CUDA fault the
    process's context is poisoned: the rebuild fails, ``failures`` counts
    it, the breaker stays open and the server keeps answering the posture
    within its budget; nothing here restarts the process.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Callable, List, Optional

log = logging.getLogger(__name__)


class Heartbeat:
    """Lock-free worker-liveness beacon: a single (monotonic ts, busy)
    tuple swap per beat (GIL-atomic), read by the supervisor. Workers mark
    ``busy()`` before entering work that must complete within the wedge
    budget and ``idle()`` before blocking on their intake — an idle
    heartbeat never ages into a wedge verdict."""

    __slots__ = ("_state", "_clock")

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._state = (clock(), False)

    def busy(self) -> None:
        self._state = (self._clock(), True)

    def idle(self) -> None:
        self._state = (self._clock(), False)

    def snapshot(self) -> tuple:
        """(seconds since the last beat, busy)."""
        ts, busy = self._state
        return self._clock() - ts, busy

    def is_wedged(self, budget_s: float) -> bool:
        age, busy = self.snapshot()
        return busy and age > budget_s


class HeartbeatGroup:
    """Composite heartbeat over a component with several worker loops
    (the pipelined batcher's collect/dispatch/decode stages): wedged when
    ANY member heartbeat is wedged. ``provider`` is re-read every probe so
    components that swap their workers stay covered."""

    def __init__(self, provider: Callable[[], dict]):
        self._provider = provider

    def is_wedged(self, budget_s: float) -> bool:
        try:
            beats = self._provider() or {}
        except Exception:  # noqa: BLE001 — a sick probe reads healthy
            return False
        return any(h.is_wedged(budget_s) for h in beats.values())

    def snapshot(self) -> tuple:
        """(age, busy) of the stalest BUSY member, else the freshest idle
        one — the number an operator wants on /debug/supervisor."""
        try:
            beats = list((self._provider() or {}).values())
        except Exception:  # noqa: BLE001
            return (0.0, False)
        if not beats:
            return (0.0, False)
        snaps = [h.snapshot() for h in beats]
        busy = [s for s in snaps if s[1]]
        if busy:
            return max(busy, key=lambda s: s[0])
        return min(snaps, key=lambda s: s[0])


class _Component:
    __slots__ = (
        "name", "replica", "threads", "restart", "heartbeat",
        "wedge_budget_s", "cooldown_until", "restarts", "failures",
        "last_event",
    )

    def __init__(
        self, name, threads, restart, heartbeat, wedge_budget_s, replica=""
    ):
        self.name = name
        # fleet-member identity: components are keyed {component, replica}
        # so one replica's death/restart is attributable instead of
        # vanishing into a shared component namespace; "" on the
        # single-engine path keeps existing keys/metrics stable
        self.replica = replica
        self.threads = threads  # () -> List[threading.Thread]
        self.restart = restart  # (reason: str) -> bool
        self.heartbeat = heartbeat
        self.wedge_budget_s = wedge_budget_s
        self.cooldown_until = 0.0
        self.restarts = 0
        self.failures = 0
        self.last_event: Optional[dict] = None

    @property
    def key(self) -> str:
        return f"{self.name}/{self.replica}" if self.replica else self.name


class Supervisor:
    """Watchdog over registered components; see module docstring. All
    state transitions happen on the supervisor's own thread (or an
    explicit ``check_once`` call from tests) — restart callables must be
    safe to invoke from a thread that is not the component's own."""

    def __init__(
        self,
        interval_s: float = 1.0,
        wedge_budget_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.interval_s = max(0.05, float(interval_s))
        self.wedge_budget_s = float(wedge_budget_s)
        self._clock = clock
        self._components: List[_Component] = []
        self._recoveries: list = []  # DeviceRecovery instances (status only)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._checks = 0

    # ------------------------------------------------------------- wiring

    def register(
        self,
        name: str,
        *,
        threads: Callable[[], List[threading.Thread]],
        restart: Callable[[str], bool],
        heartbeat: Optional[Heartbeat] = None,
        wedge_budget_s: Optional[float] = None,
        replica: str = "",
    ) -> None:
        """Put one component under supervision. ``threads`` returns the
        worker threads that must all be alive; ``restart(reason)`` revives
        the component (returning False when nothing needed doing);
        ``heartbeat`` enables wedge detection on top of liveness;
        ``replica`` names the fleet member this component serves (status
        keys and restart metrics carry it — empty on the single-engine
        path)."""
        budget = (
            self.wedge_budget_s if wedge_budget_s is None else wedge_budget_s
        )
        comp = _Component(name, threads, restart, heartbeat, budget, replica)
        with self._lock:
            self._components.append(comp)

    def register_recovery(self, recovery: "DeviceRecovery") -> None:
        """Track a DeviceRecovery for /debug/supervisor reporting (the
        recovery drives itself off the fast path's error hook)."""
        with self._lock:
            self._recoveries.append(recovery)

    # ------------------------------------------------------------ watchdog

    def check_once(self) -> List[dict]:
        """One watchdog pass; returns the restart events it performed."""
        now = self._clock()
        self._checks += 1
        with self._lock:
            components = list(self._components)
        events = []
        for comp in components:
            if now < comp.cooldown_until:
                continue
            reason = None
            try:
                threads = comp.threads() or []
                dead = [t for t in threads if t is not None and not t.is_alive()]
                if dead:
                    reason = (
                        f"dead thread(s): "
                        f"{', '.join(t.name or '?' for t in dead)}"
                    )
                elif comp.heartbeat is not None and comp.heartbeat.is_wedged(
                    comp.wedge_budget_s
                ):
                    age, _busy = comp.heartbeat.snapshot()
                    reason = (
                        f"wedged: busy heartbeat {age:.1f}s old "
                        f"(budget {comp.wedge_budget_s:.1f}s)"
                    )
            except Exception:  # noqa: BLE001 — a sick probe must not kill the loop
                log.exception("supervisor probe for %s failed", comp.name)
                continue
            if reason is None:
                continue
            event = {"component": comp.name, "reason": reason, "ok": False}
            if comp.replica:
                event["replica"] = comp.replica
            log.warning("supervisor: restarting %s (%s)", comp.key, reason)
            try:
                event["ok"] = bool(comp.restart(reason))
            except Exception:  # noqa: BLE001 — count, retry next tick
                log.exception("supervisor: restart of %s failed", comp.key)
                comp.failures += 1
            if event["ok"]:
                comp.restarts += 1
                _record_restart(comp.name, comp.replica)
            # cooldown either way: fresh threads need a tick to come up,
            # and a persistently failing restart must not spin the loop
            comp.cooldown_until = now + max(1.0, 2 * self.interval_s)
            comp.last_event = event
            events.append(event)
        return events

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the watchdog must not die
                log.exception("supervisor check failed")

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="supervisor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2 * self.interval_s + 1.0)

    # -------------------------------------------------------------- status

    def status(self) -> dict:
        """Snapshot for /debug/supervisor."""
        with self._lock:
            components = list(self._components)
            recoveries = list(self._recoveries)
        out = {
            "running": self._thread is not None and self._thread.is_alive(),
            "interval_s": self.interval_s,
            "checks": self._checks,
            "components": {},
            "device_recovery": {},
        }
        for comp in components:
            entry = {
                "restarts": comp.restarts,
                "restart_failures": comp.failures,
                "last_event": comp.last_event,
            }
            if comp.replica:
                entry["replica"] = comp.replica
            try:
                threads = comp.threads() or []
                entry["threads_alive"] = sum(
                    1 for t in threads if t is not None and t.is_alive()
                )
                entry["threads"] = len(threads)
            except Exception:  # noqa: BLE001 — status must not 500
                entry["threads"] = "error"
            if comp.heartbeat is not None:
                age, busy = comp.heartbeat.snapshot()
                entry["heartbeat"] = {"age_s": round(age, 3), "busy": busy}
            out["components"][comp.key] = entry
        for rec in recoveries:
            out["device_recovery"][rec.name] = rec.status()
        return out


def _record_restart(component: str, replica: str = "") -> None:
    try:
        from .metrics import record_supervisor_restart

        record_supervisor_restart(component, replica)
    except Exception:  # noqa: BLE001 — metrics must never break recovery
        log.debug("supervisor restart metric publish failed", exc_info=True)


# ------------------------------------------------------- device-loss plane

# error text markers that read as a lost or sick device rather than a
# policy/evaluation bug. The JAX package's markers (runtime status codes,
# link failures, and the chaos plane's injected device faults, which embed
# UNAVAILABLE precisely so this classifier treats them like the real
# thing), then CUDA's: the sticky faults that poison the process's CUDA
# context (an illegal address, a device-side assert, an unspecified launch
# failure, an uncorrectable ECC error) and the CUDA APIs' error
# texts. Deliberately conservative: a mis-typed policy raising KeyError
# must NOT trigger an engine rebuild, and an out-of-memory error (the
# context stays usable) is not fatal, as RESOURCE_EXHAUSTED is not in JAX.
_FATAL_MARKERS = (
    "UNAVAILABLE",
    "DATA_LOSS",
    "INTERNAL:",
    "ABORTED",
    "device lost",
    "Device lost",
    "device is in an invalid state",
    "Socket closed",
    "Connection reset",
    "failed to connect",
    "XlaRuntimeError",
    "CUDA error",
    "CUDA driver error",
    "cudaError",
    "device-side assert",
    "illegal memory access",
    "unspecified launch failure",
    "ECC",
)


def _accelerator_error_type():
    """torch.AcceleratorError where this torch has it (a CUDA runtime error
    raised by torch), else None."""
    try:
        import torch
    except ImportError:
        return None
    return getattr(torch, "AcceleratorError", None)


def _out_of_memory_type():
    try:
        import torch
    except ImportError:
        return None
    return getattr(torch.cuda, "OutOfMemoryError", None)


def is_fatal_device_error(exc: BaseException) -> bool:
    """True when the exception reads as a dead or sick device plane: a
    torch.AcceleratorError, or a message carrying one of _FATAL_MARKERS.
    An out-of-memory error is not fatal."""
    if exc is None:
        return False
    oom = _out_of_memory_type()
    if oom is not None and isinstance(exc, oom):
        return False
    acc = _accelerator_error_type()
    if acc is not None and isinstance(exc, acc):
        return True
    s = f"{type(exc).__name__}: {exc}"
    return any(m in s for m in _FATAL_MARKERS)


class DeviceRecovery:
    """Rebuilds a TorchPolicyEngine after a fatal device error (module
    docstring). ``observe(exc)`` is safe to call from any serving path —
    non-fatal errors return False immediately; a fatal one force-opens the
    breaker and kicks ONE background rebuild (concurrent observers
    coalesce). ``rebuild_context`` wraps each rebuild (the webhook passes
    its load serialisation with the collector paused, cli/webhook.py)."""

    def __init__(
        self,
        engine,
        breaker=None,
        name: str = "engine",
        warm_max_batch: Optional[int] = None,
        classifier: Callable[[BaseException], bool] = is_fatal_device_error,
        warm: bool = True,
        cooldown_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        rebuild_context: Callable = contextlib.nullcontext,
    ):
        self.engine = engine
        self.breaker = breaker
        self.name = name
        self.warm_max_batch = warm_max_batch
        self.warm = warm
        # fatal errors arrive in bursts (every in-flight batch on a dead
        # device fails, and on the card a fault surfaces at a later
        # synchronization, in any stage); one rebuild serves the whole
        # burst — without the cooldown each failed half-open probe would
        # kick ANOTHER rebuild
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._classifier = classifier
        self._rebuild_context = rebuild_context
        self._lock = threading.Lock()
        self._rebuilding = False
        self._last_attempt = float("-inf")
        self.rebuilds = 0
        self.failures = 0
        self.last_error: Optional[str] = None
        # the last rebuild's stats (TorchPolicyEngine.rebuild_compiled:
        # generation and seconds by phase)
        self.last_rebuild: Optional[dict] = None

    @property
    def rebuilding(self) -> bool:
        """True while a rebuild is in flight."""
        return self._rebuilding

    def observe(self, exc: BaseException) -> bool:
        """Classify one evaluator exception; True when it was treated as a
        device loss (a rebuild is running, just ran, or was kicked off)."""
        if not self._classifier(exc):
            return False
        with self._lock:
            now = self._clock()
            if self._rebuilding or now - self._last_attempt < self.cooldown_s:
                return True
            self._rebuilding = True
            self._last_attempt = now
        self.last_error = f"{type(exc).__name__}: {exc}"
        log.error(
            "device recovery [%s]: fatal device error observed (%s); "
            "tripping breaker and rebuilding",
            self.name,
            self.last_error,
        )
        if self.breaker is not None:
            # requests answer the posture NOW, not after failure_threshold
            # more broken batches
            self.breaker.force_open()
        threading.Thread(
            target=self._rebuild_main,
            name=f"device-recovery-{self.name}",
            daemon=True,
        ).start()
        return True

    def rebuild_now(self) -> bool:
        """Synchronous rebuild (tests)."""
        with self._lock:
            if self._rebuilding:
                return False
            self._rebuilding = True
        return self._rebuild_main()

    def _rebuild_main(self) -> bool:
        try:
            return self._rebuild()
        finally:
            with self._lock:
                self._rebuilding = False

    def _rebuild(self) -> bool:
        try:
            with self._rebuild_context():
                # re-place the set on the card and, with warm, take every
                # bucket's device paths on it before it is published: the
                # new plane's first-use costs stay off the serving path
                stats = self.engine.rebuild_compiled(
                    max_batch=self.warm_max_batch if self.warm else None
                )
            if not stats:
                log.warning(
                    "device recovery [%s]: nothing to rebuild "
                    "(no compiled set, or a load replaced it)",
                    self.name,
                )
                return False
            self.last_rebuild = stats
            self.rebuilds += 1
            _record_rebuild()
            if self.breaker is not None:
                # re-arm: half-open, so live probes confirm the rebuilt
                # plane before full traffic returns
                self.breaker.half_open_now()
            log.warning(
                "device recovery [%s]: engine rebuilt (%s); breaker half-open",
                self.name,
                stats,
            )
            return True
        except Exception:  # noqa: BLE001 — stay degraded, retry on next fatal
            log.exception(
                "device recovery [%s]: rebuild failed; breaker stays open",
                self.name,
            )
            self.failures += 1
            return False

    def status(self) -> dict:
        return {
            "rebuilds": self.rebuilds,
            "failures": self.failures,
            "rebuilding": self._rebuilding,
            "last_error": self.last_error,
            "last_rebuild": self.last_rebuild,
        }


def _record_rebuild() -> None:
    try:
        from .metrics import record_device_rebuild

        record_device_rebuild()
    except Exception:  # noqa: BLE001 — metrics must never break recovery
        log.debug("device rebuild metric publish failed", exc_info=True)
