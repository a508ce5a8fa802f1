"""Priority-aware admission control: the ingress gate between the HTTP
front end and the batchers (a copy of the JAX package's load/admission.py).

Production webhook traffic is open-loop: a node reconnect storm or a
controller hot loop offers whatever it wants, and a server that accepts
it all converts the excess into queue wait until every request (the
kubelet SARs the cluster's health depends on included) burns its
deadline budget. The controller keeps the damage shaped:

  * **Classification at ingress** (`classify`): kubelet/system SARs are
    ``high`` (shed only at the hard saturation cap), controller and
    admission traffic is ``normal``, and explain requests are
    ``sheddable`` (operator surface, first overboard). Classification is
    a byte scan, with no JSON parse on the hot path. The port serves no
    explain requests, so nothing it serves classifies ``sheddable``.
  * **Graduated load states**: inflight/max_inflight maps to
    ok -> pressure -> overload -> saturated. Sheddable traffic sheds at
    ``pressure``, normal at ``overload``, high only at ``saturated``, and
    ``/readyz`` reports the state so a real apiserver can steer.
  * **Per-client fair share**: under pressure each client (the SAR or
    admission username, parsed only when enforcement is active) must
    pass its own token bucket, so one hot controller cannot starve the
    kubelets sharing the server. The ``client`` metric label is bounded.

Sheds answer honestly: the HTTP layer renders NoOpinion + ``Retry-After``
(authorization) or the configured fail-open/closed review (admission),
and ``cedar_load_shed_total{priority,reason}`` counts every one, so
``offered == admitted + shed`` is exact by construction.

The ``load.shed`` chaos seam fires on every gate verdict; a ``corrupt``
rule forces sheds for storm game days (the ``shed-storm`` scenario).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional, Tuple

from ..chaos.registry import chaos_fire

PRIORITY_HIGH = "high"
PRIORITY_NORMAL = "normal"
PRIORITY_SHEDDABLE = "sheddable"

PRIORITIES = (PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_SHEDDABLE)

# graduated load states, ordered; STATE_CODES backs the cedar_load_state
# gauge (0 is healthy, like the breaker-state encoding)
STATE_OK = "ok"
STATE_PRESSURE = "pressure"
STATE_OVERLOAD = "overload"
STATE_SATURATED = "saturated"
STATE_CODES = {
    STATE_OK: 0, STATE_PRESSURE: 1, STATE_OVERLOAD: 2, STATE_SATURATED: 3,
}

# byte markers identifying system-critical principals in a raw SAR body
# WITHOUT a JSON parse: the kubelet user prefix and the node/control-plane
# identities the cluster's own health depends on. A marker that happens to
# appear inside a resource name over-classifies (strictly safer: high is
# shed LAST); none of these strings occur in normal object names.
_HIGH_MARKERS = (
    b'"system:node:',            # kubelet user name prefix
    b'"system:nodes"',           # kubelet group
    b'"system:kube-scheduler"',
    b'"system:kube-controller-manager"',
    b'"system:apiserver"',
    b'"system:masters"',
)


class RequestShed(Exception):
    """The admission-control plane refused this request. Carries the
    facts the answering layer needs to render an honest shed (priority,
    reason, suggested retry) — and is recognized by the serving path so a
    shed NEVER feeds the device breaker (the breaker watches the device
    plane; a shedder doing its job is not a sick accelerator)."""

    def __init__(
        self,
        message: str = "request shed under overload",
        priority: str = PRIORITY_NORMAL,
        reason: str = "load",
        retry_after_s: float = 1.0,
    ):
        super().__init__(message)
        self.priority = priority
        self.reason = reason
        self.retry_after_s = retry_after_s


def classify(path: str, body: bytes, explain: bool = False) -> str:
    """Priority of one ingress request: ``path`` is the metric path label
    ("authorization" / "admission"), ``body`` the raw wire bytes. Explain
    traffic is an operator surface, not serving traffic -> sheddable.
    Admission reviews are controller/apiserver write-path traffic ->
    normal. Authorization SARs from system-critical principals -> high.

    Policy-decision-point traffic (a body object stamped with a non-empty
    ``protocol``, as the JAX package's mesh front end wraps its bodies) is
    NEVER high: the high tier exists so control-plane health survives
    overload, and the marker byte scan must not let a mesh request that
    happens to contain ``"system:node:`` buy kubelet priority."""
    if explain:
        return PRIORITY_SHEDDABLE
    if getattr(body, "protocol", ""):
        return PRIORITY_NORMAL
    if path == "authorization":
        for marker in _HIGH_MARKERS:
            if marker in body:
                return PRIORITY_HIGH
    return PRIORITY_NORMAL


class _FairBucket:
    """Token bucket with a configurable burst (the chaos TokenBucket is
    burst-1 by reference parity; a fair-share quota needs headroom for a
    client's natural request trains)."""

    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = max(1.0, burst)
        self._tokens = self.burst
        self._last = now

    def allow(self, now: float) -> bool:
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class Shed:
    """One gate refusal (returned by ``AdmissionController.admit``)."""

    __slots__ = ("priority", "reason", "retry_after_s", "client")

    def __init__(
        self,
        priority: str,
        reason: str,
        retry_after_s: float = 1.0,
        client: str = "",
    ):
        self.priority = priority
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.client = client

    def to_exception(self) -> RequestShed:
        return RequestShed(
            f"request shed under overload ({self.reason}); "
            f"retry after {self.retry_after_s:g}s",
            priority=self.priority,
            reason=self.reason,
            retry_after_s=self.retry_after_s,
        )


class AdmissionController:
    """The ingress overload gate (module docstring). Thread-safe; every
    hot-path operation is O(1) under one lock. ``max_inflight`` sizes the
    whole plane: load = tracked in-flight requests / max_inflight."""

    # per-client bucket map cap: beyond this many distinct clients new
    # ones fold into one shared bucket (an adversary minting principals
    # must not grow host memory or dodge the quota)
    CLIENT_CAP = 1024

    def __init__(
        self,
        max_inflight: int = 256,
        shed_sheddable_at: float = 0.5,
        shed_normal_at: float = 0.8,
        client_qps: float = 0.0,
        client_burst: float = 0.0,
        client_enforce_at: float = 0.5,
        retry_after_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_inflight = max(1, int(max_inflight))
        self.shed_sheddable_at = float(shed_sheddable_at)
        self.shed_normal_at = float(shed_normal_at)
        # per-client fair-share quota (tokens/second); 0 disables the
        # bucket check entirely
        self.client_qps = float(client_qps)
        self.client_burst = float(client_burst) or max(
            1.0, self.client_qps / 2
        )
        # quota enforcement only under pressure: an unloaded server never
        # refuses a polite burst, and an idle gate answers byte for byte
        # as no gate does
        self.client_enforce_at = float(client_enforce_at)
        self.retry_after_s = float(retry_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight: dict = {}  # (path, priority) -> count
        self._total_inflight = 0
        self._buckets: dict = {}
        self._overflow_bucket: Optional[_FairBucket] = None
        # honest accounting: offered == admitted + shed, by construction
        self.offered = 0
        self.admitted = 0
        self.shed_total = 0
        self.eval_shed_total = 0
        self._shed_by: dict = {}  # (priority, reason) -> count

    # ------------------------------------------------------------- load state

    def load(self) -> float:
        with self._lock:
            return self._total_inflight / self.max_inflight

    def load_state(self) -> str:
        return self._state_for(self.load())

    def _state_for(self, load: float) -> str:
        if load >= 1.0:
            return STATE_SATURATED
        if load >= self.shed_normal_at:
            return STATE_OVERLOAD
        if load >= self.shed_sheddable_at:
            return STATE_PRESSURE
        return STATE_OK

    # ---------------------------------------------------------------- gating

    def admit(
        self, path: str, body: bytes, explain: bool = False
    ) -> Tuple[str, Optional[Shed]]:
        """Gate one ingress request: returns ``(priority, None)`` when
        admitted or ``(priority, Shed)`` when refused. The caller renders
        the shed answer and MUST NOT evaluate; admitted requests must run
        inside ``track()`` so the load signal sees them."""
        priority = classify(path, body, explain)
        with self._lock:
            load = self._total_inflight / self.max_inflight
        shed: Optional[Shed] = None
        if priority == PRIORITY_SHEDDABLE:
            if load >= self.shed_sheddable_at:
                shed = self._mk_shed(priority, "load_pressure")
        elif priority == PRIORITY_NORMAL:
            if load >= self.shed_normal_at:
                shed = self._mk_shed(priority, "load_overload")
        if shed is None and load >= 1.0:
            # the hard cap protects the process itself: even high-priority
            # traffic sheds rather than queueing past saturation
            shed = self._mk_shed(priority, "saturated")
        if (
            shed is None
            and self.client_qps > 0
            and priority != PRIORITY_HIGH
            and load >= self.client_enforce_at
        ):
            client = self._client_of(path, body)
            if client and not self._client_allow(client):
                shed = self._mk_shed(priority, "client_quota", client=client)
                self._record_client_throttled(client)
        # chaos seam: a `corrupt` rule forces the verdict to a shed (storm
        # game days); disarmed this is one attribute read
        shed = chaos_fire(
            "load.shed",
            shed,
            corrupter=lambda _p: self._mk_shed(priority, "chaos"),
        )
        with self._lock:
            self.offered += 1
            if shed is None:
                self.admitted += 1
            else:
                self.shed_total += 1
                key = (shed.priority, shed.reason)
                self._shed_by[key] = self._shed_by.get(key, 0) + 1
        if shed is not None:
            self._record_shed(shed)
        return priority, shed

    def check_eval(self, priority: str) -> None:
        """The evaluation-stage gate: a request admitted at ingress can
        find the server saturated by the time its (coalesced, cache-missed)
        evaluation is about to submit — shed it NOW rather than letting it
        burn a batcher-queue slot and its whole deadline budget. High
        priority always passes. Raises ``RequestShed``."""
        if priority == PRIORITY_HIGH:
            return
        with self._lock:
            load = self._total_inflight / self.max_inflight
        if load < 1.0:
            return
        shed = self._mk_shed(priority, "eval_saturated")
        with self._lock:
            self.eval_shed_total += 1
            key = (shed.priority, shed.reason)
            self._shed_by[key] = self._shed_by.get(key, 0) + 1
        self._record_shed(shed)
        raise shed.to_exception()

    def _mk_shed(self, priority: str, reason: str, client: str = "") -> Shed:
        return Shed(priority, reason, self.retry_after_s, client)

    # ------------------------------------------------------------- fair share

    def _client_of(self, path: str, body: bytes) -> str:
        """The requesting principal, parsed ONLY when quota enforcement is
        active (the classify() byte scan carries the rest of the gate).
        Unparseable bodies are exempt — the decode-error answer downstream
        is cheaper than any evaluation the quota exists to bound."""
        try:
            doc = json.loads(body)
            if path == "admission":
                req = doc.get("request") or {}
                return (req.get("userInfo") or {}).get("username", "") or ""
            return (doc.get("spec") or {}).get("user", "") or ""
        except Exception:  # noqa: BLE001 — exempt, never crash the gate
            return ""

    def _client_allow(self, client: str) -> bool:
        now = self._clock()
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                if len(self._buckets) >= self.CLIENT_CAP:
                    # bounded client map: late-arriving principals share
                    # one overflow bucket (same posture as the bounded
                    # metric label sets)
                    if self._overflow_bucket is None:
                        self._overflow_bucket = _FairBucket(
                            self.client_qps, self.client_burst, now
                        )
                    bucket = self._overflow_bucket
                else:
                    bucket = self._buckets[client] = _FairBucket(
                        self.client_qps, self.client_burst, now
                    )
            return bucket.allow(now)

    # ----------------------------------------------------------- inflight

    class _Track:
        __slots__ = ("ctrl", "path", "priority")

        def __init__(self, ctrl, path, priority):
            self.ctrl = ctrl
            self.path = path
            self.priority = priority

        def __enter__(self):
            self.ctrl._inflight_add(self.path, self.priority, 1)
            return self

        def __exit__(self, *exc):
            self.ctrl._inflight_add(self.path, self.priority, -1)
            return False

    def track(self, path: str, priority: str) -> "AdmissionController._Track":
        """Context manager wrapping one admitted request end to end — the
        inflight count IS the load signal, so it must cover queue wait and
        evaluation, not just dispatch."""
        return self._Track(self, path, priority)

    def _inflight_add(self, path: str, priority: str, delta: int) -> None:
        with self._lock:
            key = (path, priority)
            n = self._inflight.get(key, 0) + delta
            self._inflight[key] = max(0, n)
            self._total_inflight = max(0, self._total_inflight + delta)
            state = self._state_for(self._total_inflight / self.max_inflight)
            n_now = self._inflight[key]
        self._publish_inflight(path, priority, n_now, state)

    # ------------------------------------------------------------- reporting

    def stats(self) -> dict:
        with self._lock:
            load = self._total_inflight / self.max_inflight
            return {
                "state": self._state_for(load),
                "load": round(load, 4),
                "max_inflight": self.max_inflight,
                "inflight": {
                    f"{p}/{pr}": n
                    for (p, pr), n in sorted(self._inflight.items())
                },
                "offered": self.offered,
                "admitted": self.admitted,
                "shed": self.shed_total,
                "eval_shed": self.eval_shed_total,
                "shed_by": {
                    f"{pr}/{reason}": n
                    for (pr, reason), n in sorted(self._shed_by.items())
                },
                "thresholds": {
                    "sheddable": self.shed_sheddable_at,
                    "normal": self.shed_normal_at,
                    "client_enforce": self.client_enforce_at,
                },
                "client_qps": self.client_qps,
                "clients_tracked": len(self._buckets),
            }

    # --------------------------------------------------------------- metrics

    @staticmethod
    def _record_shed(shed: Shed) -> None:
        try:
            from ..server.metrics import record_load_shed

            record_load_shed(shed.priority, shed.reason)
        except Exception:  # noqa: BLE001 — metrics must never break the gate
            pass

    @staticmethod
    def _record_client_throttled(client: str) -> None:
        try:
            from ..server.metrics import record_client_throttled

            record_client_throttled(client)
        except Exception:  # noqa: BLE001 — metrics must never break the gate
            pass

    @staticmethod
    def _publish_inflight(
        path: str, priority: str, n: int, state: str
    ) -> None:
        try:
            from ..server.metrics import set_inflight, set_load_state

            set_inflight(path, priority, n)
            set_load_state(STATE_CODES[state])
        except Exception:  # noqa: BLE001 — metrics must never break serving
            pass


__all__ = [
    "AdmissionController",
    "PRIORITIES",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_SHEDDABLE",
    "RequestShed",
    "STATE_CODES",
    "STATE_OK",
    "STATE_OVERLOAD",
    "STATE_PRESSURE",
    "STATE_SATURATED",
    "Shed",
    "classify",
]
