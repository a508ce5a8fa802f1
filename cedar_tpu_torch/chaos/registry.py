"""Fault-injection seam registry: one config surface for the failure
modes of the serving stack (a copy of the JAX package's chaos/registry.py).

Serving layers expose *named seams* as `chaos_fire(seam)` calls. The
catalogue ``SEAMS`` is the JAX package's whole catalogue, so a scenario
file written for the JAX server validates here unchanged; the seams on
the port's paths fire:

  * ``store.load`` (directory store re-read),
  * ``store.crd.relist`` / ``store.crd.object`` (the CRD store's list and
    its per-object parse),
  * ``cache.get`` / ``cache.put`` (the decision cache's lookup and
    insert, cache/decision_cache.py; the serving paths treat a raising
    cache as a miss),
  * ``engine.shard_compile`` (each dirty shard's lowering),
  * ``engine.encode`` / ``engine.dispatch`` / ``engine.decode`` (the fast
    paths' stages; ``engine.dispatch`` also on the evaluator's own launch
    path, engine/evaluator.py evaluate_batch),
  * ``pipeline.collect`` / ``pipeline.dispatch_q`` / ``pipeline.decode_q``
    (the batchers' worker loops, outside the per-batch containment),
  * ``response`` (the final (decision, reason, error) of /v1/authorize),
  * ``load.shed`` (the overload-control gate's verdict, load/admission.py),
  * ``shadow.offer`` / ``shadow.process`` (the shadow evaluator's offer
    hook and its worker's batches, rollout/shadow.py),
  * ``rollout.stage`` / ``rollout.promote`` (rollout/controller.py),
  * ``lifecycle.gate`` / ``lifecycle.canary`` / ``lifecycle.journal``
    (each gate's evidence check, the embedded canary router's candidate
    evaluation and every journal append, lifecycle/).

The others (fleet, fanout, the peer cache) belong to modules the port does
not have: configuring them is valid and injects nothing.

With the registry disarmed (the production state) a fire is one module
attribute read and a returned payload: no locks, no clock reads, no
allocation, and live responses are byte-identical to a build without the
plane. Armed, each configured seam applies its scenario rules in order:

  * ``error``    — raise ChaosError (a wedged/raising dependency)
  * ``latency``  — sleep ``delay_s`` (a stalled store / slow device)
  * ``corrupt``  — transform the payload (a poison policy object)
  * ``kill``     — raise ThreadKilled, a BaseException that sails past
                   the per-batch ``except Exception`` containment and
                   unwinds the worker thread (a stage death)
  * ``response_error`` / ``response_deny`` — the reference
    error-injector's artificial NoOpinion/Deny swaps on the ``response``
    seam's (decision, reason, error) payload

Rule scheduling is deterministic: ``after``/``count`` schedule by the
seam's call index, ``probability`` draws from the scenario's seeded PRNG,
and ``rate`` uses the reference's burst-1 token bucket — no wall-clock
randomness anywhere, so a scenario replays identically.

Injections count into ``cedar_chaos_injections_total{seam,kind}``
(server/metrics.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class ChaosError(RuntimeError):
    """An injected dependency failure."""


class ThreadKilled(BaseException):
    """An injected thread death. Deliberately NOT an Exception: the worker
    loops contain per-batch ``except Exception`` (and the batcher's
    per-batch ``except BaseException`` guards sit *inside* the loop, after
    the seam fire points), so this unwinds the whole thread exactly like a
    C-extension crash or interpreter teardown would."""


class TokenBucket:
    """Token bucket: ``rate`` tokens/second, burst 1 (golang.org/x/time/rate
    semantics as used by the reference error injector with burst=1): the
    limiter of rate-scheduled scenario rules."""

    def __init__(self, rate: float, now=time.monotonic):
        self.rate = rate
        self._now = now
        self._tokens = 1.0 if rate > 0 else 0.0
        self._last = now()
        self._lock = threading.Lock()

    def allow(self) -> bool:
        if self.rate <= 0:
            return False
        with self._lock:
            now = self._now()
            self._tokens = min(1.0, self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


# seam catalogue: name -> where it fires in the JAX package (module
# docstring: which of them fire in the port). configure() rejects unknown
# names so a typo'd scenario fails loudly instead of silently injecting
# nothing.
SEAMS = {
    "store.load": "directory store load_policies / reloader tier fetch",
    "store.crd.relist": "CRD store list + watch-reconnect relist",
    "store.crd.object": "per-CRD-object policy text parse (corruptible)",
    "cache.get": "decision cache lookup",
    "cache.put": "decision cache insert",
    "engine.encode": "native/host batch encode (fastpath._encode_chunk)",
    "engine.dispatch": "device batch launch (fastpath + evaluator paths)",
    "engine.shard_compile": "per-dirty-shard lowering inside the "
    "incremental compiler (compiler/shard.py ShardCompiler.compile)",
    "engine.decode": "device readback + verdict decode",
    "pipeline.collect": "batcher worker loop after claiming a batch",
    "pipeline.dispatch_q": "pipeline dispatch stage after queue get",
    "pipeline.decode_q": "pipeline decode stage after queue get",
    "shadow.offer": "shadow-evaluation offer hook (live request side)",
    "shadow.process": "shadow worker batch processing",
    "rollout.stage": "rollout candidate staging",
    "rollout.promote": "rollout promotion",
    "fleet.route": "fleet router replica selection (request thread)",
    "fleet.hedge": "hedged-dispatch fire point (lone-request tail hedge)",
    "fleet.replica_dispatch": "replica batcher worker loop after claiming "
    "a batch (kill = one replica lost)",
    "fleet.promote": "per-replica compiled-set swap inside the fleet "
    "promotion barrier",
    "fanout.route": "front-end worker selection (cedar_tpu/fanout): fired "
    "with the chosen worker id before the request is handed over",
    "fanout.worker_kill": "inside a fanout worker's request handling "
    "(kill = that worker process lost; the front-end rehashes around it)",
    "fanout.swap": "per-worker compiled-set swap inside the cross-process "
    "generation barrier (frontend.load / promote)",
    "cache.peer_fetch": "peer decision-cache traffic (fetch AND gossip "
    "delivery) between fanout workers",
    "load.shed": "admission-control gate verdict (cedar_tpu/load): a "
    "`corrupt` rule forces the verdict to a shed — storm game days prove "
    "the shed answer path and the breaker's indifference to it",
    "lifecycle.gate": "lifecycle gate evaluation (cedar_tpu/lifecycle): "
    "fired before each verify/shadow/canary evidence check — `error` "
    "rules exercise the transient-retry path, `kill` a controller crash "
    "at a stage boundary",
    "lifecycle.canary": "per-request canary-slice candidate evaluation "
    "inside the lifecycle canary router — an `error` rule makes the "
    "canary slice burn its SLO budget (the lifecycle-breach game day)",
    "lifecycle.journal": "lifecycle journal append (crash-point seam: "
    "`kill` = controller dies mid-transition; resume must replay)",
    "response": "final (decision, reason, error) swap (reference parity)",
}

RESPONSE_SEAM = "response"

_KINDS = (
    "error", "latency", "corrupt", "kill", "response_error", "response_deny",
)


class InjectionRule:
    """One scheduled fault on one seam (see module docstring for kinds).

    Scheduling fields (all optional, ANDed):
      after        skip the first N eligible calls of the seam
      count        fire at most N times (None = unlimited)
      probability  fire with this chance per call (seeded PRNG)
      rate         token-bucket fires/second (reference limiter semantics)
    """

    def __init__(
        self,
        kind: str,
        after: int = 0,
        count: Optional[int] = None,
        probability: Optional[float] = None,
        rate: Optional[float] = None,
        delay_s: float = 0.0,
        message: str = "",
        replacement: Optional[str] = None,
        now=time.monotonic,
    ):
        if kind not in _KINDS:
            raise ValueError(f"unknown chaos rule kind {kind!r}")
        self.kind = kind
        self.after = max(0, int(after))
        self.count = None if count is None else max(0, int(count))
        self.probability = probability
        self.delay_s = float(delay_s)
        self.message = message or f"injected {kind}"
        self.replacement = replacement
        self.fired = 0
        self._limiter = None if rate is None else TokenBucket(rate, now)

    def should_fire(self, call_index: int, rng) -> bool:
        if call_index < self.after:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.probability is not None and rng.random() >= self.probability:
            return False
        if self._limiter is not None and not self._limiter.allow():
            return False
        self.fired += 1
        return True

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "after": self.after,
            "count": self.count,
            "probability": self.probability,
            "delay_s": self.delay_s,
            "fired": self.fired,
        }


def _default_corrupt(payload, rule: InjectionRule):
    """Generic payload corruption when the fire site supplies no
    corrupter: strings/bytes are replaced with (or poisoned by) the rule's
    replacement text — enough to turn a policy document into a parse
    failure, which is what poison-object scenarios want."""
    poison = rule.replacement if rule.replacement is not None else (
        "%% chaos-injected corruption %%"
    )
    if isinstance(payload, str):
        return poison
    if isinstance(payload, (bytes, bytearray)):
        return poison.encode()
    return payload


class Seam:
    """One named injection point and its configured rules. A Seam may be
    owned by the shared registry (scenario-driven) or held privately (the
    ErrorInjector's reference-parity ``response`` seam)."""

    def __init__(self, name: str, sleep=time.sleep):
        self.name = name
        self.rules: list = []
        self.calls = 0
        self._sleep = sleep
        self._lock = threading.Lock()

    def add_rule(self, rule: InjectionRule) -> None:
        self.rules.append(rule)

    def fire(self, payload=None, corrupter=None, rng=None, on_fire=None):
        """Apply this seam's rules to one call; returns the (possibly
        transformed) payload or raises the injected failure."""
        with self._lock:
            idx = self.calls
            self.calls += 1
        for rule in self.rules:
            with self._lock:
                hit = rule.should_fire(idx, rng)
            if not hit:
                continue
            if on_fire is not None:
                on_fire(self.name, rule.kind)
            if rule.kind == "latency":
                self._sleep(rule.delay_s)
            elif rule.kind == "corrupt":
                if corrupter is not None:
                    payload = corrupter(payload)
                else:
                    payload = _default_corrupt(payload, rule)
            elif rule.kind == "kill":
                raise ThreadKilled(f"{self.name}: {rule.message}")
            elif rule.kind == "error":
                raise ChaosError(f"{self.name}: {rule.message}")
            elif rule.kind == "response_error":
                payload = ("no_opinion", "", "encountered error")
            elif rule.kind == "response_deny":
                payload = ("deny", "Authorization denied", None)
        return payload

    def stats(self) -> dict:
        return {
            "calls": self.calls,
            "rules": [r.to_dict() for r in self.rules],
        }


class ChaosRegistry:
    """The scenario-driven seam registry. One module-level default instance
    backs the `chaos_fire` helper the instrumentation sites call; the
    server's /chaos/* endpoints, --chaos-scenario and tests configure, arm
    and disarm it.

    `armed` is read lock-free on the hot path: arming takes effect at the
    next fire, which is all a game-day needs."""

    def __init__(self):
        self._seams: dict = {}
        self._lock = threading.Lock()
        self.armed = False
        self.scenario_name = ""
        self._rng = __import__("random").Random(0)

    # ------------------------------------------------------------- lifecycle

    def configure(self, scenario: dict) -> None:
        """Install a scenario: {"name": ..., "seed": int, "faults":
        [{"seam": ..., "kind": ..., ...rule fields}]}. Replaces any prior
        configuration; does NOT arm. Unknown seam names or rule kinds are
        rejected outright — a typo must not silently inject nothing."""
        import random

        faults = scenario.get("faults") or []
        seams: dict = {}
        for f in faults:
            name = f.get("seam", "")
            if name not in SEAMS:
                raise ValueError(
                    f"unknown chaos seam {name!r}; known: {sorted(SEAMS)}"
                )
            rule = InjectionRule(
                kind=f.get("kind", ""),
                after=f.get("after", 0),
                count=f.get("count"),
                probability=f.get("probability"),
                rate=f.get("rate"),
                delay_s=f.get("delay_s", 0.0),
                message=f.get("message", ""),
                replacement=f.get("replacement"),
            )
            seams.setdefault(name, Seam(name)).add_rule(rule)
        with self._lock:
            self._seams = seams
            self.scenario_name = scenario.get("name", "")
            self._rng = random.Random(int(scenario.get("seed", 0)))

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def reset(self) -> None:
        """Disarm and drop the configured scenario + all counters."""
        with self._lock:
            self.armed = False
            self._seams = {}
            self.scenario_name = ""

    # --------------------------------------------------------------- firing

    def fire(self, name: str, payload=None, corrupter=None):
        """Hot-path entry: with no armed scenario (or no rules on this
        seam) the payload passes straight through."""
        if not self.armed:
            return payload
        seam = self._seams.get(name)
        if seam is None:
            return payload
        return seam.fire(
            payload, corrupter=corrupter, rng=self._rng,
            on_fire=_record_injection,
        )

    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": self.armed,
                "scenario": self.scenario_name,
                "seams": {n: s.stats() for n, s in self._seams.items()},
            }


def _record_injection(seam: str, kind: str) -> None:
    try:
        from ..server.metrics import record_chaos_injection

        record_chaos_injection(seam, kind)
    except Exception:  # noqa: BLE001 — metrics must never break injection
        log.debug("chaos injection metric publish failed", exc_info=True)


_default = ChaosRegistry()


def default_registry() -> ChaosRegistry:
    return _default


def chaos_fire(name: str, payload=None, corrupter=None):
    """The instrumentation-site helper. Disarmed (the production state)
    this is one attribute read and a return — behavior and bytes identical
    to not having the plane at all."""
    if not _default.armed:
        return payload
    return _default.fire(name, payload, corrupter=corrupter)
