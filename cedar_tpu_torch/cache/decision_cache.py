"""Sharded, memory-bounded LRU+TTL decision cache with split TTLs per
decision class and generation-based invalidation (a copy of the JAX
package's cache/decision_cache.py).

The webhook-side analogue of kube-apiserver's authorization-webhook
allow/deny caches (``--authorization-webhook-cache-authorized-ttl`` /
``-unauthorized-ttl``): apiserver traffic is repetitive (kubelets,
controllers and informers re-issue identical SARs for minutes), and
Cedar's deterministic evaluation makes those decisions safely cacheable
keyed on (canonical request fingerprint, policy-set generation).

  * **Sharded.** Keys hash onto N independent shards, each with its own
    lock and LRU list, so request threads do not serialize on one mutex.
    Capacity is enforced per shard (max_entries / shards), which bounds
    total memory exactly.
  * **Split TTLs.** Allows, denies and no-opinions age independently,
    mirroring kube-apiserver's asymmetric authorized/unauthorized TTLs:
    a revoked permission should stop being served from cache much faster
    than a steady-state allow. A class TTL of 0 disables caching for that
    class.
  * **Generation invalidation, not scans.** Every entry records the
    generation it was computed under (``generation_fn``: the serving
    plane's shard lineage for the engines, cache/generation.py, or the
    stores' content generations). A reload changes it, so every stale
    entry dies lazily at its next lookup: no scan, no reload-time pause.

The ``cache.get`` and ``cache.put`` chaos seams (chaos/registry.py) fire
at the top of get() and put(); the serving paths treat a raising cache as
a miss.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Optional

from ..chaos.registry import chaos_fire

log = logging.getLogger(__name__)

# decision classes: string values match server/authorizer.py DECISION_*
CLASS_ALLOW = "allow"
CLASS_DENY = "deny"
CLASS_NO_OPINION = "no_opinion"

DEFAULT_SHARDS = 8

# sentinel distinguishing "no generation passed" from an explicit None
# (generation_fn=None caches legitimately stamp None)
_UNSET = object()


class _Entry:
    __slots__ = ("value", "decision_class", "expires_at", "generation")

    def __init__(self, value, decision_class, expires_at, generation):
        self.value = value
        self.decision_class = decision_class
        self.expires_at = expires_at
        self.generation = generation


class _Shard:
    # hit/miss/eviction tallies live per shard, mutated under the shard
    # lock the operation already holds: a global stats mutex would
    # re-serialize exactly the lookups the sharding de-serializes
    __slots__ = ("lock", "entries", "hits", "misses", "evictions")

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0


def _record(fn_name: str, *args, **kwargs) -> None:
    """Metrics are best-effort: a metrics failure must never break a
    decision. The lazy import keeps the cache importable without the
    server."""
    try:
        from ..server import metrics

        getattr(metrics, fn_name)(*args, **kwargs)
    except Exception:  # noqa: BLE001
        log.debug("cache metrics publish failed", exc_info=True)


class DecisionCache:
    """Thread-safe decision cache; values are opaque to the cache (the
    authorization path stores ``(decision, reason)`` tuples, the admission
    path ``(allowed, message)``)."""

    def __init__(
        self,
        max_entries: int = 65536,
        allow_ttl_s: float = 300.0,
        deny_ttl_s: float = 30.0,
        no_opinion_ttl_s: float = 5.0,
        shards: int = DEFAULT_SHARDS,
        generation_fn: Optional[Callable[[], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        path: str = "authorization",
    ):
        self.max_entries = max(1, int(max_entries))
        self.n_shards = max(1, min(int(shards), self.max_entries))
        self.per_shard = max(1, self.max_entries // self.n_shards)
        self._ttls = {
            CLASS_ALLOW: float(allow_ttl_s),
            CLASS_DENY: float(deny_ttl_s),
            CLASS_NO_OPINION: float(no_opinion_ttl_s),
        }
        self._generation_fn = generation_fn
        self._clock = clock
        self.path = path
        self._shards = [_Shard() for _ in range(self.n_shards)]
        # lock-free lookup tick for the gauges' cadence: the increment
        # races benignly (a missed tick only delays a gauge refresh)
        self._op_tick = 0

    # gauge refresh cadence: hit ratio and size are O(shards) scans plus
    # registry locks, so they publish every Nth lookup (and from stats()),
    # not on every operation
    GAUGE_EVERY = 64

    # --------------------------------------------------------------- internals

    def _shard_for(self, key: str) -> _Shard:
        return self._shards[hash(key) % self.n_shards]

    def _generation(self):
        if self._generation_fn is None:
            return None
        try:
            return self._generation_fn()
        except Exception:  # noqa: BLE001 — fail safe: treat as a fresh gen
            log.exception("cache generation_fn failed; entry treated stale")
            return object()  # equal to nothing: every lookup misses

    def _tick_gauges(self) -> None:
        self._op_tick += 1
        if self._op_tick % self.GAUGE_EVERY == 0:
            self._publish_gauges()

    def _publish_gauges(self) -> None:
        hits = sum(s.hits for s in self._shards)
        misses = sum(s.misses for s in self._shards)
        if hits + misses:
            _record("set_cache_hit_ratio", self.path, hits / (hits + misses))
        _record("set_cache_size", self.path, self.size())

    # ----------------------------------------------------------------- surface

    def ttl_for(self, decision_class: str) -> float:
        """TTL for a decision class; unknown classes get the (shortest,
        most conservative) no-opinion TTL."""
        return self._ttls.get(decision_class, self._ttls[CLASS_NO_OPINION])

    def current_generation(self):
        """The generation a decision evaluated NOW would be computed
        under. Callers snapshot this BEFORE evaluating and hand it to
        put(): a reload landing mid-evaluation then leaves the entry
        stamped with the pre-reload generation, so it dies at its first
        post-reload lookup instead of surviving under the new generation
        for its full TTL."""
        return self._generation()

    def get(self, key: str):
        """Cached value for ``key``, or None. Expired and stale-generation
        entries are deleted on sight and count as misses. The ``cache.get``
        chaos seam can raise or stall here; the serving paths treat a
        raising lookup as a miss."""
        chaos_fire("cache.get")
        gen = self._generation()
        now = self._clock()
        shard = self._shard_for(key)
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is not None:
                if entry.generation != gen:
                    del shard.entries[key]
                    shard.evictions += 1
                    entry, reason = None, "generation"
                elif now >= entry.expires_at:
                    del shard.entries[key]
                    shard.evictions += 1
                    entry, reason = None, "ttl"
                else:
                    shard.entries.move_to_end(key)
                    value = entry.value
            else:
                reason = None
            if entry is not None:
                shard.hits += 1
            else:
                shard.misses += 1
        if entry is not None:
            _record("record_cache_hit", self.path)
            self._tick_gauges()
            return value
        if reason is not None:
            _record("record_cache_evictions", self.path, reason, 1)
        _record("record_cache_miss", self.path)
        self._tick_gauges()
        return None

    def put(
        self,
        key: str,
        value,
        decision_class: str,
        generation=_UNSET,
        ttl_s: Optional[float] = None,
    ) -> bool:
        """Insert ``value``; returns False when the class TTL disables
        caching. LRU-evicts within the key's shard past capacity.

        ``generation`` should be the current_generation() snapshot taken
        BEFORE the decision was evaluated; when omitted it is resolved at
        insert time, which is only safe for values not derived from the
        policy set.

        ``ttl_s`` CAPS the class TTL (never extends it): an entry received
        from elsewhere carries its origin's remaining lifetime, so copying
        it cannot restart the staleness clock."""
        chaos_fire("cache.put")
        ttl = self.ttl_for(decision_class)
        if ttl_s is not None:
            ttl = min(ttl, float(ttl_s))
        if ttl <= 0:
            return False
        if generation is _UNSET:
            generation = self._generation()
        entry = _Entry(value, decision_class, self._clock() + ttl, generation)
        shard = self._shard_for(key)
        evicted = 0
        with shard.lock:
            shard.entries[key] = entry
            shard.entries.move_to_end(key)
            while len(shard.entries) > self.per_shard:
                shard.entries.popitem(last=False)
                evicted += 1
            shard.evictions += evicted
        if evicted:
            _record("record_cache_evictions", self.path, "lru", evicted)
        return True

    def peer_lookup(self, key: str):
        """Read an entry for serving it to a peer: ``(value,
        decision_class, stamp, ttl_left_s)`` when the entry is fresh by
        THIS cache's own generation and TTL rules, else None. Unlike get()
        this never mutates hit/miss tallies or LRU order (a peer's miss is
        not this cache's traffic) and never deletes: a stale entry is not
        served, and dies at its own next local lookup."""
        gen = self._generation()
        now = self._clock()
        shard = self._shard_for(key)
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is None:
                return None
            if entry.generation != gen or now >= entry.expires_at:
                return None
            return (
                entry.value,
                entry.decision_class,
                entry.generation,
                entry.expires_at - now,
            )

    def invalidate_all(self) -> int:
        """Drop every entry (an operator escape hatch, and tests); returns
        the number removed. Serving invalidation is generation-based and
        needs no call here."""
        n = 0
        for shard in self._shards:
            with shard.lock:
                n += len(shard.entries)
                shard.evictions += len(shard.entries)
                shard.entries.clear()
        _record("record_cache_evictions", self.path, "flush", n)
        _record("set_cache_size", self.path, 0)
        return n

    def size(self) -> int:
        # len() per shard without locks: an approximate momentary size is
        # fine for a gauge and avoids N lock hops on the hot path
        return sum(len(s.entries) for s in self._shards)

    def stats(self) -> dict:
        """Snapshot for the /debug/cache endpoint (also refreshes the
        size and hit-ratio gauges)."""
        hits = sum(s.hits for s in self._shards)
        misses = sum(s.misses for s in self._shards)
        evictions = sum(s.evictions for s in self._shards)
        lookups = hits + misses
        self._publish_gauges()
        return {
            "path": self.path,
            "size": self.size(),
            "max_entries": self.max_entries,
            "shards": self.n_shards,
            "hits": hits,
            "misses": misses,
            "evictions": evictions,
            "hit_ratio": (hits / lookups) if lookups else 0.0,
            "ttl_seconds": dict(self._ttls),
            "generation": repr(self._generation()),
        }


def classify_decision(decision: str) -> str:
    """Authorization decision string -> cache class (the identity today;
    kept as the one seam if the decision vocabularies ever diverge)."""
    if decision in (CLASS_ALLOW, CLASS_DENY, CLASS_NO_OPINION):
        return decision
    return CLASS_NO_OPINION
