"""Shard-scoped composite cache generations (a copy of the JAX package's
cache/generation.py).

The decision cache invalidates by generation equality: an entry whose
stamped generation no longer equals the current composite dies at its
next lookup (decision_cache.py). A single counter that steps on EVERY
swap would let an incremental reload that recompiled one shard kill the
whole cache, so the composite is the serving plane's shard lineage
(engine/evaluator.py PlaneState) instead:

  * ``PlaneGenerations``: the live composite, (structural plane id,
    {shard id: shard generation}). It is what ``current_generation()``
    returns and what un-scopable entries (default denies, NoOpinions,
    reasons that name no policy) are stamped with: any shard change kills
    them.
  * ``ShardScopedStamp``: the stamp of a decision whose reason names its
    determining policies. It records those policies' shards and their
    generations, the request's action and the shard generations of the
    whole plane when it was made. It equals the current composite iff the
    structural id matches, each determining shard still has its recorded
    generation, and no shard that changed since then added a policy that
    can apply to the request's action. So an incremental reload kills
    the entries whose shard changed and the entries a new policy could
    now decide, and every other entry stays warm.

Why the action check, which the JAX package's stamp does not make: a
decision is decided by the policies its reason names (every satisfied
permit of an allow, every satisfied forbid of a deny, all in the
deciding tier). Removing or moving a policy can only change it when the
policy is named, so the determining shards' generations cover that. But
a policy ADDED to any shard can newly match the request: a forbid added
to another shard turns a cached allow into a deny, and a permit added
beside an allow's permits changes its reason. The JAX stamp keeps such
an entry for its TTL (up to 300 s for an allow); here it dies, since the
added policy's action scope (compiler/shard.py policy_actions, kept per
shard step in the plane's ``shard_added``) admits the request's action.
A stamp made without an action (``scoped(reason)`` alone) dies at any
shard change. On a fused multi-tenant plane (tenancy/) the stamp also
records the request's tenant: a policy added to another tenant's shard
(``<tenant>/t<tier>b<bucket>``) carries that tenant's discriminator and
can never match this request, so such a step leaves the entry alive and
a one-tenant edit keeps every other tenant's entries warm. A full compile or a device rebuild changes the structural
id and kills everything, scoped or not. Comparison against plain tuple
composites returns NotImplemented, which Python resolves to "not equal":
mixing stamps can only cause a miss, never a stale hit.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

# the one copy of the helper is obs/audit.py's (the audit lines read the
# same ids); the module keeps its former private name for its callers
from ..compiler.shard import shard_tenant
from ..obs.audit import determining_policies as _determining_policies

__all__ = [
    "PlaneGenerations",
    "ShardScopedStamp",
    "plane_composite",
    "plane_wire_state",
]


class PlaneGenerations:
    """The live composite generation of an engine-served path.

    ``shards``, ``lookup`` and ``added`` are references to the serving
    PlaneState's dicts (``shard_gens``, ``policy_shard``,
    ``shard_added``), which are never mutated once published:
    construction copies nothing, and the ``is`` fast paths in the
    comparisons make steady-state lookups O(1)."""

    __slots__ = ("base", "shards", "lookup", "added")

    def __init__(
        self,
        base: tuple,
        shards: Mapping[str, int],
        lookup: Optional[Mapping[str, str]] = None,
        added: Optional[Mapping[str, tuple]] = None,
    ):
        self.base = base
        self.shards = shards
        self.lookup = lookup
        self.added = added

    def __repr__(self) -> str:
        return f"PlaneGenerations(base={self.base!r}, shards={len(self.shards)})"

    def __eq__(self, other):
        if isinstance(other, PlaneGenerations):
            return self.base == other.base and (
                self.shards is other.shards or self.shards == other.shards
            )
        if isinstance(other, ShardScopedStamp):
            return other.__eq__(self)
        return NotImplemented

    def __ne__(self, other):
        r = self.__eq__(other)
        return NotImplemented if r is NotImplemented else not r

    def scoped(self, reason: str, tenant: str = "", action: Optional[str] = None):
        """The stamp for a decision with the given rendered reason: scoped
        to the determining policies' shards when every one of them
        resolves, else this full composite. ``action`` is the request's
        action uid as it renders (``k8s::Action::"get"``): with it the
        stamp survives changes of other shards that add no policy for
        that action; without it, any shard change kills it. Called once
        per cache insert, so the parse rides the miss path, never a hit.
        On a plane that keys policies per tenant (``<tenant>/<pid>``) pass
        the request's ``tenant``."""
        if not self.lookup or not reason:
            return self
        pols = _determining_policies(reason)
        if not pols:
            return self
        shards = set()
        for pid in pols:
            sid = None
            if tenant:
                sid = self.lookup.get(f"{tenant}/{pid}")
            if sid is None:
                sid = self.lookup.get(pid)
            if sid is None:
                return self  # unknown or ambiguous policy: the full stamp
            shards.add(sid)
        return ShardScopedStamp(
            self.base,
            tuple(sorted((sid, self.shards.get(sid)) for sid in shards)),
            action=action,
            seen=self.shards,
            tenant=tenant,
        )


class ShardScopedStamp:
    """A cache entry's generation stamp scoped to its determining shards
    and its request's action (module docstring). ``seen`` is the plane's
    shard generations the stamp was last found valid against: advanced
    on each successful comparison, so a stamp checks a plane's changes
    once. ``tenant`` is the request's tenant on a fused plane ("" else):
    policies added to other tenants' shards are skipped."""

    __slots__ = ("base", "shard_gens", "action", "seen", "tenant")

    def __init__(self, base: tuple, shard_gens: Tuple[Tuple[str, int], ...],
                 action: Optional[str] = None, seen: Optional[Mapping[str, int]] = None,
                 tenant: str = ""):
        self.base = base
        self.shard_gens = shard_gens
        self.action = action
        self.seen = seen
        self.tenant = tenant

    def __repr__(self) -> str:
        return (f"ShardScopedStamp(base={self.base!r}, shards={self.shard_gens!r}, "
                f"action={self.action!r}, tenant={self.tenant!r})")

    def __eq__(self, other):
        if isinstance(other, PlaneGenerations):
            if self.base != other.base or not all(
                other.shards.get(sid) == gen for sid, gen in self.shard_gens
            ):
                return False
            if self.seen is other.shards:
                return True
            if not self._untouched_since(other):
                return False
            self.seen = other.shards  # a benign race: both writers are right
            return True
        if isinstance(other, ShardScopedStamp):
            return (self.base == other.base and self.shard_gens == other.shard_gens
                    and self.action == other.action and self.tenant == other.tenant)
        return NotImplemented

    def _untouched_since(self, plane: PlaneGenerations) -> bool:
        """True when no shard step of ``plane`` after ``seen`` added a
        policy that can apply to this stamp's action. A removed shard
        needs no check: a policy it held that decided this request is
        named in the reason, and its shard is a determining one. Nor does
        a shard of another tenant than the stamp's: its policies carry
        that tenant's discriminator."""
        if self.action is None or self.seen is None or plane.added is None:
            return False
        for sid, gen in plane.shards.items():
            before = self.seen.get(sid)
            if before == gen:
                continue
            if self.tenant:
                owner = shard_tenant(sid)
                if owner is not None and owner != self.tenant:
                    continue
            history = plane.added.get(sid)
            if not history:
                return False
            # a history the plane trimmed starts with an unbounded step,
            # so steps it dropped still kill an older stamp
            for step, actions in history:
                if before is not None and step <= before:
                    continue
                if actions is None or self.action in actions:
                    return False
        return True

    def __ne__(self, other):
        r = self.__eq__(other)
        return NotImplemented if r is NotImplemented else not r


def plane_wire_state(target):
    """Content-derived projection of ``target``'s serving plane lineage,
    safe to compare across processes.

    ``PlaneGenerations`` values are process-local: structural ids and
    shard generations come from per-process counters, so two processes
    serving the byte-identical policy set expose different composites.
    The wire state projects the plane onto what determines served
    answers: the per-shard CONTENT hashes (identical wherever the same
    corpus compiled, compiler/shard.py) plus the serving partition (the
    port serves none: ``partition`` reads as empty, the JAX token of
    ``partition=None``). Returns ``{"token": <sha256>, "shards": {sid:
    hash}}``, or None when the target has no shard lineage.

    ``target`` is an engine, or anything exposing ``template_engine`` or
    a ``compiled_set`` with a PlaneState."""
    import hashlib

    engine = getattr(target, "template_engine", target)
    cs = getattr(engine, "compiled_set", None)
    pl = getattr(cs, "plane", None) if cs is not None else None
    if pl is None or not pl.shard_hashes:
        return None
    h = hashlib.sha256()
    for sid in sorted(pl.shard_hashes):
        h.update(sid.encode())
        h.update(b":")
        h.update(pl.shard_hashes[sid].encode())
        h.update(b"\x00")
    h.update(f"partition={getattr(pl, 'partition', None) or ''}".encode())
    return {"token": h.hexdigest(), "shards": dict(pl.shard_hashes)}


def plane_composite(stores, target):
    """The generation_fn body for engine-served paths (cli/webhook.py):
    ``target`` is the engine serving the decisions. A plane with shard
    lineage yields a PlaneGenerations (scoped invalidation; the stores'
    content generations are deliberately NOT folded in: the cache tracks
    the SERVING set, which lags store content by up to a reloader tick
    exactly as the served answers do); anything else falls back to the
    kill-all composite of the stores' and the target's generations."""
    pg = getattr(target, "plane_generation", None)
    if pg is not None:
        gen = pg()
        if isinstance(gen, PlaneGenerations):
            return gen
        return (stores.cache_generation(), gen)
    if hasattr(target, "cache_epoch"):
        return (stores.cache_generation(), target.cache_epoch())
    return (stores.cache_generation(), getattr(target, "load_generation", None))
