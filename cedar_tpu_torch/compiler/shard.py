"""Shard-granular incremental compilation: lower only what changed.

The JAX package's compiler/shard.py. A full recompile of a large corpus
turns every CRD edit into seconds of compile beside serving. The Cedar
paper keeps policies independently analyzable slices — this module makes
them independently COMPILABLE slices:

  * policies partition into **(tier, bucket) shards**, bucket =
    blake2b(filename | policy_id) % n_buckets — keyed on identity, not
    content, so an edited policy stays in its bucket and dirties exactly
    one shard;
  * each shard carries a **content hash** (sha256 over its member
    policies' cached canonical fingerprints, in order — position
    included, since served Reason diagnostics carry source positions);
  * a reload **diffs old-vs-new shard hashes** and re-lowers ONLY the
    dirty shards (lowering is the per-policy dominant compile cost); the
    fused ``CompiledPolicies`` reassembles from cached per-shard slices,
    so ``pack()`` + device placement cost is bounded by RESIDENT rules,
    never total corpus size;
  * with a ``PartitionSpec`` (analysis/partition.py) each shard's
    never-matching policies are pruned at lower time — quick AST check
    before lowering (bounds the 100k first load), exact clause-level
    check after — and stay host-side in the shard cache, paging back in
    when the spec changes (the spec token is part of the reuse key).

The cache commit is transactional, and later than in the JAX package:
``compile()`` never replaces the shard map. It returns the fresh map in
its info (``info["commit"]``), and the engine hands it to ``commit()``
only once the plane built from it has been placed, warmed and published
(engine/evaluator.py). A lowering failure (or a chaos
``engine.shard_compile`` injection), and equally a placement, warm-up or
load-hook failure after the compile, leaves the previous shard map
untouched: it stays the map of the plane that serves, so the next reload
diffs against what serves and sees the correct dirty set.

The port serves no partition spec yet (``set_partition`` stays for the
JAX interface; the engine never calls it), so nothing is pruned.

Policy fingerprints memoize on the Policy object itself (stores swap
objects only when content changes — the CRD store reparses exactly the
changed object), so a steady-state 100k-corpus hash pass is a dict-lookup
scan, not a reformat of the corpus.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from ..chaos.registry import chaos_fire
from ..lang.ast import Policy
from ..schema.consts import ADMISSION_ACTION_ALL, ADMISSION_ACTION_ENTITY_TYPE
from .ir import CompiledPolicies, FallbackPolicy, LoweredPolicy, Unlowerable
from .lower import AUTHZ_SCHEMA_INFO, SchemaInfo, lower_policy

DEFAULT_SHARD_BUCKETS = 64

# see ShardCompiler.compile: position stamps are epoch-tagged so stamps
# from another compiler's scan of the same Policy objects read as stale
_scan_epochs = itertools.count(1)

__all__ = [
    "DEFAULT_SHARD_BUCKETS",
    "CompiledShard",
    "ShardCompiler",
    "bucket_hash_count",
    "policy_actions",
    "policy_fingerprint",
    "policy_semantics",
    "shard_bucket",
    "shard_tenant",
]

# fresh blake2b bucket computations (cache misses of the per-object memo
# below) — with the shard-bucket memo working, a steady-state reload over
# store-reused Policy objects recomputes buckets ONLY for re-parsed
# (edited) objects; the perf-hardening test pins that
_bucket_hashes = 0


def bucket_hash_count() -> int:
    return _bucket_hashes


def policy_fingerprint(policy: Policy) -> str:
    """Canonical per-policy content fingerprint, memoized on the object.

    Position is deliberately INCLUDED: two textually identical policies at
    different source positions serve different Reason diagnostics, so a
    cached lowered slice keyed without position would serve stale
    positions after a reload that only moved policies around."""
    fp = policy.__dict__.get("_cedar_content_fp")
    if fp is None:
        from ..lang.format import format_policy

        h = hashlib.sha256()
        h.update(policy.filename.encode())
        h.update(b"\x00")
        h.update(policy.policy_id.encode())
        h.update(b"\x00")
        h.update(repr(policy.position).encode())
        h.update(b"\x00")
        text = format_policy(policy)
        h.update(text.encode())
        fp = h.hexdigest()
        policy.__dict__["_cedar_content_fp"] = fp
        policy.__dict__.setdefault(
            "_cedar_semantic_fp", hashlib.sha256(text.encode()).hexdigest())
    return fp


def policy_semantics(policy: Policy) -> str:
    """Fingerprint of what a policy decides, memoized on the object: its
    effect, scope, conditions and annotations, WITHOUT its id, file and
    position. Two policies with equal semantics match the same
    requests."""
    fp = policy.__dict__.get("_cedar_semantic_fp")
    if fp is None:
        from ..lang.format import format_policy

        fp = hashlib.sha256(format_policy(policy).encode()).hexdigest()
        policy.__dict__["_cedar_semantic_fp"] = fp
    return fp


def policy_actions(policy: Policy) -> Optional[FrozenSet[str]]:
    """The actions a policy can apply to, as the request's action uid
    renders (``k8s::Action::"get"``), from its action scope: None when
    the scope does not bound them (a bare ``action``, an ``is`` scope, or
    the admission ``all`` action group that every admission action
    descends from). Conditions can only narrow what the scope admits."""
    sc = policy.action
    if sc.op == "eq":
        ents = (sc.entity,)
    elif sc.op == "in":
        ents = sc.entities or (sc.entity,)
    else:
        return None
    for e in ents:
        if e is None or (e.type == ADMISSION_ACTION_ENTITY_TYPE
                         and e.id == ADMISSION_ACTION_ALL):
            return None
    return frozenset(repr(e) for e in ents)


def shard_bucket(policy: Policy, n_buckets: int) -> int:
    """Stable bucket for a policy: identity-keyed (filename + policy id),
    NEVER content-keyed — an edit must dirty the policy's own shard, not
    migrate it to a different one (which would dirty two). Memoized on
    the object: the plan pass runs over the WHOLE corpus every reload,
    so per-policy recomputation is the steady-state cost that matters at
    100k policies."""
    cached = policy.__dict__.get("_cedar_shard_bucket")
    if cached is not None and cached[0] == n_buckets:
        return cached[1]
    global _bucket_hashes
    _bucket_hashes += 1
    key = f"{policy.filename}\x00{policy.policy_id}".encode()
    # blake2b, not crc32: crc is GF(2)-linear, and over the sequential
    # object names real stores produce (pol-000001, pol-000002, ...) its
    # low bits collapse onto a fraction of the buckets — skewed shards
    # mean one edit re-lowers far more than corpus/buckets policies
    h = int.from_bytes(
        hashlib.blake2b(key, digest_size=8).digest(), "big"
    )
    b = h % n_buckets
    policy.__dict__["_cedar_shard_bucket"] = (n_buckets, b)
    return b


def _shard_id(tier: int, bucket: int, realm: Optional[str] = None) -> str:
    # zero-padded bucket keeps lexicographic order == numeric order, so
    # sorted-shard assembly is deterministic and tier-grouped. A fused
    # multi-tenant plane (the JAX package's tenancy/) prefixes the owning tenant:
    # shards become (tenant, tier, bucket), so one tenant's CRD edit
    # dirties only ITS shards and the scoped cache invalidation / dirty
    # metrics stay tenant-local (tenant ids are registry-validated to
    # exclude "/").
    base = f"t{tier}b{bucket:04d}"
    return f"{realm}/{base}" if realm else base


def shard_tenant(shard_id: str) -> Optional[str]:
    """The owning tenant of a (tenant, tier, bucket) shard id, or None
    for a single-tenant shard — the parse every per-tenant rollup
    (debug docs, bench gates, dirty-scope tests) shares."""
    if "/" in shard_id:
        return shard_id.rsplit("/", 1)[0]
    return None


def _deguarded(p: Policy, realm: str) -> Policy:
    """The policy minus its leading tenant guard condition (identified BY
    IDENTITY against the per-tenant singleton, compiler/pack.py). A clone
    whose guard is not the singleton (foreign construction) lowers as-is
    — correct, just with the guard's own error clauses."""
    from .pack import tenant_guard_condition

    if p.conditions and p.conditions[0] is tenant_guard_condition(realm):
        import copy

        q = copy.copy(p)
        q.conditions = tuple(p.conditions[1:])
        # the copied content-fingerprint memo describes the GUARDED
        # source; this twin's content differs, and a stale stamp must
        # never be read off it
        q.__dict__.pop("_cedar_content_fp", None)
        return q
    return p


@dataclass
class CompiledShard:
    """One shard's cached compilation slice (pure host memory)."""

    shard_id: str
    tier: int
    content_hash: str
    lowered: List[LoweredPolicy]  # resident (post-prune) lowered policies
    fallback: List[FallbackPolicy]  # resident interpreter-fallback policies
    n_policies: int  # total member policies (incl. pruned)
    pruned: int  # policies excluded by the partition never-match proof
    spec_token: object  # partition identity the prune ran under


class ShardCompiler:
    """Per-engine incremental compiler (TorchPolicyEngine.load's backend).

    ``compile()`` returns the fused CompiledPolicies plus an info dict the
    engine folds into its load stats / metrics / plane state; the engine
    passes that info to ``commit()`` once the plane is published."""

    def __init__(
        self,
        schema: Optional[SchemaInfo] = None,
        buckets: int = DEFAULT_SHARD_BUCKETS,
        opts=None,
    ):
        self.schema = schema or AUTHZ_SCHEMA_INFO
        self.buckets = max(1, int(buckets))
        # lowering feature gates (lower.LowerOptions); fixed per compiler
        # instance, so cached shard slices never mix verdicts from two
        # different option sets
        self.opts = opts
        self.partition = None  # analysis.partition.PartitionSpec
        self._shards: Dict[str, CompiledShard] = {}
        self._n_tiers: Optional[int] = None

    def set_partition(self, spec) -> None:
        """Install (or clear) the serving-partition spec. Takes effect at
        the next compile(): shards whose prune verdict ran under a
        different spec token re-lower, paging policies on/off the plane."""
        self.partition = spec

    # ------------------------------------------------------------- compile

    def compile(self, tiers) -> Tuple[CompiledPolicies, dict]:
        """Lower the dirty shards of ``tiers`` against the committed shard
        map and fuse the plane's CompiledPolicies. Leaves the map as it
        was: the fresh one rides ``info["commit"]`` for ``commit()``."""
        t_start = time.monotonic()
        spec = self.partition
        spec_token = spec.token() if spec is not None else None

        # 1. shard plan: (tier, bucket) membership + content hashes. This
        # pass runs over the WHOLE corpus every reload, so the loop body is
        # deliberately minimal: each policy's current position is stamped
        # ON the object (epoch-tagged — a stale stamp from a prior scan is
        # detectable) instead of into a string-keyed dict. Cached slices
        # hold the SAME Policy objects (the store-reuse invariant the
        # differ keys on), so assembly reads the stamps straight back.
        # process-global epoch: authz + admission compilers (and a rollout
        # candidate's) scan the SAME policy objects — a stamp from another
        # compiler's interleaved scan must read as stale, never as a
        # plausible position
        epoch = next(_scan_epochs)
        plan: Dict[str, Tuple[int, str, list]] = {}
        pos = 0
        n_buckets = self.buckets
        for tier, ps in enumerate(tiers):
            # buckets key on (realm, bucket): single-tenant corpora carry
            # realm None and collapse to the classic per-tier bucket list;
            # fused multi-tenant tiers (the JAX package's tenancy stamps) split
            # per tenant so no shard ever spans two tenants
            buckets: Dict[Tuple[Optional[str], int], list] = {}
            for p in ps.policies():
                d = p.__dict__
                d["_cedar_ord"] = (epoch, pos)
                pos += 1
                cached = d.get("_cedar_shard_bucket")
                if cached is not None and cached[0] == n_buckets:
                    b = cached[1]
                else:
                    b = shard_bucket(p, n_buckets)
                # inline pack.policy_tenant(): d is already in hand in
                # this O(corpus) plan pass
                buckets.setdefault((d.get("_cedar_tenant"), b), []).append(p)
            for (realm, b) in sorted(
                buckets, key=lambda k: (k[0] or "", k[1])
            ):
                pols = buckets[(realm, b)]
                digest = hashlib.sha256(
                    "".join([policy_fingerprint(p) for p in pols]).encode()
                ).hexdigest()
                plan[_shard_id(tier, b, realm)] = (tier, digest, pols)

        # a tier-count change re-keys every shard id's meaning: full compile
        topology_changed = self._n_tiers is not None and self._n_tiers != len(
            tiers
        )
        first = not self._shards
        dirty: List[str] = []
        reused: List[str] = []
        fresh: Dict[str, CompiledShard] = {}
        for sid, (tier, content_hash, pols) in plan.items():
            prev = None if topology_changed else self._shards.get(sid)
            if (
                prev is not None
                and prev.content_hash == content_hash
                and prev.spec_token == spec_token
            ):
                fresh[sid] = prev
                reused.append(sid)
            else:
                dirty.append(sid)
        removed = [sid for sid in self._shards if sid not in plan]
        added_actions = self._added_actions(plan, dirty, topology_changed)
        hash_s = time.monotonic() - t_start

        # 2. lower the dirty shards only. self._shards stays as it is
        # whatever happens here: commit() replaces it wholesale once the
        # plane built from `fresh` is published
        t_lower = time.monotonic()
        for sid in dirty:
            tier, content_hash, pols = plan[sid]
            chaos_fire("engine.shard_compile", sid)
            fresh[sid] = self._lower_shard(
                sid, tier, content_hash, pols, spec, spec_token
            )
        lower_s = time.monotonic() - t_lower

        # 3. fuse, restoring EXACT corpus order: assembly sorts the cached
        # slices back into the policies' current tier/input positions, so
        # the fused CompiledPolicies is indistinguishable from a
        # lower_tiers() pass — packed policy indices, multi-reason JSON
        # orderings and policy_meta layouts never depend on shard topology
        out = CompiledPolicies(n_tiers=len(tiers))
        pruned = 0
        policy_shard: Dict[str, Optional[str]] = {}
        lowered_entries: list = []
        fallback_entries: list = []
        far = 1 << 60  # stale/missing stamp (content-identical re-parse
        # edge): sorts last — semantically harmless, reason sets are exact
        # and ordering is not a contract

        def _pos(p) -> int:
            stamp = p.__dict__.get("_cedar_ord")
            return stamp[1] if stamp is not None and stamp[0] == epoch else far

        def _stamp_key(p) -> str:
            # fused multi-tenant planes qualify the cache-stamp key by the
            # owning tenant: per-tenant directory stores commonly carry
            # the SAME bare-filename policy ids (alpha's and beta's
            # p.cedar.policy0), and an unqualified key would read as a
            # cross-shard ambiguity — downgrading those decisions' cache
            # stamps from shard-scoped to kill-on-any-reload. The scoped
            # lookup re-qualifies with the request's tenant
            # (cache/generation.py scoped(tenant=...)).
            t = p.__dict__.get("_cedar_tenant")
            return f"{t}/{p.policy_id}" if t is not None else p.policy_id

        for sid in sorted(fresh):
            cs = fresh[sid]
            pruned += cs.pruned
            for lp in cs.lowered:
                lowered_entries.append((_pos(lp.policy), lp))
                pid = _stamp_key(lp.policy)
                policy_shard[pid] = (
                    sid if policy_shard.get(pid, sid) == sid else None
                )
            for fb in cs.fallback:
                fallback_entries.append((_pos(fb.policy), fb))
                pid = _stamp_key(fb.policy)
                policy_shard[pid] = (
                    sid if policy_shard.get(pid, sid) == sid else None
                )
        lowered_entries.sort(key=lambda e: e[0])
        fallback_entries.sort(key=lambda e: e[0])
        out.lowered.extend(lp for _, lp in lowered_entries)
        out.fallback.extend(fb for _, fb in fallback_entries)

        scope = "full" if (first or topology_changed or not reused) else (
            "incremental"
        )
        info = {
            "compile_scope": scope,
            "shards": len(plan),
            "dirty_shards": len(dirty),
            "reused_shards": len(reused),
            "removed_shards": len(removed),
            "pruned_policies": pruned,
            "shard_hashes": {sid: plan[sid][1] for sid in plan},
            "dirty": sorted(dirty + removed),
            # ambiguous policy ids (same id in two shards) map to None and
            # are dropped: the cache must not scope an entry to the wrong
            # shard
            "policy_shard": {
                pid: sid for pid, sid in policy_shard.items() if sid
            },
            # per dirty shard, the actions its newly added policies can
            # apply to (None: unbounded); the decision cache's scoped
            # stamps read it (cache/generation.py)
            "added_actions": added_actions,
            "phase_seconds": {"hash": hash_s, "lower": lower_s},
            "partition": spec.name if spec is not None else None,
            # what commit() installs once the plane is published
            "commit": (fresh, len(tiers)),
        }
        return out, info

    def _added_actions(self, plan, dirty, topology_changed) -> dict:
        """{dirty shard: the actions its added policies can apply to, or
        None when one is unbounded}. Policies are counted by (tier,
        policy_semantics) over all the dirty shards, before and after: a
        policy is added when its count grew. A policy that only moved (to
        another position, id or shard of its tier) matches the same
        requests as before, and every cached decision it determined names
        it, so its old shard's stamp already covers those; a second copy
        of a policy is added (an allow's reason lists every permit it
        satisfies)."""
        before: Counter = Counter()
        if not topology_changed:
            for sid in dirty:
                prev = self._shards.get(sid)
                if prev is not None:
                    before.update((prev.tier, policy_semantics(x.policy))
                                  for x in prev.lowered + prev.fallback)
        out: dict = {}
        for sid in dirty:
            if sid not in plan:
                continue
            tier, _digest, pols = plan[sid]
            acts: Optional[set] = set()
            for p in pols:
                key = (tier, policy_semantics(p))
                if before[key] > 0:
                    before[key] -= 1
                    continue
                a = policy_actions(p)
                if a is None or acts is None:
                    acts = None
                    continue
                acts |= a
            out[sid] = None if acts is None else frozenset(acts)
        return out

    def commit(self, info: dict) -> None:
        """Make the shard map of a compile() the one the next compile
        diffs against: called by the engine once the plane built from
        that compile serves. A compile whose plane never published is
        never committed."""
        self._shards, self._n_tiers = info["commit"]

    def _lower_shard(
        self, sid, tier, content_hash, pols, spec, spec_token
    ) -> CompiledShard:
        from ..analysis.partition import (
            lowered_never_matches,
            quick_never_matches,
        )
        from .pack import discriminate_lowered, policy_tenant

        lowered: List[LoweredPolicy] = []
        fallback: List[FallbackPolicy] = []
        pruned = 0
        for p in pols:
            realm = policy_tenant(p)
            # fused multi-tenant clone: lower the DEGUARDED twin — same
            # lowerability verdict and same clause IR as the tenant's
            # standalone engine — then prepend the synthetic total
            # discriminator literal (compiler/pack.py). Lowering the
            # guarded AST directly would add error clauses for the
            # guard's fallible context access; the fallback AST keeps the
            # guard so policy_matches stays tenant-isolated.
            base = _deguarded(p, realm) if realm is not None else p
            if spec is not None and quick_never_matches(
                base, spec, self.schema
            ):
                pruned += 1
                continue
            try:
                lp = lower_policy(base, tier, self.schema, self.opts)
            except Unlowerable as e:
                fallback.append(
                    FallbackPolicy(
                        policy=p,
                        tier=tier,
                        reason=str(e),
                        code=e.code,
                        construct=e.construct,
                    )
                )
                continue
            if spec is not None and lowered_never_matches(lp, spec):
                pruned += 1
                continue
            if realm is not None:
                lp = discriminate_lowered(lp, realm)
                # the SCANNED clone (not the deguarded twin) must ride the
                # cached slice: assembly reads the per-reload position
                # stamps off it, and pack's gate/tenant plumbing reads
                # the _cedar_tenant stamp
                lp.policy = p
            lowered.append(lp)
        return CompiledShard(
            sid, tier, content_hash, lowered, fallback, len(pols), pruned,
            spec_token,
        )

    # -------------------------------------------------------------- status

    def shard_map(self) -> Dict[str, CompiledShard]:
        """The live shard cache (read-only view for reports/debug)."""
        return dict(self._shards)
