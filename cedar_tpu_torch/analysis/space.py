"""Typed request-universe enumeration for device-exact policy analysis
(a copy of the JAX package's analysis/space.py over the port's compiler:
the same domains, the same seeded strata, the same requests in the same
order).

The compiled plane (compiler/pack.py) answers one request exactly; this
module enumerates *which* requests are worth asking so that a batched
sweep over the result answers questions about the whole policy space —
dead rules, shadowing, permit/forbid overlap, semantic diff (see
analysis/semdiff.py for the sweep itself).

The key observation is that plane behaviour factors through the encoded
feature vector (codes, extras) that compiler/table.py produces: two
requests landing on the same codes row and the same host-evaluated
extras bits are indistinguishable to every packed rule. Codes are
determined by vocab membership (FeatureTable interns every constant any
policy tests), and out-of-vocab values can differ only through the
host-evaluated like/cmp/type-error extras. A finite set of
representatives therefore covers the full quotient of the request
space, per slot:

- every interned vocab constant (scalar_vocab / uid_vocab / anc_vocab),
- each cmp boundary neighbourhood {c-1, c, c+1},
- a witness string matched by each `like` pattern,
- one typed out-of-vocab witness (plus a wrong-type witness for
  untyped slots that feed type-error indicator literals), and
- the missing-attribute class where the schema does not mandate the
  attribute.

When the cartesian product over those per-dimension domains is small
(and the pack has no host-opaque HARD literals or fallback policies,
whose behaviour does NOT factor through codes), the enumeration is
**exhaustive over the quotient** and sweep verdicts are exact.
Otherwise we emit a seeded stratified sample: a one-dimension-at-a-time
cover stratum (every domain value appears in at least one request), a
clause-witness stratum (a directed assignment per packed match clause,
so conjunctions that joint random sampling would essentially never hit
are represented), and a seeded random fill. No wall-clock randomness —
enumeration is a pure function of (packs, budget, seed).

Generated requests respect the closed authz schema the lowerer assumed
(compiler/lower.py SchemaInfo): every entity carries its type's
mandatory attributes and schema-typed slots only receive values of
their static type. Violating either would exercise states the
negation-safety and flow-typing proofs explicitly excluded, where a
plane/interpreter divergence is not a bug.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..compiler.encode import _MISSING
from ..compiler.ir import (
    CMP,
    ENTITY_IN,
    ENTITY_IN_ANY,
    EQ,
    EQ_ENTITY,
    HARD,
    HARD_ERR,
    HARD_OK,
    HAS,
    IN_SET,
    IN_SLOT,
    IS,
    LIKE,
    SET_HAS,
    TRUE,
    TYPE_ERR,
    Clause,
    Slot,
)
from ..compiler.lower import BOOL, ENTITY, LONG, SET, STR, UNKNOWN, SchemaInfo
from ..lang.entities import Entity, EntityMap
from ..lang.eval import Request
from ..lang.values import CedarRecord, CedarSet, EntityUID

VARS = ("principal", "action", "resource")

# id used for out-of-vocab witness entities / strings; chosen to be
# outside anything synth corpora or the k8s demo policies intern
_OOV_ID = "zz-oov-witness"
_OOV_STR = "zz-oov-witness"
_DEFAULT_STR = "space-default"

# marker returned by _decode_value_key for tags the enumerator does not
# expand into concrete values (records, extension types)
_UNDECODABLE = object()


# ---------------------------------------------------------------------------
# value decoding and witnesses


def _decode_value_key(vk: Any) -> Any:
    """Concrete Cedar value for an interned value_key, or _UNDECODABLE."""
    if not isinstance(vk, tuple) or not vk:
        return _UNDECODABLE
    tag = vk[0]
    if tag in ("b", "l", "s"):
        return vk[1]
    if tag == "e":
        return EntityUID(vk[1], vk[2])
    return _UNDECODABLE


def _like_witness(pattern: Any) -> Optional[str]:
    """A string the pattern matches: wildcards collapse to empty."""
    try:
        parts = [c for c in pattern.components if isinstance(c, str)]
        s = "".join(parts)
        return s if pattern.match(s) else None
    except Exception:
        return None


_WRONG_TYPE_WITNESS = {
    # required tag -> a value carrying a different tag
    "s": 7,
    "l": _OOV_STR,
    "b": _OOV_STR,
    "S": _OOV_STR,
    "e": _OOV_STR,
}


def _key_of(v: Any) -> Any:
    """Stable dedup key for a domain value (values may be unhashable)."""
    if v is _MISSING:
        return ("missing",)
    if isinstance(v, EntityUID):
        return ("e", v.type, v.id)
    if isinstance(v, CedarSet):
        return ("S", tuple(sorted(repr(e) for e in v.elems)))
    return (type(v).__name__, repr(v))


class _Domain:
    """Ordered, deduped list of candidate values for one dimension."""

    def __init__(self) -> None:
        self.values: List[Any] = []
        self._seen: Set[Any] = set()
        self.full = True  # exhaustive over the quotient classes

    def add(self, v: Any) -> None:
        k = _key_of(v)
        if k not in self._seen:
            self._seen.add(k)
            self.values.append(v)


# ---------------------------------------------------------------------------
# domains


@dataclass
class SpaceDomains:
    """Per-dimension candidate values merged across one or more packs."""

    uid_choices: Dict[str, List[EntityUID]]
    anc_subsets: Dict[str, List[Tuple[EntityUID, ...]]]
    anc_full: Dict[str, bool]
    slot_order: List[Slot]
    slot_domains: Dict[Slot, List[Any]]
    slot_full: Dict[Slot, bool]
    quotient_sound: bool  # no HARD literals / fallback policies

    def product_size(self) -> int:
        total = 1
        for var in VARS:
            total *= max(1, len(self.uid_choices[var]))
            total *= max(1, len(self.anc_subsets[var]))
            if total > 1 << 62:
                return 1 << 62
        for slot in self.slot_order:
            total *= max(1, len(self.slot_domains[slot]))
            if total > 1 << 62:
                return 1 << 62
        return total


def _default_uid(var: str, schema: SchemaInfo) -> EntityUID:
    types = schema.var_types.get(var, ())
    t = types[0] if types else "k8s::%s" % var.capitalize()
    return EntityUID(t, _OOV_ID)


def build_domains(
    packs: Sequence[Any], schema: Optional[SchemaInfo] = None
) -> SpaceDomains:
    """Merge the vocab tables + encode plans of ``packs`` into candidate
    domains per request dimension."""
    schema = schema or SchemaInfo()
    uid_doms: Dict[str, _Domain] = {v: _Domain() for v in VARS}
    anc_doms: Dict[str, _Domain] = {v: _Domain() for v in VARS}
    ref_types: Dict[str, List[str]] = {v: [] for v in VARS}
    slot_doms: Dict[Slot, _Domain] = {}
    slot_cmp: Dict[Slot, Set[int]] = {}
    slot_set_elems: Dict[Slot, _Domain] = {}
    slot_order: List[Slot] = []
    quotient_sound = True

    def _slot(slot: Slot) -> _Domain:
        if slot not in slot_doms:
            slot_doms[slot] = _Domain()
            slot_order.append(slot)
        return slot_doms[slot]

    def _ref_type(var: str, t: str) -> None:
        if var in ref_types and t not in ref_types[var]:
            ref_types[var].append(t)

    for pack in packs:
        plan = pack.plan
        table = getattr(pack, "table", None)
        if plan.hard_lits or getattr(pack, "fallback", None):
            quotient_sound = False
        if table is not None:
            for key in table.uid_vocab:
                var, t, i = key
                if var in uid_doms:
                    uid_doms[var].add(EntityUID(t, i))
                    _ref_type(var, t)
            for key in table.anc_vocab:
                var, t, i = key
                if var in anc_doms:
                    anc_doms[var].add(EntityUID(t, i))
            for key in table.type_vocab:
                var, t = key
                _ref_type(var, t)
            for slot, vocab in table.scalar_vocab.items():
                d = _slot(slot)
                for vk in vocab:
                    v = _decode_value_key(vk)
                    if v is _UNDECODABLE:
                        d.full = False
                    else:
                        d.add(v)
        for var, targets in plan.eq_entity_idx.items():
            for t, i in targets:
                if var in uid_doms:
                    uid_doms[var].add(EntityUID(t, i))
                    _ref_type(var, t)
        for var, targets in plan.entity_in_idx.items():
            for t, i in targets:
                if var in anc_doms:
                    anc_doms[var].add(EntityUID(t, i))
        for var, types in plan.is_idx.items():
            for t in types:
                _ref_type(var, t)
        for slot in plan.slots:
            _slot(slot)
        for slot, pats in plan.like_idx.items():
            d = _slot(slot)
            for _lid, pat in pats:
                w = _like_witness(pat)
                if w is None:
                    d.full = False
                else:
                    d.add(w)
        for slot, cmps in plan.cmp_idx.items():
            _slot(slot)
            acc = slot_cmp.setdefault(slot, set())
            for _lid, _op, c in cmps:
                acc.add(int(c))
        for slot, elems in plan.set_has_idx.items():
            _slot(slot)
            d = slot_set_elems.setdefault(slot, _Domain())
            for ek in elems:
                v = _decode_value_key(ek)
                if v is _UNDECODABLE:
                    d.full = False
                else:
                    d.add(v)
        for slot, targets in plan.in_slot_idx.items():
            d = _slot(slot)
            for t, i in targets:
                d.add(EntityUID(t, i))
        for slot in plan.has_idx:
            _slot(slot)
        for slot in plan.type_err_idx:
            _slot(slot)
        for slot in plan.inset_idx:
            d = _slot(slot)
            for vk in plan.inset_idx[slot]:
                v = _decode_value_key(vk)
                if v is _UNDECODABLE:
                    d.full = False
                else:
                    d.add(v)

    # finalize slot domains: cmp boundaries, set subsets, typed OOV +
    # wrong-type witnesses, and the missing class
    slot_domains: Dict[Slot, List[Any]] = {}
    slot_full: Dict[Slot, bool] = {}
    for slot in slot_order:
        var, path = slot
        d = slot_doms[slot]
        static_t = schema.attr_type(None, var, path)
        for c in sorted(slot_cmp.get(slot, ())):
            for v in (c - 1, c, c + 1):
                d.add(v)
        elems = slot_set_elems.get(slot)
        if elems is not None:
            if not elems.full:
                d.full = False
            n = len(elems.values)
            if n <= 2:
                for r in range(n + 1):
                    for combo in itertools.combinations(elems.values, r):
                        d.add(CedarSet(tuple(combo)))
            else:
                d.full = False
                d.add(CedarSet(()))
                for e in elems.values:
                    d.add(CedarSet((e,)))
                d.add(CedarSet(tuple(elems.values)))
        # typed out-of-vocab witness
        if static_t == BOOL:
            d.add(True)
            d.add(False)
        elif static_t == LONG:
            ceiling = max(slot_cmp.get(slot, {0}) or {0})
            d.add(ceiling + 1_000_003)
        elif static_t == SET:
            d.add(CedarSet(()))
        elif static_t == ENTITY:
            d.add(EntityUID("k8s::Group", _OOV_ID))
        else:  # STR or UNKNOWN
            d.add(_OOV_STR)
        if static_t == UNKNOWN:
            want_tags = {w for pack in packs for _l, w in pack.plan.type_err_idx.get(slot, ())}
            for w in sorted(want_tags):
                wrong = _WRONG_TYPE_WITNESS.get(w)
                if wrong is not None:
                    d.add(wrong)
        if not schema.is_mandatory(None, var, path):
            d.add(_MISSING)
        slot_domains[slot] = d.values
        slot_full[slot] = d.full

    # uid choices: vocab uids + one OOV witness per referenced type + a
    # default-typed witness so every var has at least one choice
    uid_choices: Dict[str, List[EntityUID]] = {}
    for var in VARS:
        d = uid_doms[var]
        for t in ref_types[var]:
            d.add(EntityUID(t, _OOV_ID))
        d.add(_default_uid(var, schema))
        uid_choices[var] = d.values

    # ancestor subsets: full powerset when small, else empty/singletons/all
    anc_subsets: Dict[str, List[Tuple[EntityUID, ...]]] = {}
    anc_full: Dict[str, bool] = {}
    for var in VARS:
        cands = anc_doms[var].values
        if len(cands) <= 3:
            subsets = [
                tuple(combo)
                for r in range(len(cands) + 1)
                for combo in itertools.combinations(cands, r)
            ]
            anc_full[var] = True
        else:
            subsets = [()]
            subsets.extend((c,) for c in cands)
            subsets.append(tuple(cands))
            anc_full[var] = False
        anc_subsets[var] = subsets

    return SpaceDomains(
        uid_choices=uid_choices,
        anc_subsets=anc_subsets,
        anc_full=anc_full,
        slot_order=slot_order,
        slot_domains=slot_domains,
        slot_full=slot_full,
        quotient_sound=quotient_sound,
    )


# ---------------------------------------------------------------------------
# assignments -> concrete (EntityMap, Request)


@dataclass
class _Assignment:
    uids: Dict[str, EntityUID]
    ancestors: Dict[str, Tuple[EntityUID, ...]]
    slots: Dict[Slot, Any]

    def key(self) -> Tuple[Any, ...]:
        return (
            tuple((v, _key_of(self.uids[v])) for v in VARS if v in self.uids),
            tuple(
                (v, tuple(sorted(_key_of(a) for a in self.ancestors.get(v, ()))))
                for v in VARS
            ),
            tuple(sorted((s, _key_of(val)) for s, val in self.slots.items())),
        )


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for part in path[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[path[-1]] = value


def _to_record(tree: Dict[str, Any]) -> CedarRecord:
    out = {}
    for k, v in tree.items():
        out[k] = _to_record(v) if isinstance(v, dict) else v
    return CedarRecord(out)


def materialize(
    asg: _Assignment, schema: Optional[SchemaInfo] = None
) -> Tuple[EntityMap, Request]:
    """Build the concrete entity map + request for one assignment.

    Every generated entity carries its type's mandatory attributes
    (defaulted when the assignment does not pin them) and every
    entity-valued slot value gets a bare support entity so ancestor
    closures resolve.
    """
    schema = schema or SchemaInfo()
    attr_trees: Dict[str, Dict[str, Any]] = {v: {} for v in VARS}
    ctx_tree: Dict[str, Any] = {}
    support: List[EntityUID] = []
    for slot, val in asg.slots.items():
        if val is _MISSING:
            continue
        var, path = slot
        if isinstance(val, EntityUID):
            support.append(val)
        elif isinstance(val, CedarSet):
            support.extend(e for e in val.elems if isinstance(e, EntityUID))
        if var == "context":
            _set_path(ctx_tree, path, val)
        elif var in attr_trees:
            _set_path(attr_trees[var], path, val)
    emap = EntityMap()
    for var in VARS:
        uid = asg.uids.get(var)
        if uid is None:
            continue
        tree = attr_trees[var]
        for name in schema.mandatory.get(uid.type, frozenset()):
            tree.setdefault(name, _DEFAULT_STR)
        parents = asg.ancestors.get(var, ())
        emap.add(Entity(uid, _to_record(tree), tuple(parents)))
    for var in VARS:
        for anc in asg.ancestors.get(var, ()):
            if emap.get(anc) is None:
                emap.add(Entity(anc))
    for uid in support:
        if emap.get(uid) is None:
            emap.add(Entity(uid))
    request = Request(
        asg.uids["principal"],
        asg.uids["action"],
        asg.uids["resource"],
        _to_record(ctx_tree),
    )
    return emap, request


# ---------------------------------------------------------------------------
# clause-directed witnesses


def _interval_pick(cmps: List[Tuple[str, int]]) -> Optional[int]:
    """An integer satisfying every (op, c) comparison, or None."""
    lo, hi = None, None
    for op, c in cmps:
        if op in ("<", "<="):
            b = c if op == "<=" else c - 1
            hi = b if hi is None else min(hi, b)
        elif op in (">", ">="):
            b = c if op == ">=" else c + 1
            lo = b if lo is None else max(lo, b)
        elif op == "==":
            lo = c if lo is None else max(lo, c)
            hi = c if hi is None else min(hi, c)
        else:
            return None
    if lo is None and hi is None:
        return 0
    if lo is None:
        return hi
    if hi is None:
        return lo
    return lo if lo <= hi else None


def clause_assignment(
    clause: Clause, doms: SpaceDomains, schema: Optional[SchemaInfo] = None
) -> Optional[_Assignment]:
    """Directed witness assignment satisfying the clause's positive
    literals (negated literals default to out-of-vocab values, which the
    sweep confirms or refutes against the plane). None when the positive
    literals visibly conflict or require host-opaque evaluation."""
    schema = schema or SchemaInfo()
    uids: Dict[str, EntityUID] = {}
    ancs: Dict[str, Set[EntityUID]] = {v: set() for v in VARS}
    slots: Dict[Slot, Any] = {}
    var_is: Dict[str, str] = {}
    cmps: Dict[Slot, List[Tuple[str, int]]] = {}
    set_elems: Dict[Slot, List[Any]] = {}
    present: Set[Slot] = set()

    def _put(slot: Slot, v: Any) -> bool:
        if slot in slots and _key_of(slots[slot]) != _key_of(v):
            return False
        slots[slot] = v
        return True

    for cl in clause:
        lit, neg = cl.lit, cl.negated
        if neg:
            continue
        k = lit.kind
        if k == TRUE:
            continue
        if k in (HARD, HARD_OK, HARD_ERR, TYPE_ERR):
            return None
        if k == EQ:
            v = _decode_value_key(lit.data)
            if v is _UNDECODABLE or lit.slot is None or not _put(lit.slot, v):
                return None
        elif k == HAS:
            if lit.slot is not None:
                present.add(lit.slot)
        elif k == LIKE:
            w = _like_witness(lit.data)
            if w is None or lit.slot is None or not _put(lit.slot, w):
                return None
        elif k == CMP:
            if lit.slot is None:
                return None
            op, c = lit.data
            cmps.setdefault(lit.slot, []).append((op, int(c)))
        elif k == IN_SET:
            if lit.slot is None or not lit.data:
                return None
            v = _decode_value_key(next(iter(lit.data)))
            if v is _UNDECODABLE or not _put(lit.slot, v):
                return None
        elif k == SET_HAS:
            if lit.slot is None:
                return None
            v = _decode_value_key(lit.data)
            if v is _UNDECODABLE:
                return None
            set_elems.setdefault(lit.slot, []).append(v)
        elif k == IS:
            if lit.var in var_is and var_is[lit.var] != lit.data:
                return None
            var_is[lit.var] = lit.data
        elif k == EQ_ENTITY:
            t, i = lit.data
            uid = EntityUID(t, i)
            if lit.var in uids and uids[lit.var] != uid:
                return None
            uids[lit.var] = uid
        elif k == ENTITY_IN:
            t, i = lit.data
            ancs.setdefault(lit.var, set()).add(EntityUID(t, i))
        elif k == ENTITY_IN_ANY:
            if not lit.data:
                return None
            targets = sorted(lit.data)
            t, i = targets[0]
            ancs.setdefault(lit.var, set()).add(EntityUID(t, i))
        elif k == IN_SLOT:
            if lit.slot is None:
                return None
            data = lit.data
            if isinstance(data, tuple) and len(data) == 2 and all(
                isinstance(x, str) for x in data
            ):
                targets = [data]
            else:
                targets = sorted(data)
            if not targets:
                return None
            t, i = targets[0]
            if not _put(lit.slot, EntityUID(t, i)):
                return None
        else:
            return None

    for slot, ops in cmps.items():
        v = _interval_pick(ops)
        if v is None or not _put(slot, v):
            return None
    for slot, elems in set_elems.items():
        dedup: List[Any] = []
        for e in elems:
            if all(_key_of(e) != _key_of(x) for x in dedup):
                dedup.append(e)
        if not _put(slot, CedarSet(tuple(dedup))):
            return None
    for slot in present:
        if slot not in slots:
            var, path = slot
            static_t = schema.attr_type(None, var, path)
            if static_t == LONG:
                slots[slot] = 0
            elif static_t == BOOL:
                slots[slot] = True
            elif static_t == SET:
                slots[slot] = CedarSet(())
            else:
                slots[slot] = _OOV_STR

    for var in VARS:
        if var in uids:
            continue
        want = var_is.get(var)
        choice = None
        for cand in doms.uid_choices.get(var, ()):
            if want is None or cand.type == want:
                choice = cand
                break
        if choice is None:
            choice = EntityUID(want, _OOV_ID) if want else _default_uid(var, schema)
        uids[var] = choice

    # a var constrained by IS must actually carry that type
    for var, want in var_is.items():
        if var in uids and uids[var].type != want:
            uids[var] = EntityUID(want, _OOV_ID)

    return _Assignment(
        uids=uids,
        ancestors={v: tuple(sorted(ancs.get(v, ()), key=_key_of)) for v in VARS},
        slots=slots,
    )


# ---------------------------------------------------------------------------
# universe


@dataclass
class Universe:
    """The enumerated request universe for one or more packed sets."""

    items: List[Tuple[EntityMap, Request]]
    exhaustive: bool
    strata: Dict[str, int] = field(default_factory=dict)
    truncated: bool = False

    @property
    def size(self) -> int:
        return len(self.items)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "size": self.size,
            "exhaustive": self.exhaustive,
            "strata": dict(self.strata),
            "truncated": self.truncated,
        }


def _base_assignment(doms: SpaceDomains) -> _Assignment:
    slots: Dict[Slot, Any] = {}
    for slot in doms.slot_order:
        dom = doms.slot_domains[slot]
        slots[slot] = dom[0] if dom else _MISSING
    return _Assignment(
        uids={v: doms.uid_choices[v][0] for v in VARS},
        ancestors={v: () for v in VARS},
        slots=slots,
    )


def enumerate_universe(
    packs: Sequence[Any],
    budget: int = 4096,
    seed: int = 0,
    schema: Optional[SchemaInfo] = None,
) -> Universe:
    """Enumerate the typed request universe for ``packs`` (one or more
    PackedPolicySets — pass both live and candidate packs for a semantic
    diff so the universe covers the union of their vocabularies).

    Exhaustive (over the encoding quotient) when the cartesian product
    of per-dimension domains fits in ``budget`` and every domain is
    itself quotient-complete; otherwise a seeded stratified sample of at
    most ``budget`` requests.
    """
    schema = schema or SchemaInfo()
    doms = build_domains(packs, schema)
    product = doms.product_size()
    exhaustive = (
        product <= budget
        and doms.quotient_sound
        and all(doms.anc_full.values())
        and all(doms.slot_full.values())
    )

    items: List[Tuple[EntityMap, Request]] = []
    seen: Set[Tuple[Any, ...]] = set()
    strata: Dict[str, int] = {}
    truncated = False

    def _emit(asg: _Assignment, stratum: str) -> bool:
        if len(items) >= budget:
            return False
        k = asg.key()
        if k in seen:
            return True
        seen.add(k)
        items.append(materialize(asg, schema))
        strata[stratum] = strata.get(stratum, 0) + 1
        return True

    if product <= budget:
        dims: List[Tuple[str, List[Any]]] = []
        for var in VARS:
            dims.append(("uid:%s" % var, list(doms.uid_choices[var])))
            dims.append(("anc:%s" % var, list(doms.anc_subsets[var])))
        for slot in doms.slot_order:
            dims.append(("slot", list(doms.slot_domains[slot]) or [_MISSING]))
        for combo in itertools.product(*(vals for _n, vals in dims)):
            idx = 0
            uids: Dict[str, EntityUID] = {}
            ancestors: Dict[str, Tuple[EntityUID, ...]] = {}
            for var in VARS:
                uids[var] = combo[idx]
                ancestors[var] = combo[idx + 1]
                idx += 2
            slots = {
                slot: combo[idx + j] for j, slot in enumerate(doms.slot_order)
            }
            _emit(_Assignment(uids, ancestors, slots), "product")
        return Universe(items, exhaustive, strata, truncated=False)

    # stratified-with-seed
    rng = random.Random(seed)
    base = _base_assignment(doms)
    _emit(base, "base")

    # clause stratum FIRST: a directed witness per packed match clause.
    # These prove aliveness — multi-literal conjunctions that joint
    # random sampling would essentially never hit — so when the budget
    # cannot fit everything, clause witnesses win over the cover sweep.
    for pack in packs:
        for rc in getattr(pack, "rule_clause", ()):
            if rc.kind != "match" or rc.clause is None:
                continue
            asg = clause_assignment(rc.clause, doms, schema)
            if asg is not None and not _emit(asg, "clause"):
                truncated = True
        if truncated:
            break

    # cover stratum: vary one dimension at a time off the base so every
    # live vocab constant (and each OOV witness) appears at least once.
    # Seeded shuffle so truncation drops a random slice, not whole slots.
    cover: List[Tuple[str, Any, Any]] = []
    for var in VARS:
        for uid in doms.uid_choices[var]:
            cover.append(("uid", var, uid))
        for subset in doms.anc_subsets[var]:
            cover.append(("anc", var, subset))
    for slot in doms.slot_order:
        for v in doms.slot_domains[slot]:
            cover.append(("slot", slot, v))
    rng.shuffle(cover)
    for dim, key, val in cover:
        asg = _Assignment(dict(base.uids), dict(base.ancestors), dict(base.slots))
        if dim == "uid":
            asg.uids[key] = val
        elif dim == "anc":
            asg.ancestors[key] = val
        else:
            asg.slots[key] = val
        if not _emit(asg, "cover"):
            truncated = True
            break

    # random fill: seeded joint samples up to the budget
    attempts = 0
    max_attempts = max(64, 4 * budget)
    while len(items) < budget and attempts < max_attempts:
        attempts += 1
        uids = {v: rng.choice(doms.uid_choices[v]) for v in VARS}
        ancestors = {v: rng.choice(doms.anc_subsets[v]) for v in VARS}
        slots = {
            slot: rng.choice(doms.slot_domains[slot])
            for slot in doms.slot_order
            if doms.slot_domains[slot]
        }
        _emit(_Assignment(uids, ancestors, slots), "random")

    return Universe(items, exhaustive=False, strata=strata, truncated=truncated)


def universe_for_tiers(
    tiers: Iterable[Any],
    budget: int = 4096,
    seed: int = 0,
    schema: Optional[SchemaInfo] = None,
) -> Tuple[Universe, Any]:
    """Compile ``tiers`` (PolicySets) into one pack and enumerate its
    universe. Returns (universe, packed) — convenience for callers that
    do not already hold a compiled pack."""
    from .semdiff import pack_tiers

    packed = pack_tiers(tiers, schema)
    return enumerate_universe([packed], budget=budget, seed=seed, schema=schema), packed
