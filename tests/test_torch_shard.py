"""Incremental (shard-granular) compile in the port (cedar_tpu_torch/
compiler/shard.py and TorchPolicyEngine(incremental=True)) against the JAX
package's, on the CPU, at tolerance 0 throughout.

One harness feeds both packages the same tier stacks: each tier is a set
of policy files ({filename: Cedar text}), parsed by each package with a
per-file parse cache, as a directory store keeps one (an unchanged file
keeps its Policy objects, and with them the fingerprints and buckets
memoized on them). Six edit sequences start from a 60-policy synth corpus
in 15 files: a file modified, a file added, a file deleted, a policy
moved across files, a tier added and a tier removed; each runs at 1, 8
and 64 buckets per tier.

Held equal, per step:
  * the ShardCompilers' compile_scope, dirty set, shard hashes and
    policy-to-shard map (the port's committed after every compile, as
    the engine commits a published plane);
  * the incremental engines' pack bytes (W, thresh, rule_group,
    rule_policy, act_rows), scope, shard counts and plane lineage (shard
    generations, dirty set, the structural id kept or renewed);
  * decisions and reason sets of the port's incremental engine, the
    port's full compile and the JAX incremental engine.

Then what the port adds: a load that fails after its compile (pack,
place, warm-up, a load hook) commits nothing, so the next reload's dirty
set is relative to the serving plane and its plane equals a full
compile's; a lowering failure (the chaos seam) keeps the prior set; a
rebuild renews the structural id and keeps the generations.
"""

import numpy as np
import pytest

from cedar_tpu.chaos.registry import default_registry as j_chaos
from cedar_tpu.compiler.shard import ShardCompiler as JShardCompiler
from cedar_tpu.compiler.shard import policy_fingerprint as j_fingerprint
from cedar_tpu.compiler.shard import shard_bucket as j_shard_bucket
from cedar_tpu.corpus.synth import synth_corpus as j_synth_corpus
from cedar_tpu.engine.evaluator import TPUPolicyEngine
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.lang.parser import parse_policies as j_parse
from cedar_tpu_torch.chaos import ChaosError
from cedar_tpu_torch.chaos.registry import default_registry as t_chaos
from cedar_tpu_torch.compiler.shard import ShardCompiler
from cedar_tpu_torch.compiler.shard import policy_fingerprint, shard_bucket
from cedar_tpu_torch.corpus.synth import synth_corpus, synth_source
from cedar_tpu_torch.engine import evaluator as t_evaluator
from cedar_tpu_torch.engine.evaluator import TorchPolicyEngine
from cedar_tpu_torch.engine.weights import packed_arrays
from cedar_tpu_torch.lang import PolicySet
from cedar_tpu_torch.lang.parser import parse_policies

N_POLICIES, SEED, CLUSTERS, PER_FILE = 60, 7, 3, 4
BUCKETS = (1, 8, 64)
PACK_ARRAYS = ("W", "thresh", "rule_group", "rule_policy", "act_rows")
FORBID_TIER = {"guard.cedar": 'forbid (principal, action == k8s::Action::"watch", '
                              "resource is k8s::Resource);\n"}
ADDED = ('forbid (principal, action in [k8s::Action::"get", k8s::Action::"list"], '
         'resource is k8s::Resource) when { resource.resource == "secrets" };\n')


def _base_files() -> dict:
    lines = synth_source(N_POLICIES, seed=SEED, clusters=CLUSTERS).split("\n")
    return {f"obj-{k:02d}.cedar": "\n".join(lines[i:i + PER_FILE]) + "\n"
            for k, i in enumerate(range(0, len(lines), PER_FILE))}


def _flip(text: str) -> str:
    """The file with its first policy's effect flipped."""
    if text.startswith("permit "):
        return "forbid " + text[len("permit "):]
    return "permit " + text[len("forbid "):]


def _moved(files: dict, src: str, dst: str) -> dict:
    """files with the first policy of `src` moved to the end of `dst`."""
    head, rest = files[src].split("\n", 1)
    return {**files, src: rest, dst: files[dst] + head + "\n"}


def _sequences() -> dict:
    base = _base_files()
    mod1 = {**base, "obj-03.cedar": _flip(base["obj-03.cedar"])}
    return {
        "modify": [[base], [mod1], [{**mod1, "obj-07.cedar": _flip(base["obj-07.cedar"])}]],
        "add": [[base], [{**base, "added.cedar": ADDED}],
                [{**base, "added.cedar": ADDED, "added-2.cedar": _flip(ADDED)}]],
        "delete": [[base], [{k: v for k, v in base.items() if k != "obj-05.cedar"}],
                   [{k: v for k, v in base.items() if k not in ("obj-05.cedar", "obj-11.cedar")}]],
        "move": [[base], [_moved(base, "obj-02.cedar", "obj-09.cedar")], [base]],
        "tier-add": [[base], [FORBID_TIER, base], [FORBID_TIER, mod1]],
        "tier-remove": [[FORBID_TIER, base], [base], [mod1]],
    }


SEQUENCES = _sequences()


class FileTiers:
    """Tier stacks of one package from file specs, with a per-file parse
    cache: an unchanged file keeps its Policy objects across steps."""

    def __init__(self, parse, policy_set_cls):
        self._parse, self._ps = parse, policy_set_cls
        self._cache: dict = {}

    def tiers(self, spec: list) -> list:
        out = []
        for t, files in enumerate(spec):
            ps = self._ps()
            for fname in sorted(files):
                key = (t, fname, files[fname])
                if key not in self._cache:
                    self._cache[key] = self._parse(files[fname], fname)
                for i, p in enumerate(self._cache[key]):
                    ps.add(p, policy_id=f"{fname}.policy{i}")
            out.append(ps)
        return out


def _both():
    return FileTiers(j_parse, JPolicySet), FileTiers(parse_policies, PolicySet)


def _pack_bytes(packed) -> dict:
    arrays = packed_arrays(packed)
    return {k: (arrays[k].dtype.str, arrays[k].shape, arrays[k].tobytes()) for k in PACK_ARRAYS}


def _info_key(info: dict) -> dict:
    return {k: info[k] for k in ("compile_scope", "shards", "dirty_shards", "reused_shards",
                                 "removed_shards", "shard_hashes", "dirty", "policy_shard")}


def _diag_key(result):
    decision, diag = result
    return decision, sorted(r.policy for r in diag.reasons), sorted(diag.errors)


@pytest.fixture(autouse=True)
def _clean_chaos():
    t_chaos().reset()
    j_chaos().reset()
    yield
    t_chaos().reset()
    j_chaos().reset()


# ------------------------------------------------ the compilers, step by step


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_shard_compiler_equals_jax(seq, buckets):
    """Same edits, same plan: scope, dirty set, shard hashes and the
    policy-to-shard map equal the JAX ShardCompiler's at every step (the
    port's map committed after each compile, as a published load does)."""
    jt, tt = _both()
    jsc, tsc = JShardCompiler(buckets=buckets), ShardCompiler(buckets=buckets)
    scopes = []
    for spec in SEQUENCES[seq]:
        _, jinfo = jsc.compile(jt.tiers(spec))
        _, tinfo = tsc.compile(tt.tiers(spec))
        assert _info_key(tinfo) == _info_key(jinfo)
        tsc.commit(tinfo)
        assert sorted(tsc.shard_map()) == sorted(jsc.shard_map())
        scopes.append(tinfo["compile_scope"])
    # one bucket per tier: an edit dirties the tier's only shard, nothing
    # is reused, and the compile counts as full
    assert scopes[0] == "full"
    if buckets > 1:
        want = ["full", "incremental"] if seq.startswith("tier-") else ["incremental"] * 2
        assert scopes[1:] == want


def test_uncommitted_compile_leaves_the_map():
    """compile() alone replaces nothing: a second compile of the same edit
    still sees its shard dirty, until commit()."""
    _, tt = _both()
    seq = SEQUENCES["modify"]
    sc = ShardCompiler(buckets=8)
    _, first = sc.compile(tt.tiers(seq[0]))
    sc.commit(first)
    committed = sc.shard_map()
    _, a = sc.compile(tt.tiers(seq[1]))
    _, b = sc.compile(tt.tiers(seq[1]))
    assert sc.shard_map() == committed
    assert a["dirty"] == b["dirty"] and len(b["dirty"]) == 1
    sc.commit(b)
    _, c = sc.compile(tt.tiers(seq[1]))
    assert (c["compile_scope"], c["dirty"]) == ("incremental", [])


@pytest.mark.parametrize("buckets", BUCKETS)
def test_fingerprints_and_buckets_equal_jax(buckets):
    """The memos on the Policy objects: each policy's content fingerprint
    and bucket equal the JAX package's, and are memoized on the object."""
    jc = j_synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS)
    tc = synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS)
    for jp, tp in zip(jc.policies, tc.policies):
        assert policy_fingerprint(tp) == j_fingerprint(jp)
        assert shard_bucket(tp, buckets) == j_shard_bucket(jp, buckets)
        assert tp.__dict__["_cedar_content_fp"] == policy_fingerprint(tp)
        assert tp.__dict__["_cedar_shard_bucket"] == (buckets, shard_bucket(tp, buckets))


def test_reparsed_unchanged_object_keeps_its_fingerprint():
    """A store that re-parses an unchanged object (a CRD relist) hands back
    new Policy objects of equal fingerprints: their shard stays clean."""
    text = _base_files()["obj-04.cedar"]
    a, b = parse_policies(text, "obj-04.cedar"), parse_policies(text, "obj-04.cedar")
    for i, (p, q) in enumerate(zip(a, b)):
        p.policy_id = q.policy_id = f"obj-04.cedar.policy{i}"
        assert p is not q and policy_fingerprint(p) == policy_fingerprint(q)
    sc = ShardCompiler(buckets=8)
    _, info = sc.compile([PolicySet(a)])
    sc.commit(info)
    _, again = sc.compile([PolicySet(b)])
    assert (again["compile_scope"], again["dirty"]) == ("incremental", [])


# ---------------------------------------------------- the engines, step by step


def _engine_steps(seq: str, buckets: int):
    """Per step of the sequence, once both engines (incremental, over the
    same tier stacks) have loaded it: (JAX engine stats, port stats, JAX
    engine, port engine)."""
    jt, tt = _both()
    je = TPUPolicyEngine(incremental=True, shard_buckets=buckets)
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=buckets)
    for spec in SEQUENCES[seq]:
        jstats = je.load(jt.tiers(spec), warm="off")
        tstats = te.load(tt.tiers(spec))
        yield jstats, tstats, je, te


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_incremental_engine_equals_jax(seq, buckets):
    """Pack bytes, scope, shard counts and the plane lineage of the port's
    incremental engine equal the JAX incremental engine's at every step:
    shard generations and dirty set equal, and the structural id is kept
    exactly where the JAX engine keeps its own."""
    prev = None
    for jstats, tstats, je, te in _engine_steps(seq, buckets):
        jcs, tcs = je._compiled, te.compiled_set
        assert _pack_bytes(tcs.packed) == _pack_bytes(jcs.packed)
        assert [m.policy_id for m in tcs.packed.policy_meta] == \
            [m.policy_id for m in jcs.packed.policy_meta]
        for k in ("compile_scope", "shards", "dirty_shards", "L", "R", "rules"):
            assert tstats[k] == jstats[k], k
        assert tstats["warm_skipped"] is False
        assert set(tstats["compile_seconds"]) == {"hash", "lower", "pack", "place", "warm",
                                                  "total"}
        jp, tp = jcs.plane, tcs.plane
        assert (tp.shard_gens, tp.shard_hashes, tp.policy_shard, tp.scope, tp.dirty) == \
            (jp.shard_gens, jp.shard_hashes, jp.policy_shard, jp.scope, jp.dirty)
        if prev is not None:
            assert (tp.structural == prev[1]) is (jp.structural == prev[0])
        prev = (jp.structural, tp.structural)


@pytest.mark.parametrize("buckets", BUCKETS)
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_incremental_decisions_equal_full_and_jax(seq, buckets):
    """After each edit, the decisions and reason sets (ids, files and
    positions ride the reasons) of the port's incremental engine equal the
    port's full compile's and the JAX incremental engine's."""
    _, full_tt = _both()
    full = TorchPolicyEngine(device="cpu")
    t_items = synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS).sar_items(48, cluster=1)
    t_items += synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS).sar_items(16, cluster=0)
    j_items = j_synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS).sar_items(48, cluster=1)
    j_items += j_synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS).sar_items(16, cluster=0)
    steps = _engine_steps(seq, buckets)
    for spec, (_, _, je, te) in zip(SEQUENCES[seq], steps):
        full.load(full_tt.tiers(spec))
        inc = [_diag_key(r) for r in te.evaluate_batch(t_items)]
        assert inc == [_diag_key(r) for r in full.evaluate_batch(t_items)]
        assert inc == [_diag_key(r) for r in je.evaluate_batch(j_items)]


@pytest.mark.parametrize("buckets", BUCKETS)
def test_unchanged_reload_dirties_nothing(buckets):
    """The same stack again: an incremental load with no dirty shard, the
    generations and structural id kept, as in the JAX engine."""
    jt, tt = _both()
    spec = SEQUENCES["modify"][0]
    je = TPUPolicyEngine(incremental=True, shard_buckets=buckets)
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=buckets)
    for _ in range(2):
        jstats = je.load(jt.tiers(spec), warm="off")
        tstats = te.load(tt.tiers(spec))
    assert (tstats["compile_scope"], tstats["dirty_shards"]) == \
        (jstats["compile_scope"], jstats["dirty_shards"]) == ("incremental", 0)
    assert te.compiled_set.plane.shard_gens == je._compiled.plane.shard_gens
    assert te.shard_status()["dirty"] == []


# --------------------------------------------------------------- lineage


@pytest.mark.parametrize("then", ["full", "incremental"])
def test_rebuild_starts_a_fresh_structural_id(then):
    """rebuild_compiled re-places the serving set under a fresh structural
    id with the same shard generations and hashes (the JAX rebuild); the
    next incremental load cannot continue the rebuilt plane's lineage and
    takes a fresh id again, and still re-lowers only its dirty shards."""
    jt, tt = _both()
    seq = SEQUENCES["modify"]
    je = TPUPolicyEngine(incremental=True, shard_buckets=8)
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=8)
    steps = seq[:1] if then == "full" else seq[:2]
    for spec in steps:
        je.load(jt.tiers(spec), warm="off")
        te.load(tt.tiers(spec))
    before_j, before_t = je._compiled.plane, te.compiled_set.plane
    assert je.rebuild_compiled() is True
    assert te.rebuild_compiled() is not None
    after_j, after_t = je._compiled.plane, te.compiled_set.plane
    assert after_t.structural != before_t.structural
    assert (after_t.shard_gens, after_t.shard_hashes, after_t.scope, after_t.dirty) == \
        (after_j.shard_gens, after_j.shard_hashes, after_j.scope, after_j.dirty) == \
        (before_t.shard_gens, before_t.shard_hashes, "rebuild", ())
    assert te.last_adoption_scope == "rebuild"
    jstats = je.load(jt.tiers(seq[2]), warm="off")
    tstats = te.load(tt.tiers(seq[2]))
    assert (tstats["compile_scope"], tstats["dirty_shards"]) == \
        (jstats["compile_scope"], jstats["dirty_shards"])
    assert te.compiled_set.plane.structural not in (after_t.structural, before_t.structural)
    assert te.compiled_set.plane.shard_gens == je._compiled.plane.shard_gens


def _raise_once(real):
    state = {"armed": True}

    def fn(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected failure after the compile")
        return real(*a, **kw)

    return fn


@pytest.mark.parametrize("point", ["pack", "place", "warm", "hook"])
def test_shard_map_commits_only_on_publish(monkeypatch, point):
    """A load that fails after its compile (at `point`) leaves the serving
    plane, its generation and the shard map as they were; reloading the
    same edited stack then reports the dirty set relative to the serving
    plane (the JAX engine's dirty set for that edit), steps those shards'
    generations, and serves the plane of an incremental load that never
    failed (the JAX engine's pack, byte for byte) with a full compile's
    decisions and reason sets. (An incremental pack is not a full pack
    byte for byte: a re-parsed file's unchanged policies keep their cached
    slices, whose rules assemble after the rest, in both packages.)"""
    jt, tt = _both()
    seq = SEQUENCES["modify"]
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=8)
    je = TPUPolicyEngine(incremental=True, shard_buckets=8)
    te.load(tt.tiers(seq[0]), max_batch=1)
    je.load(jt.tiers(seq[0]), warm="off")
    serving, gen = te.compiled_set, te.load_generation
    committed = {sid: s.content_hash for sid, s in te._shard_compiler.shard_map().items()}
    assert committed == serving.plane.shard_hashes
    if point == "warm":
        monkeypatch.setattr(te, "warmup", _raise_once(te.warmup))
    elif point == "hook":
        monkeypatch.setattr(te, "load_hooks", [_raise_once(lambda cs: None)])
    else:
        name = {"pack": "pack", "place": "compiled_set_from_numpy"}[point]
        monkeypatch.setattr(t_evaluator, name, _raise_once(getattr(t_evaluator, name)))
    with pytest.raises(RuntimeError, match="injected"):
        te.load(tt.tiers(seq[1]), max_batch=1)
    assert te.compiled_set is serving and te.load_generation == gen
    assert {sid: s.content_hash for sid, s in te._shard_compiler.shard_map().items()} == committed
    jstats = je.load(jt.tiers(seq[1]), warm="off")
    tstats = te.load(tt.tiers(seq[1]), max_batch=1)
    assert (tstats["compile_scope"], tstats["dirty_shards"]) == ("incremental", 1)
    assert te.compiled_set.plane.dirty == je._compiled.plane.dirty
    stepped = {sid for sid, g in te.compiled_set.plane.shard_gens.items()
               if serving.plane.shard_gens.get(sid) != g}
    assert stepped == set(te.compiled_set.plane.dirty)
    assert te.compiled_set.plane.structural == serving.plane.structural
    assert _pack_bytes(te.compiled_set.packed) == _pack_bytes(je._compiled.packed)
    full = TorchPolicyEngine(device="cpu")
    full.load(_both()[1].tiers(seq[1]))
    items = synth_corpus(N_POLICIES, seed=SEED, clusters=CLUSTERS).sar_items(64, cluster=1)
    assert [_diag_key(r) for r in te.evaluate_batch(items)] == \
        [_diag_key(r) for r in full.evaluate_batch(items)]


def test_lowering_failure_keeps_the_prior_set():
    """An error at the engine.shard_compile seam (one dirty shard's
    lowering) fails the load: the prior set serves, and the next clean
    reload lands the edit with exactly that shard dirty."""
    _, tt = _both()
    seq = SEQUENCES["modify"]
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=8)
    te.load(tt.tiers(seq[0]))
    serving = te.compiled_set
    t_chaos().configure({"faults": [{"seam": "engine.shard_compile", "kind": "error",
                                     "count": 1}]})
    t_chaos().arm()
    with pytest.raises(ChaosError):
        te.load(tt.tiers(seq[1]))
    t_chaos().disarm()
    assert te.compiled_set is serving and te.load_generation == 1
    stats = te.load(tt.tiers(seq[1]))
    assert (stats["compile_scope"], stats["dirty_shards"]) == ("incremental", 1)


def test_full_compile_engine_reports_no_shards():
    """incremental=False (the library default, the CLI's
    --no-incremental-compile): every load lowers the whole corpus, with no
    hash phase and no shard map; the plane still gets a lineage."""
    _, tt = _both()
    te = TorchPolicyEngine(device="cpu")
    stats = [te.load(tt.tiers(spec)) for spec in SEQUENCES["modify"]]
    assert [(s["compile_scope"], s["shards"], s["dirty_shards"]) for s in stats] == \
        [("full", 0, 0)] * 3
    assert set(stats[0]["compile_seconds"]) == {"lower", "pack", "place", "warm", "total"}
    assert te._shard_compiler is None
    assert te.shard_status()["shards"] == 0 and te.last_adoption_scope == "full"
    # 0 buckets (the CLI's default) means the default, 64, as in the JAX engine
    assert TorchPolicyEngine(device="cpu", shard_buckets=0).shard_buckets == \
        TPUPolicyEngine(shard_buckets=0).shard_buckets == 64


def test_shard_status_document_equals_jax():
    """/debug/engine's shards document: the JAX engine's keys the port
    serves, with equal values but the structural id."""
    jt, tt = _both()
    je = TPUPolicyEngine(incremental=True, shard_buckets=64)
    te = TorchPolicyEngine(device="cpu", incremental=True, shard_buckets=64)
    for spec in SEQUENCES["add"][:2]:
        je.load(jt.tiers(spec), warm="off")
        te.load(tt.tiers(spec))
    jdoc, tdoc = je.shard_status(), te.shard_status()
    assert set(tdoc) == {"scope", "last_adoption_scope", "shards", "dirty", "structural",
                         "hashes", "hashes_truncated"}
    assert {k: tdoc[k] for k in tdoc if k != "structural"} == \
        {k: jdoc[k] for k in tdoc if k != "structural"}
    assert np.sum([len(h) for h in tdoc["hashes"].values()]) == 12 * tdoc["shards"]
