"""PyTorch policy-evaluation engine: compile, place on the card,
batch-evaluate.

The engine owns the compiled tensor form of a tiered policy set and
evaluates batches of requests on the device. It is a drop-in `evaluate` /
`evaluate_batch` backend for CedarWebhookAuthorizer (same (entities,
request) -> (decision, diagnostics) contract as
TieredPolicyStores.is_authorized), with:

  * hybrid verdict merge: policies the compiler can't lower are evaluated
    by the interpreter per request and merged into a host-side tier walk
    over the device's per-group (first, last) matrices (want_full, the
    first-match kernel);
  * packed fast path: without interpreter fallback the tier walk runs ON
    THE DEVICE and the readback is one uint32 word per request (the words
    path: one match_words_kernel launch per chunk);
  * diagnostics: exact matched-policy sets. The verdict word's multi/err
    bits flag the rows whose word cannot carry every reason; only those
    rows fetch their per-rule bitsets (compacted in the same launch for
    small batches, want_bits; match_bits_arrays otherwise), from which the
    host recovers every determining policy;
  * asynchronous launches: match_arrays_launch enqueues the H2D copies
    (from pinned staging buffers on the card), the kernels and the D2H
    copies and returns a finish() that materializes them, so the native
    fast path (engine/fastpath.py) encodes chunk k+1 while chunk k runs.

Devices: constructed with ``device=None`` the engine runs on CUDA and
raises when CUDA is absent; only an explicit ``device="cpu"`` selects the
CPU, where every kernel wrapper takes its plain version.

Incremental compile (``incremental=True``; compiler/shard.py): a load
re-lowers only the (tier, bucket) shards whose content hash changed and
reassembles the plane from the cached slices; pack, placement and warm-up
stay whole (each set has its own plane, TMA maps and float plane on the
card). Every set carries its shard lineage (``PlaneState``, as the JAX
package's). The shard map a compile produced is committed only once its
set is published, so a load that fails after its compile (placement,
warm-up, a load hook) leaves the map of the plane that serves.

Tier semantics mirror the reference's TieredPolicyStores
(internal/server/store/store.go:25-42): first tier with any explicit
signal (reasons or errors) wins; the last tier's default applies.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos.registry import chaos_fire
from ..compiler.lower import AUTHZ_SCHEMA_INFO, SchemaInfo, lower_tiers
from ..compiler.pack import ERROR_IDX, FORBID_IDX, GROUPS_PER_TIER, PERMIT_IDX, pack
from ..compiler.shard import DEFAULT_SHARD_BUCKETS, ShardCompiler
from ..compiler.table import encode_request_codes
from ..lang.authorize import ALLOW, DENY, Diagnostics, PolicySet, Reason
from ..lang.entities import EntityMap
from ..lang.eval import Env, Request, policy_matches
from ..lang.values import EvalError
from ..ops import cuda_match
from ..ops.match import (
    CODE_DENY,
    CODE_ERROR,
    CODE_NONE,
    INT32_MAX,
    POLICY_NONE,
    WORD_ERR,
    WORD_MULTI,
    compact_flagged_bits,
    flagged_rows,
    lit_matrix_codes,
    match_rules_codes_bits,
    n_groups_of,
)
from ..server.metrics import record_fallback_decision
from .weights import compiled_set_from_numpy, packed_arrays

log = logging.getLogger(__name__)

_BATCH_BUCKETS = (1, 8, 32, 128, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# rows per device launch; larger batches run as several launches
_PIPELINE_SB = 32768
# chunk size of the fast path's encode/device overlap (engine/fastpath.py
# _RawFastPath._CHUNK aliases it)
SERVING_CHUNK = 16384
# above this many rows the fast path skips the in-launch diagnostics
# compaction (want_bits) and fetches flagged rows' bitsets afterwards
# (engine/fastpath.py _BITS_INCALL_MAX aliases it)
BITS_INCALL_MAX = 4096


# process-wide structural plane ids: every full compile (or tier-topology
# change, device rebuild) gets a fresh id, so shard generations of two
# structurally different planes are never compared
_plane_structs = itertools.count(1)


@dataclass
class PlaneState:
    """Shard lineage of one compiled set (the JAX package's PlaneState,
    without its partition and mesh fields, which the port does not serve).

    ``shard_gens`` steps per dirty shard on an incremental reload;
    ``structural`` changes whenever the whole plane is new (full compile,
    tier-topology change, device rebuild). ``shard_added`` keeps, per
    shard of this structural lineage, its last steps as (generation, the
    actions its added policies can apply to, None when unbounded): what
    a decision cached before the step must check (cache/generation.py).
    The dicts are never mutated once the set is published: a load builds
    fresh copies."""

    structural: int
    shard_gens: Dict[str, int] = field(default_factory=dict)
    shard_hashes: Dict[str, str] = field(default_factory=dict)
    policy_shard: Dict[str, str] = field(default_factory=dict)
    scope: str = "full"  # how this plane came to be serving
    dirty: Tuple[str, ...] = ()
    shard_added: Dict[str, tuple] = field(default_factory=dict)


# steps of a shard's history a plane keeps; an older step reads as one of
# unbounded actions, which only costs cached entries
_SHARD_HISTORY = 32


def _round_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_device(device=None) -> torch.device:
    """None -> CUDA (raises without it); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchPolicyEngine: CUDA is not available; pass device='cpu' "
                "to run the plain versions on the CPU"
            )
        return torch.device("cuda")
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"TorchPolicyEngine: {d} requested but CUDA is not available")
    return d


def bits_rule_indices(bits_row: np.ndarray, n_rules: int) -> np.ndarray:
    """Set-bit positions of one uint32 rule-bitset row (little-endian bit
    order), bounded by n_rules: the one decoder of the bits plane, read by
    the engine's diagnostics (_bits_groups) and the explain plane
    (explain/attribution.py sat_from_bits)."""
    bits = np.unpackbits(
        np.ascontiguousarray(bits_row).view(np.uint8), bitorder="little"
    )
    return np.nonzero(bits[:n_rules])[0]


class _StagingPool:
    """Reusable host staging buffers for bucket-padded (codes, extras)
    batches. On the card each buffer is a pinned (page-locked) tensor seen
    through the numpy view the C++ encoder writes into (the view's base is
    the tensor), so the H2D copy is a non_blocking copy from the pinned
    memory itself; on the CPU a plain numpy array.

    A buffer goes back to the pool only after the outputs of the launch
    that read it have materialized (finish(), or the fast path's deferred
    resolve): released at launch time, a later batch could overwrite rows
    an in-flight H2D copy is still reading. A buffer whose batch failed
    after its launch comes back through ``release_after_device``: it waits
    on an event recorded behind the batch's copies on the serving stream
    and returns to the pool once the event has completed (checked at each
    acquire and stats(); nothing blocks on it). Where no event can be
    recorded or queried (a poisoned CUDA context), the buffer is retired
    instead: counted back and dropped, never pooled again.

    stats() records the buffers acquired and not yet returned or retired
    (``outstanding``; 0 at rest, failed batches included), its peak, and
    the buffers waiting on a failed batch's event (``pending``); a peak
    above one batch's buffer count shows that a second batch's staging
    overlapped the first's device work; ``buckets`` lists the row counts
    (batch buckets) of every shape ever acquired."""

    # free buffers kept per (shape, dtype); the working set is a handful of
    # bucket shapes
    _MAX_PER_KEY = 8

    def __init__(self, pinned: bool):
        self._pinned = pinned
        self._free: dict = {}  # (shape, dtype str) -> [ndarray]
        self._lock = threading.Lock()
        self._outstanding = 0
        self._peak_outstanding = 0
        self._acquires = 0
        self._overlapped_acquires = 0
        # (CUDA event, buffers) of failed batches: returned once the event
        # recorded behind their copies has completed
        self._pending: list = []
        self._retired = 0
        # the row counts (batch buckets) of every shape acquired: a bucket
        # the warm-up did not visit shows here once a batch meets it
        self._rows_seen: set = set()

    def acquire(self, shape, dtype) -> np.ndarray:
        self._reap()
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            self._acquires += 1
            if self._outstanding > 0:
                self._overlapped_acquires += 1
            self._outstanding += 1
            self._peak_outstanding = max(self._peak_outstanding, self._outstanding)
            self._rows_seen.add(key[0][0] if key[0] else 0)
            bufs = self._free.get(key)
            if bufs:
                return bufs.pop()
        # the caller fills every row (payload and padding): no zeroing
        if self._pinned:
            tdtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
            return torch.empty(tuple(shape), dtype=tdtype, pin_memory=True).numpy()
        return np.empty(shape, dtype=dtype)

    def release(self, *arrays) -> None:
        with self._lock:
            self._outstanding = max(0, self._outstanding - len(arrays))
            for a in arrays:
                bufs = self._free.setdefault((a.shape, a.dtype.str), [])
                if len(bufs) < self._MAX_PER_KEY:
                    bufs.append(a)

    def retire(self, *arrays) -> None:
        """Count buffers back without pooling them again (their memory goes
        when the last reference does)."""
        with self._lock:
            self._outstanding = max(0, self._outstanding - len(arrays))
            self._retired += len(arrays)

    def release_after_device(self, arrays, device: torch.device) -> None:
        """Return the buffers of a batch that failed after (or during) its
        launch, once no copy can still read them: at once on the CPU, else
        when an event recorded now on ``device``'s current stream (behind
        every copy the batch enqueued: the serving threads all launch on
        the default stream) has completed."""
        if not arrays:
            return
        if device.type != "cuda":
            self.release(*arrays)
            return
        try:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        except Exception:  # noqa: BLE001 — a poisoned context: nothing reads them
            log.warning("staging: no event behind a failed batch's copies; retired")
            self.retire(*arrays)
            return
        with self._lock:
            self._pending.append((event, list(arrays)))

    def _reap(self) -> None:
        """Return the pending buffers whose event has completed; retire
        those whose event cannot be queried."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for event, arrays in pending:
            try:
                done = event.query()
            except Exception:  # noqa: BLE001 — a poisoned context
                self.retire(*arrays)
                continue
            if done:
                self.release(*arrays)
            else:
                keep.append((event, arrays))
        if keep:
            with self._lock:
                self._pending.extend(keep)

    def stats(self) -> dict:
        self._reap()
        with self._lock:
            return {
                "pinned": self._pinned,
                "outstanding": self._outstanding,
                "peak_outstanding": self._peak_outstanding,
                "acquires": self._acquires,
                "overlapped_acquires": self._overlapped_acquires,
                "pending": sum(len(a) for _e, a in self._pending),
                "retired": self._retired,
                "buckets": sorted(self._rows_seen),
            }


class _Readback:
    """Device tensors -> host numpy arrays without blocking the launch:
    on the card each tensor is copied non_blocking into a pinned host
    buffer, and one CUDA event is recorded after the copies on the stream
    they ran on (the launching thread's current stream, captured once:
    the current stream is per thread); arrays() waits on that event before
    the host reads anything, from whichever thread calls it (the serving
    pipeline launches on its dispatch thread and reads on its decode
    thread). On the CPU the tensors already are the host arrays."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            stream = torch.cuda.current_stream(tensors[0].device)
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(stream)
            tensors = host
        self._host = list(tensors)

    def arrays(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class _WordPacker:
    """One D2H copy for the verdict words of every chunk of a batch.

    The fast path launches a batch as several chunks; each registers its
    device words with add(). flush(), once every chunk has launched, cats
    them on the device (a single chunk skips the cat) and starts one
    non_blocking copy into a pinned host buffer (_Readback); view() waits
    on its event and hands each chunk its rows as a view of that one host
    buffer, as uint32."""

    def __init__(self):
        self._parts: list = []  # device word tensors
        self._offsets: list = []
        self._readback: Optional[_Readback] = None
        self._host: Optional[np.ndarray] = None

    @property
    def parts(self) -> int:
        return len(self._parts)

    def add(self, words_dev: torch.Tensor) -> int:
        """Register one chunk's device words; returns its part id."""
        if self._readback is not None:
            raise RuntimeError("_WordPacker: add() after flush()")
        self._offsets.append(
            self._offsets[-1] + self._parts[-1].shape[0] if self._parts else 0
        )
        self._parts.append(words_dev)
        return len(self._parts) - 1

    def flush(self) -> None:
        """Start the packed copy. Idempotent."""
        if self._readback is not None or not self._parts:
            return
        packed = self._parts[0] if len(self._parts) == 1 else torch.cat(self._parts)
        self._readback = _Readback([packed])

    def view(self, part: int, m: int) -> np.ndarray:
        """Rows [0, m) of `part` (uint32), once the copy has landed."""
        self.flush()
        if self._host is None:
            self._host = self._readback.arrays()[0].view(np.uint32)
        lo = self._offsets[part]
        return self._host[lo : lo + m]


class _CompiledSet:
    """Immutable device-resident compiled policy set (the swap unit): the
    K-major rule plane Wt int8 [R, L], thresh / rule_group / rule_policy
    int32 [R] and the activation table act_rows uint8 [V, L] on the
    device, plus the host metadata the decoders read, and the TMA maps of
    the plane that the match kernels encode once (``plane_maps``). Build it
    with engine/weights.py compiled_set_from_numpy."""

    def __init__(
        self, *, Wt, thresh, rule_group, rule_policy, act_rows, n_tiers,
        has_gate, n_rules, policy_meta, device, packed=None,
    ):
        self.packed = packed
        self.device = torch.device(device)
        self.R, self.L = Wt.shape
        self.n_tiers = n_tiers
        self.has_gate = has_gate
        self.n_groups = n_groups_of(n_tiers, has_gate)
        self.n_rules = n_rules
        self.policy_meta = policy_meta
        # host copies for the bitset decode (_bits_groups)
        self.rule_group = rule_group
        self.rule_policy = rule_policy
        self.fallback = list(packed.fallback) if packed is not None else []
        dev = self.device
        self.Wt_dev = torch.from_numpy(Wt).to(dev)
        self.thresh_dev = torch.from_numpy(thresh).to(dev)
        self.rule_group_dev = torch.from_numpy(rule_group).to(dev)
        self.rule_policy_dev = torch.from_numpy(rule_policy).to(dev)
        self.act_rows_dev = torch.from_numpy(act_rows).to(dev)
        self.plane_maps: dict = {}
        self._W_f32: Optional[torch.Tensor] = None
        # shard lineage (PlaneState), set by the engine before it publishes
        self.plane: Optional[PlaneState] = None
        # host state that lives and dies with this set, keyed by its
        # owner: the fast paths keep their native encoder and decode
        # caches here (engine/fastpath.py), so nothing outside the set
        # holds it once the engine has swapped it out
        self.host_state: dict = {}

    @property
    def W_dev(self) -> torch.Tensor:
        """The plane as the match functions take it: W [L, R], the
        transposed view of Wt_dev (no copy)."""
        return self.Wt_dev.t()

    @property
    def W_f32(self) -> torch.Tensor:
        """W [L, R] in float32 (a view of one [R, L] copy made at first
        use): the plane the diagnostics bitsets are scored on (the
        in-launch compaction and match_bits_arrays), so no call converts
        the whole int8 plane again. Four bytes per cell on the device."""
        if self._W_f32 is None:
            self._W_f32 = self.Wt_dev.to(torch.float32).t()
        return self._W_f32

    @property
    def device_bytes(self) -> int:
        """Bytes of the set's tensors on its device (the float plane
        counted once made)."""
        ts = [self.Wt_dev, self.thresh_dev, self.rule_group_dev, self.rule_policy_dev,
              self.act_rows_dev]
        if self._W_f32 is not None:
            ts.append(self._W_f32)
        return sum(t.numel() * t.element_size() for t in ts)


class TorchPolicyEngine:
    def __init__(
        self,
        schema: Optional[SchemaInfo] = None,
        device=None,
        incremental: bool = False,
        shard_buckets: int = DEFAULT_SHARD_BUCKETS,
        name: str = "authorization",
    ):
        """``incremental``: shard-granular compile (module docstring) over
        ``shard_buckets`` buckets per tier (0 or None: the default, 64).
        ``name`` labels the engine's shard gauges on /metrics."""
        self.schema = schema or AUTHZ_SCHEMA_INFO
        self.device = resolve_device(device)
        self.name = name
        self._compiled: Optional[_CompiledSet] = None
        self.load_generation = 0
        self.incremental = bool(incremental)
        self.shard_buckets = int(shard_buckets or DEFAULT_SHARD_BUCKETS)
        self._shard_compiler: Optional[ShardCompiler] = None
        # shard generation values are never reused, so a removed and
        # re-added shard never takes an old generation back
        self._shard_gen_seq = itertools.count(1)
        # the PlaneState of this engine's last published load: the next
        # load continues its lineage only while it still serves
        self._last_plane: Optional[PlaneState] = None
        # how the serving plane last changed: full / incremental / rebuild
        self.last_adoption_scope = "none"
        self._lock = threading.Lock()
        # one load or rebuild at a time, from compile to publish: a rebuild
        # must not publish over a load that landed meanwhile, and two
        # loads must not race (the publish itself takes _lock)
        self._load_lock = threading.Lock()
        # rows whose diagnostics came from rule bitsets (resolve_flagged
        # and the want_full multi rows) since construction
        self.flagged_rows = 0
        # host staging buffers of the fast path and of padded launches
        self._staging = _StagingPool(pinned=self.device.type == "cuda")
        # kernel launches of every warmup() since construction (they do
        # not count in cuda_match.launch_counts(), the served launches)
        self.warmup_launches: dict = {}
        # the batch buckets the last warm-up visited
        self.warm_buckets: tuple = ()
        # called with each new compiled set after its warm-up and before
        # it is published (a fast path builds its native encoder there);
        # a hook that raises fails the load
        self.load_hooks: list = []
        # generation, wall-clock start and publish times and compile
        # seconds of the last successful load
        self.last_load: dict = {}
        # the same of the last successful rebuild_compiled
        self.last_rebuild: dict = {}

    # ------------------------------------------------------------ lifecycle

    def load(self, tiers: Sequence[PolicySet], max_batch: Optional[int] = None,
             analysis_seconds: Optional[float] = None) -> dict:
        """Compile a tiered policy set (in full with lower_tiers, or only
        its dirty shards when the engine is incremental) and pack it,
        place it on the device, warm it there when ``max_batch`` is given
        (``warmup(max_batch, cs=new)`` before anything can serve from it),
        pass it to each of ``load_hooks``, and only then swap it in
        atomically and commit its shard map. A compile, placement, warm-up
        or hook that raises fails the load: the previous set keeps
        serving, ``load_generation`` stays and the shard map stays that of
        the serving set. Loads and rebuild_compiled run one at a time per
        engine. Returns compile stats: the shape, ``compile_scope``
        (full / incremental), ``shards``, ``dirty_shards``,
        ``warm_skipped`` (always False: every set is warmed) and
        ``compile_seconds`` by phase (``hash`` only when incremental;
        ``analyze`` when the caller gives ``analysis_seconds``, the time
        its load-time analysis of ``tiers`` took, which ``total`` leaves
        out)."""
        if not tiers:
            raise ValueError("TorchPolicyEngine.load: at least one tier required")
        with self._load_lock:
            return self._load(tiers, max_batch, analysis_seconds)

    def _load(self, tiers: Sequence[PolicySet], max_batch: Optional[int],
              analysis_seconds: Optional[float] = None) -> dict:
        # the load began with the caller's analysis of these tiers
        started = time.time() - (analysis_seconds or 0.0)
        t0 = time.monotonic()
        seconds = {}
        if analysis_seconds is not None:
            seconds["analyze"] = round(analysis_seconds, 4)
        if self.incremental:
            if self._shard_compiler is None:
                self._shard_compiler = ShardCompiler(self.schema, buckets=self.shard_buckets)
            compiled, info = self._shard_compiler.compile(list(tiers))
            seconds["hash"] = round(info["phase_seconds"]["hash"], 4)
            seconds["lower"] = round(info["phase_seconds"]["lower"], 4)
        else:
            compiled = lower_tiers(list(tiers), self.schema)
            info = {"compile_scope": "full", "shards": 0, "dirty_shards": 0}
            seconds["lower"] = round(time.monotonic() - t0, 4)
        t1 = time.monotonic()
        packed = pack(compiled)
        t2 = time.monotonic()
        new = compiled_set_from_numpy(packed_arrays(packed), self.device, packed)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t3 = time.monotonic()
        # the prior set is the serving one: loads hold the load lock
        new.plane = self._next_plane(self._compiled, info)
        if max_batch is not None:
            self.warmup(max_batch, cs=new)
        for hook in self.load_hooks:
            hook(new)
        t4 = time.monotonic()
        seconds.update(
            pack=round(t2 - t1, 4),
            place=round(t3 - t2, 4),
            warm=round(t4 - t3, 4),
            total=round(t4 - t0, 4),
        )
        scope = info["compile_scope"]
        shards = {"compile_scope": scope, "shards": info["shards"],
                  "dirty_shards": info["dirty_shards"]}
        with self._lock:
            self._compiled = new
            self.load_generation += 1
            self.last_load = {
                "generation": self.load_generation,
                "started_unix": started,
                "published_unix": time.time(),
                "compile_seconds": seconds,
                **shards,
            }
        if self.incremental:
            self._shard_compiler.commit(info)
        self._last_plane = new.plane
        self.last_adoption_scope = scope
        return {
            **compiled.stats(),
            "L": packed.L,
            "R": packed.R,
            "native_opaque_policies": packed.native_opaque,
            **shards,
            "warm_skipped": False,
            "compile_seconds": seconds,
        }

    def _next_plane(self, prior: Optional[_CompiledSet], info: dict) -> PlaneState:
        """PlaneState for a freshly compiled set (the JAX package's
        _next_plane): continue the prior plane's lineage (same structural
        id, the dirty shards' generations stepped) only on an incremental
        compile over the plane this engine's own last load published; a
        rebuild in between broke the lineage, so the set gets a fresh
        structural id."""
        scope = info.get("compile_scope")
        prev_plane = prior.plane if prior is not None else None
        continues = (
            scope == "incremental"
            and prev_plane is not None
            and prev_plane is self._last_plane
        )
        hashes = dict(info.get("shard_hashes", ()))
        added: Dict[str, tuple] = {}
        if continues:
            gens = {sid: g for sid, g in prev_plane.shard_gens.items() if sid in hashes}
            added = {sid: h for sid, h in prev_plane.shard_added.items() if sid in hashes}
            added_actions = info.get("added_actions", {})
            for sid in info.get("dirty", ()):
                if sid in hashes:
                    gens[sid] = next(self._shard_gen_seq)
                    hist = added.get(sid, ()) + ((gens[sid], added_actions.get(sid)),)
                    if len(hist) > _SHARD_HISTORY:
                        hist = ((hist[-_SHARD_HISTORY][0], None),) + hist[1 - _SHARD_HISTORY:]
                    added[sid] = hist
            for sid in hashes:
                # a number is drawn for every shard, as the JAX engine's
                # setdefault draws one, so the generations stay its own
                g = next(self._shard_gen_seq)
                if sid not in gens:
                    gens[sid] = g
                    added[sid] = ((g, None),)
            structural = prev_plane.structural
        else:
            structural = next(_plane_structs)
            gens = {sid: next(self._shard_gen_seq) for sid in hashes}
        return PlaneState(
            structural=structural,
            shard_gens=gens,
            shard_hashes=hashes,
            policy_shard=dict(info.get("policy_shard", ())),
            scope=scope or "full",
            dirty=tuple(info.get("dirty", ())),
            shard_added=added,
        )

    def shard_status(self) -> dict:
        """The /debug/engine shard document: the serving plane's shard
        count and hashes (the first 256, 12 hex digits each), the scope
        and dirty set of the load that made it, and its structural id."""
        cs = self._compiled
        pl = cs.plane if cs is not None else None
        if pl is None:
            return {"scope": self.last_adoption_scope, "shards": 0}
        hashes = dict(sorted(pl.shard_hashes.items())[:256])
        return {
            "scope": pl.scope,
            "last_adoption_scope": self.last_adoption_scope,
            "shards": len(pl.shard_hashes),
            "dirty": list(pl.dirty),
            "structural": pl.structural,
            "hashes": {sid: h[:12] for sid, h in hashes.items()},
            "hashes_truncated": len(pl.shard_hashes) > 256,
        }

    def plane_generation(self):
        """The decision cache's composite-generation unit for this engine
        (cache/generation.py), as the JAX engine's: a PlaneGenerations
        over the serving plane's shard lineage, or ``("unloaded",
        load_generation)`` before the first load. Cheap: it wraps
        references and copies nothing."""
        cs = self._compiled
        if cs is None:
            return ("unloaded", self.load_generation)
        pl = cs.plane
        if pl is None:
            return ("plane", self.load_generation)
        from ..cache.generation import PlaneGenerations

        return PlaneGenerations(("plane", pl.structural), pl.shard_gens, pl.policy_shard,
                                pl.shard_added)

    def rebuild_compiled(self, max_batch: Optional[int] = None) -> Optional[dict]:
        """Re-place the current compiled set on the device from its
        retained host-side pack: the device-loss recovery primitive
        (server/supervisor.py DeviceRecovery). The PackedPolicySet is host
        memory and outlives the device's buffers, so nothing is
        recompiled: a fresh _CompiledSet uploads the plane into new
        allocations, with its own (empty) TMA maps and float plane, so
        nothing of the dead set is reused. With ``max_batch`` every bucket
        is warmed on it (``warmup(max_batch, cs=new)``) and the load hooks
        run before it is published; the fast paths' host state (native
        encoder, decode caches: host memory over the same pack) moves
        across. Runs under the load lock and publishes only if the set it
        re-placed is still current, so a rebuild never reverts a reload;
        bumps ``load_generation``. The rebuilt set keeps the shard
        generations and hashes under a fresh structural id (the JAX
        package's rebuild); the shard map, which describes the same pack,
        stays. Returns {generation, seconds by phase},
        or None when there is no set with a pack to rebuild (or a load
        replaced it). Raises when the device does (a poisoned CUDA context
        fails here): the current set stays."""
        with self._load_lock:
            cs = self._compiled
            if cs is None or cs.packed is None:
                return None
            started = time.time()
            t0 = time.monotonic()
            new = compiled_set_from_numpy(packed_arrays(cs.packed), self.device, cs.packed)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.monotonic()
            new.host_state.update(cs.host_state)
            if cs.plane is not None:
                new.plane = PlaneState(
                    structural=next(_plane_structs),
                    shard_gens=dict(cs.plane.shard_gens),
                    shard_hashes=dict(cs.plane.shard_hashes),
                    policy_shard=cs.plane.policy_shard,
                    scope="rebuild",
                )
            if max_batch is not None:
                self.warmup(max_batch, cs=new)
            for hook in self.load_hooks:
                hook(new)
            t2 = time.monotonic()
            seconds = {
                "place": round(t1 - t0, 4),
                "warm": round(t2 - t1, 4),
                "total": round(t2 - t0, 4),
            }
            with self._lock:
                if self._compiled is not cs:
                    return None
                self._compiled = new
                self.load_generation += 1
                self.last_adoption_scope = "rebuild"
                self.last_rebuild = {
                    "generation": self.load_generation,
                    "started_unix": started,
                    "published_unix": time.time(),
                    "seconds": seconds,
                }
                return dict(self.last_rebuild)

    def warmup(self, max_batch: int = 1, cs: Optional[_CompiledSet] = None) -> dict:
        """Take every device path of a compiled set (``cs``, else the
        serving one) once per batch bucket up to max_batch's, on
        all-padding rows (they activate nothing): the words launch, the
        want_full groups launch and the in-launch bitset compaction, then
        the plain bitset product once. A server warms each set before it
        serves from it, so no request's deadline pays a first-use cost (the
        kernel library's module load, the float product's library handle
        and its kernels per shape, the set's float plane W_f32 and TMA
        maps, each bucket's staging buffers). Its launches count into
        ``warmup_launches``, not into the served launch counts; returns
        this call's."""
        cs = cs or self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        launches = dict.fromkeys(cuda_match.LAUNCHES, 0)
        with cuda_match.counting_into(launches):
            S = cs.packed.table.n_slots if cs.packed is not None else 1
            top = _round_bucket(min(max(max_batch, 1), _PIPELINE_SB), _BATCH_BUCKETS)
            buckets = tuple(b for b in _BATCH_BUCKETS if b <= top)
            for B in buckets:
                codes = np.zeros((B, S), dtype=np.int32)
                extras = np.full((B, 1), cs.L, dtype=np.int32)
                self.match_arrays(codes, extras, cs=cs)
                self.match_arrays(codes, extras, want_full=True, cs=cs)
                if B <= BITS_INCALL_MAX:
                    self.match_arrays_launch(codes, extras, cs=cs, want_bits=True, valid_rows=B)()
            self.match_bits_arrays(codes[:1], extras[:1], cs=cs)
        with self._lock:
            for k, n in launches.items():
                self.warmup_launches[k] = self.warmup_launches.get(k, 0) + n
            self.warm_buckets = buckets
        return launches

    @property
    def loaded(self) -> bool:
        return self._compiled is not None

    @property
    def compiled_set(self) -> Optional[_CompiledSet]:
        return self._compiled

    # ----------------------------------------------------------- evaluation

    def evaluate(
        self, entities: EntityMap, request: Request
    ) -> Tuple[str, Diagnostics]:
        return self.evaluate_batch([(entities, request)])[0]

    def evaluate_batch(
        self, items: Sequence[Tuple[EntityMap, Request]]
    ) -> List[Tuple[str, Diagnostics]]:
        # chaos seam: this path's device launch (the gated rows' re-run
        # and the Python path's batches); an injected fatal error here
        # exercises the breaker and the device recovery as a lost device
        chaos_fire("engine.dispatch")
        cs = self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        if cs.packed is None:
            raise RuntimeError(
                "TorchPolicyEngine: this compiled set carries no encoder "
                "plan; evaluate pre-encoded codes with match_arrays"
            )
        if not items:
            return []
        packed = cs.packed
        encoded = [
            encode_request_codes(packed.plan, packed.table, em, req)
            for em, req in items
        ]
        codes_arr, extras_arr = self._encode_batch_arrays(cs, encoded, len(encoded))

        if cs.fallback:
            # interpreter-fallback policies can flip earlier tiers, so the
            # device tier walk is not authoritative: walk tiers host-side
            # over the (first, last) matrices — exact per-group sets
            # wherever min == max; genuinely multi rows fetch their bitsets
            _, full = self.match_arrays(codes_arr, extras_arr, want_full=True, cs=cs)
            first, last = full
            multi = np.nonzero(((first != last) & (first != INT32_MAX)).any(axis=1))[0]
            bits_groups = {}
            missing = multi.tolist()
            if missing:
                bits = self.match_bits_arrays(
                    codes_arr[missing], extras_arr[missing], cs=cs
                )
                self.flagged_rows += len(missing)
                for k, i in enumerate(missing):
                    bits_groups[i] = self._bits_groups(cs, bits[k])
            return [
                self._finalize_sets(
                    cs,
                    bits_groups.get(i) or self._first_groups(first[i]),
                    em,
                    req,
                )
                for i, (em, req) in enumerate(items)
            ]

        words, _ = self.match_arrays(codes_arr, extras_arr, cs=cs)
        resolved = self.resolve_flagged(words, codes_arr, extras_arr, cs=cs)
        return [
            resolved[i] if i in resolved else self._finalize_packed(cs, int(words[i]))
            for i in range(len(items))
        ]

    def resolve_flagged(
        self,
        words: np.ndarray,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        cs: Optional[_CompiledSet] = None,
    ) -> dict:
        """Resolve rows whose verdict word cannot carry complete
        diagnostics — multiple distinct policies matched the deciding group
        (multi bit) or a policy errored alongside a real match (err bit).
        The flagged rows fetch their rule bitsets in one batched call.
        Returns {row index: (decision, Diagnostics)} with the full
        reason/error sets; rows not in the dict are exactly described by
        their word."""
        cs = cs or self._compiled
        w = words.astype(np.uint32)
        # WORD_GATE is ignored on purpose: this path runs on the Python-
        # encoded side, where hard literals were host-evaluated
        need = np.nonzero((w & (WORD_ERR | WORD_MULTI)) != 0)[0]
        out: dict = {}
        if not need.size:
            return out
        bits = self.match_bits_arrays(codes_arr[need], extras_arr[need], cs=cs)
        self.flagged_rows += int(need.size)
        for k, i in enumerate(need.tolist()):
            groups = self._bits_groups(cs, bits[k])
            out[i] = self._finalize_sets(cs, groups, None, None)
        return out

    def _pad_to_bucket(self, chunk_c, chunk_e, pad_L: int, held: Optional[list] = None):
        """Pad a (codes, extras) chunk up to the next batch bucket. Codes
        pad with 0 (the all-zero activation row), extras with L, so padding
        rows activate nothing. An array already at its bucket passes
        through when it is contiguous. With `held`, copies come from the
        staging pool (pinned on the card) and are appended to it, for the
        caller to release once the launch's outputs have materialized."""
        B = _round_bucket(chunk_c.shape[0], _BATCH_BUCKETS)
        return self._padded(chunk_c, B, 0, held), self._padded(chunk_e, B, pad_L, held)

    def _padded(self, a: np.ndarray, B: int, fill: int, held: Optional[list]) -> np.ndarray:
        if a.shape[0] == B and a.flags["C_CONTIGUOUS"]:
            return a
        if held is None:
            out = np.empty((B, a.shape[1]), dtype=a.dtype)
        else:
            out = self._staging.acquire((B, a.shape[1]), a.dtype)
            held.append(out)
        out[: a.shape[0]] = a
        out[a.shape[0]:] = fill
        return out

    @staticmethod
    def _check_codes(cs: _CompiledSet, codes_arr: np.ndarray) -> None:
        """Feature codes index the activation table on the device, where
        an out-of-range gather is a device-side fault: check on the host."""
        if codes_arr.size and (
            codes_arr.min() < 0 or codes_arr.max() >= cs.act_rows_dev.shape[0]
        ):
            raise ValueError(
                f"feature codes outside [0, {cs.act_rows_dev.shape[0]}): "
                "encoded against another compiled set?"
            )

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """int32 host array -> the engine's device. The copy is
        non_blocking: from a staging buffer (pinned memory) it runs
        asynchronously, so the buffer must stay untouched until the
        launch's outputs have materialized; from pageable memory CUDA
        completes it before returning."""
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32))
        return t.to(self.device, non_blocking=True)

    def staging_stats(self) -> dict:
        """The staging pool's occupancy counters (_StagingPool.stats)."""
        return self._staging.stats()

    @property
    def stats(self) -> dict:
        """The loaded set's shape and device bytes, the staging pool, the
        match kernels' served launch counts (process-wide,
        cuda_match.launch_counts), the warm-ups' launches and the last
        load: the server's /debug/engine entry."""
        with self._lock:
            warmup_launches = dict(self.warmup_launches)
        out = {
            "device": str(self.device),
            "launches": cuda_match.launch_counts(),
            "warmup_launches": warmup_launches,
            "warm_buckets": list(self.warm_buckets),
            "staging": self._staging.stats(),
            "last_load": dict(self.last_load),
            "last_rebuild": dict(self.last_rebuild),
        }
        cs = self._compiled
        if cs is not None:
            out.update(
                rules=cs.n_rules,
                L=cs.L,
                R=cs.R,
                fallback_policies=len(cs.fallback),
                native_opaque_policies=cs.packed.native_opaque if cs.packed else 0,
                device_bytes=cs.device_bytes,
            )
        if self.device.type == "cuda":
            # the process's allocations on the card (every engine's), and
            # what its caching allocator holds of the card's memory
            out["device_memory"] = {
                "allocated": torch.cuda.memory_allocated(self.device),
                "reserved": torch.cuda.memory_reserved(self.device),
            }
        return out

    def match_arrays(
        self,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        want_full: bool = False,
        cs: Optional[_CompiledSet] = None,
    ):
        """Launch and materialize in one call (see match_arrays_launch)."""
        return self.match_arrays_launch(codes_arr, extras_arr, want_full=want_full, cs=cs)()

    def match_arrays_launch(
        self,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        want_full: bool = False,
        cs: Optional[_CompiledSet] = None,
        want_bits: bool = False,
        word_pack: Optional[_WordPacker] = None,
        valid_rows: Optional[int] = None,
    ):
        """Device-match pre-encoded feature codes: codes [n, S], extras
        [n, E] (padded with >= L). Enqueues every sub-batch of at most
        32768 rows (H2D, literal expansion, kernel, D2H) without waiting
        for the device, and returns ``finish()``, which materializes:

          * plain: (words [n] uint32, None), one match_words_kernel launch
            per sub-batch;
          * want_full: (None, (first [n, G], last [n, G]) int32) from
            match_groups_kernel alone, never a words launch; the caller
            walks the tiers on the host;
          * want_bits: a third element, {row: [ceil(R / 32)] uint32
            bitset} for the flagged rows (ops/match.py flagged_rows),
            compacted on the device in the same launch
            (compact_flagged_bits: at most BITS_TOPK rows per sub-batch)
            and copied back with the words. Rows past that are absent;
            the caller fetches theirs with match_bits_arrays.

        `word_pack` (a _WordPacker) registers this launch's words for the
        batch-wide packed D2H copy: the caller flushes it once every chunk
        has launched, and finish() reads its rows from the one host
        buffer. Ignored for want_full and want_bits launches.

        `valid_rows` marks trailing rows as the caller's bucket padding
        (the fast path's staging buffers arrive padded): the want_bits
        compaction skips them. Words come back for every row.

        Staging buffers this call acquires (to pad a sub-batch) go back to
        the pool in finish(), after the outputs have materialized.
        `cs` pins the compiled set the codes were encoded against."""
        cs = cs or self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        self._check_codes(cs, codes_arr)
        n = codes_arr.shape[0]
        use_pack = word_pack is not None and not want_full and not want_bits
        pack = word_pack if use_pack else _WordPacker()
        held: list = []
        outs = []  # (lo, m, words part, full readback, bits readback)
        for lo in range(0, n, _PIPELINE_SB):
            hi = min(lo + _PIPELINE_SB, n)
            v = hi - lo if valid_rows is None else max(0, min(hi, valid_rows) - lo)
            c, e = self._pad_to_bucket(codes_arr[lo:hi], extras_arr[lo:hi], cs.L, held)
            lit = lit_matrix_codes(self._to_device(c), self._to_device(e), cs.act_rows_dev)
            part = full = words = None
            if want_full:
                first, last = cuda_match.match_groups(
                    lit, cs.W_dev, cs.thresh_dev, cs.rule_group_dev,
                    cs.rule_policy_dev, cs.n_groups, plane_maps=cs.plane_maps,
                )
                full = _Readback([first, last])
            else:
                words = cuda_match.match_words(
                    lit, cs.W_dev, cs.thresh_dev, cs.rule_group_dev,
                    cs.rule_policy_dev, cs.n_tiers, cs.has_gate,
                    plane_maps=cs.plane_maps,
                )
                part = pack.add(words)
            bits = None
            if want_bits:
                flagged = flagged_rows(words, None if full is None else (first, last))
                bits = _Readback(
                    compact_flagged_bits(lit, cs.W_f32, cs.thresh_dev, flagged, v)
                )
            outs.append((lo, hi - lo, part, full, bits))
        if not use_pack:
            pack.flush()

        def finish():
            words = full = None
            if not want_full:
                parts = [pack.view(part, m) for _, m, part, _, _ in outs]
                if len(parts) == 1:
                    words = parts[0]
                else:
                    words = np.concatenate(parts) if parts else np.zeros((0,), np.uint32)
            else:
                fl = [f.arrays() for _, _, _, f, _ in outs]
                full = tuple(
                    np.concatenate([a[k][:m] for a, (_, m, _, _, _) in zip(fl, outs)])
                    if outs else np.zeros((0, cs.n_groups), np.int32)
                    for k in (0, 1)
                )
            bitmap: dict = {}
            if want_bits:
                for lo, _, _, _, b in outs:
                    vals, idx, kbits = b.arrays()
                    live = vals > 0
                    for r, row in zip(idx[live].tolist(), kbits[live].view(np.uint32)):
                        bitmap[lo + r] = row
            # the outputs have materialized, so the device has consumed
            # the staged inputs: their buffers may serve the next batch
            if held:
                self._staging.release(*held)
                held.clear()
            return (words, full, bitmap) if want_bits else (words, full)

        # the staging this launch holds until finish(): a caller whose
        # batch fails before finish() hands it back (engine/fastpath.py)
        finish.held = held
        return finish

    def match_bits_arrays(
        self,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        cs: Optional[_CompiledSet] = None,
    ) -> np.ndarray:
        """Launch and materialize in one call (see match_bits_arrays_launch)."""
        return self.match_bits_arrays_launch(codes_arr, extras_arr, cs=cs)()

    def match_bits_arrays_launch(
        self,
        codes_arr: np.ndarray,
        extras_arr: np.ndarray,
        cs: Optional[_CompiledSet] = None,
    ):
        """Per-rule satisfaction bitsets [n, ceil(R / 32)] uint32 for the
        given pre-encoded rows, as a launch and its ``finish()`` (the
        diagnostics path: plain tensor plane, as in the JAX package, where
        it runs in XLA). Used for the flagged rows an in-launch compaction
        does not carry."""
        cs = cs or self._compiled
        if cs is None:
            raise RuntimeError("TorchPolicyEngine: no policy set loaded")
        self._check_codes(cs, codes_arr)
        n = codes_arr.shape[0]
        if n == 0:
            empty = np.zeros((0, -(-cs.R // 32)), dtype=np.uint32)
            return lambda: empty
        outs = []
        for lo in range(0, n, _PIPELINE_SB):
            hi = min(lo + _PIPELINE_SB, n)
            bits = match_rules_codes_bits(
                self._to_device(codes_arr[lo:hi]),
                self._to_device(extras_arr[lo:hi]),
                cs.act_rows_dev,
                cs.W_f32,
                cs.thresh_dev,
            )
            outs.append(_Readback([bits]))

        def finish():
            return np.concatenate([r.arrays()[0] for r in outs]).view(np.uint32)

        return finish

    def _encode_batch_arrays(
        self, cs: _CompiledSet, encoded, B: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pad (codes, extras) pairs into [B, S] and [B, E] int32 arrays."""
        S = cs.packed.table.n_slots
        codes_arr = np.zeros((B, S), dtype=np.int32)
        max_e = max((len(e) for _, e in encoded), default=0)
        if max_e == 0:
            E = 0
        elif max_e <= 256:
            E = _round_bucket(max_e, (8, 16, 32, 64, 128, 256))
        else:  # never truncate: dropping an extra would drop an activation
            E = -(-max_e // 128) * 128
        extras_arr = np.full((B, max(E, 1)), cs.L, dtype=np.int32)
        for i, (c, e) in enumerate(encoded):
            codes_arr[i] = c
            if e:
                extras_arr[i, : len(e)] = e
        return codes_arr, extras_arr

    # ------------------------------------------------- fallback + tier walk

    def _finalize_packed(self, cs: _CompiledSet, word: int) -> Tuple[str, Diagnostics]:
        """Decode one device verdict word (no-fallback fast path)."""
        code = (word >> 30) & 0x3
        pol = word & POLICY_NONE
        if code == CODE_NONE:
            return DENY, Diagnostics()
        meta = cs.policy_meta[pol]
        if code == CODE_ERROR:
            return DENY, Diagnostics(
                reasons=[],
                errors=[f"while evaluating policy `{meta.policy_id}`: evaluation error"],
            )
        reason = Reason(meta.policy_id, meta.filename, meta.position)
        decision = DENY if code == CODE_DENY else ALLOW
        return decision, Diagnostics(reasons=[reason])

    @staticmethod
    def _first_groups(first_row: np.ndarray) -> dict:
        """{group id: [policy index]} from one first-match row — exact when
        every group matched at most one policy (the caller checks)."""
        return {
            g: [int(p)] for g, p in enumerate(first_row.tolist()) if p != INT32_MAX
        }

    @staticmethod
    def _bits_groups(cs: _CompiledSet, bits_row: np.ndarray) -> dict:
        """Decode one rule bitset row -> {group id: [policy indices,
        ascending]} with every matched policy (deduped across the several
        DNF rules one policy may lower to)."""
        idx = bits_rule_indices(bits_row, cs.R)
        pols = cs.rule_policy[idx]
        grps = cs.rule_group[idx]
        valid = pols != INT32_MAX  # padding rules never match; belt and braces
        out: dict = {}
        for g, p in zip(grps[valid].tolist(), pols[valid].tolist()):
            out.setdefault(g, set()).add(p)
        return {g: sorted(s) for g, s in out.items()}

    def _finalize_sets(
        self,
        cs: _CompiledSet,
        groups: dict,
        entities: Optional[EntityMap],
        request: Optional[Request],
    ) -> Tuple[str, Diagnostics]:
        """Host tier walk over COMPLETE per-group policy sets, merged with
        interpreter-fallback verdicts when entities/request are given.
        Mirrors PolicySet.is_authorized + TieredPolicyStores semantics with
        full reason lists."""
        T = cs.n_tiers
        fb_allow: List[List[Reason]] = [[] for _ in range(T)]
        fb_deny: List[List[Reason]] = [[] for _ in range(T)]
        fb_errors: List[List[str]] = [[] for _ in range(T)]
        if cs.fallback and entities is not None:
            # fallback burn-down: this decision is interpreter-merged
            # because the plane carries unlowerable policies; count it
            # under each distinct Unlowerable code, on this engine
            # (cedar_fallback_decisions_total{code,engine}, tallied on
            # /debug/engine and /debug/analysis)
            try:
                record_fallback_decision(
                    cs.packed.fallback_codes if cs.packed is not None else (), self.name
                )
            except Exception:  # noqa: BLE001 — metrics never break serving
                log.exception("recording a fallback decision failed")
            env = Env(request, entities)
            for fp in cs.fallback:
                p = fp.policy
                try:
                    if not policy_matches(p, env):
                        continue
                except EvalError as e:
                    fb_errors[fp.tier].append(
                        f"while evaluating policy `{p.policy_id}`: {e}"
                    )
                    continue
                reason = Reason(p.policy_id, p.filename, p.position)
                (fb_deny if p.effect == "forbid" else fb_allow)[fp.tier].append(reason)

        for t in range(T):
            base = t * GROUPS_PER_TIER
            deny_reasons = [
                self._meta_reason(cs, i) for i in groups.get(base + FORBID_IDX, ())
            ] + fb_deny[t]
            allow_reasons = [
                self._meta_reason(cs, i) for i in groups.get(base + PERMIT_IDX, ())
            ] + fb_allow[t]
            errors = [
                f"while evaluating policy "
                f"`{cs.policy_meta[i].policy_id}`: evaluation error"
                for i in groups.get(base + ERROR_IDX, ())
            ] + fb_errors[t]
            if deny_reasons:
                return DENY, Diagnostics(reasons=deny_reasons, errors=errors)
            if allow_reasons:
                return ALLOW, Diagnostics(reasons=allow_reasons, errors=errors)
            if errors:
                # explicit signal: stops tier descent with a reasonless deny
                return DENY, Diagnostics(reasons=[], errors=errors)
        return DENY, Diagnostics()

    @staticmethod
    def _meta_reason(cs: _CompiledSet, idx: int) -> Reason:
        meta = cs.policy_meta[int(idx)]
        return Reason(meta.policy_id, meta.filename, meta.position)
