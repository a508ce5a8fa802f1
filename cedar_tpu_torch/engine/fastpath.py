"""The fast paths: raw SubjectAccessReview and AdmissionReview bytes ->
answers, native end to end.

Fuses the C++ encoder (native/) with the device match: the host never
builds Python entity objects for a well-formed request. Per request the
host work is one C++ JSON parse and a handful of hash lookups, written
straight into pinned staging buffers; the device work is one
match_words_kernel launch per chunk; the readback is 4 bytes per request,
in one D2H copy for the whole batch.

Semantics are those of the exact Python path (CedarWebhookAuthorizer over
the engine; the authorizer's gates run inside the C++ encoder in the same
order as the upstream project's internal/server/authorizer/authorizer.go:38-66).
Rows the native path cannot prove equivalent re-run through the exact
Python path:

  * parse quirks and extras overflow: routed per row by the encoder's flag
    column;
  * rows whose verdict word carries WORD_GATE: the scope of a policy the
    native plane cannot evaluate matched (compiler/pack.py packs one gate
    rule per interpreter-fallback policy and per native-opaque policy), so
    the word is not authoritative; gated rows re-run batched through
    engine.evaluate_batch (the want_full path when the set has
    interpreter-fallback policies).

Nothing else falls back: a native encoder that cannot be built raises, and
so does a device failure. There is no breaker and no degrade to the
Python path for a whole batch.

_RawFastPath holds the chunked pipeline: chunk k+1's C++ encode overlaps
chunk k's device work; clean rows decode once per distinct verdict word;
flagged (multi/err) rows get their rule bitsets from the launch itself
(batches of at most BITS_INCALL_MAX rows) or from one deferred cross-chunk
fetch; gated rows defer to one batched Python re-run. SARFastPath supplies
the SAR-specific pieces (encode, flag routing, per-row fallback, decode);
AdmissionFastPath the admission ones, over the admission tier stack's
engine and CedarAdmissionHandler (server/admission.py): the C++ encoder
walks the review's (old)object, the namespace skip is an encoder gate, and
a deny carries every matched forbid in its message.

The same work is also split into three stages (pipeline_encode /
pipeline_dispatch / pipeline_decode) that engine/batcher.py
PipelinedBatcher runs on separate threads, so batch N+1 encodes while
batch N is on the device. A stage that raises fails its batch; nothing
re-runs it elsewhere.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..lang.authorize import ALLOW, DENY, Diagnostics, Reason
from ..native import (
    F_ADM_ERROR,
    F_ADM_NS_SKIP,
    F_EXTRAS_OVERFLOW,
    F_OK,
    F_PARSE_ERROR,
    F_SELF_ALLOW_POLICIES,
    F_SELF_ALLOW_RBAC,
    F_SYSTEM_SKIP,
    NativeEncoder,
)
from ..ops.match import WORD_ERR, WORD_GATE, WORD_MULTI
from ..entities.admission import AdmissionRequest, review_request_uid
from ..server.admission import AdmissionResponse
from ..server.authorizer import (
    DECISION_ALLOW,
    DECISION_DENY,
    DECISION_NO_OPINION,
    CedarWebhookAuthorizer,
    _diagnostic_to_reason,
    record_to_cedar_resource,
)
from ..server.sar import get_authorizer_attributes
from .evaluator import (
    _BATCH_BUCKETS,
    BITS_INCALL_MAX,
    SERVING_CHUNK,
    TorchPolicyEngine,
    _round_bucket,
    _WordPacker,
)

log = logging.getLogger(__name__)

# (decision, reason, error) results of the encoder's gate flags
# (authorizer.go:38-57)
_GATE_RESULTS = {
    F_SELF_ALLOW_POLICIES: (
        DECISION_ALLOW,
        "cedar authorizer is always allowed to access policies",
        None,
    ),
    F_SELF_ALLOW_RBAC: (
        DECISION_ALLOW,
        "cedar authorizer is always allowed to read RBAC policies",
        None,
    ),
    F_SYSTEM_SKIP: (DECISION_NO_OPINION, "", None),
}

# (decision, reason, error): error non-None mirrors the webhook handler's
# decode-error / evaluation-error response shapes
Result = Tuple[str, str, Optional[str]]

# the routing classes of a batch's rows (_RawFastPath.routing)
ROUTES = ("clean_native", "gated", "flagged", "encoder_fallback", "encoder_gate")


class _Snapshot(NamedTuple):
    """Immutable (encoder, compiled set, caches) tuple that a batch takes
    once and carries through every stage, so a policy hot swap can never
    pair the old encoder's codes with the new compiled set's activation
    table, and cache entries never leak across swaps. The encoder and
    caches live in the set's ``host_state`` (one entry per fast-path
    class, with no reference back to the set): once the engine has
    swapped a set out and the last batch holding its snapshot is done,
    nothing holds the set."""

    encoder: NativeEncoder
    cs: object  # the _CompiledSet the encoder was built on
    reason_cache: dict  # policy index -> reason JSON
    # verdict word -> decoded Result, and feature-row bytes -> flagged-row
    # Result; verdict diversity is tiny, so decode is one dict hit per word
    word_cache: dict


def _chunk_sizes(n: int, chunk: int, tail: int) -> List[int]:
    """Pipeline chunk plan for an n-row batch: full `chunk`s, then the
    remainder, split into equal halves when it exceeds `tail`, so the final
    device wait (which no later encode hides) is at most a half-chunk. The
    split happens only when both halves exceed tail // 2 (BITS_INCALL_MAX
    for the serving constants), so a tail piece never takes the in-launch
    bits compaction."""
    sizes = []
    rem = n
    while rem > chunk:
        sizes.append(chunk)
        rem -= chunk
    if rem > tail and rem - (rem + 1) // 2 > tail // 2:
        half = (rem + 1) // 2
        sizes.extend((half, rem - half))
    elif rem:
        sizes.append(rem)
    return sizes


class _RawFastPath:
    """The chunked raw-bytes pipeline (see the module docstring).

    Subclasses implement `_encode_into`, `_route_flags`, `_fallback_row`,
    `_run_gated`, `_decode_word_payload` and `_decode_bits_payload`, and
    `_emit` where a row's result is not the shared payload itself; the
    snapshot, the chunk overlap, the clean decode and the deferred
    gated/flagged resolve live here."""

    # rows per pipeline chunk: chunk k's device work runs while the host
    # encodes chunk k+1
    _CHUNK = SERVING_CHUNK
    # the last chunk's device work has no later encode to hide behind, so
    # a remainder above this is split in two
    _TAIL_CHUNK = SERVING_CHUNK // 2
    # chunks of at most this many rows get their flagged rows' bitsets
    # from the launch itself (want_bits); larger ones fetch them after
    _BITS_INCALL_MAX = BITS_INCALL_MAX
    # True when _emit returns the payload unchanged (SAR): clean rows then
    # take the shared payload objects in one fancy-index scatter
    _EMIT_IDENTITY = True

    def __init__(self, engine: TorchPolicyEngine):
        self.engine = engine
        self._build_lock = threading.Lock()
        # guards the counters below: the pipeline's encode, dispatch and
        # decode threads and the serial path update them concurrently
        self._stats_lock = threading.Lock()
        # encode / device / decode seconds of the last process_raw call
        self.last_stage_s: dict = {"encode": 0.0, "device": 0.0, "decode": 0.0}
        # rows per routing class since construction (ROUTES)
        self.routing: dict = dict.fromkeys(ROUTES, 0)
        # batch-wide packed word transfers, and the chunk word arrays they
        # carried, since construction (_note_packed)
        self.packed_transfers = 0
        self.packed_chunks = 0

    def _current_snapshot(self) -> _Snapshot:
        """The snapshot for the engine's current compiled set. Raises when
        no set is loaded or the encoder cannot be built.

        Interpreter-fallback policies do not disable the native plane:
        their scopes are packed as gate rules, and rows whose verdict word
        carries WORD_GATE re-run through the exact Python path."""
        cs = self.engine.compiled_set
        if cs is None:
            raise RuntimeError("fast path: the engine has no policy set loaded")
        return self._snapshot_of(cs)

    def _snapshot_of(self, cs) -> _Snapshot:
        """The snapshot of compiled set ``cs``, building its native
        encoder at the set's first use by this fast-path class."""
        key = type(self).__name__
        state = cs.host_state.get(key)  # lock-free: one dict read
        if state is None:
            with self._build_lock:
                # re-read under the lock: another thread may have built it
                state = cs.host_state.get(key)
                if state is None:
                    if cs.packed is None:
                        raise RuntimeError(
                            "fast path: the compiled set carries no encoder plan"
                        )
                    state = (NativeEncoder.create(cs.packed), {}, {})
                    cs.host_state[key] = state
        return _Snapshot(state[0], cs, state[1], state[2])

    def prepare(self) -> None:
        """Build the native encoder for the loaded set now (g++ at first
        use), and for every set the engine loads later before the engine
        publishes it (a load hook), so no request waits for a build.
        Raises as _current_snapshot does."""
        self._current_snapshot()
        if self._snapshot_of not in self.engine.load_hooks:
            self.engine.load_hooks.append(self._snapshot_of)

    # ----------------------------------------------------- subclass surface

    def _encode_into(self, snap: _Snapshot, bodies, codes, extras, counts, flags):
        """C++ encode of one chunk straight into the caller's (staging)
        buffers; returns the path's aux payload (None for SAR)."""
        raise NotImplementedError

    def _route_flags(self, flags, results, bodies, aux) -> np.ndarray:
        """Fill encoder-gate rows into `results`; return the row indices
        that need the per-row Python fallback."""
        raise NotImplementedError

    def _fallback_row(self, body: bytes):
        """Exact Python path for one raw body."""
        raise NotImplementedError

    def _run_gated(self, bodies: List[bytes]) -> list:
        """Exact Python path for gate-flagged rows, batched."""
        raise NotImplementedError

    def _decode_word_payload(self, snap: _Snapshot, word: int):
        """Decode (and cache) the shared result of one clean verdict word."""
        raise NotImplementedError

    def _decode_bits_payload(self, snap: _Snapshot, row_bits):
        """Decode one rule-bitset row into a result."""
        raise NotImplementedError

    def _emit(self, payload, i: int, aux):
        """Render a shared payload into the result of row i (the identity
        unless _EMIT_IDENTITY is False)."""
        return payload

    # ------------------------------------------------------------- pipeline

    def process_raw(self, bodies: Sequence[bytes], snap: _Snapshot) -> list:
        """Evaluate a batch of raw JSON bodies through the native plane.

        Each chunk's C++ encode and asynchronous launch (_prepare_chunk)
        runs while the previous chunk's device work is in flight; every
        chunk's verdict words register with one _WordPacker, flushed into
        a single D2H copy once all chunks have launched; the words then
        materialize and decode in order (_finish_words), and gated and
        flagged rows across all chunks resolve in one deferred pass.
        `last_stage_s` records this call's encode/device/decode split."""
        self.last_stage_s = {"encode": 0.0, "device": 0.0, "decode": 0.0}
        pack = _WordPacker()
        pending = []
        lo = 0
        for size in _chunk_sizes(len(bodies), self._CHUNK, self._TAIL_CHUNK):
            chunk = bodies[lo : lo + size]
            lo += size
            pending.append((chunk, self._prepare_chunk(snap, chunk, word_pack=pack)))
        pack.flush()
        self._note_packed(pack)
        ctxs = [self._finish_words(snap, chunk, pre) for chunk, pre in pending]
        self._resolve_deferred(snap, ctxs)
        return _concat_results(ctxs)

    # ------------------------------------------------- pipelined stage API
    #
    # engine/batcher.py PipelinedBatcher drives these from its threads:
    # pipeline_encode on an encode worker (host only: no launch, no device
    # read), pipeline_dispatch on the one dispatch thread (every launch of
    # the batch, none waited for), pipeline_decode on the decode thread
    # (the only wait on the device, then the decode and the deferred
    # rows). The answers equal process_raw's. A stage that raises
    # propagates: the batcher fails that batch, and nothing re-runs it on
    # another path.

    def _pipeline_ready(self) -> bool:
        """The path's readiness gate (store initial loads), as its serial
        entry point checks it."""
        raise NotImplementedError

    def pipeline_encode(self, bodies: Sequence[bytes]):
        """Stage 1: snapshot, readiness and the C++ encode of every chunk
        into staging buffers. Before every store's initial load completes
        the rows answer from the exact path now (the readiness semantics,
        which evaluates nothing) and the later stages pass them through.
        If a chunk's encode raises, the buffers of the chunks encoded
        before it go back to the pool (no launch has read them)."""
        snap = self._current_snapshot()
        if not self._pipeline_ready():
            return ("direct", [self._fallback_row(b) for b in bodies])
        encs = []
        lo = 0
        try:
            for size in _chunk_sizes(len(bodies), self._CHUNK, self._TAIL_CHUNK):
                chunk = bodies[lo : lo + size]
                lo += size
                encs.append((chunk, self._encode_chunk(snap, chunk)))
        except BaseException:
            for _chunk, enc in encs:
                self.engine._staging.release(*enc[-1])
            raise
        return ("enc", snap, encs)

    def pipeline_dispatch(self, ctx):
        """Stage 2: launch every chunk's match asynchronously, the batch's
        verdict words registered with one _WordPacker whose single D2H
        copy starts once the last chunk is away; returns without waiting,
        so the dispatch thread moves on to the next batch."""
        if ctx[0] == "direct":
            return ctx
        _, snap, encs = ctx
        pack = _WordPacker()
        launched = [
            (chunk, self._launch_chunk(snap, enc, word_pack=pack)) for chunk, enc in encs
        ]
        pack.flush()
        self._note_packed(pack)
        return ("run", snap, launched)

    def pipeline_decode(self, ctx) -> list:
        """Stage 3: wait for the batch's device results, decode the clean
        rows, resolve the gated and flagged rows, and return the results
        in order."""
        if ctx[0] == "direct":
            return ctx[1]
        _, snap, launched = ctx
        ctxs = [self._finish_words(snap, chunk, pre) for chunk, pre in launched]
        self._resolve_deferred(snap, ctxs)
        return _concat_results(ctxs)

    def _note_packed(self, pack: _WordPacker) -> None:
        """Count one batch's packed word transfer (the server's
        cedar_packed_decode_* families read the counts)."""
        if pack.parts:
            with self._stats_lock:
                self.packed_transfers += 1
                self.packed_chunks += pack.parts

    def _record_routing(
        self, n: int, n_fallback: int, n_ok: int, n_gated: int, n_flagged: int
    ) -> None:
        """One chunk's row counts by routing class. The gated share is the
        early warning for the gate-plane cliff: a hot fallback or opaque
        scope sends its rows through the Python path."""
        with self._stats_lock:
            r = self.routing
            r["clean_native"] += n_ok - n_gated - n_flagged
            r["gated"] += n_gated
            r["flagged"] += n_flagged
            r["encoder_fallback"] += n_fallback
            r["encoder_gate"] += n - n_fallback - n_ok

    def _add_stage_s(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self.last_stage_s[stage] += seconds

    def _encode_chunk(self, snap: _Snapshot, bodies: Sequence[bytes]):
        """Host half of a chunk: C++ encode straight into bucket-padded
        buffers from the engine's staging pool (pinned on the card), so the
        codes reach the H2D copy with no intermediate copy. The buffers
        ride the chunk (`held`) and go back to the pool only in the
        deferred resolve, after every readback of the batch has
        materialized. If the encode raises, no launch has read them, and
        they go straight back; an exception after the launch abandons them
        to the GC: a buffer that might still back an in-flight copy never
        re-enters the pool."""
        n = len(bodies)
        staging = self.engine._staging
        pad_L = snap.cs.packed.L
        B = _round_bucket(n, _BATCH_BUCKETS)
        cap = snap.encoder.DEFAULT_EXTRAS_CAP
        codes = staging.acquire((B, snap.encoder.n_slots), np.int32)
        extras = staging.acquire((B, cap), np.int32)
        held = [codes, extras]
        counts = np.empty((n,), np.int32)
        flags = np.empty((n,), np.uint8)
        try:
            aux = self._encode_into(snap, bodies, codes, extras, counts, flags)
        except Exception:
            staging.release(*held)
            raise
        if B != n:
            # bucket padding: all-zero codes activate nothing, extras >= L
            # match nothing
            codes[n:] = 0
            extras[n:] = pad_L
        # an object ndarray: clean rows scatter in one fancy-index store
        results = np.empty(n, dtype=object)
        py_rows = self._route_flags(flags, results, bodies, aux)

        ok = flags == F_OK
        n_ok = int(ok.sum())
        idx = ok_codes = ok_extras = None
        if n_ok:
            all_ok = n_ok == n
            idx = np.arange(n) if all_ok else np.nonzero(ok)[0]
            # trim the extras to the live width (bucketed): most requests
            # carry none, and every column costs the literal expansion
            max_e = int(counts.max(initial=0) if all_ok else counts[idx].max(initial=0))
            E = 1 if max_e == 0 else min(_round_bucket(max_e, (8, 16, 32, 64, 128, 256)), cap)
            if all_ok:
                ok_codes = codes
                ok_extras = extras[:, :E]
            else:
                # compacting to the ok rows copies them out of the pooled
                # buffers, which then never reach the device
                ok_codes = codes[idx]
                ok_extras = extras[idx, :E]
                staging.release(*held)
                held = []
        else:
            staging.release(*held)
            held = []
        return results, py_rows, idx, ok_codes, ok_extras, aux, held

    def _launch_chunk(self, snap: _Snapshot, enc, word_pack=None):
        """Device half of a chunk: launch the encoded rows' match
        asynchronously (the readback happens in _finish_words). Small
        chunks get their flagged rows' bitsets in the same launch;
        `word_pack` routes the words of larger ones into the batch-wide
        packed D2H copy."""
        results, py_rows, idx, ok_codes, ok_extras, aux, held = enc
        fin = None
        if idx is not None:
            fin = self.engine.match_arrays_launch(
                ok_codes, ok_extras, cs=snap.cs,
                want_bits=len(idx) <= self._BITS_INCALL_MAX,
                valid_rows=len(idx),
                word_pack=word_pack,
            )
        return results, py_rows, idx, ok_codes, ok_extras, fin, aux, held

    def _prepare_chunk(self, snap: _Snapshot, bodies: Sequence[bytes], word_pack=None):
        """Encode one chunk natively and launch its device match; the
        device runs while the caller prepares the next chunk."""
        t0 = time.monotonic()
        pre = self._launch_chunk(snap, self._encode_chunk(snap, bodies), word_pack=word_pack)
        self._add_stage_s("encode", time.monotonic() - t0)
        return pre

    def _finish_words(self, snap: _Snapshot, bodies, pre) -> dict:
        """Materialize one chunk's verdict words and decode every clean row
        (one shared result per distinct word). Gate-flagged and multi/err
        rows are recorded for _resolve_deferred; the bitsets of flagged
        rows the launch did not carry are fetched now, asynchronously, so
        the fetch runs while later chunks decode."""
        results, py_rows, idx, ok_codes, ok_extras, fin, aux, held = pre
        for i in py_rows:
            results[i] = self._fallback_row(bodies[i])
        ctx = {
            "results": results,
            "bodies": bodies,
            "idx": idx,
            "aux": aux,
            "ok_codes": ok_codes,
            "ok_extras": ok_extras,
            "held": held,
            "bitmap": None,
            "gate_rows": [],
            "flag_rows": [],
            "flag_keys": {},
            "flag_cached": {},
            "bits_rows": [],
            "bits_fin": None,
        }
        if fin is None:
            self._record_routing(len(bodies), len(py_rows), 0, 0, 0)
            return ctx
        t0 = time.monotonic()
        out = fin()
        words, bitmap = out[0], (out[2] if len(out) == 3 else None)
        t1 = time.monotonic()
        self._add_stage_s("device", t1 - t0)
        # the launch returns words for the bucket-padding rows too
        w = words[: len(idx)]
        ctx["bitmap"] = bitmap
        handled = set()
        if snap.cs.has_gate:
            ctx["gate_rows"] = np.nonzero((w & WORD_GATE) != 0)[0].tolist()
            handled.update(ctx["gate_rows"])
        flagged = np.nonzero((w & (WORD_ERR | WORD_MULTI)) != 0)[0].tolist()
        ctx["flag_rows"] = [k for k in flagged if k not in handled]
        handled.update(ctx["flag_rows"])
        self._record_routing(
            len(bodies), len(py_rows), len(idx), len(ctx["gate_rows"]), len(ctx["flag_rows"])
        )
        # a flagged row's complete reason set is a function of its feature
        # row (codes + extras determine the rule bitset), so rows whose
        # feature bytes were resolved before skip the fetch
        cache = snap.word_cache
        if len(cache) > 200_000:  # growth bound under adversarial traffic;
            cache.clear()  # evict before the membership checks below
        miss = []
        miss_keys = set()  # dedupe repeats within the chunk too
        fkeys = ctx["flag_keys"]
        fc = ctx["flag_cached"]
        for k in ctx["flag_rows"]:
            if bitmap and k in bitmap:
                continue
            key = ok_codes[k].tobytes() + ok_extras[k].tobytes()
            fkeys[k] = key
            cached = cache.get(key)
            if cached is not None:
                # keep the value: an eviction before the resolve must not
                # strand the row
                fc[k] = cached
            elif key not in miss_keys:
                miss.append(k)
                miss_keys.add(key)
        if miss:
            ctx["bits_rows"] = miss
            ctx["bits_fin"] = self.engine.match_bits_arrays_launch(
                ok_codes[miss], ok_extras[miss], cs=snap.cs
            )
        decode = self._decode_word_payload
        emit = self._emit
        if not handled:
            # one payload per distinct word, then one fancy-index scatter
            # (admission rows still build one response per row: each
            # carries its own uid)
            uniq, inv = np.unique(w, return_inverse=True)
            payloads = np.empty(len(uniq), dtype=object)
            for j, word in enumerate(uniq.tolist()):
                payload = cache.get(word)
                if payload is None:
                    payload = decode(snap, word)
                payloads[j] = payload
            if self._EMIT_IDENTITY:
                results[idx] = payloads[inv]
            else:
                row_pay = payloads[inv]
                out = np.empty(len(idx), dtype=object)
                for k, i in enumerate(idx.tolist()):
                    out[k] = emit(row_pay[k], i, aux)
                results[idx] = out
        else:
            wl = w.tolist()
            for k, i in enumerate(idx.tolist()):
                if k in handled:
                    continue
                payload = cache.get(wl[k])
                if payload is None:
                    payload = decode(snap, wl[k])
                results[i] = emit(payload, i, aux)
        self._add_stage_s("decode", time.monotonic() - t1)
        return ctx

    def _resolve_deferred(self, snap: _Snapshot, ctxs: List[dict]) -> None:
        """Resolve every chunk's gate-flagged and multi/err rows in one
        pass: one batched Python re-run for the gated rows and one
        cross-chunk bitset gather for the flagged rows. Then, every device
        readback of the batch having materialized, the chunks' staging
        buffers go back to the pool (an exception above skips this on
        purpose: abandoned buffers are garbage-collected)."""
        gated = [(ctx, k) for ctx in ctxs for k in ctx["gate_rows"]]
        if gated:
            g_res = self._run_gated([ctx["bodies"][int(ctx["idx"][k])] for ctx, k in gated])
            for (ctx, k), res in zip(gated, g_res):
                ctx["results"][int(ctx["idx"][k])] = res

        cache = snap.word_cache
        decode_bits = self._decode_bits_payload
        key_bits = _gather_flag_bits(self.engine, snap, ctxs)
        for ctx in ctxs:
            bm = ctx["bitmap"]
            fc = ctx["flag_cached"]
            fkeys = ctx["flag_keys"]
            for k in ctx["flag_rows"]:
                if bm and k in bm:
                    payload = decode_bits(snap, bm[k])
                elif k in fc:
                    payload = fc[k]
                else:
                    key = fkeys[k]
                    payload = cache.get(key)
                    if payload is None:
                        payload = cache[key] = decode_bits(snap, key_bits[key])
                i = int(ctx["idx"][k])
                ctx["results"][i] = self._emit(payload, i, ctx["aux"])

        staging = self.engine._staging
        for ctx in ctxs:
            if ctx["held"]:
                staging.release(*ctx["held"])
                ctx["held"] = []


def _concat_results(ctxs: List[dict]) -> list:
    if len(ctxs) == 1:
        return ctxs[0]["results"].tolist()
    out: list = []
    for ctx in ctxs:
        out.extend(ctx["results"].tolist())
    return out


def _gather_flag_bits(engine, snap, ctxs) -> dict:
    """Materialize each chunk's bitset fetch and return {feature key:
    bitset row} for every flagged row not covered by an in-launch bitmap
    or a cached result taken at launch time. Duplicate keys share one
    entry; rows whose cache entry was evicted between launch and resolve
    are fetched in one more batched call (never one row at a time)."""
    key_bits: dict = {}
    for ctx in ctxs:
        if ctx["bits_fin"] is not None:
            bits = ctx["bits_fin"]()
            fkeys = ctx["flag_keys"]
            for j, k in enumerate(ctx["bits_rows"]):
                key_bits[fkeys[k]] = bits[j]
    sync_rows: list = []
    for ctx in ctxs:
        bm = ctx["bitmap"]
        fc = ctx["flag_cached"]
        for k in ctx["flag_rows"]:
            if (bm and k in bm) or k in fc:
                continue
            key = ctx["flag_keys"][k]
            if key in key_bits:
                continue
            # claimed here even when the shared cache holds the key now: a
            # concurrent eviction could clear it before the resolve loop
            key_bits[key] = None
            sync_rows.append((ctx, k, key))
    if not sync_rows:
        return key_bits
    E = max(ctx["ok_extras"].shape[1] for ctx, _k, _key in sync_rows)
    codes_rows = np.stack([ctx["ok_codes"][k] for ctx, k, _ in sync_rows])
    extras_rows = np.full(
        (len(sync_rows), E), snap.cs.packed.L, dtype=sync_rows[0][0]["ok_extras"].dtype
    )
    for j, (ctx, k, _) in enumerate(sync_rows):
        row = ctx["ok_extras"][k]
        extras_rows[j, : row.shape[0]] = row
    bits = engine.match_bits_arrays(codes_rows, extras_rows, cs=snap.cs)
    for j, (_ctx, _k, key) in enumerate(sync_rows):
        key_bits[key] = bits[j]
    return key_bits


class SARFastPath(_RawFastPath):
    """Batch evaluator over raw SubjectAccessReview JSON bodies."""

    def __init__(self, engine: TorchPolicyEngine, authorizer: CedarWebhookAuthorizer):
        super().__init__(engine)
        self.authorizer = authorizer

    def authorize_raw(self, bodies: Sequence[bytes]) -> List[Result]:
        """Evaluate a batch of raw SAR JSON bodies -> [(decision, reason,
        error)]. Raises when the native encoder cannot be built or the
        device fails."""
        snap = self._current_snapshot()
        if not self.authorizer.ready():
            # NoOpinion until every store's initial load completes
            # (authorizer.go:58-66); the gates still apply, so every row
            # takes the exact path
            return [self._python_fallback(b) for b in bodies]
        return self.process_raw(bodies, snap)

    def _pipeline_ready(self) -> bool:
        return self.authorizer.ready()

    # --------------------------------------------------------------- hooks

    def _encode_into(self, snap, bodies, codes, extras, counts, flags):
        snap.encoder.encode_batch_into(bodies, codes, extras, counts, flags)
        return None

    def _route_flags(self, flags, results, bodies, aux):
        for flag, res in _GATE_RESULTS.items():
            for i in np.nonzero(flags == flag)[0]:
                results[i] = res
        return np.nonzero((flags == F_PARSE_ERROR) | (flags == F_EXTRAS_OVERFLOW))[0]

    def _fallback_row(self, body: bytes) -> Result:
        return self._python_fallback(body)

    def _run_gated(self, bodies: List[bytes]) -> List[Result]:
        return self._gated_batch(bodies)

    def _decode_word_payload(self, snap: _Snapshot, word: int) -> Result:
        """Decode and cache one clean verdict word (no multi/err/gate bit:
        those rows are handled apart). The deny-on-error log fires once per
        distinct word per snapshot, not once per row."""
        code = (word >> 30) & 0x3
        pol = word & 0xFFFFFF
        if code == 1:
            r: Result = (DECISION_ALLOW, self._reason(snap, pol), None)
        elif code == 2:
            r = (DECISION_DENY, self._reason(snap, pol), None)
        else:
            if code == 3:
                log.error(
                    "Authorize errors: while evaluating policy `%s`: evaluation error",
                    snap.cs.policy_meta[pol].policy_id,
                )
            r = (DECISION_NO_OPINION, "", None)
        snap.word_cache[word] = r
        return r

    def _decode_bits_payload(self, snap: _Snapshot, row_bits) -> Result:
        groups = self.engine._bits_groups(snap.cs, row_bits)
        decision, diag = self.engine._finalize_sets(snap.cs, groups, None, None)
        return self._map_decision(decision, diag)

    # ---------------------------------------------------------- python path

    def _python_fallback(self, body: bytes) -> Result:
        """Exact Python path for one raw body: CedarWebhookAuthorizer.authorize
        over the parsed SAR, with the webhook handler's decode-error and
        conversion-error answers; the evaluation itself may raise."""
        try:
            sar = json.loads(body)
        except (ValueError, TypeError, RecursionError) as e:
            return (
                DECISION_NO_OPINION,
                "Encountered decoding error",
                f"failed parsing request body: {e}",
            )
        authz = self.authorizer
        try:
            attributes = get_authorizer_attributes(sar)
            short = authz._short_circuit(attributes)
            if short is not None:
                return (*short, None)
            entities, request = record_to_cedar_resource(attributes)
        except Exception as e:  # noqa: BLE001 — a malformed request still gets an answer
            log.exception("fastpath python fallback: request conversion failed")
            return DECISION_NO_OPINION, "", f"evaluation error: {e}"
        # an evaluation (device) failure raises to the caller
        return (*authz._map_verdict(*authz._evaluate(entities, request)), None)

    def _gated_batch(self, bodies: Sequence[bytes]) -> List[Result]:
        """Exact Python path for gate-flagged rows, with one batched
        engine.evaluate_batch call. The rows already passed the native
        gates (self-allow / system-skip fire before encoding) and the
        caller checked readiness, so what remains is the entity build, the
        hybrid evaluation and the mapping: per row, authorizer.authorize's
        semantics. An evaluation failure raises."""
        results: List[Optional[Result]] = [None] * len(bodies)
        items = []  # (row, entities, request)
        for i, body in enumerate(bodies):
            try:
                sar = json.loads(body)
            except (ValueError, TypeError, RecursionError) as e:
                results[i] = (
                    DECISION_NO_OPINION,
                    "Encountered decoding error",
                    f"failed parsing request body: {e}",
                )
                continue
            try:
                entities, request = record_to_cedar_resource(get_authorizer_attributes(sar))
            except Exception as e:  # noqa: BLE001 — always answer
                log.exception("fastpath gated entity build failed")
                results[i] = (DECISION_NO_OPINION, "", f"evaluation error: {e}")
                continue
            items.append((i, entities, request))
        if items:
            verdicts = self.engine.evaluate_batch([(em, req) for _, em, req in items])
            for (i, _, _), (decision, diag) in zip(items, verdicts):
                results[i] = self._map_decision(decision, diag)
        return results  # type: ignore[return-value]

    # -------------------------------------------------------------- helpers

    @staticmethod
    def _reason(snap: _Snapshot, pol: int) -> str:
        """Reason JSON of a single-policy match, cached on the snapshot (it
        depends only on the policy index within that compiled set)."""
        r = snap.reason_cache.get(pol)
        if r is None:
            meta = snap.cs.policy_meta[pol]
            r = _diagnostic_to_reason(
                Diagnostics(reasons=[Reason(meta.policy_id, meta.filename, meta.position)])
            )
            snap.reason_cache[pol] = r
        return r

    @staticmethod
    def _map_decision(decision: str, diag) -> Result:
        """Cedar decision -> webhook decision (authorizer.go:75-84)."""
        if decision == ALLOW:
            return DECISION_ALLOW, _diagnostic_to_reason(diag), None
        if decision == DENY and diag.reasons:
            return DECISION_DENY, _diagnostic_to_reason(diag), None
        if diag.errors:
            log.error("Authorize errors: %s", diag.errors)
        return DECISION_NO_OPINION, "", None


class AdmissionFastPath(_RawFastPath):
    """Batch evaluator over raw AdmissionReview JSON bodies: the admission
    twin of SARFastPath. The C++ encoder parses the review and walks the
    (old)object into feature codes (native/encoder.cpp build_adm, the walk
    of entities/admission.py), and the words launch gives the verdicts;
    a deny message lists every matched forbid, as the reference's handler
    (internal/server/admission/handler.go:157-164) does.

    The exact Python path (parse errors, conversion errors, extras
    overflow, gated rows) is CedarAdmissionHandler over the same engine:
    it answers what the handler answers, and an evaluation failure there
    raises, as a device failure on the native rows does."""

    _EMIT_IDENTITY = False

    def __init__(self, engine: TorchPolicyEngine, handler):
        super().__init__(engine)
        self.handler = handler  # CedarAdmissionHandler: Python path + readiness

    def handle_raw(self, bodies: Sequence[bytes]) -> List[AdmissionResponse]:
        """Evaluate a batch of raw AdmissionReview JSON bodies. Raises when
        the native encoder cannot be built or the device fails."""
        snap = self._current_snapshot()
        if not self.handler._ready():
            # every request is allowed until the stores' initial loads
            # complete (handler.go:49-57); the exact path answers that
            return [self._py_one(b) for b in bodies]
        return self.process_raw(bodies, snap)

    def _pipeline_ready(self) -> bool:
        return self.handler._ready()

    # --------------------------------------------------------------- hooks

    def _encode_into(self, snap, bodies, codes, extras, counts, flags):
        return snap.encoder.encode_adm_batch_into(bodies, codes, extras, counts, flags)

    def _route_flags(self, flags, results, bodies, uids):
        for i in np.nonzero(flags == F_ADM_NS_SKIP)[0]:
            results[i] = AdmissionResponse(uid=uids[i], allowed=True)
        return np.nonzero(
            (flags == F_PARSE_ERROR) | (flags == F_ADM_ERROR) | (flags == F_EXTRAS_OVERFLOW)
        )[0]

    def _fallback_row(self, body: bytes) -> AdmissionResponse:
        return self._py_one(body)

    def _run_gated(self, bodies: List[bytes]) -> List[AdmissionResponse]:
        return self._gated_batch(bodies)

    def _decode_word_payload(self, snap: _Snapshot, word: int):
        """(allowed, message) of one clean verdict word, cached per
        snapshot; the error logs fire once per distinct word."""
        code = (word >> 30) & 0x3
        pol = word & 0xFFFFFF
        if code == 1:
            payload = (True, "")
        elif code == 2:
            payload = (False, self._deny_message(snap, (pol,)))
        elif code == 3:
            log.error(
                "admission errors: while evaluating policy `%s`: evaluation error",
                snap.cs.policy_meta[pol].policy_id,
            )
            payload = (False, "")
        else:  # no signal: the allow-all final tier should preclude this
            log.error(
                "request denied without reasons; the default permit "
                "policy was not evaluated"
            )
            payload = (False, "")
        snap.word_cache[word] = payload
        return payload

    def _decode_bits_payload(self, snap: _Snapshot, row_bits):
        groups = self.engine._bits_groups(snap.cs, row_bits)
        decision, diag = self.engine._finalize_sets(snap.cs, groups, None, None)
        if decision == DENY and diag.reasons:
            return False, json.dumps([r.to_dict() for r in diag.reasons], separators=(",", ":"))
        if decision == DENY:
            if diag.errors:
                log.error("admission errors: %s", diag.errors)
            return False, ""
        return True, ""

    def _emit(self, payload, i: int, uids) -> AdmissionResponse:
        return AdmissionResponse(uid=uids[i], allowed=payload[0], message=payload[1])

    # ---------------------------------------------------------- python path

    def _parse_one(self, body: bytes):
        """One raw body -> (request, review, None), or (None, review, error
        response) with the webhook's answers: a body that does not decode
        answers denied with the parse error, a request that does not
        convert the allow-on-error response."""
        review = None
        try:
            review = json.loads(body)
            return AdmissionRequest.from_admission_review(review), review, None
        except (ValueError, TypeError, RecursionError) as e:
            if review is None:
                return None, None, AdmissionResponse(
                    uid="", allowed=False, code=400, error=f"failed parsing body: {e}"
                )
            return None, review, self._allow_on_error(review, e)
        except Exception as e:  # noqa: BLE001 — fail-open like the reference
            log.exception("admission fastpath conversion failed")
            return None, review, self._allow_on_error(review, e)

    def _py_one(self, body: bytes) -> AdmissionResponse:
        """The exact Python path for one raw body; an evaluation failure
        raises."""
        req, _review, err = self._parse_one(body)
        if err is not None:
            return err
        return self.handler.handle(req, raise_errors=True)

    def _gated_batch(self, bodies: Sequence[bytes]) -> List[AdmissionResponse]:
        """The exact Python path for gate-flagged rows, in one
        handler.handle_batch call (one engine.evaluate_batch); per-row
        parse and conversion answers as _py_one's. An evaluation failure
        raises."""
        results: list = [None] * len(bodies)
        reqs = []  # (row, AdmissionRequest)
        for i, body in enumerate(bodies):
            req, _review, err = self._parse_one(body)
            if err is not None:
                results[i] = err
            else:
                reqs.append((i, req))
        if reqs:
            responses = self.handler.handle_batch([r for _, r in reqs], raise_errors=True)
            for (i, _), resp in zip(reqs, responses):
                results[i] = resp
        return results

    def _allow_on_error(self, review, e) -> AdmissionResponse:
        allowed = bool(self.handler.allow_on_error)
        return AdmissionResponse(
            uid=review_request_uid(review),
            allowed=allowed,
            code=200,
            error=f"evaluation error ({'allowed' if allowed else 'denied'} on error): {e}",
        )

    def _deny_message(self, snap: _Snapshot, pols) -> str:
        """Compact JSON list of reason dicts, byte for byte the handler's
        _decide rendering (Reason.to_dict per matched policy)."""
        key = ("adm", tuple(pols))
        msg = snap.reason_cache.get(key)
        if msg is None:
            meta = snap.cs.policy_meta
            msg = json.dumps(
                [
                    Reason(meta[p].policy_id, meta[p].filename, meta[p].position).to_dict()
                    for p in pols
                ],
                separators=(",", ":"),
            )
            snap.reason_cache[key] = msg
        return msg
