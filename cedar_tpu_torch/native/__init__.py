"""Native (C++) host runtime of the fast paths: raw SubjectAccessReview
and AdmissionReview JSON -> dictionary-coded feature codes.

The port's own copy of the JAX package's native encoder. encoder.cpp
(beside this file; its comments aside, the same source) turns raw request
bytes into the [n_slots] code vector + extras list the device match
consumes, running the authorizer's gates itself, with no Python entity
objects. It is compiled with g++ at first use (native/build.py, process-
safe, into native/_build/) and bound through ctypes: ``NativeEncoder`` is
the Python-facing handle; ``serialize_table`` writes the activation-table
blob it loads.

The admission entries (``encode_adm_batch_into`` / ``encode_adm_batch``)
walk the review's (old)object in C++ the way entities/admission.py walks
it, and hand back each row's review uid (at most 255 bytes: a longer uid
flags the row F_ADM_ERROR, and the caller's Python path answers it).

There is no fallback here: a failed build raises to the caller, and it is
not remembered, so the next call builds again.

Blob format (little-endian; must match BlobReader in encoder.cpp):

  i32 magic "CTB4" (0x43544234)
  i32 n_slots
  3x var sections (principal, action, resource):
      i32 type_slot, i32 uid_slot, i32 n_anc, i32 anc_slots[...]
  type_map:  i32 count, { str key, i32 row }       key = "<v>\\x1f<type>"
  uid_map:   i32 count, { str key, i32 row }       key = "<v>\\x1f<type>\\x1f<id>"
  anc_map:   i32 count, { str key, i32 row, i32 nlits, i32 lits[] }
  slots:     i32 count, { u8 var, u8 deep, str attr, i32 sidx,
                          i32 present_row,
                          vocab:   i32 count, { str canon, i32 row }
                          likes:   i32 count, { i32 lit, i32 ncomps,
                                                { u8 wild, [str chunk] } }
                          cmps:    i32 count, { i32 lit, u8 op, i64 c }
                          set_has: i32 count, { str canon, i32 n, i32 lits[] }
                          dyns:    i32 count, { u8 kind (0 contains, 1 eq,
                                                2 cmp, 3 containsAny,
                                                4 containsAll), u8 op
                                                (eq: 0 == 1 !=; cmp: 0 <
                                                1 <= 2 > 3 >=; else 0),
                                                i32 lit, i32 ok, i32 err,
                                                kind<=2: tmpl
                                                kind>=3: i32 n, { tmpl } }
                          type_err: i32 count, { i32 lit, u8 want-tag } }
  tmpl = u8 kind: 0 const  { str canon }
                | 2 record { i32 n, { str name, tmpl } }   (names sorted)
                | 3 set    { i32 n, { tmpl } }             (sorted at runtime)
                | 4 slot   { u8 var, i32 n, { str comp } } (another request
                            slot's value, resolved per request; kind 1 was
                            the principal-attr special case, subsumed by 4)

  (str = i32 length + bytes)
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..compiler.dyn import DynCmp, DynContainsMulti, DynEq
from ..lang.ast import WILDCARD
from . import build

# flags mirrored from encoder.cpp
F_OK = 0
F_PARSE_ERROR = 1
F_SELF_ALLOW_POLICIES = 2
F_SELF_ALLOW_RBAC = 3
F_SYSTEM_SKIP = 4
F_EXTRAS_OVERFLOW = 5
F_ADM_NS_SKIP = 6  # admission: kube-system/cedar-k8s-authz-system -> allow
F_ADM_ERROR = 7  # admission: conversion error/unsupported shape -> Python path

# bytes per row of the uid buffer the admission entries fill; encoder.cpp
# flags a longer uid F_ADM_ERROR (build_adm)
ADM_UID_BYTES = 256

_VAR_IDX = {"principal": 0, "action": 1, "resource": 2, "context": 3}
_CMP_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3}


def _canon(vk) -> bytes:
    """Canonical byte string for a value_key; must stay in sync with the
    canon_* helpers in encoder.cpp.

    Strings (and entity type/id, and record field names) are LENGTH-
    PREFIXED: request-controlled bytes may contain the \\x1f/\\x1d
    structure separators, and without the prefix a crafted value like
    "x\\x1fsy" would alias a different composite value's canon — a
    decision-flipping false match on the native membership paths."""
    tag = vk[0]
    if tag == "b":
        return b"t" if vk[1] else b"f"
    if tag == "l":
        return b"l%d" % vk[1]
    if tag == "s":
        b = vk[1].encode("utf-8", "surrogatepass")
        return b"s%d:%s" % (len(b), b)
    if tag == "e":
        t = vk[1].encode()
        i = vk[2].encode("utf-8", "surrogatepass")
        return b"e%d:%s%d:%s" % (len(t), t, len(i), i)
    if tag == "S":
        return b"S{" + b"\x1f".join(sorted(_canon(e) for e in vk[1])) + b"}"
    if tag == "R":
        parts = []
        for k, v in vk[1]:
            kb = k.encode("utf-8", "surrogatepass")
            parts.append(b"%d:%s\x1d%s" % (len(kb), kb, _canon(v)))
        return b"R{" + b"\x1f".join(parts) + b"}"
    raise ValueError(f"cannot canonicalize value key {vk!r}")


class _BlobWriter:
    def __init__(self):
        self.parts: List[bytes] = []

    def u8(self, v: int):
        self.parts.append(struct.pack("<B", v))

    def i32(self, v: int):
        self.parts.append(struct.pack("<i", v))

    def i64(self, v: int):
        self.parts.append(struct.pack("<q", v))

    def s(self, b) -> None:
        if isinstance(b, str):
            b = b.encode("utf-8", "surrogatepass")
        self.parts.append(struct.pack("<i", len(b)))
        self.parts.append(b)

    def blob(self) -> bytes:
        return b"".join(self.parts)


def serialize_table(plan, table) -> Optional[bytes]:
    """FeatureTable + EncodePlan -> native blob, or None when the table
    holds value kinds the canon format doesn't cover.

    Hard literals OUTSIDE the dyn-contains class (compiler/dyn.py) do not
    disable the native plane: their lit/ok/err features simply stay
    inactive in native encodes, which can never fire the owning policy's
    rules or error clauses — and every request those rules COULD affect
    matches the policy's scope, which pack() turned into a gate rule, so
    such rows re-run the exact Python path (WORD_GATE)."""
    try:
        return _serialize_table(plan, table)
    except ValueError:
        return None


_TMPL_VAR_CODES = {"principal": 0, "action": 1, "resource": 2, "context": 3}


def _write_tmpl(w: "_BlobWriter", t) -> None:
    kind = t[0]
    if kind == "const":
        w.u8(0)
        w.s(_canon(t[1]))
    elif kind == "slot":
        w.u8(4)
        code = _TMPL_VAR_CODES.get(t[1])
        if code is None:
            raise ValueError(f"unknown template slot var {t[1]!r}")
        w.u8(code)
        w.i32(len(t[2]))
        for comp in t[2]:
            w.s(comp)
    elif kind == "record":
        w.u8(2)
        w.i32(len(t[1]))
        for name, child in t[1]:  # pre-sorted by dyn._tmpl_of
            w.s(name)
            _write_tmpl(w, child)
    elif kind == "set":
        w.u8(3)
        w.i32(len(t[1]))
        for child in t[1]:
            _write_tmpl(w, child)
    else:
        raise ValueError(f"unknown template node {t!r}")


def _serialize_table(plan, table) -> bytes:
    w = _BlobWriter()
    w.i32(0x43544234)
    w.i32(table.n_slots)

    vars3 = ("principal", "action", "resource")
    for var in vars3:
        w.i32(table.var_type_slot.get(var, -1))
        w.i32(table.var_uid_slot.get(var, -1))
        anc = table.anc_slots.get(var, ())
        w.i32(len(anc))
        for a in anc:
            w.i32(a)

    def var_key(var: str, *rest: str) -> bytes:
        return b"\x1f".join(
            [str(_VAR_IDX[var]).encode()] + [r.encode() for r in rest]
        )

    w.i32(len(table.type_vocab))
    for (var, tname), row in table.type_vocab.items():
        w.s(var_key(var, tname))
        w.i32(row)

    w.i32(len(table.uid_vocab))
    for (var, tname, eid), row in table.uid_vocab.items():
        w.s(var_key(var, tname, eid))
        w.i32(row)

    w.i32(len(table.anc_vocab))
    for (var, tname, eid), row in table.anc_vocab.items():
        w.s(var_key(var, tname, eid))
        w.i32(row)
        lits = plan.entity_in_idx.get(var, {}).get((tname, eid), ())
        w.i32(len(lits))
        for lid in lits:
            w.i32(lid)

    w.i32(len(table.scalar_slot_of))
    for slot, sidx in table.scalar_slot_of.items():
        var, path = slot
        w.u8(_VAR_IDX.get(var, 3))
        w.u8(1 if len(path) != 1 else 0)
        w.s(path[0] if len(path) == 1 else "\x1f".join(path))
        w.i32(sidx)
        w.i32(table.present_row[slot])

        vocab = table.scalar_vocab.get(slot, {})
        w.i32(len(vocab))
        for vk, row in vocab.items():
            w.s(_canon(vk))
            w.i32(row)

        likes = plan.like_idx.get(slot, ())
        w.i32(len(likes))
        for lid, pattern in likes:
            w.i32(lid)
            w.i32(len(pattern.components))
            for comp in pattern.components:
                if comp is WILDCARD:
                    w.u8(1)
                else:
                    w.u8(0)
                    w.s(comp)

        cmps = plan.cmp_idx.get(slot, ())
        w.i32(len(cmps))
        for lid, op, c in cmps:
            w.i32(lid)
            w.u8(_CMP_OPS[op])
            w.i64(c)

        sh = plan.set_has_idx.get(slot, {})
        w.i32(len(sh))
        for vk, lits in sh.items():
            w.s(_canon(vk))
            w.i32(len(lits))
            for lid in lits:
                w.i32(lid)

        dyns = [
            (spec, lid, okid, elid)
            for (lid, okid, _expr, elid), spec in zip(
                plan.hard_lits, plan.dyn_specs
            )
            if spec is not None and spec.slot == slot
        ]
        w.i32(len(dyns))
        for spec, lid, okid, elid in dyns:
            if isinstance(spec, DynEq):
                w.u8(1)
                w.u8(1 if spec.negate else 0)
            elif isinstance(spec, DynCmp):
                w.u8(2)
                w.u8(_CMP_OPS[spec.op])
            elif isinstance(spec, DynContainsMulti):
                w.u8(4 if spec.require_all else 3)
                w.u8(0)
            else:
                w.u8(0)
                w.u8(0)
            w.i32(lid)
            w.i32(okid)
            w.i32(elid)
            if isinstance(spec, DynContainsMulti):
                w.i32(len(spec.tmpls))
                for t in spec.tmpls:
                    _write_tmpl(w, t)
            else:
                _write_tmpl(w, spec.tmpl)

        type_errs = plan.type_err_idx.get(slot, ())
        w.i32(len(type_errs))
        for lid, want in type_errs:
            w.i32(lid)
            w.u8(ord(want))

    return w.blob()

_lib = None
_pylib = None  # PyDLL view for the *_pylist entries (None: built without the glue)
_lib_lock = threading.Lock()


def _load_library():
    """Build (native/build.py) and bind the library once per process.
    A failure raises to the caller and is not cached."""
    global _lib, _pylib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = build.ensure_built()
        # ctypes.CDLL's default RTLD_LOCAL mode: the JAX package's copy of
        # this library exports the same symbols, and both may be loaded in
        # one process (the tests)
        lib = ctypes.CDLL(str(path))
        lib.ce_load_table.restype = ctypes.c_void_p
        lib.ce_load_table.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ce_free_table.restype = None
        lib.ce_free_table.argtypes = [ctypes.c_void_p]
        lib.ce_n_slots.restype = ctypes.c_int32
        lib.ce_n_slots.argtypes = [ctypes.c_void_p]
        lib.ce_encode_sar_batch.restype = None
        lib.ce_encode_sar_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
        ]
        lib.ce_encode_adm_batch.restype = None
        lib.ce_encode_adm_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        pylib = None
        if "glue_" in path.name:
            # a PyDLL view of the same library keeps the GIL on entry: the
            # C side reads the bodies list under the GIL, then releases it
            # for the threaded encode
            pylib = ctypes.PyDLL(str(path))
            pylib.ce_encode_sar_pylist.restype = None
            pylib.ce_encode_sar_pylist.argtypes = [
                ctypes.c_void_p,
                ctypes.py_object,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32,
            ]
            pylib.ce_encode_adm_pylist.restype = None
            pylib.ce_encode_adm_pylist.argtypes = [
                ctypes.c_void_p,
                ctypes.py_object,
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
        _pylib = pylib
        _lib = lib
    return _lib


_encode_threads_cache: "Optional[int]" = None
_encode_threads_override: "Optional[int]" = None


def _default_encode_threads() -> int:
    """Per-batch encode thread count. An explicit set_encode_threads()
    override wins; otherwise CEDAR_NATIVE_THREADS pins it (operators
    sharing cores with other tenants); a malformed value is logged ONCE
    and ignored. Default: the host's cores, at most 16. Resolved on first
    use and cached (this runs per batch); reset_encode_threads()
    invalidates the cache."""
    global _encode_threads_cache
    if _encode_threads_override is not None:
        return _encode_threads_override
    if _encode_threads_cache is not None:
        return _encode_threads_cache
    val = 0
    raw = os.environ.get("CEDAR_NATIVE_THREADS", "")
    if raw:
        try:
            env = int(raw)
            if env > 0:
                val = env
        except ValueError:
            logging.getLogger(__name__).warning(
                "ignoring malformed CEDAR_NATIVE_THREADS=%r (want a "
                "positive integer)",
                raw,
            )
    if val <= 0:
        val = min(max(os.cpu_count() or 1, 1), 16)
    _encode_threads_cache = val
    return val


def reset_encode_threads() -> None:
    """Invalidate the cached thread count (and any override): the next
    encode re-reads CEDAR_NATIVE_THREADS."""
    global _encode_threads_cache, _encode_threads_override
    _encode_threads_cache = None
    _encode_threads_override = None


def set_encode_threads(n: Optional[int]) -> None:
    """Pin the per-batch encode thread count, overriding the env var. None
    (or <= 0) clears the override back to env/auto resolution."""
    global _encode_threads_override
    reset_encode_threads()
    if n is not None and n > 0:
        _encode_threads_override = int(n)


class NativeEncoder:
    """Owns one loaded native activation table; encodes raw SAR and
    AdmissionReview JSON batches."""

    DEFAULT_EXTRAS_CAP = 32

    def __init__(self, handle: int, n_slots: int, pad_value: int):
        self._handle = handle
        self.n_slots = n_slots
        self.pad_value = pad_value

    @classmethod
    def create(cls, packed) -> "NativeEncoder":
        """Build the library if needed (raising when it cannot be built)
        and load the activation table of a PackedPolicySet. Raises
        ValueError when the set holds a value kind the blob's canonical
        format does not cover: such a set is served through the
        authorizer's Python path instead. Hard literals outside the dyn
        class do not: their policies gate to the Python path per row (see
        serialize_table)."""
        lib = _load_library()
        blob = serialize_table(packed.plan, packed.table)
        if blob is None:
            raise ValueError(
                "this policy set holds a value kind the native encoder's "
                "table format does not cover"
            )
        handle = lib.ce_load_table(blob, len(blob))
        if not handle:
            raise RuntimeError("native table load failed (blob format skew?)")
        if lib.ce_n_slots(handle) != packed.table.n_slots:
            lib.ce_free_table(handle)
            raise RuntimeError("native table slot count disagrees with the encode plan")
        return cls(handle, packed.table.n_slots, packed.L)

    def __del__(self):
        lib = _lib
        if lib is not None and getattr(self, "_handle", None):
            lib.ce_free_table(self._handle)
            self._handle = None

    @staticmethod
    def _check_out(name: str, arr: np.ndarray, rows: int, width, dtype):
        """Output-buffer contract for encode_batch_into: the C side
        writes through raw pointers with a fixed row stride, so a wrong
        dtype/shape/layout is memory corruption, not an exception."""
        if arr.dtype != np.dtype(dtype):
            raise ValueError(f"{name}: want dtype {np.dtype(dtype)}, got {arr.dtype}")
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError(f"{name}: buffer must be C-contiguous")
        if arr.shape[0] < rows:
            raise ValueError(f"{name}: {arr.shape[0]} rows < batch size {rows}")
        if width is not None and (arr.ndim != 2 or arr.shape[1] != width):
            raise ValueError(f"{name}: want shape [>= {rows}, {width}], got {arr.shape}")

    def encode_batch_into(
        self,
        bodies: Sequence[bytes],
        codes: np.ndarray,
        extras: np.ndarray,
        counts: np.ndarray,
        flags: np.ndarray,
        n_threads: int = 0,
    ) -> int:
        """Encode raw SAR bodies straight into caller-provided buffers (the
        engine's pooled staging buffers, pinned on the card, so the H2D
        copy reads them in place).

        codes [B >= n, n_slots] int32 and extras [B >= n, cap] int32 must
        be C-contiguous; counts [>= n] int32, flags [>= n] uint8. Only the
        first len(bodies) rows are written (extras rows are pad-filled to
        the buffer's cap); rows beyond that (bucket padding) are the
        caller's to fill. Returns the encoded row count."""
        lib = _load_library()
        n = len(bodies)
        if n_threads <= 0:
            n_threads = _default_encode_threads()
        self._check_out("codes", codes, n, self.n_slots, np.int32)
        extras_cap = extras.shape[1] if extras.ndim == 2 else 0
        self._check_out("extras", extras, n, extras_cap, np.int32)
        self._check_out("counts", counts, n, None, np.int32)
        self._check_out("flags", flags, n, None, np.uint8)
        if n == 0:
            return 0
        c_codes = codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_extras = extras.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_counts = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_flags = flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if _pylib is not None and type(bodies) is list:
            # the C side reads the bytes objects in place (no join, no
            # per-item length loop) and pad-fills every row's unused
            # extras cells itself
            _pylib.ce_encode_sar_pylist(
                self._handle,
                bodies,
                n,
                c_codes,
                c_extras,
                extras_cap,
                self.pad_value,
                c_counts,
                c_flags,
                n_threads,
            )
            return n
        # packed-buffer entry: extras arrives caller-pre-padded (the C
        # side only writes consumed cells)
        extras[:n] = self.pad_value
        buf = b"".join(bodies)
        lens = np.fromiter((len(b) for b in bodies), dtype=np.uint64, count=n)
        offsets = np.zeros((n,), dtype=np.uint64)
        np.cumsum(lens[:-1], out=offsets[1:])
        lib.ce_encode_sar_batch(
            self._handle,
            n,
            buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            c_codes,
            c_extras,
            extras_cap,
            c_counts,
            c_flags,
            n_threads,
        )
        return n

    def encode_batch(
        self,
        bodies: Sequence[bytes],
        extras_cap: int = DEFAULT_EXTRAS_CAP,
        n_threads: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Raw SAR JSON bodies -> (codes [n, S] int32, extras [n, cap] int32
        pre-padded with pad_value, extras_count [n], flags [n]).

        flags: F_OK rows are device-ready; gate rows (self-allow / system
        skip) carry the decision; F_PARSE_ERROR / F_EXTRAS_OVERFLOW rows
        need the caller's Python path."""
        n = len(bodies)
        if n == 0:
            return (
                np.zeros((0, self.n_slots), np.int32),
                np.full((0, extras_cap), self.pad_value, np.int32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.uint8),
            )
        # every cell of the first n rows is written by the C side (or the
        # packed-entry pre-pad in encode_batch_into): np.empty is safe
        codes = np.empty((n, self.n_slots), dtype=np.int32)
        extras = np.empty((n, extras_cap), dtype=np.int32)
        counts = np.empty((n,), dtype=np.int32)
        flags = np.empty((n,), dtype=np.uint8)
        self.encode_batch_into(bodies, codes, extras, counts, flags, n_threads)
        return codes, extras, counts, flags

    def encode_adm_batch_into(
        self,
        bodies: Sequence[bytes],
        codes: np.ndarray,
        extras: np.ndarray,
        counts: np.ndarray,
        flags: np.ndarray,
        n_threads: int = 0,
    ) -> List[str]:
        """Admission twin of encode_batch_into: encode raw AdmissionReview
        bodies into caller-provided buffers (the same shape and layout
        contract) and return the rows' review uids (F_OK and F_ADM_NS_SKIP
        rows; "" on rows the caller's Python path answers). Only the first
        len(bodies) rows are written; bucket-padding rows are the caller's
        to fill."""
        lib = _load_library()
        n = len(bodies)
        if n_threads <= 0:
            n_threads = _default_encode_threads()
        self._check_out("codes", codes, n, self.n_slots, np.int32)
        extras_cap = extras.shape[1] if extras.ndim == 2 else 0
        self._check_out("extras", extras, n, extras_cap, np.int32)
        self._check_out("counts", counts, n, None, np.int32)
        self._check_out("flags", flags, n, None, np.uint8)
        if n == 0:
            return []
        uid_buf = ctypes.create_string_buffer(n * ADM_UID_BYTES)
        uid_lens = np.zeros((n,), dtype=np.int32)
        c_codes = codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_extras = extras.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_counts = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_flags = flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        c_uid_lens = uid_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if _pylib is not None and type(bodies) is list:
            _pylib.ce_encode_adm_pylist(
                self._handle,
                bodies,
                n,
                c_codes,
                c_extras,
                extras_cap,
                self.pad_value,
                c_counts,
                c_flags,
                uid_buf,
                c_uid_lens,
                n_threads,
            )
        else:
            extras[:n] = self.pad_value  # packed entry: the caller pre-pads
            buf = b"".join(bodies)
            lens = np.fromiter((len(b) for b in bodies), dtype=np.uint64, count=n)
            offsets = np.zeros((n,), dtype=np.uint64)
            np.cumsum(lens[:-1], out=offsets[1:])
            lib.ce_encode_adm_batch(
                self._handle,
                n,
                buf,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                c_codes,
                c_extras,
                extras_cap,
                c_counts,
                c_flags,
                uid_buf,
                c_uid_lens,
                n_threads,
            )
        raw = uid_buf.raw
        w = ADM_UID_BYTES
        return [
            raw[i * w : i * w + int(uid_lens[i])].decode("utf-8", "replace")
            for i in range(n)
        ]

    def encode_adm_batch(
        self,
        bodies: Sequence[bytes],
        extras_cap: int = DEFAULT_EXTRAS_CAP,
        n_threads: int = 0,
    ):
        """Raw AdmissionReview JSON bodies -> (codes, extras, extras_count,
        flags, uids): encode_batch's contract plus uids[i], the review uid
        of F_OK / F_ADM_NS_SKIP rows. F_PARSE_ERROR / F_ADM_ERROR /
        F_EXTRAS_OVERFLOW rows need the caller's Python path."""
        n = len(bodies)
        if n == 0:
            return (
                np.zeros((0, self.n_slots), np.int32),
                np.full((0, extras_cap), self.pad_value, np.int32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.uint8),
                [],
            )
        codes = np.empty((n, self.n_slots), dtype=np.int32)
        extras = np.empty((n, extras_cap), dtype=np.int32)
        counts = np.empty((n,), dtype=np.int32)
        flags = np.empty((n,), dtype=np.uint8)
        uids = self.encode_adm_batch_into(bodies, codes, extras, counts, flags, n_threads)
        return codes, extras, counts, flags, uids
