"""Wrappers, launch counters and build for the hand-written match kernels
(csrc/match.cu): one tensor-core mainloop (TMA + int8 wgmma) behind two
entry points.

  * ``match_groups`` -> match_groups_kernel: lit @ W, the satisfaction
    compare and the per-group first/last matched policy. The port of
    pallas_first_match (the want_full path).
  * ``match_words`` -> match_words_kernel: the same, with the tier walk
    fused into the epilogue: one launch from literal matrix to packed
    verdict words. The port of pallas_match_words (the serving path).

Operand layout on the card: lit [B, L] int8 contiguous and W [L, R] int8
given as the transposed view ``Wt.t()`` of a contiguous K-major plane
Wt [R, L] (engine/weights.py ``k_major_plane``), with L a multiple of 64
and both base addresses 16-byte aligned. ``kernel_operands`` checks this
and raises; nothing is transposed or copied per call. The plane's TMA
maps are encoded once and kept in the ``plane_maps`` dict the caller
passes (the compiled set's); without one they are encoded per call.

A CPU tensor takes the plain version (ops/match.py), whatever its layout.
A CUDA tensor takes the kernel or raises: there is no fallback from kernel
to plain version.

The kernels are compiled with nvcc for sm_90a at first use, from the
sources under csrc/ only, into ``_build/<hash of sources and flags>/`` next
to this package, and loaded through ctypes (a plain C interface; no
PyTorch headers, so a build takes seconds). Each wrapper adds one to
``LAUNCHES[<kernel>]`` where it launches its kernel and nowhere else;
inside ``counting_into(counts)`` the launches of the calling thread count
into ``counts`` instead (an engine's warm-up of a new plane, while other
threads serve, keeps the served counts to served traffic).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from .match import (
    INT32_MAX,
    first_match_ref,
    match_words_ref,
    n_groups_of,
)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("match.cu",)
LIB_NAME = "libcedar_match.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-ldl",)

# csrc/match.cu: the G limit of the shared-memory epilogue (10 tiers plus
# the gate group), the request rows of a CTA tile, and the literal
# multiple the plane is padded to (a TMA stride is a multiple of 16 bytes;
# a pipeline stage is 128 literals, zero-filled past L)
MAX_GROUPS = 32
TILE_ROWS = 128
L_MULTIPLE = 64
_ALIGN = 16

LAUNCHES = {"match_groups_kernel": 0, "match_words_kernel": 0}
# the serving pipeline launches from two threads (dispatch: the words;
# decode: the gated rows' first-match), so a count is a locked add
_launch_lock = threading.Lock()
# per thread: the dict counting_into() diverts this thread's launches to
_sink = threading.local()

_lib = None
_lib_lock = threading.Lock()
_build_log = ""


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with _launch_lock:
        return dict(LAUNCHES)


@contextlib.contextmanager
def counting_into(counts: dict):
    """Count the calling thread's launches inside the block into
    ``counts`` (kernel name -> launches, added to) instead of LAUNCHES."""
    prev = getattr(_sink, "counts", None)
    _sink.counts = counts
    try:
        yield counts
    finally:
        _sink.counts = prev


def _count_launch(kernel: str) -> None:
    counts = getattr(_sink, "counts", None)
    with _launch_lock:
        if counts is None:
            LAUNCHES[kernel] += 1
        else:
            counts[kernel] = counts.get(kernel, 0) + 1


def build_log() -> str:
    """nvcc's output of the build this process ran ('' when the library
    was already built), including -Xptxas -v register/spill lines."""
    return _build_log


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the match kernels are built "
            "from csrc/ at first use"
        )
    return found


def library_path() -> Path:
    """Where the built library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu into the hash-keyed build directory unless the
    library is already there. The library is written under a temporary
    name and renamed, so concurrent builders never load a partial file."""
    global _build_log
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{_build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.cedar_tensor_map.argtypes = [p, p, ll, ll, i]
            lib.cedar_tensor_map.restype = i
            lib.cedar_match_groups.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.cedar_match_groups.restype = i
            lib.cedar_match_words.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
            lib.cedar_match_words.restype = i
            lib.cedar_error_string.argtypes = [i]
            lib.cedar_error_string.restype = ctypes.c_char_p
            for name, want in (("cedar_max_groups", MAX_GROUPS), ("cedar_tile_rows", TILE_ROWS)):
                getattr(lib, name).restype = i
                if getattr(lib, name)() != want:
                    raise RuntimeError(f"csrc/match.cu {name} disagrees with the wrapper")
            _lib = lib
    return _lib


def _check_launch(lib, rc: int, kernel: str) -> None:
    if rc != 0:
        msg = lib.cedar_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: error {rc} ({msg})")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    every tensor lies on one CUDA device (kernel). Raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the match kernels need CUDA")
    return False


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_operands(
    lit: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
    group: torch.Tensor,
    policy: torch.Tensor,
    n_groups: int,
) -> Tuple[int, int, int]:
    """Check the operands the kernels take and return (B, L, R); raise
    TypeError / ValueError on anything else. Device-independent, so it
    runs (and is tested) on CPU tensors too."""
    if lit.dim() != 2 or W.dim() != 2:
        raise ValueError("lit and W must be 2-D")
    B, L = lit.shape
    R = W.shape[1]
    _require(lit, "lit", torch.int8, (B, L))
    if W.dtype != torch.int8:
        raise TypeError(f"W: expected torch.int8, got {W.dtype}")
    if tuple(W.shape) != (L, R):
        raise ValueError(f"W: expected shape {(L, R)}, got {tuple(W.shape)}")
    if not W.t().is_contiguous():
        raise ValueError(
            "W: must be the transposed view Wt.t() of a contiguous K-major "
            "plane Wt [R, L] (engine/weights.py k_major_plane)"
        )
    if L == 0 or L % L_MULTIPLE:
        raise ValueError(
            f"L = {L}: the plane and lit must be padded to a multiple of "
            f"{L_MULTIPLE} literals (zero columns)"
        )
    if R == 0:
        raise ValueError("the rule plane is empty (R = 0)")
    for name, t in (("lit", lit), ("W", W)):
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name}: base address must be {_ALIGN}-byte aligned (TMA)")
    for name, t in (("thresh", thresh), ("group", group), ("policy", policy)):
        _require(t, name, torch.int32, (R,))
    if not 0 < n_groups <= MAX_GROUPS:
        raise ValueError(f"n_groups must lie in [1, {MAX_GROUPS}], got {n_groups}")
    return B, L, R


def rule_tile(B: int, R: int, n_sm: int) -> int:
    """Rules per CTA on a card of n_sm SMs: 256 when that grid fills four
    waves (less L2 traffic per op), else 128 when its grid fills two, else
    64 (more CTAs stream the plane at once)."""
    row_tiles = -(-B // TILE_ROWS)
    if row_tiles * -(-R // 256) >= 4 * n_sm:
        return 256
    return 128 if row_tiles * -(-R // 128) >= 2 * n_sm else 64


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _plane_map(lib, W: torch.Tensor, bn: int, maps) -> ctypes.Array:
    """W's TMA map with a box of bn rules, from `maps` (the caller's, kept
    with the plane) or encoded now."""
    L, R = W.shape
    key = (W.data_ptr(), R, L, bn)
    m = None if maps is None else maps.get(key)
    if m is None:
        m = ctypes.create_string_buffer(128)
        rc = lib.cedar_tensor_map(m, W.data_ptr(), R, L, bn)
        if rc != 0:
            why = "libcuda.so.1 has no cuTensorMapEncodeTiled" if rc == -1 else f"CUresult {rc}"
            raise RuntimeError(f"TMA map of the [{R}, {L}] int8 plane failed: {why}")
        if maps is not None:
            maps[key] = m
    return m


def match_groups(
    lit: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
    group: torch.Tensor,
    policy: torch.Tensor,
    n_groups: int,
    plane_maps: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """lit [B, L] int8, W [L, R] int8, thresh/group/policy [R] int32 ->
    (first [B, G], last [B, G]) int32: per-group min/max satisfied
    rule_policy (INT32_MAX / -1 = none). On the card one
    match_groups_kernel launch (operands as ``kernel_operands`` says;
    plane_maps as in the module docstring)."""
    if _on_cpu(lit, W, thresh, group, policy):
        return first_match_ref(lit, W, thresh, group, policy, n_groups)
    B, L, R = kernel_operands(lit, W, thresh, group, policy, n_groups)
    out = torch.empty((2, B, n_groups), dtype=torch.int32, device=lit.device)
    first, last = out[0].fill_(INT32_MAX), out[1].fill_(-1)
    if B == 0:
        return first, last
    lib = _load()
    bn = rule_tile(B, R, sm_count(lit.device.index))
    stream = torch.cuda.current_stream(lit.device).cuda_stream
    rc = lib.cedar_match_groups(
        lit.data_ptr(), _plane_map(lib, W, bn, plane_maps), thresh.data_ptr(),
        group.data_ptr(), policy.data_ptr(), first.data_ptr(), last.data_ptr(),
        B, L, R, n_groups, bn, stream,
    )
    _check_launch(lib, rc, "match_groups_kernel")
    _count_launch("match_groups_kernel")
    return first, last


def match_words(
    lit: torch.Tensor,
    W: torch.Tensor,
    thresh: torch.Tensor,
    group: torch.Tensor,
    policy: torch.Tensor,
    n_tiers: int,
    has_gate: bool = False,
    plane_maps: Optional[dict] = None,
) -> torch.Tensor:
    """The serving path: literal matrix -> packed verdict words [B] (int32
    bit pattern). On the card one match_words_kernel launch. Its scratch
    (row-tile arrival counters, first, ~last) and the words are one int32
    tensor filled once with INT32_MAX; the words come back as its tail."""
    if _on_cpu(lit, W, thresh, group, policy):
        return match_words_ref(lit, W, thresh, group, policy, n_tiers, has_gate)
    G = n_groups_of(n_tiers, has_gate)
    B, L, R = kernel_operands(lit, W, thresh, group, policy, G)
    dev = lit.device
    if B == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    head = -(-B // TILE_ROWS) + 2 * B * G
    scratch = torch.full((head + B,), INT32_MAX, dtype=torch.int32, device=dev)
    lib = _load()
    bn = rule_tile(B, R, sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.cedar_match_words(
        lit.data_ptr(), _plane_map(lib, W, bn, plane_maps), thresh.data_ptr(),
        group.data_ptr(), policy.data_ptr(), scratch.data_ptr(),
        B, L, R, n_tiers, int(bool(has_gate)), bn, stream,
    )
    _check_launch(lib, rc, "match_words_kernel")
    _count_launch("match_words_kernel")
    return scratch[head:]
