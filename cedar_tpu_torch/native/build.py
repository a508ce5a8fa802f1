"""On-demand build of the native encoder library.

Compiles encoder.cpp (beside this file) with the system C++ toolchain
(``g++``, or ``$CXX``) into a shared library under ``native/_build/``,
named by a hash of the source, the ``-march`` choice and, when the
CPython glue is compiled in, the interpreter's ABI tag. Repeated imports
find the library and build nothing.

Process-safe: builders take an exclusive ``fcntl.flock`` on
``_build/lock``, look again for the library under the lock, compile into a
``tempfile.mkstemp`` name and ``os.replace`` it into place, so concurrent
processes (pytest workers, server replicas) never load a partial file and
never race on one temporary name. A failed build raises and is not
remembered: the next call tries again.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import sysconfig
import tempfile
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "encoder.cpp"
BUILD_DIR = SRC.parent / "_build"


def glue_include() -> str:
    """This interpreter's include directory when Python.h is there (the
    *_pylist entries, which read the bodies list in place, are then
    compiled in), else ''."""
    inc = sysconfig.get_paths().get("include")
    if inc and os.path.exists(os.path.join(inc, "Python.h")):
        return inc
    return ""


def _arch() -> str:
    # CEDAR_NATIVE_ARCH=x86-64 (etc.) builds a portable binary; the
    # default tunes for the build machine
    return os.environ.get("CEDAR_NATIVE_ARCH", "native")


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where the library for the current source, arch and glue state
    lives. The glue state is part of the name: the glue compiles CPython
    struct offsets for this interpreter's ABI."""
    glue = bool(glue_include())
    h = hashlib.sha256(SRC.read_bytes())
    h.update(_arch().encode())
    if glue:
        h.update(b"pyglue:" + str(sysconfig.get_config_var("SOABI")).encode())
    tag = "glue_" if glue else ""
    return Path(build_dir or BUILD_DIR) / f"libcedar_native_{tag}{h.hexdigest()[:16]}.so"


def compile_command(glue_inc: str, out: str) -> list:
    """The compiler's argument list for one build into `out`."""
    cmd = [os.environ.get("CXX", "g++"), "-O3", f"-march={_arch()}", "-fno-plt",
           "-std=c++17", "-shared", "-fPIC", "-pthread"]
    if glue_inc:
        cmd += ["-DCEDAR_PY_GLUE", f"-I{glue_inc}"]
    return cmd + [str(SRC), "-o", out]


def _compile(out: Path, glue_inc: str) -> None:
    cxx = os.environ.get("CXX", "g++")
    which = "with the CPython glue (-DCEDAR_PY_GLUE)" if glue_inc else "without the CPython glue"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(compile_command(glue_inc, tmp), capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native encoder build {which}: cannot run {cxx!r}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native encoder build {which} failed ({cxx} exit "
                f"{proc.returncode}):\n{(proc.stdout + proc.stderr)[-4000:]}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_built(build_dir: Optional[Path] = None) -> Path:
    """Compile (once, across processes) and return the library's path;
    raise RuntimeError, naming the build, when the compiler fails or
    cannot be run."""
    out = library_path(build_dir)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.is_file():
                _compile(out, glue_include())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out
