"""--profiling on the port's webhook listener against the JAX server's
``enable_profiling``: ``GET /debug/pprof/profile`` answers a one-second
whole-process sample (header ``# N samples over 1s, 10ms interval``, then
the most frequent stacks), any other ``/debug/pprof/*`` a dump of every
thread (``--- thread`` blocks), and without the flag both answer 404.

The JAX server's sampler reads FrameSummary fields off the frames
traceback.walk_stack yields and raises, so its profile request drops the
connection; the port's reads each frame's code object and answers. The
profile is held to its documented format; the rest to the JAX server."""

from __future__ import annotations

import json
import pathlib
import re
import sys
import urllib.error
import urllib.request

import pytest

from cedar_tpu_torch.cli.webhook import build_server, make_parser

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_rollout import LIVE_POLICIES  # noqa: E402
from test_torch_rollout import _interp_server, _write_dir  # noqa: E402

HEADER = re.compile(r"^# (\d+) samples over 1s, 10ms interval$")


def _port(tmp_path, profiling: bool):
    live = _write_dir(tmp_path / "live", {"p.cedar": LIVE_POLICIES})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"spec": {"stores": [
        {"type": "directory", "directoryStore": {"path": str(live)}}]}}))
    argv = ["--config", str(cfg), "--backend", "interpreter", "--insecure",
            "--secure-port", "0", "--metrics-port", "0"] + (["--profiling"] if profiling else [])
    srv = build_server(make_parser().parse_args(argv))
    srv.start()
    return srv


def _jax(profiling: bool):
    srv = _interp_server("jax", LIVE_POLICIES, address="127.0.0.1", port=0, metrics_port=0,
                         enable_profiling=profiling)
    srv.start()
    return srv


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, ""


def _shape(code, ctype, text, path):
    """What both servers must agree on: the code, the type, and the shape
    of the body (the sampler's header line, or the dump's thread blocks)."""
    if code != 200:
        return code, None, None
    lines = text.splitlines()
    if path.startswith("/debug/pprof/profile"):
        m = HEADER.match(lines[0])
        return code, ctype, bool(m) and 50 <= int(m.group(1)) <= 101
    return code, ctype, lines[0].startswith("--- thread") and text.count("--- thread") >= 2


@pytest.mark.parametrize("profiling", [False, True])
@pytest.mark.parametrize("path", ["/debug/pprof/profile", "/debug/pprof/profile?seconds=1",
                                  "/debug/pprof/goroutine", "/debug/pprof/"])
def test_pprof_routes_equal_jax(tmp_path, profiling, path):
    t, j = _port(tmp_path, profiling), _jax(profiling)
    try:
        got = _shape(*_get(t.bound_port, path), path)
        if not (profiling and path.startswith("/debug/pprof/profile")):
            assert got == _shape(*_get(j.bound_port, path), path)
        assert got[0] == (200 if profiling else 404)
        if profiling:
            assert got == (200, "text/plain", True)
    finally:
        t.stop()
        j.stop()


def test_profile_sees_the_serving_threads(tmp_path):
    """The sampler walks every other thread: the listeners' serve loops
    show up among its stacks, and the handler thread itself does not."""
    t = _port(tmp_path, True)
    try:
        code, _, text = _get(t.bound_port, "/debug/pprof/profile")
        assert code == 200
        assert "serve_forever" in text
        assert " _debug" not in text
        # each stack line is "<file>:<line> <function>"
        stack_lines = [ln.strip() for ln in text.splitlines() if ln.startswith("  ")]
        assert stack_lines and all(re.match(r"^.+:\d+ .+$", ln) for ln in stack_lines)
    finally:
        t.stop()


def test_other_paths_still_404(tmp_path):
    t = _port(tmp_path, True)
    try:
        for path in ("/debug/pprofx", "/v1/authorize", "/debug/engine"):
            code = _get(t.bound_port, path)[0]
            assert code == (200 if path == "/debug/pprofx" else 404), path
    finally:
        t.stop()
