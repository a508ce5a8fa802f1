"""Request-recording middleware: persist every POST body for replay (a
copy of the JAX package's server/recorder.py).

Behavior parity with reference internal/server/recorder.go: bodies are
written to ``<dir>/req-<path basename>-<fingerprint>-<unixnano>.json``; the
directory is created if missing and validated to be a directory.

The ``<fingerprint>`` segment is the canonical request fingerprint from
cache/fingerprint.py — the exact key the live decision cache used
for this request — so a recording, its replay, and the cache can never
disagree about request identity (bodies that do not parse are stamped
``unkeyed``). ``sort | uniq`` over the fingerprint field of a recording
directory is the offline view of the cache's reachable hit ratio.
"""

from __future__ import annotations

import logging
import pathlib
import time

from ..cache.fingerprint import recorded_name_parts

log = logging.getLogger(__name__)


class RequestRecorder:
    def __init__(self, recording_dir: str):
        path = pathlib.Path(recording_dir)
        if path.exists() and not path.is_dir():
            raise ValueError(
                f"Recording directory is not a directory: {recording_dir}"
            )
        path.mkdir(parents=True, exist_ok=True)
        self.dir = path

    def record(self, url_path: str, body: bytes) -> None:
        if not body:
            return
        endpoint, fingerprint = recorded_name_parts(url_path, body)
        filename = self.dir / (
            f"req-{endpoint}-{fingerprint}-{time.time_ns()}.json"
        )
        try:
            filename.write_bytes(body)
        except OSError as e:
            log.error("failed to write request file %s: %s", filename, e)
