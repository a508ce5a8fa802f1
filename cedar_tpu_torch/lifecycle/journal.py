"""Write-ahead journal for lifecycle transitions (a copy of the JAX
package's lifecycle/journal.py; the file format is the same byte for byte,
so either package replays a journal the other wrote).

Every stage transition is journaled BEFORE the controller's in-memory
state (or any metric/audit record) changes: a controller that dies
between the append and the mutation resumes from a journal that is at
most one transition AHEAD of what it acted on, never behind — replaying
such a record re-enters a stage the driver can safely restart
(controller.py resume()). Appends are flushed per record (JSONL, one
object per line); a torn final line from a mid-write crash is dropped at
replay with a warning rather than poisoning the whole history.

The ``lifecycle.journal`` chaos seam fires at the top of every append:
a ``kill`` rule is the controller-crash drill (the ThreadKilled unwinds
tick() before the record lands), an ``error`` rule is a journal-write
failure (the transition retries under the stage's backoff budget).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional

from ..chaos.registry import chaos_fire

log = logging.getLogger(__name__)

# stages a rollout can never leave (controller.py owns the machine; the
# journal needs the set to answer replay() without importing it)
TERMINAL_STAGES = frozenset({"promoted", "rolled_back", "failed"})


class LifecycleJournal:
    """Append-only JSONL transition log, file-backed (``path``) or
    in-memory (tests, embedded runs). Thread-safe; appends are
    flushed + fsync'd so a crash loses at most the in-flight record."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._mem: List[dict] = []
        self._seq = 0
        self._fh = None
        if path is not None:
            # recover the sequence counter from an existing journal so a
            # resumed controller keeps appending monotonically
            for rec in self._read_file():
                self._seq = max(self._seq, int(rec.get("seq", 0)))
            self._fh = open(path, "a")
            # heal a torn tail: a mid-write crash can leave a final line
            # with no newline; appending onto it would corrupt the NEXT
            # record too, so terminate it first (replay drops the torn
            # line either way)
            if os.path.getsize(path) > 0:
                with open(path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    if f.read(1) != b"\n":
                        self._fh.write("\n")
                        self._fh.flush()

    def append(self, record: dict) -> dict:
        """Durably append one transition record (adds ``seq``); returns
        the record as written. Raises on write failure — the caller's
        transition has NOT happened until this returns."""
        chaos_fire("lifecycle.journal", payload=record)
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, **record}
            if self._fh is not None:
                self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
                self._fh.flush()
                os.fsync(self._fh.fileno())
            else:
                self._mem.append(rec)
        return rec

    def records(self) -> List[dict]:
        """Every journal record, in append order."""
        if self.path is None:
            with self._lock:
                return list(self._mem)
        with self._lock:
            return self._read_file()

    def _read_file(self) -> List[dict]:
        if self.path is None or not os.path.exists(self.path):
            return []
        out: List[dict] = []
        with open(self.path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    # torn tail from a mid-write crash: only acceptable on
                    # the final line; anything earlier is corruption worth
                    # shouting about either way
                    log.warning(
                        "lifecycle journal %s: dropping unparseable "
                        "line %d", self.path, i + 1,
                    )
        return out

    def replay(self) -> Dict[str, dict]:
        """Per-tenant resume view: the last ``applied`` spec document and
        the last recorded stage. Tenants whose last lifecycle record is a
        ``deleted`` event are omitted (their rollout no longer exists)."""
        state: Dict[str, dict] = {}
        for rec in self.records():
            tenant = rec.get("tenant")
            if not tenant:
                continue
            event = rec.get("event")
            if event == "deleted":
                state.pop(tenant, None)
                continue
            entry = state.setdefault(
                tenant, {"stage": "pending", "spec": None, "last": None}
            )
            if event == "applied":
                entry["spec"] = rec.get("spec")
                entry["stage"] = "pending"
            elif rec.get("to"):
                entry["stage"] = rec["to"]
            entry["last"] = rec
        return state

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None


__all__ = ["LifecycleJournal", "TERMINAL_STAGES"]
