"""Poison-object quarantine: last-known-good retention bookkeeping.

A directory *.cedar file that stops parsing must degrade, not wedge: the
store keeps serving the file's previous good content (or drops only that
file) and records the poison here, with the parse error and a failure
count. Entries clear when the object loads cleanly again or is deleted.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class QuarantineRegistry:
    def __init__(self):
        self._items: dict = {}  # (component, name) -> entry dict
        self._lock = threading.Lock()

    def quarantine(self, component: str, name: str, reason: str) -> None:
        """Record (or refresh) one poisoned object. ``reason`` is the
        parse error text, truncated."""
        with self._lock:
            entry = self._items.get((component, name))
            if entry is None:
                entry = {
                    "component": component,
                    "name": name,
                    "since_unix": round(time.time(), 3),
                    "failures": 0,
                }
                self._items[(component, name)] = entry
                log.error("quarantined %s object %r: %s", component, name, reason)
            entry["failures"] += 1
            entry["reason"] = str(reason)[:500]

    def clear(self, component: str, name: str) -> bool:
        """Remove one object from quarantine (it loaded cleanly or was
        deleted); True when it was quarantined."""
        with self._lock:
            entry = self._items.pop((component, name), None)
        if entry is not None:
            log.warning("cleared quarantine for %s object %r", component, name)
        return entry is not None

    def is_quarantined(self, component: str, name: str) -> bool:
        with self._lock:
            return (component, name) in self._items

    def snapshot(self) -> dict:
        """Every quarantined object, oldest first (/debug/supervisor)."""
        with self._lock:
            items = [dict(e) for e in self._items.values()]
        items.sort(key=lambda e: e["since_unix"])
        return {"count": len(items), "objects": items}


_default: Optional[QuarantineRegistry] = None
_default_lock = threading.Lock()


def quarantine_registry() -> QuarantineRegistry:
    """The process's registry."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = QuarantineRegistry()
    return _default
