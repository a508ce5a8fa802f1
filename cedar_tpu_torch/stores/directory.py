"""Directory policy store: loads the *.cedar files of one directory.

Behavior parity with the reference's internal/server/store/directory.go
(the JAX package's stores/directory.py): ready immediately, errors logged
and skipped per file, policy ids namespaced as "<filename>.policy<N>"
(directory.go:75), an atomic swap of the whole set. A file that stops
parsing keeps its last good policies and is quarantined
(stores/quarantine.py).

The port loads the directory once, at construction: the device plane is
compiled from it once at start (there is no reloader yet), so a ticker
re-reading the files would only let the store drift from what the card
serves. ``load_policies()`` re-reads on demand.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Dict, Tuple

from ..lang.authorize import PolicySet
from ..lang.lexer import ParseError
from ..lang.parser import parse_policies
from .quarantine import quarantine_registry

log = logging.getLogger(__name__)


class DirectoryPolicyStore:
    def __init__(self, directory: str):
        self.directory = directory
        # file names this store quarantined, so a reload can clear the
        # entries of files that vanish (born-poison ones included)
        self._quarantined: set = set()
        self._policies = PolicySet()
        # filename -> (content sha256, parsed policies); entries of
        # removed files drop at each reload
        self._parse_cache: Dict[str, Tuple[str, list]] = {}
        self._generation = 0
        self._lock = threading.Lock()
        self.load_policies()

    def load_policies(self) -> None:
        try:
            entries = sorted(os.listdir(self.directory))
        except OSError as e:
            log.error("Error reading policy directory: %s", e)
            return
        ps = PolicySet()
        new_cache: Dict[str, Tuple[str, list]] = {}
        seen: set = set()
        for name in entries:
            path = os.path.join(self.directory, name)
            if not os.path.isfile(path) or not name.endswith(".cedar"):
                continue
            seen.add(name)
            try:
                with open(path, "r") as f:
                    data = f.read()
            except OSError as e:
                log.error("Error reading policy file: %s", e)
                continue
            digest = hashlib.sha256(data.encode()).hexdigest()
            cached = self._parse_cache.get(name)
            if cached is not None and cached[0] == digest:
                policies = cached[1]
            else:
                try:
                    policies = parse_policies(data, name)
                except ParseError as e:
                    log.error("Error loading policy file %s: %s", name, e)
                    quarantine_registry().quarantine("directory", name, str(e))
                    self._quarantined.add(name)
                    if cached is not None:
                        # last-known-good retention: keep serving the
                        # previous parse (under the old digest, so a fix
                        # is re-parsed)
                        new_cache[name] = cached
                        for i, p in enumerate(cached[1]):
                            ps.add(p, policy_id=f"{name}.policy{i}")
                    continue
            quarantine_registry().clear("directory", name)
            self._quarantined.discard(name)
            new_cache[name] = (digest, policies)
            for i, p in enumerate(policies):
                ps.add(p, policy_id=f"{name}.policy{i}")
        # deleted files leave quarantine (keyed on files seen on disk: a
        # born-poison file still present stays quarantined)
        for name in self._quarantined - seen:
            quarantine_registry().clear("directory", name)
            self._quarantined.discard(name)
        changed = {n: d for n, (d, _) in new_cache.items()} != {
            n: d for n, (d, _) in self._parse_cache.items()
        }
        self._parse_cache = new_cache
        with self._lock:
            self._policies = ps
            if changed:
                self._generation += 1

    def policy_set(self) -> PolicySet:
        with self._lock:
            return self._policies

    def initial_policy_load_complete(self) -> bool:
        return True

    def name(self) -> str:
        return "FilePolicyStore"

    def content_generation(self) -> int:
        with self._lock:
            return self._generation
