"""Directory policy store: loads the *.cedar files of one directory and
re-reads them on a ticker.

Behavior parity with the reference's internal/server/store/directory.go
(the JAX package's stores/directory.py): ready immediately, errors logged
and skipped per file, policy ids namespaced as "<filename>.policy<N>"
(directory.go:75), an atomic swap of the whole set, a full re-read every
``refresh_interval_s`` (the StoreConfig's refreshInterval). A file that
stops parsing keeps its last good policies and is quarantined
(stores/quarantine.py). Parse results are cached per file by content
hash, so a tick over unchanged files costs reads and hashes.

``content_generation()`` steps when a re-read changes the content; the
webhook's reloader (cli/webhook.py TorchReloader) polls it and recompiles
the device planes. ``load_policies()`` re-reads on demand; ``close()``
stops the ticker.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Dict, Optional, Tuple

from ..lang.authorize import PolicySet
from ..lang.lexer import ParseError
from ..lang.parser import parse_policies
from .quarantine import quarantine_registry

log = logging.getLogger(__name__)


class DirectoryPolicyStore:
    def __init__(
        self,
        directory: str,
        refresh_interval_s: float = 60.0,
        start_ticker: bool = True,
    ):
        self.directory = directory
        self.refresh_interval_s = refresh_interval_s
        # file names this store quarantined, so a reload can clear the
        # entries of files that vanish (born-poison ones included)
        self._quarantined: set = set()
        self._policies = PolicySet()
        # filename -> (content sha256, parsed policies); entries of
        # removed files drop at each reload
        self._parse_cache: Dict[str, Tuple[str, list]] = {}
        self._generation = 0
        self._lock = threading.Lock()
        # one re-read at a time: the ticker and an on-demand
        # load_policies() share the parse cache and the quarantine set
        self._load_lock = threading.Lock()
        self._stop = threading.Event()
        self.load_policies()
        self._ticker: Optional[threading.Thread] = None
        if start_ticker:
            self._ticker = threading.Thread(
                target=self._reload_loop, name="directory-store-reload", daemon=True
            )
            self._ticker.start()

    def close(self) -> None:
        """Stop the ticker: it exits at once, without a re-read."""
        self._stop.set()

    def _reload_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            try:
                self.load_policies()
            except Exception:  # noqa: BLE001 — the previous set keeps serving
                log.exception("directory store re-read failed; serving the previous set")

    def load_policies(self) -> None:
        with self._load_lock:
            self._load_policies()

    def _load_policies(self) -> None:
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
