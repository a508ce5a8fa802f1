"""Directory policy store: loads the *.cedar files of one directory and
re-reads them on a ticker.

Behavior parity with the reference's internal/server/store/directory.go
(the JAX package's stores/directory.py): ready immediately, errors logged
and skipped per file, policy ids namespaced as "<filename>.policy<N>"
(directory.go:75), an atomic swap of the whole set, a full re-read every
``refresh_interval_s`` (the StoreConfig's refreshInterval). A file that
stops parsing keeps its last good policies and is quarantined
(stores/quarantine.py). Parse results are cached per file by content
hash. A tick over unchanged files costs one stat each: a file whose
(inode, size, mtime, ctime) equal those of its last read, and whose
mtime and ctime were at least ``RACY_S`` older than that read began, is
taken from the cache unread (the kernel sets ctime on every write and
rename, so a later change shows in the stat; a file changed within
``RACY_S`` of a read is read and hashed again, as git treats "racily
clean" index entries). Every other file is read and hashed. (Ten tenant
directories of 1,000 files each, every one re-read in full at each tick,
kept the serving threads of a webhook off the host.)

``content_generation()`` steps when a re-read changes the content; the
webhook's reloader (cli/webhook.py TorchReloader) polls it and recompiles
the device planes. ``load_policies()`` re-reads on demand; ``close()``
stops the ticker. The supervisor (server/supervisor.py) watches the
ticker through ``ticker_threads()`` and restarts it with ``revive()``.
A re-read fires the ``store.load`` chaos seam first: an injected stall
delays it, an injected error skips it, and either way the previous set
keeps serving.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..chaos.registry import ChaosError, chaos_fire
from ..lang.authorize import PolicySet
from ..lang.lexer import ParseError
from ..lang.parser import parse_policies
from .quarantine import quarantine_registry

log = logging.getLogger(__name__)

# a file's stat is trusted only once its mtime and ctime are this much
# older than the read that cached it (well above any file system's
# timestamp granularity)
RACY_S = 2.0


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
        # filename -> the stat signature of a file whose read may be
        # skipped (module docstring); absent for racy, unread and
        # quarantined files
        self._stable: Dict[str, tuple] = {}
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
            if self._ticker is not threading.current_thread():
                return  # superseded by revive(): a fresh ticker owns re-reads
            try:
                self.load_policies()
            except Exception:  # noqa: BLE001 — the previous set keeps serving
                log.exception("directory store re-read failed; serving the previous set")

    def ticker_threads(self) -> list:
        """The reload ticker thread (the supervisor's liveness probe);
        none once the store is closed."""
        if self._ticker is None or self._stop.is_set():
            return []
        return [self._ticker]

    def revive(self, force: bool = False) -> bool:
        """Restart a dead (or, forced, wedged) reload ticker (the
        supervisor's hook); serving is unaffected either way: the previous
        policy set keeps answering. False when nothing needed doing (the
        store is closed, has no ticker, or its ticker lives)."""
        t = self._ticker
        if self._stop.is_set() or t is None:
            return False
        if t.is_alive() and not force:
            return False
        log.warning("directory store: restarting reload ticker")
        self._ticker = threading.Thread(
            target=self._reload_loop, name="directory-store-reload", daemon=True
        )
        self._ticker.start()
        return True

    def load_policies(self) -> None:
        with self._load_lock:
            self._load_policies()

    def _load_policies(self) -> None:
        try:
            # chaos seam: a latency rule is the "store stalls" game day, an
            # error rule a failed re-read; both leave the previous set
            chaos_fire("store.load")
            entries = sorted(os.scandir(self.directory), key=lambda e: e.name)
        except ChaosError as e:
            log.error("policy directory load failed (injected): %s", e)
            return
        except OSError as e:
            log.error("Error reading policy directory: %s", e)
            return
        ps = PolicySet()
        new_cache: Dict[str, Tuple[str, list]] = {}
        stable: Dict[str, tuple] = {}
        seen: set = set()
        started_ns = time.time_ns()
        for entry in entries:
            name = entry.name
            if not name.endswith(".cedar"):
                continue
            try:
                if not entry.is_file():
                    continue
                st = entry.stat()
            except OSError:
                continue
            seen.add(name)
            sig = (st.st_ino, st.st_size, st.st_mtime_ns, st.st_ctime_ns)
            cached = self._parse_cache.get(name)
            if cached is not None and self._stable.get(name) == sig:
                # unchanged since a read that began after the file settled
                quarantine_registry().clear("directory", name)
                new_cache[name] = cached
                stable[name] = sig
                for i, p in enumerate(cached[1]):
                    ps.add(p, policy_id=f"{name}.policy{i}")
                continue
            try:
                with open(entry.path, "r") as f:
                    data = f.read()
            except OSError as e:
                log.error("Error reading policy file: %s", e)
                continue
            digest = hashlib.sha256(data.encode()).hexdigest()
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
            if max(st.st_mtime_ns, st.st_ctime_ns) < started_ns - RACY_S * 1e9:
                stable[name] = sig
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
        self._stable = stable
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
