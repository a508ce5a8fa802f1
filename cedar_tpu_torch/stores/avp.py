"""Amazon Verified Permissions policy store.

Behavior parity with the upstream project's
internal/server/store/verified_permissions.go: ListPolicies paginator +
GetPolicy per policy, full set rebuilt on a ticker, ready after first load.

The AWS client is injected (any object with list_policy_ids(store_id) and
get_policy_statement(store_id, policy_id)); boto3 is not available in this
image, so the default constructor raises unless a client is supplied — tests
and air-gapped deployments inject their own.
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Protocol

from ..lang.authorize import PolicySet
from ..lang.lexer import ParseError
from ..lang.parser import parse_policies

log = logging.getLogger(__name__)


class AVPClient(Protocol):
    def list_policy_ids(self, policy_store_id: str) -> List[str]:
        ...

    def get_policy_statement(self, policy_store_id: str, policy_id: str) -> str:
        ...


class Boto3AVPClient:
    """Adapter over boto3 verifiedpermissions (optional dependency)."""

    def __init__(self, region: str = "", profile: str = ""):
        try:
            import boto3  # type: ignore
        except ImportError as e:  # pragma: no cover - boto3 not in image
            raise ImportError(
                "boto3 is required for the verifiedPermissions store; install "
                "it or inject a custom AVPClient"
            ) from e
        session = boto3.Session(
            **({"region_name": region} if region else {}),
            **({"profile_name": profile} if profile else {}),
        )
        self._client = session.client("verifiedpermissions")

    def list_policy_ids(self, policy_store_id: str) -> List[str]:
        ids: List[str] = []
        paginator = self._client.get_paginator("list_policies")
        for page in paginator.paginate(policyStoreId=policy_store_id):
            for p in page.get("policies", []):
                ids.append(p["policyId"])
        return ids

    def get_policy_statement(self, policy_store_id: str, policy_id: str) -> str:
        resp = self._client.get_policy(
            policyStoreId=policy_store_id, policyId=policy_id
        )
        definition = resp.get("definition", {})
        static = definition.get("static")
        if static:
            return static.get("statement", "")
        return ""


class VerifiedPermissionsPolicyStore:
    def __init__(
        self,
        policy_store_id: str,
        client: Optional[AVPClient] = None,
        refresh_interval_s: float = 300.0,
        region: str = "",
        profile: str = "",
        start_ticker: bool = True,
    ):
        self.policy_store_id = policy_store_id
        self._client = client or Boto3AVPClient(region, profile)
        self.refresh_interval_s = refresh_interval_s
        self._policies = PolicySet()
        self._generation = 0
        self._lock = threading.Lock()
        self._load_complete = False
        self._stop = threading.Event()
        self.load_policies()
        if start_ticker:
            threading.Thread(
                target=self._reload_loop, name="avp-store-reload", daemon=True
            ).start()

    def close(self) -> None:
        self._stop.set()

    def _reload_loop(self) -> None:
        while not self._stop.wait(self.refresh_interval_s):
            self.load_policies()

    def load_policies(self) -> None:
        import hashlib

        digest = hashlib.sha256()
        statements = []
        try:
            # sorted: ListPolicies pagination order is not canonical, and
            # the digest must not depend on it
            ids = sorted(self._client.list_policy_ids(self.policy_store_id))
            for pid in ids:
                statement = self._client.get_policy_statement(
                    self.policy_store_id, pid
                )
                if not statement:
                    continue
                # length prefixes keep (pid, statement) boundaries
                # unambiguous in the digest
                digest.update(f"{len(pid)}:".encode())
                digest.update(pid.encode())
                digest.update(f"{len(statement)}:".encode())
                digest.update(statement.encode())
                statements.append((pid, statement))
        except Exception as e:
            log.error("AVP store load failed: %s", e)
            return
        fp = digest.hexdigest()
        if fp == getattr(self, "_content_digest", None):
            # unchanged corpus: skip the re-parse entirely
            self._load_complete = True
            return
        ps = PolicySet()
        for pid, statement in statements:
            try:
                for i, p in enumerate(parse_policies(statement, pid)):
                    ps.add(p, policy_id=f"{pid}.policy{i}")
            except ParseError as e:
                log.error("AVP policy %s parse error: %s", pid, e)
        with self._lock:
            self._policies = ps
            self._content_digest = fp
            self._generation += 1
        self._load_complete = True

    def policy_set(self) -> PolicySet:
        with self._lock:
            return self._policies

    def initial_policy_load_complete(self) -> bool:
        return self._load_complete

    def name(self) -> str:
        return "VerifiedPermissionsStore"

    def content_generation(self) -> int:
        with self._lock:
            return self._generation
