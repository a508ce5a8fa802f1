"""Minimal kubeconfig-driven apiserver client — stdlib only (urllib + ssl).

The JAX package's stores/kubeclient.py: the TLS/auth surface of the CRD
policy store's list+watch transport (stores/crd.py). Supports the
kubeconfig auth shapes the reference's clientcmd path covers in this
deployment: CA data/file (or insecure-skip-tls-verify), bearer token, and
client certificate data/files; a plain ``http://`` server (kubectl proxy,
tests) needs no TLS.

A kubeconfig is YAML, and JSON is a subset of YAML: the file is read with
``json`` first and PyYAML is imported only for a file that is not JSON,
so a JSON kubeconfig needs no PyYAML.
"""

from __future__ import annotations

import base64
import json
import ssl
import tempfile
import urllib.error
import urllib.request
from typing import Optional

from ..server.backoff import Backoff, retry_call


def read_kubeconfig(path: str) -> dict:
    """The kubeconfig at ``path`` as a dict: JSON read with json, anything
    else with PyYAML, imported only then."""
    with open(path) as f:
        data = f.read()
    try:
        cfg = json.loads(data)
    except ValueError:
        import yaml

        cfg = yaml.safe_load(data)
    return cfg or {}


class KubeConfigClient:
    """HTTPS client for one apiserver, built from a kubeconfig file."""

    def __init__(self, kubeconfig_path: str, context: str = ""):
        cfg = read_kubeconfig(kubeconfig_path)
        ctx_name = context or cfg.get("current-context", "")
        ctx = next(
            c["context"] for c in cfg.get("contexts", []) if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"]
            for c in cfg.get("clusters", [])
            if c["name"] == ctx["cluster"]
        )
        user = next(
            u["user"] for u in cfg.get("users", []) if u["name"] == ctx["user"]
        )
        self.server = cluster["server"].rstrip("/")
        self._ssl = ssl.create_default_context()
        if cluster.get("certificate-authority-data"):
            self._ssl.load_verify_locations(
                cadata=base64.b64decode(
                    cluster["certificate-authority-data"]
                ).decode()
            )
        elif cluster.get("certificate-authority"):
            self._ssl.load_verify_locations(cafile=cluster["certificate-authority"])
        if cluster.get("insecure-skip-tls-verify"):
            self._ssl.check_hostname = False
            self._ssl.verify_mode = ssl.CERT_NONE
        if self.server.startswith("http://"):
            # plain-HTTP apiserver (tests / kubectl-proxy): no TLS context,
            # and any configured client certs are unusable — ignore them
            self._ssl = None
        self._token = user.get("token", "")
        self._cert_files = []
        cert = user.get("client-certificate-data")
        key = user.get("client-key-data")
        if self._ssl is None:
            pass
        elif cert and key:
            cf = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            cf.write(base64.b64decode(cert))
            cf.close()
            kf = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
            kf.write(base64.b64decode(key))
            kf.close()
            self._ssl.load_cert_chain(cf.name, kf.name)
            self._cert_files = [cf.name, kf.name]
        elif user.get("client-certificate") and user.get("client-key"):
            self._ssl.load_cert_chain(
                user["client-certificate"], user["client-key"]
            )

    def open(self, url: str, timeout: Optional[float]):
        """Open an absolute URL (already including self.server)."""
        req = urllib.request.Request(url)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        return urllib.request.urlopen(req, context=self._ssl, timeout=timeout)

    def get_json(self, path: str, timeout: float = 30.0, attempts: int = 3):
        """GET an apiserver-relative path (e.g. ``/openapi/v3``) -> parsed
        JSON, retrying transient failures (connection errors, timeouts,
        5xx) with decorrelated-jitter backoff. GETs are idempotent, so the
        retry is always safe; 4xx responses are the caller's problem and
        re-raise immediately."""

        def _get():
            try:
                with self.open(f"{self.server}{path}", timeout=timeout) as resp:
                    return json.loads(resp.read())
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    raise _NoRetry(e) from e
                raise

        try:
            return retry_call(
                _get,
                attempts=max(1, attempts),
                retry_on=(urllib.error.URLError, OSError, TimeoutError),
                backoff=Backoff(base_s=0.25, cap_s=5.0),
            )
        except _NoRetry as e:
            raise e.error from None


class _NoRetry(Exception):
    """Wraps a terminal (non-retryable) HTTP error through retry_call."""

    def __init__(self, error):
        super().__init__(str(error))
        self.error = error
