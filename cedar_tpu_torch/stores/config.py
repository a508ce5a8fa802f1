"""Store configuration -> ordered tiered stores.

Behavior parity with the reference's internal/server/store/config.go (the
JAX package's stores/config.py): ParseConfig (YAML/JSON + validation) and
CedarConfigStores (the ordered store list: directory, CRD and Verified
Permissions stores, in any tier order), which carry the config's
validationMode: the CRD store gates each Policy object with it and the
tiered stores gate every engine load (analysis/loadgate.py). And
load_config_stores, which waits for the stores' initial loads, for the
offline CLIs.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..apis.v1alpha1 import (
    STORE_TYPE_CRD,
    STORE_TYPE_DIRECTORY,
    STORE_TYPE_VERIFIED_PERMISSIONS,
    CedarConfig,
)
from .avp import VerifiedPermissionsPolicyStore
from .crd import CRDPolicyStore
from .directory import DirectoryPolicyStore
from .store import TieredPolicyStores


def parse_config(data: str) -> CedarConfig:
    """A StoreConfig document -> validated CedarConfig. JSON (a subset of
    YAML) is read with json; anything else needs PyYAML, imported only
    then."""
    try:
        raw = json.loads(data) if data.strip() else None
    except ValueError:
        import yaml

        raw = yaml.safe_load(data)
    if raw is None:
        raw = {}
    config = CedarConfig.from_dict(raw)
    config.validate()
    return config


def cedar_config_stores(
    config: Optional[CedarConfig],
    kubeconfig_path: Optional[str] = None,
    avp_client=None,
) -> TieredPolicyStores:
    """The config's stores in tier order. A CRD store watches the
    apiserver named by ``kubeconfig_path`` (else $KUBECONFIG) from its own
    thread; a Verified Permissions store uses ``avp_client`` (else boto3,
    which must then be installed)."""
    if config is None:
        return TieredPolicyStores([])
    stores = []
    for sd in config.stores:
        if sd.type == STORE_TYPE_DIRECTORY:
            stores.append(
                DirectoryPolicyStore(
                    sd.directory_store.path,
                    refresh_interval_s=sd.directory_store.refresh_interval_ns / 1e9,
                )
            )
        elif sd.type == STORE_TYPE_CRD:
            stores.append(
                CRDPolicyStore(
                    kubeconfig_path=kubeconfig_path,
                    kubeconfig_context=sd.crd_store.kubeconfig_context,
                    validation_mode=config.validation_mode,
                )
            )
        elif sd.type == STORE_TYPE_VERIFIED_PERMISSIONS:
            vp = sd.verified_permissions_store
            stores.append(
                VerifiedPermissionsPolicyStore(
                    vp.policy_store_id,
                    client=avp_client,
                    refresh_interval_s=vp.refresh_interval_ns / 1e9,
                    region=vp.aws_region,
                    profile=vp.aws_profile,
                )
            )
    return TieredPolicyStores(stores, validation_mode=config.validation_mode)


def load_config_stores(config_path: str, timeout_s: float = 30.0) -> TieredPolicyStores:
    """Parse a StoreConfig file, build its tiered stores and wait for every
    store's initial load: the offline CLIs' (cedar-shadow, cedar-why) open,
    parse and poll helper. Raises RuntimeError when the stores are not
    ready within ``timeout_s``."""
    with open(config_path) as f:
        config = parse_config(f.read())
    stores = cedar_config_stores(config)
    deadline = time.monotonic() + timeout_s
    while not all(s.initial_policy_load_complete() for s in stores):
        if time.monotonic() > deadline:
            raise RuntimeError(f"stores not ready after {timeout_s:.0f}s")
        time.sleep(0.2)
    return stores
