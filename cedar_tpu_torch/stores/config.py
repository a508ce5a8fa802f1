"""Store configuration -> ordered tiered stores.

Behavior parity with the reference's internal/server/store/config.go (the
JAX package's stores/config.py): ParseConfig (YAML/JSON + validation) and
CedarConfigStores (the ordered store list). The port serves directory
stores only: a CRD or Verified Permissions store, or a validationMode
that needs the load-time policy analysis (strict, partial), raises
ValueError naming what is missing rather than serving without it.
"""

from __future__ import annotations

import json
from typing import Optional

from ..apis.v1alpha1 import (
    STORE_TYPE_DIRECTORY,
    VALIDATION_MODE_PERMISSIVE,
    CedarConfig,
)
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


def cedar_config_stores(config: Optional[CedarConfig]) -> TieredPolicyStores:
    if config is None:
        return TieredPolicyStores([])
    if config.validation_mode != VALIDATION_MODE_PERMISSIVE:
        raise ValueError(
            f".spec.validationMode {config.validation_mode!r} needs the "
            "load-time policy analysis, which the port does not have yet; "
            f"use {VALIDATION_MODE_PERMISSIVE!r}"
        )
    stores = []
    for i, sd in enumerate(config.stores):
        if sd.type != STORE_TYPE_DIRECTORY:
            raise ValueError(
                f".spec.stores[{i}]: store type {sd.type!r} is not in the port "
                f"yet (the CRD and Verified Permissions stores are not "
                f"ported); only {STORE_TYPE_DIRECTORY!r} stores are served"
            )
        stores.append(
            DirectoryPolicyStore(
                sd.directory_store.path,
                refresh_interval_s=sd.directory_store.refresh_interval_ns / 1e9,
            )
        )
    return TieredPolicyStores(stores)
