"""Candidate policy-set sources for staging (the JAX package's
rollout/source.py).

A candidate is a full replacement policy corpus: one tier compiled (and
perhaps promoted) in place of the live tiers. Three sources:

  * a **directory** of ``*.cedar`` files: the operator's scratch copy of
    the live directory store, with ids namespaced ``<file>.policy<N>``
    as stores/directory.py does, so promoted reasons line up with what the
    store serves once the content is committed;
  * an **inline source** string (tests, the stage HTTP endpoint);
  * **CRD objects carrying the rollout label**: Policy objects labelled
    ``cedar.k8s.aws/rollout=candidate`` are the staged corpus (the CRD
    store withholds them from the live set, stores/crd.py).

Unlike the live directory store, which logs and skips a bad file, a
candidate load raises on any parse failure: a stage must never shadow a
subset of what the operator staged.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

from ..lang.authorize import PolicySet
from ..lang.parser import parse_policies
from ..stores.crd import CANDIDATE_LABEL, CANDIDATE_LABEL_VALUE

__all__ = [
    "CANDIDATE_LABEL",
    "CANDIDATE_LABEL_VALUE",
    "CandidateSourceError",
    "candidate_tiers_from_directory",
    "candidate_tiers_from_objects",
    "candidate_tiers_from_source",
]


class CandidateSourceError(ValueError):
    """A candidate corpus could not be loaded (missing dir, parse error)."""


def candidate_tiers_from_source(
    source: str, filename: str = "candidate.cedar"
) -> List[PolicySet]:
    """One candidate tier from an inline Cedar source string."""
    try:
        policies = parse_policies(source, filename)
    except Exception as e:
        raise CandidateSourceError(f"candidate source failed to parse: {e}")
    ps = PolicySet()
    for i, p in enumerate(policies):
        ps.add(p, policy_id=f"{filename}.policy{i}")
    return [ps]


def candidate_tiers_from_directory(directory: str) -> List[PolicySet]:
    """One candidate tier from every ``*.cedar`` file under ``directory``
    (sorted, ids namespaced like the live directory store)."""
    if not os.path.isdir(directory):
        raise CandidateSourceError(f"candidate directory does not exist: {directory}")
    ps = PolicySet()
    n_files = 0
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if not os.path.isfile(path) or not name.endswith(".cedar"):
            continue
        n_files += 1
        try:
            with open(path, "r") as f:
                data = f.read()
            policies = parse_policies(data, name)
        except Exception as e:
            raise CandidateSourceError(f"candidate policy file {name} failed to load: {e}")
        for i, p in enumerate(policies):
            ps.add(p, policy_id=f"{name}.policy{i}")
    if n_files == 0:
        raise CandidateSourceError(f"no *.cedar files under candidate directory {directory}")
    return [ps]


def candidate_tiers_from_objects(
    objects: Sequence,
    label: str = CANDIDATE_LABEL,
    value: Optional[str] = CANDIDATE_LABEL_VALUE,
) -> List[PolicySet]:
    """One candidate tier from Policy CRD objects (apis.v1alpha1
    PolicyObject) whose ``metadata.labels[label]`` equals ``value`` (any
    value when ``value`` is None). Ids are namespaced ``<object
    name>.policy<N>`` like the CRD store's live parse."""
    ps = PolicySet()
    n_objects = 0
    for obj in objects:
        labels = getattr(obj, "labels", None) or {}
        if label not in labels:
            continue
        if value is not None and labels.get(label) != value:
            continue
        n_objects += 1
        try:
            policies = parse_policies(obj.spec.content, obj.name)
        except Exception as e:
            raise CandidateSourceError(f"candidate Policy object {obj.name} failed to parse: {e}")
        for i, p in enumerate(policies):
            ps.add(p, policy_id=f"{obj.name}.policy{i}")
    if n_objects == 0:
        raise CandidateSourceError(
            f"no Policy objects labeled {label}" + (f"={value}" if value is not None else "")
        )
    return [ps]
