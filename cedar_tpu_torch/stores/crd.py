"""CRD policy store: watches cedar.k8s.aws/v1alpha1 Policy objects.

The JAX package's stores/crd.py, with the reference's behavior
(the upstream project's internal/server/store/crd.go):
  * not ready until the initial list completes (crd.go:183-186); the store
    first poll-waits for its kubeconfig file to exist (bootstrap circular
    dependency with the apiserver, crd.go:130-144)
  * add/update/delete events re-parse policy text into the shared set under
    a lock; policy ids are "<name><idx>-<uid>" (crd.go:60)
  * a parse error logs and skips that Policy object

The watch transport is pluggable: KubeAPIWatchSource speaks list+watch to a
real apiserver using a kubeconfig (stdlib TLS, no client library); tests
drive a fake source directly.

The store's generation is content-keyed: it steps only when the live
view (each object's uid, content and candidate label) changes, so a
watch reconnect's relist or a metadata-only MODIFIED event recompiles
nothing downstream. A watch event or a relist parses only the objects
whose uid or content changed: every other object keeps its Policy
objects, and with them the fingerprints the incremental compiler
memoizes on them (compiler/shard.py). The JAX store re-parses every
object at a relist, which at 10k policies holds the interpreter for
seconds while the server serves; the served set is the same. A
quarantined object is always parsed again, so a relist that lists it
repaired clears its quarantine, as in the JAX package.

With a ``validation_mode`` (CedarConfig.validationMode), each parsed
object passes the per-object lowerability gate (analysis/loadgate.py
check_object_policies): strict quarantines an object with a blocking
finding and keeps serving its last good content, partial drops only the
offending policies, permissive logs and counts the findings. The gate
runs where the parse does, so an unchanged object is not checked again
at a relist.

Objects labelled ``cedar.k8s.aws/rollout=candidate`` stay out of the
serving set, as in the JAX package (they are held for a rollout
controller, which the port does not have yet).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.error
from typing import Callable, List, Optional, Protocol

from ..apis.v1alpha1 import (
    GROUP,
    VALIDATION_MODE_PARTIAL,
    VALIDATION_MODE_STRICT,
    VERSION,
    PolicyObject,
)
from ..chaos.registry import chaos_fire
from ..lang.authorize import PolicySet
from ..lang.lexer import ParseError
from ..lang.parser import parse_policies
from ..server.backoff import Backoff
from .quarantine import quarantine_registry

log = logging.getLogger(__name__)

# the shadow-rollout candidate label (rollout/source.py stages the
# objects that carry it)
CANDIDATE_LABEL = "cedar.k8s.aws/rollout"
CANDIDATE_LABEL_VALUE = "candidate"

Event = tuple  # (type: "ADDED"|"MODIFIED"|"DELETED"|"ERROR", PolicyObject)


class WatchExpired(Exception):
    """The watch's resourceVersion is no longer valid; a fresh list is
    required (kube 410 Gone / ERROR watch event)."""


class PolicyWatchSource(Protocol):
    def list(self) -> List[PolicyObject]:
        ...

    def watch(self, on_event: Callable[[str, PolicyObject], None], stop) -> None:
        """Blocks, delivering events until `stop` (threading.Event) is set."""
        ...


class CRDPolicyStore:
    def __init__(
        self,
        source: Optional[PolicyWatchSource] = None,
        kubeconfig_path: Optional[str] = None,
        kubeconfig_context: str = "",
        start: bool = True,
        validation_mode: Optional[str] = None,
    ):
        self._source = source
        self._kubeconfig_path = kubeconfig_path or os.environ.get("KUBECONFIG", "")
        self._kubeconfig_context = kubeconfig_context
        # load-time lowerability gate per Policy object
        # (CedarConfig.validationMode; analysis/loadgate.py): strict
        # rejects the whole object like a parse error, partial drops only
        # the offending policies, permissive logs + counts. None skips the
        # analysis entirely. Whole-set passes (shadowing/conflicts) need
        # the full tier view and run at engine load instead.
        self._validation_mode = validation_mode
        self._policies = PolicySet()
        self._ids_by_object: dict = {}  # object name -> [policy ids]
        # object name -> (uid, content, is_candidate): generation bumps
        # ONLY when this map changes, so watch reconnect relists and
        # metadata-only MODIFIED events never trigger a TPU recompile.
        # is_candidate is part of the key because flipping the rollout
        # label IS a serving-set change (the object enters/leaves the live
        # corpus) even though uid+content are untouched.
        self._content_by_object: dict = {}
        # Policy objects labeled cedar.k8s.aws/rollout=candidate: EXCLUDED
        # from the live serving set and held here for a shadow-rollout
        # controller to stage
        self._candidate_objects: dict = {}
        # object names THIS store quarantined: a relist after a watch
        # outage must clear entries for objects deleted while disconnected
        # (their DELETED events never arrived)
        self._quarantined: set = set()
        self._generation = 0
        self._lock = threading.Lock()
        self._load_complete = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._start_thread()

    def _start_thread(self) -> None:
        self._thread = threading.Thread(
            target=self._watch_main, name="crd-store", daemon=True
        )
        self._thread.start()

    def watch_threads(self) -> list:
        """The list+watch worker thread(s) (supervisor liveness probe)."""
        return [self._thread] if self._thread is not None else []

    def revive(self, force: bool = False) -> bool:
        """Restart a dead (or, forced, wedged) list+watch thread
        (supervisor hook). The fresh thread relists from scratch — the
        content-keyed generation means an unchanged corpus relist never
        recompiles downstream. A superseded old thread exits at its next
        loop check."""
        t = self._thread
        if self._stop.is_set():
            return False
        if t is not None and t.is_alive() and not force:
            return False
        log.warning("CRD store: restarting list+watch thread")
        self._start_thread()
        return True

    def _watch_main(self) -> None:
        try:
            self._populate_policies()
        except BaseException:  # noqa: BLE001 — visibility, then unwind
            try:
                from ..server.metrics import record_worker_death

                record_worker_death("crd.watch")
            except Exception:  # noqa: BLE001 — must not mask the death
                pass
            log.critical("CRD watch thread died on an uncaught exception")
            raise

    def _superseded(self) -> bool:
        """True when this thread's generation was replaced by revive()
        (direct test calls from the owning thread are never superseded)."""
        t = self._thread
        return t is not None and t is not threading.current_thread()

    def close(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------- lifecycle

    def _populate_policies(self) -> None:
        if self._source is None:
            # bootstrap: wait for the kubeconfig file to exist (5s poll)
            while not self._stop.is_set():
                if self._kubeconfig_path and os.path.exists(self._kubeconfig_path):
                    break
                log.info(
                    "CRD store waiting for kubeconfig %s", self._kubeconfig_path
                )
                if self._stop.wait(5.0):
                    return
            try:
                self._source = KubeAPIWatchSource(
                    self._kubeconfig_path, self._kubeconfig_context
                )
            except Exception as e:  # pragma: no cover - env specific
                log.error("CRD store: failed to build kube client: %s", e)
                return
        # decorrelated-jitter backoff shared by the initial list and the
        # watch reconnect loop: an apiserver blip must neither kill the
        # store permanently (the old initial-list behavior) nor invite a
        # synchronized fixed-cadence retry herd
        backoff = Backoff(base_s=1.0, cap_s=30.0)
        while not self._stop.is_set() and not self._superseded():
            try:
                self._relist()
                break
            except Exception as e:
                log.error("CRD store: initial list failed, retrying: %s", e)
                if self._stop.wait(backoff.next()):
                    return
        else:
            return
        self._load_complete = True
        backoff.reset()
        while not self._stop.is_set() and not self._superseded():
            try:
                self._source.watch(self._dispatch, self._stop)
                backoff.reset()  # a clean watch cycle proves the link healthy
            except WatchExpired as e:
                # stale resourceVersion (apiserver compaction / 410 Gone):
                # drop the bookmark and rebuild from a fresh list
                log.warning("CRD store: watch expired (%s), relisting", e)
                self._try_relist(backoff)
            except Exception as e:
                log.error("CRD store: watch error, retrying: %s", e)
                if self._stop.wait(backoff.next()):
                    return
                self._try_relist(backoff)

    def _try_relist(self, backoff: Optional[Backoff] = None) -> None:
        try:
            reset = getattr(self._source, "reset_resource_version", None)
            if reset is not None:
                reset()
            self._relist()
            if backoff is not None:
                backoff.reset()
        except Exception as e:
            log.error("CRD store: relist failed: %s", e)
            self._stop.wait(backoff.next() if backoff is not None else 2.0)

    def _relist(self) -> None:
        chaos_fire("store.crd.relist")
        objs = self._source.list()
        # objects deleted while the watch was down never sent a DELETED
        # event: their quarantine entries leave with them at the relist
        listed = {obj.name for obj in objs}
        for name in self._quarantined - listed:
            quarantine_registry().clear("crd", name)
            self._quarantined.discard(name)
        with self._lock:
            ps = PolicySet()
            ids_by_object: dict = {}
            content_by_object: dict = {}
            candidate_objects: dict = {}
            for obj in objs:
                if self._is_candidate(obj):
                    candidate_objects[obj.name] = obj
                    content_by_object[obj.name] = (
                        obj.uid, obj.spec.content, True,
                    )
                    continue
                uid, content = obj.uid, obj.spec.content
                if (self._content_by_object.get(obj.name) == (uid, content, False)
                        and obj.name in self._ids_by_object
                        and obj.name not in self._quarantined):
                    # unchanged since the last list or event: keep its
                    # Policy objects (and the fingerprints memoized on
                    # them) instead of parsing it again; a relist of an
                    # unchanged corpus then parses nothing. A quarantined
                    # object is parsed again: its stored content is the
                    # retained last good one, and a relist that lists it
                    # repaired must clear the quarantine, as _parse does
                    policies = [self._policies.get(pid)
                                for pid in self._ids_by_object[obj.name]]
                else:
                    policies = self._parse(obj)
                if policies is None:
                    # poison-object quarantine with last-known-good
                    # retention: the object is broken (parse failure or
                    # strict-gate rejection), but its PREVIOUS content
                    # served fine — keep serving that instead of silently
                    # dropping the object's policies from the corpus. The
                    # retained (uid, content) keeps the live-view
                    # generation stable, so no recompile churns either.
                    prev = self._content_by_object.get(obj.name)
                    if prev is None or prev[2]:
                        continue  # nothing good to retain
                    uid, content = prev[0], prev[1]
                    try:
                        policies = parse_policies(content, obj.name)
                    except ParseError:
                        continue  # previous content gone bad too: drop
                ids = []
                for i, p in enumerate(policies):
                    pid = f"{obj.name}{i}-{uid}"
                    ps.add(p, policy_id=pid)
                    ids.append(pid)
                ids_by_object[obj.name] = ids
                content_by_object[obj.name] = (uid, content, False)
            self._policies = ps
            self._ids_by_object = ids_by_object
            self._candidate_objects = candidate_objects
            # generation compares the LIVE view only: a candidate-labeled
            # object's content is not served, so a candidate edit arriving
            # via a reconnect relist must not recompile the engines (or —
            # after a promotion — revert the promoted compiled set through
            # the reloader). Label flips still bump: the object enters or
            # leaves the live view. The watch _upsert path has the same
            # semantics.
            live_view = {
                k: v for k, v in content_by_object.items() if not v[2]
            }
            prev_live_view = {
                k: v for k, v in self._content_by_object.items() if not v[2]
            }
            self._content_by_object = content_by_object
            if live_view != prev_live_view:
                self._generation += 1

    def _dispatch(self, event_type: str, obj: PolicyObject) -> None:
        if event_type == "ADDED":
            self.on_add(obj)
        elif event_type == "MODIFIED":
            self.on_update(obj)
        elif event_type == "DELETED":
            self.on_delete(obj)
        elif event_type == "ERROR":
            raise WatchExpired("ERROR event from watch stream")

    # -------------------------------------------------------- event handlers

    @staticmethod
    def _is_candidate(obj: PolicyObject) -> bool:
        """True when the object carries the shadow-rollout candidate label
        (CANDIDATE_LABEL): such objects are withheld from the live serving
        set and surfaced via candidate_objects()."""
        labels = getattr(obj, "labels", None) or {}
        return labels.get(CANDIDATE_LABEL) == CANDIDATE_LABEL_VALUE

    def candidate_objects(self) -> list:
        """The current candidate-labeled Policy objects."""
        with self._lock:
            return list(self._candidate_objects.values())

    def _parse(self, obj: PolicyObject):
        # chaos seam: a corrupt rule turns this object's policy text into
        # garbage — the scripted poison-CRD game day (docs/resilience.md)
        content = chaos_fire("store.crd.object", obj.spec.content)
        try:
            policies = parse_policies(content, obj.name)
        except ParseError as e:
            log.error("Error parsing policy %s: %s", obj.name, e)
            quarantine_registry().quarantine("crd", obj.name, str(e))
            self._quarantined.add(obj.name)
            return None
        policies = self._validated(obj, policies)
        if policies is None:
            quarantine_registry().quarantine(
                "crd", obj.name, "rejected by strict load-time validation"
            )
            self._quarantined.add(obj.name)
            return None
        quarantine_registry().clear("crd", obj.name)
        self._quarantined.discard(obj.name)
        return policies

    def _validated(self, obj: PolicyObject, policies):
        """Apply the load-time lowerability gate to one object's policies
        per the validation mode; None rejects the object entirely."""
        if not self._validation_mode or not policies:
            return policies
        from ..analysis.loadgate import check_object_policies
        from ..server.metrics import record_analysis_findings

        checked = check_object_policies(policies)
        bad = [(p, f) for p, f in checked if f is not None]
        if not bad:
            return policies
        for _p, f in bad:
            record_analysis_findings(f.code, 1)
            log.log(
                logging.ERROR
                if self._validation_mode == VALIDATION_MODE_STRICT
                else logging.WARNING,
                "policy %s: analysis %s[%s]: %s",
                obj.name,
                f.severity,
                f.code,
                f.message,
            )
        if self._validation_mode == VALIDATION_MODE_STRICT:
            log.error(
                "rejecting Policy object %s (strict validation): %d "
                "policy(ies) not fastpath-lowerable",
                obj.name,
                len(bad),
            )
            return None
        if self._validation_mode == VALIDATION_MODE_PARTIAL:
            dropped = {id(p) for p, _f in bad}
            kept = [p for p in policies if id(p) not in dropped]
            log.warning(
                "Policy object %s: dropped %d of %d policy(ies) "
                "(partial validation)",
                obj.name,
                len(bad),
                len(policies),
            )
            return kept
        return policies  # permissive: annotate only

    def _copy_on_write(self, mutate) -> None:
        """Build a mutated copy and swap the reference — O(policies) per
        event (rare), O(1) per read on the authorization hot path."""
        with self._lock:
            ps = PolicySet()
            for p in self._policies.policies():
                ps.add(p, policy_id=p.policy_id)
            mutate(ps)
            self._policies = ps
            self._generation += 1

    def on_add(self, obj: PolicyObject) -> None:
        self._upsert(obj)

    def on_update(self, obj: PolicyObject) -> None:
        self._upsert(obj)

    def _upsert(self, obj: PolicyObject) -> None:
        """ADDED/MODIFIED share the semantics: replace the object's policies.
        Metadata-only MODIFIED events (same uid + content + candidate
        label state) are no-ops — no set rebuild, no generation bump, no
        recompile downstream. Candidate-labeled objects never enter the
        live set; gaining the label removes an object from it (the
        operator is pulling it into the staged corpus), losing the label
        admits it."""
        is_candidate = self._is_candidate(obj)
        key = (obj.uid, obj.spec.content, is_candidate)
        if self._content_by_object.get(obj.name) == key:
            return
        if is_candidate:
            with self._lock:
                self._candidate_objects[obj.name] = obj
            if obj.name in self._ids_by_object:
                # previously live: withdraw its policies from the set
                def mutate(ps: PolicySet) -> None:
                    for pid in self._ids_by_object.pop(obj.name, []):
                        ps.remove(pid)
                    self._content_by_object[obj.name] = key

                self._copy_on_write(mutate)
            else:
                with self._lock:
                    self._content_by_object[obj.name] = key
            return
        policies = self._parse(obj)
        if policies is None:
            return

        def mutate(ps: PolicySet) -> None:
            self._candidate_objects.pop(obj.name, None)
            for pid in self._ids_by_object.pop(obj.name, []):
                ps.remove(pid)
            ids = []
            for i, p in enumerate(policies):
                pid = f"{obj.name}{i}-{obj.uid}"
                ps.add(p, policy_id=pid)
                ids.append(pid)
            self._ids_by_object[obj.name] = ids
            self._content_by_object[obj.name] = key

        self._copy_on_write(mutate)

    def on_delete(self, obj: PolicyObject) -> None:
        quarantine_registry().clear("crd", obj.name)
        self._quarantined.discard(obj.name)
        with self._lock:
            was_candidate = (
                self._candidate_objects.pop(obj.name, None) is not None
            )
        if was_candidate and obj.name not in self._ids_by_object:
            with self._lock:
                self._content_by_object.pop(obj.name, None)
            return
        if obj.name not in self._ids_by_object:
            return  # unknown object: nothing to remove, nothing changed

        def mutate(ps: PolicySet) -> None:
            for pid in self._ids_by_object.pop(obj.name, []):
                ps.remove(pid)
            self._content_by_object.pop(obj.name, None)

        self._copy_on_write(mutate)

    # -------------------------------------------------------------- protocol

    def policy_set(self) -> PolicySet:
        # the set is immutable once published (copy-on-write swap above)
        return self._policies

    def initial_policy_load_complete(self) -> bool:
        return self._load_complete

    def name(self) -> str:
        return "CRDPolicyStore"

    def content_generation(self) -> int:
        with self._lock:
            return self._generation


# --------------------------------------------------------------- transport


class KubeAPIWatchSource:
    """Minimal list+watch client for the Policy CRD over HTTPS using a
    kubeconfig — stdlib only, via the shared KubeConfigClient transport
    (stores/kubeclient.py)."""

    def __init__(self, kubeconfig_path: str, context: str = ""):
        from .kubeclient import KubeConfigClient

        self._client = KubeConfigClient(kubeconfig_path, context)
        self.server = self._client.server
        self._resource_version = ""

    def _url(self, watch: bool = False) -> str:
        base = f"{self.server}/apis/{GROUP}/{VERSION}/policies"
        if watch:
            rv = f"&resourceVersion={self._resource_version}" if self._resource_version else ""
            return f"{base}?watch=true{rv}"
        return base

    def _open(self, url: str, timeout: Optional[float]):
        return self._client.open(url, timeout)

    def list(self) -> List[PolicyObject]:
        with self._open(self._url(), timeout=30) as resp:
            body = json.loads(resp.read())
        self._resource_version = body.get("metadata", {}).get("resourceVersion", "")
        return [PolicyObject.from_dict(item) for item in body.get("items", [])]

    def reset_resource_version(self) -> None:
        self._resource_version = ""

    def watch(self, on_event, stop) -> None:
        try:
            resp = self._open(self._url(watch=True), timeout=300)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise WatchExpired("410 Gone") from None
            raise
        with resp:
            for line in resp:
                if stop.is_set():
                    return
                if not line.strip():
                    continue
                evt = json.loads(line)
                if evt.get("type") == "ERROR":
                    code = (evt.get("object") or {}).get("code")
                    if code == 410:
                        raise WatchExpired("410 Gone (ERROR event)")
                obj = evt.get("object", {})
                rv = obj.get("metadata", {}).get("resourceVersion")
                if rv:
                    self._resource_version = rv
                on_event(evt.get("type", ""), PolicyObject.from_dict(obj))
