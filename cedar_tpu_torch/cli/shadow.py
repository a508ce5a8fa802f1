"""cedar-shadow (port): offline decision diffing of recorded traffic against
a candidate policy set.

    python -m cedar_tpu_torch.cli.shadow RECORDINGS... --config store.json \
        --candidate-dir ./candidate [--json] [--fail-on-diff]

The webhook's recorder (server/recorder.py) writes every POST body as
``req-<endpoint>-<fingerprint>-<unixnano>.json``. This CLI replays those
recordings through both the live store stack (the StoreConfig the server
runs with) and a candidate directory of ``*.cedar`` files, and prints the
decision-diff report the live server's shadow evaluator gathers at
/debug/rollout (rollout/report.py, the same compare and record step), so
an operator can ask what a candidate would have decided about recorded
traffic without staging anything on the serving path.

Both sides evaluate on the host interpreter: this is a parity tool, not a
serving path, and needs no card. The candidate passes the same analysis
gate as a live stage (strict by default), so a candidate the server would
refuse to stage fails here too, with the same findings.

Exit codes: 0 done; 1 no recordings, or a store or candidate error; 2
with --fail-on-diff when any decision diff was found.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from types import SimpleNamespace
from typing import List, Optional

from ..rollout.report import DiffReport, compare_admission, compare_authorization


def _build_live(config_path: str):
    """(authorizer, admission handler) over the live StoreConfig, on the
    interpreter, once the stores' initial loads are complete."""
    from ..server.admission import CedarAdmissionHandler, allow_all_admission_policy_store
    from ..server.authorizer import CedarWebhookAuthorizer
    from ..stores.config import load_config_stores
    from ..stores.store import TieredPolicyStores

    stores = load_config_stores(config_path)
    authorizer = CedarWebhookAuthorizer(stores)
    admission = CedarAdmissionHandler(
        TieredPolicyStores(list(stores.stores) + [allow_all_admission_policy_store()])
    )
    return authorizer, admission


def _build_candidate(directory: str, validation_mode: str):
    """(authorizer, admission handler) over the candidate directory,
    through the stage gate and the stack assembly of a live stage
    (rollout/controller.py candidate_stores)."""
    from ..analysis.loadgate import AnalysisRejected, enforce
    from ..rollout.controller import candidate_stores
    from ..rollout.source import candidate_tiers_from_directory
    from ..server.admission import CedarAdmissionHandler
    from ..server.authorizer import CedarWebhookAuthorizer

    tiers = candidate_tiers_from_directory(directory)
    if validation_mode:
        try:
            tiers, _report = enforce(tiers, validation_mode, publish=False)
        except AnalysisRejected as e:
            raise RuntimeError(f"candidate rejected by analysis: {e}")
    authz_stores, admission_stores = candidate_stores(tiers)
    return CedarWebhookAuthorizer(authz_stores), CedarAdmissionHandler(admission_stores)


def _load_recordings(paths) -> List[tuple]:
    """[(file name, endpoint, body)]; the endpoint comes from the name."""
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.glob("req-*.json")))
        else:
            files.append(path)
    return [(f.name, "authorize" if "authorize" in f.name else "admit", f.read_bytes())
            for f in files]


def _offline_attributor(live, candidate):
    """An interpreter-plane DiffAttributor over the offline stacks, so the
    report carries the determining-policy attribution live shadow
    exemplars do (policy level: there is no compiled pack offline)."""
    from ..explain import DiffAttributor

    live_authorizer, live_admission = live
    cand_authorizer, cand_admission = candidate
    cand_ns = SimpleNamespace(
        authz_engine=None,
        admission_engine=None,
        tiers=[s.policy_set() for s in cand_authorizer.stores],
        admission_handler=cand_admission,
    )
    return DiffAttributor(
        candidate=cand_ns,
        live_authz_tiers=[s.policy_set() for s in live_authorizer.stores],
        live_admission_tiers=[s.policy_set() for s in live_admission.stores],
    )


def diff_recordings(recordings, live, candidate, exemplar_cap: int = 64) -> DiffReport:
    """Replay every recording through both stacks into one DiffReport, the
    offline twin of rollout/shadow.py's comparison (the same
    rollout/report.py compare_* step)."""
    from ..entities.admission import AdmissionRequest
    from ..server.sar import get_authorizer_attributes

    live_authorizer, live_admission = live
    cand_authorizer, cand_admission = candidate
    try:
        attributor = _offline_attributor(live, candidate)
    except Exception:  # noqa: BLE001 — attribution is best-effort
        attributor = None
    report = DiffReport(exemplar_cap=exemplar_cap)
    for _name, endpoint, body in recordings:
        if endpoint == "authorize":
            try:
                attributes = get_authorizer_attributes(json.loads(body))
            except Exception:  # noqa: BLE001 — unkeyable rows are skipped
                report.record_skipped("authorization")
                continue
            compare_authorization(
                report, attributes, live_authorizer.authorize(attributes),
                cand_authorizer.authorize(attributes), attributor=attributor,
            )
        else:
            try:
                req = AdmissionRequest.from_admission_review(json.loads(body))
            except Exception:  # noqa: BLE001 — unkeyable rows are skipped
                report.record_skipped("admission")
                continue
            live_resp = live_admission.handle(req)
            cand_resp = cand_admission.handle(req)
            compare_admission(
                report, req, (live_resp.allowed, live_resp.message or ""),
                (cand_resp.allowed, cand_resp.message or ""), attributor=attributor,
            )
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cedar-shadow",
        description="Replay recorded webhook requests against a candidate "
        "policy set and report decision diffs",
    )
    parser.add_argument("paths", nargs="+", help="recording files or directories (req-*.json)")
    parser.add_argument("--config", required=True,
                        help="StoreConfig of the LIVE policy stores (the baseline)")
    parser.add_argument("--candidate-dir", required=True,
                        help="directory of *.cedar files forming the candidate set")
    parser.add_argument(
        "--validation-mode", default="strict", choices=["", "strict", "permissive", "partial"],
        help="analysis gate applied to the candidate before replay "
        "(default strict, matching a live stage; '' disables)",
    )
    parser.add_argument("--exemplar-cap", type=int, default=64,
                        help="max diff exemplars retained in the report")
    parser.add_argument("--json", action="store_true",
                        help="emit the full diff report as JSON instead of text")
    parser.add_argument("--fail-on-diff", action="store_true",
                        help="exit nonzero when any decision diff is found (CI gating)")
    args = parser.parse_args(argv)

    recordings = _load_recordings(args.paths)
    if not recordings:
        print("no recordings found", file=sys.stderr)
        return 1
    try:
        live = _build_live(args.config)
        candidate = _build_candidate(args.candidate_dir, args.validation_mode)
    except Exception as e:  # noqa: BLE001 — setup failures are user errors
        print(f"error: {e}", file=sys.stderr)
        return 1
    report = diff_recordings(recordings, live, candidate, exemplar_cap=args.exemplar_cap)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render_text())
    if args.fail_on_diff and report.total_diffs:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
