"""cedar-why (port): replay a recorded request and print its explanation
tree.

    python -m cedar_tpu_torch.cli.why RECORDINGS... --fingerprint 3a7c94ed \
        --config store.json [--candidate-dir ./candidate] [--json]

The recorder names every recording by the request's canonical fingerprint
(``req-<endpoint>-<fingerprint>-<ns>.json``: the key the decision cache,
the audit log and the rollout diff exemplars carry), so a fingerprint
from a diff report, a cache entry or a log line joins back to its body
here, and the CLI says why it decided as it did.

Explanations come from the attribution core of ``?explain=1``
(explain/): the body is encoded on the host and matched against the
lowered pack of the chosen policies on the host plane (no engine, no
card): determining policy, clause, each attribute test, tier, fallback.
With a live stack (``--config`` / ``--policy-dir``) and a candidate
(``--candidate-dir`` / ``--candidate-source``) the tree prints both sides:
the offline half of a rollout diff exemplar.

Exit codes: 0 explained; 1 store or usage errors; 2 no recording matched
the fingerprint. Unparseable recordings are counted and reported.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Tuple

from ..cache.fingerprint import fingerprint_body


def _load_recordings(paths) -> Tuple[List[tuple], int]:
    """([(file name, endpoint, body, fingerprint)], unparseable count).
    Fingerprints are recomputed, so a renamed file still joins; a body
    that does not parse counts (fingerprint None)."""
    files: List[pathlib.Path] = []
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            files.extend(sorted(path.glob("req-*.json")))
        else:
            files.append(path)
    out = []
    unparseable = 0
    for f in files:
        endpoint = "authorize" if "authorize" in f.name else "admit"
        try:
            body = f.read_bytes()
        except OSError as e:
            print(f"# unreadable recording {f}: {e}", file=sys.stderr)
            unparseable += 1
            continue
        fp = fingerprint_body(endpoint, body)
        if fp is None:
            # a renamed file loses the endpoint hint: a valid body of the
            # other endpoint still joins (the name's endpoint stays first)
            other = "admit" if endpoint == "authorize" else "authorize"
            fp = fingerprint_body(other, body)
            if fp is not None:
                endpoint = other
        if fp is None:
            unparseable += 1
        out.append((f.name, endpoint, body, fp))
    return out, unparseable


def _explainer_from_tiers(tiers):
    """An offline Explainer over interpreter stacks and the lowered host
    pack of ``tiers``, so clause-level attribution needs no engine: the
    host plane of ?explain over pack(lower_tiers(...))."""
    from ..compiler.lower import AUTHZ_SCHEMA_INFO, lower_tiers
    from ..compiler.pack import pack
    from ..explain import Explainer
    from ..rollout.controller import candidate_stores
    from ..server.admission import CedarAdmissionHandler, allow_all_admission_policy_store
    from ..server.authorizer import CedarWebhookAuthorizer

    authz_stores, admission_stores = candidate_stores(tiers)
    authz_packed = admission_packed = None
    try:
        authz_packed = pack(lower_tiers(list(tiers), AUTHZ_SCHEMA_INFO))
        admission_packed = pack(lower_tiers(
            list(tiers) + [allow_all_admission_policy_store().policy_set()], AUTHZ_SCHEMA_INFO))
    except Exception as e:  # noqa: BLE001 — interpreter attribution still works
        print(f"# note: pack failed ({e}); policy-level attribution only", file=sys.stderr)
    return Explainer(
        authorizer=CedarWebhookAuthorizer(authz_stores),
        admission_handler=CedarAdmissionHandler(admission_stores),
        authz_packed=authz_packed,
        admission_packed=admission_packed,
    )


def _explainer_from_config(config_path: str):
    from ..stores.config import load_config_stores

    stores = load_config_stores(config_path)
    return _explainer_from_tiers([s.policy_set() for s in stores])


# ------------------------------------------------------------- rendering


def _span_str(span: Optional[dict]) -> str:
    if not span:
        return ""
    return f"  ({span.get('file')}:{span.get('line')}:{span.get('column')})"


def render_tree(label: str, decision: str, explanation: dict) -> str:
    """Human-readable explanation tree of one (side, recording) pair."""
    lines = []
    tier = explanation.get("tier")
    head = f"{label}: decision={decision}"
    if explanation.get("decision") is not None:
        head += f" (cedar {explanation['decision']})"
    if tier is not None:
        head += f"  tier={tier}"
    head += f"  source={explanation.get('source')}"
    if explanation.get("shortCircuit"):
        head += f"  short-circuit={explanation['shortCircuit']}"
    lines.append(head)
    det = explanation.get("determining")
    reasons = explanation.get("reasons") or ([det] if det else [])
    for i, doc in enumerate(reasons):
        if doc is None:
            continue
        marker = "└─" if i == len(reasons) - 1 else "├─"
        fb = "  [interpreter fallback]" if doc.get("fallback") else ""
        det_mark = " *" if det and doc.get("policyId") == det.get("policyId") else ""
        lines.append(
            f"  {marker} {doc.get('effect') or '?'} "
            f"{doc.get('policyId')}{det_mark}{_span_str(doc.get('span'))}{fb}"
        )
        unlow = doc.get("unlowerable")
        if unlow:
            lines.append(f"       unlowerable [{unlow.get('code')}]: {unlow.get('reason')}")
        clause = doc.get("clause")
        if clause:
            lines.append(f"       clause {clause['index'] + 1}/{clause['of']} [{clause['kind']}]:")
            tests = clause.get("tests") or []
            for j, t in enumerate(tests):
                tm = "└─" if j == len(tests) - 1 else "├─"
                lines.append(f"         {tm} {t['source']}")
    for err in explanation.get("errors") or []:
        lines.append(f"  !! {err}")
    if not reasons and not explanation.get("errors"):
        lines.append("  └─ no policy matched (default applies)")
    return "\n".join(lines)


def _explain_one(explainer, endpoint: str, body: bytes):
    """(webhook decision string, explanation) of one recording body."""
    if endpoint == "authorize":
        decision, _reason, error, explanation = explainer.explain_authorize(body)
        return (decision if error is None else f"<error: {error}>"), explanation
    response, explanation = explainer.explain_admit(body)
    decision = "allow" if response.allowed else "deny"
    if response.error is not None:
        decision = f"<error: {response.error}>"
    return decision, explanation


def _sides(args) -> list:
    """[(label, Explainer)]: the live stack and the candidate, as given."""
    from ..rollout.source import candidate_tiers_from_directory, candidate_tiers_from_source

    sides = []
    if args.config:
        sides.append(("live", _explainer_from_config(args.config)))
    elif args.policy_dir:
        sides.append(("live", _explainer_from_tiers(
            candidate_tiers_from_directory(args.policy_dir))))
    if args.candidate_dir:
        sides.append(("candidate", _explainer_from_tiers(
            candidate_tiers_from_directory(args.candidate_dir))))
    elif args.candidate_source:
        sides.append(("candidate", _explainer_from_tiers(
            candidate_tiers_from_source(args.candidate_source))))
    return sides


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cedar-why",
        description="Replay a recorded webhook request and print the "
        "explanation tree (determining policy, clause, attribute tests)",
    )
    parser.add_argument("paths", nargs="+", help="recording files or directories (req-*.json)")
    sel = parser.add_mutually_exclusive_group(required=True)
    sel.add_argument(
        "--fingerprint",
        help="canonical request fingerprint (or unique prefix) to join — "
        "the key in recording filenames, cache entries, and rollout diff "
        "exemplars",
    )
    sel.add_argument("--all", action="store_true", help="explain every parseable recording")
    parser.add_argument("--config", help="StoreConfig for the LIVE policy stack (same file the "
                        "webhook serves from)")
    parser.add_argument("--policy-dir", help="directory of .cedar files for the LIVE stack "
                        "(alternative to --config)")
    parser.add_argument("--candidate-dir", help="candidate policy directory — prints a second "
                        "tree per recording (the offline half of a rollout diff exemplar)")
    parser.add_argument("--candidate-source", help="inline candidate policy source "
                        "(alternative to --candidate-dir)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON document instead of the text trees")
    args = parser.parse_args(argv)

    recordings, unparseable = _load_recordings(args.paths)
    scanned = len(recordings)
    print(f"# scanned {scanned} recording(s), {unparseable} unparseable", file=sys.stderr)
    if args.all:
        matches = [r for r in recordings if r[3] is not None]
    else:
        matches = [r for r in recordings
                   if r[3] is not None and r[3].startswith(args.fingerprint)]
    if not matches:
        what = "parseable recordings" if args.all else (
            f"recording matches fingerprint {args.fingerprint!r}")
        print(
            f"error: no {what} (scanned {scanned} recording(s), {unparseable} unparseable "
            "— rerun cedar-why with --all to list every joinable fingerprint, or check "
            "the recording directory)",
            file=sys.stderr,
        )
        return 2
    try:
        sides = _sides(args)
    except Exception as e:  # noqa: BLE001 — usage / store errors exit 1
        print(f"error: failed to build policy stack: {e}", file=sys.stderr)
        return 1
    if not sides:
        print("error: no policy stack given — pass --config or --policy-dir "
              "(and optionally --candidate-dir / --candidate-source)", file=sys.stderr)
        return 1

    docs = []
    for name, endpoint, body, fp in matches:
        if not args.json:
            print(f"{name}\t/v1/{endpoint}\tfingerprint={fp}")
        entry = {"recording": name, "endpoint": endpoint, "fingerprint": fp}
        for label, explainer in sides:
            decision, explanation = _explain_one(explainer, endpoint, body)
            if args.json:
                entry[label] = {"decision": decision, "explanation": explanation}
            else:
                print(render_tree(label, decision, explanation))
        if args.json:
            docs.append(entry)
        else:
            print()
    if args.json:
        print(json.dumps({"scanned": scanned, "unparseable": unparseable,
                          "matched": len(matches), "results": docs}, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
