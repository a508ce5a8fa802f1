"""cedar-trace: list and print request span trees (a copy of the JAX
package's cli/trace.py).

    python -m cedar_tpu_torch.cli.trace --log trace.jsonl [TRACE_ID]

The offline/online viewer for the request tracing plane (obs/trace.py):

  * ``cedar-trace --log trace.jsonl`` — list the traces in a
    ``--trace-log-file`` JSONL export, newest first;
  * ``cedar-trace --url http://127.0.0.1:10289`` — the same against a
    live server's ``/debug/traces`` ring (the metrics listener);
  * append a trace id (unambiguous prefix accepted) to print one trace's
    span tree with per-span durations and attributes, the fraction of the
    request's e2e latency the named spans account for, and WHICH stage
    dominated — the question the plane exists to answer.

Exit codes: 0 success; 2 no matching trace (or an empty source — nothing
to show is a query miss, not a tool failure); 1 unreadable input or
transport errors. Unparseable trace-log lines are COUNTED and reported,
never silently skipped.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

from ..obs.trace import span_tree_coverage


def _load_log(path: str) -> Tuple[List[dict], int]:
    """(traces, unparseable line count) from a JSONL trace log."""
    traces: List[dict] = []
    bad = 0
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict) or "traceId" not in doc:
                    raise ValueError("not a trace document")
            except (ValueError, TypeError):
                bad += 1
                continue
            traces.append(doc)
    return traces, bad


def _fetch_url(base: str, trace_id: str = "") -> Optional[dict]:
    import urllib.error
    import urllib.request

    url = base.rstrip("/") + "/debug/traces"
    if trace_id:
        url += "/" + trace_id
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def dominant_stage(doc: dict) -> Tuple[str, float]:
    """(span name, share of e2e) for the longest non-root span — 'which
    stage dominated' with one glance."""
    total = doc.get("duration_us", 0.0) or 1.0
    root_id = doc["spans"][0]["spanId"] if doc.get("spans") else None
    best_name, best_dur = "", 0.0
    for s in doc.get("spans", ()):
        if s["spanId"] == root_id:
            continue
        if s["duration_us"] > best_dur:
            best_name, best_dur = s["name"], s["duration_us"]
    return best_name, best_dur / total


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.3f}s"
    if us >= 1e3:
        return f"{us / 1e3:.2f}ms"
    return f"{us:.0f}µs"


def print_tree(doc: dict, out=None) -> None:
    out = out or sys.stdout  # bound at CALL time so redirection works
    spans = doc.get("spans", [])
    root_id = spans[0]["spanId"] if spans else None
    children: dict = {}
    for s in spans:
        children.setdefault(s.get("parent"), []).append(s)

    def walk(span, depth):
        attrs = "".join(
            f" {k}={v!r}" for k, v in (span.get("attrs") or {}).items()
        )
        out.write(
            f"{'  ' * depth}{span['name']:<24} "
            f"+{_fmt_us(span['start_us'])} "
            f"({_fmt_us(span['duration_us'])}){attrs}\n"
        )
        for child in sorted(
            children.get(span["spanId"], []), key=lambda c: c["start_us"]
        ):
            walk(child, depth + 1)

    worker = f" worker={doc['worker']}" if doc.get("worker") else ""
    out.write(
        f"trace {doc['traceId']} path={doc['path']} "
        f"decision={doc.get('decision')} kept={doc.get('kept') or '-'} "
        f"e2e={_fmt_us(doc.get('duration_us', 0.0))}{worker}\n"
    )
    if doc.get("upstreamParent"):
        out.write(f"  upstream parent span: {doc['upstreamParent']}\n")
    for s in spans:
        if s["spanId"] == root_id:
            for child in sorted(
                children.get(root_id, []), key=lambda c: c["start_us"]
            ):
                walk(child, 1)
            break
    name, share = dominant_stage(doc)
    coverage = span_tree_coverage(doc)
    if name:
        out.write(
            f"  dominant stage: {name} ({share * 100:.1f}% of e2e); "
            f"named spans cover {coverage * 100:.1f}% of e2e\n"
        )
    else:
        out.write("  no stage spans recorded\n")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cedar-trace",
        description="List/print request span trees from a --trace-log-file "
        "JSONL export or a live /debug/traces ring",
    )
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--log", default="", help="trace log (JSONL) path")
    source.add_argument(
        "--url",
        default="",
        help="metrics listener base URL (e.g. http://127.0.0.1:10289)",
    )
    parser.add_argument(
        "trace_id",
        nargs="?",
        default="",
        help="trace id (unambiguous prefix accepted); omit to list",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit raw JSON instead of text"
    )
    parser.add_argument(
        "--limit", type=int, default=32, help="list at most N traces"
    )
    args = parser.parse_args(argv)

    try:
        if args.log:
            traces, bad = _load_log(args.log)
            if bad:
                print(
                    f"warning: {bad} unparseable line(s) in {args.log}",
                    file=sys.stderr,
                )
            if args.trace_id:
                doc = next(
                    (
                        t
                        for t in reversed(traces)
                        if t["traceId"].startswith(args.trace_id)
                    ),
                    None,
                )
            else:
                doc = None
        else:
            traces = None
            doc = _fetch_url(args.url, args.trace_id) if args.trace_id else None
            if not args.trace_id:
                listing = _fetch_url(args.url)
                traces = (listing or {}).get("traces", [])
    except OSError as e:
        print(f"error: cannot read traces: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — transport/JSON errors
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.trace_id:
        if doc is None:
            print(f"no trace matches {args.trace_id!r}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(doc, indent=2))
        else:
            print_tree(doc)
        return 0

    # list mode
    if not traces:
        print("no traces recorded", file=sys.stderr)
        return 2
    rows = traces[-args.limit :] if args.log else traces[: args.limit]
    if args.log:
        rows = list(reversed(rows))  # newest first, like the ring listing
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    print(
        f"{'TRACE':<34}{'PATH':<15}{'DECISION':<11}{'E2E':>10}  "
        f"{'KEPT':<9}DOMINANT"
    )
    for t in rows:
        if isinstance(t.get("spans"), list):
            name, share = dominant_stage(t)
            dom = f"{name} ({share * 100:.0f}%)" if name else "-"
        else:
            dom = "-"  # ring summaries carry a span COUNT, not the spans
        print(
            f"{t['traceId']:<34}{t['path']:<15}"
            f"{str(t.get('decision')):<11}"
            f"{_fmt_us(t.get('duration_us', 0.0)):>10}  "
            f"{t.get('kept') or '-':<9}{dom}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
