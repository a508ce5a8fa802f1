"""cedar-policy-formatter: canonicalize Cedar policy files in place.

Subsumes the repo-maintenance role the reference delegates to the Rust
``cedar-policy-cli`` (``cedar format``, reference Makefile
``format-policies`` target): every ``*.cedar`` file is parsed with this
framework's own parser and re-serialized through lang/format.py — the
same layout the RBAC converter emits (tests/test_format.py proves the
round trip preserves decisions).

Comment handling: the parser does not retain comments, so the formatter
re-attaches LEADING ``//`` lines (the run above each policy, blank lines
crossed — unless the comment hugs the code above it, which marks it as a
trailing comment) itself — the common documentation style, e.g.
mount/policies/demo.cedar. A file whose comments appear anywhere else
(inline after code, inside a policy body, trailing the last policy) is
SKIPPED with a warning rather than silently stripped; pass
``--strip-comments`` to format it anyway, losing exactly those comments.

``--check`` reports files that would change without writing and exits 1
(the CI mode); skipped commented files also FAIL the check — a skipped
file is an unchecked file, and CI must not silently lose coverage.
Golden corpus files (tests/testdata) are deliberately NOT covered by
``make format-policies`` — they pin byte-parity with the reference's
converter output, not this formatter's layout.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Tuple


def _comment_spans(text: str) -> List[Tuple[int, int]]:
    """(start, end) offsets of every ``//`` line comment OUTSIDE string
    literals. Cedar strings are double-quoted with backslash escapes."""
    spans = []
    i, n = 0, len(text)
    in_str = False
    while i < n:
        c = text[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == "/" and i + 1 < n and text[i + 1] == "/":
            j = text.find("\n", i)
            j = n if j == -1 else j
            spans.append((i, j))
            i = j
            continue
        i += 1
    return spans


class _HasUnattachableComments(Exception):
    pass


def format_source(text: str, strip_comments: bool = False) -> str:
    """Parse + re-serialize one policy file's text (canonical layout),
    re-attaching leading per-policy ``//`` comments. Raises
    _HasUnattachableComments when other comment placements exist and
    strip_comments is False."""
    from ..lang import PolicySet
    from ..lang.format import format_policy

    ps = PolicySet.from_source(text, "fmt")
    pols = ps.policies()
    lines = text.splitlines()
    attached: set = set()  # 0-based line indices of re-attached comments
    blocks = []
    for p in pols:
        lead: List[str] = []
        j = p.position[1] - 2  # 0-based index of the line above the policy
        # stop at lines another policy already claimed: two policies on
        # one source line share the same "line above" — the comment
        # attaches to the FIRST of them only, never duplicated. Blank
        # lines between the comment block and the policy (or between
        # comment blocks) are crossed, so documentation separated by
        # spacing still attaches — EXCEPT a block that hugs the code
        # above it while a blank separates it from this policy: that is
        # the previous policy's TRAILING comment, and claiming it would
        # silently re-home it; leave it unattached (file skipped).
        crossed_blank = False
        while j >= 0 and j not in attached:
            stripped = lines[j].strip()
            if stripped == "":
                crossed_blank = True
                j -= 1
                continue
            if not stripped.startswith("//"):
                break
            g = j
            group: List[tuple] = []
            while (
                g >= 0
                and g not in attached
                and lines[g].strip().startswith("//")
            ):
                group.append((g, lines[g].strip()))
                g -= 1
            if (
                crossed_blank
                and g >= 0
                and g not in attached
                and lines[g].strip() != ""
            ):
                break  # trailing comment of the code above — not ours
            for idx, s in group:
                lead.append(s)
                attached.add(idx)
            j = g
        lead.reverse()
        blocks.append("\n".join(lead + [format_policy(p)]))
    if not strip_comments:
        for start, _end in _comment_spans(text):
            line_idx = text.count("\n", 0, start)
            at_line_start = lines[line_idx].lstrip().startswith("//")
            if not (at_line_start and line_idx in attached):
                raise _HasUnattachableComments(
                    f"line {line_idx + 1}: comment is not a leading "
                    "per-policy line"
                )
    return "\n\n".join(blocks) + ("\n" if blocks else "")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cedar-policy-formatter", description=__doc__
    )
    parser.add_argument(
        "files", nargs="*", help="*.cedar policy files to format"
    )
    parser.add_argument(
        "--check",
        action="store_true",
        help="exit 1 if any file would change; write nothing",
    )
    parser.add_argument(
        "--strip-comments",
        action="store_true",
        help="format files with inline/trailing comments anyway (those "
        "comments are deleted; leading per-policy comments are always "
        "preserved)",
    )
    args = parser.parse_args(argv)
    changed = 0
    failed = 0
    skipped = 0
    for name in args.files:
        path = pathlib.Path(name)
        try:
            text = path.read_text()
            out = format_source(text, strip_comments=args.strip_comments)
        except _HasUnattachableComments as e:
            print(
                f"{name}: skipped ({e}; --strip-comments to force)",
                file=sys.stderr,
            )
            skipped += 1
            continue
        except Exception as e:  # noqa: BLE001 — report per file, keep going
            print(f"{name}: ERROR: {e}", file=sys.stderr)
            failed += 1
            continue
        if out == text:
            continue
        changed += 1
        if args.check:
            print(f"{name}: needs formatting")
        else:
            path.write_text(out)
            print(f"{name}: formatted")
    if skipped:
        print(
            f"{skipped} file(s) skipped (unattachable comments) — not "
            + ("checked" if args.check else "formatted"),
            file=sys.stderr,
        )
    if failed:
        return 2
    # --check must not silently lose coverage: a skipped file is an
    # unchecked file, and CI treating it as success would let an
    # unformatted (or unformattable) file rot — fail the check instead
    if args.check and (changed or skipped):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
