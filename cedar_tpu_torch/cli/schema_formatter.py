"""cedarschema re-indenter CLI.

Behavior parity with reference cmd/schema-formatter/main.go:22-73: splits
packed ``{"..."`` / ``, "..."`` runs onto their own lines and re-indents by
brace depth with tabs; namespace-closing braces get a trailing blank line;
``{}`` literals and ``@...({...})`` annotation lines are left intact.
"""

from __future__ import annotations

import sys
from typing import List, Optional

_PLACEHOLDER = "__EMPTY_BRACES__"


def format_schema_text(content: str) -> str:
    content = content.replace("{}", _PLACEHOLDER)
    content = content.replace("  ", "")
    content = content.replace('{"', '{\n"')
    content = content.replace(', "', ',\n"')
    content = content.replace("}", "\n}")
    content = content.replace(_PLACEHOLDER, "{}")

    out: List[str] = []
    brace_count = 0
    for line in content.split("\n"):
        indent = "\t" * max(brace_count, 0)
        if line == "}" and brace_count == 1:
            out.append(line.rstrip() + "\n")
        elif (
            (line.endswith("};") and not line.endswith("{};"))
            or line.endswith("},")
            or (
                line.endswith("}")
                and not line.endswith("{}")
                and not line.startswith("@")
            )
        ):
            out.append("\t" * max(brace_count - 1, 0) + line.rstrip())
        elif line:
            out.append(indent + line.rstrip())
        if "{" in line:
            brace_count += 1
        if "}" in line:
            brace_count -= 1
    return "\n".join(out) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: schema-formatter <file.cedarschema>", file=sys.stderr)
        return 1
    with open(args[0]) as f:
        sys.stdout.write(format_schema_text(f.read()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
