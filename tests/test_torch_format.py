"""The port's policy formatter (cli/policy_formatter.py) and JSON policy
form (lang/json_format.py) against the JAX package's, at tolerance 0: the
same text through both, the formatted text, the raised error, the CLI's
stdout, stderr and exit code, and the JSON, equal byte for byte.

Inputs: every *.cedar file in the repo, and the comment-placement cases of
tests/test_format.py, written out here.
"""

import json
import pathlib

import pytest

from cedar_tpu.cli import policy_formatter as j_pf
from cedar_tpu.lang import PolicySet as JPolicySet
from cedar_tpu.lang.json_format import policy_set_to_json as j_to_json
from cedar_tpu_torch.cli import policy_formatter as t_pf
from cedar_tpu_torch.lang import PolicySet as TPolicySet
from cedar_tpu_torch.lang.json_format import policy_set_to_json as t_to_json

REPO = pathlib.Path(__file__).resolve().parent.parent
CEDAR_FILES = sorted(
    p for p in REPO.rglob("*.cedar")
    if not {".git", "_archive", "chiprun_out"} & set(p.relative_to(REPO).parts)
)
_ID = dict(ids=lambda p: str(p.relative_to(REPO)))

# comment placements and layouts (tests/test_format.py's cases)
RAW = (
    'permit(principal,action    ==\n k8s::Action::"get",'
    "resource is k8s::Resource)   when{principal.name=="
    '"alice"};'
)
SOURCES = {
    "canonical-input": RAW,
    "leading-comments": "// keep me\n// and me\n" + RAW,
    "slashes-in-string": 'permit(principal,action,resource)when{principal.name=="https://x//y"};',
    "trailing-comment": "permit(principal,action,resource); // trailing\n",
    "blank-separated-doc": "// doc\n\n\npermit(principal,action,resource);",
    "trailing-not-rehomed": (
        "permit(principal,action,resource);\n"
        "// TODO: tighten the permit above\n\n"
        "forbid(principal,action,resource);"
    ),
    "shared-line": (
        "// note\npermit(principal,action,resource); "
        "permit(principal is k8s::User,action,resource);"
    ),
    "header-blank-first-policy": "// header\n\npermit(principal,action,resource);\n",
    "empty": "",
    "comment-only": "// nothing here\n",
    "all-permit": "permit (principal, action, resource);",
    "forbid-unless": (
        "forbid (principal is k8s::User, action in [k8s::Action::\"get\", "
        "k8s::Action::\"list\"], resource is k8s::Resource) when { resource has "
        "namespace && resource.namespace == \"kube-system\" || "
        "resource.labelSelector.containsAny([{\"key\": \"env\", \"operator\": \"in\", "
        "\"values\": [\"prod\"]}]) } unless { principal.name like \"system:*\" };"
    ),
    "annotated": (
        '@id("x")\npermit (principal in k8s::Group::"dev", action, resource)\n'
        "when { context has oldObject && context.oldObject has spec }\n"
        'when { if principal has name then principal.name != "" else false }\n'
        "unless { resource.ip.isLoopback() || resource.n < -3 + 2 * 4 };"
    ),
    "parse-error": "permit (principal, action resource);",
}


def _format(pf, text: str, strip: bool):
    """format_source's text, or the type and message it raised."""
    try:
        return "ok", pf.format_source(text, strip_comments=strip)
    except Exception as e:  # noqa: BLE001 — compared between the two
        return type(e).__name__, str(e)


@pytest.mark.parametrize("strip", [False, True], ids=["keep", "strip"])
@pytest.mark.parametrize("path", CEDAR_FILES, **_ID)
def test_format_source_of_repo_file_equals_jax(path, strip):
    text = path.read_text()
    assert _format(t_pf, text, strip) == _format(j_pf, text, strip)


@pytest.mark.parametrize("strip", [False, True], ids=["keep", "strip"])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_format_source_of_placement_case_equals_jax(name, strip):
    text = SOURCES[name]
    got = _format(t_pf, text, strip)
    assert got == _format(j_pf, text, strip)
    if name == "trailing-not-rehomed" and not strip:
        assert got[0] == "_HasUnattachableComments"


def _cli(capsys, main, argv):
    rc = main(list(argv))
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _cli_pair(capsys, tmp_path, files: dict, flags):
    """Both CLIs over their own copy of ``files``: (rc, stdout, stderr)
    with the copy's directory written as DIR, and the files after."""
    out = []
    for name, main in (("j", j_pf.main), ("t", t_pf.main)):
        d = tmp_path / name
        d.mkdir()
        paths = []
        for fname, text in files.items():
            (d / fname).write_text(text)
            paths.append(str(d / fname))
        rc, so, se = _cli(capsys, main, list(flags) + paths)
        after = {f: (d / f).read_text() for f in files}
        out.append((rc, so.replace(str(d), "DIR"), se.replace(str(d), "DIR"), after))
    return out


@pytest.mark.parametrize("flags", [["--check"], [], ["--strip-comments"],
                                   ["--check", "--strip-comments"]],
                         ids=["check", "write", "strip", "check-strip"])
@pytest.mark.parametrize("path", CEDAR_FILES, **_ID)
def test_formatter_cli_on_repo_file_equals_jax(path, flags, capsys, tmp_path):
    j, t = _cli_pair(capsys, tmp_path, {path.name: path.read_text()}, flags)
    assert t == j


@pytest.mark.parametrize("flags", [["--check"], [], ["--strip-comments"]],
                         ids=["check", "write", "strip"])
def test_formatter_cli_on_placement_cases_equals_jax(flags, capsys, tmp_path):
    """All the placement cases in one run: per-file lines and the summary,
    and the exit code (2 on a parse error, 1 under --check on a change or
    a skip)."""
    files = {f"{name}.cedar": text for name, text in sorted(SOURCES.items())}
    j, t = _cli_pair(capsys, tmp_path, files, flags)
    assert t == j
    assert t[0] == 2


@pytest.mark.parametrize("name", sorted(set(SOURCES) - {"parse-error"}))
def test_formatter_cli_check_exit_code_equals_jax(name, capsys, tmp_path):
    j, t = _cli_pair(capsys, tmp_path, {"p.cedar": SOURCES[name]}, ["--check"])
    assert t == j


def test_formatter_cli_no_files_equals_jax(capsys):
    assert _cli(capsys, t_pf.main, []) == _cli(capsys, j_pf.main, []) == (0, "", "")


def test_formatter_cli_write_then_check_equals_jax(capsys, tmp_path):
    """Format in place, then --check the result: idempotent in both."""
    files = {f"{name}.cedar": text for name, text in sorted(SOURCES.items())
             if name != "parse-error"}
    for step in ("write", "check"):
        (tmp_path / step).mkdir()
    j1, t1 = _cli_pair(capsys, tmp_path / "write", files, [])
    assert t1 == j1
    j2, t2 = _cli_pair(capsys, tmp_path / "check", t1[3], ["--check"])
    assert t2 == j2


@pytest.mark.parametrize("path", CEDAR_FILES, **_ID)
def test_policy_set_to_json_of_repo_file_equals_jax(path):
    text = path.read_text()
    jp = JPolicySet.from_source(text, path.name).policies()
    tp = TPolicySet.from_source(text, path.name).policies()
    j, t = j_to_json(jp), t_to_json(tp)
    assert json.dumps(t) == json.dumps(j)
    assert len(t["staticPolicies"]) == len(tp)


@pytest.mark.parametrize("name", sorted(set(SOURCES) - {"parse-error"}))
def test_policy_set_to_json_of_placement_case_equals_jax(name):
    text = SOURCES[name]
    j = j_to_json(JPolicySet.from_source(text, "p").policies())
    t = t_to_json(TPolicySet.from_source(text, "p").policies())
    assert json.dumps(t) == json.dumps(j)
