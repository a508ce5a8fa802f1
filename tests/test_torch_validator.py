"""The port's validator and type checker (cli/validator.py,
schema/typecheck.py) against the JAX package's, at tolerance 0: the same
policies and schema through both, the findings equal in text and order, and
the CLI's stdout, stderr and exit code equal.

Inputs: every *.cedar file in the repo, and the broken and well-typed
policies of tests/test_validator.py, written out here.
"""

import json
import pathlib

import pytest

from cedar_tpu.cli import validator as j_val
from cedar_tpu.lang import parse_policies as j_parse
from cedar_tpu.schema import typecheck as j_tc
from cedar_tpu.schema.model import CedarSchema as JSchema
from cedar_tpu_torch.cli import validator as t_val
from cedar_tpu_torch.lang import parse_policies as t_parse
from cedar_tpu_torch.schema import typecheck as t_tc
from cedar_tpu_torch.schema.model import CedarSchema as TSchema

REPO = pathlib.Path(__file__).resolve().parent.parent
SCHEMAS = {
    "full": REPO / "cedarschema" / "k8s-full.cedarschema.json",
    "authorization": REPO / "cedarschema" / "k8s-authorization.cedarschema.json",
}
CEDAR_FILES = sorted(
    p for p in REPO.rglob("*.cedar")
    if not {".git", "_archive", "chiprun_out"} & set(p.relative_to(REPO).parts)
)


@pytest.fixture(scope="module")
def schemas():
    out = {}
    for name, path in SCHEMAS.items():
        doc = json.loads(path.read_text())
        out[name] = (JSchema.from_json(doc), TSchema.from_json(doc))
    return out


def _findings(val, parse, schema, src: str):
    found = []
    for p in parse(src, filename="inline"):
        found.extend(val.validate_policy(schema, p, "inline"))
    return [str(f) for f in found]


def _both(schemas, src: str, which: str = "full"):
    js, ts = schemas[which]
    return _findings(j_val, j_parse, js, src), _findings(t_val, t_parse, ts, src)


def test_repo_has_policy_files():
    assert len(CEDAR_FILES) >= 10


@pytest.mark.parametrize("which", sorted(SCHEMAS))
@pytest.mark.parametrize("path", CEDAR_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_validate_file_equals_jax(path, which, schemas):
    js, ts = schemas[which]
    jn, jf = j_val.validate_file(js, path)
    tn, tf = t_val.validate_file(ts, path)
    assert (tn, [str(f) for f in tf]) == (jn, [str(f) for f in jf])


@pytest.mark.parametrize("which", sorted(SCHEMAS))
def test_validator_cli_over_repo_equals_jax(which, capsys):
    argv = ["--schema", str(SCHEMAS[which])] + [str(p) for p in CEDAR_FILES]
    out = []
    for main in (j_val.main, t_val.main):
        rc = main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]


def test_validator_cli_over_directory_equals_jax(capsys):
    argv = ["--schema", str(SCHEMAS["full"]), str(REPO / "tests" / "testdata" / "rbac")]
    out = []
    for main in (j_val.main, t_val.main):
        rc = main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]
    assert out[1][0] == 0


# the broken policies of tests/test_validator.py, each with a fragment its
# findings must carry
BROKEN = [
    ('permit (principal is k8s::Bogus, action, resource);',
     "unknown entity type 'k8s::Bogus'"),
    ('permit (principal, action == k8s::Action::"frobnicate", resource);',
     'unknown action k8s::Action::"frobnicate"'),
    ('permit (principal, action, resource is k8s::Resource)'
     ' when { resource.nosuchattr == "x" };', "no attribute path 'nosuchattr'"),
    ('permit (principal is k8s::User, action == k8s::Action::"update",'
     " resource is k8s::NonResourceURL);", "does not apply to resource type"),
    ("permit (principal is k8s::User, action in"
     ' [k8s::Action::"update", k8s::Action::"create"],'
     " resource is k8s::NonResourceURL);", "no action in the set applies"),
    ("permit (principal, action, resource is core::v1::Pod)"
     " when { resource.spec.bogusField == true };", "no attribute path"),
    # operand types
    ('permit (principal is k8s::User, action, resource) when { principal.name < 3 };',
     "must be Long"),
    ('permit (principal is k8s::User, action, resource) when { principal.name == 3 };',
     "always false"),
    ('permit (principal is k8s::User, action, resource) when { principal.name && true };',
     "must be Boolean"),
    ('permit (principal, action, resource is k8s::Resource)'
     ' when { resource.resource like "p*" && resource.name + 1 > 2 };', "must be Long"),
    ('permit (principal is k8s::User, action, resource)'
     ' when { principal.name.contains("x") };', "must be Set"),
    ('permit (principal, action, resource is k8s::Resource) when { resource.namespace };',
     "condition must be Boolean"),
    ('permit (principal is k8s::User, action, resource) when { !principal.name };',
     "must be Boolean"),
    ('permit (principal, action, resource is core::v1::ConfigMap)'
     ' when { resource.metadata.name like "x*" &&'
     ' resource.metadata.generation like "y*" };', "operand of like"),
    ('permit (principal, action, resource is k8s::Resource)'
     ' when { if resource.resource then true else false };', "if condition"),
    # bare principal / resource, typed by the appliesTo union
    ('permit (principal, action, resource) when { principal.name < 3 };', "must be Long"),
    ('permit (principal, action == k8s::Action::"get", resource)'
     ' when { principal.name + 1 > 0 };', "must be Long"),
    ("permit (principal, action in"
     ' [k8s::admission::Action::"create", k8s::admission::Action::"update"],'
     " resource) when { principal.name && true };", "must be Boolean"),
    # scope and condition `in` that no type can satisfy
    ('permit (principal in k8s::Resource::"r", action, resource);', "can never hold"),
    ('permit (principal is k8s::Node in k8s::User::"u", action, resource);',
     "can never hold"),
    ("permit (principal is k8s::User, action, resource)"
     ' when { principal in k8s::Resource::"r" };', "always false"),
]


@pytest.mark.parametrize("which", sorted(SCHEMAS))
@pytest.mark.parametrize("src,fragment", BROKEN, ids=[f"broken{i}" for i in range(len(BROKEN))])
def test_broken_policy_findings_equal_jax(src, fragment, which, schemas):
    j, t = _both(schemas, src, which)
    assert t == j
    if which == "full":
        assert any(fragment in f for f in t), t


# policies that must stay clean of the findings above
CLEAN = [
    "permit (principal is k8s::User, action in"
    ' [k8s::Action::"impersonate", k8s::Action::"get"], resource is k8s::Resource);',
    "permit (principal is k8s::User,"
    ' action == k8s::admission::Action::"create", resource is core::v1::Pod)'
    ' when { resource.metadata.name == "x" };',
    'permit (principal, action, resource) when { principal.name == "x" };',
    'permit (principal, action, resource)'
    ' when { resource has path && resource.path like "/api*" };',
    'permit (principal in k8s::Group::"g", action, resource);',
    'permit (principal is k8s::ServiceAccount in k8s::Group::"g", action, resource);',
    'permit (principal in k8s::User::"u", action, resource);',
    'permit (principal is k8s::User, action, resource) when { principal in k8s::Group::"g" };',
    'permit (principal, action, resource) when { principal in k8s::Resource::"r" };',
    'permit (principal is k8s::User, action, resource) when { principal in ext::Team::"t" };',
    'permit (principal is k8s::User, action, resource) when { principal.name == "sam" };',
    'permit (principal, action, resource is k8s::Resource) when { resource.resource like "pod*" };',
    'permit (principal, action, resource is core::v1::ConfigMap)'
    ' when { resource.metadata.generation > 3 };',
    'permit (principal is k8s::User, action, resource)'
    ' when { principal.extra.contains({key: "k", values: ["v"]}) };',
    'permit (principal, action, resource is k8s::Resource)'
    ' when { ["pods", "services"].contains(resource.resource) };',
]


@pytest.mark.parametrize("which", sorted(SCHEMAS))
@pytest.mark.parametrize("src", CLEAN, ids=[f"clean{i}" for i in range(len(CLEAN))])
def test_clean_policy_findings_equal_jax(src, which, schemas):
    j, t = _both(schemas, src, which)
    assert t == j
    if which == "full":
        assert not [f for f in t if "type error" in f or "can never hold" in f
                    or "always false" in f], t


def test_validator_cli_with_findings_equals_jax(tmp_path, capsys):
    """Exit code 1 and every finding on stderr, in order, as JAX prints
    them; a parse error and an unreadable file are findings too."""
    bad = tmp_path / "bad"
    bad.mkdir()
    for i, (src, _) in enumerate(BROKEN):
        (bad / f"b{i:02d}.cedar").write_text(src + "\n")
    (bad / "zz-parse.cedar").write_text("permit (principal, action resource);\n")
    argv = ["--schema", str(SCHEMAS["full"]), str(bad), str(tmp_path / "missing.cedar")]
    out = []
    for main in (j_val.main, t_val.main):
        rc = main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]
    assert out[1][0] == 1 and "parse error" in out[1][2] and "unreadable" in out[1][2]


def test_in_feasible_and_entity_def_equal_jax():
    doc = {
        "": {"entityTypes": {"Resource": {"shape": {"type": "Record"}}}, "actions": {}},
        "a": {
            "entityTypes": {
                "X": {"shape": {"type": "Record"}, "memberOfTypes": ["Resource"]},
                "Resource": {"shape": {"type": "Record"}},
                "Y": {"shape": {"type": "Record"}, "memberOfTypes": ["ext::Team"]},
                "T": {"shape": {"type": "Record"}},
            },
            "actions": {},
        },
    }
    js, ts = JSchema.from_json(doc), TSchema.from_json(doc)
    names = ["a::X", "a::Y", "a::T", "a::Resource", "Resource", "ext::Team", "X", "nope::Z"]
    for v in names:
        jd, td = j_tc.entity_def(js, v), t_tc.entity_def(ts, v)
        assert (td is None) == (jd is None), v
        for tgt in names:
            assert t_tc.in_feasible(ts, v, tgt) == j_tc.in_feasible(js, v, tgt), (v, tgt)
    assert t_tc.in_feasible(ts, "a::X", "a::Resource")
    assert not t_tc.in_feasible(ts, "a::X", "Resource")


@pytest.mark.parametrize("path", CEDAR_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_typecheck_policy_equals_jax(path, schemas):
    """typecheck_policy alone, over each policy of each repo file, with
    the principal and resource types each policy's scope names."""
    js, ts = schemas["full"]
    jp = j_parse(path.read_text(), filename=str(path))
    tp = t_parse(path.read_text(), filename=str(path))
    assert len(tp) == len(jp)
    for a, b in zip(jp, tp):
        ja = j_tc.typecheck_policy(js, a, j_val._scope_type(a.principal),
                                   j_val._scope_type(a.resource))
        ta = t_tc.typecheck_policy(ts, b, t_val._scope_type(b.principal),
                                   t_val._scope_type(b.resource))
        assert ta == ja
