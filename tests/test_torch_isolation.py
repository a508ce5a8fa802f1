"""The PyTorch port stands alone: no module under cedar_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package (cedar_tpu), not even a
JAX-free module of it. Scanned from the AST, so lazy imports inside
functions count too; and the webhook entry point and the offline CLIs run
with both blocked at import."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "cedar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "cedar_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value.split(".")[0], node.lineno


def test_port_has_files():
    assert len(FILES) > 20
    assert (REPO / "cedar_tpu_torch" / "csrc" / "match.cu").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_cedar_tpu_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


# runs a CLI module (argv[1]) as __main__ with jax and the JAX package
# unimportable; the rest of argv is the CLI's
BLOCKED_MAIN = (
    "import runpy, sys\n"
    "module = sys.argv.pop(1)\n"
    "BLOCKED = ('jax', 'jaxlib', 'cedar_tpu')\n"
    "for m in list(sys.modules):\n"
    "    if m.split('.')[0] in BLOCKED:\n"
    "        del sys.modules[m]\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in BLOCKED:\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv[0] = module\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
)


def run_blocked(module: str, *argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-c", BLOCKED_MAIN, module, *argv],
        env=env, capture_output=True, text=True, timeout=120,
    )


def test_webhook_help_runs_with_jax_blocked():
    proc = run_blocked("cedar_tpu_torch.cli.webhook", "--help")
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--tenant" in proc.stdout
    assert "--fleet-replicas" not in proc.stdout


# each offline CLI with jax and the JAX package blocked: (argv, a word of
# its output); the schema formatter takes no flags, so it formats a file
OFFLINE_CLIS = {
    "schema_generator": (["--help"], "--openapi-dir"),
    "validator": (["--help"], "--schema"),
    "policy_formatter": (["--help"], "--strip-comments"),
    "converter": (["--help"], "--kubeconfig"),
    "schema_formatter": ([str(REPO / "cedarschema" / "k8s-authorization.cedarschema")],
                         "namespace k8s"),
}


@pytest.mark.parametrize("cli", sorted(OFFLINE_CLIS))
def test_offline_cli_runs_with_jax_blocked(cli):
    argv, word = OFFLINE_CLIS[cli]
    proc = run_blocked(f"cedar_tpu_torch.cli.{cli}", *argv)
    assert proc.returncode == 0, proc.stderr
    assert word in proc.stdout


def test_offline_cli_does_not_initialise_cuda():
    """Importing the offline CLIs leaves torch unimported: they do no
    tensor work and start no device."""
    code = (
        "import sys\n"
        "for m in ('schema_generator', 'schema_formatter', 'validator',"
        " 'policy_formatter', 'converter'):\n"
        "    __import__('cedar_tpu_torch.cli.' + m)\n"
        "print('torch' in sys.modules)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
