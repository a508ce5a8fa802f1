"""The PyTorch port stands alone: no module under cedar_tpu_torch/, and not
chip_smoke.py, imports jax or the JAX package (cedar_tpu), not even a
JAX-free module of it. Scanned from the AST, so lazy imports inside
functions count too; and the webhook entry point runs with both blocked
at import."""

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


# runs the webhook CLI as __main__ with jax and the JAX package unimportable
BLOCKED_MAIN = (
    "import runpy, sys\n"
    "BLOCKED = ('jax', 'jaxlib', 'cedar_tpu')\n"
    "for m in list(sys.modules):\n"
    "    if m.split('.')[0] in BLOCKED:\n"
    "        del sys.modules[m]\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in BLOCKED:\n"
    "            raise ImportError(name + ' is blocked')\n"
    "sys.meta_path.insert(0, Block())\n"
    "sys.argv[0] = 'cedar-webhook'\n"
    "runpy.run_module('cedar_tpu_torch.cli.webhook', run_name='__main__', alter_sys=True)\n"
)


def test_webhook_help_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_MAIN, "--help"],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--tenant" in proc.stdout
    assert "--fleet-replicas" not in proc.stdout
