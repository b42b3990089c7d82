"""The port stands alone: nothing in ``deeplearning4j_tpu_torch/`` or
``chip_smoke.py`` imports jax, jaxlib or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")
SOURCES = sorted(p.relative_to(ROOT).as_posix()
                 for p in (ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("source", SOURCES)
def test_no_jax_imports(source):
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{source} imports {bad}"


def test_package_imports_with_jax_blocked():
    modules = sorted(p[:-3].replace("/", ".") for p in SOURCES
                     if p.startswith("deeplearning4j_tpu_torch/") and not p.endswith("__main__.py"))
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch/text/word2vec.py", "deeplearning4j_tpu_torch/text/zh_lattice.py",
    "deeplearning4j_tpu_torch/graphlib/deepwalk.py", "deeplearning4j_tpu_torch/graphlib/loader.py",
    "deeplearning4j_tpu_torch/clustering/tsne.py", "deeplearning4j_tpu_torch/clustering/server.py",
    "deeplearning4j_tpu_torch/utils/hostsync.py"])
def test_the_sweep_covers_the_nlp_tier(module):
    """The copied and ported NLP modules are among the AST-checked sources,
    so none keeps an import of the JAX package."""
    assert module in SOURCES
