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


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch/datasets/normalizers.py",
    "deeplearning4j_tpu_torch/datasets/fetchers.py",
    "deeplearning4j_tpu_torch/datasets/records.py",
    "deeplearning4j_tpu_torch/datasets/images.py",
    "deeplearning4j_tpu_torch/datasets/cacheable.py",
    "deeplearning4j_tpu_torch/datasets/iterator.py",
    "deeplearning4j_tpu_torch/nn/layers/core.py", "deeplearning4j_tpu_torch/nn/layers/vae.py",
    "deeplearning4j_tpu_torch/nn/solvers.py", "deeplearning4j_tpu_torch/nn/simple.py",
    "deeplearning4j_tpu_torch/nn/conf/memory.py", "deeplearning4j_tpu_torch/nn/conf/__init__.py",
    "deeplearning4j_tpu_torch/utils/gradcheck.py",
    "deeplearning4j_tpu_torch/utils/quantization.py",
    "deeplearning4j_tpu_torch/utils/timeseries.py",
    "deeplearning4j_tpu_torch/serving/registry.py", "deeplearning4j_tpu_torch/cli.py"])
def test_the_sweep_covers_the_rest_of_the_training_core(module):
    """The data tier, layers, solvers and utilities copied or ported from
    the JAX package's numpy-only and jnp modules are AST-checked too."""
    assert module in SOURCES


def test_the_fetchers_need_no_pil_at_import():
    """The card's host may lack PIL: the fetchers, image loader and the
    MNIST path import it only where an image is decoded."""
    code = ("import sys\n"
            "sys.modules['PIL'] = None\n"
            "from deeplearning4j_tpu_torch.datasets import fetchers, images, normalizers\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch/native/__init__.py", "deeplearning4j_tpu_torch/native/h5.py",
    "deeplearning4j_tpu_torch/native/codec.py", "deeplearning4j_tpu_torch/native/queue.py",
    "deeplearning4j_tpu_torch/native/etl.py",
    "deeplearning4j_tpu_torch/modelimport/__init__.py",
    "deeplearning4j_tpu_torch/modelimport/dl4j.py",
    "deeplearning4j_tpu_torch/modelimport/keras.py",
    "deeplearning4j_tpu_torch/modelimport/layers.py",
    "deeplearning4j_tpu_torch/modelimport/_tensors.py"])
def test_the_sweep_covers_model_import(module):
    """The native bridges and the model importers, copied and ported from
    the JAX package, are AST-checked and imported with JAX blocked."""
    assert module in SOURCES


def test_the_native_sources_are_the_ports_own_copy():
    """The port builds its own copy of the C++ sources, never the JAX
    package's root ``native/``: its loader names no path outside it."""
    from deeplearning4j_tpu_torch import native

    src = ROOT / "deeplearning4j_tpu_torch" / "native" / "src"
    assert sorted(p.name for p in src.glob("*.cc")) == sorted(native._SOURCES)
    assert native._SRC_DIR == src
    assert native.library_path().parent == ROOT / "deeplearning4j_tpu_torch" / "_build"
