"""The port stands alone: nothing in ``deeplearning4j_tpu_torch/`` or
``chip_smoke.py`` imports jax, jaxlib or the JAX package."""

import ast
import os
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


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch/streaming/__init__.py",
    "deeplearning4j_tpu_torch/streaming/codec.py",
    "deeplearning4j_tpu_torch/streaming/pubsub.py",
    "deeplearning4j_tpu_torch/continuous/__init__.py",
    "deeplearning4j_tpu_torch/continuous/chaos.py",
    "deeplearning4j_tpu_torch/continuous/trainer.py",
    "deeplearning4j_tpu_torch/continuous/runner.py",
    "deeplearning4j_tpu_torch/fleet/__init__.py",
    "deeplearning4j_tpu_torch/fleet/worker.py",
    "deeplearning4j_tpu_torch/fleet/router.py",
    "deeplearning4j_tpu_torch/fleet/prober.py",
    "deeplearning4j_tpu_torch/fleet/supervisor.py"])
def test_the_sweep_covers_streaming_continuous_and_fleet(module):
    """The streaming tier, the continuous trainer and the serving fleet are
    AST-checked and imported with JAX blocked, the runner and worker
    subprocesses' entry points among them."""
    assert module in SOURCES


@pytest.mark.parametrize("module", [
    "deeplearning4j_tpu_torch/ui/__init__.py",
    "deeplearning4j_tpu_torch/ui/storage.py",
    "deeplearning4j_tpu_torch/ui/components.py",
    "deeplearning4j_tpu_torch/ui/stats.py",
    "deeplearning4j_tpu_torch/ui/visualization.py",
    "deeplearning4j_tpu_torch/ui/server.py",
    "deeplearning4j_tpu_torch/hostfleet/__init__.py",
    "deeplearning4j_tpu_torch/hostfleet/exchange.py",
    "deeplearning4j_tpu_torch/hostfleet/worker.py",
    "deeplearning4j_tpu_torch/hostfleet/supervisor.py",
    "deeplearning4j_tpu_torch/mlpipeline.py"])
def test_the_sweep_covers_the_dashboard_hostfleet_and_mlpipeline(module):
    """The training dashboard, the elastic training fleet and the sklearn
    adapters (the jax-free storage, components and exchange copied, not
    imported) are AST-checked and imported with JAX blocked."""
    assert module in SOURCES


def test_the_hostfleet_worker_runs_as_a_module_with_jax_blocked(tmp_path):
    """The supervisor's subprocess entry, ``-m
    deeplearning4j_tpu_torch.hostfleet.worker``, with JAX and its package
    made unimportable: a one-round job runs to its done line."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['worker', '--process-id', '0', '--num-processes', '1', '--bundle',\n"
            f"            {str(tmp_path / 'b.zip')!r}, '--total-rounds', '1',\n"
            f"            '--heartbeat-dir', {str(tmp_path / 'hb')!r}, '--device', 'cpu']\n"
            "runpy.run_module('deeplearning4j_tpu_torch.hostfleet.worker', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert '"hostfleet_done": true' in proc.stdout


def test_the_fake_fleet_worker_imports_neither_jax_nor_torch():
    """The tests' fake fleet worker speaks the wire protocol with the
    standard library alone, so supervisor lifecycle tests cost
    milliseconds per spawn."""
    source = "tests/torch_fake_fleet_worker.py"
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN + ("torch", "deeplearning4j_tpu_torch")]
    assert not bad, f"{source} imports {bad}"


ANALYSIS = sorted(s for s in SOURCES if s.startswith("deeplearning4j_tpu_torch/analysis/"))


@pytest.mark.parametrize("source", ANALYSIS)
def test_the_linter_imports_no_accelerator_stack(source):
    """graftlint and graftsan are pure stdlib: no module of the port's
    ``analysis/`` imports torch (nor jax, nor the JAX package), so the
    linter runs on a host without either."""
    tree = ast.parse((ROOT / source).read_text(), filename=source)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN + ("torch", "numpy")]
    assert not bad, f"{source} imports {bad}"


def test_the_lint_verb_runs_with_torch_blocked(tmp_path):
    """``python -m deeplearning4j_tpu_torch lint`` on a file, with torch,
    jax and the JAX package unimportable: the verb needs none of them."""
    bad = tmp_path / "bad.py"
    bad.write_text("import threading\nt = threading.Thread(target=print)\n")
    code = ("import sys\n"
            "for name in ('torch', 'jax', 'jaxlib', 'deeplearning4j_tpu'):\n"
            "    sys.modules[name] = None\n"
            "from deeplearning4j_tpu_torch.cli import main\n"
            f"sys.exit(main(['lint', '--no-baseline', {str(bad)!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "R6[thread-discipline]" in proc.stderr
