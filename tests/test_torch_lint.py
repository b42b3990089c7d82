"""graftlint for the port (``deeplearning4j_tpu_torch/analysis/``), the twin
of ``tests/test_lint.py``: every rule fires on a fixture with its fault and
stays silent on one without; the rules and the framework carried over
(R6, R9, R10-R13, suppressions, baselines, the JSON report, ``--diff``)
give the JAX package's findings on identical sources; the port lints clean
against its committed (empty) baseline, and ``--emit-schema`` writes the
port's schema inside its package, never the repo root's.

The whole port is linted once, in a module-scoped fixture; every other
test lints small inline sources (the analyzer never runs them).
"""

import ast
import io
import json
import subprocess
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from deeplearning4j_tpu import analysis as J
from deeplearning4j_tpu import cli as jax_cli
from deeplearning4j_tpu.analysis import reporters as jax_reporters
from deeplearning4j_tpu_torch import analysis as T
from deeplearning4j_tpu_torch import cli
from deeplearning4j_tpu_torch.analysis import reporters
from deeplearning4j_tpu_torch.analysis.dataflow import project_facts
from deeplearning4j_tpu_torch.analysis.rules import _facts

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deeplearning4j_tpu_torch"


def fired(src, rules=None, path="<string>", pkg=T):
    findings, err = pkg.lint_source(textwrap.dedent(src), path=path, rules=rules)
    assert err is None, err
    return findings


def lines_of(src, rule, path="<string>"):
    return sorted(f.line for f in fired(src, [rule], path=path))


# ----------------------------------------------------------------------
# the whole port, linted once
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_report():
    """``lint --strict-baseline --format json`` over the port's package:
    (exit code, the JSON report)."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["lint", "--strict-baseline", "--format", "json"])
    return rc, json.loads(out.getvalue())


def test_the_port_lints_clean_against_its_committed_baseline(port_report):
    rc, doc = port_report
    assert rc == 0, doc["new"]
    assert doc["counts"] == {"new": 0, "baselined": 0, "stale": 0}


def test_the_committed_baseline_is_the_ports_own_and_empty():
    path = T.default_baseline_path()
    assert path == PKG / "analysis" / "graftlint.baseline.json"
    assert path != J.default_baseline_path()
    assert T.load_baseline(path) == {}


def test_every_rule_is_registered():
    assert sorted(T.all_rules(), key=lambda r: int(r[1:])) == [f"R{i}" for i in range(1, 14)]


def test_list_rules_prints_the_catalog(capsys):
    assert cli.main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in T.all_rules():
        assert f"{name} [" in out


# ----------------------------------------------------------------------
# each rule: a fixture with the fault fires, one without stays silent
# ----------------------------------------------------------------------

CAPTURE = """
    import torch

    class Steps:
        def _steps(self, x, lr):
            loss = (x * lr).sum()
            {body}
            return loss

        def capture(self, x, lr):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = self._steps(x, lr)
            return g, out
"""

FAULTS = {
    # rule: [(id, source, path, lines the rule must report)]
    "R1": [
        ("item_under_capture", CAPTURE.format(body="v = loss.item()"), "<string>", [7]),
        ("cpu_under_capture_begin", """
            import torch

            def windows(fn, x):
                g = torch.cuda.CUDAGraph()
                g.capture_begin()
                y = fn(x)
                host = y.cpu()
                g.capture_end()
                return g
         """, "<string>", [8]),
        ("per_step_item", """
            def fit(self, batches):
                for x, y in batches:
                    loss = self.step_fn(x, y)
                    self.scores.append(loss.item())
         """, "<string>", [5]),
        ("per_step_synchronize", """
            import torch

            def fit(self, batches):
                for x in batches:
                    loss = self.train_step(x)
                    torch.cuda.synchronize()
         """, "<string>", [7]),
        ("float_of_a_dispatch", """
            def run_round(self, rounds):
                for _ in range(rounds):
                    losses = self.steps_fn(self.params, self.xs)
                    self.last = float(losses[-1])
         """, "<string>", [5]),
    ],
    "R2": [
        ("compare_under_capture", CAPTURE.format(body="if lr > 0.1:\n                loss = loss * 2"),
         "<string>", [7]),
        ("torch_predicate_under_capture",
         CAPTURE.format(body="if torch.isnan(loss).any():\n                loss = loss * 0"),
         "<string>", [7]),
    ],
    "R3": [
        ("graph_per_iteration", """
            import torch

            def bench(fns, x):
                for fn in fns:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        fn(x)
         """, "<string>", [6, 7]),
        ("compile_per_iteration", """
            import torch

            def tune(fns):
                return [torch.compile(fn) for fn in fns] + [
                    torch.compile(f) for f in fns]

            def sweep(shapes, fn):
                for s in shapes:
                    c = torch.compile(fn)
         """, "<string>", [10]),
        ("compile_of_a_lambda", """
            import torch

            def make():
                return torch.compile(lambda x: x * 2)
         """, "<string>", [5]),
        ("build_per_iteration", """
            from deeplearning4j_tpu_torch.ops import _build

            def rebuild(sources):
                for src in sources:
                    _build.build(src)
         """, "<string>", [6]),
    ],
    "R4": [
        ("clock_under_capture", CAPTURE.format(body="import time\n            t = time.perf_counter()"),
         "<string>", [8]),
        ("print_and_host_rng_under_capture",
         CAPTURE.format(body="print(loss)\n            import numpy as np\n"
                             "            z = np.random.rand(3)"), "<string>", [7, 9]),
        ("telemetry_under_capture", """
            import torch
            from deeplearning4j_tpu_torch import telemetry

            def step(x):
                telemetry.get_registry().counter("steps_total", "steps").inc()
                return x * 2

            def capture(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = step(x)
                return g
         """, "<string>", [6]),
    ],
    "R5": [
        ("bare_memory_query", """
            import torch

            def peak():
                return torch.cuda.max_memory_allocated()

            def free():
                free, total = torch.cuda.mem_get_info()
                return free
         """, "<string>", [5, 8]),
        ("props_after_an_unrelated_branch", """
            import torch

            def sms(dev):
                if dev is None:
                    dev = 0
                return torch.cuda.get_device_properties(dev).multi_processor_count
         """, "<string>", [7]),
    ],
    "R6": [
        ("thread_without_daemon", """
            import threading

            def start(fn):
                t = threading.Thread(target=fn)
                t.start()
         """, "<string>", [5]),
        ("unlocked_rmw", """
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def bump(self):
                    self.n += 1
         """, "<string>", [10]),
    ],
    "R7": [
        ("static_output_returned", """
            import torch

            class Chunk:
                def _steps(self):
                    return self.x * 2

                def _capture(self):
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        out = self._steps()
                    self.graph, self.out = g, out

                def __call__(self):
                    self.graph.replay()
                    return self.out
         """, "<string>", [16]),
        ("static_output_kept_per_replay", """
            import torch

            class Chunk:
                def _capture(self, fn):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self.losses = fn()

                def run(self, n):
                    kept = []
                    for _ in range(n):
                        self.graph.replay()
                        kept.append(self.losses[0])
                    return kept
         """, "<string>", [14]),
        ("alias_read_after_the_next_replay", """
            import torch

            class Chunk:
                def _capture(self, fn):
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        out = fn()
                    self.out = out

                def two(self):
                    self.graph.replay()
                    first = self.out.detach()
                    self.graph.replay()
                    return (first - self.out.clone()).abs().max()
         """, "<string>", [15]),
    ],
    "R8": [
        ("axis_name_as_a_group", """
            import torch.distributed as dist

            def reduce(x):
                dist.all_reduce(x, group="data")
                return x
         """, "<string>", [5]),
        ("port_collective_on_a_literal", """
            from deeplearning4j_tpu_torch.utils import collectives as C

            def reduce(x, y):
                C.all_reduce_(x, "model")
                return C.gather_dim(y, 0, "model")
         """, "<string>", [5, 6]),
        ("group_attr_bound_to_a_literal", """
            import torch.distributed as dist

            class Trainer:
                def __init__(self):
                    self.group = "data"

                def step(self, g):
                    dist.all_reduce(g, group=self.group)
         """, "<string>", [9]),
        ("axis_outside_the_universe", """
            AXES = ("data", "model", "seq", "stage")

            def groups(mesh):
                return mesh.group("dta"), mesh.coords["modle"]
         """, "<string>", [5, 5]),
    ],
    "R9": [
        ("ab_ba_cycle", """
            import threading

            class Pair:
                def __init__(self):
                    self.l1 = threading.Lock()
                    self.l2 = threading.Lock()

                def fwd(self):
                    with self.l1:
                        with self.l2:
                            pass

                def rev(self):
                    with self.l2:
                        with self.l1:
                            pass
         """, "<string>", [11, 16]),
        ("blocking_get_under_lock", """
            import queue
            import threading

            class Worker:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._q = queue.Queue()

                def drain(self):
                    with self._lock:
                        return self._q.get()
         """, "<string>", [12]),
    ],
    "R10": [
        ("route_typo", """
            class Handler:
                def do_GET(self):
                    if self.path.startswith("/health"):
                        self._send(200, {"ok": True})

            def client(addr):
                code, doc = _http_json(addr + "/helth", {})
                return code
         """, "<string>", [8]),
    ],
    "R11": [
        ("fire_before_register", """
            from deeplearning4j_tpu_torch import telemetry as _tm

            class Prober:
                def __init__(self):
                    self._m = _tm.get_registry().counter("probe_total", "probes")

                def probe_once(self, verdict):
                    self._m.inc(model="m", verdict=verdict)
         """, "<string>", [9]),
    ],
    "R12": [
        ("urlopen_without_timeout", """
            from urllib.request import urlopen

            def scrape(url):
                with urlopen(url) as r:
                    return r.read()
         """, "pkg/fleet/scrape.py", [5]),
    ],
    "R13": [
        ("raw_path_label", """
            from deeplearning4j_tpu_torch import telemetry as _tm

            class H:
                def __init__(self):
                    self._m = _tm.get_registry().counter("http_total", "requests")

                def count(self, path):
                    self._m.inc(path=path)
         """, "<string>", [9]),
    ],
}

CLEAN = {
    "R1": [
        ("static_queries_under_capture",
         CAPTURE.format(body="n = int(x.shape[0]) + x.numel() + len(x)"), "<string>"),
        ("one_read_after_the_loop", """
            def fit(self, batches):
                total = 0.0
                for x, y in batches:
                    loss = self.step_fn(x, y)
                    total = total + loss
                return total.item()
         """, "<string>"),
        ("host_data_in_the_loop", """
            import numpy as np

            def fit(self, data, batches):
                for i in batches:
                    x = np.asarray(data[i])
                    loss = self._train_step(x)
         """, "<string>"),
        ("streaming_time_step_reads_per_call", """
            def generate(self, xs):
                out = []
                for x in xs:
                    out.append(self.rnn_time_step(x).cpu())
                return out
         """, "<string>"),
    ],
    "R2": [
        ("static_branches_under_capture",
         CAPTURE.format(body="if x.dim() == 3 and lr is not None:\n"
                             "                loss = loss * 2\n"
                             "            if self.with_health:\n"
                             "                loss = loss + 0"), "<string>"),
        ("host_branches_outside_capture", """
            def fit(self, loss):
                if loss > 100.0:
                    return None
         """, "<string>"),
    ],
    "R3": [
        ("built_once", """
            import torch

            def bench(fn, xs):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn(xs[0])
                c = torch.compile(fn)
                for x in xs:
                    g.replay()
                    c(x)
         """, "<string>"),
        ("checkpoint_in_a_loop", """
            from torch.utils.checkpoint import checkpoint

            def run(blocks, x):
                for b in blocks:
                    x = checkpoint(b, x, use_reentrant=False)
                return x
         """, "<string>"),
    ],
    "R4": [
        ("host_work_outside_capture", """
            import time
            import torch
            from deeplearning4j_tpu_torch.telemetry.health import health_stats

            def step(x, g):
                return health_stats(g, x, x.sum())

            def capture(x):
                t0 = time.perf_counter()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = step(x, x)
                print(time.perf_counter() - t0)
                return graph
         """, "<string>"),
    ],
    "R5": [
        ("guarded_queries", """
            import torch

            def peak():
                if torch.cuda.is_available():
                    return torch.cuda.max_memory_allocated()
                return 0

            def peak_or_none(x):
                return torch.cuda.max_memory_allocated() if x.is_cuda else None

            def limit():
                if not torch.cuda.is_available():
                    return None
                return torch.cuda.mem_get_info()[1]

            def stats():
                try:
                    return torch.cuda.memory_stats()
                except RuntimeError:
                    return {}

            def per_card():
                return [torch.cuda.memory_allocated(i)
                        for i in range(torch.cuda.device_count())]

            def on(dev):
                if dev.type == "cuda":
                    return torch.cuda.get_device_properties(dev)
         """, "<string>"),
    ],
    "R6": [
        ("daemon_and_locked", """
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0
                    self._t = threading.Thread(target=self.bump, daemon=True)

                def bump(self):
                    with self._lock:
                        self.n += 1
         """, "<string>"),
    ],
    "R7": [
        ("cloned_after_replay", """
            import torch

            class Chunk:
                def _steps(self):
                    return self.x * 2

                def _capture(self):
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        out = self._steps()
                    self.graph, self.out = g, out

                def __call__(self):
                    self.graph.replay()
                    losses, health = self.out
                    return losses.clone(), {k: v.clone() for k, v in health.items()}

                def many(self, n):
                    kept = []
                    for _ in range(n):
                        self.graph.replay()
                        kept.append(self.out.clone())
                        total = self.out.sum()
                    return kept
         """, "<string>"),
    ],
    "R8": [
        ("opened_groups", """
            import torch.distributed as dist
            from deeplearning4j_tpu_torch.utils import collectives as C

            AXES = ("data", "model")

            class Trainer:
                def __init__(self, mesh, bg):
                    self.mesh = mesh
                    self.group = mesh.group("data")
                    self.bg = bg

                def step(self, g, group=None):
                    dist.all_reduce(g, group=self.group)
                    C.all_reduce_(g, self.bg.group)
                    C.all_reduce_(g, group)
                    C.all_reduce_(g)
                    sub = dist.new_group([0, 1])
                    dist.barrier(sub)
                    return self.mesh.coords["model"], dist.get_world_size(self.group)
         """, "<string>"),
    ],
    "R9": [
        ("consistent_order", """
            import threading

            class Pair:
                def __init__(self):
                    self.l1 = threading.Lock()
                    self.l2 = threading.Lock()

                def fwd(self):
                    with self.l1:
                        with self.l2:
                            pass

                def also(self):
                    with self.l1:
                        with self.l2:
                            pass
         """, "<string>"),
    ],
    "R10": [
        ("served_route", """
            class Handler:
                def do_GET(self):
                    if self.path.startswith("/health"):
                        self._send(200, {"ok": True})

            def client(addr):
                code, doc = _http_json(addr + "/health", {})
                return doc.get("ok")
         """, "<string>"),
    ],
    "R11": [
        ("preregistered", """
            from deeplearning4j_tpu_torch import telemetry as _tm

            class Prober:
                def __init__(self):
                    self._m = _tm.get_registry().counter("probe_total", "probes")
                    for v in ("ok", "error"):
                        self._m.inc(0, model="m", verdict=v)

                def probe_once(self, verdict):
                    self._m.inc(model="m", verdict=verdict)
         """, "<string>"),
    ],
    "R12": [
        ("bounded_waits", """
            from urllib.request import urlopen

            def scrape(url, thread):
                thread.join(timeout=5.0)
                with urlopen(url, timeout=5.0) as r:
                    return r.read()
         """, "pkg/fleet/scrape.py"),
    ],
    "R13": [
        ("closed_set_label", """
            from deeplearning4j_tpu_torch import telemetry as _tm

            ROUTES = ("/health", "/stats")

            class H:
                def __init__(self):
                    self._m = _tm.get_registry().counter("http_total", "requests")

                def count(self, path):
                    root = path if path in ROUTES else "/other"
                    self._m.inc(path=root)
         """, "<string>"),
    ],
}


@pytest.mark.parametrize("rule,src,path,want", [
    pytest.param(rule, src, path, want, id=f"{rule}-{name}")
    for rule, cases in FAULTS.items() for name, src, path, want in cases])
def test_fault_fixture_fires(rule, src, path, want):
    assert lines_of(src, rule, path=path) == want


@pytest.mark.parametrize("rule,src,path", [
    pytest.param(rule, src, path, id=f"{rule}-{name}")
    for rule, cases in CLEAN.items() for name, src, path in cases])
def test_clean_fixture_silent(rule, src, path):
    assert fired(src, [rule], path=path) == []


def test_every_rule_has_a_fault_and_a_clean_fixture():
    assert set(FAULTS) == set(CLEAN) == set(T.all_rules())


# ----------------------------------------------------------------------
# the port's own idioms: what R1-R8 must and must not see there
# ----------------------------------------------------------------------

@pytest.mark.parametrize("rel", [
    "nn/graph.py", "nn/multilayer.py", "parallel/data_parallel.py", "parallel/pipeline.py",
    "nn/solvers.py"])
def test_checkpoint_loops_and_plain_functions_are_r3_negatives(rel):
    """``torch.utils.checkpoint`` in a loop and ``nn/solvers.py``'s plain
    ``value_and_grad`` compile nothing: the JAX rule fires on the port's
    sources there, the port's rule does not."""
    mods, errors = T.parse_paths([PKG / rel], root=REPO)
    assert not errors
    assert [f for f in T.lint_modules(mods, rules=["R3"])] == []
    jmods, _ = J.parse_paths([PKG / rel], root=REPO)
    assert [f.rule for f in J.lint_modules(jmods, rules=["R3"])], \
        "the JAX rule no longer fires here: this negative no longer tells the rules apart"


def _module(rel):
    mods, errors = T.parse_paths([PKG / rel], root=REPO)
    assert not errors
    return mods[0]


def test_the_capture_sites_are_classified():
    """The three capture sites the rules key on: the K-step engine's
    ``_steps`` and word2vec's ``_ChunkSteps._steps`` run under capture,
    the tuner's ``capture_begin`` span is a region; the StepDriver's
    dispatch loops are step loops."""
    fused = _facts(_module("nn/fused.py"))
    assert "_steps" in {fn.name for fn in fused.captured}
    w2v = _facts(_module("text/word2vec.py"))
    assert "_steps" in {fn.name for fn in w2v.captured}
    measure = _facts(_module("tuning/measure.py"))
    assert [fn.name for fn, _ in measure.regions] == ["_graph_windows"]
    driver = _facts(_module("continuous/driver.py"))
    assert driver.steploop


def test_the_static_outputs_are_found_and_cloned():
    """R7 sees ``sig.out`` and ``_ChunkSteps.out`` as static outputs, and
    both replays clone them; the same source returning the buffer as is
    fires."""
    mods = [_module("nn/fused.py"), _module("text/word2vec.py")]
    facts = project_facts(mods)
    assert all("out" in facts.static_attrs[m] for m in mods)
    assert T.lint_modules(mods, rules=["R7"]) == []
    src = (PKG / "text/word2vec.py").read_text()
    assert src.count("return self.out.clone()") == 1
    broken = src.replace("return self.out.clone()", "return self.out")
    fs = fired(broken, ["R7"], path="text/word2vec.py")
    assert [f.rule for f in fs] == ["R7"]


def test_the_mesh_axes_are_the_universe():
    facts = project_facts([_module("parallel/mesh.py")])
    assert facts.axis_universe == {"data", "model", "seq", "stage"}


# ----------------------------------------------------------------------
# parity with the JAX package on identical sources
# ----------------------------------------------------------------------

#: rules that carry over as written, and the framework around them
PARITY_RULES = ["R6", "R9", "R10", "R11", "R12", "R13"]


def _jax_fixture_sources():
    """Every inline source of the JAX lint tests that parses: the
    reference's own fixtures, run through both packages unchanged."""
    tree = ast.parse((REPO / "tests" / "test_lint.py").read_text())
    out = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.ClassDef)):
            continue
        for i, n in enumerate(x for x in ast.walk(fn)
                              if isinstance(x, ast.Constant) and isinstance(x.value, str)):
            src = textwrap.dedent(n.value)
            if src.count("\n") < 3:
                continue
            try:
                ast.parse(src)
            except SyntaxError:
                continue
            out.setdefault(src, f"{fn.name}-{i}")
    return sorted((name, src) for src, name in out.items())


FRAMEWORK = {
    "line_suppression": """
        import threading
        t = threading.Thread(target=print)  # graftlint: disable=R6 -- joined by the caller
    """,
    "rule_specific_suppression": """
        import threading
        t = threading.Thread(target=print)  # graftlint: disable=R9
    """,
    "disable_all": """
        import threading
        t = threading.Thread(target=print)  # graftlint: disable=all
    """,
    "comma_in_justification": """
        import threading

        def fit(self, batches):
            for x in batches:
                loss = self.step_fn(x)
                s = float(loss)  # graftlint: disable=R6 -- R1, R9 are prose here
                t = threading.Thread(target=print)  # graftlint: disable=R1 -- R6, not R6
    """,
    "multiline_statement": """
        import threading
        t = threading.Thread(
            target=print)  # graftlint: disable=R6 -- trailing-line style
    """,
    "file_level": """
        # graftlint: disable-file=R6
        import threading
        t = threading.Thread(target=print)
        u = threading.Thread(target=print)
    """,
    "decorator_line": """
        import threading

        @staticmethod  # graftlint: disable=R6 -- the decorated def's findings
        def start():
            return threading.Thread(target=print)
    """,
    "step_loop_suppressed": """
        def fit(self, batches):
            for b in batches:
                loss = self.step_fn(b)
                s = float(
                    loss)  # graftlint: disable=R1 -- trailing-line style
                t = loss.item()
    """,
}


def _pairs(src, path, rules):
    return ([(f.rule, f.line, f.end_line) for f in fired(src, rules, path=path, pkg=T)],
            [(f.rule, f.line, f.end_line) for f in fired(src, rules, path=path, pkg=J)])


@pytest.mark.parametrize("name,src", _jax_fixture_sources())
@pytest.mark.parametrize("path", ["<string>", "pkg/fleet/mod.py"])
def test_carried_rules_match_jax_on_the_reference_fixtures(name, src, path):
    mine, theirs = _pairs(src, path, PARITY_RULES)
    assert mine == theirs


@pytest.mark.parametrize("name", sorted(FRAMEWORK))
def test_suppressions_match_jax(name):
    src = FRAMEWORK[name]
    mine, theirs = _pairs(src, "<string>", ["R1", "R6"])
    assert mine == theirs
    assert _pairs(src, "<string>", None)[0] == [f for f in mine]  # nothing else fires


@pytest.mark.parametrize("rule", PARITY_RULES)
def test_own_fixtures_match_jax(rule):
    for _, src, path, _ in FAULTS[rule]:
        mine, theirs = _pairs(src, path, [rule])
        assert mine == theirs and mine
    for _, src, path in CLEAN[rule]:
        assert _pairs(src, path, [rule]) == ([], [])


BASELINE_SRC = """
    def fit(self, batches):
        for x in batches:
            loss = self.step_fn(x)
            s = float(loss)
"""


def test_baseline_identity_and_staleness_match_jax(tmp_path):
    mine, theirs = fired(BASELINE_SRC, ["R1"]), fired(BASELINE_SRC, ["R1"], pkg=J)
    assert [f.key() for f in mine] == [f.key() for f in theirs] and mine
    T.save_baseline(tmp_path / "t.json", mine)
    J.save_baseline(tmp_path / "j.json", theirs)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    base = T.load_baseline(tmp_path / "t.json")
    worse_src = BASELINE_SRC.replace("s = float(loss)", "s = float(loss)\n            t = loss.item()")
    for pkg in (T, J):
        worse = fired(worse_src, ["R1"], pkg=pkg)
        new, known, stale = pkg.apply_baseline(worse, base)
        assert len(new) == 1 and ".item()" in new[0].message and len(known) == 1 and not stale
        assert pkg.apply_baseline([], base) == ([], [], {next(iter(base)): 1})
    drifted = fired("\n\n\n" + textwrap.dedent(BASELINE_SRC), ["R1"])
    assert drifted[0].line != mine[0].line and drifted[0].key() == mine[0].key()
    assert T.load_baseline(tmp_path / "absent.json") == {}


def test_json_report_shape_matches_jax():
    src = FRAMEWORK["comma_in_justification"].replace("disable=R6 -- R1, R9 are prose here",
                                                      "")
    mine, theirs = fired(src, ["R1", "R6"]), fired(src, ["R1", "R6"], pkg=J)
    a, b = io.StringIO(), io.StringIO()
    doc = reporters.report_json(mine, [], {"R1|x.py|y": 1}, stream=a)
    jdoc = jax_reporters.report_json(theirs, [], {"R1|x.py|y": 1}, stream=b)
    assert doc == jdoc and json.loads(a.getvalue()) == json.loads(b.getvalue())
    assert doc["counts"] == {"new": 2, "baselined": 0, "stale": 1}


# ----------------------------------------------------------------------
# the CLI: exit codes, --diff, --emit-schema
# ----------------------------------------------------------------------

BAD_FILE = textwrap.dedent("""
    import threading

    def start(fn):
        t = threading.Thread(target=fn)
        t.start()
""")


def test_cli_exit_codes_and_formats(tmp_path, capsys):
    bad, good = tmp_path / "bad.py", tmp_path / "good.py"
    bad.write_text(BAD_FILE)
    good.write_text(BAD_FILE.replace("target=fn)", "target=fn, daemon=True)"))
    assert cli.main(["lint", "--no-baseline", str(bad)]) == 1
    assert "R6[thread-discipline]" in capsys.readouterr().err
    assert cli.main(["lint", "--no-baseline", str(good)]) == 0
    assert cli.main(["lint", "--no-baseline", "--rules", "R9", str(bad)]) == 0
    with pytest.raises(SystemExit):
        cli.main(["lint", "--rules", "R99", str(bad)])
    capsys.readouterr()
    assert cli.main(["lint", "--no-baseline", "--format", "json", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out)["counts"]["new"] == 1
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert cli.main(["lint", "--no-baseline", str(broken)]) == 1
    assert "E0[parse-error]" in capsys.readouterr().err


def test_cli_update_then_strict_gate(tmp_path, capsys):
    bad, base = tmp_path / "bad.py", tmp_path / "b.json"
    bad.write_text(BAD_FILE)
    assert cli.main(["lint", "--baseline", str(base), "--update-baseline", str(bad)]) == 0
    assert cli.main(["lint", "--baseline", str(base), "--strict-baseline", str(bad)]) == 0
    bad.write_text(BAD_FILE.replace("target=fn)", "target=fn, daemon=True)"))
    assert cli.main(["lint", "--baseline", str(base), str(bad)]) == 0
    assert cli.main(["lint", "--baseline", str(base), "--strict-baseline", str(bad)]) == 1
    assert "stale" in capsys.readouterr().err


def _git(repo, *args):
    subprocess.run(["git", "-C", str(repo), *args], check=True, capture_output=True,
                   env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
                        "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
                        "HOME": str(repo), "PATH": "/usr/bin:/bin:/usr/local/bin"})


def test_diff_mode_matches_jax_on_a_scratch_repo(tmp_path, capsys):
    repo = tmp_path / "r"
    repo.mkdir()
    _git(repo, "init", "-q")
    (repo / "old.py").write_text(BAD_FILE)
    (repo / "touched.py").write_text(BAD_FILE)
    _git(repo, "add", "-A")
    _git(repo, "commit", "-qm", "seed")
    (repo / "touched.py").write_text(BAD_FILE.replace("t.start()", "t.start()\n    t.join()\n"
                                                      "    u = threading.Thread(target=fn)"))
    (repo / "new.py").write_text(BAD_FILE)
    changed = cli._git_changed_lines("HEAD", str(repo))
    assert changed == jax_cli._git_changed_lines("HEAD", str(repo))
    assert set(changed) == {"touched.py", "new.py"}
    assert changed["new.py"] == set(range(1, BAD_FILE.count("\n") + 1))
    # the CLI keeps only findings on changed lines: touched.py's new
    # thread and every line of the untracked file, not old.py's
    assert cli.main(["lint", "--no-baseline", "--diff", "HEAD",
                     str(repo / "old.py")]) == 0
    with pytest.raises(SystemExit):
        cli._git_changed_lines("no-such-ref", str(repo))
    with pytest.raises(SystemExit):
        cli.main(["lint", "--diff", "HEAD", "--update-baseline", str(repo / "old.py")])


def test_san_report_merge_completes_a_static_cycle(tmp_path, capsys):
    """An order only the runtime saw, merged with an order only the code
    declares, closes a cycle the merged graph reports."""
    src = tmp_path / "pair.py"
    src.write_text(textwrap.dedent("""
        import threading

        class Pair:
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()

            def fwd(self):
                with self.a:
                    with self.b:
                        pass
    """))
    rep = tmp_path / "san.json"
    rep.write_text(json.dumps({"version": 1, "locks": {}, "findings": [], "lock_order_edges": [
        {"from": f"{src}:7", "to": f"{src}:6", "count": 1}]}))
    assert cli.main(["lint", "--san-report", str(rep), str(src)]) == 1
    assert "MERGED lock-order cycle" in capsys.readouterr().out
    rep.write_text(json.dumps({"version": 1, "locks": {}, "findings": [], "lock_order_edges": [
        {"from": f"{src}:6", "to": f"{src}:7", "count": 1}]}))
    assert cli.main(["lint", "--san-report", str(rep), str(src)]) == 0
    assert "merge clean" in capsys.readouterr().out


def test_emit_schema_writes_inside_the_package_never_at_the_root(tmp_path, monkeypatch):
    """Without ``--schema-dir`` the port's schema goes to its own
    ``analysis/schema/`` (here redirected, so the test writes nothing into
    the checkout); the committed artifact is what the sources harvest, and
    the repo root's SCHEMA.json and METRICS.md (the JAX package's) are left
    alone."""
    names = ("SCHEMA.json", "METRICS.md")
    out_dir = PKG / "analysis" / "schema"
    assert Path(reporters.default_schema_dir()) == out_dir
    monkeypatch.setattr(reporters, "default_schema_dir", lambda: str(tmp_path / "schema"))
    root_before = {n: (REPO / n).read_bytes() for n in names}
    assert cli.main(["lint", "--emit-schema"]) == 0
    assert {n: (REPO / n).read_bytes() for n in names} == root_before
    fresh = {n: (tmp_path / "schema" / n).read_bytes() for n in names}
    committed = {n: (out_dir / n).read_bytes() for n in names}
    assert fresh == committed, \
        "the committed schema is stale: run python -m deeplearning4j_tpu_torch lint --emit-schema"
    schema = json.loads(committed["SCHEMA.json"])
    for series in ("serving_requests_total", "fleet_dispatch_total",
                   "continuous_dropped_total", "compile_cache_total"):
        assert series in schema["metrics"], series
    assert "/fleet" in {r["path"] for r in schema["wire"]["routes"]}
