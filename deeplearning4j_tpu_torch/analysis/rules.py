"""graftlint rule set R1-R6: the hazards of Python-over-CUDA step paths.

The JAX package's R1-R6 key on ``jax.jit`` tracing; the port has no
tracer. Its hazards are the host syncs of an eager step loop and what
breaks a CUDA-graph capture, so R1-R5 are re-derived for PyTorch and R6
carries over as written.

Shared machinery first: ``ModuleFacts`` classifies every function in a
module as *captured* (it runs while a CUDA graph captures: the body of a
``with torch.cuda.graph(g):`` block or of a ``capture_begin()`` ..
``capture_end()`` span, and the same-module functions those call, nested
defs included), *step-loop* (host code that drives a train-step callable
per iteration), or plain host code, and runs a light lexical taint pass
marking names bound from step-fn results. The rules then only fire where
the hazard is real:

* a ``.item()`` in a captured body is an error at capture (a sync is not
  allowed while a stream captures) — R1, always wrong;
* a ``.item()`` on a step result inside a fit/round loop is a
  per-iteration sync (R1, fix = accumulate on device or fetch one step
  late — ``telemetry/scorepipe.py`` is the sanctioned pattern);
* the same ``.item()`` in a one-shot ``score()`` API is fine and is not
  flagged.

The step classifier keys on how this repo builds its step functions:
``nn/multilayer.py make_train_step``, ``make_train_steps`` and
``make_tbptt_step``, ``nn/fused.py make_train_steps``, ``nn/graph.py
make_tbptt_step``, and the ``step_fn``/``steps_fn`` callables the
StepDriver holds. New findings that are deliberate carry a line
suppression with a justification; pre-existing debt lives in the
committed baseline.
"""

from __future__ import annotations

import ast
import re

from deeplearning4j_tpu_torch.analysis.core import LintModule, Rule, register
from deeplearning4j_tpu_torch.analysis.dataflow import ProjectFacts

# ----------------------------------------------------------------------
# classification tables
# ----------------------------------------------------------------------

#: callee names that mark the calling (host) function as a step loop
_STEP_EXACT = {
    "step", "step_fn", "steps_fn", "train_step", "tbptt_step",
    "split_step", "make_train_step", "make_train_steps", "make_tbptt_step",
}
_STEP_SUFFIXES = ("_step", "step_fn", "steps_fn", "_split_fn")
#: ...except streaming-inference timesteps, whose callers legitimately
#: sync per call (results must reach the host)
_STEP_EXCLUDE_SUFFIX = ("time_step",)

#: single-argument builtins that force a device->host transfer
_SYNC_BUILTINS = {"float", "int", "bool", "complex"}
#: dotted calls that are explicit syncs (their argument, if any, synced)
_SYNC_DOTTED = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
#: method names that sync their receiver
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}

#: attribute accesses and methods that are static metadata, never a
#: device value
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "axis_names"}
_STATIC_METHODS = {"size", "dim", "numel", "element_size", "data_ptr",
                   "is_contiguous", "is_floating_point", "stride",
                   "get_device", "nelement"}
#: torch functions that answer host questions (no device value)
_STATIC_TORCH = {"torch.is_tensor", "torch.is_floating_point",
                 "torch.is_complex", "torch.is_grad_enabled",
                 "torch.is_inference_mode_enabled", "torch.cuda.is_available",
                 "torch.cuda.is_current_stream_capturing",
                 "torch.get_default_dtype", "torch.device", "torch.finfo",
                 "torch.iinfo"}

#: telemetry entry points that ARE safe inside a captured body (pure
#: device math designed to run inside the step; see telemetry/health.py)
_PURE_TELEMETRY = {"health_stats", "tree_sq_sum", "any_nonfinite"}

_IMPURE_DOTTED_PREFIXES = ("time.", "numpy.random.", "random.",
                           "datetime.")
_IMPURE_DOTTED = {"torch.manual_seed", "torch.seed", "torch.initial_seed",
                  "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}
_IMPURE_NAME_CALLS = {"print", "open", "input"}
_IMPURE_LOG_ROOTS = {"logger", "logging", "log"}
_IMPURE_METRIC_METHODS = {"inc", "dec", "observe", "set", "note",
                          "annotate", "dump", "record"}

#: ``torch.cuda`` queries that need a card (CPU builds raise, or there is
#: no device to ask)
_BACKEND_CALLS = {"memory_stats", "memory_stats_as_nested_dict",
                  "memory_allocated", "max_memory_allocated",
                  "memory_reserved", "max_memory_reserved",
                  "reset_peak_memory_stats", "reset_max_memory_allocated",
                  "mem_get_info", "memory_summary", "memory_snapshot",
                  "get_device_properties", "get_device_name",
                  "get_device_capability", "utilization", "temperature",
                  "power_draw", "clock_rate", "list_gpu_processes"}
#: what an availability guard mentions: a query of the card, a loop over
#: the visible cards, or the "cuda" device type
_GUARD_CALLS = {"is_available", "is_initialized", "device_count"}
_GUARD_NAME_RE = re.compile(r"(^|_)(cards|devices)$")

_MUTATING_METHODS = {"append", "extend", "insert", "remove", "pop",
                     "clear", "update", "add", "discard", "appendleft",
                     "popleft", "popitem", "setdefault"}

#: what builds a kernel or a graph: costly once, a hazard per iteration
_BUILD_SUFFIXES = ("._build.build", "_build.Library", "cpp_extension.load",
                   "cpp_extension.load_inline")


def _is_step_callee(name):
    if name is None:
        return False
    short = name.rsplit(".", 1)[-1]
    if short.endswith(_STEP_EXCLUDE_SUFFIX):
        return False
    return (short in _STEP_EXACT
            or short.endswith(_STEP_SUFFIXES))


def _callee_name(call, mod):
    """Short name of a Call's target: bare name, attr name, or None."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


# ----------------------------------------------------------------------
# per-module facts
# ----------------------------------------------------------------------

class ModuleFacts:
    """Captured / step-loop classification + step-result taint, computed
    once per module and shared by every rule (attached to the LintModule
    so N rules don't re-derive it N times)."""

    def __init__(self, mod: LintModule):
        self.mod = mod
        self.functions = [n for n in ast.walk(mod.tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))]
        self._by_name = {}
        self._encl_fn = {}
        self._encl_cls = {}
        for fn in self.functions:
            self._by_name.setdefault(fn.name, []).append(fn)
            self._encl_fn[fn] = mod.enclosing_function(fn)
            self._encl_cls[fn] = self._class_of(fn)
        self.regions = []          # (capturing fn, [stmts])
        self.captured = self._find_captured()
        self.steploop = self._find_steploops()
        self.taint = {fn: self._taint_pass(fn) for fn in self.steploop}

    # -- captured set ---------------------------------------------------

    def _find_captured(self):
        mod = self.mod
        roots = set()
        for fn in self.functions:
            for span in ProjectFacts.capture_spans(mod, fn):
                self.regions.append((fn, span))
                for stmt in span:
                    for call in (n for n in ast.walk(stmt)
                                 if isinstance(n, ast.Call)):
                        roots.update(self._resolve_callable(call.func,
                                                            site=call))
        # transitive closure over same-module call edges + nested defs
        captured = set(roots)
        changed = True
        while changed:
            changed = False
            for fn in self.functions:
                if fn in captured:
                    continue
                encl = self._encl_fn.get(fn)
                if encl is not None and encl in captured:
                    captured.add(fn)
                    changed = True
            for fn in list(captured):
                for call in (n for n in ast.walk(fn)
                             if isinstance(n, ast.Call)):
                    for callee in self._resolve_callable(call.func,
                                                         site=call):
                        if callee not in captured:
                            captured.add(callee)
                            changed = True
        return captured

    def captured_scopes(self):
        """(scope function, its nodes that run under capture): every
        captured function whole, and each region's statements within the
        function that captures."""
        for fn in self.captured:
            yield fn, [n for n in ast.walk(fn)
                       if self.mod.enclosing_function(n) is fn]
        for fn, span in self.regions:
            if fn in self.captured:
                continue
            nodes = []
            for stmt in span:
                nodes.extend(n for n in ast.walk(stmt)
                             if self.mod.enclosing_function(n) is fn)
            yield fn, nodes

    def _class_of(self, node):
        for a in self.mod.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None  # a def nested in a method is not a method
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def _resolve_callable(self, node, site):
        """Same-module functions a Name / ``self.x`` / ``cls.x`` node may
        refer to, resolved LEXICALLY from ``site``: a bare name only
        reaches defs visible by scoping (nested in an enclosing function,
        or module level), and ``self.x`` only reaches methods of the
        class the site sits in."""
        if isinstance(node, ast.Name):
            chain = []
            f = self.mod.enclosing_function(site)
            while f is not None:
                chain.append(f)
                f = self._encl_fn.get(f)
            chain.append(None)  # module scope
            for scope in chain:
                hits = [fn for fn in self._by_name.get(node.id, [])
                        if self._encl_fn.get(fn) is scope
                        and (scope is not None
                             or self._encl_cls.get(fn) is None)]
                if hits:
                    return hits
            return []
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in ("self", "cls")):
            site_cls = self._class_of_site(site)
            hits = [fn for fn in self._by_name.get(node.attr, [])
                    if self._encl_cls.get(fn) is not None
                    and (site_cls is None
                         or self._encl_cls.get(fn) is site_cls)]
            return hits
        return []

    def _class_of_site(self, node):
        for a in self.mod.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    # -- step loops -----------------------------------------------------

    def _find_steploops(self):
        out = set()
        for fn in self.functions:
            if fn in self.captured:
                continue
            for call in (n for n in ast.walk(fn)
                         if isinstance(n, ast.Call)):
                if self.mod.enclosing_function(call) is not fn:
                    continue  # nested defs classified on their own
                if _is_step_callee(_callee_name(call, self.mod)):
                    out.add(fn)
                    break
        return out

    # -- step-result taint ---------------------------------------------

    def _taint_pass(self, fn):
        """Names (and ``self.x`` attrs) bound from step-fn call results,
        by one lexical pass over the function's assignments. A sync
        construct's own result is host data and clears the taint."""
        tainted = set()

        def target_keys(t):
            if isinstance(t, ast.Name):
                return [t.id]
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return [f"self.{t.attr}"]
            if isinstance(t, (ast.Tuple, ast.List)):
                keys = []
                for e in t.elts:
                    keys.extend(target_keys(e))
                return keys
            if isinstance(t, ast.Starred):
                return target_keys(t.value)
            return []

        for node in ast.walk(fn):
            if self.mod.enclosing_function(node) is not fn:
                continue
            if isinstance(node, ast.Assign):
                if _sync_call_kind(node.value, self.mod):
                    continue  # loss.item() etc: the result is host data
                if self._tainted(node.value, tainted):
                    for t in node.targets:
                        tainted.update(target_keys(t))
            elif isinstance(node, ast.AugAssign):
                if self._tainted(node.value, tainted):
                    tainted.update(target_keys(node.target))
        return tainted

    def _tainted(self, node, tainted):
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                if _is_step_callee(_callee_name(n, self.mod)):
                    return True
            if isinstance(n, ast.Name) and n.id in tainted:
                return True
            if (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    and f"self.{n.attr}" in tainted):
                return True
        return False

    def expr_tainted(self, fn, node):
        return self._tainted(node, self.taint.get(fn, set()))


def _facts(mod: LintModule) -> ModuleFacts:
    f = getattr(mod, "_gl_facts", None)
    if f is None:
        f = mod._gl_facts = ModuleFacts(mod)
    return f


def _sync_call_kind(node, mod):
    """If ``node`` is a sync construct call, return ("name", arg_node);
    else None. arg_node is the synced expression (or None)."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Name) and f.id in _SYNC_BUILTINS:
        if len(node.args) == 1:
            return (f.id, node.args[0])
        return None
    dotted = mod.dotted(f)
    if dotted in _SYNC_DOTTED:
        arg = node.args[0] if node.args else None
        return (dotted, arg)
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS \
            and not node.args:
        return (f".{f.attr}()", f.value)
    return None


def _is_static_expr(node, mod=None):
    """Expressions whose value is host data, not a device value: literals,
    shape/dtype metadata, sizes and shape arithmetic. ``int(x.shape[0])``
    or ``int(x.numel())`` in a captured body is fine."""
    if node is None:
        return True
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            return True
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Name) and n.func.id == "len":
                return True
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _STATIC_METHODS:
                return True
            if mod is not None and mod.dotted(n.func) in (
                    "numpy.prod", "math.prod", "numpy.ndim"):
                return True
    return isinstance(node, ast.Constant)


# ----------------------------------------------------------------------
# R1: hidden host syncs
# ----------------------------------------------------------------------

@register
class HostSyncRule(Rule):
    name = "R1"
    slug = "host-sync"
    description = (
        "device->host sync in the step path: .item()/.tolist()/.cpu()/"
        ".numpy(), float()/int()/bool() of a tensor or "
        "torch.cuda.synchronize() inside a CUDA-graph capture body (an "
        "error while the stream captures), or per iteration on step "
        "results inside fit/dispatch loops (fix: accumulate on device, "
        "or fetch one step late via telemetry.scorepipe / "
        "telemetry.health)")

    def check(self, mod: LintModule):
        facts = _facts(mod)
        for fn, nodes in facts.captured_scopes():
            for node in nodes:
                kind = _sync_call_kind(node, mod)
                if kind is None:
                    continue
                if kind[0] != "torch.cuda.synchronize" \
                        and _is_static_expr(kind[1], mod):
                    continue
                yield mod.finding(
                    self.name, self.slug, node,
                    f"{kind[0]} inside a CUDA-graph capture body forces a "
                    "device->host sync, which a capturing stream refuses; "
                    "keep the value on device")
        for fn in facts.steploop:
            for node in ast.walk(fn):
                if mod.enclosing_function(node) is not fn:
                    continue
                kind = _sync_call_kind(node, mod)
                if kind is None or not mod.in_loop_within(node, fn):
                    continue
                if kind[0] == "torch.cuda.synchronize":
                    yield mod.finding(
                        self.name, self.slug, node,
                        "torch.cuda.synchronize() per iteration of a step "
                        "loop stalls the host on every step; sync once "
                        "after the loop")
                    continue
                if kind[1] is None or not facts.expr_tainted(fn, kind[1]):
                    continue
                yield mod.finding(
                    self.name, self.slug, node,
                    f"per-iteration {kind[0]} on a train-step result "
                    "forces one device->host sync per step; accumulate "
                    "on device or fetch one step late "
                    "(telemetry.scorepipe.ScorePipeline)")


# ----------------------------------------------------------------------
# R2: Python control flow on device values under capture
# ----------------------------------------------------------------------

@register
class CapturedBranchRule(Rule):
    name = "R2"
    slug = "captured-branch"
    description = (
        "Python if/while on a device value inside a CUDA-graph capture "
        "body: the test syncs (refused while capturing), and a replay "
        "runs whichever branch the capture took, never the other; use "
        "torch.where or hoist the decision out of the captured steps")

    def check(self, mod: LintModule):
        facts = _facts(mod)
        for fn, nodes in facts.captured_scopes():
            params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                                      + fn.args.kwonlyargs)} - {"self", "cls"}
            derived = set(params)
            for node in nodes:
                if isinstance(node, ast.Assign) and not _sync_call_kind(
                        node.value, mod) and not _is_static_expr(
                        node.value, mod):
                    if any(isinstance(n, ast.Name) and n.id in derived
                           for n in ast.walk(node.value)):
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                derived.add(t.id)
            for node in nodes:
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                hit = self._device_test(node.test, derived, mod)
                if hit is not None:
                    yield mod.finding(
                        self.name, self.slug, node,
                        f"branch on {hit} inside a CUDA-graph capture "
                        "body; use torch.where or move the decision out "
                        "of the captured steps")

    @staticmethod
    def _device_test(test, derived, mod):
        """What makes this test depend on a device value, or None.

        Deliberately narrow: bare-name truthiness (structure checks like
        ``if masks:``), ``is None`` sentinels, and shape/dtype metadata
        comparisons are all legitimate static control flow."""
        for n in ast.walk(test):
            if isinstance(n, ast.Call):
                dotted = mod.dotted(n.func) or ""
                if dotted.startswith("torch.") \
                        and dotted not in _STATIC_TORCH \
                        and not dotted.startswith("torch.cuda.") \
                        and not dotted.startswith("torch.jit."):
                    return f"a {dotted}(...) result"
                if isinstance(n.func, ast.Attribute) \
                        and n.func.attr in ("item", "any", "all") \
                        and any(isinstance(m, ast.Name) and m.id in derived
                                for m in ast.walk(n.func.value)):
                    return f"a device value's .{n.func.attr}()"
            if isinstance(n, ast.Compare):
                if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                       for op in n.ops):
                    continue
                operands = [n.left] + list(n.comparators)
                if any(_is_static_expr(o, mod)
                       and not isinstance(o, ast.Constant)
                       for o in operands):
                    continue  # shape/metadata comparison
                for o in operands:
                    for m in ast.walk(o):
                        if isinstance(m, ast.Name) and m.id in derived:
                            return f"device value {m.id!r}"
        return None


# ----------------------------------------------------------------------
# R3: capture / compile / build in a loop
# ----------------------------------------------------------------------

@register
class RecaptureRule(Rule):
    name = "R3"
    slug = "recapture"
    description = (
        "what must be built once, built per iteration: a "
        "torch.cuda.CUDAGraph() or a torch.cuda.graph(...) capture, a "
        "torch.compile, or a kernel build (ops/_build.py, "
        "cpp_extension.load) inside a loop — every iteration pays a fresh "
        "capture, compile or build; torch.compile of an inline lambda "
        "inside a function body rebuilds per call. "
        "torch.utils.checkpoint inside a loop compiles nothing and is "
        "not flagged")

    def check(self, mod: LintModule):
        facts = _facts(mod)
        for node in ast.walk(mod.tree):
            what = self._built(node, mod)
            if what is None:
                continue
            fn = mod.enclosing_function(node)
            if fn is None:
                continue
            if fn in facts.captured and what != "torch.compile":
                continue  # a captured body: replays never run it again
            if mod.in_loop_within(node, fn):
                yield mod.finding(
                    self.name, self.slug, node,
                    f"{what} inside a loop: every iteration pays a fresh "
                    "capture/compile/build; hoist it out and keep the "
                    "result (one graph per signature, one library per "
                    "source)")
            elif (what == "torch.compile" and isinstance(node, ast.Call)
                  and node.args and isinstance(node.args[0], ast.Lambda)):
                yield mod.finding(
                    self.name, self.slug, node,
                    "torch.compile(lambda ...) inside a function body "
                    "builds a fresh callable (and compile-cache entry) per "
                    "call; define the function once at module/class scope")

    @staticmethod
    def _built(node, mod):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for it in node.items:
                if ProjectFacts.is_graph_ctx(mod, it.context_expr):
                    return "a torch.cuda.graph(...) capture"
            return None
        if not isinstance(node, ast.Call):
            return None
        d = mod.dotted(node.func) or ""
        if d in ("torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph"):
            return "torch.cuda.CUDAGraph()"
        if d == "torch.compile":
            return "torch.compile"
        if d.endswith(_BUILD_SUFFIXES) or (
                d.startswith("deeplearning4j_tpu_torch.ops.")
                and d.endswith(".build")):
            return f"kernel build {d}"
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "capture_begin":
            return "a capture_begin() capture"
        return None


# ----------------------------------------------------------------------
# R4: impure captured bodies
# ----------------------------------------------------------------------

@register
class ImpureCaptureRule(Rule):
    name = "R4"
    slug = "impure-capture"
    description = (
        "host-side call inside a CUDA-graph capture body (host RNG, "
        "clocks, telemetry records, print, I/O): it runs once, at "
        "capture, and never at replay — record device stats via the "
        "fetched-one-step-late pattern (telemetry.health / "
        "telemetry.scorepipe) and keep host work outside the capture")

    def check(self, mod: LintModule):
        facts = _facts(mod)
        for fn, nodes in facts.captured_scopes():
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                why = self._impure(node, mod)
                if why:
                    yield mod.finding(
                        self.name, self.slug, node,
                        f"{why} inside a CUDA-graph capture body runs at "
                        "capture only, never at replay; hoist it to the "
                        "host loop / fetch one step late")

    @staticmethod
    def _impure(call, mod):
        f = call.func
        if isinstance(f, ast.Name) and f.id in _IMPURE_NAME_CALLS:
            return f"{f.id}()"
        dotted = mod.dotted(f)
        if dotted:
            if dotted.rsplit(".", 1)[-1] in _PURE_TELEMETRY:
                return None
            if (".telemetry.tracectx" in dotted
                    or dotted.startswith("tracectx.")):
                return (f"trace-context call {dotted} (host-side; "
                        "attach/handoff around the captured steps)")
            if dotted.startswith("deeplearning4j_tpu_torch.telemetry"):
                return f"telemetry call {dotted}"
            if dotted in _IMPURE_DOTTED:
                return f"host RNG seeding {dotted}"
            if dotted.startswith(_IMPURE_DOTTED_PREFIXES):
                return dotted
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            root = f.value.id
            if root in _IMPURE_LOG_ROOTS:
                return f"{root}.{f.attr}()"
            if (f.attr in _IMPURE_METRIC_METHODS
                    and re.match(r"^_m_|^(reg|registry|frec|hm)$|_metric",
                                 root)):
                return f"metric/instrument call {root}.{f.attr}()"
        return None


# ----------------------------------------------------------------------
# R5: card queries outside an availability guard
# ----------------------------------------------------------------------

def _mentions_guard(expr, mod):
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            d = mod.dotted(n.func) or ""
            name = d.rsplit(".", 1)[-1] if d else (
                n.func.attr if isinstance(n.func, ast.Attribute) else "")
            if name in _GUARD_CALLS or _GUARD_NAME_RE.search(name or ""):
                return True
        elif isinstance(n, ast.Attribute) and n.attr == "is_cuda":
            return True
        elif isinstance(n, ast.Name) and _GUARD_NAME_RE.search(n.id):
            return True
        elif isinstance(n, ast.Constant) and n.value == "cuda":
            return True
    return False


def _exits(body):
    last = body[-1] if body else None
    return isinstance(last, (ast.Return, ast.Raise, ast.Continue,
                             ast.Break))


@register
class BackendGuardRule(Rule):
    name = "R5"
    slug = "backend-guard"
    description = (
        "torch.cuda memory/device query (memory_stats, "
        "max_memory_allocated, mem_get_info, get_device_properties, ...) "
        "outside an availability guard or a try: on a CPU run it raises "
        "or has no device to ask — gate it on torch.cuda.is_available(), "
        "a tensor's .is_cuda or a loop over the visible cards")

    def check(self, mod: LintModule):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            d = mod.dotted(node.func) or ""
            head, _, short = d.rpartition(".")
            if short not in _BACKEND_CALLS \
                    or not head.startswith("torch.cuda"):
                continue
            if self._guarded(node, mod):
                continue
            yield mod.finding(
                self.name, self.slug, node,
                f"{d}() needs a card (a CPU run raises); wrap it in "
                "try/except or gate it on torch.cuda.is_available()")

    @staticmethod
    def _guarded(node, mod):
        prev = node
        for a in mod.ancestors(node):
            if isinstance(a, ast.Try):
                return True
            if isinstance(a, (ast.If, ast.IfExp, ast.While)) \
                    and prev is not a.test and _mentions_guard(a.test, mod):
                return True
            if isinstance(a, (ast.For, ast.AsyncFor)) \
                    and prev is not a.iter and _mentions_guard(a.iter, mod):
                return True
            if isinstance(a, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                              ast.DictComp)) and any(
                    _mentions_guard(g.iter, mod) for g in a.generators):
                return True
            if isinstance(a, ast.BoolOp) and isinstance(a.op, ast.And):
                for v in a.values:
                    if v is prev:
                        break
                    if _mentions_guard(v, mod):
                        return True
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Module)) or hasattr(a, "body"):
                # an early exit on a guard earlier in the same block
                for block in ("body", "orelse", "finalbody"):
                    stmts = getattr(a, block, None)
                    if not isinstance(stmts, list) or not any(
                            s is prev for s in stmts):
                        continue
                    for s in stmts:
                        if s is prev:
                            break
                        if isinstance(s, ast.If) and _exits(s.body) \
                                and _mentions_guard(s.test, mod):
                            return True
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return False
            prev = a
        return False


# ----------------------------------------------------------------------
# R6: concurrency smells
# ----------------------------------------------------------------------

@register
class ThreadDisciplineRule(Rule):
    name = "R6"
    slug = "thread-discipline"
    description = (
        "concurrency smells in thread-using modules: threading.Thread "
        "without an explicit daemon flag; read-modify-write of a shared "
        "self attribute outside the owning lock in a lock-bearing class")

    def check(self, mod: LintModule):
        if "threading" not in mod.aliases.values() \
                and "threading" not in mod.aliases:
            return
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and mod.dotted(node.func) == "threading.Thread"
                    and not any(k.arg == "daemon" for k in node.keywords)):
                yield mod.finding(
                    self.name, self.slug, node,
                    "threading.Thread without an explicit daemon= — state "
                    "the join/daemon discipline at construction")
        for cls in (n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)):
            locks = self._lock_attrs(cls, mod)
            if not locks:
                continue
            yield from self._unlocked_writes(cls, locks, mod)

    @staticmethod
    def _lock_attrs(cls, mod):
        names = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Assign):
                continue
            if not (isinstance(node.value, ast.Call) and mod.dotted(
                    node.value.func) in ("threading.Lock",
                                         "threading.RLock",
                                         "threading.Condition")):
                continue
            for t in node.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    names.add(t.attr)
        return names

    def _unlocked_writes(self, cls, locks, mod):
        for fn in (n for n in ast.walk(cls)
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))):
            if fn.name == "__init__":
                continue  # construction is single-threaded
            for node in ast.walk(fn):
                if mod.enclosing_function(node) is not fn:
                    continue
                attr = self._rmw_self_attr(node, mod)
                if attr is None or attr in locks:
                    continue
                if self._under_lock(node, locks, fn, mod):
                    continue
                yield mod.finding(
                    self.name, self.slug, node,
                    f"read-modify-write of shared self.{attr} outside "
                    f"the owning lock (class holds "
                    f"{', '.join(sorted('self.' + l for l in locks))})")

    @staticmethod
    def _rmw_self_attr(node, mod):
        """self attribute mutated non-atomically by this node, or None."""
        def root_self_attr(t):
            while isinstance(t, ast.Subscript):
                t = t.value
            if (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                return t.attr
            return None

        if isinstance(node, ast.AugAssign):
            return root_self_attr(node.target)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATING_METHODS):
            return root_self_attr(node.func.value)
        return None

    @staticmethod
    def _under_lock(node, locks, fn, mod):
        for a in mod.ancestors(node):
            if a is fn:
                return False
            if isinstance(a, ast.With):
                for item in a.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call):
                        ctx = ctx.func
                    if (isinstance(ctx, ast.Attribute)
                            and isinstance(ctx.value, ast.Name)
                            and ctx.value.id == "self"
                            and ctx.attr in locks):
                        return True
        return False
