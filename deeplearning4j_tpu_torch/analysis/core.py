"""graftlint core: findings, parsed modules, rule registry, the runner.

The port's own copy of the JAX package's framework, unchanged in
behaviour: the same findings, suppression comments, baseline identity and
ordering. Everything here is accelerator-agnostic stdlib; rules get a ``LintModule``
(AST with parent links + suppression map + import-alias table) and yield
``Finding``s. The runner filters suppressions and sorts deterministically
so baselines and CI diffs are stable.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path, PurePosixPath


class LintError(Exception):
    """Unrecoverable linter-usage error (bad rule name, missing path)."""


# ----------------------------------------------------------------------
# findings
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str          # posix-relative to the lint root
    line: int
    col: int
    rule: str          # "R1"
    slug: str          # "host-sync"
    message: str
    snippet: str = ""  # stripped source line (baseline identity survives
    #                    line-number drift; see key())
    #: last physical line of the flagged node — suppression comments on
    #: any line of a multi-line statement are honored; not part of the
    #: finding's identity/ordering
    end_line: int = dataclasses.field(default=0, compare=False)
    #: first physical line of the flagged STATEMENT including decorators —
    #: a suppression comment on a decorator line covers the decorated
    #: def/class's findings (0 = same as ``line``)
    sup_start: int = dataclasses.field(default=0, compare=False)

    def key(self):
        """Baseline identity: rule + file + the offending line's text.

        Line NUMBERS drift on every unrelated edit; the line's stripped
        text only changes when the finding itself is touched — the same
        trade clang-tidy/ruff baselines make."""
        return f"{self.rule}|{self.path}|{self.snippet}"

    def human(self):
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}[{self.slug}] {self.message}")

    def to_json(self):
        return dataclasses.asdict(self)


# ----------------------------------------------------------------------
# parsed module + suppressions
# ----------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_*,\s-]+)")


class LintModule:
    """One parsed source file: AST with ``._gl_parent`` links, physical
    lines, the suppression map, and the import-alias table rules share."""

    def __init__(self, source: str, path: str = "<string>"):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._gl_parent = node
        self.line_suppressed, self.file_suppressed = self._suppressions()
        self.aliases = self._import_aliases()

    # -- construction ---------------------------------------------------

    @classmethod
    def from_path(cls, path, rel=None):
        text = Path(path).read_text(encoding="utf-8", errors="replace")
        return cls(text, path=str(rel if rel is not None else path))

    def _suppressions(self):
        per_line, per_file = {}, set()
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except tokenize.TokenError:
            comments = []
        for lineno, text in comments:
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            # a "-- justification" tail is cut BEFORE splitting the rule
            # list, so commas inside the justification never become bogus
            # suppressed-rule names
            spec = m.group(2).split("--", 1)[0].replace("*", "all")
            rules = set()
            for part in spec.split(","):
                tok = part.strip().split()
                if tok:
                    rules.add(tok[0])
            if not rules:
                continue
            if m.group(1) == "disable-file":
                per_file |= rules
            else:
                per_line.setdefault(lineno, set()).update(rules)
        return per_line, per_file

    def _import_aliases(self):
        """{local name: canonical dotted module} — so rules can resolve
        ``np.asarray`` -> ``numpy.asarray`` and ``_tm.span`` ->
        ``deeplearning4j_tpu_torch.telemetry.span`` whatever the import style."""
        aliases = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    # -- shared helpers -------------------------------------------------

    def dotted(self, node):
        """``a.b.c`` for a Name/Attribute chain with the root resolved
        through the alias table; None for dynamic expressions."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def snippet(self, node):
        line = getattr(node, "lineno", 0)
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppressed(self, rule, node):
        if rule in self.file_suppressed or "all" in self.file_suppressed:
            return True
        start = getattr(node, "lineno", 0)
        end = getattr(node, "end_lineno", start) or start
        for line in range(start, end + 1):
            marked = self.line_suppressed.get(line)
            if marked and (rule in marked or "all" in marked):
                return True
        return False

    def finding(self, rule, slug, node, message):
        line = getattr(node, "lineno", 0)
        return Finding(path=self.path, line=line,
                       col=getattr(node, "col_offset", 0) + 1, rule=rule,
                       slug=slug, message=message,
                       snippet=self.snippet(node),
                       end_line=getattr(node, "end_lineno", line) or line,
                       sup_start=self._stmt_start(node))

    def _stmt_start(self, node):
        """First physical line of the decorated statement ``node`` anchors
        to: for a decorated def/class (or a node inside its decorator
        list) the earliest decorator line — so ``# graftlint: disable``
        on a decorator line suppresses the whole decorated statement's
        findings."""
        line = getattr(node, "lineno", 0)
        decorated = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        if isinstance(node, decorated) and node.decorator_list:
            return min(d.lineno for d in node.decorator_list)
        # a finding anchored ON (or inside) a decorator expression: widen
        # to the decorated statement (decorators + def line)
        for a in self.ancestors(node):
            if isinstance(a, decorated) and a.decorator_list:
                for dec in a.decorator_list:
                    if any(n is node for n in ast.walk(dec)):
                        return min(d.lineno for d in a.decorator_list)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                break
        return line

    # -- AST navigation -------------------------------------------------

    @staticmethod
    def parent(node):
        return getattr(node, "_gl_parent", None)

    def ancestors(self, node):
        node = self.parent(node)
        while node is not None:
            yield node
            node = self.parent(node)

    def enclosing_function(self, node):
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def in_loop_within(self, node, func):
        """True when ``node`` sits inside a for/while body that itself
        belongs to ``func`` (not to a nested function)."""
        for a in self.ancestors(node):
            if a is func:
                return False
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return False
            if isinstance(a, (ast.For, ast.While, ast.AsyncFor)):
                # the loop must belong to func too
                for b in self.ancestors(a):
                    if b is func:
                        return True
                    if isinstance(b, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        return False
        return False


# ----------------------------------------------------------------------
# rule registry
# ----------------------------------------------------------------------

class Rule:
    """One lint rule. Subclasses set ``name``/``slug``/``description`` and
    implement ``check(module) -> iterable[Finding]``."""

    name = "R0"
    slug = "abstract"
    description = ""

    def check(self, module: LintModule):
        raise NotImplementedError


class ProjectRule(Rule):
    """A rule that needs the WHOLE module set at once (interprocedural
    dataflow: cross-module call graph, lock graph, donation summaries).
    Subclasses implement ``check_project(modules) -> iterable[Finding]``;
    the runner calls it exactly once per lint run. ``check`` is provided
    for single-module use (tests, editors linting one buffer)."""

    def check(self, module: LintModule):
        return self.check_project([module])

    def check_project(self, modules):
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the global registry."""
    inst = cls()
    _REGISTRY[inst.name] = inst
    return cls


def all_rules():
    """{name: rule} in name order."""
    return dict(sorted(_REGISTRY.items()))


def _select(rule_names):
    if not rule_names:
        return list(all_rules().values())
    picked = []
    for n in rule_names:
        n = n.strip()
        if n not in _REGISTRY:
            raise LintError(f"unknown rule {n!r}; known: "
                            f"{', '.join(all_rules())}")
        picked.append(_REGISTRY[n])
    return picked


# ----------------------------------------------------------------------
# runner
# ----------------------------------------------------------------------

#: directories never descended into when expanding a path
_SKIP_DIRS = {"__pycache__", ".git", ".claude", "node_modules", ".venv"}


def _expand(paths):
    files = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    files.append(f)
        elif p.is_file():
            files.append(p)
        else:
            raise LintError(f"no such file or directory: {p}")
    return files


def lint_modules(mods, rules=None):
    """Run the selected rules over already-parsed modules: per-module rules
    file by file, project rules ONCE over the whole set, suppression
    filtering applied per finding against its own module."""
    selected = _select(rules)
    bypath = {m.path: m for m in mods}
    found = []
    for rule in selected:
        if isinstance(rule, ProjectRule):
            found.extend(rule.check_project(list(mods)))
        else:
            for mod in mods:
                found.extend(rule.check(mod))
    keep = []
    for f in found:
        mod = bypath.get(f.path)
        if mod is not None and mod.suppressed(
                f.rule, _FakeNode(f.sup_start or f.line, f.end_line)):
            continue
        keep.append(f)
    return sorted(set(keep))


def lint_source(source, path="<string>", rules=None):
    """Lint one source string. Returns (findings, parse_error|None)."""
    try:
        mod = LintModule(source, path=path)
    except SyntaxError as e:
        return [], Finding(path=path, line=e.lineno or 0, col=(e.offset or 0),
                           rule="E0", slug="parse-error",
                           message=f"file does not parse: {e.msg}")
    return lint_modules([mod], rules=rules), None


class _FakeNode:
    """Line-range node stand-in so suppression filtering in lint_modules
    can reuse LintModule.suppressed for already-built findings."""

    def __init__(self, line, end_line=0):
        self.lineno = line
        self.end_lineno = max(end_line, line)


def parse_paths(paths, root=None):
    """(modules, parse-error findings) for files/trees. Paths are made
    relative to ``root`` (posix separators) so baseline keys are
    machine-independent; unparseable files surface as ``E0[parse-error]``
    findings rather than aborting the run."""
    root = Path(root) if root is not None else None
    mods, errors = [], []
    for f in _expand(paths):
        rel = f
        if root is not None:
            try:
                rel = f.resolve().relative_to(root.resolve())
            except ValueError:
                rel = f
        rel = str(PurePosixPath(rel))
        text = Path(f).read_text(encoding="utf-8", errors="replace")
        try:
            mods.append(LintModule(text, path=rel))
        except SyntaxError as e:
            errors.append(Finding(
                path=rel, line=e.lineno or 0, col=(e.offset or 0),
                rule="E0", slug="parse-error",
                message=f"file does not parse: {e.msg}"))
    return mods, errors


def lint_paths(paths, rules=None, root=None):
    """Lint files/trees (all files parse FIRST, so project rules see the
    whole module set, then rules run)."""
    mods, errors = parse_paths(paths, root=root)
    return sorted(set(lint_modules(mods, rules=rules) + errors))
