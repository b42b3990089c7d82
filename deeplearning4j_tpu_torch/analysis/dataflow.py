"""Interprocedural facts for the port's graftlint dataflow rules (R7-R9).

The intraprocedural rules R1-R6 see one function at a time; the hazards
R7-R9 check live in the seams BETWEEN functions. :class:`ProjectFacts`
computes, once per lint run over the whole module set:

* a **module-level call graph** — names resolved lexically inside a
  module and through the import-alias table across modules, the same
  "key on how this repo actually builds things" stance as
  ``rules.ModuleFacts``;
* **capture facts** (R7) — the CUDA-graph capture regions (``with
  torch.cuda.graph(g):`` bodies and ``capture_begin()`` ..
  ``capture_end()`` spans), the values bound inside them, and the
  attributes those values are kept in: a captured graph's STATIC outputs,
  which every ``replay()`` overwrites in place;
* **group facts** (R8) — the process groups a collective runs on,
  traced back to where they were opened (``dist.new_group``,
  ``Mesh.group(axis)``, a ``BatchGroup``/``ModelGroup``'s ``.group``, a
  parameter the caller passes), and the project's mesh axis-name universe
  (every ``AXES = ("data", ...)`` tuple literal);
* the **static lock graph** — per-class lock attributes, lock-ordered
  acquisition edges (nested ``with`` blocks and calls whose summaries
  acquire), blocking-call summaries (queue get/put without timeout,
  ``join()``/``wait()``), and the cycles in that graph.

Everything is heuristic-by-design (static analysis over Python), tuned
to this repo's idioms; pure stdlib — importing this module never
imports torch.
"""

from __future__ import annotations

import ast

# ----------------------------------------------------------------------
# small AST helpers
# ----------------------------------------------------------------------
def reaches(graph, start, goal):
    """True when ``goal`` is reachable from ``start`` in the
    ``{node: iterable-of-successors}`` graph (start == goal counts).
    THE cycle primitive for the three lock-graph consumers — static R9
    (``lock_cycles``), graftsan's online inversion check, and the
    ``lint --san-report`` merge — so cycle semantics stay in one place."""
    seen, stack = {start}, [start]
    while stack:
        cur = stack.pop()
        if cur == goal:
            return True
        for nxt in graph.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def chain_of(node):
    """``a.b.c`` string for a pure Name/Attribute chain, else None (the
    identity key R7 tracks static buffers by)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _kw(call, *names):
    for k in call.keywords:
        if k.arg in names:
            return k.value
    return None


def _flat_targets(t):
    """The leaf targets of an assignment target (tuples unpacked)."""
    if isinstance(t, (ast.Tuple, ast.List)):
        out = []
        for e in t.elts:
            out.extend(_flat_targets(e))
        return out
    if isinstance(t, ast.Starred):
        return _flat_targets(t.value)
    return [t]


def _pairs(target, value):
    """(target, value) pairs of one assignment, tuple-to-tuple unpacked."""
    if isinstance(target, (ast.Tuple, ast.List)) \
            and isinstance(value, (ast.Tuple, ast.List)) \
            and len(target.elts) == len(value.elts):
        out = []
        for t, v in zip(target.elts, value.elts):
            out.extend(_pairs(t, v))
        return out
    return [(target, value)]


def _params_of(fn):
    a = fn.args
    return [p.arg for p in (a.posonlyargs + a.args)]


class _FnInfo:
    """One function def with its resolution context."""

    __slots__ = ("node", "mod", "name", "cls", "encl", "params",
                 "is_method")

    def __init__(self, node, mod, cls, encl):
        self.node = node
        self.mod = mod
        self.name = node.name
        self.cls = cls          # enclosing ClassDef or None
        self.encl = encl        # enclosing function node or None
        self.params = _params_of(node)
        self.is_method = cls is not None and encl is None


# ----------------------------------------------------------------------
# project facts
# ----------------------------------------------------------------------

#: ``torch.distributed`` calls that take a process group, and the
#: position of their ``group`` argument (``group=`` is read first)
DIST_GROUP_ARG = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_object": 2, "broadcast": 2, "broadcast_object_list": 2,
    "reduce": 3, "reduce_scatter": 3, "reduce_scatter_tensor": 3,
    "all_to_all": 2, "all_to_all_single": 4, "gather": 3, "scatter": 3,
    "barrier": 0, "send": 2, "recv": 2, "isend": 2, "irecv": 2,
    "monitored_barrier": 0, "get_world_size": 0, "get_rank": 0,
    "get_backend": 0}
#: the port's own collectives (``utils/collectives.py``,
#: ``parallel/sequence.py``) and their group argument's position
PORT_GROUP_ARG = {
    "utils.collectives.all_reduce_": 1, "utils.collectives.reduce_scatter": 1,
    "utils.collectives.all_gather": 1, "utils.collectives.host_staged": 1,
    "utils.collectives.gather_dim": 2, "utils.collectives.AllReduceSum.apply": 1,
    "parallel.sequence.ppermute": 2, "parallel.sequence.all_to_all": 3}
#: module-level tuple literals naming mesh axes (parallel/mesh.py AXES)
_AXES_NAME_SUFFIX = "AXES"

_LOCK_CTORS = {"threading.Lock": "Lock", "threading.RLock": "RLock",
               "threading.Condition": "Condition"}
_QUEUE_CTOR_SUFFIXES = ("queue.Queue", "queue.LifoQueue",
                        "queue.PriorityQueue", "queue.SimpleQueue",
                        "FancyBlockingQueue")
_THREAD_CTOR = "threading.Thread"
_EVENT_CTOR = "threading.Event"


def _mod_dotted(mod):
    p = mod.path
    if p.endswith(".py"):
        p = p[:-3]
    return p.replace("/", ".").lstrip(".")


class ProjectFacts:
    def __init__(self, mods):
        self.mods = list(mods)
        self.dotted_of = {m: _mod_dotted(m) for m in self.mods}
        # ---- function index -------------------------------------------
        self.fns = {}            # node -> _FnInfo
        self.global_fns = {}     # "mod.dotted.name" -> _FnInfo
        self.class_methods = {}  # (mod, ClassDef) -> {name: _FnInfo}
        self.classes = {}        # "mod.dotted.ClassName" -> (mod, ClassDef)
        self._by_mod_name = {}   # (mod, name) -> [_FnInfo]
        for mod in self.mods:
            self._index_module(mod)
        # ---- capture facts (R7) ----------------------------------------
        self.capture_regions = []  # (mod, fn_node, [stmt nodes])
        self.static_attrs = {}     # mod -> {attr name}
        self._capture_pass()
        # ---- group facts (R8) ------------------------------------------
        self.axis_universe = set()
        self._axes_pass()
        # ---- locks ----------------------------------------------------
        self.locks = {}            # lock_id -> {kind, path, line}
        self.fn_acquires = {}      # fn_node -> set[lock_id] (transitive)
        self.fn_blocks = {}        # fn_node -> list[(desc, node)]
        self.lock_edges = []       # (src_id, dst_id, mod, node, via)
        self._lock_pass()

    # ------------------------------------------------------------------
    # indexing + resolution
    # ------------------------------------------------------------------

    def _index_module(self, mod):
        dotted = self.dotted_of[mod]
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                self.classes[f"{dotted}.{node.name}"] = (mod, node)
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            cls = None
            encl = mod.enclosing_function(node)
            for a in mod.ancestors(node):
                if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    break
                if isinstance(a, ast.ClassDef):
                    cls = a
                    break
            info = _FnInfo(node, mod, cls, encl)
            self.fns[node] = info
            self._by_mod_name.setdefault((mod, node.name), []).append(info)
            if cls is None and encl is None:
                self.global_fns[f"{dotted}.{node.name}"] = info
            if cls is not None and encl is None:
                self.class_methods.setdefault((mod, cls), {})[node.name] = \
                    info

    def _class_of_site(self, mod, node):
        for a in mod.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def resolve_call(self, mod, call):
        """_FnInfo the call's target may refer to, or None. Resolution is
        lexical for bare names, ``self.x``/``cls.x`` for methods within
        the site's class, ``super().x`` for the base class, and the
        import-alias table for cross-module ``pkg.mod.fn``."""
        f = call.func
        if isinstance(f, ast.Name):
            info = self._resolve_name(mod, call, f.id)
            if info is not None:
                return info
            dotted = mod.aliases.get(f.id)
            if dotted:
                return self.global_fns.get(dotted)
            return None
        if isinstance(f, ast.Attribute):
            # self.x / cls.x
            if isinstance(f.value, ast.Name) and f.value.id in ("self",
                                                               "cls"):
                cls = self._class_of_site(mod, call)
                if cls is not None:
                    hit = self.class_methods.get((mod, cls), {}).get(f.attr)
                    if hit is not None:
                        return hit
                    return self._base_method(mod, cls, f.attr)
                return None
            # super().x
            if (isinstance(f.value, ast.Call)
                    and isinstance(f.value.func, ast.Name)
                    and f.value.func.id == "super"):
                cls = self._class_of_site(mod, call)
                if cls is not None:
                    return self._base_method(mod, cls, f.attr)
                return None
            dotted = mod.dotted(f)
            if dotted:
                return self.global_fns.get(dotted)
        return None

    def _base_method(self, mod, cls, name):
        for b in cls.bases:
            base = None
            if isinstance(b, ast.Name):
                dotted = mod.aliases.get(b.id, b.id)
                base = (self.classes.get(f"{self.dotted_of[mod]}.{b.id}")
                        or self.classes.get(dotted))
            elif isinstance(b, ast.Attribute):
                dotted = mod.dotted(b)
                base = self.classes.get(dotted) if dotted else None
            if base is not None:
                bmod, bcls = base
                hit = self.class_methods.get((bmod, bcls), {}).get(name)
                if hit is not None:
                    return hit
        return None

    def _resolve_name(self, mod, site, name):
        """Lexically-visible same-module def for a bare name."""
        candidates = self._by_mod_name.get((mod, name))
        if not candidates:
            return None
        scope = mod.enclosing_function(site)
        chain = []
        while scope is not None:
            chain.append(scope)
            info = self.fns.get(scope)
            scope = info.encl if info else None
        chain.append(None)
        for s in chain:
            for info in candidates:
                if info.encl is s and (s is not None or info.cls is None):
                    return info
        return None

    # ------------------------------------------------------------------
    # capture facts (R7)
    # ------------------------------------------------------------------

    @staticmethod
    def is_graph_ctx(mod, expr):
        """True for ``torch.cuda.graph(...)`` (the capture context)."""
        if not isinstance(expr, ast.Call):
            return False
        d = mod.dotted(expr.func) or ""
        return d == "torch.cuda.graph" or d.endswith("cuda.graph")

    @classmethod
    def capture_spans(cls, mod, fn):
        """The capture regions of ``fn``'s own body, each a list of the
        statements that run while a graph captures: a ``with
        torch.cuda.graph(...)`` block's body, and every statement of
        ``fn`` between a ``.capture_begin()`` and the next
        ``.capture_end()`` (by line)."""
        spans = []
        own = [n for n in ast.walk(fn) if mod.enclosing_function(n) is fn]
        for n in own:
            if isinstance(n, (ast.With, ast.AsyncWith)) and any(
                    cls.is_graph_ctx(mod, it.context_expr) for it in n.items):
                spans.append(list(n.body))
        marks = sorted((n.lineno, n.func.attr) for n in own
                       if isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Attribute)
                       and n.func.attr in ("capture_begin", "capture_end"))
        begin = None
        for line, what in marks:
            if what == "capture_begin":
                begin = line if begin is None else begin
            elif begin is not None:
                spans.append([n for n in own if isinstance(n, ast.stmt)
                              and begin < n.lineno < line])
                begin = None
        return spans

    def _capture_pass(self):
        """Capture regions and the static-output attributes they feed: a
        name bound inside a region (``out = self._steps(...)``) and then
        stored on an object (``sig.graph, sig.out = graph, out``), or an
        attribute assigned inside the region itself."""
        for info in self.fns.values():
            mod = info.mod
            for span in self.capture_spans(mod, info.node):
                self.capture_regions.append((mod, info.node, span))
                bound = set()
                attrs = self.static_attrs.setdefault(mod, set())
                for stmt in span:
                    for n in ast.walk(stmt):
                        if isinstance(n, (ast.Assign, ast.AnnAssign,
                                          ast.AugAssign)):
                            targets = n.targets if isinstance(
                                n, ast.Assign) else [n.target]
                            for t in targets:
                                for e in _flat_targets(t):
                                    if isinstance(e, ast.Name):
                                        bound.add(e.id)
                                    elif isinstance(e, ast.Attribute):
                                        attrs.add(e.attr)
                if not bound:
                    continue
                end = max(getattr(st, "end_lineno", st.lineno) or st.lineno
                          for st in span) if span else 0
                for n in ast.walk(info.node):
                    if not isinstance(n, ast.Assign) or n.lineno <= end \
                            or mod.enclosing_function(n) is not info.node:
                        continue
                    for t in n.targets:
                        pairs = list(zip(t.elts, n.value.elts)) if (
                            isinstance(t, ast.Tuple)
                            and isinstance(n.value, ast.Tuple)
                            and len(t.elts) == len(n.value.elts)) \
                            else [(t, n.value)]
                        for tt, vv in pairs:
                            if isinstance(tt, ast.Attribute) \
                                    and isinstance(vv, ast.Name) \
                                    and vv.id in bound:
                                attrs.add(tt.attr)

    # ------------------------------------------------------------------
    # group facts (R8)
    # ------------------------------------------------------------------

    def _axes_pass(self):
        for mod in self.mods:
            for node in mod.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                if not any(isinstance(t, ast.Name)
                           and t.id.endswith(_AXES_NAME_SUFFIX)
                           for t in node.targets):
                    continue
                if isinstance(node.value, (ast.Tuple, ast.List)):
                    for e in node.value.elts:
                        if isinstance(e, ast.Constant) \
                                and isinstance(e.value, str):
                            self.axis_universe.add(e.value)

    def collective_group_arg(self, mod, call):
        """(name, group expression or None) when ``call`` is a collective
        (or group query) of ``torch.distributed`` or of the port's own
        collectives; None for any other call. A missing group argument
        is the default (world) group."""
        d = mod.dotted(call.func) or ""
        pos = None
        if d.startswith("torch.distributed.") \
                and d.rsplit(".", 1)[-1] in DIST_GROUP_ARG:
            pos = DIST_GROUP_ARG[d.rsplit(".", 1)[-1]]
        else:
            # bare names inside the defining module resolve against it
            cands = (d, f"{_mod_dotted(mod)}.{d}")
            for name, p in PORT_GROUP_ARG.items():
                if any(c == name or c.endswith("." + name) for c in cands):
                    pos = p
                    break
        if pos is None:
            return None
        expr = _kw(call, "group")
        if expr is None and pos < len(call.args):
            expr = call.args[pos]
        short = ".".join(d.split(".")[-2:]) if d.endswith(".apply") \
            else d.rsplit(".", 1)[-1]
        return short, expr

    def group_origin(self, mod, site, expr, _depth=0):
        """Where the process group ``expr`` evaluates to at ``site`` came
        from: "opened" (``dist.new_group``, ``<mesh>.group(axis)``, a
        ``BatchGroup``/``ModelGroup``'s ``.group``, the default group,
        ``dist.group.WORLD``), "caller" (a parameter: the caller decides),
        "unknown", or a description of what it is instead (a literal: the
        JAX idiom of naming an axis where a ProcessGroup belongs)."""
        if expr is None:
            return "opened"
        if _depth > 6:
            return "unknown"
        if isinstance(expr, ast.Constant):
            if expr.value is None:
                return "opened"
            return f"the literal {expr.value!r}"
        if isinstance(expr, ast.IfExp):
            arms = [self.group_origin(mod, site, e, _depth + 1)
                    for e in (expr.body, expr.orelse)]
            bad = [v for v in arms if v not in ("opened", "caller", "unknown")]
            return bad[0] if bad else arms[0]
        if isinstance(expr, ast.Call):
            d = mod.dotted(expr.func) or ""
            if d.endswith("new_group") or d.endswith("Group") \
                    or (isinstance(expr.func, ast.Attribute)
                        and expr.func.attr in ("group", "new_group")):
                return "opened"
            return "unknown"
        if isinstance(expr, ast.Attribute):
            if expr.attr in ("group", "WORLD", "data_group", "model_group",
                             "seq_group", "_group") \
                    and not (isinstance(expr.value, ast.Name)
                             and expr.value.id == "self"):
                return "opened"
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                cls = self._class_of_site(mod, site)
                if cls is None:
                    return "unknown"
                verdicts = []
                for n in ast.walk(cls):
                    if not isinstance(n, ast.Assign):
                        continue
                    for t in n.targets:
                        for tt, vv in _pairs(t, n.value):
                            if isinstance(tt, ast.Attribute) \
                                    and tt.attr == expr.attr \
                                    and isinstance(tt.value, ast.Name) \
                                    and tt.value.id == "self":
                                verdicts.append(self.group_origin(
                                    mod, n, vv, _depth + 1))
                bad = [v for v in verdicts
                       if v not in ("opened", "caller", "unknown")]
                return bad[0] if bad else (
                    "opened" if verdicts else "unknown")
            return "unknown"
        if isinstance(expr, ast.Name):
            fn = mod.enclosing_function(site)
            a = fn.args if fn is not None else None
            if a is not None and expr.id in {p.arg for p in (
                    a.posonlyargs + a.args + a.kwonlyargs)}:
                return "caller"
            scope = fn if fn is not None else mod.tree
            best = None
            for n in ast.walk(scope):
                if isinstance(n, ast.Assign) and n.lineno <= site.lineno:
                    for t in n.targets:
                        for tt, vv in _pairs(t, n.value):
                            if isinstance(tt, ast.Name) \
                                    and tt.id == expr.id \
                                    and (best is None
                                         or n.lineno >= best[0]):
                                best = (n.lineno, n, vv)
            if best is not None:
                return self.group_origin(mod, best[1], best[2], _depth + 1)
            return "unknown"
        return "unknown"

    # ------------------------------------------------------------------
    # lock facts (R9)
    # ------------------------------------------------------------------

    def _lock_pass(self):
        # discover lock/queue/thread/event attrs per class + module locks
        self._cls_locks = {}    # (mod, ClassDef) -> {attr: (kind, line)}
        self._cls_queues = {}   # (mod, ClassDef) -> set[attr]
        self._cls_threads = {}
        self._cls_events = {}
        self._mod_locks = {}    # (mod, name) -> (kind, line)
        for mod in self.mods:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign) \
                        or not isinstance(node.value, ast.Call):
                    continue
                d = mod.dotted(node.value.func) or ""
                kind = _LOCK_CTORS.get(d)
                is_q = d.endswith(_QUEUE_CTOR_SUFFIXES)
                is_t = d == _THREAD_CTOR or d.endswith(".Thread")
                is_e = d == _EVENT_CTOR or d.endswith(".Event")
                if not (kind or is_q or is_t or is_e):
                    continue
                cls = self._class_of_site(mod, node)
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self" and cls is not None):
                        if kind:
                            self._cls_locks.setdefault(
                                (mod, cls), {})[t.attr] = (kind,
                                                           node.lineno)
                        elif is_q:
                            self._cls_queues.setdefault(
                                (mod, cls), set()).add(t.attr)
                        elif is_t:
                            self._cls_threads.setdefault(
                                (mod, cls), set()).add(t.attr)
                        elif is_e:
                            self._cls_events.setdefault(
                                (mod, cls), set()).add(t.attr)
                    elif isinstance(t, ast.Name) and cls is None \
                            and mod.enclosing_function(node) is None:
                        if kind:
                            self._mod_locks[(mod, t.id)] = (kind,
                                                            node.lineno)
        for (mod, cls), attrs in self._cls_locks.items():
            for attr, (kind, line) in attrs.items():
                self.locks[self._lock_id(mod, cls, attr)] = {
                    "kind": kind, "path": mod.path, "line": line}
        for (mod, name), (kind, line) in self._mod_locks.items():
            self.locks[f"{self.dotted_of[mod]}.{name}"] = {
                "kind": kind, "path": mod.path, "line": line}
        # per-function direct acquires / blocking ops, then transitive
        direct_acq = {}
        direct_blk = {}
        for info in self.fns.values():
            acq, blk = set(), []
            for node in ast.walk(info.node):
                if info.mod.enclosing_function(node) is not info.node:
                    continue
                lid = self._with_lock_id(info, node)
                if lid:
                    acq.add(lid)
                b = self._blocking(info, node, held=None)
                if b:
                    blk.append((b, node))
            direct_acq[info.node] = acq
            direct_blk[info.node] = blk
        self.fn_acquires = {fn: set(a) for fn, a in direct_acq.items()}
        self.fn_blocks = {fn: list(b) for fn, b in direct_blk.items()}
        changed = True
        iters = 0
        while changed and iters < 8:
            changed = False
            iters += 1
            for info in self.fns.values():
                for call in (n for n in ast.walk(info.node)
                             if isinstance(n, ast.Call)):
                    tgt = self.resolve_call(info.mod, call)
                    if tgt is None or tgt.node is info.node:
                        continue
                    add = self.fn_acquires.get(tgt.node, set()) \
                        - self.fn_acquires[info.node]
                    if add:
                        self.fn_acquires[info.node] |= add
                        changed = True
                    if self.fn_blocks.get(tgt.node) \
                            and not any(n is call for _, n
                                        in self.fn_blocks[info.node]):
                        desc = self.fn_blocks[tgt.node][0][0]
                        self.fn_blocks[info.node].append(
                            (f"{desc} (via {tgt.name}())", call))
                        changed = True
        # edges + blocking-under-lock sites
        self.blocking_under_lock = []   # (lock_id, desc, mod, node)
        for info in self.fns.values():
            self._walk_lock_regions(info)

    @staticmethod
    def _lock_id(mod, cls, attr):
        return f"{_mod_dotted(mod)}.{cls.name}.{attr}"

    def _attr_owner(self, mod, cls, attr, table):
        """(owner_mod, owner_cls) defining ``attr`` in ``table`` for the
        class or (transitively) its statically-resolvable bases — so a
        subclass's ``with self._lock`` maps to the INHERITED lock's
        identity, not a phantom second lock."""
        seen = set()
        stack = [(mod, cls)]
        while stack:
            m, c = stack.pop()
            if (id(m), id(c)) in seen:
                continue
            seen.add((id(m), id(c)))
            entry = table.get((m, c))
            if entry is not None and attr in entry:
                return m, c
            for b in c.bases:
                base = None
                if isinstance(b, ast.Name):
                    dotted = m.aliases.get(b.id, b.id)
                    base = (self.classes.get(
                        f"{self.dotted_of[m]}.{b.id}")
                        or self.classes.get(dotted))
                elif isinstance(b, ast.Attribute):
                    dotted = m.dotted(b)
                    base = self.classes.get(dotted) if dotted else None
                if base is not None:
                    stack.append(base)
        return None

    def _with_lock_id(self, info, node):
        """lock_id if ``node`` is a With whose first item acquires a
        known lock of the enclosing class (own or inherited) / module."""
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            return None
        for item in node.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call):
                ctx = ctx.func
            if (isinstance(ctx, ast.Attribute)
                    and isinstance(ctx.value, ast.Name)
                    and ctx.value.id == "self" and info.cls is not None):
                owner = self._attr_owner(info.mod, info.cls, ctx.attr,
                                         self._cls_locks)
                if owner is not None:
                    return self._lock_id(owner[0], owner[1], ctx.attr)
            if isinstance(ctx, ast.Name):
                if (info.mod, ctx.id) in self._mod_locks:
                    return f"{self.dotted_of[info.mod]}.{ctx.id}"
        return None

    def _blocking(self, info, node, held):
        """Description if ``node`` is a potentially-unbounded blocking
        call: queue get/put with no timeout, thread join() with no
        timeout, event wait() with no timeout. The condvar idiom —
        waiting on the very lock you hold — is exempt."""
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            return None
        recv, meth = node.func.value, node.func.attr
        if not (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self" and info.cls is not None):
            return None
        has_timeout = _kw(node, "timeout") is not None or len(node.args) >= 2

        def owns(table):
            return self._attr_owner(info.mod, info.cls, recv.attr,
                                    table) is not None

        if meth in ("get", "put") and owns(self._cls_queues):
            # get(False)/get(block=False)/put(x, False) never block at all
            block_arg = _kw(node, "block")
            if block_arg is None:
                pos = 0 if meth == "get" else 1
                if pos < len(node.args):
                    block_arg = node.args[pos]
            if isinstance(block_arg, ast.Constant) \
                    and block_arg.value is False:
                return None
            if meth == "put" and len(node.args) >= 2:
                has_timeout = True
            if not has_timeout:
                return f"blocking self.{recv.attr}.{meth}() with no timeout"
        if meth == "join" and owns(self._cls_threads):
            if not (node.args or _kw(node, "timeout") is not None):
                return f"self.{recv.attr}.join() with no timeout"
        if meth == "wait":
            if owns(self._cls_events):
                if not (node.args or _kw(node, "timeout") is not None):
                    return f"self.{recv.attr}.wait() with no timeout"
            owner = self._attr_owner(info.mod, info.cls, recv.attr,
                                     self._cls_locks)
            if owner is not None and held is not None:
                lid = self._lock_id(owner[0], owner[1], recv.attr)
                if lid != held \
                        and not (node.args
                                 or _kw(node, "timeout") is not None):
                    return (f"self.{recv.attr}.wait() with no timeout "
                            f"(not the held lock)")
        return None

    def _walk_lock_regions(self, info):
        """Record ordered edges + blocking ops for every with-lock region
        of one function."""
        mod = info.mod

        def walk(node, held):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                lid = self._with_lock_id(info, child)
                if lid:
                    if held:
                        self.lock_edges.append(
                            (held[-1], lid, mod, child, "nested with"))
                    walk(child, held + [lid])
                    continue
                if held and isinstance(child, ast.Call):
                    b = self._blocking(info, child, held=held[-1])
                    if b:
                        self.blocking_under_lock.append(
                            (held[-1], b, mod, child))
                    tgt = self.resolve_call(mod, child)
                    if tgt is not None and tgt.node is not info.node:
                        for acquired in sorted(
                                self.fn_acquires.get(tgt.node, ())):
                            self.lock_edges.append(
                                (held[-1], acquired, mod, child,
                                 f"call to {tgt.name}()"))
                        for desc, _n in self.fn_blocks.get(tgt.node, ()):
                            self.blocking_under_lock.append(
                                (held[-1],
                                 f"{desc} inside {tgt.name}()",
                                 mod, child))
                walk(child, held)

        walk(info.node, [])

    def lock_cycles(self):
        """Simple cycles in the lock-order graph as ordered lock-id
        tuples (deterministic), including self-cycles on non-reentrant
        Lock kinds."""
        graph = {}
        for src, dst, *_ in self.lock_edges:
            graph.setdefault(src, set()).add(dst)
        cycles = set()
        for src, dst, *_ in self.lock_edges:
            if src == dst:
                if self.locks.get(src, {}).get("kind") == "Lock":
                    cycles.add((src,))
                continue
            if reaches(graph, dst, src):
                cycles.add(tuple(sorted((src, dst))))
        return sorted(cycles)


def project_facts(mods):
    """Cached ProjectFacts for this exact module list (all dataflow rules
    share one build per lint run)."""
    key = tuple(id(m) for m in mods)
    if not mods:                  # every file failed to parse
        return ProjectFacts(mods)
    holder = mods[0]
    cached = getattr(holder, "_gl_pfacts", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    facts = ProjectFacts(mods)
    holder._gl_pfacts = (key, facts)
    return facts
