"""graftlint contract rules R10-R13: the distributed tier's string contracts.

The port's fleet, hostfleet, federation, SLO, serving, streaming and UI
tiers hinge on contracts R1-R9 cannot see because they live in STRING
space, not value space: HTTP routes and header names, response-JSON
keys, and metric series names with their label sets. A verdict series
that is not pre-registered appears too late for the SLO delta window; a
route a client names but no handler serves can only 404. This module
harvests those contracts into one :class:`ContractFacts` registry per
lint run and checks them (the JAX package's rules, carried over as
written):

* ``R10 wire-contract``     — HTTP handler dispatch (``do_GET``/``do_POST``
  classes matching on ``path``) vs client call sites (``base + "/route"``
  fed to an http helper): requests to routes no handler serves, reads of
  response-JSON keys no handler emits, and ``X-*`` header-name drift
  (two spellings that normalize to the same header).
* ``R11 metric-schema``     — every counter/gauge/histogram emit site
  folded into a name -> (type, label-key-set) registry: emit sites whose
  label sets don't nest (optional labels ride the subset relation),
  series referenced by SLO rules (``telemetry/slo.py SloRule``) /
  ``series_map`` that no creation site produces, and verdict/outcome
  counters that fire before any ``inc(0, ...)`` pre-registration.
* ``R12 blocking-timeout``  — HTTP/socket requests, ``communicate``,
  bare ``join()``/``get()`` and bounded-queue ``put`` WITHOUT a timeout
  on the fleet/hostfleet/federate paths (the hang class the supervisors
  exist to bound; R9 flags these only under a lock — the wire paths may
  not hold one).
* ``R13 label-cardinality`` — a metric label fed from request-derived or
  unbounded strings (raw request paths, exception text) instead of a
  closed set: every distinct value mints a new series forever.

The same harvest feeds ``lint --emit-schema``: :func:`build_schema`
renders the wire+metric contract as a deterministic ``SCHEMA.json`` and
a human ``METRICS.md`` table (the port's own, under
``deeplearning4j_tpu_torch/analysis/schema/``), so tests consume the
registry the rules enforce.

Pure stdlib, heuristic by design — same stance as rules.py/dataflow.py.
"""

from __future__ import annotations

import ast
import re

from deeplearning4j_tpu_torch.analysis.core import ProjectRule, register
from deeplearning4j_tpu_torch.analysis.dataflow import _QUEUE_CTOR_SUFFIXES, _kw

#: X-Header-Name literals (the wire-header shape worth policing)
_HEADER_RE = re.compile(r"^X-[A-Za-z0-9]+(?:-[A-Za-z0-9]+)+$")
_DO_METHOD_RE = re.compile(r"^do_[A-Z]+$")

_METRIC_CTORS = ("counter", "gauge", "histogram")
_EMIT_METHODS = ("inc", "set", "observe")
#: callables whose first argument is a request URL (client call sites)
_CLIENT_FUNCS = ("_http_json", "http_json", "urlopen")
#: label keys naming a closed verdict/outcome enum — the series R11
#: requires pre-registered at zero (the SLO delta discipline ignores a
#: series' FIRST appearance; one born mid-storm delays the gate a window)
_ENUM_LABELS = frozenset(("outcome", "verdict"))


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _mentions_path(expr):
    """True when ``expr`` reads something called ``path`` (``self.path``,
    ``url.path``, a ``path`` parameter) — the request-path signal both
    the route harvest and R13 key on."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr == "path":
            return True
        if isinstance(n, ast.Name) and n.id == "path":
            return True
    return False


class _Emit:
    """One resolved metric emit site (inc/set/observe on a binding that
    traces back to a registry creation call)."""

    __slots__ = ("name", "method", "labels", "dynamic", "zero", "values",
                 "mod", "node")

    def __init__(self, name, method, call, mod):
        self.name = name
        self.method = method
        self.mod = mod
        self.node = call
        self.labels = frozenset(k.arg for k in call.keywords if k.arg)
        self.dynamic = any(k.arg is None for k in call.keywords)
        self.values = {k.arg: k.value for k in call.keywords if k.arg}
        amt = call.args[0] if call.args else None
        self.zero = (isinstance(amt, ast.Constant)
                     and not isinstance(amt.value, bool)
                     and amt.value == 0)


class ContractFacts:
    """Wire + metric contracts harvested once per module set (cached the
    same way :func:`dataflow.project_facts` is)."""

    def __init__(self, mods):
        self.mods = list(mods)
        # ---- wire -----------------------------------------------------
        self.routes = []          # (path, "exact"|"prefix", method, mod, node)
        self.response_keys = set()
        self.client_routes = []   # (route, mod, node)
        self.headers = []         # (value, mod, node)
        self.doc_reads = []       # (key, mod, node)
        # ---- metrics --------------------------------------------------
        self.created = {}         # name -> {"kinds", "help", "sites"}
        self.dynamic_prefixes = set()
        self.emits = []           # [_Emit]
        self.refs = []            # (name, via, mod, node)
        for mod in self.mods:
            self._harvest_wire(mod)
            self._harvest_metrics(mod)

    # ------------------------------------------------------------------
    # wire harvest
    # ------------------------------------------------------------------

    def _harvest_wire(self, mod):
        for n in ast.walk(mod.tree):
            val = _const_str(n)
            if val is not None and _HEADER_RE.match(val):
                self.headers.append((val, mod, n))
        for cls in (n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.ClassDef)):
            do_meths = [m for m in cls.body
                        if isinstance(m, ast.FunctionDef)
                        and _DO_METHOD_RE.match(m.name)]
            if not do_meths:
                continue
            for meth in do_meths:
                self._harvest_routes(mod, meth)
            # every str-keyed dict literal or subscript-assign anywhere
            # in a handler class is (part of) a possible response body:
            # over-collecting keys only weakens the missing-key check,
            # never falsifies it
            for n in ast.walk(cls):
                if isinstance(n, ast.Dict):
                    for k in n.keys:
                        key = _const_str(k) if k is not None else None
                        if key is not None:
                            self.response_keys.add(key)
                elif isinstance(n, ast.Assign):
                    for t in n.targets:
                        if isinstance(t, ast.Subscript):
                            key = _const_str(t.slice)
                            if key is not None:
                                self.response_keys.add(key)
        self._harvest_client(mod)

    def _harvest_routes(self, mod, meth):
        http_method = meth.name[3:]

        def add(path, match, node):
            self.routes.append((path, match, http_method, mod, node))

        for n in ast.walk(meth):
            if isinstance(n, ast.Compare) and len(n.ops) == 1:
                if isinstance(n.ops[0], ast.Eq):
                    for a, b in ((n.left, n.comparators[0]),
                                 (n.comparators[0], n.left)):
                        v = _const_str(b)
                        if v is not None and v.startswith("/") \
                                and _mentions_path(a):
                            add(v, "exact", n)
                elif isinstance(n.ops[0], ast.In) \
                        and _mentions_path(n.left):
                    cont = n.comparators[0]
                    if isinstance(cont, (ast.Tuple, ast.List, ast.Set)):
                        for e in cont.elts:
                            v = _const_str(e)
                            if v is not None and v.startswith("/"):
                                add(v, "exact", n)
            elif (isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "startswith" and n.args
                  and _mentions_path(n.func.value)):
                v = _const_str(n.args[0])
                if v is not None and v.startswith("/"):
                    add(v, "prefix", n)

    @staticmethod
    def _route_of(arg):
        """The literal route in a ``base + "/route"`` URL build."""
        if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
            v = _const_str(arg.right)
            if v is not None and v.startswith("/"):
                return v.split("?")[0]
        return None

    def _harvest_client(self, mod):
        docvars = set()   # (enclosing_fn, varname) holding a response doc
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            dotted = mod.dotted(f) or ""
            if fname not in _CLIENT_FUNCS \
                    and not dotted.endswith(".urlopen"):
                continue
            if n.args:
                route = self._route_of(n.args[0])
                if route is not None:
                    self.client_routes.append((route, mod, n))
            par = mod.parent(n)
            if isinstance(par, ast.Assign):
                scope = mod.enclosing_function(n)
                for t in par.targets:
                    elts = t.elts if isinstance(t, ast.Tuple) else [t]
                    for e in elts:
                        if isinstance(e, ast.Name):
                            docvars.add((scope, e.id))
        if not docvars:
            return
        for n in ast.walk(mod.tree):
            recv = key = None
            if isinstance(n, ast.Subscript) \
                    and isinstance(n.value, ast.Name):
                recv, key = n.value.id, _const_str(n.slice)
            elif (isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "get"
                  and isinstance(n.func.value, ast.Name) and n.args):
                recv, key = n.func.value.id, _const_str(n.args[0])
            if recv is None or key is None:
                continue
            if (mod.enclosing_function(n), recv) in docvars:
                self.doc_reads.append((key, mod, n))

    # ------------------------------------------------------------------
    # metric harvest
    # ------------------------------------------------------------------

    def _creation(self, call):
        """(name, kind, help) when ``call`` is ``<reg>.counter("x", ...)``
        (or gauge/histogram); name None for dynamic first args."""
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in _METRIC_CTORS and call.args):
            return None
        kind = call.func.attr
        name = _const_str(call.args[0])
        if name is None:
            if isinstance(call.args[0], ast.JoinedStr):
                vals = call.args[0].values
                if vals and isinstance(vals[0], ast.Constant) \
                        and isinstance(vals[0].value, str):
                    self.dynamic_prefixes.add(vals[0].value)
            return None
        help_ = ""
        if len(call.args) > 1:
            help_ = _const_str(call.args[1]) or ""
        return name, kind, help_

    def _note_creation(self, name, kind, help_, mod, node):
        info = self.created.setdefault(
            name, {"kinds": set(), "help": "", "sites": []})
        info["kinds"].add(kind)
        if help_ and not info["help"]:
            info["help"] = help_
        info["sites"].append((mod, node))

    def _class_of(self, mod, node):
        for a in mod.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def _harvest_metrics(self, mod):
        cls_attr = {}    # (ClassDef, attr) -> name
        cls_dict = {}    # (ClassDef, attr, key) -> name
        local = {}       # (fn|None, varname) -> name
        fn_ret = {}      # function name -> metric name
        fn_ret_tuple = {}  # function name -> [metric names]

        def note(v, mod_, node_):
            got = self._creation(v)
            if got is not None:
                self._note_creation(*got, mod_, node_)
            return got

        # creation sites (all of them, bound or not) + return-map
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call):
                note(n, mod, n)
        for fn in (n for n in ast.walk(mod.tree)
                   if isinstance(n, ast.FunctionDef)):
            for r in ast.walk(fn):
                if not isinstance(r, ast.Return) or r.value is None:
                    continue
                got = self._creation(r.value)
                if got is not None:
                    fn_ret.setdefault(fn.name, got[0])
                elif isinstance(r.value, ast.Tuple):
                    names = [self._creation(e) for e in r.value.elts]
                    if names and all(g is not None for g in names):
                        fn_ret_tuple.setdefault(
                            fn.name, [g[0] for g in names])
        # bindings
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Assign) or len(n.targets) != 1:
                continue
            t, v = n.targets[0], n.value
            pairs = []
            if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) \
                    and len(t.elts) == len(v.elts):
                pairs = list(zip(t.elts, v.elts))
            elif isinstance(t, ast.Tuple) and isinstance(v, ast.Call) \
                    and isinstance(v.func, ast.Name) \
                    and v.func.id in fn_ret_tuple \
                    and len(t.elts) == len(fn_ret_tuple[v.func.id]):
                scope = mod.enclosing_function(n)
                for e, name in zip(t.elts, fn_ret_tuple[v.func.id]):
                    if isinstance(e, ast.Name):
                        local[(scope, e.id)] = name
                continue
            else:
                pairs = [(t, v)]
            for tt, vv in pairs:
                if isinstance(vv, ast.Dict) and isinstance(tt, ast.Attribute) \
                        and isinstance(tt.value, ast.Name) \
                        and tt.value.id == "self":
                    cls = self._class_of(mod, n)
                    if cls is None:
                        continue
                    for k, dv in zip(vv.keys, vv.values):
                        key = _const_str(k) if k is not None else None
                        got = self._creation(dv)
                        if key is not None and got is not None:
                            cls_dict[(cls, tt.attr, key)] = got[0]
                    continue
                got = self._creation(vv)
                if got is None and isinstance(vv, ast.Call) \
                        and isinstance(vv.func, ast.Name) \
                        and vv.func.id in fn_ret:
                    # x = _make_counter(): a creation-returning helper
                    got = (fn_ret[vv.func.id], None, None)
                if got is None:
                    continue
                if isinstance(tt, ast.Attribute) \
                        and isinstance(tt.value, ast.Name) \
                        and tt.value.id == "self":
                    cls = self._class_of(mod, n)
                    if cls is not None:
                        cls_attr[(cls, tt.attr)] = got[0]
                elif isinstance(tt, ast.Name):
                    local[(mod.enclosing_function(n), tt.id)] = got[0]
        # emit sites
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _EMIT_METHODS):
                continue
            recv = n.func.value
            name = None
            if isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id == "self":
                cls = self._class_of(mod, n)
                if cls is not None:
                    name = cls_attr.get((cls, recv.attr))
            elif isinstance(recv, ast.Name):
                name = local.get((mod.enclosing_function(n), recv.id)) \
                    or local.get((None, recv.id))
            elif isinstance(recv, ast.Call) \
                    and isinstance(recv.func, ast.Name):
                name = fn_ret.get(recv.func.id)
            elif isinstance(recv, ast.Subscript) \
                    and isinstance(recv.value, ast.Attribute) \
                    and isinstance(recv.value.value, ast.Name) \
                    and recv.value.value.id == "self":
                cls = self._class_of(mod, n)
                key = _const_str(recv.slice)
                if cls is not None and key is not None:
                    name = cls_dict.get((cls, recv.value.attr, key))
            if name is not None:
                self.emits.append(_Emit(name, n.func.attr, n, mod))
        # reference sites (SLO rules, series_map reads)
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            fname = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else "")
            if fname == "series_map" and n.args:
                v = _const_str(n.args[0])
                if v is not None:
                    self.refs.append((v, "series_map", mod, n))
            elif fname.endswith("SloRule"):
                metric = _kw(n, "metric")
                if metric is None and len(n.args) > 2:
                    metric = n.args[2]
                for expr in (metric, _kw(n, "den_metric")):
                    v = _const_str(expr) if expr is not None else None
                    if v is not None:
                        self.refs.append((v, "SloRule", mod, n))


def contract_facts(mods):
    """Cached ContractFacts for this exact module list (R10-R13 and the
    schema emitter share one harvest per lint run)."""
    if not mods:
        return ContractFacts(mods)
    key = tuple(id(m) for m in mods)
    holder = mods[0]
    cached = getattr(holder, "_gl_cfacts", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    facts = ContractFacts(mods)
    holder._gl_cfacts = (key, facts)
    return facts


# ----------------------------------------------------------------------
# R10: wire-contract
# ----------------------------------------------------------------------

@register
class WireContractRule(ProjectRule):
    name = "R10"
    slug = "wire-contract"
    description = (
        "HTTP string-contract drift between handlers and clients: a "
        "client URL build (base + \"/route\") naming a route no "
        "do_GET/do_POST handler dispatches on; a response-JSON key read "
        "from an http-call result that no handler ever emits; and "
        "X-Header-Name literals whose spellings differ only in "
        "hyphenation/case (wire headers silently don't match)")

    def check_project(self, mods):
        facts = contract_facts(mods)
        exact = {r[0] for r in facts.routes if r[1] == "exact"}
        prefixes = sorted({r[0] for r in facts.routes if r[1] == "prefix"})
        if facts.routes:
            known = ", ".join(sorted(exact | set(prefixes)))
            for route, mod, node in facts.client_routes:
                if route in exact \
                        or any(route.startswith(p) for p in prefixes):
                    continue
                yield mod.finding(
                    self.name, self.slug, node,
                    f"client requests route {route!r} but no handler "
                    f"serves it (served routes: {known}) — the request "
                    "can only 404")
            for key, mod, node in facts.doc_reads:
                if facts.response_keys and key not in facts.response_keys:
                    yield mod.finding(
                        self.name, self.slug, node,
                        f"response-JSON key {key!r} is read from an "
                        "http-call result but no handler emits it — "
                        "this read can only ever see the default")
        groups = {}
        for val, mod, node in facts.headers:
            groups.setdefault(
                val.lower().replace("-", ""), []).append((val, mod, node))
        for norm in sorted(groups):
            items = groups[norm]
            spellings = sorted({v for v, _m, _n in items})
            if len(spellings) < 2:
                continue
            counts = {s: sum(1 for v, _m, _n in items if v == s)
                      for s in spellings}
            majority = max(spellings, key=lambda s: (counts[s], s))
            for val, mod, node in items:
                if val != majority:
                    yield mod.finding(
                        self.name, self.slug, node,
                        f"header {val!r} drifts from the majority "
                        f"spelling {majority!r}: HTTP matches headers "
                        "byte-wise, so the two never meet on the wire")


# ----------------------------------------------------------------------
# R11: metric-schema
# ----------------------------------------------------------------------

@register
class MetricSchemaRule(ProjectRule):
    name = "R11"
    slug = "metric-schema"
    description = (
        "metric series-schema drift: two emit sites of one series whose "
        "label-key sets don't nest (optional labels must ride the subset "
        "relation — disjoint keys split the series); a series referenced "
        "by an SloRule or series_map() that no creation site produces; "
        "and a verdict/outcome-labeled counter that only materializes "
        "when it first fires — pre-register every enum series at zero in "
        "__init__ (inc(0, ...)), or the SLO delta discipline ignores its "
        "first mid-storm appearance for a full window (the fleet prober's "
        "bug class)")

    def check_project(self, mods):
        facts = contract_facts(mods)
        by_name = {}
        for e in facts.emits:
            by_name.setdefault(e.name, []).append(e)
        # (a) non-nesting label sets across emit sites
        for name in sorted(by_name):
            sites = sorted(by_name[name],
                           key=lambda e: (e.mod.path, e.node.lineno))
            seen_pairs = set()
            for i, a in enumerate(sites):
                for b in sites[i + 1:]:
                    if a.labels <= b.labels or b.labels <= a.labels:
                        continue
                    pair = frozenset((a.labels, b.labels))
                    if pair in seen_pairs:
                        continue
                    seen_pairs.add(pair)
                    yield b.mod.finding(
                        self.name, self.slug, b.node,
                        f"metric {name!r} emitted here with labels "
                        f"{{{', '.join(sorted(b.labels))}}} but with "
                        f"{{{', '.join(sorted(a.labels))}}} at "
                        f"{a.mod.path}:{a.node.lineno} — label sets of "
                        "one series must nest (optional extras only), or "
                        "the two sites chart as unrelated series")
        # (b) referenced series nothing produces
        for rname, via, mod, node in facts.refs:
            if rname in facts.created:
                continue
            if any(rname.startswith(p)
                   for p in facts.dynamic_prefixes if p):
                continue
            yield mod.finding(
                self.name, self.slug, node,
                f"{via} references series {rname!r} but no "
                "counter/gauge/histogram creation site produces it — "
                "the rule/read can only ever see an empty series")
        # (c) fire-before-register enum counters
        zeroed = {e.name for e in facts.emits if e.zero}
        for name in sorted(by_name):
            if name in zeroed:
                continue
            kinds = facts.created.get(name, {}).get("kinds", set())
            if kinds and "counter" not in kinds:
                continue
            enum_sites = [e for e in by_name[name]
                          if e.method == "inc" and not e.zero
                          and e.labels & _ENUM_LABELS]
            if not enum_sites:
                continue
            first = min(enum_sites,
                        key=lambda e: (e.mod.path, e.node.lineno))
            keys = sorted(set().union(
                *(e.labels & _ENUM_LABELS for e in enum_sites)))
            yield first.mod.finding(
                self.name, self.slug, first.node,
                f"counter {name!r} carries the enum label(s) "
                f"{', '.join(keys)} but is never pre-registered: its "
                "series only exist once the outcome first happens, and "
                "the SLO delta discipline ignores a series' first "
                "appearance — inc(0, ...) every enum value at init "
                "(the fleet/prober.py idiom)")


# ----------------------------------------------------------------------
# R12: blocking-call timeout discipline
# ----------------------------------------------------------------------

@register
class BlockingTimeoutRule(ProjectRule):
    name = "R12"
    slug = "blocking-timeout"
    description = (
        "potentially-unbounded blocking call on the fleet/hostfleet/"
        "federate paths (module path containing 'fleet' or 'federate'): "
        "urlopen/create_connection without timeout=, .communicate() "
        "without timeout, zero-argument .join()/.get(), and .put() on a "
        "BOUNDED queue attr without timeout/block=False — the hang class "
        "the supervisors exist to bound; every wire wait must expire")

    def check_project(self, mods):
        for mod in mods:
            segs = mod.path.lower().split("/")
            if not any("fleet" in s or "federate" in s for s in segs):
                continue
            yield from self._check_mod(mod)

    def _bounded_queues(self, mod):
        """{(ClassDef, attr): bounded?} for queue ctor self-attrs (an
        UNBOUNDED queue.Queue() put can never block — exempt)."""
        out = {}
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Assign) \
                    or not isinstance(n.value, ast.Call):
                continue
            d = mod.dotted(n.value.func) or ""
            if not d.endswith(_QUEUE_CTOR_SUFFIXES):
                continue
            size = n.value.args[0] if n.value.args else _kw(n.value,
                                                           "maxsize")
            bounded = size is not None and not (
                isinstance(size, ast.Constant) and not size.value)
            cls = None
            for a in mod.ancestors(n):
                if isinstance(a, ast.ClassDef):
                    cls = a
                    break
            for t in n.targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" and cls is not None:
                    out[(cls, t.attr)] = bounded
        return out

    def _check_mod(self, mod):
        queues = self._bounded_queues(mod)
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            d = mod.dotted(n.func) or ""
            if d.endswith(".urlopen") or d == "urlopen":
                if _kw(n, "timeout") is None:
                    yield mod.finding(
                        self.name, self.slug, n,
                        "urlopen without timeout= on a fleet path: a "
                        "dead peer holds this thread forever — bound it")
                continue
            if d.endswith("create_connection"):
                if _kw(n, "timeout") is None and len(n.args) < 2:
                    yield mod.finding(
                        self.name, self.slug, n,
                        "socket.create_connection without a timeout on a "
                        "fleet path — a black-holed peer never refuses")
                continue
            if not isinstance(n.func, ast.Attribute):
                continue
            meth, recv = n.func.attr, n.func.value
            if meth == "communicate" and _kw(n, "timeout") is None:
                yield mod.finding(
                    self.name, self.slug, n,
                    ".communicate() without timeout on a fleet path: a "
                    "wedged child process wedges the supervisor with it")
            elif meth == "join" and not n.args \
                    and _kw(n, "timeout") is None \
                    and _const_str(recv) is None:
                yield mod.finding(
                    self.name, self.slug, n,
                    ".join() with no timeout on a fleet path: a stuck "
                    "thread/process makes shutdown unbounded")
            elif meth == "get" and not n.args \
                    and _kw(n, "timeout") is None \
                    and _kw(n, "block") is None:
                yield mod.finding(
                    self.name, self.slug, n,
                    "zero-argument .get() on a fleet path blocks without "
                    "bound (queue/future) — pass a timeout")
            elif meth == "put" and _kw(n, "timeout") is None:
                block = _kw(n, "block")
                if isinstance(block, ast.Constant) \
                        and block.value is False:
                    continue
                if len(n.args) >= 2:        # put(item, block[, timeout])
                    continue
                if isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self":
                    cls = None
                    for a in mod.ancestors(n):
                        if isinstance(a, ast.ClassDef):
                            cls = a
                            break
                    if cls is not None and queues.get((cls, recv.attr)):
                        yield mod.finding(
                            self.name, self.slug, n,
                            f"self.{recv.attr}.put() on a BOUNDED queue "
                            "without timeout on a fleet path: admission "
                            "backpressure becomes a producer hang")


# ----------------------------------------------------------------------
# R13: label-cardinality hygiene
# ----------------------------------------------------------------------

@register
class LabelCardinalityRule(ProjectRule):
    name = "R13"
    slug = "label-cardinality"
    description = (
        "a metric label fed from request-derived or unbounded strings "
        "(a raw request path, exception text) instead of a closed set: "
        "every distinct value mints a new series that lives forever in "
        "the registry and every scrape — bucket through a known set "
        "(`x if x in KNOWN else \"other\"`) or drop the label")

    @staticmethod
    def _guarded(expr):
        """The closed-set bucketing idiom: ``x if x in KNOWN else "other"``."""
        return (isinstance(expr, ast.IfExp)
                and isinstance(expr.test, ast.Compare)
                and any(isinstance(op, (ast.In, ast.NotIn))
                        for op in expr.test.ops))

    @staticmethod
    def _local_rhs(mod, site, name):
        """RHS of the nearest preceding same-function ``name = ...``."""
        fn = mod.enclosing_function(site)
        if fn is None:
            return None
        best = None
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and n.lineno < site.lineno \
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in n.targets):
                if best is None or n.lineno > best.lineno:
                    best = n
        return best.value if best is not None else None

    def _unbounded(self, mod, site, value):
        if self._guarded(value):
            return None
        expr = value
        if isinstance(value, ast.Name):
            rhs = self._local_rhs(mod, site, value.id)
            if rhs is not None:
                if self._guarded(rhs):
                    return None
                expr = rhs
        handlers = set()
        fn = mod.enclosing_function(site)
        for n in ast.walk(fn if fn is not None else mod.tree):
            if isinstance(n, ast.ExceptHandler) and n.name:
                handlers.add(n.name)
        for n in ast.walk(expr):
            if isinstance(n, ast.Attribute) and n.attr == "path":
                return "a raw request path"
            if isinstance(n, ast.Name):
                if n.id == "path":
                    return "a raw request path"
                if n.id in handlers:
                    return "exception text"
        return None

    def check_project(self, mods):
        facts = contract_facts(mods)
        for e in facts.emits:
            for key in sorted(e.values):
                why = self._unbounded(e.mod, e.node, e.values[key])
                if why:
                    yield e.mod.finding(
                        self.name, self.slug, e.node,
                        f"metric {e.name!r} label {key}= is fed from "
                        f"{why}: unbounded label values mint a new "
                        "series per distinct value — bucket through a "
                        "closed set (`x if x in KNOWN else \"other\"`) "
                        "or drop the label")


# ----------------------------------------------------------------------
# schema artifact (lint --emit-schema)
# ----------------------------------------------------------------------

def build_schema(mods):
    """The harvested wire+metric contract as one deterministic JSON-able
    dict — what ``lint --emit-schema`` writes to SCHEMA.json and renders
    as METRICS.md, and what the port's lint tests gate drift on."""
    facts = contract_facts(mods)
    routes = {}
    for path, match, method, mod, node in facts.routes:
        r = routes.setdefault(path, {"path": path, "match": match,
                                     "methods": set(), "sites": set()})
        r["methods"].add(method)
        r["sites"].add(f"{mod.path}:{node.lineno}")
        if match == "prefix":
            r["match"] = "prefix"
    wire = {
        "routes": [{"path": p, "match": routes[p]["match"],
                    "methods": sorted(routes[p]["methods"]),
                    "sites": sorted(routes[p]["sites"])}
                   for p in sorted(routes)],
        "headers": sorted({v for v, _m, _n in facts.headers}),
        "response_keys": sorted(facts.response_keys),
        "client_calls": sorted({(r, f"{m.path}:{n.lineno}")
                                for r, m, n in facts.client_routes}),
    }
    wire["client_calls"] = [{"route": r, "site": s}
                            for r, s in wire["client_calls"]]
    metrics = {}
    for name in sorted(facts.created):
        info = facts.created[name]
        emits = [e for e in facts.emits if e.name == name]
        all_labels = [set(e.labels) for e in emits]
        core = set.intersection(*all_labels) if all_labels else set()
        union = set.union(*all_labels) if all_labels else set()
        metrics[name] = {
            "type": sorted(info["kinds"])[0],
            "help": info["help"],
            "labels": sorted(core),
            "optional_labels": sorted(union - core),
            "dynamic_labels": any(e.dynamic for e in emits),
            "preregistered": any(e.zero for e in emits),
            "emit_sites": sorted({f"{e.mod.path}:{e.node.lineno}"
                                  for e in emits}),
            "creation_sites": sorted({f"{m.path}:{n.lineno}"
                                      for m, n in info["sites"]}),
        }
    return {"version": 1,
            "wire": wire,
            "metrics": metrics,
            "dynamic_metric_prefixes": sorted(facts.dynamic_prefixes)}
