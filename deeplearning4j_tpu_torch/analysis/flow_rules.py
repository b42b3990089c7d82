"""graftlint dataflow rules R7-R9: interprocedural hazards of the port.

The JAX package's R7 (use-after-donate) and R8 (sharding axes) have no
direct PyTorch form: nothing is donated, and a collective takes a process
group, not an axis name. Their port forms check the same bug classes in
the port's own idioms; R9 carries over as written. All three run as
:class:`~.core.ProjectRule`s over the whole module set, sharing one
:class:`~.dataflow.ProjectFacts` build:

* ``R7 stale-static-output`` — a CUDA graph's static output (a value
  bound inside its capture and kept on an object: ``nn/fused.py``'s
  ``sig.out``, ``text/word2vec.py _ChunkSteps.out``) that escapes a
  ``replay()`` without ``.clone()`` — returned, stored or appended — or
  an alias of it read after the NEXT replay: every replay overwrites the
  static buffers in place, so a kept reference silently changes value
  (the JAX rule's "buffer reused after the call took it" class).
* ``R8 group-discipline`` — a collective (``torch.distributed`` or the
  port's ``utils/collectives.py`` / ``parallel/sequence.py``) whose group
  is not one the code opened (``dist.new_group``, ``Mesh.group(axis)``,
  a ``BatchGroup``/``ModelGroup``'s ``.group``, the default group, a
  parameter): a literal in a group's place is the JAX idiom of naming an
  axis, which torch.distributed rejects at run time; and a mesh axis
  name (``mesh.group("x")``, ``mesh.coords["x"]``) outside the project's
  ``AXES`` universe.
* ``R9 lock-order`` — cycles in the static lock-acquisition graph
  (including a non-reentrant ``threading.Lock`` re-acquired via a
  callee: instant self-deadlock) and potentially-unbounded blocking ops
  (queue ``get``/``put`` with no timeout, bare ``join()``/``wait()``)
  while holding a lock.

Pure stdlib, heuristic by design — same stance as rules.py.
"""

from __future__ import annotations

import ast

from deeplearning4j_tpu_torch.analysis.core import (LintModule, ProjectRule,
                                                    register)
from deeplearning4j_tpu_torch.analysis.dataflow import chain_of, project_facts

#: methods whose result shares its receiver's storage (a view, not a copy)
_ALIASING_METHODS = {"detach", "view", "view_as", "reshape", "flatten",
                     "squeeze", "unsqueeze", "permute", "transpose", "t",
                     "narrow", "select", "expand", "expand_as",
                     "contiguous", "to", "unbind", "split", "chunk",
                     "requires_grad_", "as_strided", "unflatten"}
#: container methods that keep their argument past the call
_STORING_METHODS = {"append", "extend", "insert", "add", "appendleft",
                    "put", "put_nowait", "setdefault"}


# ----------------------------------------------------------------------
# R7: a captured graph's static output kept across replays
# ----------------------------------------------------------------------

@register
class StaleStaticOutputRule(ProjectRule):
    name = "R7"
    slug = "stale-static-output"
    description = (
        "a CUDA graph's static output (bound inside its capture, kept on "
        "an object) escapes a replay() without .clone() — returned, "
        "stored or appended — or an alias of it is read after the next "
        "replay(): every replay overwrites the static buffers in place, "
        "so a kept reference silently changes value — clone after the "
        "replay (nn/fused.py, text/word2vec.py _ChunkSteps)")

    def check_project(self, mods):
        facts = project_facts(mods)
        for mod in mods:
            statics = facts.static_attrs.get(mod)
            if not statics:
                continue
            for info in (i for i in facts.fns.values() if i.mod is mod):
                yield from self._check_fn(mod, info.node, statics)

    @staticmethod
    def _own(mod, fn):
        return [n for n in ast.walk(fn) if mod.enclosing_function(n) is fn]

    def _check_fn(self, mod: LintModule, fn, statics):
        own = self._own(mod, fn)
        replays = sorted(n.lineno for n in own
                         if isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Attribute)
                         and n.func.attr == "replay" and not n.args)
        if not replays:
            return
        first = replays[0]
        aliases = {}          # name -> line bound (after a replay)

        def is_alias(e):
            """``e`` shares a static buffer's storage."""
            if isinstance(e, ast.Attribute) and e.attr in statics \
                    and chain_of(e) is not None:
                return True
            if isinstance(e, ast.Name) and e.id in aliases:
                return True
            if isinstance(e, ast.Subscript):
                return is_alias(e.value)
            if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                    and e.func.attr in _ALIASING_METHODS:
                return is_alias(e.func.value)
            if isinstance(e, ast.Starred):
                return is_alias(e.value)
            return False

        def escapes(e):
            """An aliasing expression inside ``e`` that ``e`` hands on
            as is (a container display's elements included)."""
            if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
                for x in e.elts:
                    hit = escapes(x)
                    if hit is not None:
                        return hit
                return None
            if isinstance(e, ast.Dict):
                for x in e.values:
                    hit = escapes(x)
                    if hit is not None:
                        return hit
                return None
            return e if is_alias(e) else None

        for node in sorted((n for n in own if isinstance(n, ast.stmt)),
                           key=lambda n: (n.lineno, n.col_offset)):
            if node.lineno <= first:
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    pairs = list(zip(t.elts, node.value.elts)) if (
                        isinstance(t, (ast.Tuple, ast.List))
                        and isinstance(node.value, (ast.Tuple, ast.List))
                        and len(t.elts) == len(node.value.elts)) \
                        else [(t, node.value)]
                    for tt, vv in pairs:
                        alias = is_alias(vv)
                        names = [e for e in ast.walk(tt)
                                 if isinstance(e, ast.Name)] \
                            if isinstance(tt, (ast.Tuple, ast.List)) \
                            else [tt]
                        for e in names:
                            if isinstance(e, ast.Name):
                                if alias:
                                    aliases[e.id] = node.lineno
                                else:
                                    aliases.pop(e.id, None)
                            elif alias and isinstance(
                                    e, (ast.Attribute, ast.Subscript)) \
                                    and not (isinstance(e, ast.Attribute)
                                             and e.attr in statics):
                                yield self._escape(mod, node, vv,
                                                   "stored on an object")
            elif isinstance(node, ast.Return) and node.value is not None:
                hit = escapes(node.value)
                if hit is not None:
                    yield self._escape(mod, node, hit, "returned")
            elif isinstance(node, ast.Expr) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Attribute) \
                    and node.value.func.attr in _STORING_METHODS:
                for a in node.value.args:
                    hit = escapes(a)
                    if hit is not None:
                        yield self._escape(mod, node, hit,
                                           "kept in a container")
                        break
        # an alias read after the NEXT replay sees the new values
        for name, bound in sorted(aliases.items()):
            later = [r for r in replays if r > bound]
            if not later:
                continue
            for n in own:
                if isinstance(n, ast.Name) and n.id == name \
                        and isinstance(n.ctx, ast.Load) \
                        and n.lineno > later[0]:
                    yield mod.finding(
                        self.name, self.slug, n,
                        f"{name!r} aliases a captured graph's static "
                        f"output (bound at line {bound}) and is read after "
                        f"the replay() at line {later[0]} overwrote it — "
                        ".clone() it when it is bound")
                    break

    def _escape(self, mod, node, expr, how):
        what = ast.unparse(expr) if hasattr(ast, "unparse") else "it"
        return mod.finding(
            self.name, self.slug, node,
            f"{what} is a captured graph's static output, {how} after "
            "replay() without .clone(): the next replay overwrites it in "
            "place — clone it first")


# ----------------------------------------------------------------------
# R8: collectives on groups nobody opened, mesh axes nobody declared
# ----------------------------------------------------------------------

@register
class GroupDisciplineRule(ProjectRule):
    name = "R8"
    slug = "group-discipline"
    description = (
        "a collective (torch.distributed or utils/collectives.py / "
        "parallel/sequence.py) on a group no dist.new_group, "
        "Mesh.group(axis), BatchGroup or ModelGroup opened — a literal in "
        "the group's place is the JAX idiom of naming an axis, which "
        "torch.distributed rejects at run time — or a mesh axis name "
        "(mesh.group/ranks/coords/shape) outside every AXES tuple in the "
        "project")

    def check_project(self, mods):
        facts = project_facts(mods)
        for mod in mods:
            yield from self._collectives(facts, mod)
            yield from self._axes(facts, mod)

    def _collectives(self, facts, mod: LintModule):
        for call in (n for n in ast.walk(mod.tree)
                     if isinstance(n, ast.Call)):
            got = facts.collective_group_arg(mod, call)
            if got is None:
                continue
            name, expr = got
            origin = facts.group_origin(mod, call, expr)
            if origin in ("opened", "caller", "unknown"):
                continue
            yield mod.finding(
                self.name, self.slug, call,
                f"{name}(...) runs on {origin}, not on a process group "
                "the code opened (dist.new_group, mesh.group(axis), a "
                "BatchGroup/ModelGroup's .group): torch.distributed "
                "rejects it at run time")

    def _axes(self, facts, mod: LintModule):
        universe = facts.axis_universe
        if not universe:
            return
        known = ", ".join(sorted(universe))
        def of_mesh(e):
            # the receiver is a mesh by name (mesh, self.mesh, self._mesh)
            c = chain_of(e) or ""
            return "mesh" in c.rsplit(".", 1)[-1].lower()

        for n in ast.walk(mod.tree):
            axis = None
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("group", "ranks") \
                    and of_mesh(n.func.value) \
                    and len(n.args) == 1 and not n.keywords \
                    and isinstance(n.args[0], ast.Constant) \
                    and isinstance(n.args[0].value, str):
                axis = n.args[0].value
            elif isinstance(n, ast.Subscript) \
                    and isinstance(n.value, ast.Attribute) \
                    and n.value.attr in ("coords", "shape") \
                    and of_mesh(n.value.value) \
                    and isinstance(n.slice, ast.Constant) \
                    and isinstance(n.slice.value, str):
                axis = n.slice.value
            if axis is None or axis in universe:
                continue
            yield mod.finding(
                self.name, self.slug, n,
                f"mesh axis {axis!r} matches no AXES tuple declared in the "
                f"project (known: {known}): the lookup raises KeyError at "
                "run time")


# ----------------------------------------------------------------------
# R9: lock-order discipline
# ----------------------------------------------------------------------

@register
class LockOrderRule(ProjectRule):
    name = "R9"
    slug = "lock-order"
    description = (
        "static lock-graph hazards across the threaded subsystems: "
        "lock-acquisition cycles (A->B here, B->A elsewhere — a deadlock "
        "waiting for the right interleaving; includes a non-reentrant "
        "Lock re-acquired via a callee) and potentially-unbounded "
        "blocking calls (queue get/put with no timeout, bare "
        "join()/wait()) made while holding a lock")

    def check_project(self, mods):
        facts = project_facts(mods)
        cycles = facts.lock_cycles()
        cyc_members = {}
        for cyc in cycles:
            for lid in cyc:
                cyc_members.setdefault(lid, cyc)
        reported = set()
        for src, dst, mod, node, via in facts.lock_edges:
            cyc = None
            if src == dst and (src,) in set(cycles):
                cyc = (src,)
            elif src in cyc_members and dst in cyc_members.get(src, ()):
                cyc = cyc_members[src]
            if cyc is None:
                continue
            key = (cyc, mod.path, node.lineno)
            if key in reported:
                continue
            reported.add(key)
            if len(cyc) == 1:
                yield mod.finding(
                    self.name, self.slug, node,
                    f"non-reentrant lock {src} re-acquired while already "
                    f"held ({via}): self-deadlock")
            else:
                yield mod.finding(
                    self.name, self.slug, node,
                    f"lock-order cycle {' -> '.join(cyc + (cyc[0],))}: "
                    f"{src} is held while acquiring {dst} here ({via}), "
                    "and the opposite order exists elsewhere — a "
                    "deadlock waiting for the right thread interleaving")
        for lock_id, desc, mod, node in facts.blocking_under_lock:
            yield mod.finding(
                self.name, self.slug, node,
                f"{desc} while holding {lock_id}: every other thread "
                "needing that lock stalls behind an unbounded wait — "
                "drop the lock first, or bound the wait with a timeout")
