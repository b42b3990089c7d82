"""graftsan: runtime concurrency sanitizer for the port's threaded subsystems.

Static R9 sees the lock-order graph the CODE declares; graftsan records
the orders that actually HAPPEN. Enabled (in the port's tests through a
fixture of their own, and in ``chip_smoke.py``'s serve phase on the
card), it:

* wraps ``threading.Lock``/``threading.RLock`` allocations made from
  scoped modules (``deeplearning4j_tpu_torch.*`` by default) in a
  recording proxy: every acquisition pushes onto a per-thread held stack,
  every "acquire B while holding A" adds an ordered edge keyed by the
  locks' ALLOCATION SITES (``file:line`` — the same identity static R9
  derives from the ``self._lock = threading.Lock()`` assignment, which is
  what lets ``lint --san-report`` merge the two graphs exactly), and an
  edge that closes a cycle in the observed graph is reported as a **lock
  inversion** the moment it happens — no deadlock needed;
* snapshots ``threading.enumerate()`` at install and reports **leaked
  non-daemon threads** still alive at check time;
* tracks every
  :class:`~deeplearning4j_tpu_torch.serving.engine.InferenceFuture`
  created while enabled (weakly) and reports **never-resolved futures**
  still referenced but not ``done()`` at check time;
* offers :meth:`Sanitizer.watch_rmw` to instrument chosen attributes of
  an object and report **cross-thread read-modify-write without any
  tracked lock held** — the lost-update class R6 can only flag inside
  lock-bearing classes.

Pure stdlib; never imports torch (the serving-future hook engages only
when ``deeplearning4j_tpu_torch.serving.engine`` is ALREADY imported, so
the sanitizer itself stays importable anywhere, without an accelerator
stack).

Usage::

    from deeplearning4j_tpu_torch.analysis.sanitizer import Sanitizer
    with Sanitizer() as san:
        ... exercise threaded code ...
    assert san.findings == []          # or: san.check() -> list
    san.dump("graftsan.json")          # observed orders for --san-report
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import threading
import weakref

from deeplearning4j_tpu_torch.analysis.dataflow import reaches

#: the real factories, captured at import time (install() swaps the
#: ``threading`` module attributes; these never change)
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


@dataclasses.dataclass(frozen=True)
class SanFinding:
    kind: str      # lock-inversion | leaked-thread | unresolved-future
    #                | unlocked-rmw
    message: str
    site: str = ""

    def human(self):
        tail = f" [{self.site}]" if self.site else ""
        return f"graftsan[{self.kind}] {self.message}{tail}"


class _LockProxy:
    """Recording wrapper around one real lock. Context-manager and
    acquire/release compatible; bookkeeping is per-thread (no contention
    added) and switches off when the owning sanitizer uninstalls."""

    __slots__ = ("_san", "_real", "site", "kind", "_xrel", "__weakref__")

    def __init__(self, san, real, site, kind):
        self._san = san
        self._real = real
        self.site = site
        self.kind = kind
        self._xrel = 0          # handoff releases pending owner-side purge

    def acquire(self, blocking=True, timeout=-1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            san = self._san
            if san is not None and san.enabled:
                san._note_acquire(self)
        return ok

    def release(self):
        san = self._san
        if san is not None and san.enabled:
            san._note_release(self)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def __repr__(self):
        return f"<graftsan {self.kind} proxy @ {self.site}>"


class Sanitizer:
    """One enable/record/check cycle. Re-entrant installs are refused —
    one sanitizer owns the ``threading`` patch at a time."""

    _active = None

    def __init__(self, scope_prefixes=("deeplearning4j_tpu_torch",)):
        self.scope = tuple(scope_prefixes)
        self.enabled = False
        self._state = _REAL_LOCK()          # guards the graphs below
        self._tls = threading.local()
        self._edges = {}                    # (site_a, site_b) -> count
        self._graph = {}                    # site_a -> set[site_b]
        self._lock_kinds = {}               # site -> kind
        self._inversions = []
        self._rmw = {}                      # (obj_id, attr) -> state
        self._rmw_classes = {}
        self._futures = []                  # (weakref, site)
        self._thread_snapshot = frozenset()
        self._saved = None
        self._future_cls = None
        self._saved_future_init = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def install(self):
        if Sanitizer._active is not None:
            raise RuntimeError("a graftsan Sanitizer is already installed")
        Sanitizer._active = self
        self.enabled = True
        self._thread_snapshot = frozenset(threading.enumerate())
        self._saved = (threading.Lock, threading.RLock)
        threading.Lock = self._factory("Lock", _REAL_LOCK)
        threading.RLock = self._factory("RLock", _REAL_RLOCK)
        self._hook_futures()
        return self

    def uninstall(self):
        if Sanitizer._active is self:
            Sanitizer._active = None
        self.enabled = False
        if self._saved is not None:
            threading.Lock, threading.RLock = self._saved
            self._saved = None
        if self._future_cls is not None \
                and self._saved_future_init is not None:
            self._future_cls.__init__ = self._saved_future_init
            self._future_cls = None
            self._saved_future_init = None

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _factory(self, kind, real_ctor):
        san = self

        def make():
            real = real_ctor()
            if not san.enabled:
                return real
            fr = sys._getframe(1)
            modname = fr.f_globals.get("__name__", "") or ""
            if not modname.startswith(san.scope):
                return real
            site = f"{fr.f_code.co_filename}:{fr.f_lineno}"
            with san._state:
                san._lock_kinds[site] = kind
            return _LockProxy(san, real, site, kind)

        make.__name__ = kind
        return make

    def _hook_futures(self):
        """Track InferenceFuture creations — only when the serving module
        is already imported (importing it here would pull in torch)."""
        eng = sys.modules.get("deeplearning4j_tpu_torch.serving.engine")
        if eng is None:
            return
        cls = getattr(eng, "InferenceFuture", None)
        if cls is None:
            return
        san = self
        orig = cls.__init__

        def init(fut, *a, **k):
            orig(fut, *a, **k)
            if san.enabled:
                fr = sys._getframe(1)
                site = f"{fr.f_code.co_filename}:{fr.f_lineno}"
                try:
                    ref = weakref.ref(fut)
                except TypeError:
                    return
                with san._state:
                    san._futures.append((ref, site))

        self._future_cls = cls
        self._saved_future_init = orig
        cls.__init__ = init

    # ------------------------------------------------------------------
    # lock-order recording
    # ------------------------------------------------------------------

    def _held(self):
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def _purge(self, held):
        """Apply handoff releases other threads recorded against locks on
        THIS thread's stack. Only the owning thread mutates its own list,
        so there is no cross-thread list race."""
        i = 0
        while i < len(held):
            p = held[i]
            if p._xrel:
                with self._state:
                    if p._xrel:
                        p._xrel -= 1
                        del held[i]
                        continue
            i += 1

    def _note_acquire(self, proxy):
        held = self._held()
        self._purge(held)
        site = proxy.site
        if any(p is proxy or p.site == site for p in held):
            held.append(proxy)      # reentrant RLock: no new edge
            return
        if held:
            top = held[-1].site
            if top != site:
                self._add_edge(top, site)
        held.append(proxy)

    def _note_release(self, proxy):
        held = getattr(self._tls, "held", None)
        if held:
            self._purge(held)
            for i in range(len(held) - 1, -1, -1):
                if held[i] is proxy:
                    del held[i]
                    return
        # released by a thread that never acquired it (threading.Lock
        # permits the handoff pattern): record a pending release the
        # ACQUIRER purges on its next bookkeeping touch, else its stack
        # keeps a phantom entry that turns later acquisitions into edges
        with self._state:
            proxy._xrel += 1

    def _add_edge(self, a, b):
        with self._state:
            first = (a, b) not in self._edges
            self._edges[(a, b)] = self._edges.get((a, b), 0) + 1
            if not first:
                return
            # does b already reach a? then this edge closes a cycle —
            # report the inversion NOW, with both orders named
            closes = reaches(self._graph, b, a)
            self._graph.setdefault(a, set()).add(b)
            if closes:
                self._inversions.append(SanFinding(
                    "lock-inversion",
                    f"lock at {a} acquired before lock at {b} on "
                    f"{threading.current_thread().name}, but the opposite "
                    "order was observed on another path — deadlock "
                    "waiting for the right interleaving",
                    site=f"{a} <-> {b}"))

    # ------------------------------------------------------------------
    # cross-thread RMW watching
    # ------------------------------------------------------------------

    def watch_rmw(self, obj, *attrs):
        """Instrument ``obj`` so writes to ``attrs`` record the writing
        thread and whether any tracked lock was held; ``check()`` reports
        attributes written by 2+ threads with at least one lock-free
        write. Returns True when instrumentation took (objects whose
        layout forbids ``__class__`` assignment return False)."""
        san = self
        cls = type(obj)
        key = (cls, tuple(sorted(attrs)))
        sub = self._rmw_classes.get(key)
        if sub is None:
            watched = frozenset(attrs)

            def __setattr__(s, name, value):
                if name in watched and san.enabled:
                    san._note_write(s, name)
                cls.__setattr__(s, name, value)

            sub = type(f"_GraftsanWatched_{cls.__name__}", (cls,),
                       {"__setattr__": __setattr__,
                        "_graftsan_watched_cls": cls.__name__})
            self._rmw_classes[key] = sub
        try:
            obj.__class__ = sub
        except TypeError:
            return False
        return True

    def _note_write(self, obj, attr):
        held = bool(getattr(self._tls, "held", None))
        # the thread OBJECT, not get_ident(): idents are reused the moment
        # a thread exits, which would fold two short-lived writers into one
        tid = threading.current_thread()
        with self._state:
            st = self._rmw.setdefault(
                (id(obj), attr),
                # "obj" pins the instance so its id cannot be reused for
                # a different watched object while this state lives
                {"threads": set(), "unlocked": False, "obj": obj,
                 "cls": getattr(obj, "_graftsan_watched_cls",
                                type(obj).__name__), "attr": attr})
            st["threads"].add(tid)
            st["unlocked"] = st["unlocked"] or not held

    # ------------------------------------------------------------------
    # findings / report
    # ------------------------------------------------------------------

    def check(self):
        """All findings accumulated so far plus end-state sweeps (leaked
        non-daemon threads, unresolved still-referenced futures)."""
        gc.collect()
        out = list(self._inversions)
        for t in threading.enumerate():
            if t in self._thread_snapshot or not t.is_alive() or t.daemon:
                continue
            out.append(SanFinding(
                "leaked-thread",
                f"non-daemon thread {t.name!r} started during the "
                "sanitized span is still alive — join it or mark the "
                "join/daemon discipline at construction"))
        with self._state:
            futures = list(self._futures)
            rmw = list(self._rmw.values())
        for ref, site in futures:
            fut = ref()
            if fut is not None and not fut.done():
                out.append(SanFinding(
                    "unresolved-future",
                    "InferenceFuture created here was never resolved "
                    "(no result, no error): its waiters would block "
                    "until their own timeout", site=site))
        for st in rmw:
            if len(st["threads"]) > 1 and st["unlocked"]:
                out.append(SanFinding(
                    "unlocked-rmw",
                    f"{st['cls']}.{st['attr']} written by "
                    f"{len(st['threads'])} threads with at least one "
                    "write outside any tracked lock — lost updates"))
        return out

    @property
    def findings(self):
        return self.check()

    def report(self, findings=None):
        """Machine-readable observed state (the --san-report input).
        Pass already-computed ``check()`` findings to skip a second
        gc.collect + sweep."""
        if findings is None:
            findings = self.check()
        with self._state:
            edges = [{"from": a, "to": b, "count": c}
                     for (a, b), c in sorted(self._edges.items())]
            kinds = dict(self._lock_kinds)
        return {
            "version": 1,
            "lock_order_edges": edges,
            "locks": kinds,
            "findings": [dataclasses.asdict(f) for f in findings],
        }

    def dump(self, path):
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.report(), fh, indent=1)
            fh.write("\n")
        return path


def merge_report(total, report):
    """Accumulate one sanitizer report into a running total (a session's
    report over several sanitized spans)."""
    total.setdefault("version", 1)
    total.setdefault("locks", {}).update(report.get("locks", {}))
    edges = total.setdefault("lock_order_edges", [])
    index = {(e["from"], e["to"]): e for e in edges}
    for e in report.get("lock_order_edges", ()):
        k = (e["from"], e["to"])
        if k in index:
            index[k]["count"] += e["count"]
        else:
            edges.append(dict(e))
            index[k] = edges[-1]
    total.setdefault("findings", []).extend(report.get("findings", ()))
    return total
