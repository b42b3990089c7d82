"""Causal trace contexts: Dapper-style request/step tracing across threads.

The port of ``deeplearning4j_tpu/telemetry/tracectx.py``, the same in
substance; the endpoints and CLI verbs it names are the JAX package's.

The ``span()`` tracer records flat per-thread timelines; the hot paths
cross threads — a serving request travels submit -> admission queue ->
drain thread -> device -> future resolve, a super-batch is assembled on
the AsyncDataSetIterator producer thread and consumed by the K-step
dispatch. Without causal linkage, a p99
spike in ``serving_latency_ms`` is a number with no story. This module is
the missing layer (the per-request timeline discipline of the TF serving
story, Abadi et al., 2016):

* :class:`TraceContext` — ``(trace, span_id)`` carried in a
  ``contextvars.ContextVar``. While a context is attached, every
  ``telemetry.span()`` on that thread records into the trace as a child
  span (in addition to its normal Chrome-trace event), parented under the
  innermost enclosing span.
* **Explicit thread handoff** — contextvars do not follow work across
  ``threading.Thread`` / queue boundaries, so the producing side calls
  ``token = ctx.handoff()`` and the consuming thread brackets its work in
  ``with tracectx.attach(token):`` — spans recorded on the drain thread,
  the prefetch producer, or a worker rollup then parent correctly under
  the originating request/step trace.
* **Slow-trace flight ring** — a bounded ring of the N slowest *complete*
  traces per root-span name (``get_ring()``), surfaced by the UIServer
  ``/traces`` endpoint and the ``traces`` CLI verb, and dumped into the
  flight-recorder payload on anomaly so a crash report carries the slow
  traces that preceded it.
* **Exemplars** — while a context is attached,
  ``MetricsRegistry`` histograms stamp the bucket each observation lands
  in with the current trace id (OpenMetrics exemplar syntax on
  ``/metrics``), so a p99 gauge links to a concrete trace.

Overhead discipline (asserted in tests): disabled, the step/submit paths
pay one module-attribute read and a branch — no contextvar is read or
written, no Trace is allocated, no clock runs. Enabled, all cross-thread
bookkeeping happens under each trace's own ``threading.Lock`` (a tracked
lock, so graftsan does not report the tracer's internals as unlocked
cross-thread RMW).

API sketch::

    ctx = tracectx.maybe_start("serving.request", model="m")  # None if off
    with tracectx.attach(ctx):          # same- or cross-thread
        with telemetry.span("queue_wait"):
            ...
    ctx.add_span("device_exec", t0, t1, bucket=8)  # measured window
    ctx.finish()                        # completes -> slow-trace ring
"""

from __future__ import annotations

import itertools
import os
import threading
import time

from deeplearning4j_tpu_torch.telemetry import registry as _registry

__all__ = ["TraceContext", "Trace", "SlowTraceRing", "start_trace",
           "maybe_start", "maybe_start_remote", "attach", "current",
           "current_trace_id", "get_ring", "set_enabled", "enabled",
           "open_trace_count", "reset_open_count"]

# the contextvar carrying the active TraceContext. Imported lazily by
# nothing and read only behind enabled-gates — the disabled step path
# never touches it (asserted in tests/test_tracectx.py).
import contextvars

_cvar = contextvars.ContextVar("dl4j_tpu_tracectx", default=None)

#: mirror of tracing._enabled, kept in sync by tracing.set_enabled (one
#: toggle: telemetry.enable() flips metrics, spans and trace contexts)
_enabled = False

_seq = itertools.count(1)
_open_lock = threading.Lock()
_open_traces = 0

ROOT_SPAN_ID = 1


def set_enabled(flag):
    global _enabled
    _enabled = bool(flag)


def enabled():
    return _enabled


#: cached — os.getpid() is a real syscall on hardened kernels (several
#: us), and the pid cannot change under one interpreter
_PID_HEX = f"{os.getpid():x}"


def _new_trace_id():
    """Process-unique, exemplar-friendly id (pid-prefixed counter — cheap,
    monotonic, and collision-free across the serving fleet's processes)."""
    return f"{_PID_HEX}-{next(_seq):x}"


#: bumped by reset_open_count(); a Trace closing across a reset must not
#: decrement the NEW generation's balance below zero
_open_gen = 0


def open_trace_count():
    """Traces started but not yet finished/abandoned — the dangling-state
    probe for the thread-exit tests (a producer dying mid-span must not
    leave its trace open forever)."""
    with _open_lock:
        return _open_traces


def reset_open_count():
    """Zero the open-trace balance (telemetry.reset): traces still open
    from before the reset become a new generation's strays — closing them
    later is a no-op on the counter instead of driving it negative."""
    global _open_traces, _open_gen
    with _open_lock:
        _open_traces = 0
        _open_gen += 1


def _note_open():
    global _open_traces
    with _open_lock:
        _open_traces += 1
        return _open_gen


def _note_close(gen):
    global _open_traces
    with _open_lock:
        if gen == _open_gen:
            _open_traces -= 1


class Trace:
    """Accumulator for one causal trace: the root span plus every
    descendant recorded from any thread. All mutation happens under
    ``self._lock`` (a real ``threading.Lock`` — a *tracked* lock under
    graftsan, so the tracer's own bookkeeping never reads as unlocked
    cross-thread RMW). Deliberately not ``__slots__``-ed: instances exist
    only while tracing is on, and graftsan's ``watch_rmw`` needs the
    mutable layout."""

    def __init__(self, name, args=None, trace_id=None):
        self._lock = threading.Lock()
        self.name = name
        # a remote-parented trace ADOPTS the originating process's id (the
        # fleet worker's spans must land in the ROUTER's trace, matched by
        # id when the response carries them back over the wire)
        self.trace_id = _new_trace_id() if trace_id is None \
            else str(trace_id)
        self.args = dict(args) if args else {}
        self.t0 = time.perf_counter()
        self.wall_t0 = time.time()
        self.spans = []
        self.finished = False
        self.status = None
        self.duration_s = None
        self._nspan = ROOT_SPAN_ID
        self.thread = threading.current_thread().name
        self._gen = _note_open()

    def next_span_id(self):
        with self._lock:
            self._nspan += 1
            return self._nspan

    def add(self, name, t0, t1, span_id=None, parent_id=ROOT_SPAN_ID,
            **args):
        """Record one completed span window (``t0``/``t1`` are
        ``perf_counter`` readings; stored relative to the trace start)."""
        if span_id is None:
            span_id = self.next_span_id()
        doc = {"name": name, "span_id": span_id, "parent_id": parent_id,
               "t0_s": round(t0 - self.t0, 9),
               "dur_s": round(t1 - t0, 9),
               "thread": threading.current_thread().name}
        if args:
            doc["args"] = args
        with self._lock:
            self.spans.append(doc)
        return doc

    def graft(self, remote_doc, parent_id, offset_s=0.0, instance=None):
        """Splice another PROCESS's trace doc into this trace, parented
        under ``parent_id`` (the cross-wire merge: the fleet worker
        returns its span timings in the /submit response and the router
        grafts them under that attempt's span, so ONE trace spans
        admission→dispatch→worker-device→resolve).

        Every remote span gets a fresh span id from this trace — remote
        processes allocate their own 1..N sequence, which would collide —
        with internal parent links preserved; the remote root re-parents
        under ``parent_id``. Timestamps re-anchor through the remote
        doc's ``t0_unix`` wall clock (minus the estimated inter-process
        clock ``offset_s``); a doc without the anchor keeps its own
        relative times. Returns the remote root's new span id (None when
        the doc carries no spans)."""
        spans = [s for s in (remote_doc or {}).get("spans") or ()
                 if isinstance(s, dict)]
        if not spans:
            return None
        base_unix = remote_doc.get("t0_unix")
        idmap = {s.get("span_id"): self.next_span_id() for s in spans}
        root_new = None
        grafted = []
        for s in spans:
            new = dict(s)
            new["span_id"] = idmap[s.get("span_id")]
            pid = s.get("parent_id")
            if pid in idmap:
                new["parent_id"] = idmap[pid]
            else:
                new["parent_id"] = parent_id
                if root_new is None:
                    root_new = new["span_id"]
                args = dict(new.get("args") or {})
                if instance is not None:
                    args["instance"] = instance
                args.setdefault("remote_trace", remote_doc.get("name"))
                new["args"] = args
            if base_unix is not None and s.get("t0_s") is not None:
                # remote-relative -> wall -> local-relative (offset_s is
                # remote_clock - local_clock, so subtract it)
                wall = base_unix + float(s["t0_s"]) - float(offset_s)
                new["t0_s"] = round(wall - self.wall_t0, 9)
            grafted.append(new)
        with self._lock:
            self.spans.extend(grafted)
        return root_new

    def _close(self, status):
        """Mark finished (idempotent); returns True on the first close."""
        with self._lock:
            if self.finished:
                return False
            self.finished = True
            self.status = status
            self.duration_s = time.perf_counter() - self.t0
        _note_close(self._gen)
        return True

    def finish(self, status="ok"):
        """Complete the trace: stamp the root span, compute the end-to-end
        duration and offer the trace to the slow-trace ring. Idempotent —
        racing finishers (worker resolve vs. shutdown drain) are safe."""
        if not self._close(status):
            return False
        get_ring().offer(self.to_doc())
        return True

    def abandon(self):
        """Close without ringing: the trace never completed its causal
        story (producer died mid-span, queued batch drained on close) and
        must not masquerade as a measured slow trace."""
        return self._close("abandoned")

    def to_doc(self):
        """JSON-ready document (the /traces and flight-dump shape)."""
        with self._lock:
            spans = [dict(s) for s in self.spans]
            dur = self.duration_s
            status = self.status
        root = {"name": self.name, "span_id": ROOT_SPAN_ID,
                "parent_id": None, "t0_s": 0.0,
                "dur_s": None if dur is None else round(dur, 9),
                "thread": self.thread}
        if self.args:
            root["args"] = dict(self.args)
        return {"trace_id": self.trace_id, "name": self.name,
                "t0_unix": self.wall_t0, "status": status,
                "duration_s": None if dur is None else round(dur, 9),
                "spans": [root] + spans}


class TraceContext:
    """One position in a trace: ``(trace, span_id, parent_id)``.
    Immutable — child contexts are fresh objects, so a handoff token can
    be attached on any number of threads concurrently."""

    __slots__ = ("trace", "span_id", "parent_id")

    def __init__(self, trace, span_id, parent_id=None):
        self.trace = trace
        self.span_id = span_id
        self.parent_id = parent_id

    @property
    def trace_id(self):
        return self.trace.trace_id

    def child(self):
        """A context one level deeper (a freshly allocated span id
        parented under this one) — what ``span()`` pushes on entry."""
        return TraceContext(self.trace, self.trace.next_span_id(),
                            self.span_id)

    def handoff(self):
        """Token to carry across a thread boundary (queue item, submit
        tuple). Contexts are immutable, so the token IS a context — the
        method exists to make the crossing explicit and greppable."""
        return TraceContext(self.trace, self.span_id, self.parent_id)

    def add_span(self, name, t0, t1, **args):
        """Record a measured window (e.g. queue-wait computed from a
        submit timestamp) as a child of this context's span."""
        return self.trace.add(name, t0, t1, parent_id=self.span_id, **args)

    def finish(self, status="ok"):
        return self.trace.finish(status)

    def abandon(self):
        return self.trace.abandon()


class _Attach:
    """Context manager binding a TraceContext (or None — no-op) to the
    current thread's contextvar for the duration of a block."""

    __slots__ = ("_ctx", "_tok")

    def __init__(self, ctx):
        self._ctx = ctx
        self._tok = None

    def __enter__(self):
        if self._ctx is not None:
            self._tok = _cvar.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._tok is not None:
            _cvar.reset(self._tok)
            self._tok = None
        return False


def attach(ctx):
    """``with tracectx.attach(token):`` — receive a handoff on this
    thread. ``attach(None)`` is a no-op block, so call sites need no
    enabled-branching of their own."""
    return _Attach(ctx)


def start_trace(name, **args):
    """Open a new root trace; returns its root :class:`TraceContext`.
    The caller owns completion: ``ctx.finish()`` when the causal story
    ends (or ``ctx.abandon()`` if it never will)."""
    return TraceContext(Trace(name, args), ROOT_SPAN_ID)


def maybe_start(name, **args):
    """``start_trace`` gated on the tracing toggle: the one call hot
    paths make. Disabled cost: a module-attribute read and a branch."""
    if not _enabled:
        return None
    return start_trace(name, **args)


def maybe_start_remote(name, trace_id, parent_span_id=None, **args):
    """Open a trace that ADOPTS a remote caller's trace id (the wire
    side of cross-process tracing: the fleet worker roots its local
    spans under the router's identity, ships ``trace.to_doc()`` back in
    the response, and the router grafts it under the dispatching attempt
    span). ``parent_span_id`` — the caller-side span the remote work
    hangs under — is recorded on the trace for the merge; gated like
    :func:`maybe_start`."""
    if not _enabled or not trace_id:
        return None
    if parent_span_id is not None:
        args = dict(args, remote_parent=parent_span_id)
    return TraceContext(Trace(name, args, trace_id=trace_id),
                        ROOT_SPAN_ID)


def current():
    """The TraceContext attached to this thread, or None."""
    if not _enabled:
        return None
    return _cvar.get()


def current_trace_id():
    """Trace id of the attached context (exemplar source), or None."""
    if not _enabled:
        return None
    ctx = _cvar.get()
    return None if ctx is None else ctx.trace.trace_id


class SlowTraceRing:
    """The N slowest complete traces per root-span name.

    ``offer`` keeps a ring sorted slowest-first; when full, a new trace
    must beat the fastest kept trace to enter (the fastest is evicted).
    Bounded per name AND in names so an always-on serving process cannot
    grow it without limit."""

    def __init__(self, per_name=8, max_names=64):
        self._lock = threading.Lock()
        self.per_name = int(per_name)
        self.max_names = int(max_names)
        self._rings = {}  # root name -> [trace docs], slowest first

    def offer(self, doc):
        """Admit ``doc`` if it is among the slowest seen for its root
        name; returns True when kept."""
        dur = doc.get("duration_s") or 0.0
        name = doc.get("name")
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                if len(self._rings) >= self.max_names:
                    return False
                ring = self._rings[name] = []
            if len(ring) >= self.per_name:
                if dur <= (ring[-1].get("duration_s") or 0.0):
                    return False
                ring.pop()  # evict the fastest kept trace
            i = 0
            while i < len(ring) and dur <= (ring[i].get("duration_s")
                                            or 0.0):
                i += 1
            ring.insert(i, doc)
            return True

    def snapshot(self, name=None):
        """{root name: [trace docs slowest-first]} (one name if given)."""
        with self._lock:
            if name is not None:
                ring = self._rings.get(name, [])
                return {name: [dict(d) for d in ring]} if ring else {}
            return {n: [dict(d) for d in ring]
                    for n, ring in self._rings.items()}

    def find(self, trace_id):
        """The trace doc with this id, or None."""
        with self._lock:
            for ring in self._rings.values():
                for d in ring:
                    if d.get("trace_id") == trace_id:
                        return dict(d)
        return None

    def clear(self):
        with self._lock:
            self._rings = {}


_ring = SlowTraceRing()


def get_ring():
    return _ring


# histograms stamp exemplars from the attached context (registry cannot
# import this module — it is imported BY it — so the source is injected)
_registry.set_exemplar_source(current_trace_id)
