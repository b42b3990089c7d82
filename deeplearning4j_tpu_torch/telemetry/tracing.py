"""Host-side span tracing: Chrome trace events + ``torch.profiler``
correlation.

The port of ``deeplearning4j_tpu/telemetry/tracing.py``. Reference analog:
libnd4j's OpProfiler gives the reference per-op host timing; on the card
the device timeline belongs to the CUDA profiler (``torch.profiler``), so
the missing piece is the HOST side — where did the step loop spend its
wall time when the device was idle (ETL stall? queue wait? averaging
round?). A ``span("etl")`` context manager records a Chrome trace-event
(the ``chrome://tracing`` / Perfetto JSON format) AND, while a
``torch.profiler`` session is collecting, forwards into
``torch.profiler.record_function``, so the host span shows up in the
profiler's trace as a range around the CUDA kernels it launched (where
the JAX module forwards into ``jax.profiler.TraceAnnotation``).

Near-zero overhead when disabled: ``span()`` returns one shared no-op
context manager — a function call and a branch, no allocation, no clock
read. A span is a host-clock region: it must never open inside a
CUDA-graph capture (it would run once, at capture); a caller puts it
around the ``replay()``.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch
from torch.profiler import record_function

from deeplearning4j_tpu_torch.telemetry import registry as _registry
from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx

_enabled = _registry.env_enabled()
_tracectx.set_enabled(_enabled)



def set_enabled(flag):
    global _enabled
    _enabled = bool(flag)
    # span tracing and causal trace contexts share ONE toggle — a span
    # recording while its trace silently drops (or vice versa) was the
    # same support trap as metrics-without-spans
    _tracectx.set_enabled(_enabled)


def enabled():
    return _enabled


def _profiler_active():
    """True while a ``torch.profiler`` (autograd profiler) session is
    collecting: entering ``record_function`` with none active is pure
    overhead, so spans forward only when there is a trace to land on."""
    return torch.autograd.profiler._is_profiler_enabled


class Tracer:
    """Bounded in-memory buffer of Chrome trace 'X' (complete) events.

    Spans from any thread land here; ``tid`` is the recording thread so the
    trace viewer renders the training loop, the ETL prefetch thread and the
    serving worker as separate, correlated rows. The buffer is bounded —
    an always-on tracer in a long-lived serving process must not grow
    without limit; overflow drops new events and counts them.
    """

    def __init__(self, max_events=200_000):
        self._lock = threading.Lock()
        self.max_events = int(max_events)
        self.events = []
        self.dropped = 0
        self.epoch = time.perf_counter()
        # cached: os.getpid() is a real syscall on hardened kernels
        # (several us — it would dominate the span record cost)
        self._pid = os.getpid()

    def now_us(self):
        return (time.perf_counter() - self.epoch) * 1e6

    def add_complete(self, name, ts_us, dur_us, args=None, tid=None):
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
              "pid": self._pid,
              "tid": threading.get_ident() if tid is None else tid}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(ev)

    def add_instant(self, name, args=None):
        """Point event ('i' phase) — markers like trace-start or hot-swap."""
        ev = {"name": name, "ph": "i", "s": "t", "ts": self.now_us(),
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(ev)

    def chrome_trace(self):
        """The trace as a chrome://tracing / Perfetto-loadable dict."""
        with self._lock:
            evs = list(self.events)
            dropped = self.dropped
        out = {"traceEvents": evs, "displayTimeUnit": "ms"}
        if dropped:
            out["droppedEventCount"] = dropped
        return out

    def export(self, path):
        """Write the Chrome trace JSON; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def clear(self):
        with self._lock:
            self.events = []
            self.dropped = 0
            self.epoch = time.perf_counter()


_tracer = Tracer()


def get_tracer():
    return _tracer


class _NullSpan:
    """Shared do-nothing span — the entire disabled-path cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "args", "_t0", "_ann", "_ctx", "_tok")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def set(self, **attrs):
        """Attach attributes discovered mid-span (batch size, hit/miss)."""
        self.args.update(attrs)
        return self

    def __enter__(self):
        self._ann = None
        if _profiler_active():
            self._ann = record_function(self.name)
            self._ann.__enter__()
        # causal linkage: with a TraceContext attached to this thread the
        # span becomes a child of the innermost enclosing span and pushes
        # itself as the new parent for anything nested (tracectx). No
        # context attached -> one contextvar read, nothing else.
        parent = _tracectx._cvar.get()
        if parent is not None:
            self._ctx = parent.child()
            self._tok = _tracectx._cvar.set(self._ctx)
        else:
            self._ctx = self._tok = None
        # start the host clock AFTER the range so the Chrome span nests
        # inside (not around) its profiler twin
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        args = self.args or None
        ctx = self._ctx
        if ctx is not None:
            _tracectx._cvar.reset(self._tok)
            span_args = dict(self.args) if self.args else {}
            if exc and exc[0] is not None:
                span_args["error"] = type(exc[0]).__name__
            ctx.trace.add(self.name, self._t0, t1, span_id=ctx.span_id,
                          parent_id=ctx.parent_id, **span_args)
            # the Chrome event carries the ids too, so a Perfetto row and
            # a /traces timeline cross-reference by trace_id
            args = dict(self.args) if self.args else {}
            args["trace_id"] = ctx.trace_id
            args["span_id"] = ctx.span_id
        tr = _tracer
        ts = (self._t0 - tr.epoch) * 1e6
        tr.add_complete(self.name, ts, (t1 - self._t0) * 1e6, args)
        return False


def span(name, **attrs):
    """Context manager timing a host-side region.

    When telemetry is enabled: records a Chrome trace event into the
    process tracer and brackets the region in
    ``torch.profiler.record_function`` (a range in the profiler's trace
    when a ``torch.profiler`` session is active). Disabled: a shared
    no-op. Nest freely — nesting is reconstructed from timestamps by the
    trace viewer.
    """
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, attrs)
