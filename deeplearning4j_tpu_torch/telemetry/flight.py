"""Crash flight recorder: a bounded ring of recent step records.

The port of ``deeplearning4j_tpu/telemetry/flight.py`` (the same dump
format: the JAX package's ``flightrec`` verb reads a dump of either).

When a long run dies — NaN, OOM, an exception three layers down, or the
scheduler's SIGTERM — the question is always "what were the last N steps
doing?". Metrics answer in aggregates; the flight recorder answers in
records: a fixed-size ring buffer of per-step dicts (step index, score,
step/ETL time, grad norm, memory, health flags) that costs one deque append
per step while healthy and dumps itself to JSON the moment something goes
wrong:

* **numerics** — the health watchdog (telemetry/health.py) dumps on its
  first anomaly, whatever the policy;
* **exception** — the fit loops call ``crash_dump(exc)`` on the way out of
  an uncaught error (NumericsError is not re-dumped: it carries the path of
  the dump the watchdog already wrote);
* **SIGTERM** — ``install_signal_handler()`` (opt-in: signals are
  process-global and main-thread-only) dumps before chaining to the
  previous handler, so preemption leaves a postmortem behind.

A dump is one JSON document. Dump location: ``$DL4J_TPU_FLIGHT_DIR`` (created if needed) or the system
temp dir.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import tempfile
import threading
import time

from deeplearning4j_tpu_torch.telemetry import registry as _registry

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Ring buffer of step records + JSON dump-on-failure."""

    def __init__(self, capacity=DEFAULT_CAPACITY):
        self._lock = threading.RLock()
        self.capacity = int(capacity)
        self._records = collections.deque(maxlen=self.capacity)
        self.dumps = []  # paths written by this process

    @property
    def armed(self):
        """Recording/dumping is worthwhile: telemetry or the watchdog is on.
        Computed, not stored — toggling either subsystem needs no recorder
        bookkeeping."""
        if _registry.get_registry().enabled:
            return True
        from deeplearning4j_tpu_torch.telemetry import health as _health
        return _health.get_monitor().active

    def note(self, **fields):
        """Append one step record (the ring drops the oldest beyond
        capacity). One dict + one deque append — cheap enough for every
        step of an instrumented run."""
        rec = dict(fields)
        rec.setdefault("t", time.time())
        with self._lock:
            self._records.append(rec)
        return rec

    def annotate(self, step, **fields):
        """Merge fields into the newest record for ``step`` (the health
        monitor resolves bundles one step late); creates the record if the
        ring never saw — or already evicted — that step."""
        with self._lock:
            for rec in reversed(self._records):
                if rec.get("step") == step:
                    rec.update(fields)
                    return rec
        return self.note(step=step, **fields)

    def snapshot(self):
        with self._lock:
            return [dict(r) for r in self._records]

    def clear(self):
        with self._lock:
            self._records.clear()
            self.dumps = []

    def dump(self, reason, path=None, extra=None):
        """Write the ring to a JSON file; returns the path (None when the
        ring is empty — nothing flown, nothing to record)."""
        recs = self.snapshot()
        if not recs:
            return None
        if path is None:
            d = (os.environ.get("DL4J_TPU_FLIGHT_DIR")
                 or tempfile.gettempdir())
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"dl4j_tpu_flight_{os.getpid()}_{int(time.time() * 1e3)}"
                   f".json")
        doc = {"reason": reason, "pid": os.getpid(),
               "dumped_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
               "n_records": len(recs)}
        try:
            # clock pair: lets the cluster-timeline merge place this
            # process's traces on the shared wall clock postmortem
            from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
            doc["clock"] = _timeline.clock_pair()
        except Exception:
            pass
        for key, provider in list(_dump_sections.items()):
            try:
                # registered analysis sections ride every dump — e.g. the
                # SLO engine names the rules burning when the process died
                # (telemetry/slo.py). Defensive like the clock/trace
                # sections: a broken provider must never mask the dump.
                section = provider()
                if section is not None:
                    doc[key] = section
            except Exception:
                pass
        if extra:
            doc.update(extra)
        doc["records"] = recs
        try:
            # the slow-trace ring rides every dump: a crash report then
            # carries the complete causal timelines of the slowest
            # requests/dispatches that preceded the anomaly (read them
            # back with `traces --file <dump.json>`)
            from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx
            traces = _tracectx.get_ring().snapshot()
            if traces:
                doc["traces"] = traces
        except Exception:
            pass  # a broken ring must never mask the dump itself
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        path = str(path)
        with self._lock:
            self.dumps.append(path)
        return path


#: {key: zero-arg provider} of extra sections every dump carries; a
#: provider returning None contributes nothing (see dump()). Providers
#: read live state at dump time, so registration is once-per-process.
_dump_sections = {}


def register_dump_section(key, provider):
    """Attach a named analysis section to every future dump (idempotent
    per key — the latest provider wins)."""
    _dump_sections[str(key)] = provider


def unregister_dump_section(key):
    _dump_sections.pop(str(key), None)


_recorder = FlightRecorder()


def get_recorder():
    return _recorder


def crash_dump(exc):
    """Dump the ring for an uncaught fit-loop exception — defensive (a
    failed dump must never mask the training error) and once per exception:
    the watchdog marks its NumericsError with the dump path it already
    wrote, and this marker stops a second, identical dump here."""
    try:
        rec = get_recorder()
        if not rec.armed:
            return None
        existing = getattr(exc, "flight_dump", None)
        if existing:
            return existing
        path = rec.dump(reason=f"exception:{type(exc).__name__}",
                        extra={"error": str(exc)[:500]})
        if path is not None:
            try:
                exc.flight_dump = path
            except Exception:
                pass
        return path
    except Exception:
        return None


_sig_installed = {}


def install_signal_handler(signum=signal.SIGTERM):
    """Dump the ring when ``signum`` arrives, then chain to the previous
    disposition (a SIG_DFL previous handler is re-raised so the default
    action — usually termination — still happens). Opt-in and idempotent;
    must run on the main thread (CPython restriction on signal.signal)."""
    if _sig_installed.get(signum):
        return False
    prev = signal.getsignal(signum)

    def _handler(s, frame):
        try:
            get_recorder().dump(reason=f"signal:{signal.Signals(s).name}")
        finally:
            if callable(prev):
                prev(s, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(s, signal.SIG_DFL)
                signal.raise_signal(s)

    signal.signal(signum, _handler)
    _sig_installed[signum] = True
    return True
