"""Metrics registry: counters, gauges, fixed-bucket histograms.

The port of ``deeplearning4j_tpu/telemetry/registry.py``, the same in
substance; the endpoints and CLI verbs it names are the JAX package's.

Reference analog: the reference scatters observability across
PerformanceListener (samples/sec), BaseStatsListener (SBE-encoded stats
records) and libnd4j's OpProfiler; none of them compose and none cover the
serving/distributed/ETL tiers. This module is the unifying layer: cheap
always-on counters in the TensorFlow monitoring mold (Abadi et al., 2016,
§5 — "cheap always-on counters plus on-demand correlated traces"), exported
as JSON-lines (one series per line, the bench.py record schema) or
Prometheus text exposition format (scraped from UIServer's /metrics).

Design constraints:

* Thread-safe: the serving worker, the ETL prefetch thread and the training
  loop all write concurrently; one registry-wide lock guards every series
  map (contention is negligible — the critical sections are dict updates).
* Near-zero overhead when disabled: every record method's first action is
  one attribute load + branch; nothing is allocated, no clock is read. The
  instrumented fit loops additionally skip their ``perf_counter`` calls when
  the registry is off, so a disabled build adds only dead branches to the
  step path (no device->host syncs are ever added; see acceptance test).
* Histograms use fixed cumulative buckets (Prometheus semantics): observe()
  is O(log n_buckets) with no per-observation allocation, and latency
  percentiles are estimated from the bucket CDF — the standard trade for
  always-on latency tracking of "heavy traffic" serving paths.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time

_INF = float("inf")

#: trace-id source for histogram exemplars, injected by telemetry.tracectx
#: at import (this module cannot import tracectx — tracectx imports it).
#: None until tracing is wired; the callable returns the attached trace id
#: or None, and observe() only consults it on the enabled path.
_exemplar_source = None


def set_exemplar_source(fn):
    global _exemplar_source
    _exemplar_source = fn

#: default latency buckets (seconds): 100us .. 60s, roughly log-spaced —
#: wide enough for both a 200us serving forward and a multi-second
#: distributed averaging round
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def env_enabled():
    """Telemetry default state: DL4J_TPU_TELEMETRY=1 switches it on for a
    whole process without touching code (CLI runs, bench sweeps)."""
    return os.environ.get("DL4J_TPU_TELEMETRY", "0") == "1"


def write_jsonl(record, stream=None):
    """THE JSON-lines writer: one compact JSON object per line, flushed.

    Shared schema/writer for bench.py record emission and the registry's
    JSONL export, so every machine-readable artifact this repo emits goes
    through one serializer (non-JSON-native values degrade to str rather
    than killing the producing sweep)."""
    stream = sys.stdout if stream is None else stream
    stream.write(json.dumps(record, default=str) + "\n")
    stream.flush()


class _Metric:
    """Base: one named metric holding a family of label-keyed series."""

    kind = "untyped"

    def __init__(self, name, help="", registry=None):
        self.name = name
        self.help = help
        self._reg = registry
        self._lock = registry._lock
        self._series = {}  # tuple(sorted(label items)) -> value

    @staticmethod
    def _key(labels):
        return tuple(sorted(labels.items()))

    def labelsets(self):
        with self._lock:
            return [dict(k) for k in self._series]

    def _snapshot_value(self, raw):
        return raw

    def snapshot(self):
        with self._lock:
            return {"kind": self.kind, "help": self.help,
                    "series": [{"labels": dict(k),
                                "value": self._snapshot_value(v)}
                               for k, v in self._series.items()]}


class Counter(_Metric):
    """Monotonic counter (requests served, cache hits, iterations)."""

    kind = "counter"

    def inc(self, amount=1.0, **labels):
        if not self._reg.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels):
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Gauge(_Metric):
    """Point-in-time value (queue depth, score, device bytes in use)."""

    kind = "gauge"

    def set(self, value, **labels):
        if not self._reg.enabled:
            return
        k = self._key(labels)
        with self._lock:
            self._series[k] = float(value)

    def inc(self, amount=1.0, **labels):
        if not self._reg.enabled:
            return
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def dec(self, amount=1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        with self._lock:
            return self._series.get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Fixed-bucket histogram with Prometheus cumulative-bucket semantics;
    the latency-percentile instrument for the serving/step hot paths."""

    kind = "histogram"

    def __init__(self, name, help="", registry=None, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, registry)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs

    def observe(self, value, **labels):
        if not self._reg.enabled:
            return
        k = self._key(labels)
        i = bisect.bisect_left(self.buckets, value)
        # exemplar (OpenMetrics): each bucket remembers the LAST trace id
        # that landed in it, so a tail bucket on /metrics links straight
        # to a concrete slow trace in the ring. Resolved outside the lock;
        # no trace attached (or tracing off) costs one call + branch.
        src = _exemplar_source
        tid = src() if src is not None else None
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            st["counts"][i] += 1
            st["sum"] += value
            st["count"] += 1
            if tid is not None:
                st.setdefault("exemplars", {})[i] = {
                    "trace_id": tid, "value": value, "ts": time.time()}

    def count(self, **labels):
        with self._lock:
            st = self._series.get(self._key(labels))
            return st["count"] if st else 0

    def sum(self, **labels):
        with self._lock:
            st = self._series.get(self._key(labels))
            return st["sum"] if st else 0.0

    def percentile(self, q, **labels):
        """Bucket-CDF estimate of the q-th percentile (q in [0, 100]).
        Linear interpolation inside the containing bucket; the overflow
        bucket reports its lower bound (the largest finite boundary)."""
        with self._lock:
            st = self._series.get(self._key(labels))
            if not st or not st["count"]:
                return None
            counts = list(st["counts"])
            total = st["count"]
        rank = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]

    def _snapshot_value(self, raw):
        les = [*map(str, self.buckets), "+Inf"]
        out = {"buckets": dict(zip(les, raw["counts"])),
               "sum": raw["sum"], "count": raw["count"]}
        ex = raw.get("exemplars")
        if ex:
            # keyed by the bucket's le label — the JSONL/Prometheus
            # exporters and the acceptance tests read it by bound
            out["exemplars"] = {les[i]: dict(e) for i, e in ex.items()}
        return out


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    ``enabled`` gates every write; explicitly constructed registries default
    to enabled (tests, embedded use), while the process-wide default
    registry starts from ``DL4J_TPU_TELEMETRY`` and is toggled through
    telemetry.enable()/disable().
    """

    def __init__(self, enabled=True):
        self._lock = threading.RLock()
        self._metrics = {}
        self._enabled = bool(enabled)

    @property
    def enabled(self):
        return self._enabled

    @enabled.setter
    def enabled(self, flag):
        self._enabled = bool(flag)
        # ONE toggle: flipping the default registry also flips span
        # tracing, so `get_registry().enabled = True` and
        # `telemetry.enable()` are equivalent (metrics appearing while the
        # Chrome trace stays silently empty was a support trap)
        if _default is self:
            from deeplearning4j_tpu_torch.telemetry import tracing as _tracing
            _tracing.set_enabled(self._enabled)

    def _get_or_create(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, registry=self, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        m = self._get_or_create(Histogram, name, help, buckets=buckets)
        want = tuple(sorted(float(b) for b in buckets))
        if m.buckets != want:
            # silently handing back the first caller's resolution would put
            # the second caller's observations in bounds it never asked for
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}, requested {want}")
        return m

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def reset(self):
        """Drop every recorded series (metric objects survive, so cached
        instrument references in instrumented code stay valid)."""
        with self._lock:
            for m in self._metrics.values():
                m._series.clear()

    # -- exporters -----------------------------------------------------

    def snapshot(self):
        """{name: {kind, help, series: [{labels, value}]}} — the JSON shape
        the CLI dump and the acceptance test read."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(metrics)}

    def to_jsonl(self, stream=None):
        """One line per series through write_jsonl (the bench.py writer).
        Returns the serialized text when ``stream`` is None."""
        import io
        out = stream if stream is not None else io.StringIO()
        for name, snap in self.snapshot().items():
            for s in snap["series"]:
                write_jsonl({"metric": name, "kind": snap["kind"],
                             "labels": s["labels"], "value": s["value"]},
                            out)
        return None if stream is not None else out.getvalue()

    def to_prometheus(self):
        """OpenMetrics text exposition — served by UIServer's /metrics
        endpoint (as application/openmetrics-text: bucket-line exemplar
        suffixes are only legal there, and a classic 0.0.4 parser would
        reject the whole scrape the moment tracing stamped one). Ends
        with the spec's ``# EOF`` marker."""
        lines = []
        for name, snap in self.snapshot().items():
            if snap["help"]:
                # help text is escaped too (\\ and \n per the exposition
                # format) — a multi-line help string must not corrupt the
                # whole scrape
                lines.append(f"# HELP {name} "
                             f"{_prom_escape_help(snap['help'])}")
            lines.append(f"# TYPE {name} {snap['kind']}")
            for s in snap["series"]:
                base = dict(s["labels"])
                if snap["kind"] == "histogram":
                    v = s["value"]
                    exemplars = v.get("exemplars") or {}
                    cum = 0
                    # exposition-format buckets are CUMULATIVE (le= means
                    # "observations <= bound"); the snapshot stores raw
                    # per-bucket counts, so accumulate here
                    for le, c in v["buckets"].items():
                        cum += c
                        line = _prom_line(f"{name}_bucket",
                                          {**base, "le": le}, cum)
                        ex = exemplars.get(le)
                        if ex is not None:
                            # OpenMetrics exemplar: the last trace that
                            # landed in this bucket, linking the gauge to
                            # a concrete causal timeline
                            line += (f' # {{trace_id="'
                                     f'{_prom_escape(ex["trace_id"])}"}} '
                                     f'{ex["value"]} {ex["ts"]}')
                        lines.append(line)
                    lines.append(_prom_line(f"{name}_sum", base, v["sum"]))
                    lines.append(_prom_line(f"{name}_count", base,
                                            v["count"]))
                else:
                    lines.append(_prom_line(name, base, s["value"]))
        if not lines:
            return ""
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def _prom_line(name, labels, value):
    if labels:
        body = ",".join(f'{k}="{_prom_escape(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def _prom_escape(v):
    """THE label-value escaper (exposition format: backslash, double
    quote, newline) — label values AND exemplar labels route through this
    one function, so a model named ``he said "hi"\\n`` cannot corrupt a
    /metrics scrape anywhere."""
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


def _prom_escape_help(v):
    # help text escapes backslash and newline only (quotes are legal)
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


_default = None
_default_lock = threading.Lock()


def get_registry():
    """The process-wide default registry every instrumented layer records
    into; created on first use, enabled per DL4J_TPU_TELEMETRY."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry(enabled=env_enabled())
    return _default
