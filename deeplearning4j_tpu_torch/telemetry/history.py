"""Bounded metrics history: the demand plane's memory.

The port of ``deeplearning4j_tpu/telemetry/history.py``. The SLO engine
judges the registry as it is now; this module lets anything ask what a
series did over the last minutes, and lets a restarted process judge a
window it did not live through.

:class:`MetricsHistory` is a bounded in-process time series store:

* a sampler thread snapshots the local registry (or any callable source,
  e.g. a federated merge) on an interval into a fixed-size ring of
  ``{"t": unix_seconds, "metrics": <registry snapshot>}`` docs;
* every ``segment_samples`` samples persist as ONE atomic JSONL segment
  under ``history_dir`` (tmp + ``os.replace``), the oldest evicted past
  ``max_segments``, and a store over an existing dir resumes its segment
  sequence; the segment format is the JAX package's, so each package reads
  the other's segments;
* ``query(series, t0, t1)`` answers range queries over the ring, and
  ``rate_over(series, window_s)`` applies the SLO engine's per-series
  counter-delta discipline (:class:`~.slo._DeltaTrack`): a series that
  resets, vanishes or newly appears contributes nothing for that interval;
* ``replay_into(engine)`` feeds retained samples through
  ``SloEngine.evaluate(metrics=..., now=sample_t)``;
* :func:`load_dir` reads a history dir back; a corrupt segment is counted
  (``history_segment_total{event=corrupt}``), never fatal.

The process-default store (:func:`get_history`, its dir from
``DL4J_TPU_HISTORY_DIR``) registers the flight recorder's ``"history"``
dump section. Sampling runs on the host and reads no tensor.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from deeplearning4j_tpu_torch.telemetry import registry as _registry
from deeplearning4j_tpu_torch.telemetry.slo import (_DeltaTrack, _normalize,
                                              _select)

#: history segment file name prefix (``<prefix><seq>.jsonl``)
SEGMENT_PREFIX = "history-"


def parse_series(series):
    """``"metric"`` or ``"metric{k=v,k2=v2}"`` -> (metric, labels dict).
    The one spec parser of ``query``, ``rate_over`` and the tests."""
    series = str(series).strip()
    if "{" not in series:
        return series, {}
    if not series.endswith("}"):
        raise ValueError(f"malformed series spec {series!r} "
                         "(expected metric{{k=v,...}})")
    metric, _, rest = series.partition("{")
    labels = {}
    body = rest[:-1].strip()
    if body:
        for pair in body.split(","):
            k, sep, v = pair.partition("=")
            if not sep or not k.strip():
                raise ValueError(f"malformed label pair {pair!r} in "
                                 f"series spec {series!r}")
            labels[k.strip()] = v.strip().strip('"')
    return metric.strip(), labels


class MetricsHistory:
    """Bounded ring of registry snapshots + atomic JSONL persistence."""

    def __init__(self, registry=None, *, max_samples=512,
                 segment_samples=32, max_segments=16, history_dir=None,
                 source=None):
        self._reg = registry or _registry.get_registry()
        self.max_samples = int(max_samples)
        self.segment_samples = max(int(segment_samples), 1)
        self.max_segments = max(int(max_segments), 1)
        self.history_dir = history_dir
        #: callable returning the metrics doc to snapshot (None = the
        #: local registry; e.g. a federated merge)
        self._source = source
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.max_samples)
        self._seg_buf = []     # samples awaiting the next segment flush
        self._seg_seq = 0      # next segment sequence number
        self._corrupt = 0      # segments/lines dropped on load
        self._persist_errors = 0
        self._thread = None
        self._stop = threading.Event()
        self.interval_s = None
        self._m_samples = self._reg.counter(
            "history_samples_total",
            "metrics-history snapshots taken by outcome (ok/error)")
        self._m_segments = self._reg.counter(
            "history_segment_total",
            "history segment persistence events "
            "(persist/evict/corrupt/persist_error)")
        if self._reg.enabled:
            # pre-register the snapshot outcome series at zero: a broken
            # source's error series must land in the delta window it
            # first breaks in, not be discarded as a series birth
            for outcome in ("ok", "error"):
                self._m_samples.inc(0, outcome=outcome)
        if history_dir:
            os.makedirs(history_dir, exist_ok=True)
            self._seg_seq = self._next_seq(history_dir)

    @staticmethod
    def _next_seq(history_dir):
        """First unused segment sequence number (resume after restart)."""
        seq = 0
        try:
            names = os.listdir(history_dir)
        except OSError:
            return 0
        for name in names:
            if name.startswith(SEGMENT_PREFIX) and name.endswith(".jsonl"):
                try:
                    seq = max(seq, 1 + int(
                        name[len(SEGMENT_PREFIX):-len(".jsonl")]))
                except ValueError:
                    continue
        return seq

    # ---- sampling ----

    def sample_now(self, now=None, metrics=None):
        """Take one snapshot NOW (the sampler thread's body; also the
        deterministic test/bench entry point — explicit ``now`` makes
        every downstream window exact). Returns the sample doc."""
        if now is None:
            now = time.time()
        try:
            if metrics is None:
                metrics = (self._reg.snapshot() if self._source is None
                           else self._source())
            metrics = _normalize(metrics, self._reg)
        except Exception:  # a broken source degrades counted, not fatal
            if self._reg.enabled:
                self._m_samples.inc(outcome="error")
            return None
        sample = {"t": float(now), "metrics": metrics}
        flush = None
        with self._lock:
            self._ring.append(sample)
            if self.history_dir:
                self._seg_buf.append(sample)
                if len(self._seg_buf) >= self.segment_samples:
                    flush, self._seg_buf = self._seg_buf, []
        if self._reg.enabled:
            self._m_samples.inc(outcome="ok")
        if flush:
            self._persist_segment(flush)
        return sample

    def _persist_segment(self, samples):
        """One atomic JSONL segment (tmp + rename) + oldest-first
        eviction past ``max_segments``. A persistence failure is counted
        and the store keeps sampling — history must never take down the
        process it observes."""
        with self._lock:
            seq = self._seg_seq
            self._seg_seq += 1
        path = os.path.join(self.history_dir,
                            f"{SEGMENT_PREFIX}{seq:08d}.jsonl")
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                for s in samples:
                    f.write(json.dumps(s) + "\n")
            os.replace(tmp, path)
            if self._reg.enabled:
                self._m_segments.inc(event="persist")
            for old in self.segment_paths()[:-self.max_segments]:
                try:
                    os.remove(old)
                    if self._reg.enabled:
                        self._m_segments.inc(event="evict")
                except OSError:
                    pass
        except OSError:
            with self._lock:
                self._persist_errors += 1
            if self._reg.enabled:
                self._m_segments.inc(event="persist_error")

    def flush(self):
        """Persist any buffered partial segment now (shutdown path)."""
        if not self.history_dir:
            return
        with self._lock:
            buf, self._seg_buf = self._seg_buf, []
        if buf:
            self._persist_segment(buf)

    def segment_paths(self):
        """On-disk segment files, oldest first."""
        if not self.history_dir:
            return []
        try:
            names = sorted(n for n in os.listdir(self.history_dir)
                           if n.startswith(SEGMENT_PREFIX)
                           and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.history_dir, n) for n in names]

    # ---- queries ----

    def samples(self, t0=None, t1=None):
        """Retained samples (ring order = time order), optionally
        bounded to ``t0 <= t <= t1``."""
        with self._lock:
            out = list(self._ring)
        if t0 is not None:
            out = [s for s in out if s["t"] >= t0]
        if t1 is not None:
            out = [s for s in out if s["t"] <= t1]
        return out

    def query(self, series, t0=None, t1=None, field="sum"):
        """Range query: ``series`` is ``"metric"`` or
        ``"metric{k=v,...}"``; returns ``[[t, value], ...]`` with value =
        the sum over matching label series at each retained sample (the
        query's payload). Samples where the metric is absent are skipped,
        not zero-filled — absence is an honest gap, not a measurement."""
        metric, labels = parse_series(series)
        points = []
        for s in self.samples(t0, t1):
            cur = _select(s["metrics"], metric, labels, field)
            if cur:
                points.append([s["t"], sum(cur.values())])
        return points

    def rate_over(self, series, window_s, now=None, field="sum"):
        """Counter-aware per-second rate over the trailing window,
        applying the SLO engine's per-series delta discipline: a counter
        reset / vanished / newborn series contributes nothing for that
        interval (never a negative rate). None until two samples span
        the window's base."""
        metric, labels = parse_series(series)
        samples = self.samples()
        if not samples:
            return None
        if now is None:
            now = samples[-1]["t"]
        track = _DeltaTrack(keep_s=max(2 * float(window_s), 3600.0))
        for s in samples:
            track.sample(s["t"], _select(s["metrics"], metric, labels,
                                         field))
        return track.rate(float(window_s), now)

    def replay_into(self, engine, t0=None, t1=None, samples=None):
        """Feed retained (or given) samples through
        ``engine.evaluate(metrics=..., now=sample_t)`` oldest-first —
        the history-backed evaluation that lets a freshly restarted
        process judge burn-rate windows it didn't live through. Returns
        the number of samples replayed."""
        if samples is None:
            samples = self.samples(t0, t1)
        n = 0
        for s in samples:
            engine.evaluate(metrics=s["metrics"], now=s["t"])
            n += 1
        return n

    # ---- lifecycle ----

    def start(self, interval_s=15.0):
        """Sample every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self.interval_s = float(interval_s)
        self._stop.clear()  # graftlint: disable=R6 -- threading.Event is internally synchronized; self._lock guards the ring/segments, not lifecycle

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample_now()
                except Exception:  # sampling must never kill the host
                    pass

        self._thread = threading.Thread(target=loop,
                                        name="metrics-history",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        self.flush()

    def describe(self):
        """The layout/status doc (the flight-dump section): where the
        segments live and what the ring holds."""
        with self._lock:
            n = len(self._ring)
            last_t = self._ring[-1]["t"] if n else None
            first_t = self._ring[0]["t"] if n else None
            corrupt = self._corrupt
            persist_errors = self._persist_errors
            pending = len(self._seg_buf)
        return {"dir": self.history_dir,
                "segment_prefix": SEGMENT_PREFIX,
                "samples": n, "first_t": first_t, "last_t": last_t,
                "max_samples": self.max_samples,
                "segment_samples": self.segment_samples,
                "max_segments": self.max_segments,
                "segments": len(self.segment_paths()),
                "pending_samples": pending,
                "corrupt": corrupt,
                "persist_errors": persist_errors,
                "interval_s": self.interval_s,
                "sampling": self._thread is not None}

    def load(self, path=None, into_ring=True):
        """Read persisted segments back (default: this store's own dir).
        Corrupt segments/lines degrade counted — ``history_segment_total
        {event=corrupt}`` — never fatal. Returns the loaded samples;
        with ``into_ring`` they seed the ring (oldest evicted by the
        bound), so a restarted process can answer windows it didn't
        live through."""
        samples, corrupt = load_dir(path or self.history_dir)
        if corrupt:
            with self._lock:
                self._corrupt += corrupt
            if self._reg.enabled:
                self._m_segments.inc(corrupt, event="corrupt")
        if into_ring and samples:
            with self._lock:
                have = {s["t"] for s in self._ring}
                merged = [s for s in samples if s["t"] not in have]
                merged.extend(self._ring)
                merged.sort(key=lambda s: s["t"])
                self._ring.clear()
                self._ring.extend(merged)
        return samples


def load_dir(path):
    """(samples, corrupt_count) from a history dir (or one segment
    file). Unparseable files/lines are counted and skipped — a
    postmortem reader must survive a torn copy. Samples come back
    oldest-first by timestamp."""
    samples, corrupt = [], 0
    if not path:
        return samples, corrupt
    if os.path.isdir(path):
        try:
            paths = sorted(
                os.path.join(path, n) for n in os.listdir(path)
                if n.startswith(SEGMENT_PREFIX) and n.endswith(".jsonl"))
        except OSError:
            return samples, corrupt
    else:
        paths = [path]
    for p in paths:
        try:
            with open(p) as f:
                text = f.read()
        except OSError:
            corrupt += 1
            continue
        bad = False
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                bad = True
                continue
            if isinstance(doc, dict) and isinstance(doc.get("t"),
                                                    (int, float)) \
                    and isinstance(doc.get("metrics"), dict):
                samples.append(doc)
            else:
                bad = True
        if bad:
            corrupt += 1
    samples.sort(key=lambda s: s["t"])
    return samples, corrupt


# ---- process-default store ----

_default = None
_default_lock = threading.Lock()

#: env var naming the default store's history dir (optional; memory-only
#: without it)
HISTORY_DIR_ENV = "DL4J_TPU_HISTORY_DIR"


def get_history():
    """Process-default history store, created on first use (history dir
    from ``DL4J_TPU_HISTORY_DIR`` when set); registers the flight-dump
    section so every postmortem dump names the history dir layout."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsHistory(
                history_dir=os.environ.get(HISTORY_DIR_ENV) or None)
            from deeplearning4j_tpu_torch.telemetry import flight as _flight
            _flight.register_dump_section("history", _dump_section)
        return _default


def configure(**kwargs):
    """Replace the process-default store (``MetricsHistory`` kwargs: a
    dir, bounds, a source). Stops any previous sampler."""
    global _default
    fresh = MetricsHistory(**kwargs)
    with _default_lock:
        old, _default = _default, fresh
        from deeplearning4j_tpu_torch.telemetry import flight as _flight
        _flight.register_dump_section("history", _dump_section)
    if old is not None:
        old.stop()
    return fresh


def reset():
    """Drop the process-default store (telemetry.reset()): sampler
    stopped, ring gone. The dump section provider stays registered and
    reads whatever default exists at dump time."""
    global _default
    with _default_lock:
        store, _default = _default, None
    if store is not None:
        store.stop()


def _dump_section():
    """Flight-dump payload: the history dir layout + retention state, so
    a postmortem can replay the minutes BEFORE the dump (None when no
    store was ever created — nothing to point at)."""
    with _default_lock:
        store = _default
    if store is None:
        return None
    return store.describe()
