"""Cluster timeline: one time-aligned view over every process's traces.

The port of ``deeplearning4j_tpu/telemetry/timeline.py``, the same in
substance; the endpoints and CLI verbs it names are the JAX package's.

PRs 12–15 made the production story multi-process (fleet router+workers,
hostfleet generations, continuous runner); each process keeps its own
slow-trace ring and flight dumps, all timestamped with ITS clocks.
Diagnosing a wedged round then means hand-correlating N files with N
different time bases. This module is the merge: per-process trace
sources (a live ring snapshot, a /traces scrape, a flight dump) are
re-anchored onto one shared wall-clock timeline using the
monotonic+epoch **clock pair** every worker echoes on its ready line and
each HTTP round trip, and rendered as one merged timeline (JSON for
``/traces?cluster=1``, Chrome trace events for a viewer, an indented
text view for the ``traces --cluster`` CLI).

Clock discipline: a single (mono, unix) pair lets the receiver estimate
``offset = remote_unix - local_unix`` at one instant; the round-trip
variant (:func:`estimate_offset`) bounds the estimate by the RTT and
clamps to 0 inside the uncertainty — same-host processes share
``time.time()``, and "correcting" them by half an RTT of noise would
MISalign what the kernel already aligned.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["clock_pair", "estimate_offset", "source", "merge",
           "to_chrome", "load_file", "load_dir", "load_paths",
           "register_source_provider", "unregister_source_provider",
           "clear_source_providers", "cluster_snapshot"]


def clock_pair():
    """The monotonic+epoch timestamp pair a process stamps on its ready
    line, HTTP responses and flight dumps — the clock-alignment seed.
    One definition so every wire carries the same two keys."""
    return {"mono": time.perf_counter(), "unix": time.time()}


def estimate_offset(remote_unix, sent_unix, recv_unix):
    """One NTP-style offset sample from a round trip: the remote stamped
    ``remote_unix`` somewhere inside our [sent, recv] window, so
    ``offset = remote - midpoint`` with uncertainty RTT/2. Offsets
    inside the uncertainty clamp to 0 (indistinguishable from shared
    clocks, and same-host processes DO share time.time()). Returns
    ``(offset_s, uncertainty_s)``."""
    try:
        remote_unix = float(remote_unix)
    except (TypeError, ValueError):
        return 0.0, None
    mid = 0.5 * (sent_unix + recv_unix)
    unc = max(0.5 * (recv_unix - sent_unix), 0.0)
    off = remote_unix - mid
    return (0.0 if abs(off) <= unc else off), unc


def source(instance, rings, clock_offset_s=0.0, meta=None):
    """Normalize one process's traces into a timeline source:
    ``rings`` is the slow-trace-ring shape ({root name: [trace docs]});
    ``clock_offset_s`` is that process's clock minus the local clock
    (subtracted during the merge)."""
    rings = {k: [d for d in v if isinstance(d, dict)]
             for k, v in (rings or {}).items() if isinstance(v, list)}
    out = {"instance": str(instance), "rings": rings,
           "clock_offset_s": float(clock_offset_s or 0.0)}
    if meta:
        out["meta"] = dict(meta)
    return out


def merge(sources):
    """Merge per-process sources into ONE time-aligned timeline.

    Every trace doc's ``t0_unix`` is shifted by its source's clock
    offset onto the local wall clock; traces sort by aligned start.
    ``hosts`` summarizes ``hostfleet.round`` traces per instance (last
    round seen + its aligned end time) and names the ``stalled``
    instance — the one whose round clock stopped first — which is how a
    postmortem over a killed generation's dumps identifies the dead
    host's last round."""
    traces = []
    instances = []
    for src in sources:
        inst = src.get("instance", "?")
        if inst not in instances:
            instances.append(inst)
        off = float(src.get("clock_offset_s") or 0.0)
        for name, docs in (src.get("rings") or {}).items():
            for doc in docs:
                t0 = doc.get("t0_unix")
                aligned = None if t0 is None else float(t0) - off
                dur = doc.get("duration_s")
                traces.append({
                    "instance": inst, "name": doc.get("name", name),
                    "trace_id": doc.get("trace_id"),
                    "status": doc.get("status"),
                    "t0_unix": aligned, "duration_s": dur,
                    "spans": doc.get("spans") or []})
    traces.sort(key=lambda t: (t["t0_unix"] is None, t["t0_unix"] or 0.0))
    base = min((t["t0_unix"] for t in traces
                if t["t0_unix"] is not None), default=None)
    hosts = {}
    for t in traces:
        if t["name"] != "hostfleet.round" or not t["spans"]:
            continue
        args = (t["spans"][0].get("args") or {})
        rnd = args.get("round")
        if rnd is None:
            continue
        h = hosts.setdefault(t["instance"], {"last_round": -1,
                                             "last_end_unix": None})
        end = (None if t["t0_unix"] is None
               else t["t0_unix"] + (t["duration_s"] or 0.0))
        if int(rnd) >= h["last_round"]:
            h["last_round"] = int(rnd)
            h["last_end_unix"] = end
    stalled = None
    if len(hosts) > 1:
        rounds = {i: h["last_round"] for i, h in hosts.items()}
        lo = min(rounds.values())
        if lo < max(rounds.values()):
            # the host whose round clock stopped first; ties broken by
            # the OLDEST last activity (it went quiet before its peers)
            behind = [i for i, r in rounds.items() if r == lo]
            stalled = min(behind, key=lambda i:
                          hosts[i]["last_end_unix"] or 0.0)
    return {"instances": instances, "t0_unix": base,
            "n_traces": len(traces), "traces": traces,
            "hosts": hosts, "stalled": stalled}


def to_chrome(merged):
    """The merged timeline as a chrome://tracing / Perfetto-loadable
    dict: one ``pid`` row per instance, span start times in absolute
    microseconds since the merged timeline's base."""
    base = merged.get("t0_unix") or 0.0
    events = []
    pids = {inst: i + 1 for i, inst in enumerate(merged["instances"])}
    for t in merged["traces"]:
        if t["t0_unix"] is None:
            continue
        t_abs = t["t0_unix"] - base
        pid = pids.get(t["instance"], 0)
        for s in t["spans"]:
            if not isinstance(s, dict) or s.get("t0_s") is None:
                continue
            ev = {"name": s.get("name"), "ph": "X",
                  "ts": (t_abs + s["t0_s"]) * 1e6,
                  "dur": (s.get("dur_s") or 0.0) * 1e6,
                  "pid": pid, "tid": s.get("thread") or "main",
                  "args": {"trace_id": t["trace_id"],
                           **(s.get("args") or {})}}
            events.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": p,
             "args": {"name": inst}} for inst, p in pids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _source_from_doc(doc, fallback_instance):
    """One loaded JSON document as a timeline source. Accepts the three
    shapes traces travel in (a /traces payload, a raw ring snapshot, a
    flight dump with a 'traces' key) plus the postmortem shape the
    hostfleet supervisor writes (adds instance/clock_offset_s)."""
    if not isinstance(doc, dict):
        return None
    rings = doc.get("traces", doc)
    if not isinstance(rings, dict):
        return None
    rings = {k: v for k, v in rings.items() if isinstance(v, list)}
    if not rings:
        return None
    inst = doc.get("instance") or (f"pid{doc['pid']}" if doc.get("pid")
                                   else fallback_instance)
    return source(inst, rings,
                  clock_offset_s=doc.get("clock_offset_s") or 0.0,
                  meta={k: doc[k] for k in ("reason", "dumped_at", "host")
                        if k in doc})


def load_file(path):
    """One dump/scrape file -> timeline source (None when it carries no
    traces)."""
    with open(path) as f:
        doc = json.load(f)
    return _source_from_doc(doc, os.path.basename(path))


def load_dir(path):
    """Every readable JSON file in a directory of flight dumps (the
    postmortem of a dead generation) -> timeline sources. Unparseable
    and trace-less files are skipped, not fatal: a postmortem dir mixes
    dumps with bundles and heartbeats."""
    out = []
    for name in sorted(os.listdir(path)):
        if not name.endswith(".json"):
            continue
        try:
            src = load_file(os.path.join(path, name))
        except (OSError, ValueError):
            continue
        if src is not None:
            out.append(src)
    return out


def load_paths(paths):
    """Files and/or directories -> merged source list (the CLI's
    multi ``--file`` / directory entry point)."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(load_dir(p))
        else:
            src = load_file(p)
            if src is not None:
                out.append(src)
    return out


# -- live cluster sources (UIServer /traces?cluster=1) ------------------

_lock = threading.Lock()
_providers = []


def register_source_provider(fn):
    """Register a zero-arg callable returning timeline sources for the
    processes THIS process supervises (the fleet/hostfleet supervisors
    register here so the UIServer can serve the whole cluster's
    timeline). Idempotent per callable; cleared by telemetry.reset()."""
    with _lock:
        if fn not in _providers:
            _providers.append(fn)


def unregister_source_provider(fn):
    with _lock:
        if fn in _providers:
            _providers.remove(fn)


def clear_source_providers():
    with _lock:
        _providers.clear()


def cluster_snapshot(include_local=True):
    """The merged cluster timeline: this process's own ring plus every
    registered provider's sources. A broken provider is skipped (the
    timeline endpoint must never 500 because one member died)."""
    sources = []
    if include_local:
        from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx
        rings = _tracectx.get_ring().snapshot()
        if rings:
            sources.append(source(f"local:pid{os.getpid()}", rings))
    with _lock:
        providers = list(_providers)
    for fn in providers:
        try:
            sources.extend(fn() or ())
        except Exception:  # noqa: BLE001 — one dead member, not a 500
            continue
    return merge(sources)
