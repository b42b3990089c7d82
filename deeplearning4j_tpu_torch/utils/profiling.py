"""Programmatic profile analysis: per-kernel device time from a
``torch.profiler`` trace.

The port of ``deeplearning4j_tpu/utils/profiling.py``, which reads the
xprof trace of a ``jax.profiler`` capture; this one reads the Chrome trace
that ``telemetry/profiling.py profile_window`` writes
(``<logdir>/trace.json``) and turns it into a ranked op table: the device
events (CUDA kernels, memcpys and memsets) summed by name.

Usage:
    with profile_window(logdir): ...timed work...
    for op in top_ops(logdir, k=10):
        print(op["total_self_us"], op["category"], op["expression"][:80])

``merge_rows``, ``rank_ops`` and ``format_rows`` are the JAX module's.
A trace can lack device events of launches it holds (the tracer drops
them); ``launch_check`` counts those, and ``top_ops`` warns of them, so a
ranked table never under-counts a kernel quietly.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
import warnings

#: the Chrome-trace categories of device work in a torch.profiler trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(trace_dir):
    """Newest Chrome trace (``*.json``) under a capture directory."""
    paths = sorted(glob.glob(os.path.join(str(trace_dir), "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace .json under {trace_dir}")
    return paths[-1]


def rows_from_trace(doc, categories=DEVICE_CATEGORIES):
    """One row per complete ('X') event of ``categories`` in a Chrome
    trace dict, with the canonical keys ``total_self_us`` (its duration:
    device events do not nest), ``occurrences`` (1), ``category``,
    ``bound_by`` (None: the trace does not say) and ``expression`` (the
    event's name). Pure — unit-testable on a synthetic trace."""
    rows = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in categories:
            continue
        rows.append({"total_self_us": float(ev.get("dur", 0.0)), "occurrences": 1,
                     "category": ev.get("cat"), "bound_by": None,
                     "expression": ev.get("name")})
    return rows


def launch_check(doc, categories=DEVICE_CATEGORIES):
    """A Chrome trace's kernel launches against its device events, matched
    by the correlation id the tracer gives both. ``launches``: the host
    calls whose name holds "Launch" (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaGraphLaunch``, ...); ``device_events``;
    ``missing``: the launches with no device event, ``missing_by_call``
    the same by the call's name and ``missing_ts`` their start times;
    ``lag_us``: the least, median and largest
    of a device event's start less its launch's (below 0, the device's
    times stand earlier on the host's clock than the launches that caused
    them). Pure — unit-testable on a synthetic trace."""
    evs = doc.get("traceEvents", [])
    launch = {}
    for ev in evs:
        if (ev.get("ph") == "X" and ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in ev.get("name", "")):
            launch[ev.get("args", {}).get("correlation")] = ev
    device = [ev for ev in evs if ev.get("ph") == "X" and ev.get("cat") in categories]
    seen = {ev.get("args", {}).get("correlation") for ev in device}
    by_call, missing_ts = {}, []
    for corr, ev in launch.items():
        if corr not in seen:
            by_call[ev["name"]] = by_call.get(ev["name"], 0) + 1
            missing_ts.append(float(ev["ts"]))
    lags = sorted(float(ev["ts"]) - float(launch[c]["ts"]) for ev in device
                  if (c := ev.get("args", {}).get("correlation")) in launch)
    return {"launches": len(launch), "device_events": len(device),
            "missing": sum(by_call.values()), "missing_by_call": by_call,
            "missing_ts": sorted(missing_ts),
            "lag_us": ({"min": lags[0], "median": statistics.median(lags), "max": lags[-1]}
                       if lags else None)}


def merge_rows(rows):
    """Merge rows sharing an expression: self-times and occurrence counts
    add; the first row's other columns win."""
    merged = {}
    order = []
    for r in rows:
        key = r.get("expression")
        cur = merged.get(key)
        if cur is None or key is None:
            # None expressions never merge with each other — keep them apart
            key = key if key is not None else object()
            merged[key] = dict(r)
            order.append(key)
            continue
        cur["total_self_us"] = ((cur.get("total_self_us") or 0.0)
                                + (r.get("total_self_us") or 0.0))
        cur["occurrences"] = ((cur.get("occurrences") or 0)
                              + (r.get("occurrences") or 0))
    return [merged[k] for k in order]


def rank_ops(rows, k=None):
    """Rows sorted by descending self-time; ``k`` truncates (None = all)."""
    out = sorted(rows, key=lambda r: r["total_self_us"] or 0.0, reverse=True)
    return out if k is None else out[:k]


def top_ops(trace_dir, k=15, categories=DEVICE_CATEGORIES):
    """Ranked per-kernel rows of the newest trace under a capture
    directory (events of one name merged first). Warns when the trace
    holds launches without their device events: the rows then under-count
    the kernels those launched."""
    with open(find_trace(trace_dir)) as f:
        doc = json.load(f)
    check = launch_check(doc, categories)
    if check["missing"]:
        warnings.warn(f"{check['missing']} of {check['launches']} launches in {trace_dir} "
                      f"have no device event ({check['missing_by_call']}): the ranked "
                      "times under-count their kernels", RuntimeWarning, stacklevel=2)
    return rank_ops(merge_rows(rows_from_trace(doc, categories)), k)


def format_rows(rows):
    """Human-readable ranked-op table (one string), for logs and reports."""
    lines = [f"{'self us':>10}  {'%':>5}  {'x':>5}  {'category':<18} expression"]
    total = sum(r["total_self_us"] or 0.0 for r in rows) or 1.0
    for r in rows:
        us = r["total_self_us"] or 0.0
        occ = r["occurrences"] or 0
        lines.append(
            f"{us:>10.1f}  {100.0 * us / total:>4.1f}  {occ:>5.0f}  "
            f"{(r['category'] or '?'):<18} {(r['expression'] or '')[:90]}")
    return "\n".join(lines)


def summarize(trace_dir, k=10):
    """Human-readable top-k table for a captured trace directory."""
    return format_rows(top_ops(trace_dir, k))
