"""Metrics federation: one scrape for several processes.

The port of ``deeplearning4j_tpu/telemetry/federate.py``.
:func:`federate` collects every member's registry snapshot (a callable or
dict already in hand, or a URL to a member's ``/metrics`` JSON, read
through ``urllib`` under a timeout) and merges the series under a stable
added ``instance`` label, so a counter from two members is two series of
ONE metric.

Members are scraped concurrently under one bounded timeout; a dead member
costs one timeout in all and is **counted**
(``federate_scrape_total{outcome,instance}``): a federated read never
hangs and never fails because one member died. ``merged_to_prometheus``
renders a merge as OpenMetrics text. The SLO engine evaluates a merge
like a local snapshot.
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.telemetry.registry import (_prom_escape_help, _prom_line,
                                                         get_registry)

__all__ = ["federate", "federate_default", "merged_to_prometheus",
           "member_snapshot", "snapshot_from_series_maps",
           "register_target_provider", "unregister_target_provider",
           "clear_target_providers", "default_targets"]


def member_snapshot(source, timeout_s=2.0):
    """One member's registry snapshot: ``source`` is an already-collected
    snapshot dict ({name: {kind, help, series}}), a zero-argument callable
    returning one (e.g. a registry's ``snapshot``), or a URL to a member's
    ``/metrics`` JSON (the snapshot under ``"metrics"``), read within
    ``timeout_s``."""
    if callable(source):
        source = source()
    if isinstance(source, dict):
        return source.get("metrics", source)
    import json
    import urllib.request
    with urllib.request.urlopen(str(source), timeout=timeout_s) as r:
        doc = json.loads(r.read().decode())
    return doc.get("metrics", doc)


def snapshot_from_series_maps(series_maps, kind="counter"):
    """A registry-snapshot-shaped doc from the ``series_map`` wire form
    (``{metric: {"label=value|...": value}}``, ``telemetry.series_map``'s
    form): what a process without an HTTP server ships in its records."""
    out = {}
    for name, smap in (series_maps or {}).items():
        series = []
        for key, value in (smap or {}).items():
            labels = {}
            if key:
                for part in key.split("|"):
                    k, _, v = part.partition("=")
                    labels[k] = v
            series.append({"labels": labels, "value": value})
        out[name] = {"kind": kind, "help": "", "series": series}
    return out


def federate(targets, timeout_s=2.0, instance_label="instance"):
    """Scrape + merge every member's metrics under stable instance labels.

    ``targets``: iterable of ``(instance, source)`` — source as in
    :func:`member_snapshot`. Returns::

        {"metrics": {name: {kind, help, series: [...]}},  # merged
         "members": {instance: {"ok": bool, "error": str|None}},
         "scrapes": {"ok": n, "error": n}}

    Each merged series carries ``instance=<member>`` in addition to its
    own labels (a member-supplied instance label wins — a nested
    federation keeps its original attribution). Scrape outcomes are
    counted into the LOCAL registry's ``federate_scrape_total``.
    """
    targets = [(str(i), s) for i, s in targets]
    slots = [None] * len(targets)

    def scrape(i, src):
        try:
            slots[i] = ("ok", member_snapshot(src, timeout_s=timeout_s))
        except Exception as e:  # noqa: BLE001 — dead member, counted
            slots[i] = ("error", str(e)[:300])

    threads = [threading.Thread(target=scrape, args=(i, src), daemon=True)
               for i, (_inst, src) in enumerate(targets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s + 1.0)

    reg = get_registry()
    m_scrape = reg.counter(
        "federate_scrape_total",
        "federated member scrapes by outcome (ok/error) — a dead member "
        "is counted here, never a hang")
    if reg.enabled:
        # pre-register both outcome series per member at zero: a member
        # that dies on its FIRST scrape must land in that delta window,
        # not be invisible as a series birth (the prober idiom)
        for inst, _src in targets:
            for outcome in ("ok", "error"):
                m_scrape.inc(0, outcome=outcome, instance=inst)
    merged = {}
    members = {}
    counts = {"ok": 0, "error": 0}
    for (inst, _src), slot in zip(targets, slots):
        outcome, payload = slot if slot is not None else (
            "error", "scrape hung")
        if outcome != "ok" or not isinstance(payload, dict):
            members[inst] = {"ok": False,
                             "error": (payload if outcome != "ok"
                                       else "malformed snapshot")}
            counts["error"] += 1
            m_scrape.inc(outcome="error", instance=inst)
            continue
        members[inst] = {"ok": True, "error": None}
        counts["ok"] += 1
        m_scrape.inc(outcome="ok", instance=inst)
        for name, snap in payload.items():
            if not isinstance(snap, dict) or "series" not in snap:
                continue
            dst = merged.setdefault(name, {"kind": snap.get("kind", ""),
                                           "help": snap.get("help", ""),
                                           "series": []})
            if not dst["help"] and snap.get("help"):
                dst["help"] = snap["help"]
            for s in snap["series"]:
                labels = dict(s.get("labels") or {})
                labels.setdefault(instance_label, inst)
                dst["series"].append({"labels": labels,
                                      "value": s.get("value")})
    return {"metrics": merged, "members": members, "scrapes": counts}


# -- default-target registry -------------------------------------------

_plock = threading.Lock()
_target_providers = []


def register_target_provider(fn):
    """Register a zero-arg callable returning ``(instance, source)``
    pairs for the members THIS process fronts, so ``federate_default``
    covers them. Idempotent per callable; cleared by telemetry.reset()."""
    with _plock:
        if fn not in _target_providers:
            _target_providers.append(fn)


def unregister_target_provider(fn):
    with _plock:
        if fn in _target_providers:
            _target_providers.remove(fn)


def clear_target_providers():
    with _plock:
        _target_providers.clear()


def default_targets(include_local=True):
    """Every registered provider's targets, plus this process's own
    registry snapshot as instance ``local``. A broken provider is
    skipped: one dead provider never fails the federated read."""
    targets = []
    if include_local:
        targets.append(("local", get_registry().snapshot()))
    with _plock:
        providers = list(_target_providers)
    for fn in providers:
        try:
            targets.extend(fn() or ())
        except Exception:  # noqa: BLE001 — one dead provider, not a failure
            continue
    return targets


def federate_default(timeout_s=2.0):
    """The local registry plus every registered member, merged."""
    return federate(default_targets(), timeout_s=timeout_s)


def merged_to_prometheus(fed):
    """OpenMetrics text for a :func:`federate` result — the
    ``/metrics?federate=1`` body. Histogram series re-render their
    cumulative buckets; exemplars are dropped at federation level (the
    trace ids they point at live in the MEMBER's ring, not ours)."""
    lines = []
    for name, snap in sorted((fed.get("metrics") or {}).items()):
        if snap.get("help"):
            lines.append(f"# HELP {name} "
                         f"{_prom_escape_help(snap['help'])}")
        lines.append(f"# TYPE {name} {snap.get('kind') or 'untyped'}")
        for s in snap["series"]:
            base = dict(s["labels"])
            v = s["value"]
            if snap.get("kind") == "histogram" and isinstance(v, dict):
                cum = 0
                for le, c in (v.get("buckets") or {}).items():
                    cum += c
                    lines.append(_prom_line(f"{name}_bucket",
                                            {**base, "le": le}, cum))
                lines.append(_prom_line(f"{name}_sum", base,
                                        v.get("sum", 0.0)))
                lines.append(_prom_line(f"{name}_count", base,
                                        v.get("count", 0)))
            else:
                lines.append(_prom_line(name, base, v))
    if not lines:
        return ""
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
