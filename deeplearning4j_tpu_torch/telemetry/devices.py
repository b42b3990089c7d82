"""Device memory + CUDA-graph capture observability.

The port of ``deeplearning4j_tpu/telemetry/devices.py``. Two failure modes
the metrics tier could not see:

* **HBM creep** — the caching allocator's live bytes grow until an OOM
  kills the run hours in. ``poll_memory()`` samples them into the shared
  registry each recorded iteration: ``device_bytes_in_use`` from
  ``torch.cuda.memory_allocated`` per card, ``device_bytes_limit`` from
  ``torch.cuda.mem_get_info`` (read once a card: the capacity does not
  move), and ``live_array_bytes`` (the bytes of live tensors over every
  card: the JAX module's live-array census). None of these reads waits on
  the card. On the CPU there is nothing to poll: the walk latches off.
* **Recapture storms** — the port's counterpart of XLA's recompiles: a
  K-step engine (``nn/fused.py``) or a word2vec chunk (``_ChunkSteps``)
  captures one CUDA graph a signature, and a capture per dispatch turns a
  microseconds replay into a capture and warm-up each time.
  ``note_jit_cache(site, engine)`` reads the engine's ``captures``; growth
  beyond the first counts into ``recompiles_total{site=...}``.

``step_peak_stats(step)`` runs one step with the card's peak counter reset
and reads ``max_memory_allocated`` around it: XLA's compiled memory
analysis has no counterpart here, so the peak is measured, not planned.

Everything here is registry-gated: with telemetry disabled these functions
are never called by the instrumented loops, and calling them anyway records
nothing.
"""

from __future__ import annotations

import threading

import torch

from deeplearning4j_tpu_torch.telemetry import registry as _registry

#: recaptures-per-site at which a health report flips to "warn": a couple
#: are normal warm-up (a ragged final batch, replaced tensors after a
#: restore); a storm is one per dispatch
RECOMPILE_STORM_THRESHOLD = 8

_lock = threading.Lock()
_cache_sizes = {}        # (site, id(engine)) -> last observed captures
_mem_unsupported = False  # latched: no card to poll
_limits = {}             # card index -> capacity bytes
_train_bytes = {}        # site -> last note_train_tree_bytes snapshot
_step_peak = {}          # site -> last note_step_peak_bytes snapshot


def reset():
    """Drop capture baselines + the memory-support latch (test isolation;
    part of telemetry.reset())."""
    global _mem_unsupported
    with _lock:
        _cache_sizes.clear()
        _train_bytes.clear()
        _step_peak.clear()
        _limits.clear()
        _mem_unsupported = False


def _instruments():
    reg = _registry.get_registry()
    return (reg,
            reg.gauge("device_bytes_in_use",
                      "per-device HBM bytes in use (memory_allocated), "
                      "labeled by device"),
            reg.gauge("device_bytes_limit",
                      "per-device HBM capacity bytes, labeled by device"),
            reg.gauge("live_array_bytes",
                      "total bytes of live tensors on the cards of this process"),
            reg.counter("compiles_total",
                        "CUDA graphs captured, labeled by site "
                        "(first-fill warm-up included)"),
            reg.counter("recompiles_total",
                        "CUDA-graph captures beyond the first fill, labeled "
                        "by site — a rising series is a recapture storm"))


def _cards():
    return range(torch.cuda.device_count()) if torch.cuda.is_available() else range(0)


def _limit(i):
    if i not in _limits:
        _limits[i] = int(torch.cuda.mem_get_info(i)[1])  # graftlint: disable=R5 -- called only for the cards _cards() yields
    return _limits[i]


def poll_memory(include_live_arrays=True):
    """Sample device memory into the shared registry gauges.

    Returns a small dict (``live_array_bytes``, ``device_bytes_in_use``:
    max across cards) for callers that want the numbers inline (the fit
    loops put them on flight-recorder step records), or ``None`` when the
    registry is disabled.
    """
    global _mem_unsupported
    reg, g_use, g_lim, g_live, _, _ = _instruments()
    if not reg.enabled:
        return None
    out = {}
    if _mem_unsupported:
        return out
    cards = _cards()
    if not len(cards):
        _mem_unsupported = True  # don't re-probe every step
        return out
    uses = []
    for i in cards:
        use = int(torch.cuda.memory_allocated(i))
        g_use.set(use, device=f"cuda:{i}")
        g_lim.set(_limit(i), device=f"cuda:{i}")
        uses.append(use)
    out["device_bytes_in_use"] = max(uses)
    if include_live_arrays:
        g_live.set(sum(uses))
        out["live_array_bytes"] = sum(uses)
    return out


def memory_summary():
    """Registry-independent snapshot — ``{devices: {dev: {bytes_in_use,
    bytes_limit, peak_bytes, reserved_bytes}}, live_array_bytes}`` — for
    bench records and health reports. The CPU yields an empty ``devices``
    map, never an error."""
    out = {"devices": {}, "live_array_bytes": 0}
    for i in _cards():
        stats = torch.cuda.memory_stats(i)
        out["devices"][f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_limit": _limit(i),
            "peak_bytes": int(torch.cuda.max_memory_allocated(i)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0))}
        out["live_array_bytes"] += out["devices"][f"cuda:{i}"]["bytes_in_use"]
    return out


def tree_shard_bytes(tree):
    """``(logical_bytes, per_device_bytes)`` for a tree of tensors. A rank
    of the port's parallel trainers stores its own shards as plain tensors,
    so both count what the tree holds here (the JAX module reads the
    logical size off a global array's sharding)."""
    from deeplearning4j_tpu_torch.utils.trees import tree_leaves
    n = 0
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            n += t.numel() * t.element_size()
        elif hasattr(t, "nbytes"):
            n += int(t.nbytes)
    return n, n


def note_train_tree_bytes(params=None, opt_state=None, site="trainer"):
    """Record the HBM ledger of a training job's persistent trees:
    ``param_bytes`` / ``opt_state_bytes`` gauges labeled
    ``{site, scope=logical|per_device}`` plus a registry-independent
    snapshot (``train_memory_summary``). Returns the snapshot dict."""
    snap = {}
    if params is not None:
        lg, pd = tree_shard_bytes(params)
        snap["param_bytes"] = {"logical": lg, "per_device": pd}
    if opt_state is not None:
        lg, pd = tree_shard_bytes(opt_state)
        snap["opt_state_bytes"] = {"logical": lg, "per_device": pd}
    with _lock:
        _train_bytes[site] = snap
    reg = _registry.get_registry()
    if reg.enabled:
        for name, vals in snap.items():
            g = reg.gauge(name,
                          "bytes of the training job's persistent "
                          f"{'params' if name.startswith('param') else 'updater state'}"
                          ", labeled by site and scope (logical = every "
                          "element once; per_device = this rank's resident "
                          "bytes — ~1/N under a ZeRO/FSDP layout)")
            for scope, v in vals.items():
                g.set(float(v), site=site, scope=scope)
    return snap


def step_peak_stats(step, device=None):
    """Run ``step()`` once with the card's peak counter reset and return
    ``{argument_bytes, peak_bytes, temp_bytes, output_bytes}``: the bytes
    allocated before it, the most allocated during it, their difference
    (the step's scratch: activations, gathered parameters) and what stays
    allocated after it, less what was there before. None off a card (the
    step still runs). Synchronizes the card before and after: call it
    outside the timed steps."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else None)
    if dev is None or dev.type != "cuda":
        step()
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = int(torch.cuda.memory_allocated(dev))
    step()
    torch.cuda.synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev))
    after = int(torch.cuda.memory_allocated(dev))
    return {"argument_bytes": before, "peak_bytes": peak, "temp_bytes": peak - before,
            "output_bytes": max(after - before, 0)}


def note_step_peak_bytes(site, stats, layout="default"):
    """Export a step's memory ledger (``step_peak_stats``'s dict) into
    ``step_peak_bytes{site, layout, component}`` gauges plus the
    registry-independent snapshot ``train_memory_summary`` folds in.
    Returns the stats dict, or None (no ledger — nothing recorded)."""
    if stats is None:
        return None
    snap = dict(stats, layout=str(layout))
    with _lock:
        _step_peak[site] = snap
    reg = _registry.get_registry()
    if reg.enabled:
        g = reg.gauge("step_peak_bytes",
                      "measured memory ledger of one train step "
                      "(max_memory_allocated around it), labeled by site, "
                      "storage layout and component (temp = scratch incl. "
                      "gathered params; peak = the most allocated during "
                      "the step)")
        for comp in ("temp", "argument", "output", "peak"):
            g.set(float(stats[f"{comp}_bytes"]), site=site, layout=str(layout),
                  component=comp)
    return stats


def train_memory_summary():
    """{site: {param_bytes: {logical, per_device}, opt_state_bytes: ...,
    step_peak_bytes: {...}}} — the last note_train_tree_bytes /
    note_step_peak_bytes snapshots per site, registry-independent."""
    with _lock:
        out = {k: dict(v) for k, v in _train_bytes.items()}
        for site, snap in _step_peak.items():
            out.setdefault(site, {})["step_peak_bytes"] = dict(snap)
    return out


def note_jit_cache(site, engine):
    """Observe a capturing engine's CUDA-graph count after a call (its
    ``captures``: ``nn/fused.py``'s K-step engines, word2vec's
    ``_ChunkSteps``).

    The first observation baselines the expected warm-up capture(s); any
    growth after that is a recapture at a site that should be steady-state
    — counted into ``recompiles_total{site=...}``. Keyed by (site, engine)
    so two networks sharing a site name each get their own baseline.
    Returns the number of NEW recaptures seen (0 on baseline or an engine
    without a count)."""
    size = getattr(engine, "captures", None)
    if size is None:
        return 0
    key = (site, id(engine))
    with _lock:
        last = _cache_sizes.get(key)
        _cache_sizes[key] = size
    reg, *_, c_comp, c_rec = _instruments()
    if last is None:
        if size:
            c_comp.inc(size, site=site)
        return 0
    new = size - last
    if new <= 0:
        return 0
    c_comp.inc(new, site=site)
    c_rec.inc(new, site=site)
    return new


def recompile_counts():
    """{site: recaptures} from the shared registry."""
    reg = _registry.get_registry()
    c = reg.get("recompiles_total")
    if c is None:
        return {}
    return {ls.get("site", ""): c.value(**ls) for ls in c.labelsets()}
