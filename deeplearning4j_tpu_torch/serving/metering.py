"""Per-model / per-tenant usage metering: who is consuming the device.

The port of ``deeplearning4j_tpu/serving/metering.py``. The serving engine
counts outcomes (submitted/served/shed); :class:`UsageMeter` attributes
consumption: the rows, input elements, real and padded sequence tokens,
queue seconds, device seconds and estimated FLOPs each model (and each
tenant, from ``submit(tenant=)``) burned.

Two views of the same numbers, recorded per served request:

* an in-process ledger (always on, also with telemetry off) whose
  per-model rows equal the rows the engine served. Synthetic
  ``origin=probe`` traffic IS metered: device time is device time; it is
  kept out of SLIs at the metric-label layer, not here;
* ``usage_*_total{model,tenant}`` counters in the MetricsRegistry, so the
  federation, history and SLO planes can rate and window them.

The engine records on its worker thread from host numbers it already has
(rows, the forward's host wall time): metering adds no device sync.
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.telemetry import registry as _registry

#: ledger label for unattributed traffic (no tenant field on submit)
NO_TENANT = "-"

_FIELDS = ("rows", "tokens", "seq_tokens", "padded_tokens",
           "queue_seconds", "device_seconds", "flops")


class UsageMeter:
    """Accumulate per-(model, tenant) usage; export ledger + counters."""

    def __init__(self, registry=None):
        self._reg = registry or _registry.get_registry()
        self._lock = threading.Lock()
        self._ledger = {}  # (model, tenant) -> {field: total}
        self._m = {
            "rows": self._reg.counter(
                "usage_rows_total",
                "rows served per model and tenant (equal to the rows "
                "the engine served)"),
            "tokens": self._reg.counter(
                "usage_tokens_total",
                "input elements consumed per model and tenant"),
            "seq_tokens": self._reg.counter(
                "usage_seq_tokens_total",
                "REAL sequence tokens served per model and tenant "
                "(rows x real steps; rows on batch-only models)"),
            "padded_tokens": self._reg.counter(
                "usage_padded_tokens_total",
                "PADDED sequence tokens the device ran per model and "
                "tenant (batch_bucket x seq_bucket per chunk, prorated "
                "by rows) — minus usage_seq_tokens_total this is the "
                "padded-waste column the 2-D shape grid exists to cut"),
            "queue_seconds": self._reg.counter(
                "usage_queue_seconds_total",
                "seconds requests spent queued per model and tenant"),
            "device_seconds": self._reg.counter(
                "usage_device_seconds_total",
                "device-exec seconds attributed per model and tenant "
                "(forward wall prorated by rows)"),
            "flops": self._reg.counter(
                "usage_flops_total",
                "estimated forward FLOPs per model and tenant "
                "(2 * params * padded rows, prorated)"),
        }

    def record(self, model, *, rows=0, tokens=0, seq_tokens=0,
               padded_tokens=0, queue_s=0.0, device_s=0.0, flops=0.0,
               tenant=None):
        """One request's consumption. Negative clock skew is clamped —
        the ledger is monotone by construction. ``seq_tokens`` /
        ``padded_tokens`` are the real-vs-padded sides of the seq-axis
        waste column (engine worker; zero on paths that predate it)."""
        model = str(model)
        tenant = NO_TENANT if tenant is None else str(tenant)
        vals = {"rows": max(int(rows), 0),
                "tokens": max(int(tokens), 0),
                "seq_tokens": max(float(seq_tokens), 0.0),
                "padded_tokens": max(float(padded_tokens), 0.0),
                "queue_seconds": max(float(queue_s), 0.0),
                "device_seconds": max(float(device_s), 0.0),
                "flops": max(float(flops), 0.0)}
        with self._lock:
            row = self._ledger.setdefault(
                (model, tenant), {f: 0.0 for f in _FIELDS})
            for f in _FIELDS:
                row[f] += vals[f]
        if self._reg.enabled:
            for f in _FIELDS:
                if vals[f]:
                    self._m[f].inc(vals[f], model=model, tenant=tenant)

    def usage(self):
        """The usage doc: per-model totals with a per-tenant
        breakdown, plus the grand totals."""
        with self._lock:
            items = [(k, dict(v)) for k, v in self._ledger.items()]
        models = {}
        totals = {f: 0.0 for f in _FIELDS}
        for (model, tenant), vals in sorted(items):
            m = models.setdefault(model, {f: 0.0 for f in _FIELDS})
            m.setdefault("tenants", {})
            m["tenants"][tenant] = {f: _num(vals[f]) for f in _FIELDS}
            for f in _FIELDS:
                m[f] += vals[f]
                totals[f] += vals[f]
        for m in models.values():
            for f in _FIELDS:
                m[f] = _num(m[f])
        return {"models": models,
                "totals": {f: _num(totals[f]) for f in _FIELDS}}

    def rows_for(self, model):
        """Total metered rows for one model (the ledger-balance probe)."""
        with self._lock:
            return int(sum(v["rows"] for (m, _t), v in self._ledger.items()
                           if m == str(model)))

    def clear(self):
        with self._lock:
            self._ledger.clear()


def _num(v):
    """Integral floats print as ints in JSON (rows/tokens are counts)."""
    return int(v) if float(v).is_integer() else float(v)


def estimate_flops(param_count, padded_rows, *, padded_tokens=None):
    """Dense-forward estimate from the registered shapes: 2 FLOPs per
    parameter per padded row (multiply + add). Deliberately crude — a
    ranking signal for attribution, not a performance model; padding is
    charged because padding burns the device all the same. With
    ``padded_tokens`` (2-D shape buckets) the charge is per padded
    ``batch_bucket x seq_bucket`` TOKEN instead — on a batch-only engine
    the two are the same number (seq bucket 1), so the ledger's FLOPs
    column falls exactly when the seq grid stops padding to max_seq."""
    units = padded_rows if padded_tokens is None else padded_tokens
    return 2.0 * float(param_count) * float(units)


# ---- process-default meter ----

_default = None
_default_lock = threading.Lock()


def get_meter():
    """Process-default meter, created on first use (every ServingEngine
    records into it, so one process = one ledger)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = UsageMeter()
        return _default


def reset():
    """Drop the process-default meter (telemetry.reset())."""
    global _default
    with _default_lock:
        _default = None
