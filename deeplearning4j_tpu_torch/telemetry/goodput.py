"""Wall-clock goodput ledger: where every second of a training run went.

The port of ``deeplearning4j_tpu/telemetry/goodput.py``. MFU and tokens/s
say how fast the compute was; this ledger says how much of the wall clock
was compute at all, classified from the instruments the fit loops already
emit (no new timer on the step path):

* ``compute``       — Δ ``train_step_seconds``.sum, minus seconds later
                      invalidated;
* ``etl_stall``     — Δ ``train_etl_seconds``.sum (host-side batch
                      assembly and placement between steps);
* ``exchange``      — noted collective/exchange seconds;
* ``checkpoint``    — noted snapshot/bundle-write seconds
                      (``StepDriver.checkpoint`` notes its own);
* ``rollback_lost`` — noted compute seconds invalidated by a rollback,
                      subtracted from ``compute``;
* ``idle``          — the window's remainder.

The categories sum to the window by construction (up to the skew between
the histograms' timers and the window's clock). On top: tokens/s
(``note_tokens``) and an MFU estimate, flops per step x steps / (window x
peak FLOP/s). Noted seconds also count into
``goodput_seconds_total{category}``, so the SLO engine can rule on them.

The process-default ledger (``get_ledger()``) opens with the first
instrumented ``StepDriver``; ``start()`` rebases the window.
``device_peak_flops()`` knows the card by its CUDA device name.
"""

from __future__ import annotations

import threading
import time

from deeplearning4j_tpu_torch.telemetry import registry as _registry

#: classification buckets, in display order
CATEGORIES = ("compute", "etl_stall", "exchange", "checkpoint", "rollback_lost", "idle")

#: categories note() accepts; noted compute/etl_stall seconds ADD to the
#: deltas derived from the train histograms (loops without instrumented
#: drivers time their own round edges)
NOTED = ("compute", "etl_stall", "exchange", "checkpoint", "rollback_lost")

#: dense bf16 peak FLOP/s of one card, by ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheet: H100 SXM5, 700 W)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989.4e12}


class GoodputLedger:
    """Wall-clock classification of a training window (thread-safe)."""

    def __init__(self, registry=None):
        self._reg = registry or _registry.get_registry()
        self._lock = threading.Lock()
        self._t0 = None
        self._base_step_sum = 0.0
        self._base_etl_sum = 0.0
        self._base_steps = 0
        self._noted = {k: 0.0 for k in NOTED}
        self._tokens = 0.0
        self._flops_per_step = None
        self._peak_flops = None
        self._m_noted = self._reg.counter(
            "goodput_seconds_total",
            "wall seconds noted into the goodput ledger by category "
            "(exchange / checkpoint / rollback_lost)")

    # ---- lifecycle ----

    @property
    def active(self):
        with self._lock:
            return self._t0 is not None

    def _hists(self):
        reg = self._reg
        return (reg.histogram("train_step_seconds", "wall time of one optimizer step (fit loop)"),
                reg.histogram("train_etl_seconds",
                              "host-side batch assembly/placement per iteration"))

    def start(self, now=None):
        """(Re)base the window at ``now``: later snapshots cover only work
        from here on. Carries no category seconds across."""
        step_h, etl_h = self._hists()
        with self._lock:
            self._t0 = time.monotonic() if now is None else float(now)
            self._base_step_sum = float(step_h.sum())
            self._base_etl_sum = float(etl_h.sum())
            self._base_steps = int(step_h.count())
            self._noted = {k: 0.0 for k in NOTED}
            self._tokens = 0.0
        return self

    def ensure_started(self, now=None):
        """start() only if the window is not open yet (what the instrumented
        StepDriver calls, so any fit loop gets a ledger without wiring)."""
        with self._lock:
            started = self._t0 is not None
        if not started:
            self.start(now=now)
        return self

    # ---- accounting ----

    def note(self, category, seconds):
        """Attribute ``seconds`` of the window to an explicit category; a
        no-op while the window is closed or for non-positive amounts."""
        if category not in NOTED:
            raise ValueError(f"goodput category {category!r} is derived or unknown; "
                             f"note() takes one of {NOTED}")
        s = float(seconds)
        if s <= 0:
            return
        with self._lock:
            if self._t0 is None:
                return
            self._noted[category] += s
        if self._reg.enabled:
            self._m_noted.inc(s, category=category)

    def note_tokens(self, n):
        """Count ``n`` training tokens (or examples: the caller picks the
        unit) into the window for the tokens/s line."""
        if n <= 0:
            return
        with self._lock:
            if self._t0 is None:
                return
            self._tokens += float(n)

    def set_flops_per_step(self, flops):
        """Analyzed FLOPs of one optimizer step: enables the MFU estimate."""
        with self._lock:
            self._flops_per_step = None if flops is None else float(flops)

    def set_peak_flops(self, flops):
        """Aggregate peak FLOP/s of the cards under this run."""
        with self._lock:
            self._peak_flops = None if flops is None else float(flops)

    # ---- reporting ----

    def snapshot(self, now=None):
        """The goodput block: per-category seconds and fractions summing to
        the window, tokens/s, steps, MFU (None without flops)."""
        step_h, etl_h = self._hists()
        step_sum, etl_sum = float(step_h.sum()), float(etl_h.sum())
        steps = int(step_h.count())
        with self._lock:
            if self._t0 is None:
                return {"active": False}
            t = time.monotonic() if now is None else float(now)
            window = max(t - self._t0, 0.0)
            noted = dict(self._noted)
            tokens = self._tokens
            fps = self._flops_per_step
            peak = self._peak_flops
            d_step = max(step_sum - self._base_step_sum, 0.0)
            d_etl = max(etl_sum - self._base_etl_sum, 0.0)
            d_steps = max(steps - self._base_steps, 0)
        gross_compute = d_step + noted["compute"]
        rollback_lost = min(noted["rollback_lost"], gross_compute)
        compute = gross_compute - rollback_lost
        seconds = {"compute": compute, "etl_stall": d_etl + noted["etl_stall"],
                   "exchange": noted["exchange"], "checkpoint": noted["checkpoint"],
                   "rollback_lost": rollback_lost}
        seconds["idle"] = max(window - sum(seconds.values()), 0.0)
        out = {
            "active": True,
            "window_s": window,
            "seconds": {k: round(seconds[k], 6) for k in CATEGORIES},
            "fractions": {k: (round(seconds[k] / window, 6) if window > 0 else 0.0)
                          for k in CATEGORIES},
            "goodput_fraction": round(compute / window, 6) if window > 0 else 0.0,
            "steps": d_steps,
            "tokens": tokens,
            "tokens_per_s": round(tokens / window, 3) if window > 0 and tokens else 0.0,
            "mfu": None,
            "flops_per_step": fps,
        }
        if fps and peak and window > 0:
            out["mfu"] = round(fps * d_steps / (window * peak), 6)
        return out


# ---- process-default ledger ----

_default_ledger = None
_default_lock = threading.Lock()


def get_ledger():
    global _default_ledger
    with _default_lock:
        if _default_ledger is None:
            _default_ledger = GoodputLedger()
        return _default_ledger


def reset():
    """Drop the process-default ledger (telemetry.reset())."""
    global _default_ledger
    with _default_lock:
        _default_ledger = None


def device_peak_flops():
    """Aggregate dense bf16 peak FLOP/s of the visible cards for the MFU
    denominator: the per-card figure of a known device name
    (``PEAK_BF16_FLOPS``) times the device count; None without a card or
    for another name, so MFU is never built on a guess."""
    import torch

    if not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    per = PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(0)) if n else None
    return None if per is None else per * n
