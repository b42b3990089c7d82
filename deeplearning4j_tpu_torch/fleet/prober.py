"""Synthetic monitoring: the fleet judged from OUTSIDE, even at zero load.

The port of ``deeplearning4j_tpu/fleet/prober.py`` (host code, numpy
only).

Every SLI the metrics plane holds is self-reported by the process being
judged; a fleet serving nothing reports nothing. :class:`FleetProber`
closes that gap: a loop submits known-answer canary requests through the
full submit path (a :class:`~deeplearning4j_tpu_torch.fleet.FleetRouter`'s
wire hop included), checks the answers against pinned references within
a tolerance, and publishes verdict-labeled counters plus a probe latency
series — so "the fleet is up AND answering correctly" is measured
continuously, and a wrong model swap or a dead pool fires the
``probe_failure_ratio`` SLO gate rule within one window even when no
organic request would have noticed.

Isolation discipline: every canary is submitted ``origin="probe"`` and
rides that label end-to-end (router → wire → worker → engine), so its
request/latency/shed series are DISTINCT from the organic ones and every
default SLO rule excludes them — a prober storm cannot move an organic
SLI, and an idle fleet's organic series stay exactly zero while
``probe_total`` advances.

Verdicts (the ``probe_total{model,verdict}`` label):

* ``ok`` — answered within tolerance;
* ``wrong_answer`` — answered, but off the pinned reference;
* ``shed`` — admission control shed the canary (queue_full/deadline);
* ``unreachable`` — no live worker / shutdown / timeout: counted, NEVER
  a hang (every wait is bounded by ``timeout_s``);
* ``error`` — the submit path raised something else.

``extra_probes`` extends the loop beyond inference: ``(name, fn)``
pairs where ``fn()`` returning truthy is ok — e.g. a canary train-step
probe against the continuous loop's registry handoff.

For a 2-D (batch × seq) serving grid, :func:`seq_sweep_canaries` builds
the canary set at varied sequence lengths (shortest bucket, just under
the median bucket, the max bucket) so the outside-in correctness floor
exercises seq-bucket selection AND the pad-then-slice round trip — a
wrong 2-D bucket or a bad seq slice is a ``wrong_answer`` verdict, not
a silent waste regression.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.serving.engine import (ServingOverloaded,
                                                     ServingShutdown,
                                                     shed_reason)

#: verdicts a canary probe can land on (the probe_total label values)
VERDICTS = ("ok", "wrong_answer", "shed", "unreachable", "error")


class FleetProber:
    """Known-answer canary loop over one submit target.

    ``target`` is anything with the engine-shaped ``submit(x, batched=,
    tenant=, origin=)`` -> future contract (ServingEngine, FleetRouter).
    ``canaries``: dicts with ``x`` (one example or, with ``batched``,
    an ``[n, ...]`` batch), ``expect`` (the pinned reference output),
    optional ``name`` and ``model`` (metric label; defaults to the
    target's model name)."""

    def __init__(self, target, canaries, *, interval_s=15.0, tol=1e-6,
                 timeout_s=10.0, deadline_s=None, extra_probes=(),
                 registry=None):
        self.target = target
        self.canaries = [dict(c) for c in canaries]
        for i, c in enumerate(self.canaries):
            c.setdefault("name", f"canary{i}")
            c.setdefault("model", getattr(target, "name", "default"))
        self.interval_s = float(interval_s)
        self.tol = float(tol)
        self.timeout_s = float(timeout_s)
        self.deadline_s = deadline_s
        self.extra_probes = list(extra_probes)
        self._reg = registry or _tm.get_registry()
        self._lock = threading.Lock()
        self._last = {}     # probe name -> last verdict doc
        self._rounds = 0
        self._thread = None
        self._stop = threading.Event()
        self._m_total = self._reg.counter(
            "probe_total",
            "synthetic canary probes by model and verdict (ok/"
            "wrong_answer/shed/unreachable/error)")
        self._m_bad = self._reg.counter(
            "probe_bad_total",
            "synthetic canary probes with any non-ok verdict, per model "
            "(the probe_failure_ratio SLO rule's numerator)")
        self._m_latency = self._reg.histogram(
            "probe_latency_seconds",
            "submit-to-answer latency of synthetic canaries, per model "
            "(the externally-measured serving latency floor)")
        if self._reg.enabled:
            # pre-register every verdict series at zero: the SLO delta
            # discipline ignores a series' FIRST appearance, so a
            # failure series born mid-storm would contribute nothing
            # that interval and delay the probe_failure_ratio gate by a
            # full window
            for model in {c["model"] for c in self.canaries}:
                self._m_bad.inc(0, model=model)
                for verdict in VERDICTS:
                    self._m_total.inc(0, model=model, verdict=verdict)

    # ---- one probe round ----

    def _verdict_of(self, canary):
        """Run one canary through the full submit path. Returns
        (verdict, latency_s_or_None, detail)."""
        t0 = time.perf_counter()
        try:
            fut = self.target.submit(canary["x"],
                                     deadline_s=self.deadline_s,
                                     batched=bool(canary.get("batched")),
                                     tenant=canary.get("tenant"),
                                     origin="probe")
            y = fut.get(timeout=self.timeout_s)
        except ServingOverloaded as e:
            reason = shed_reason(e) or "queue_full"
            if reason == "no_worker":
                # the whole pool is down — that is unreachability, not
                # load shedding (an idle dead fleet has no load to shed)
                return "unreachable", None, reason
            return "shed", None, reason
        except ServingShutdown as e:
            return "unreachable", None, str(e)[:200]
        except TimeoutError as e:
            # a bounded wait that expired: counted, never a hang
            return "unreachable", None, str(e)[:200] or "timeout"
        except Exception as e:  # noqa: BLE001 — verdict, not crash
            return "error", None, f"{type(e).__name__}: {e}"[:200]
        dt = time.perf_counter() - t0
        try:
            got = np.asarray(y, dtype=np.float64)
            want = np.asarray(canary["expect"], dtype=np.float64)
            if got.shape != want.shape:
                return ("wrong_answer", dt,
                        f"shape {got.shape} != {want.shape}")
            err = float(np.max(np.abs(got - want))) if got.size else 0.0
        except Exception as e:  # noqa: BLE001 — uncomparable answer
            return "wrong_answer", dt, f"uncomparable: {e}"[:200]
        if err > self.tol:
            return "wrong_answer", dt, f"max|err|={err:.3e}>{self.tol:g}"
        return "ok", dt, f"max|err|={err:.3e}"

    def probe_once(self):
        """One full round over every canary + extra probe; returns the
        verdict docs (also retained for ``status()``)."""
        results = []
        for canary in self.canaries:
            verdict, dt, detail = self._verdict_of(canary)
            results.append({"probe": canary["name"],
                            "model": canary["model"],
                            "verdict": verdict, "detail": detail,
                            "latency_ms": (None if dt is None
                                           else round(1e3 * dt, 3))})
            if self._reg.enabled:
                self._m_total.inc(model=canary["model"], verdict=verdict)
                if verdict != "ok":
                    self._m_bad.inc(model=canary["model"])
                if dt is not None:
                    self._m_latency.observe(dt, model=canary["model"])
        for name, fn in self.extra_probes:
            try:
                verdict = "ok" if fn() else "wrong_answer"
                detail = None
            except Exception as e:  # noqa: BLE001 — verdict, not crash
                verdict, detail = "error", f"{type(e).__name__}: {e}"[:200]
            results.append({"probe": name, "model": name,
                            "verdict": verdict, "detail": detail,
                            "latency_ms": None})
            if self._reg.enabled:
                self._m_total.inc(model=name, verdict=verdict)
                if verdict != "ok":
                    self._m_bad.inc(model=name)
        with self._lock:
            self._rounds += 1
            for r in results:
                self._last[r["probe"]] = r
        return results

    # ---- lifecycle / status ----

    def start(self):
        """Probe every ``interval_s`` on a daemon thread (first round
        fires immediately — a fresh fleet gets its verdict now, not one
        interval late)."""
        if self._thread is not None:
            return self

        def loop():
            while not self._stop.is_set():
                try:
                    self.probe_once()
                except Exception:  # the prober must never kill the host
                    pass
                if self._stop.wait(self.interval_s):
                    return

        self._stop.clear()  # graftlint: disable=R6 -- threading.Event is internally synchronized; self._lock guards probe state, not lifecycle
        self._thread = threading.Thread(target=loop, name="fleet-prober",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(5.0, self.timeout_s + 1.0))

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def status(self):
        """The prober's slice of /fleet: per-probe last verdicts + loop
        bookkeeping."""
        with self._lock:
            last = dict(self._last)
            rounds = self._rounds
        return {"running": self.running, "interval_s": self.interval_s,
                "tol": self.tol, "rounds": rounds,
                "probes": last,
                "ok": all(r["verdict"] == "ok" for r in last.values())
                if last else None}


def seq_sweep_canaries(reference, feature_shape, seq_buckets, *,
                       model="default", seed=0):
    """Known-answer canaries at varied sequence lengths for a 2-D grid.

    Picks three lengths from ``seq_buckets``: the shortest bucket
    (exact fit), one just UNDER the median bucket (forces a seq-axis pad
    and the slice back to real steps), and the max bucket (the old
    max_seq path). Each canary's ``expect`` is pinned NOW through
    ``reference`` — a callable taking one ``[n, T, ...]`` batch (e.g.
    ``net.output``) — so the prober later judges the serving path
    against the unbucketed forward at probe-build time.

    ``feature_shape``: per-step trailing shape (e.g. ``(n_features,)``);
    inputs are deterministic ``float32`` draws seeded per length, so a
    respawned prober pins identical canaries.
    """
    bs = sorted({int(b) for b in seq_buckets})
    if not bs:
        raise ValueError("seq_sweep_canaries needs a non-empty seq grid")
    lengths = sorted({bs[0], max(1, bs[len(bs) // 2] - 1), bs[-1]})
    canaries = []
    for length in lengths:
        rng = np.random.default_rng(seed + length)
        x = rng.standard_normal(
            (length,) + tuple(feature_shape)).astype(np.float32)
        expect = np.asarray(reference(x[None]))[0]
        canaries.append({"x": x, "expect": expect,
                         "name": f"seq{length}", "model": model})
    return canaries


# ---- process-default prober ----

_default = None
_default_lock = threading.Lock()


def set_default(prober):
    """Install (or clear, with None) the process-default prober — what
    ``fleet_status()`` folds into /fleet. Stops any previous one."""
    global _default
    with _default_lock:
        old, _default = _default, prober
    if old is not None and old is not prober:
        old.stop()
    return prober


def get_default():
    with _default_lock:
        return _default


def status():
    """The default prober's status, or None when none is installed (the
    inert-seam contract: /fleet embeds this without starting anything)."""
    with _default_lock:
        prober = _default
    return None if prober is None else prober.status()


def reset():
    """Drop the process-default prober (telemetry.reset())."""
    set_default(None)
