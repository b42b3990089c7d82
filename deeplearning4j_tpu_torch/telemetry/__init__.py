"""Unified telemetry of the port: metrics registry + host-side span tracing.

The port of ``deeplearning4j_tpu/telemetry/``'s core (its ``__init__``,
``registry``, ``tracectx``, ``tracing``, ``flight``, ``devices``,
``timeline`` and ``profiling``), with the training telemetry that came
first (``scorepipe``, ``health``):

* ``get_registry()`` — process-wide MetricsRegistry (counters, gauges,
  fixed-bucket histograms; JSONL + Prometheus exporters). Instrumented
  layers: the fit loops and the StepDriver (step/ETL time, score,
  iterations), the serving engine (requests, latency, batch fill), the
  parallel trainers and the TrainingMasters (collective and round time),
  the dataset iterators (prefetch stalls) and sharded checkpoints.
* ``span("name")`` — host-side tracing into a Chrome trace-event buffer
  (``get_tracer().export(path)``), forwarded to
  ``torch.profiler.record_function`` while a profiler session collects, so
  host spans line up with the CUDA kernels they launched.
* ``tracectx`` — causal trace contexts over those spans: a request/step
  trace carried via contextvars, handed across thread boundaries with
  ``ctx.handoff()`` / ``tracectx.attach(token)``, completed traces
  ringing into the N-slowest-per-root ring.
* ``health`` — numerics watchdog (``health.enable(policy="raise")``).
* ``devices`` — HBM gauges (``device_bytes_in_use``, ``live_array_bytes``)
  and ``recompiles_total``, the CUDA-graph recapture counter.
* ``flight`` — ring-buffer flight recorder of the last N step records;
  auto-dumps JSON on a watchdog anomaly, an uncaught fit exception, or
  SIGTERM (``flight.install_signal_handler()``) into
  ``$DL4J_TPU_FLIGHT_DIR``.
* ``timeline`` — clock-pair offset estimation + the merge of per-process
  trace rings into one time-aligned view (each rank of a process group
  keeps its own registry and ring; ``timeline.merge`` joins them).
* ``profiling`` — windowed ``torch.profiler`` capture around exactly one
  round (``profile_round``; a guarded no-op off a card).
* ``goodput`` — the wall-clock goodput ledger: a training window's seconds
  classified compute|etl_stall|exchange|checkpoint|rollback_lost|idle
  from the fit loops' histograms, plus tokens/s and an MFU estimate
  (``device_peak_flops()`` knows the card by its name).
* ``slo`` — declarative SloRules (windowed rate/ratio/threshold,
  multi-window burn rate, EWMA drift) evaluated over the local registry,
  a federated merge or a history sample, into ok|warning|firing verdicts
  counted in ``slo_alerts_total{rule,state}``; the flight dumps name the
  burning rules.
* ``history`` — a bounded ring of registry snapshots with atomic JSONL
  segments (``DL4J_TPU_HISTORY_DIR``), range queries and counter-safe
  ``rate_over``; the demand signal ``datasets.iterator.ShapeBuckets.
  from_demand`` reads.
* ``federate`` — several processes' registries merged under stable
  ``instance`` labels, a dead member counted, never a hang.
* ``reset()`` — drop all recorded state across the subsystem (tests).

The compile-artifact tier's events and cold-start gauges
(``compile_cache_total``, ``time_to_first_step_ms``,
``time_to_first_request_ms``: ``utils/compile_cache.py``), the kernel
builds (``kernel_builds_total``: ``ops/_build.py``) and the tuning DB's
lookups (``tuning_db_total``: ``tuning/db.py``) record into the same
registry.

Off by default; switch on per process with ``DL4J_TPU_TELEMETRY=1`` or at
runtime::

    from deeplearning4j_tpu_torch import telemetry
    telemetry.enable()
    net.fit(x, y, epochs=2)
    print(telemetry.get_registry().to_prometheus())
    telemetry.get_tracer().export("host_trace.json")

Disabled, the instrumentation costs one branch per site — no allocations,
no clock reads, and never a device->host sync; enabled, no site adds a
device->host sync (scores stay one dispatch late) and none runs inside a
CUDA-graph capture.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.telemetry.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                                         Histogram, MetricsRegistry,
                                                         get_registry, write_jsonl)
from deeplearning4j_tpu_torch.telemetry.tracing import Tracer, get_tracer, span
from deeplearning4j_tpu_torch.telemetry import (devices, federate, flight, goodput, health,
                                                history, profiling, scorepipe, slo, timeline,
                                                tracectx)
from deeplearning4j_tpu_torch.telemetry.health import NumericsError
from deeplearning4j_tpu_torch.telemetry.scorepipe import ScorePipeline
from deeplearning4j_tpu_torch.telemetry.tracectx import TraceContext

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
           "DEFAULT_BUCKETS", "get_registry", "get_tracer", "span",
           "write_jsonl", "enable", "disable", "enabled", "reset",
           "series_map", "train_metrics",
           "health", "devices", "flight", "scorepipe", "ScorePipeline",
           "NumericsError", "tracectx", "TraceContext", "federate", "timeline",
           "profiling", "slo", "goodput", "history"]


def enable():
    """Turn on metrics recording and span tracing process-wide (the
    default registry's ``enabled`` setter flips both)."""
    get_registry().enabled = True


def disable():
    get_registry().enabled = False


def enabled():
    return get_registry().enabled


def reset():
    """Drop every piece of recorded telemetry state — registry series,
    tracer buffer, watchdog state (back to inactive), recapture baselines,
    flight-recorder ring, trace ring, federation targets, the SLO engine,
    the goodput ledger, the metrics history, the usage meter, the
    process-default fleet prober and the compile cache's
    first-step/first-request marks — without discarding instrument
    objects. Does not change the registry's enabled flag."""
    get_registry().reset()
    get_tracer().clear()
    health.get_monitor().reset()
    devices.reset()
    flight.get_recorder().clear()
    tracectx.get_ring().clear()
    tracectx.reset_open_count()
    timeline.clear_source_providers()
    federate.clear_target_providers()
    slo.reset()
    goodput.reset()
    history.reset()
    # lazy: serving imports telemetry back
    from deeplearning4j_tpu_torch.serving import metering as _metering
    _metering.reset()
    from deeplearning4j_tpu_torch.fleet import prober as _prober
    _prober.reset()
    from deeplearning4j_tpu_torch.utils import compile_cache as _cc
    _cc.reset_marks()


def series_map(name):
    """``{"label=value|label2=value2": value}`` flattening of one metric's
    series (``""`` keys an unlabeled series; ``{}`` when the metric does
    not exist)."""
    m = get_registry().get(name)
    if m is None:
        return {}
    return {("|".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
             or ""): s["value"] for s in m.snapshot()["series"]}


def train_metrics():
    """(registry, step_hist, etl_hist, iterations_counter, score_gauge) —
    the per-iteration instruments shared by the MultiLayerNetwork and
    ComputationGraph fit loops (the JAX package's names)."""
    reg = get_registry()
    return (reg,
            reg.histogram("train_step_seconds",
                          "wall time of one optimizer step (fit loop)"),
            reg.histogram("train_etl_seconds",
                          "host-side batch assembly/placement per iteration"),
            reg.counter("train_iterations_total",
                        "optimizer iterations completed"),
            reg.gauge("train_score", "last training score (loss)"))
