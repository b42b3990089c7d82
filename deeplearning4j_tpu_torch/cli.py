"""Command-line entry point of the port: the JAX package's verbs but
``bench``.

    python -m deeplearning4j_tpu_torch train --model-path ckpt.zip --data x.npy --labels y.npy \
        --epochs 2 --averaging-frequency 5 --model-output-path out.zip --ui-port 9000
    python -m deeplearning4j_tpu_torch train --zoo lenet --data x.npy --labels y.npy
    python -m deeplearning4j_tpu_torch ui --port 9000
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --max-batch 32 --port 9000
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --smoke 64 --device cpu
    python -m deeplearning4j_tpu_torch serve --model-path dl4j.zip --input-shape 128,96 --smoke 4
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --compile-cache /var/cache/k \
        --warm-manifest ckpt.warm.zip
    python -m deeplearning4j_tpu_torch fleet --model-path ckpt.zip --workers 2 \
        --warm-manifest ckpt.warm.zip --port 9000
    python -m deeplearning4j_tpu_torch eval --model-path ckpt.zip --data x.npy --labels y.npy
    python -m deeplearning4j_tpu_torch eval --model-path ckpt.zip --data test.csv \
        --label-column 784 --n-classes 10
    python -m deeplearning4j_tpu_torch tune --db tuned.json
    python -m deeplearning4j_tpu_torch tune --db tuned.json --smoke --device cpu
    python -m deeplearning4j_tpu_torch continuous --snapshot s.zip --offline-n 8 --device cpu
    python -m deeplearning4j_tpu_torch telemetry --url http://127.0.0.1:9000/metrics
    python -m deeplearning4j_tpu_torch slo --history /var/lib/dl4j/history --gate
    python -m deeplearning4j_tpu_torch traces --cluster --file postmortem_gen0/
    python -m deeplearning4j_tpu_torch flightrec dump.json --last 20
    python -m deeplearning4j_tpu_torch lint --strict-baseline
    python -m deeplearning4j_tpu_torch lint --rules R1,R7 deeplearning4j_tpu_torch/nn
    python -m deeplearning4j_tpu_torch lint --emit-schema
    python -m deeplearning4j_tpu_torch lint --san-report graftsan.json \
        deeplearning4j_tpu_torch/serving deeplearning4j_tpu_torch/telemetry

``train`` resumes a model file (``--model-path``) or builds a zoo model
(``--zoo``) and trains it on ``.npy`` features and labels or a labelled
CSV through ``DistributedMultiLayer``: ``--averaging-frequency 1`` is the
per-step gradient-sharing ``SharedTrainingMaster`` (the exact mean),
``k > 1`` the local-SGD ``ParameterAveragingTrainingMaster``. A worker
is a rank of a ``torch.distributed`` group: ``--workers 1`` trains in
this process, ``N > 1`` spawns N rank processes (``parallel/launch.py``;
on the card each rank takes a card of its own, so N is at most the
cards visible; on the CPU, gloo ranks), ``0`` means every visible card
(one worker on the CPU). ``--ui-port`` attaches a
``StatsListener`` and serves the training dashboard (``ui/``; the ranks
of a spawned job post to it through ``RemoteStatsStorageRouter``).
``ui`` serves the dashboard alone (``POST /remote`` takes records).

``serve`` loads a model file through ``models.zoo.restore_checkpoint``
(the framework's checkpoint zip written by either package, a DL4J
ModelSerializer zip or a Keras HDF5 file; a MultiLayerNetwork or a
ComputationGraph), or a fresh ``--zoo`` model, warms every batch bucket,
and serves with continuous batching and admission control; ``--port``
serves ``/serving`` and ``/metrics`` (the UI server) beside it. The
warmup shape is ``--input-shape`` where given, else the model's input
type; a graph's is one per-example shape per input, from its input
types. A model whose input type leaves a dimension open (a DL4J
recurrent zip stores no sequence length) needs ``--input-shape``.
``--smoke N`` serves N synthetic requests, prints the engine's stats as
JSON (with ``smoke_answers_sha256``, a digest of the answers in request
order) and exits. ``fleet`` serves one model from N worker processes
(``fleet/``) behind one admission and routing front; ``--port`` serves
``/fleet``. ``eval`` runs a model file (or a freshly initialised zoo
model, ``--zoo``) over ``.npy`` features and labels, or over one labelled
CSV, and prints the ``Evaluation`` (or, with ``--regression``, the
``RegressionEvaluation``) statistics; flat rows for an image model are
reshaped to its input image (DL4J's ``InputType.convolutionalFlat``).
``train``, ``serve``, ``fleet`` and ``eval`` run on ``--device``
(default ``cuda``; a missing card raises rather than falling back to the
CPU). ``--port`` defaults to no dashboard (the JAX verbs' default is
9000); ``--port 0`` picks a free one. ``--compile-cache DIR`` (default
``$DL4J_TPU_COMPILE_CACHE``) builds and keeps the kernel libraries in DIR
(``utils/compile_cache.enable_persistent_cache``); ``--warm-manifest
PATH`` warms the buckets from PATH where it exists (no nvcc run, no
tuning lookup) and ``serve`` writes what it warmed back to PATH.
``tune`` searches the kernels' launch plans at the main paths' shapes on
the card and merges the winners into the tuning DB (``--db``, default
``$DL4J_TPU_TUNING_DB``) that the kernels' dispatch seams read from that
variable; ``--smoke`` runs trimmed shapes. ``--device cpu`` runs the
plain versions (a check of the search, the gate and the DB, not of the
kernels), and its winners key under the CPU's backend fingerprint, never
a card's. ``continuous`` forwards every argument after it, unparsed, to
``continuous/runner.py`` (``continuous --help-runner`` prints the runner's
own reference). The reader verbs touch no device: ``telemetry`` dumps the
local registry or scrapes a server's ``/metrics``, ``slo`` prints the SLO
engine's verdicts (live, from a server's ``/slo`` or replayed from a
metrics-history directory), ``traces`` the slow-trace ring (a server's,
flight dumps, a dead generation's post-mortem directory; ``--cluster``
merges them onto one timeline) and ``flightrec`` a flight-recorder dump.
``lint`` runs graftlint (``analysis/``) over the port's package, or over
the given paths, on the CPU: it imports no torch and needs no card. Its
rules R1-R13 are the JAX package's, re-derived for the port's idioms
(host syncs in the step loops, CUDA-graph capture hazards, collectives'
groups, lock order, the wire and metric contracts); the committed
baseline is ``analysis/graftlint.baseline.json`` (empty), ``--emit-schema``
writes ``analysis/schema/SCHEMA.json`` and ``METRICS.md`` inside the
package unless ``--schema-dir`` says otherwise (never the repo root's,
which are the JAX package's), and ``--san-report`` merges a graftsan
runtime report (``analysis/sanitizer.py``) with the static lock graph.
On the card, ``python3 chip_smoke.py --only serve`` run through the chip
tool prints a ``serve.sanitizer`` line: a burst served under the
sanitizer, merged with the static lock graph of ``serving/`` and
``telemetry/``. Not ported: ``bench`` (the port's benchmark comes on its
own).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_parser():
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="PyTorch/CUDA port of deeplearning4j_tpu: train / UI / serve / fleet / lint")
    sub = p.add_subparsers(dest="command", required=True)

    def add_compile_cache(sp):
        sp.add_argument(
            "--compile-cache", metavar="DIR",
            help="persistent kernel cache directory (utils/compile_cache): the CUDA "
                 "libraries are built into DIR and reused by every later process; "
                 "defaults to $DL4J_TPU_COMPILE_CACHE when set")

    t = sub.add_parser("train", help="data-parallel training over the ranks of a process group")
    add_compile_cache(t)
    src = t.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-path", help="model file to resume (any format serve reads)")
    src.add_argument("--zoo", help="zoo model name (e.g. lenet)")
    t.add_argument("--data", required=True, help=".npy features, or a labelled .csv/.dat file")
    t.add_argument("--labels", help=".npy labels (one-hot); unused for CSV")
    t.add_argument("--label-column", type=int, default=-1, help="CSV label column (default: last)")
    t.add_argument("--n-classes", type=int, help="one-hot CSV labels to this many classes")
    t.add_argument("--skip-lines", type=int, default=0, help="CSV header lines to skip")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--workers", type=int, default=0,
                   help="data-axis size, one rank process each (0 = every visible card)")
    t.add_argument("--batch-size-per-worker", type=int, default=32)
    t.add_argument("--averaging-frequency", type=int, default=1,
                   help="1 = per-step gradient mean; k>1 = local SGD with parameter "
                        "averaging every k steps")
    t.add_argument("--no-average-updaters", action="store_true")
    t.add_argument("--model-output-path", help="save checkpoint here")
    t.add_argument("--ui-port", type=int, help="start the training dashboard on this port")
    t.add_argument("--report-score", action="store_true")
    t.add_argument("--device", default="cuda",
                   help="device the ranks train on: cuda (default) or cpu")

    u = sub.add_parser("ui", help="standalone training dashboard server")
    u.add_argument("--port", type=int, default=9000)

    sv = sub.add_parser(
        "serve",
        help="inference server: continuous batching over warmed shape "
             "buckets, bounded admission queue with load shedding")
    add_compile_cache(sv)
    sv.add_argument("--warm-manifest", metavar="PATH",
                    help="warm manifest (utils/compile_cache WarmManifest zip): where PATH "
                         "exists, each bucket warms from it (its kernel libraries "
                         "installed, its launch plans seeded: no nvcc run, no tuning "
                         "lookup); after the warmup the manifest is (re)saved to PATH")
    svsrc = sv.add_mutually_exclusive_group(required=True)
    svsrc.add_argument("--model-path",
                       help="model to serve: a checkpoint zip, a DL4J ModelSerializer zip "
                            "or a Keras HDF5 file")
    svsrc.add_argument("--zoo", help="zoo model name (fresh init)")
    sv.add_argument("--name", default="default",
                    help="model name in the registry (default: 'default')")
    sv.add_argument("--max-batch", type=int, default=32,
                    help="largest serving batch (= largest bucket)")
    sv.add_argument("--buckets",
                    help="comma-separated batch buckets to warm "
                         "(default: powers of two up to --max-batch)")
    sv.add_argument("--seq-buckets",
                    help="comma-separated sequence buckets: a 2-D (batch, seq) grid "
                         "(default: batch buckets only)")
    sv.add_argument("--input-shape",
                    help="per-example feature shape, e.g. 128,96 (default: derived from "
                         "the model's input type)")
    sv.add_argument("--max-queue", type=int, default=256,
                    help="admission queue bound; a full queue sheds "
                         "requests with ServingOverloaded")
    sv.add_argument("--deadline-ms", type=float,
                    help="default request deadline; requests stale in the "
                         "queue past this are shed, not served")
    sv.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="max extra wait to fill a batch once at least one request is in "
                         "hand (ONE shared deadline)")
    sv.add_argument("--port", type=int,
                    help="dashboard/status port (/serving, /metrics); 0 picks a free one "
                         "(default: no dashboard)")
    sv.add_argument("--smoke", type=int, metavar="N",
                    help="serve N synthetic requests, print the stats, and exit")
    sv.add_argument("--device", default="cuda",
                    help="device the forward runs on: cuda (default) or cpu")

    fl = sub.add_parser(
        "fleet",
        help="multi-process serving fleet (fleet/): N worker processes from one "
             "checkpoint + warm manifest behind one admission/routing front with "
             "elastic worker replacement; /fleet status on the dashboard port")
    add_compile_cache(fl)
    flsrc = fl.add_mutually_exclusive_group(required=True)
    flsrc.add_argument("--model-path", help="checkpoint zip every worker serves")
    flsrc.add_argument("--zoo", help="zoo model name (fresh init per worker)")
    fl.add_argument("--workers", type=int, default=2, help="worker processes to spawn (default 2)")
    fl.add_argument("--name", default="default", help="served model name (default: 'default')")
    fl.add_argument("--max-batch", type=int, default=32)
    fl.add_argument("--buckets",
                    help="comma-separated batch buckets each worker warms (default: powers "
                         "of two up to --max-batch)")
    fl.add_argument("--input-shape",
                    help="per-example feature shape, e.g. 28,28,1 (default: derived from "
                         "the model conf)")
    fl.add_argument("--warm-manifest", metavar="PATH",
                    help="serving warm manifest every worker (and every elastic "
                         "replacement) warms from: the no-nvcc respawn contract")
    fl.add_argument("--max-queue", type=int, default=256,
                    help="front admission bound (queued examples); a full front sheds "
                         "with ServingOverloaded")
    fl.add_argument("--max-inflight", type=int, default=64,
                    help="per-worker bounded in-flight window (rows)")
    fl.add_argument("--deadline-ms", type=float,
                    help="default request deadline (front AND workers shed stale requests)")
    fl.add_argument("--port", type=int,
                    help="dashboard/status port (/fleet, /metrics); 0 picks a free one "
                         "(default: no dashboard)")
    fl.add_argument("--smoke", type=int, metavar="N",
                    help="serve N synthetic requests through the fleet, print the front + "
                         "worker status, and exit")
    fl.add_argument("--device", default="cuda",
                    help="device every worker serves on: cuda (default) or cpu")

    e = sub.add_parser("eval", help="evaluate a checkpoint on a dataset")
    add_compile_cache(e)
    esrc = e.add_mutually_exclusive_group(required=True)
    esrc.add_argument("--model-path",
                      help="checkpoint zip, DL4J ModelSerializer zip or Keras HDF5 file")
    esrc.add_argument("--zoo", help="zoo model name (fresh init)")
    e.add_argument("--data", required=True,
                   help=".npy features, or a labelled .csv/.dat file")
    e.add_argument("--label-column", type=int, default=-1,
                   help="the CSV's label column (default: the last)")
    e.add_argument("--n-classes", type=int,
                   help="one-hot the CSV's integer labels over this many classes")
    e.add_argument("--skip-lines", type=int, default=0, help="CSV header lines to skip")
    e.add_argument("--labels", help=".npy labels (one-hot or class indices)")
    e.add_argument("--batch-size", type=int, default=128)
    e.add_argument("--regression", action="store_true",
                   help="report regression metrics instead of classification")
    e.add_argument("--device", default="cuda",
                   help="device the forward runs on: cuda (default) or cpu")

    cn = sub.add_parser(
        "continuous",
        help="continuous-learning loop (continuous/): streaming ingest with bounded "
             "staleness -> watchdog-policed StepDriver rounds with rollback to the last "
             "good bundle -> periodic snapshot and serving hot-swap hand-off; every "
             "argument forwards to continuous.runner (`continuous --help-runner`)")
    cn.add_argument("--help-runner", action="store_true",
                    help="print the runner's own argument reference")
    cn.add_argument("runner_args", nargs=argparse.REMAINDER)

    tn = sub.add_parser(
        "tune",
        help="kernel tuner (tuning/): search the Hopper kernels' launch plans, "
             "parity-gate every candidate against the plain version, and merge the "
             "winners into the tuning DB the dispatch seams read")
    tn.add_argument("--db", metavar="PATH",
                    help="tuning DB JSON to update (default: $DL4J_TPU_TUNING_DB); "
                         "existing entries merge — a re-tune IS the refresh")
    tn.add_argument("--kernels",
                    help="comma-separated kernel subset (attention,conv_matmul,conv3x3,"
                         "lstm; default all)")
    tn.add_argument("--smoke", action="store_true",
                    help="tiny shapes + trimmed candidate sets (a mechanics check)")
    tn.add_argument("--device", default="cuda",
                    help="device the candidates run on: cuda (default), or cpu (the "
                         "plain versions; winners keyed to the CPU)")
    tn.add_argument("--iters", type=int, help="calls per timing window")
    tn.add_argument("--reps", type=int, help="timing windows per candidate (best-of)")

    tl = sub.add_parser(
        "telemetry",
        help="dump a metrics snapshot (local registry, or scrape a "
             "running server's /metrics)")
    tl.add_argument("--url",
                    help="scrape this /metrics endpoint (e.g. "
                         "http://127.0.0.1:9000/metrics) instead of the "
                         "local registry")
    tl.add_argument("--format", choices=("prom", "json", "jsonl"),
                    default="prom",
                    help="local-registry output format (scrapes are always "
                         "the server's Prometheus text)")
    tl.add_argument("--chrome-trace",
                    help="also export the host-span Chrome trace JSON here")

    sl = sub.add_parser(
        "slo",
        help="SLO engine verdicts (telemetry/slo.py): evaluate the "
             "default ruleset over the local registry, or read a "
             "running server's /slo endpoint, and print every rule's "
             "ok|warning|firing state")
    sl.add_argument("--url",
                    help="read this /slo endpoint (e.g. "
                         "http://127.0.0.1:9000/slo — append ?federate=1 "
                         "for the cluster-wide evaluation) instead of "
                         "evaluating the local registry")
    sl.add_argument("--history", metavar="PATH",
                    help="replay a metrics-history dir (or one segment "
                         "file) through the engine before evaluating — "
                         "judge the minutes BEFORE a dump/restart, not "
                         "just the instant of death (the flightrec "
                         "'history' section names the dir)")
    sl.add_argument("--samples", type=int, default=2,
                    help="local mode: evaluation passes (rates need >=2 "
                         "samples spanning time; default 2)")
    sl.add_argument("--interval", type=float, default=2.0,
                    help="local mode: seconds between passes (default 2)")
    sl.add_argument("--gate", action="store_true",
                    help="exit nonzero when any rule is firing "
                         "(scriptable health check)")
    sl.add_argument("--json", action="store_true",
                    help="raw status JSON instead of the table")

    tc = sub.add_parser(
        "traces",
        help="inspect the slow-trace flight ring (telemetry/tracectx.py): "
             "list the slowest complete causal traces per root span and "
             "pretty-print one as an indented timeline")
    tc.add_argument("--url",
                    help="scrape a running server's /traces endpoint "
                         "(e.g. http://127.0.0.1:9000/traces) instead of "
                         "the local ring")
    tc.add_argument("--file", action="append", metavar="PATH",
                    help="read traces from JSON file(s) — a /traces "
                         "payload, a raw ring snapshot, a flight-recorder "
                         "dump (its 'traces' key) — or a DIRECTORY of "
                         "dumps (a dead generation's postmortem). "
                         "Repeatable; every source merges into one view")
    tc.add_argument("--name",
                    help="only this root-span name (e.g. serving.request)")
    tc.add_argument("--trace-id",
                    help="print the timeline of this trace id (the id a "
                         "/metrics exemplar or BENCH worst_trace_id "
                         "points at)")
    tc.add_argument("--cluster", action="store_true",
                    help="merge every source (--file/--url, or the live "
                         "cluster providers when neither is given) into "
                         "ONE time-aligned timeline: per-instance trace "
                         "rows, per-host round clocks, and the stalled "
                         "host of a dead hostfleet generation")
    tc.add_argument("--chrome", metavar="PATH",
                    help="with --cluster: also write the merged timeline "
                         "as a Chrome trace-event file (chrome://tracing "
                         "/ Perfetto)")
    tc.add_argument("--json", action="store_true",
                    help="raw JSON passthrough instead of the timeline")

    fr = sub.add_parser(
        "flightrec",
        help="pretty-print a crash flight-recorder dump "
             "(telemetry/flight.py JSON)")
    fr.add_argument("path", help="dump file written on anomaly/crash/SIGTERM")
    fr.add_argument("--last", type=int, default=10,
                    help="show only the last N step records (default 10; "
                         "0 = all)")
    fr.add_argument("--json", action="store_true",
                    help="raw JSON passthrough instead of the table")

    ln = sub.add_parser(
        "lint",
        help="graftlint: static analysis of the port's step path (hidden "
             "host syncs, CUDA-graph capture hazards, lock order, wire and "
             "metric contracts) — see analysis/")
    ln.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "deeplearning4j_tpu_torch package)")
    ln.add_argument("--rules",
                    help="comma-separated rule subset (e.g. R1,R4); "
                         "default all")
    ln.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ln.add_argument("--format", choices=("human", "json"), default="human")
    ln.add_argument("--baseline",
                    help="baseline file (default: "
                         "deeplearning4j_tpu_torch/analysis/graftlint.baseline.json)")
    ln.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ln.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "and exit 0")
    ln.add_argument("--strict-baseline", action="store_true",
                    help="CI mode: stale baseline entries (fixed debt "
                         "still in the ledger) also fail")
    ln.add_argument("--verbose", action="store_true",
                    help="also print baselined findings")
    ln.add_argument("--diff", metavar="REF",
                    help="pre-commit mode: analyse everything (project "
                         "rules need the whole tree) but only REPORT "
                         "findings whose statement touches a line changed "
                         "vs this git ref (e.g. HEAD, origin/main)")
    ln.add_argument("--emit-schema", action="store_true",
                    help="instead of linting, write the harvested wire+"
                         "metric contract (routes, headers, response "
                         "keys, metric series with label sets) to "
                         "SCHEMA.json and METRICS.md — the same registry "
                         "rules R10/R11/R13 enforce")
    ln.add_argument("--schema-dir", metavar="DIR",
                    help="where --emit-schema writes (default: the port's "
                         "deeplearning4j_tpu_torch/analysis/schema/, never "
                         "the repo root)")
    ln.add_argument("--san-report", metavar="JSON",
                    help="merge a graftsan runtime report (Sanitizer.dump) "
                         "with the static R9 lock graph: maps observed "
                         "acquisition orders onto static lock identities "
                         "and fails on cycles in the MERGED graph — orders "
                         "only runtime saw compose with orders only the "
                         "code declares")
    return p


def _serve_input_spec(args, net):
    """Per-example input shape for warmup: ``--input-shape`` wins (a
    one-input graph takes it for that input), else the model's input type;
    a graph's is a dict of them, one per input. A shape the input type
    leaves open asks for the flag."""
    inputs = getattr(net.conf, "inputs", None)
    if args.input_shape:
        shape = tuple(int(d) for d in args.input_shape.split(",") if d.strip())
        if inputs is None:
            return shape
        if len(inputs) != 1:
            raise SystemExit(f"--input-shape names one shape, but the graph has inputs "
                             f"{list(inputs)}: serve it by its input types")
        return {inputs[0]: shape}
    from deeplearning4j_tpu_torch.nn.conf.inputs import RecurrentType

    types = list(getattr(net.conf, "input_types", None) or [getattr(net.conf, "input_type", None)])
    if any(t is None or (isinstance(t, RecurrentType) and t.timesteps is None) for t in types):
        raise SystemExit("--input-shape is required: the model conf carries no complete input "
                         "type (a sequence length, for a recurrent input) to derive the warmup "
                         "shape from")
    if inputs is not None:
        return {name: tuple(t.shape(1)[1:]) for name, t in zip(inputs, types)}
    return tuple(types[0].shape(1)[1:])


def _smoke_requests(input_spec, n):
    """``n`` synthetic per-example requests (dicts for a graph)."""
    rs = np.random.RandomState(0)
    if isinstance(input_spec, dict):
        xs = {k: rs.rand(n, *spec).astype(np.float32) for k, spec in input_spec.items()}
        return [{k: v[i] for k, v in xs.items()} for i in range(n)]
    return list(rs.rand(n, *input_spec).astype(np.float32))


def _enable_compile_cache(args):
    """Point the kernel builds at --compile-cache (or
    $DL4J_TPU_COMPILE_CACHE) before any kernel is built."""
    from deeplearning4j_tpu_torch.utils import compile_cache as _cc
    cache_dir = _cc.enable_persistent_cache(getattr(args, "compile_cache", None))
    if cache_dir:
        print(f"persistent kernel cache: {cache_dir}")
    return cache_dir


def _ints(text):
    return [int(b) for b in text.split(",") if b.strip()] if text else None


def _cmd_serve(args):
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.serving import (ServingOverloaded,
                                                  get_model_registry)
    from deeplearning4j_tpu_torch.utils import compile_cache as _cc

    telemetry.enable()  # the serving and compile-cache counters are the point of a server
    _enable_compile_cache(args)
    name = args.name
    net = _load_model(args)
    input_spec = _serve_input_spec(args, net)
    # a not-yet-created path is the normal first cold start: the engine
    # reads it leniently (missing -> None, no warning)
    warm_manifest = args.warm_manifest or None
    registry = get_model_registry()
    engine = registry.register(
        name, net, input_spec=input_spec, max_batch_size=args.max_batch,
        buckets=_ints(args.buckets), seq_buckets=_ints(args.seq_buckets),
        max_queue=args.max_queue,
        default_deadline_s=(None if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
        batch_window_s=args.batch_window_ms / 1e3,
        device=args.device, warm_manifest=warm_manifest)
    st = engine.stats()
    aot = st["aot"]
    src = (f"{aot['manifest_hits']} from warm manifest, "
           f"{aot['warmed'] - aot['manifest_hits']} warmed live" if warm_manifest
           else "warmed live")
    print(f"model {name!r}: warmed buckets {st['buckets']} in "
          f"{st['warmup_s']:.2f}s on {st['device']} ({src}; input {input_spec})")
    if args.warm_manifest:
        # (re)save after the warmup, so a cold start makes the next one warm
        manifest = engine.export_warm_manifest()
        if manifest is not None:
            manifest.save(args.warm_manifest)
            print(f"warm manifest: {args.warm_manifest} ({len(manifest)} entries, "
                  f"{len(manifest.libraries())} kernel libraries)")
    ui_server = _start_ui(args.port, "serving status", "/serving")
    try:
        if args.smoke:
            futs, shed = [], 0
            for x in _smoke_requests(input_spec, args.smoke):
                # a burst bigger than --max-queue legitimately sheds: back
                # off briefly and keep going
                for _ in range(1000):
                    try:
                        futs.append(engine.submit(x))
                        break
                    except ServingOverloaded:
                        time.sleep(0.001)
                else:
                    raise SystemExit("smoke: admission queue never drained")
            answers = []
            for f in futs:
                try:
                    answers.append(f.get(timeout=60))
                except ServingOverloaded:
                    shed += 1  # stale-in-queue deadline shed (--deadline-ms)
            if shed:
                print(f"smoke: {shed} request(s) shed by deadline")
            print(json.dumps({**registry.status()["models"][name],
                              "compile_cache": _cc.status(),
                              "smoke_answers_sha256": _digest(answers)}, indent=1))
            return 0
        _wait_for_signal()
    except KeyboardInterrupt:
        pass
    finally:
        registry.stop()
        if ui_server is not None:
            ui_server.stop()
    return 0


def _start_ui(port, what, path):
    """The UI server on ``port`` (None: no dashboard), started."""
    if port is None:
        return None
    from deeplearning4j_tpu_torch.ui import UIServer
    server = UIServer(port=port).start()
    print(f"{what}: http://127.0.0.1:{server.port}{path} (metrics on /metrics)", flush=True)
    return server


def _wait_for_signal():
    """Block until Ctrl-C or SIGTERM (routed through the same clean-stop
    path as Ctrl-C)."""
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt
    signal.signal(signal.SIGTERM, _term)
    while True:
        time.sleep(3600)


def _train_setup(args, world):
    """(x, y, net, master): the data, the model on this rank's device and
    the TrainingMaster over a ``world``-rank data mesh of the default
    group."""
    from deeplearning4j_tpu_torch.parallel import mesh as _mesh
    from deeplearning4j_tpu_torch.parallel.distributed import (
        ParameterAveragingTrainingMaster, SharedTrainingMaster)

    x, y = _load_xy(args)
    net = _load_model(args)
    mesh = _mesh.make_mesh(_mesh.MeshSpec(data=world))
    if args.averaging_frequency <= 1:
        master = SharedTrainingMaster(mesh, batch_size_per_worker=args.batch_size_per_worker,
                                      threshold=None)
    else:
        master = ParameterAveragingTrainingMaster(
            mesh, batch_size_per_worker=args.batch_size_per_worker,
            averaging_frequency=args.averaging_frequency,
            average_updaters=not args.no_average_updaters)
    return x, y, net, master


def _train_fit(args, net, master, x, y):
    from deeplearning4j_tpu_torch.parallel.distributed import DistributedMultiLayer

    loss = DistributedMultiLayer(net, master).fit(x, y, epochs=args.epochs)
    if args.model_output_path:
        from deeplearning4j_tpu_torch.utils.serialization import save_model
        save_model(net, args.model_output_path)
    return loss


def _train_rank(rank, world, args, ui_url, own_cards):
    """One rank of a spawned ``train`` job; rank 0 posts its stats to the
    parent's dashboard, saves the model and reports."""
    import torch

    if own_cards:
        torch.cuda.set_device(rank)
    if rank:
        args.model_output_path = None
    x, y, net, master = _train_setup(args, world)
    router = None
    if ui_url is not None and rank == 0:
        from deeplearning4j_tpu_torch.ui import RemoteStatsStorageRouter, StatsListener
        router = RemoteStatsStorageRouter(ui_url)
        net.add_listener(StatsListener(router, session_id="cli"))
    try:
        loss = _train_fit(args, net, master, x, y)
    finally:
        if router is not None:
            router.close()
    return {"loss": loss, "stats": master.training_stats()} if rank == 0 else None


def _cmd_train(args):
    """(reference: ParallelWrapperMain) train a model file or zoo model
    through a TrainingMaster, with the dashboard attached on request."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.telemetry import flight as _flight
    from deeplearning4j_tpu_torch.utils.device import resolve_device

    _enable_compile_cache(args)
    # CLI training is the preemptable long-running entry point: a SIGTERM
    # (scheduler eviction) leaves a flight-recorder dump behind
    _flight.install_signal_handler()
    device = resolve_device(args.device)
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        world = args.workers or n_cards
        if world > n_cards:
            raise SystemExit(f"--workers {world} exceeds the {n_cards} available card(s)")
    else:
        world = args.workers or 1  # CPU workers are processes
    storage = ui_server = None
    if args.ui_port is not None:
        from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, UIServer
        storage = InMemoryStatsStorage()
        ui_server = UIServer(port=args.ui_port).attach(storage).start()
        print(f"dashboard: http://127.0.0.1:{ui_server.port}/", flush=True)
    try:
        if world == 1:
            # one worker: this process is the only rank of a world-1 group
            own_group = not dist.is_initialized()
            if own_group:
                if device.type == "cuda":
                    torch.cuda.set_device(device.index or 0)
                pg_dir = tempfile.mkdtemp(prefix="dl4j_train_pg_")
                dist.init_process_group(
                    "nccl" if device.type == "cuda" else "gloo",
                    init_method="file://" + os.path.join(pg_dir, "rendezvous"),
                    rank=0, world_size=1)
            try:
                x, y, net, master = _train_setup(args, 1)
                if storage is not None:
                    from deeplearning4j_tpu_torch.ui import StatsListener
                    net.add_listener(StatsListener(storage, session_id="cli"))
                loss = _train_fit(args, net, master, x, y)
                stats = master.training_stats()
            finally:
                if own_group:
                    dist.destroy_process_group()
                    shutil.rmtree(pg_dir, ignore_errors=True)
        else:
            from deeplearning4j_tpu_torch.parallel.launch import run_ranks
            own_cards = device.type == "cuda"
            url = None if ui_server is None else f"http://127.0.0.1:{ui_server.port}"
            with tempfile.TemporaryDirectory(prefix="dl4j_train_ranks_") as work:
                first = run_ranks(_train_rank, world, work,
                                  backend="nccl" if own_cards else "gloo",
                                  timeout=24 * 3600, args=args, ui_url=url,
                                  own_cards=own_cards)[0]
            loss, stats = first["loss"], first["stats"]
        if args.report_score and loss is not None:
            print(f"final loss: {loss}")
        print(f"training stats: {stats}")
        if args.model_output_path:
            print(f"saved: {args.model_output_path}")
    finally:
        if ui_server is not None:
            ui_server.stop()
    return 0


def _cmd_ui(args):
    from deeplearning4j_tpu_torch.ui import UIServer
    server = UIServer(port=args.port).start()
    print(f"UI server on http://127.0.0.1:{server.port}/ (Ctrl-C to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def _cmd_fleet(args):
    """The multi-process serving entry point: spawn N workers from one
    checkpoint + warm manifest, put the admission/routing front before
    them, and keep the pool elastic: a worker death is a respawn, not an
    outage."""
    from deeplearning4j_tpu_torch import fleet, telemetry
    from deeplearning4j_tpu_torch.serving import ServingOverloaded

    telemetry.enable()
    _enable_compile_cache(args)
    if args.model_path is None:
        # zoo mode: workers init the model themselves (same seed = same
        # params); a checkpoint is the production path
        print("note: --zoo workers each init fresh (same seed); use "
              "--model-path for a real deployment")
    input_shape = (tuple(int(d) for d in args.input_shape.split(",") if d.strip())
                   if args.input_shape else None)
    supervisor = fleet.FleetSupervisor(
        args.workers, model_path=args.model_path, zoo=args.zoo, name=args.name,
        buckets=_ints(args.buckets), input_shape=input_shape,
        warm_manifest=args.warm_manifest or None,
        compile_cache=getattr(args, "compile_cache", None),
        max_queue=args.max_queue, max_batch=args.max_batch,
        deadline_ms=args.deadline_ms, device=args.device)
    router = fleet.FleetRouter(
        name=args.name, max_queue=args.max_queue, max_inflight_rows=args.max_inflight,
        default_deadline_s=(None if args.deadline_ms is None else args.deadline_ms / 1e3))
    supervisor.attach(router)
    print(f"fleet: spawning {args.workers} worker(s)...", flush=True)
    t0 = time.perf_counter()
    supervisor.start()
    fleet.set_default_front(router=router, supervisor=supervisor)
    starts = ", ".join(
        f"{w.wid}:" + ("warm" if fleet.FleetSupervisor.replacement_is_warm(w.ready_doc)
                       else "cold")
        for w in supervisor._workers.values())
    print(f"fleet: {args.workers} worker(s) ready in {time.perf_counter() - t0:.1f}s "
          f"({starts})", flush=True)
    ui_server = _start_ui(args.port, "fleet status", "/fleet")
    try:
        if args.smoke:
            spec = input_shape
            if spec is None:
                # the conf's input type, read in this process from a CPU
                # copy: the router process never opens the card
                cpu = argparse.Namespace(**{**vars(args), "device": "cpu"})
                spec = _serve_input_spec(args, _load_model(cpu))
            futs, shed = [], 0
            for x in _smoke_requests(spec, args.smoke):
                for _ in range(1000):
                    try:
                        futs.append(router.submit(x))
                        break
                    except ServingOverloaded:
                        time.sleep(0.001)
                else:
                    raise SystemExit("fleet smoke: admission queue never drained")
            answered = 0
            for f in futs:
                try:
                    f.get(timeout=60)
                    answered += 1
                except ServingOverloaded:
                    shed += 1
            if shed:
                print(f"fleet smoke: {shed} request(s) shed")
            print(json.dumps({"router": router.stats(), "workers": supervisor.status(),
                              "answered": answered, "health": router.health()},
                             indent=1, default=str))
            return 0
        _wait_for_signal()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
        supervisor.stop()
        fleet.reset()
        if ui_server is not None:
            ui_server.stop()
    return 0


def _digest(answers):
    """sha256 of the answers' bytes in order (a graph's outputs by name):
    two runs answered alike, bit for bit, when their digests are equal."""
    import hashlib

    h = hashlib.sha256()
    for a in answers:
        for v in ([a[k] for k in sorted(a)] if isinstance(a, dict) else [a]):
            v = np.ascontiguousarray(v)
            h.update(f"{v.dtype}{v.shape}".encode())
            h.update(v.tobytes())
    return h.hexdigest()


def _load_model(args):
    """The model file at ``--model-path`` (any format ``restore_checkpoint``
    reads) or a fresh ``--zoo`` model, on ``--device``."""
    from deeplearning4j_tpu_torch.models import zoo

    if args.model_path:
        return zoo.restore_checkpoint(args.model_path, device=args.device)
    try:
        entry = zoo.get_model(args.zoo)
    except KeyError:
        raise SystemExit(f"unknown zoo model {args.zoo!r}; known: {zoo.model_names()}") from None
    return entry.build(device=args.device)


def _load_xy(args):
    """Features and labels from a pair of ``.npy`` files, or from one
    labelled CSV (``--label-column``, ``--n-classes``, ``--skip-lines``,
    through ``datasets.records.csv_dataset``)."""
    if args.data.endswith((".csv", ".dat")):
        if args.labels:
            raise SystemExit(
                "--labels cannot be combined with a labelled CSV --data file: the CSV's "
                "--label-column is the label source. Drop --labels, or pass .npy "
                "features instead.")
        from deeplearning4j_tpu_torch.datasets.records import csv_dataset
        x, y = csv_dataset(args.data, label_column=args.label_column,
                           n_classes=args.n_classes, skip_lines=args.skip_lines)
        if y.ndim == 1:
            # no --n-classes: the raw label column as an [N, 1] target
            y = y[:, None]
        return x, y
    if not args.labels:
        raise SystemExit("--labels is required with .npy features")
    return np.load(args.data), np.load(args.labels)


def _image_rows(net, x):
    """Flat feature rows for a sequential model whose input is an image (a
    CSV row holds H*W*C values, NHWC order) reshaped to the image, as DL4J's
    InputType.convolutionalFlat does; any other input as it is."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import ConvolutionalType

    it = getattr(net.conf, "input_type", None)
    if isinstance(it, ConvolutionalType) and x.ndim == 2 and x.shape[1] == it.flat_size:
        return x.reshape(x.shape[0], it.height, it.width, it.channels)
    return x


def _cmd_eval(args):
    """(reference role: Evaluation printed from evaluate(), the examples'
    ``eval.stats()`` tail, as a CLI verb)"""
    _enable_compile_cache(args)
    net = _load_model(args)
    x, y = _load_xy(args)
    x = _image_rows(net, x)
    preds = []
    for i in range(0, x.shape[0], args.batch_size):
        out = net.output(x[i:i + args.batch_size])
        if isinstance(out, dict):  # multi-output graph: the first output head
            out = next(iter(out.values()))
        preds.append(out.float().cpu().numpy())
    preds = np.concatenate(preds)
    if args.regression:
        from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
        if y.ndim == 1:  # a single-target vector -> a column
            y = y[:, None]
        ev = RegressionEvaluation()
        ev.eval(y, preds)
        print(ev.stats())
        return 0
    from deeplearning4j_tpu_torch.eval.classification import Evaluation
    n_classes = preds.shape[-1]
    if n_classes == 1:
        # a single sigmoid output: Evaluation takes 1-column labels as is
        if y.ndim == 1:
            y = y[:, None]
    elif y.ndim == 1 or (y.ndim == 2 and y.shape[-1] == 1):
        y = np.eye(n_classes, dtype=np.float32)[y.astype(int).ravel()]
    ev = Evaluation()
    ev.eval(y, preds)
    print(ev.stats())
    return 0


def _cmd_tune(args):
    """Merge searched launch plans into the tuning DB: every later process
    with DL4J_TPU_TUNING_DB pointed at it launches the tuned plans, and
    warm manifests saved under it seed them with no lookup."""
    import os

    from deeplearning4j_tpu_torch import telemetry, tuning

    telemetry.enable()  # the event counters are part of the output
    path = args.db or os.environ.get(tuning.ENV_DB)
    if not path:
        raise SystemExit(f"tune: no DB path (--db PATH or ${tuning.ENV_DB})")
    device = args.device
    if device == "cpu":
        print("tune: on the CPU every candidate runs the kernel's plain version "
              "(mechanics only; the times say nothing of the card)")
    db = tuning.TuningDB.load_lenient(path) or tuning.TuningDB(path)
    kernels = ([k.strip() for k in args.kernels.split(",") if k.strip()]
               if args.kernels else None)
    overrides = {k: v for k, v in (("iters", args.iters), ("reps", args.reps)) if v}
    try:
        summaries = tuning.tune_kernels(db, kernels, smoke=args.smoke, device=device,
                                        log=print, **overrides)
    except ValueError as e:
        raise SystemExit(f"tune: {e}")
    db.save(path)
    for name, s in summaries.items():
        print(f"{name}: winner {s['winner']} ({s['winner_ms']} ms/call; default "
              f"{s['default_config']} {s['default_ms']} ms; {s['timed']} measured, "
              f"{s['pruned_static']} pruned, {s['rejected_parity']} parity-rejected)")
    print(f"tuning DB: {path} ({len(db)} entr{'y' if len(db) == 1 else 'ies'}); events "
          f"{json.dumps(tuning.event_counts())}")
    print("note: warm manifests key on the DB content — entries saved under the old DB "
          "warm live on the next start")
    return 0


def _cmd_telemetry(args):
    """Dump the unified telemetry snapshot — the 'what is this process (or
    that server) doing right now' CLI verb."""
    import json

    from deeplearning4j_tpu_torch import telemetry

    if args.url:
        if args.chrome_trace:
            raise SystemExit(
                "--chrome-trace cannot be combined with --url: the host-span "
                "tracer lives in the traced process, and this fresh CLI "
                "process has recorded nothing — export the trace from the "
                "instrumented process instead "
                "(telemetry.get_tracer().export(path)).")
        import urllib.request
        with urllib.request.urlopen(args.url, timeout=10) as r:
            sys.stdout.write(r.read().decode())
    else:
        reg = telemetry.get_registry()
        if not any(m["series"] for m in reg.snapshot().values()):
            # a fresh CLI process has recorded nothing — say so instead of
            # letting an empty dump read as "telemetry is broken"
            print("note: local registry is empty (each process has its "
                  "own); run instrumented work in THIS process, or scrape "
                  "a live server with --url http://host:port/metrics",
                  file=sys.stderr)
        if args.format == "json":
            print(json.dumps(reg.snapshot(), indent=1, default=str))
        elif args.format == "jsonl":
            reg.to_jsonl(sys.stdout)
        else:
            sys.stdout.write(reg.to_prometheus())
    if args.chrome_trace:
        path = telemetry.get_tracer().export(args.chrome_trace)
        print(f"chrome trace: {path}", file=sys.stderr)
    return 0


def _cmd_slo(args):
    """The metrics plane's verdict, on the command line: which rules
    are burning, and by how much (`slo --gate` scripts it)."""
    import json
    import time

    if args.url:
        import urllib.request
        with urllib.request.urlopen(args.url, timeout=10) as r:
            status = json.loads(r.read().decode())
    else:
        from deeplearning4j_tpu_torch import telemetry
        reg = telemetry.get_registry()
        if not any(m["series"] for m in reg.snapshot().values()):
            print("note: local registry is empty (each process has its "
                  "own); run instrumented work in THIS process, or read "
                  "a live server with --url http://host:port/slo",
                  file=sys.stderr)
        from deeplearning4j_tpu_torch.telemetry import slo as _slo
        engine = _slo.get_engine()
        if getattr(args, "history", None):
            # postmortem replay: judge the persisted minutes, not this
            # (possibly freshly-restarted, empty) process's instant. The
            # samples carry their own unix clocks, so mixing in live
            # monotonic-clock passes would corrupt the delta windows —
            # with --history the replay IS the evaluation.
            from deeplearning4j_tpu_torch.telemetry import history as _history
            samples, corrupt = _history.load_dir(args.history)
            if not samples:
                print(f"slo --history: no samples under {args.history} "
                      f"({corrupt} corrupt segment(s))", file=sys.stderr)
                return 1
            status = None
            for s in samples:
                status = engine.evaluate(metrics=s["metrics"], now=s["t"])
            span_s = samples[-1]["t"] - samples[0]["t"]
            print(f"slo --history: replayed {len(samples)} sample(s) "
                  f"spanning {span_s:.0f}s ({corrupt} corrupt segment(s) "
                  f"skipped)", file=sys.stderr)
        else:
            status = engine.evaluate()
            for _ in range(max(args.samples - 1, 0)):
                time.sleep(max(args.interval, 0.0))
                status = engine.evaluate()
    if args.json:
        print(json.dumps(status, indent=1, default=str))
    else:
        rules = status.get("rules", [])
        w_name = max([len(r["name"]) for r in rules] + [4])
        print(f"{'rule'.ljust(w_name)}  state    value        bound  "
              f"kind        metric")
        for r in rules:
            v = r.get("value")
            if isinstance(v, dict):  # burn_rate: short/long pair
                vtxt = "/".join(f"{x:.3g}" for x in v.values())
            else:
                vtxt = "-" if v is None else f"{v:.4g}"
            bound = f"{'<=' if r.get('op') == 'lt' else '>='}" \
                    f"{r.get('fire'):g}"
            print(f"{r['name'].ljust(w_name)}  {r['state']:<7}  "
                  f"{vtxt:<11}  {bound:<5}  {r['kind']:<10}  "
                  f"{r['metric']}")
        firing = status.get("firing", [])
        warning = status.get("warning", [])
        print(f"firing: {firing or 'none'}  warning: {warning or 'none'} "
              f" ({status.get('evaluations')} evaluation(s))")
    if args.gate and status.get("firing"):
        return 1
    return 0


def _load_trace_rings(args):
    """{root name: [trace docs]} from --file / --url / the local ring.
    Accepts the three shapes traces travel in: a /traces payload
    ({"traces": {...}}), a raw ring snapshot ({name: [...]}), or a
    flight-recorder dump carrying a "traces" key. ``--file`` repeats and
    accepts directories of dumps; every source's rings merge."""
    import json

    if args.file:
        from deeplearning4j_tpu_torch.telemetry import timeline as _tl
        rings = {}
        for src in _tl.load_paths(args.file):
            for name, docs in src["rings"].items():
                rings.setdefault(name, []).extend(docs)
        return rings
    if args.url:
        import urllib.request
        with urllib.request.urlopen(args.url, timeout=10) as r:
            doc = json.loads(r.read().decode())
        return doc.get("traces", doc)
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx
    rings = _tracectx.get_ring().snapshot()
    if not rings:
        print("note: local slow-trace ring is empty (each process has its "
              "own); run traced work in THIS process, scrape a live "
              "server with --url http://host:port/traces, or read a "
              "flight dump with --file", file=sys.stderr)
    return rings


def _print_trace_timeline(doc):
    """One trace as an indented timeline: spans sorted by start time,
    indented by causal depth — the 'where did the p99 request spend its
    time' view, readable without a trace viewer."""
    dur = doc.get("duration_s")
    head = f"trace {doc.get('trace_id')} {doc.get('name')}"
    if dur is not None:
        head += f" {1e3 * dur:.3f} ms"
    if doc.get("status") not in (None, "ok"):
        head += f" [{doc['status']}]"
    print(head)
    spans = [s for s in doc.get("spans", []) if isinstance(s, dict)]
    depth = {}
    by_id = {s.get("span_id"): s for s in spans}

    def depth_of(s):
        d, seen = 0, set()
        while s is not None and s.get("parent_id") is not None \
                and s.get("span_id") not in seen:
            seen.add(s.get("span_id"))
            s = by_id.get(s.get("parent_id"))
            d += 1
        return d

    for s in spans:
        depth[s.get("span_id")] = depth_of(s)
    for s in sorted(spans, key=lambda s: (s.get("t0_s", 0.0),
                                          depth[s.get("span_id")])):
        pad = "  " * depth[s.get("span_id")]
        d = s.get("dur_s")
        dtxt = "?" if d is None else f"{1e3 * d:.3f} ms"
        line = (f"  {1e3 * s.get('t0_s', 0.0):>10.3f}  {pad}"
                f"{s.get('name')}  {dtxt}  [{s.get('thread', '?')}]")
        if s.get("args"):
            line += "  " + " ".join(f"{k}={v}"
                                    for k, v in sorted(s["args"].items()))
        print(line)


def _cmd_traces_cluster(args):
    """``traces --cluster``: one time-aligned timeline over every source
    — a directory of a dead generation's dumps, multiple --file scrapes,
    or the live cluster providers — ending with the per-host round
    clocks and the stalled host (the postmortem's first question)."""
    import json

    from deeplearning4j_tpu_torch.telemetry import timeline as _tl

    if args.file:
        merged = _tl.merge(_tl.load_paths(args.file))
    elif args.url:
        import urllib.request
        with urllib.request.urlopen(args.url, timeout=10) as r:
            doc = json.loads(r.read().decode())
        src = _tl._source_from_doc(doc, args.url)
        merged = _tl.merge([src] if src is not None else [])
    else:
        merged = _tl.cluster_snapshot()
    if args.chrome:
        with open(args.chrome, "w") as f:
            json.dump(_tl.to_chrome(merged), f)
        print(f"chrome trace written to {args.chrome}", file=sys.stderr)
    if args.json:
        print(json.dumps(merged, indent=1, default=str))
        return 0
    print(f"cluster timeline: {merged['n_traces']} trace(s) across "
          f"{len(merged['instances'])} instance(s)")
    base = merged.get("t0_unix")
    for t in merged["traces"]:
        if args.name and t["name"] != args.name:
            continue
        rel = ("?" if (t["t0_unix"] is None or base is None)
               else f"{t['t0_unix'] - base:+.3f}s")
        dur = t.get("duration_s")
        dtxt = "?" if dur is None else f"{1e3 * dur:.3f} ms"
        line = f"  {rel:>10}  {t['instance']}  {t['name']}  {dtxt}"
        if t.get("status") not in (None, "ok"):
            line += f" [{t['status']}]"
        print(line)
    if merged["hosts"]:
        print()
        for inst in sorted(merged["hosts"]):
            h = merged["hosts"][inst]
            print(f"host {inst}: last round {h['last_round']}")
        if merged.get("stalled") is not None:
            h = merged["hosts"][merged["stalled"]]
            print(f"stalled: {merged['stalled']} — round clock stopped "
                  f"at round {h['last_round']} while peers advanced")
    return 0


def _cmd_traces(args):
    """The gauge->exemplar->timeline landing: `traces --trace-id <id>`
    renders the causal story a p99 exemplar points at."""
    import json

    if args.cluster:
        return _cmd_traces_cluster(args)
    rings = _load_trace_rings(args)
    if args.name:
        rings = {args.name: rings.get(args.name, [])}
    if args.trace_id:
        for docs in rings.values():
            for doc in docs:
                if doc.get("trace_id") == args.trace_id:
                    if args.json:
                        print(json.dumps(doc, indent=1, default=str))
                    else:
                        _print_trace_timeline(doc)
                    return 0
        print(f"traces: no trace {args.trace_id!r} in the ring",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(rings, indent=1, default=str))
        return 0
    slowest = None
    for name in sorted(rings):
        docs = rings[name]
        if not docs:
            continue
        durs = [d.get("duration_s") or 0.0 for d in docs]
        print(f"{name}: {len(docs)} trace(s), slowest "
              f"{1e3 * max(durs):.3f} ms, fastest kept "
              f"{1e3 * min(durs):.3f} ms")
        for d in docs:
            if slowest is None or (d.get("duration_s") or 0.0) > \
                    (slowest.get("duration_s") or 0.0):
                slowest = d
    if slowest is not None:
        print()
        _print_trace_timeline(slowest)
    return 0


#: flight-record columns in display order; only those present in the dump
#: are rendered (health fields appear when the watchdog annotated the ring)
_FLIGHT_COLS = ("step", "score", "loss", "step_time_s", "etl_time_s",
                "grad_norm", "loss_nonfinite", "grad_nonfinite",
                "trace_id", "device_bytes_in_use", "live_array_bytes")


def _cmd_flightrec(args):
    """Postmortem reader: the last-N-steps table a human scans for 'where
    did it go wrong' without hand-parsing the dump JSON."""
    import json

    with open(args.path) as f:
        doc = json.load(f)
    if args.json:
        print(json.dumps(doc, indent=1, default=str))
        return 0
    recs = doc.get("records", [])
    print(f"flight dump: reason={doc.get('reason')} "
          f"dumped_at={doc.get('dumped_at')} pid={doc.get('pid')} "
          f"records={len(recs)}")
    if doc.get("error"):
        print(f"error: {doc['error']}")
    if doc.get("anomaly"):
        print(f"anomaly: {doc['anomaly']}")
    hist = doc.get("history")
    if hist:
        # where to find the minutes BEFORE this dump: the persisted
        # metrics-history segments replay with `slo --history <dir>`
        print(f"history: {hist.get('samples', 0)} sample(s) in ring, "
              f"{hist.get('segments', 0)} segment(s) persisted"
              + (f" under {hist['dir']} (replay: slo --history "
                 f"{hist['dir']})" if hist.get("dir") else
                 " (persistence off: no history dir configured)"))
    show = recs[-args.last:] if args.last else recs

    def _fmt(v):
        if isinstance(v, bool):
            return "YES" if v else "-"
        if isinstance(v, float):
            return f"{v:.4g}"
        return "-" if v is None else str(v)

    cols = [c for c in _FLIGHT_COLS if any(c in r for r in show)]
    if cols:
        rows = [[_fmt(r.get(c)) for c in cols] for r in show]
        widths = [max(len(c), *(len(row[i]) for row in rows))
                  for i, c in enumerate(cols)]
        print("  ".join(c.ljust(w) for c, w in zip(cols, widths)))
        for row in rows:
            print("  ".join(v.ljust(w) for v, w in zip(row, widths)))
    flagged = [r for r in recs
               if r.get("loss_nonfinite") or r.get("grad_nonfinite")]
    if flagged:
        print(f"{len(flagged)} record(s) flagged nonfinite; first at step "
              f"{flagged[0].get('step')}")
    return 0


def _cmd_lint(args):
    """graftlint CLI: exit 0 when every finding is fixed/suppressed/
    baselined, non-zero otherwise — the gating contract. Imports no torch."""
    import os

    from deeplearning4j_tpu_torch import analysis
    from deeplearning4j_tpu_torch.analysis import reporters

    if args.list_rules:
        for name, rule in analysis.all_rules().items():
            print(f"{name} [{rule.slug}]\n    {rule.description}")
        return 0

    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(pkg_dir)
    paths = args.paths or [pkg_dir]
    rules = args.rules.split(",") if args.rules else None

    if args.emit_schema:
        mods, errors = analysis.parse_paths(paths, root=root)
        if errors:
            for f in errors:
                print(f.human(), file=sys.stderr)
            raise SystemExit("graftlint: cannot emit a schema over "
                             "unparseable sources")
        schema = analysis.build_schema(mods)
        jp, mp = reporters.write_schema(schema, args.schema_dir)
        print(f"graftlint: schema written: {jp}, {mp}", file=sys.stderr)
        return 0
    if args.san_report:
        return _lint_san_report(args, paths, root)
    if args.diff and args.update_baseline:
        raise SystemExit("graftlint: --diff filters findings to changed "
                         "lines; rewriting the baseline from that subset "
                         "would drop real debt — run --update-baseline "
                         "without --diff")

    try:
        findings = analysis.lint_paths(paths, rules=rules, root=root)
    except analysis.LintError as e:
        raise SystemExit(f"graftlint: {e}")

    if args.diff:
        changed = _git_changed_lines(args.diff, root)
        # a finding's statement spans sup_start (decorators included:
        # editing only a decorator line must still surface the finding it
        # causes on the def) through end_line
        findings = [f for f in findings
                    if any(ln in changed.get(f.path, ())
                           for ln in range(min(f.sup_start or f.line,
                                               f.line),
                                           max(f.end_line, f.line) + 1))]

    if args.no_baseline:
        baseline = {}
    else:
        bpath = args.baseline or analysis.default_baseline_path()
        if args.update_baseline:
            analysis.save_baseline(bpath, findings)
            print(f"graftlint: baseline rewritten with {len(findings)} "
                  f"finding(s): {bpath}", file=sys.stderr)
            return 0
        baseline = analysis.load_baseline(bpath)
    new, known, stale = analysis.apply_baseline(findings, baseline)
    if args.diff:
        # off-diff baselined debt is invisible here, so "stale" is
        # meaningless: the full (non-diff) run owns that check
        stale = []

    if args.format == "json":
        reporters.report_json(new, known, stale)
    else:
        reporters.report_human(new, known, stale, verbose=args.verbose)
    if new:
        return 1
    if stale and args.strict_baseline:
        return 1
    return 0


def _git_changed_lines(ref, root):
    """{repo-relative posix path: set of NEW-side line numbers} changed vs
    ``ref`` (committed AND working-tree changes: pre-commit wants both).
    Hunk headers only (-U0): pure deletions contribute no lines."""
    import re
    import subprocess
    from pathlib import Path

    try:
        out = subprocess.run(
            ["git", "-C", root, "diff", "--unified=0", ref, "--", "*.py"],
            capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise SystemExit(f"graftlint: git diff {ref} failed: "
                         f"{detail.strip()}")
    changed, cur = {}, None
    hunk = re.compile(r"^@@ -\d+(?:,\d+)? \+(\d+)(?:,(\d+))? @@")
    for line in out.splitlines():
        if line.startswith("+++ b/"):
            cur = line[6:]
        elif line.startswith("+++"):
            cur = None                      # /dev/null: file deleted
        elif cur is not None and line.startswith("@@"):
            m = hunk.match(line)
            if m:
                start = int(m.group(1))
                count = int(m.group(2)) if m.group(2) is not None else 1
                if count:
                    changed.setdefault(cur, set()).update(
                        range(start, start + count))
    # untracked files never appear in `git diff` hunks but ARE pending
    # changes: every line of them counts
    untracked = subprocess.run(
        ["git", "-C", root, "ls-files", "--others", "--exclude-standard",
         "--", "*.py"],
        capture_output=True, text=True).stdout
    for path in untracked.splitlines():
        if not path:
            continue
        try:
            with open(Path(root) / path, encoding="utf-8",
                      errors="replace") as fh:
                n = sum(1 for _ in fh)
        except OSError:
            continue
        changed.setdefault(path, set()).update(range(1, n + 1))
    return changed


def _lint_san_report(args, paths, root):
    """lint --san-report: one lock graph from both prongs. Static R9
    edges come in lock-id space; observed graftsan edges come keyed by
    allocation site (file:line) and map onto the SAME identity via the
    lock registry, so an order only runtime saw composes with an order
    only the code declares, and the merged cycle is reported even though
    neither prong alone had it."""
    from pathlib import Path, PurePosixPath

    from deeplearning4j_tpu_torch import analysis
    from deeplearning4j_tpu_torch.analysis.dataflow import project_facts, reaches

    with open(args.san_report, encoding="utf-8") as fh:
        report = json.load(fh)
    mods, parse_errors = analysis.parse_paths(paths, root=root)
    static = analysis.lint_modules(mods, rules=["R9"])
    facts = project_facts(mods)

    site_to_id = {f"{info['path']}:{info['line']}": lid
                  for lid, info in facts.locks.items()}

    def norm(site):
        fname, _, line = site.rpartition(":")
        try:
            rel = Path(fname).resolve().relative_to(Path(root).resolve())
        except ValueError:
            rel = Path(fname)
        return f"{PurePosixPath(rel)}:{line}"

    def ident(site):
        n = norm(site)
        return site_to_id.get(n, n)        # unmapped sites keep file:line

    merged = {}
    for src, dst, _mod, _node, _via in facts.lock_edges:
        if src != dst:          # self-edges are static R9's own call
            merged.setdefault(src, set()).add(dst)  # (RLock re-entry legal)
    observed = []
    for e in report.get("lock_order_edges", ()):
        a, b = ident(e["from"]), ident(e["to"])
        observed.append((a, b, e.get("count", 1)))
        if a != b:
            merged.setdefault(a, set()).add(b)

    cycles = set()
    for a in sorted(merged):
        for b in sorted(merged[a]):
            if reaches(merged, b, a):
                cycles.add(tuple(sorted((a, b))))

    runtime_findings = report.get("findings", ())
    print(f"graftsan report: {len(observed)} observed lock-order edge(s), "
          f"{len(runtime_findings)} runtime finding(s)")
    for a, b, count in observed:
        print(f"  observed {a} -> {b} (x{count})")
    for f in runtime_findings:
        tail = f" [{f['site']}]" if f.get("site") else ""
        print(f"RUNTIME {f['kind']}: {f['message']}{tail}")
    for f in static:
        print(f"STATIC {f.human()}")
    for f in parse_errors:
        print(f"STATIC {f.human()}")
    for cyc in sorted(cycles):
        print("MERGED lock-order cycle: "
              + " -> ".join(cyc + (cyc[0],)))
    bad = bool(runtime_findings or static or parse_errors or cycles)
    if not bad:
        print("graftsan: static + observed lock graphs merge clean")
    return 1 if bad else 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "continuous":
        # forwarded before argparse: REMAINDER cannot capture leading
        # option-style arguments (`continuous --snapshot ...`)
        rest = argv[1:]
        if rest and rest[0] == "--":
            rest = rest[1:]
        if "--help-runner" in rest:
            rest = ["--help"]
        from deeplearning4j_tpu_torch.continuous import runner
        return runner.main(rest)
    args = _build_parser().parse_args(argv)
    if args.command == "train":
        return _cmd_train(args)
    if args.command == "ui":
        return _cmd_ui(args)
    if args.command == "serve":
        return _cmd_serve(args)
    if args.command == "fleet":
        return _cmd_fleet(args)
    if args.command == "eval":
        return _cmd_eval(args)
    if args.command == "tune":
        return _cmd_tune(args)
    if args.command == "telemetry":
        return _cmd_telemetry(args)
    if args.command == "flightrec":
        return _cmd_flightrec(args)
    if args.command == "traces":
        return _cmd_traces(args)
    if args.command == "slo":
        return _cmd_slo(args)
    if args.command == "lint":
        return _cmd_lint(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
