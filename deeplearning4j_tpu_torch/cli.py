"""Command-line entry point of the port. Ported so far: the ``serve``,
``eval``, ``tune`` and ``continuous`` verbs.

    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --max-batch 32
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --smoke 64 --device cpu
    python -m deeplearning4j_tpu_torch serve --model-path dl4j.zip --input-shape 128,96 --smoke 4
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --compile-cache /var/cache/k \
        --warm-manifest ckpt.warm.zip
    python -m deeplearning4j_tpu_torch eval --model-path ckpt.zip --data x.npy --labels y.npy
    python -m deeplearning4j_tpu_torch eval --model-path ckpt.zip --data test.csv \
        --label-column 784 --n-classes 10
    python -m deeplearning4j_tpu_torch tune --db tuned.json
    python -m deeplearning4j_tpu_torch tune --db tuned.json --smoke --device cpu
    python -m deeplearning4j_tpu_torch continuous --snapshot s.zip --offline-n 8 --device cpu

``serve`` loads a model file through ``models.zoo.restore_checkpoint``
(the framework's checkpoint zip written by either package, a DL4J
ModelSerializer zip or a Keras HDF5 file; a MultiLayerNetwork or a
ComputationGraph), warms every batch bucket, and serves with continuous
batching and admission control. The warmup shape is ``--input-shape``
where given, else the model's input type; a graph's is one per-example
shape per input, from its input types. A model whose input type leaves a
dimension open (a DL4J recurrent zip stores no sequence length) needs
``--input-shape``. ``--smoke
N`` serves N synthetic requests, prints the engine's stats as JSON (with
``smoke_answers_sha256``, a digest of the answers in request order) and
exits. ``eval`` runs a model file (or a freshly initialised zoo model,
``--zoo``) over ``.npy`` features and labels, or over one labelled CSV,
and prints the ``Evaluation`` (or, with ``--regression``, the
``RegressionEvaluation``) statistics; flat rows for an image model are
reshaped to its input image (DL4J's ``InputType.convolutionalFlat``). Both run on
``--device`` (default ``cuda``; a missing card raises rather than falling
back to the CPU). ``--compile-cache DIR`` (both; default
``$DL4J_TPU_COMPILE_CACHE``) builds and keeps the kernel libraries in DIR
(``utils/compile_cache.enable_persistent_cache``); ``serve
--warm-manifest PATH`` warms the buckets from PATH where it exists (no
nvcc run, no tuning lookup) and writes what it warmed back to PATH.
``tune`` searches the kernels' launch plans at the main paths' shapes on
the card and merges the winners into the tuning DB (``--db``, default
``$DL4J_TPU_TUNING_DB``) that the kernels' dispatch seams read from that
variable; ``--smoke`` runs trimmed shapes. ``--device cpu`` runs the
plain versions (a check of the search, the gate and the DB, not of the
kernels), and its winners key under the CPU's backend fingerprint, never
a card's. ``continuous`` forwards every argument after it, unparsed, to
``continuous/runner.py`` (``continuous --help-runner`` prints the runner's
own reference): streaming training with bounded staleness, rollback to the
last good bundle and snapshot hand-off, on ``--device`` (default
``cuda``). The JAX package's other verbs are not ported yet.
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
        description="PyTorch/CUDA port of deeplearning4j_tpu: serve, eval, tune, continuous")
    sub = p.add_subparsers(dest="command", required=True)

    def add_compile_cache(sp):
        sp.add_argument(
            "--compile-cache", metavar="DIR",
            help="persistent kernel cache directory (utils/compile_cache): the CUDA "
                 "libraries are built into DIR and reused by every later process; "
                 "defaults to $DL4J_TPU_COMPILE_CACHE when set")

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
    sv.add_argument("--model-path", required=True,
                    help="model to serve: a checkpoint zip, a DL4J ModelSerializer zip "
                         "or a Keras HDF5 file")
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
    sv.add_argument("--smoke", type=int, metavar="N",
                    help="serve N synthetic requests, print the stats, and exit")
    sv.add_argument("--device", default="cuda",
                    help="device the forward runs on: cuda (default) or cpu")

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
    name = "default"
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
        import signal

        def _term(signum, frame):
            raise KeyboardInterrupt
        signal.signal(signal.SIGTERM, _term)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        registry.stop()
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
    if args.command == "serve":
        return _cmd_serve(args)
    if args.command == "eval":
        return _cmd_eval(args)
    if args.command == "tune":
        return _cmd_tune(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
