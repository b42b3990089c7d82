"""Command-line entry point of the port. Ported so far: the ``serve`` and
``eval`` verbs.

    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --max-batch 32
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --smoke 64 --device cpu
    python -m deeplearning4j_tpu_torch eval --model-path ckpt.zip --data x.npy --labels y.npy
    python -m deeplearning4j_tpu_torch eval --model-path ckpt.zip --data test.csv \
        --label-column 784 --n-classes 10

``serve`` loads a checkpoint zip (written by either package, a
MultiLayerNetwork or a ComputationGraph), warms every batch bucket, and
serves with continuous batching and admission control; a graph's warmup
spec is one per-example shape per input, from its input types. ``--smoke
N`` serves N synthetic requests, prints the engine's stats as JSON and
exits. ``eval`` runs a checkpoint (or a freshly initialised zoo model,
``--zoo``) over ``.npy`` features and labels, or over one labelled CSV,
and prints the ``Evaluation`` (or, with ``--regression``, the
``RegressionEvaluation``) statistics; flat rows for an image model are
reshaped to its input image (DL4J's ``InputType.convolutionalFlat``). Both run on
``--device`` (default ``cuda``; a missing card raises rather than falling
back to the CPU). The JAX package's other verbs are not ported yet.
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
        description="PyTorch/CUDA port of deeplearning4j_tpu: serve, eval")
    sub = p.add_subparsers(dest="command", required=True)
    sv = sub.add_parser(
        "serve",
        help="inference server: continuous batching over warmed shape "
             "buckets, bounded admission queue with load shedding")
    sv.add_argument("--model-path", required=True, help="checkpoint zip to serve")
    sv.add_argument("--max-batch", type=int, default=32,
                    help="largest serving batch (= largest bucket)")
    sv.add_argument("--buckets",
                    help="comma-separated batch buckets to warm "
                         "(default: powers of two up to --max-batch)")
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
    esrc = e.add_mutually_exclusive_group(required=True)
    esrc.add_argument("--model-path", help="checkpoint zip")
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
    return p


def _serve_input_spec(net):
    """Per-example input shape for warmup, from the model's input type; a
    graph's is a dict of them, one per input."""
    input_types = getattr(net.conf, "input_types", None)
    if input_types:
        return {name: tuple(t.shape(1)[1:]) for name, t in zip(net.conf.inputs, input_types)}
    input_type = getattr(net.conf, "input_type", None)
    if input_type is None:
        raise SystemExit("the model conf carries no input type to derive "
                         "the warmup shape from")
    return tuple(input_type.shape(1)[1:])


def _smoke_requests(input_spec, n):
    """``n`` synthetic per-example requests (dicts for a graph)."""
    rs = np.random.RandomState(0)
    if isinstance(input_spec, dict):
        xs = {k: rs.rand(n, *spec).astype(np.float32) for k, spec in input_spec.items()}
        return [{k: v[i] for k, v in xs.items()} for i in range(n)]
    return list(rs.rand(n, *input_spec).astype(np.float32))


def _cmd_serve(args):
    from deeplearning4j_tpu_torch.serving import (ServingOverloaded,
                                                  get_model_registry)
    from deeplearning4j_tpu_torch.utils.serialization import load_model

    name = "default"
    net = load_model(args.model_path, device=args.device)
    input_spec = _serve_input_spec(net)
    buckets = None
    if args.buckets:
        buckets = [int(b) for b in args.buckets.split(",") if b.strip()]
    registry = get_model_registry()
    engine = registry.register(
        name, net, input_spec=input_spec, max_batch_size=args.max_batch,
        buckets=buckets, max_queue=args.max_queue,
        default_deadline_s=(None if args.deadline_ms is None
                            else args.deadline_ms / 1e3),
        device=args.device)
    st = engine.stats()
    print(f"model {name!r}: warmed buckets {st['buckets']} in "
          f"{st['warmup_s']:.2f}s on {st['device']} (input {input_spec})")
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
            for f in futs:
                try:
                    f.get(timeout=60)
                except ServingOverloaded:
                    shed += 1  # stale-in-queue deadline shed (--deadline-ms)
            if shed:
                print(f"smoke: {shed} request(s) shed by deadline")
            print(json.dumps(registry.status()["models"][name], indent=1))
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


def _load_model(args):
    """The checkpoint at ``--model-path`` or a fresh ``--zoo`` model, on
    ``--device``."""
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


def main(argv=None):
    args = _build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "serve":
        return _cmd_serve(args)
    if args.command == "eval":
        return _cmd_eval(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
