"""Command-line entry point of the port. Ported so far: the ``serve`` verb.

    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --max-batch 32
    python -m deeplearning4j_tpu_torch serve --model-path ckpt.zip --smoke 64 --device cpu

``serve`` loads a checkpoint zip (written by either package), warms every
batch bucket, and serves with continuous batching and admission control.
``--smoke N`` serves N synthetic requests, prints the engine's stats as
JSON and exits. The forward runs on ``--device`` (default ``cuda``; a
missing card raises rather than falling back to the CPU). The JAX
package's other verbs are not ported yet.
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
        description="PyTorch/CUDA port of deeplearning4j_tpu: serve")
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
    return p


def _serve_input_spec(net):
    """Per-example input shape for warmup, from the model's input type."""
    input_type = getattr(net.conf, "input_type", None)
    if input_type is None:
        raise SystemExit("the model conf carries no input type to derive "
                         "the warmup shape from")
    return tuple(input_type.shape(1)[1:])


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
            rs = np.random.RandomState(0)
            xs = rs.rand(args.smoke, *input_spec).astype(np.float32)
            futs, shed = [], 0
            for i in range(args.smoke):
                # a burst bigger than --max-queue legitimately sheds: back
                # off briefly and keep going
                for _ in range(1000):
                    try:
                        futs.append(engine.submit(xs[i]))
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


def main(argv=None):
    args = _build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command == "serve":
        return _cmd_serve(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
