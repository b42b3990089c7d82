"""Real-subprocess continuous-training runner (the chaos harness target).

The port of ``deeplearning4j_tpu/continuous/runner.py``.
``python -m deeplearning4j_tpu_torch.continuous.runner`` runs one
continuous training session, streaming (subscribe to a broker topic) or
offline (a deterministic generated batch list: the reference and resume
legs), on ``--device`` (default ``cuda``; a missing card raises), and
speaks the JAX runner's line protocol on stdout:

* ready:  ``{"continuous_ready": true, "pid": ...}`` once the model is
  built (or resumed) and, in streaming mode, the subscription is live;
  the harness starts its publisher only after this line;
* rounds: ``{"round": r, "iteration": n}`` after every completed round
  (``--round-lines``), which lets a harness time a SIGTERM mid-round;
* done:   ``{"continuous_done": true, "digest": ..., "summary": ...,
  "counters": ..., "flight_dumps": [...]}``; digests are
  :func:`chaos.state_digest`, so bit-exact parity (rollback-resume,
  SIGTERM-resume) is string equality.

``--serve-registry`` also hosts an in-process ``ModelRegistry`` that
every published snapshot hot-swaps; the done line carries the max
|serving - direct| probe difference.

With ``--install-sigterm`` a SIGTERM dumps the flight ring to
``$DL4J_TPU_FLIGHT_DIR`` and the process dies by the default
disposition; the on-disk snapshot of the last completed round is the
point a later ``--resume`` run continues from, bit-exactly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _emit(doc):
    print(json.dumps(doc), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description="continuous-training runner")
    p.add_argument("--snapshot", required=True,
                   help="bundle path: written every snapshot cadence, "
                        "rollback target, and --resume source")
    p.add_argument("--resume", action="store_true",
                   help="resume from --snapshot instead of a fresh net")
    # model (must match the chaos generator's shapes)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--features", type=int, default=12)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--classes", type=int, default=3)
    # stream source: streaming (broker) or offline (generated)
    p.add_argument("--broker-port", type=int, default=None)
    p.add_argument("--topic", default="train")
    p.add_argument("--staleness-s", type=float, default=None)
    p.add_argument("--quiet-timeout-s", type=float, default=2.0)
    p.add_argument("--ingest-retries", type=int, default=8)
    p.add_argument("--offline-n", type=int, default=None,
                   help="offline mode: train gen_batches(gen-seed, N)")
    p.add_argument("--offline-skip", default="",
                   help="offline: comma-separated indices to omit (the "
                        "faulted batches a reference run never sees)")
    p.add_argument("--offline-start", type=int, default=0,
                   help="offline: start at this index (resume legs feed "
                        "the remainder of the stream); -1 = the resumed "
                        "bundle's iteration counter (k=1, no faults: one "
                        "step per batch)")
    p.add_argument("--round-sleep-s", type=float, default=0.0,
                   help="sleep after each round (chaos harnesses use it "
                        "to land a SIGTERM mid-run deterministically)")
    p.add_argument("--gen-seed", type=int, default=123)
    p.add_argument("--batch", type=int, default=8)
    # loop shape
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--dispatches-per-round", type=int, default=1)
    p.add_argument("--snapshot-every", type=int, default=1)
    p.add_argument("--until-steps", type=int, default=None)
    p.add_argument("--max-rounds", type=int, default=None)
    p.add_argument("--policy", default="raise",
                   choices=("record", "warn", "raise"))
    p.add_argument("--max-rollbacks", type=int, default=8)
    p.add_argument("--serve-registry", action="store_true")
    p.add_argument("--install-sigterm", action="store_true")
    p.add_argument("--round-lines", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the net trains (default cuda; cpu for tests)")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.continuous import chaos
    from deeplearning4j_tpu_torch.continuous.trainer import (ContinuousTrainer,
                                                             StreamingTrainSource,
                                                             registry_updater)
    from deeplearning4j_tpu_torch.telemetry import flight as _flight
    from deeplearning4j_tpu_torch.utils.device import resolve_device
    from deeplearning4j_tpu_torch.utils.serialization import load_bundle

    device = resolve_device(args.device)
    telemetry.enable()
    if args.install_sigterm:
        _flight.install_signal_handler()

    if args.resume:
        net = load_bundle(args.snapshot, device=device).net
    else:
        net = chaos.smoke_net(seed=args.seed, features=args.features,
                              hidden=args.hidden, classes=args.classes,
                              device=device)
        net.init()

    registry = None
    serve_update = None
    if args.serve_registry:
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
        registry = ModelRegistry()
        import copy
        # the registry serves its own copy: the trainer's tensors update in
        # place, the served ones change only by a snapshot's hot swap
        registry.register("continuous", copy.deepcopy(net), buckets=[args.batch],
                          input_spec=(args.features,), device=device)
        serve_update = registry_updater(registry, "continuous")

    subscriber = None
    if args.broker_port is not None:
        from deeplearning4j_tpu_torch.streaming.pubsub import NDArraySubscriber
        subscriber = NDArraySubscriber(args.topic, port=args.broker_port)
        source = StreamingTrainSource(
            subscriber, max_staleness_s=args.staleness_s,
            quiet_timeout_s=args.quiet_timeout_s)
    elif args.offline_n is not None:
        skip = {int(i) for i in args.offline_skip.split(",") if i.strip()}
        start = args.offline_start
        if start < 0:
            start = int(net.iteration)  # resume: the bundle knows
        batches = chaos.gen_batches(args.gen_seed, args.offline_n,
                                    batch=args.batch,
                                    features=args.features,
                                    classes=args.classes)
        source = [b for i, b in enumerate(batches)
                  if i >= start and i not in skip]
    else:
        p.error("one of --broker-port / --offline-n is required")

    trainer = ContinuousTrainer(
        net, source, snapshot_path=args.snapshot, k=args.k,
        batch_size=args.batch,
        dispatches_per_round=args.dispatches_per_round,
        snapshot_every=args.snapshot_every, health_policy=args.policy,
        max_rollbacks=args.max_rollbacks, serve_update=serve_update,
        ingest_retries=args.ingest_retries)
    if args.round_lines or args.round_sleep_s:
        def on_round(t):
            if args.round_lines:
                _emit({"round": t.rounds,
                       "iteration": int(t.net.iteration)})
            if args.round_sleep_s:
                import time
                time.sleep(args.round_sleep_s)
        trainer.on_round = on_round

    from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
    _emit({"continuous_ready": True, "pid": os.getpid(),
           "clock": _timeline.clock_pair()})
    try:
        summary = trainer.run(max_rounds=args.max_rounds,
                              until_steps=args.until_steps)
    finally:
        if subscriber is not None:
            subscriber.close()

    serving_probe_diff = None
    if registry is not None:
        import numpy as np
        probe = chaos.gen_batches(args.gen_seed + 7, 1, batch=args.batch,
                                  features=args.features,
                                  classes=args.classes)[0][0]
        served = np.asarray(registry.output("continuous", probe))
        direct = net.output(probe).detach().cpu().numpy()
        serving_probe_diff = float(np.max(np.abs(served - direct)))
        registry.unregister("continuous")

    _emit({"continuous_done": True,
           "digest": chaos.state_digest(net),
           "iteration": int(net.iteration),
           "summary": summary,
           "serving_probe_diff": serving_probe_diff,
           "counters": {name: telemetry.series_map(name) for name in (
               "continuous_rounds_total", "continuous_rollback_total",
               "continuous_rolled_back_steps_total",
               "continuous_dropped_total", "continuous_snapshots_total",
               "continuous_serve_updates_total", "etl_retry_total",
               "stream_dropped_total", "recompiles_total")},
           "flight_dumps": list(_flight.get_recorder().dumps)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
