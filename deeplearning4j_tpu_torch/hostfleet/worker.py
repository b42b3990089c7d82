"""One training host of the elastic fleet (the supervisor's subprocess).

The port of ``deeplearning4j_tpu/hostfleet/worker.py``.
``python -m deeplearning4j_tpu_torch.hostfleet.worker`` runs ONE host of
ONE generation: join the job's ``torch.distributed`` group
(``parallel.distributed.initialize_distributed``: bounded timeout,
counted retries), build the deterministic smoke net (or resume it from
the layout-free bundle, RESHARDED into this generation's topology by
``ParallelTrainer.adopt_net_state``), then train ``total_rounds`` rounds
of ``StepDriver.run_round`` with the zero1/fsdp sharded update over this
host's mesh and a cross-host exchange at every round boundary. Line
protocol on stdout (the supervisor's contract):

* ready: ``{"hostfleet_ready": true, "process": i, "generation": g,
  "clock": {mono, unix}, ...}``: the clock pair seeds the supervisor's
  per-host clock-offset estimate (cluster timeline alignment);
* round: ``{"round": r, "iteration": n, "process": i, "trace": doc}``
  after each completed round (exchange + heartbeat + snapshot done): the
  ``hostfleet.round`` trace doc (steps/exchange/heartbeat/checkpoint
  child spans) rides the line so the supervisor's ring shows which host
  stalled a generation;
* snapshot (process 0): ``{"snapshot": path, "round": r}``;
* done: ``{"hostfleet_done": true, "digest": ..., "counters": ...}``:
  digests are ``continuous.chaos.state_digest``, so the harness asserts
  cross-host agreement and fault/fault-free parity by string equality.

Failure protocol: a failed init (the group join, or a ``--device`` the
host cannot reach: a host never trains on the CPU in a card's place)
exits ``RC_INIT_FAILED`` (13), a broken round exchange exits
``RC_EXCHANGE_FAILED`` (14), each with ONE JSON error line, so the
supervisor never has to infer a cause from silence.

Exchange modes (see hostfleet/exchange.py): ``gspmd`` runs one
``ParallelTrainer`` over every host's rank, its collectives inside the
step (processes that share one card join over gloo: NCCL refuses two
ranks on one GPU); ``hostavg`` trains each host on its own world-1 mesh
and averages params + updater state at round boundaries through the
supervisor's ExchangeServer (the reference's ParameterAveraging
semantics). ``auto`` keeps the JAX package's outcome: hostavg when the
job has more than one process on the CPU, gspmd otherwise.

``step_recompiles`` counted the growth of the jitted step's cache in the
JAX package. Here it counts the growth, after the steady state (the
second round), of what this host's steps resolve once per signature: the
K-step engines' CUDA-graph captures and the kernels' plan-cache entries.

Heartbeats: after every round the worker atomically rewrites
``<heartbeat-dir>/host<i>.json`` with ``{round, iteration, ts}``: the
supervisor's round watchdog reads these (plus the exchange server's own
progress clock) to bound a wedged round without any HTTP surface.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

RC_INIT_FAILED = 13
RC_EXCHANGE_FAILED = 14


def _emit(doc):
    print(json.dumps(doc), flush=True)


def _atomic_write(path, text):
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _host_leaves(net):
    """The exchanged state as host numpy leaves, in tree order: params +
    updater state + mutable layer state, everything the round average
    must cover. The RNG chain and counters are NOT exchanged: every host
    advances the identical chain (same seed, same dispatch count), which
    is what makes the post-exchange digests equal across hosts."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.utils.trees import tree_leaves

    return [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf)
            for leaf in tree_leaves([net.params, net.opt_state, net.state])]


def _install_leaves(net, leaves):
    """Write the averaged host leaves back into the net's tensors, in
    place (same shapes, dtypes and devices); the parameters stay the
    net's own tensors."""
    import torch

    from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

    it = iter(leaves)

    def put(tree):
        out = []
        for leaf in tree_leaves(tree):
            a = next(it)
            if isinstance(leaf, torch.Tensor):
                with torch.no_grad():
                    leaf.copy_(torch.from_numpy(a))
                out.append(leaf)
            else:
                out.append(type(leaf)(a) if isinstance(leaf, (int, float)) else a)
        return tree_like(tree, iter(out))

    put(net.params)
    net.opt_state = put(net.opt_state)
    net.state = put(net.state)


def _local_mesh(me, world):
    """A one-rank mesh of this host inside a job-wide group: every rank
    creates every rank's single-member group (``new_group`` is a
    collective), each keeps its own."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh as _mesh

    own = None
    for r in range(world):
        g = dist.new_group([r])
        if r == me:
            own = g
    return _mesh.Mesh((1, 1, 1, 1), 0, {a: own for a in _mesh.AXES},
                      {a: [me] for a in _mesh.AXES})


def _signatures(trainer):
    """What this host's steps resolve once per signature: the K-step
    engines' captures plus the kernels' plan-cache entries."""
    from deeplearning4j_tpu_torch.ops import _plans

    engines = list(getattr(trainer, "_steps_fns_fused", {}).values()) \
        + list(getattr(trainer.net, "_train_steps_fused", {}).values())
    return sum(int(getattr(e, "captures", 0)) for e in engines) \
        + sum(len(c) for c in _plans._caches)


def main(argv=None):
    p = argparse.ArgumentParser(description="hostfleet training worker")
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--generation", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="host:port of this generation's process-group rendezvous "
                        "(omit for a one-host job)")
    p.add_argument("--init-timeout-s", type=int, default=20)
    p.add_argument("--init-retries", type=int, default=2)
    p.add_argument("--exchange-port", type=int, default=None,
                   help="supervisor ExchangeServer port (hostavg mode)")
    p.add_argument("--exchange", default="auto", choices=("auto", "gspmd", "hostavg"))
    p.add_argument("--round-timeout-s", type=float, default=120.0)
    p.add_argument("--device", default="cuda",
                   help="device the host trains on: cuda (default) or cpu; the hosts of "
                        "a job share card 0 unless each has a card of its own")
    # model/stream shape (must match the reference legs)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--features", type=int, default=12)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--gen-seed", type=int, default=123)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--shard-params", default="zero1",
                   choices=("replicated", "zero1", "fsdp", "fsdp_stream"))
    # loop shape
    p.add_argument("--bundle", required=True,
                   help="layout-free save_bundle path: written by process 0 after every "
                        "round, the rollback/resume source")
    p.add_argument("--resume", action="store_true",
                   help="restore from --bundle (resharded into THIS topology) instead "
                        "of a fresh net")
    p.add_argument("--total-rounds", type=int, required=True)
    p.add_argument("--dispatches-per-round", type=int, default=1)
    p.add_argument("--heartbeat-dir", required=True)
    p.add_argument("--round-sleep-s", type=float, default=0.0,
                   help="sleep between the local steps and the exchange (chaos "
                        "harnesses land a SIGKILL mid-round here)")
    p.add_argument("--serve-registry", action="store_true",
                   help="process 0: hot-swap an in-process ModelRegistry from every "
                        "published snapshot (the snapshot -> serving handoff)")
    p.add_argument("--profile-round", type=int, default=None,
                   help="capture a torch.profiler window around exactly the n-th round "
                        "this process runs (1 = the first; a no-op off a card unless "
                        "DL4J_TPU_PROFILE_FORCE=1)")
    p.add_argument("--profile-dir", default=None,
                   help="trace directory for --profile-round (default "
                        "<heartbeat-dir>/profile/host<i>)")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.telemetry import goodput as _goodput
    from deeplearning4j_tpu_torch.telemetry import timeline as _timeline
    from deeplearning4j_tpu_torch.telemetry import tracectx as _tracectx
    telemetry.enable()

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.distributed import (initialize_distributed,
                                                               shutdown_distributed)
    from deeplearning4j_tpu_torch.utils.device import resolve_device

    me, world = args.process_id, args.num_processes
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        _emit({"hostfleet_error": str(e)[:500], "stage": "device", "process": me,
               "generation": args.generation})
        return RC_INIT_FAILED
    # one card a host where there are enough of them, else every host on
    # card 0; NCCL refuses two ranks on one GPU, so a shared card (and the
    # CPU) joins over gloo
    own_cards = device.type == "cuda" and torch.cuda.device_count() >= world
    if device.type == "cuda":
        device = torch.device("cuda", me if own_cards else 0)
        torch.cuda.set_device(device)
    backend = "nccl" if own_cards and world > 1 else "gloo"
    mode = args.exchange
    if mode == "auto":
        mode = "hostavg" if (world > 1 and device.type == "cpu") else "gspmd"
    if mode == "hostavg":
        backend = "gloo"  # the group only rendezvouses: the average rides the exchange
    if args.coordinator is not None:
        try:
            initialize_distributed(
                coordinator_address=args.coordinator, num_processes=world, process_id=me,
                backend=backend, initialization_timeout=args.init_timeout_s,
                connect_retries=args.init_retries)
        except Exception as e:  # noqa: BLE001 -- counted, reported, distinct rc
            _emit({"hostfleet_error": str(e)[:500], "stage": "distributed_init",
                   "process": me, "generation": args.generation,
                   "distributed_init_total": telemetry.series_map("distributed_init_total")})
            return RC_INIT_FAILED
    if mode == "hostavg" and world > 1 and args.exchange_port is None:
        _emit({"hostfleet_error": "hostavg exchange needs --exchange-port",
               "stage": "setup", "process": me})
        return RC_INIT_FAILED
    os.makedirs(args.heartbeat_dir, exist_ok=True)
    if not dist.is_initialized():
        # a one-host job: a world-1 group of its own (the trainer's mesh
        # lives on a group), rendezvous in this generation's directory
        dist.init_process_group("gloo", init_method="file://" + os.path.abspath(
            os.path.join(args.heartbeat_dir, f"pg_host{me}")), rank=0, world_size=1)

    from deeplearning4j_tpu_torch.continuous import chaos
    from deeplearning4j_tpu_torch.continuous.driver import StepDriver, _ShardedPlainEngine
    from deeplearning4j_tpu_torch.hostfleet.exchange import ExchangeClient, ExchangeError
    from deeplearning4j_tpu_torch.parallel import mesh as _mesh
    from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelTrainer
    from deeplearning4j_tpu_torch.utils.serialization import load_bundle, save_bundle

    if args.resume:
        net = load_bundle(args.bundle, device=str(device)).net
    else:
        net = chaos.smoke_net(seed=args.seed, features=args.features, hidden=args.hidden,
                              classes=args.classes, device=str(device))
        net.init()

    # the compute mesh: this host alone under hostavg (the cross-host
    # average is the exchange's job), every host under gspmd
    mesh = (_mesh.make_mesh(_mesh.MeshSpec(data=dist.get_world_size()))
            if mode == "gspmd" else _local_mesh(dist.get_rank(), dist.get_world_size()))
    shard = None if args.shard_params in ("replicated", "zero1") else args.shard_params
    trainer = ParallelTrainer(net, mesh, shard_params=shard,
                              shard_optimizer_state=args.shard_params != "replicated")
    # adopt covers fresh init AND resume: the bundle's whole host trees are
    # placed into THIS trainer's layouts on THIS topology, the
    # reshard-into-the-new-world step of the elastic story
    trainer.adopt_net_state()
    trainer.examples_dropped = 0  # the engine's indivisible-batch counter

    D = args.dispatches_per_round
    start_iter = int(trainer.iteration)
    start_round = start_iter // D
    # per-host deterministic stream under hostavg (each host trains its
    # own shard of the data); ONE shared stream under gspmd (the global
    # batch is split over the mesh inside the step)
    host_seed = args.gen_seed if mode == "gspmd" else args.gen_seed + 7919 * me
    batches = chaos.gen_batches(host_seed, args.total_rounds * D, batch=args.batch,
                                features=args.features, classes=args.classes)[start_iter:]

    def factory():
        return ((x, y, None) for x, y in batches)

    driver = StepDriver(trainer, factory, engine=_ShardedPlainEngine(trainer))
    if args.profile_round is not None:
        driver.profile_round(args.profile_round, args.profile_dir or os.path.join(
            args.heartbeat_dir, "profile", f"host{me}"))

    registry = None
    serve_update = None
    if args.serve_registry and me == 0:
        from deeplearning4j_tpu_torch.continuous.trainer import registry_updater
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
        registry = ModelRegistry()
        registry.register("hostfleet", net, buckets=[args.batch], input_spec=(args.features,),
                          device=str(device))
        serve_update = registry_updater(registry, "hostfleet")

    client = None
    if mode == "hostavg" and world > 1:
        try:
            client = ExchangeClient(args.exchange_port, me, timeout_s=args.round_timeout_s)
        except ExchangeError as e:
            _emit({"hostfleet_error": str(e)[:500], "stage": "exchange", "process": me})
            return RC_EXCHANGE_FAILED

    hb_path = os.path.join(args.heartbeat_dir, f"host{me}.json")
    _emit({"hostfleet_ready": True, "process": me, "world": world,
           "generation": args.generation, "pid": os.getpid(),
           "mode": mode, "resumed": bool(args.resume), "start_round": start_round,
           "local_devices": 1, "device": str(device), "backend": dist.get_backend(),
           "layout": trainer.layout, "clock": _timeline.clock_pair()})

    # the sharded engine's StepDriver is uninstrumented (no
    # train_step_seconds observes on fleet hosts), so the goodput ledger
    # is fed from the round edges the trace spans already time
    ledger = _goodput.get_ledger().start()
    signatures = []
    try:
        for rnd in range(start_round, args.total_rounds):
            tctx = _tracectx.maybe_start("hostfleet.round", round=rnd, process=me,
                                         generation=args.generation)
            t_steps = time.perf_counter()
            driver.run_round(D)
            driver.sync()
            ledger.note("compute", time.perf_counter() - t_steps)
            ledger.note_tokens(D * args.batch)
            if tctx is not None:
                tctx.add_span("hostfleet.steps", t_steps, time.perf_counter(), dispatches=D)
            if args.round_sleep_s:
                time.sleep(args.round_sleep_s)
            t_exch = time.perf_counter()
            # every rank joins sync_to_net's gathers (a collective under
            # gspmd); only a host that consumes the copy (the exchange, or
            # process 0's bundle) reads it to the host, below
            host_net = trainer.sync_to_net()
            if client is not None:
                avg = client.allreduce_mean(rnd, _host_leaves(host_net))
                _install_leaves(host_net, avg)
                # re-arm the trainer's layout from the averaged copy: the
                # same shapes, so the steady state holds (counted below)
                trainer.adopt_net_state()
            ledger.note("exchange", time.perf_counter() - t_exch)
            if tctx is not None:
                tctx.add_span("hostfleet.exchange", t_exch, time.perf_counter(), mode=mode)
            signatures.append(_signatures(trainer))
            t_hb = time.perf_counter()
            _atomic_write(hb_path, json.dumps(
                {"round": rnd, "iteration": int(trainer.iteration), "ts": time.time()}))
            if tctx is not None:
                tctx.add_span("hostfleet.heartbeat", t_hb, time.perf_counter())
            if me == 0:
                t_ck = time.perf_counter()
                tmp = args.bundle + ".tmp"
                save_bundle(host_net, tmp)
                os.replace(tmp, args.bundle)  # a resume never sees a half-written bundle
                ledger.note("checkpoint", time.perf_counter() - t_ck)
                if tctx is not None:
                    tctx.add_span("hostfleet.checkpoint", t_ck, time.perf_counter())
                _emit({"snapshot": args.bundle, "round": rnd})
                if serve_update is not None:
                    serve_update(args.bundle)
            line = {"round": rnd, "iteration": int(trainer.iteration), "process": me}
            if tctx is not None:
                tctx.finish()
                line["trace"] = tctx.trace.to_doc()
            _emit(line)
    except ExchangeError as e:
        _emit({"hostfleet_error": str(e)[:500], "stage": "exchange",
               "process": me, "generation": args.generation})
        return RC_EXCHANGE_FAILED
    finally:
        if client is not None:
            client.close()

    final_net = trainer.sync_to_net()
    serving_probe_diff = None
    if registry is not None:
        probe = chaos.gen_batches(args.gen_seed + 7, 1, batch=args.batch,
                                  features=args.features, classes=args.classes)[0][0]
        served = registry.output("hostfleet", probe)
        direct = final_net.output(probe)
        serving_probe_diff = float((torch.as_tensor(served).float().cpu()
                                    - direct.float().cpu()).abs().max())
        registry.unregister("hostfleet")

    # steady state is reached by the end of the second round; any growth
    # past it is a new signature (a recapture or a new plan)
    steady = signatures[min(1, len(signatures) - 1)] if signatures else 0
    recompiles = (signatures[-1] - steady) if signatures else 0

    _emit({"hostfleet_done": True, "process": me, "world": world,
           "generation": args.generation, "mode": mode,
           "digest": chaos.state_digest(final_net),
           "iteration": int(trainer.iteration),
           "rounds": args.total_rounds - start_round,
           "start_round": start_round,
           "serving_probe_diff": serving_probe_diff,
           "step_recompiles": int(recompiles),
           "goodput": ledger.snapshot(),
           "counters": {name: telemetry.series_map(name) for name in (
               "distributed_init_total", "recompiles_total", "compiles_total",
               "kernel_builds_total")}})
    shutdown_distributed()  # leave cleanly: a rejoin starts a NEW generation
    return 0


if __name__ == "__main__":
    sys.exit(main())
