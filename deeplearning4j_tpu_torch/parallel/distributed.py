"""The TrainingMaster tier over ``torch.distributed``.

The port of ``deeplearning4j_tpu/parallel/distributed.py`` (reference
analog: the Spark layer, ``ParameterAveragingTrainingMaster``,
``SharedTrainingMaster`` and the ``SparkDl4jMultiLayer`` facade). A worker
is a rank of the mesh's ``data`` group, one process each; every rank calls
``execute_training`` with the SAME global arrays and takes its worker's
slice of each split or step, which is what the JAX masters' ``shard_map``
does with a global array.

Unlike ``ParallelTrainer``, a master's workers are separate programs: each
normalises with its own batch's statistics (no batch group is set), and the
floating layer state (BatchNorm's running statistics) is averaged across
the workers after the step, as the JAX masters ``pmean`` it.

* ``ParameterAveragingTrainingMaster``: each worker runs
  ``averaging_frequency`` local steps of ``batch_size_per_worker`` rows on
  its own copy, then the parameters (and the updater state with
  ``average_updaters``) are averaged, one all-reduce a dtype.
* ``SharedTrainingMaster``: every step, each worker's gradient is
  exchanged, exact (``threshold=None``: the mean, an all-reduce) or
  threshold-compressed (quantize-with-residual with the adaptive tau of
  EncodingHandler: the ±tau part of each element whose residual reaches
  tau is sent, the rest carried; tau doubles above a flagged density of
  1/16 and decays by ``threshold_step`` below 1%). With
  ``shard_updater_state`` (the default) each worker keeps the flat 1/w
  slice of every updater-state leaf: the exchange is a reduce-scatter into
  that slice, the update runs on it and one all-gather rebuilds the
  parameters, then the net's constraints run.
* ``EncodedGradientsAccumulator``: the host-thread exchange over
  ``native/codec.py`` and ``native/queue.py``.

The threshold step is elementwise PyTorch (it is no Pallas kernel in the
JAX package either). ``initialize_distributed`` joins a process group from
its arguments or the environment (``torchrun``'s variables).

Telemetry (JAX ``distributed.py:81``, ``:149``, ``:239``, ``:263``,
``:476-491``, ``:705``, ``:717-728``): joins count into
``distributed_init_total{outcome}``; with telemetry on each round is a
``distributed.round`` trace and span, timed into
``distributed_round_seconds{master, host}`` and counted into
``distributed_rounds_total`` (host wall time: over gloo it covers the
collective, over NCCL its dispatch — no sync is added), the worker rollup
runs in a ``distributed.worker_rollup`` span and sets the per-worker
gauges, and the shared master records its trees' bytes
(``devices.note_train_tree_bytes``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.native import codec as _codec
from deeplearning4j_tpu_torch.native.queue import FancyBlockingQueue
from deeplearning4j_tpu_torch.nn.layers.base import split_seed, step_seed
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.telemetry import health as _health
from deeplearning4j_tpu_torch.telemetry.scorepipe import ScorePipeline
from deeplearning4j_tpu_torch.utils import collectives as C
from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

# ----------------------------------------------------------------------
# the process group
# ----------------------------------------------------------------------

def _host_label():
    """This process's rank in the default group ("0" without one): the
    ``host`` label of the round series."""
    return str(dist.get_rank()) if dist.is_initialized() else "0"


def _init_counter():
    reg = _tm.get_registry()
    c = reg.counter(
        "distributed_init_total",
        "process-group joins, by outcome (ok = joined, retried = one "
        "attempt failed and was retried with backoff, failed = the retry "
        "budget ran out)")
    if reg.enabled:
        for outcome in ("ok", "retried", "failed"):
            c.inc(0, outcome=outcome)
    return c


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           local_device_ids=None, *, backend=None, initialization_timeout=None,
                           connect_retries=0, retry_backoff_s=1.0):
    """Join the default process group: at ``tcp://coordinator_address``
    with ``num_processes`` ranks as rank ``process_id``, or from the
    environment that ``torchrun`` sets (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) when no address is given. A no-op
    returning False for a single process. ``backend`` defaults to NCCL
    with a card and gloo without; ``local_device_ids`` (one id) selects
    this rank's card. A failed join retries ``connect_retries`` times,
    ``retry_backoff_s * 2**attempt`` apart, and then raises. Returns
    True once joined."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None and (num_processes is None or num_processes <= 1) \
            and env_world <= 1:
        return False
    if dist.is_initialized():
        return True
    if local_device_ids is not None and torch.cuda.is_available():
        ids = list(local_device_ids) if hasattr(local_device_ids, "__iter__") \
            else [local_device_ids]
        torch.cuda.set_device(int(ids[0]))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(initialization_timeout))
    if coordinator_address is not None:
        kw.update(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id or 0))
    else:
        kw.update(init_method="env://")
    counter = _init_counter()
    for attempt in range(int(connect_retries) + 1):
        try:
            dist.init_process_group(backend, **kw)
            counter.inc(outcome="ok")
            return True
        except Exception:  # noqa: BLE001 -- a failed join: retry or raise
            shutdown_distributed()
            if attempt >= int(connect_retries):
                counter.inc(outcome="failed")
                raise
            counter.inc(outcome="retried")
            time.sleep(float(retry_backoff_s) * (2 ** attempt))
    return False


def shutdown_distributed():
    """Leave the default process group; True when one was left. Never
    raises (teardown rides failure paths)."""
    try:
        if not dist.is_initialized():
            return False
        dist.destroy_process_group()
        return True
    except Exception:  # noqa: BLE001 -- nothing to leave
        return False


# ----------------------------------------------------------------------
# the TrainingMaster SPI
# ----------------------------------------------------------------------

class TrainingMaster:
    """A strategy that trains a network over a data source across the
    workers of a mesh (reference: spark/api/TrainingMaster.java)."""

    def execute_training(self, net, data, labels=None, *, epochs=1):
        raise NotImplementedError

    def training_stats(self):
        return dict(self._stats) if hasattr(self, "_stats") else {}

    def _init_workers(self, mesh):
        self.mesh = mesh if mesh is not None else _mesh.make_mesh()
        self.group = self.mesh.group("data")
        self.n_workers = self.mesh.shape["data"]
        self.worker = self.mesh.coords["data"]

    @staticmethod
    def _round_metrics():
        """(registry, round_hist, rounds_counter): the per-round series
        every master shares, split by ``master`` and ``host``."""
        reg = _tm.get_registry()
        return (reg,
                reg.histogram("distributed_round_seconds",
                              "wall time of one distributed round (local steps + "
                              "parameter/gradient exchange), labeled by master and host"),
                reg.counter("distributed_rounds_total",
                            "distributed rounds executed, labeled by master and host"))

    def _round_done(self, master, t_round, tctx):
        reg, round_h, rounds_c = self._round_metrics()
        if reg.enabled:
            round_h.observe(time.perf_counter() - t_round, master=master, host=_host_label())
            rounds_c.inc(master=master, host=_host_label())
        if tctx is not None:
            tctx.finish()

    def _worker_health_rollup(self, nonfinite, norm, norm_key, master, step):
        """Gather each worker's non-finite flag and norm (one all-gather),
        record them in ``training_stats()["workers"]`` (and the per-worker
        gauges) and tell the numerics watchdog which workers went
        non-finite, before the average smears a bad worker across the
        fleet."""
        with _tm.span("distributed.worker_rollup", master=master):
            v = torch.stack([nonfinite.float().reshape(()), norm.float().reshape(())])
            vals = C.all_gather(v.reshape(-1), self.group).view(self.n_workers, 2).cpu().numpy()
            reg = _tm.get_registry()
            if reg.enabled:
                g_nf = reg.gauge("distributed_worker_nonfinite",
                                 "1 when this worker's last round saw NaN/Inf, labeled by "
                                 "master, host and worker")
                g_norm = reg.gauge(f"distributed_worker_{norm_key}",
                                   f"per-worker {norm_key.replace('_', ' ')} at the last "
                                   "exchange, labeled by master, host and worker")
                for w in range(self.n_workers):
                    g_nf.set(float(vals[w, 0]), master=master, host=_host_label(), worker=w)
                    g_norm.set(float(vals[w, 1]), master=master, host=_host_label(), worker=w)
        self._stats["workers"] = [{"worker": w, "nonfinite": bool(vals[w, 0]),
                                   norm_key: float(vals[w, 1])} for w in range(self.n_workers)]
        bad = [w for w in range(self.n_workers) if vals[w, 0]]
        if bad:
            _health.get_monitor().note_anomaly("distributed_nonfinite", step=step,
                                               master=master, workers=bad,
                                               n_workers=self.n_workers)

    def _mean(self, tensors):
        """The workers' mean of each tensor, in place (one all-reduce a
        dtype)."""
        from deeplearning4j_tpu_torch.parallel.data_parallel import _all_reduce_mean
        ts = [t for t in tensors if torch.is_tensor(t)]
        if not ts:
            return
        with torch.no_grad():
            for t, m in zip(ts, _all_reduce_mean([t.detach() for t in ts], self.group,
                                                 self.n_workers)):
                t.copy_(m)

    def _mean_float_state(self, state):
        self._mean([t for t in tree_leaves(state)
                    if torch.is_tensor(t) and t.is_floating_point()])

    def _dev(self, net, a, rows):
        """Rows ``rows`` of a host or device array, on the net's device."""
        t = a[rows]
        t = t if torch.is_tensor(t) else torch.from_numpy(np.ascontiguousarray(t))
        return t.to(net.device)

    def _emit(self, net, listeners, resolved):
        if resolved is not None:
            for l in listeners:
                l.iteration_done(net, resolved[1], resolved[0])


class ParameterAveragingTrainingMaster(TrainingMaster):
    """Synchronous parameter averaging over the mesh's data axis (reference:
    ParameterAveragingTrainingMaster.java:287-293): per split, every worker
    fits ``averaging_frequency`` minibatches of ``batch_size_per_worker``
    rows on its own copy, then the parameters (and the updater state with
    ``average_updaters``) are averaged."""

    def __init__(self, mesh=None, *, batch_size_per_worker=32, averaging_frequency=5,
                 average_updaters=True):
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        self._init_workers(mesh)
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.averaging_frequency = int(averaging_frequency)
        self.average_updaters = bool(average_updaters)
        self._stats = {"splits": 0, "worker_steps": 0}

    def execute_training(self, net, data, labels=None, *, epochs=1):
        """Fit ``net`` on host arrays (the same on every rank); returns the
        last split's mean loss over workers and steps."""
        if net.params is None:
            net.init()
        if net.opt_state is None:
            net.opt_state = net.conf.updater.init(net.params)
        with_health = _health.get_monitor().active
        n, w, f, b = len(data), self.n_workers, self.averaging_frequency, \
            self.batch_size_per_worker
        split_examples = w * f * b
        if n < split_examples:
            raise ValueError(f"need at least {split_examples} examples per split "
                             f"(workers {w} x freq {f} x batch {b}), got {n}")
        step_fn = net.make_train_step()
        it0 = int(getattr(net, "iteration", 0))
        loss = None
        listeners = list(getattr(net, "listeners", []))
        pipe = ScorePipeline()
        rem = n % split_examples
        for ep in range(epochs):
            start = (ep * rem) % (rem + 1) if rem else 0
            self._stats["examples_dropped"] = self._stats.get("examples_dropped", 0) + rem
            for s0 in range(start, n - split_examples + 1, split_examples):
                t_round = time.perf_counter()
                tctx = _tm.tracectx.maybe_start("distributed.round", master="parameter_averaging")
                with _tm.tracectx.attach(tctx), _tm.span("distributed.round",
                                                         master="parameter_averaging"):
                    base = s0 + self.worker * f * b
                    seed = split_seed(step_seed(net.conf.seed + 1, it0), w)[self.worker]
                    losses = []
                    for i in range(f):
                        rows = slice(base + i * b, base + (i + 1) * b)
                        out = step_fn(net.params, net.state, net.opt_state,
                                      self._dev(net, data, rows), self._dev(net, labels, rows),
                                      it0 + i, None, step_seed(seed, i))
                        net.state = out[1]
                        losses.append(out[3])
                    local = torch.stack(losses)
                    if with_health:
                        self._worker_health_rollup(
                            ~torch.isfinite(local).all(), _health.tree_sq_sum(net.params).sqrt(),
                            "param_norm", "parameter_averaging", it0)
                    self._mean(list(tree_leaves(net.params)))
                    if self.average_updaters:
                        self._mean(list(tree_leaves(net.opt_state)))
                    loss = C.all_reduce_(local.mean().reshape(1), self.group)[0] / w
                self._round_done("parameter_averaging", t_round, tctx)
                it0 += f
                self._stats["splits"] += 1
                self._stats["worker_steps"] += w * f
                if listeners:
                    self._emit(net, listeners, pipe.push(loss, it0))
        self._emit(net, listeners, pipe.flush())
        # replicas are identical after the average; the layer state (and the
        # updater state when it was not averaged) folds by the mean
        self._mean_float_state(net.state)
        if not self.average_updaters:
            self._mean(list(tree_leaves(net.opt_state)))
        net.iteration = it0
        net.epoch = int(getattr(net, "epoch", 0)) + epochs
        return None if loss is None else float(loss)


class SharedTrainingMaster(TrainingMaster):
    """Per-step gradient sharing over the mesh's data axis (reference:
    SharedTrainingMaster.java + EncodingHandler.java:28); see the module
    docstring. ``threshold=None`` is the exact synchronous mean."""

    def __init__(self, mesh=None, *, batch_size_per_worker=32, threshold=None,
                 min_threshold=1e-5, threshold_step=1e-5, shard_updater_state=True):
        if threshold is not None and threshold <= 0:
            raise ValueError("threshold must be positive; pass threshold=None for exact "
                             "(uncompressed) gradient all-reduce")
        self._init_workers(mesh)
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.threshold = threshold
        self.min_threshold = float(min_threshold)
        self.threshold_step = float(threshold_step)
        self.shard_updater_state = bool(shard_updater_state)
        self.residual = None
        self._stats = {"steps": 0, "updater_state_sharded": self.shard_updater_state}

    def _flat_shard(self, a):
        """This worker's flat 1/w slice of ``a`` (padded to a multiple of w)."""
        return _padded_rows(a, self.n_workers)[self.worker].clone()

    def _step(self, net, params, opt, x, y, it, rng, tau):
        compress = self.threshold is not None
        w = self.n_workers
        loss, new_state, grads = net.compute_gradients(params, net.state, x, y, rng=rng)
        nonfinite = norm = None
        if _health.get_monitor().active:
            nonfinite = _health.any_nonfinite(grads) | ~torch.isfinite(loss)
            norm = _health.tree_sq_sum(grads).sqrt()
        g_leaves = list(tree_leaves(grads))
        trainable = list(tree_leaves(net._trainable(params)))
        density = None
        if compress:
            with torch.no_grad():
                resid = self.residual
                q = []
                nflag = torch.zeros((), dtype=torch.float32, device=loss.device)
                ntot = 0
                for r, g in zip(resid, g_leaves):
                    r.add_(g)
                    flags = (r.abs() >= tau).to(r.dtype)
                    qq = torch.sign(r) * tau.to(r.dtype) * flags
                    r.sub_(qq)
                    q.append(qq)
                    nflag = nflag + flags.sum().float()
                    ntot += flags.numel()
                density = C.all_reduce_((nflag / ntot).reshape(1), self.group)[0] / w
                tau = torch.where(density > 1.0 / 16.0, torch.clamp(tau * 2.0, max=1.0),
                                  torch.where(density < 0.01,
                                              torch.clamp(tau - self.threshold_step,
                                                          min=self.min_threshold), tau))
            exchange = q
        else:
            exchange = g_leaves
        from deeplearning4j_tpu_torch.parallel.data_parallel import _all_reduce_mean
        if self.shard_updater_state:
            # reduce-scatter the (quantized) gradients into this worker's
            # flat slice, update the slice, all-gather the parameters
            with torch.no_grad():
                p_shards = [self._flat_shard(p) for p in trainable]
                g_shards = [None] * len(trainable)
                for js in _by_dtype(trainable):
                    # one [w, sum of slices] buffer a dtype: one reduce-scatter
                    send = torch.cat([_padded_rows(exchange[j], w) for j in js], dim=1)
                    flat = C.reduce_scatter(send.reshape(-1), self.group) / w
                    for j, part in zip(js, flat.split([p_shards[j].numel() for j in js])):
                        g_shards[j] = part
                net.conf.updater.update_(p_shards, g_shards, opt, it)
                for js in _by_dtype(trainable):
                    whole = C.all_gather(torch.cat([p_shards[j] for j in js]), self.group)
                    rows = whole.view(w, -1).split([p_shards[j].numel() for j in js], dim=1)
                    for j, r in zip(js, rows):
                        p = trainable[j]
                        p.copy_(r.reshape(-1)[:p.numel()].view_as(p))
            net.apply_constraints(params, it)
        else:
            shared = _all_reduce_mean([g.detach() for g in exchange], self.group, w)
            net.apply_update(params, opt, tree_like(net._trainable(params), iter(shared)), it)
        self._mean_float_state(new_state)
        loss = C.all_reduce_(loss.reshape(1).clone(), self.group)[0] / w
        return new_state, loss, tau, density, nonfinite, norm

    def execute_training(self, net, data, labels=None, *, epochs=1):
        """Fit ``net`` on host arrays (the same on every rank); returns the
        last step's mean loss over workers."""
        if net.params is None:
            net.init()
        if net.opt_state is None:
            net.opt_state = net.conf.updater.init(net.params)
        w, b = self.n_workers, self.batch_size_per_worker
        n = len(data)
        step_examples = w * b
        if n < step_examples:
            raise ValueError(f"need >= {step_examples} examples per step")
        params = net.params
        trainable = list(tree_leaves(net._trainable(params)))
        if self.shard_updater_state:
            # each worker's flat 1/w slice of every (param-shaped) updater leaf
            opt = net.conf.updater.init([self._flat_shard(p) for p in trainable])
            full_opt = net._trainable(net.opt_state)
            for o_shard, o_full in zip(_param_shaped(opt, len(trainable)),
                                       _param_shaped(full_opt, len(trainable))):
                with torch.no_grad():
                    for s, f in zip(o_shard, o_full):
                        s.copy_(self._flat_shard(f))
        else:
            opt = net.opt_state
        from deeplearning4j_tpu_torch.telemetry import devices as _devices
        _devices.note_train_tree_bytes(params=params, opt_state=opt, site="shared_master")
        self.residual = [torch.zeros_like(p.detach()) for p in trainable]
        tau = torch.tensor(self.threshold if self.threshold is not None else 0.0,
                           dtype=torch.float32, device=net.device)
        it = int(getattr(net, "iteration", 0))
        loss = None
        listeners = list(getattr(net, "listeners", []))
        pipe = ScorePipeline()
        rem = n % step_examples
        densities = []
        for ep in range(epochs):
            start = (ep * rem) % (rem + 1) if rem else 0
            self._stats["examples_dropped"] = self._stats.get("examples_dropped", 0) + rem
            for s0 in range(start, n - step_examples + 1, step_examples):
                t_round = time.perf_counter()
                tctx = _tm.tracectx.maybe_start("distributed.round", master="shared")
                with _tm.tracectx.attach(tctx), _tm.span("distributed.round", master="shared"):
                    rows = slice(s0 + self.worker * b, s0 + (self.worker + 1) * b)
                    net.state, loss, tau, density, nonfinite, norm = self._step(
                        net, params, opt, self._dev(net, data, rows),
                        self._dev(net, labels, rows), it, step_seed(net.conf.seed + 2, it), tau)
                    if density is not None:
                        densities.append(density)
                    if nonfinite is not None:
                        self._worker_health_rollup(nonfinite, norm, "grad_norm", "shared", it)
                self._round_done("shared", t_round, tctx)
                it += 1
                self._stats["steps"] += 1
                if listeners:
                    self._emit(net, listeners, pipe.push(loss, it))
        self._emit(net, listeners, pipe.flush())
        if self.shard_updater_state:
            # the flat slices reassembled into the net's param-shaped state
            full_opt = net._trainable(net.opt_state)
            with torch.no_grad():
                for o_shard, o_full in zip(_param_shaped(opt, len(trainable)),
                                           _param_shaped(full_opt, len(trainable))):
                    for s, f in zip(o_shard, o_full):
                        f.copy_(C.all_gather(s, self.group)[:f.numel()].view_as(f))
        else:
            net.opt_state = opt
        net.iteration = it
        net.epoch = int(getattr(net, "epoch", 0)) + epochs
        self._stats["final_threshold"] = float(tau)
        if densities:
            self._stats["densities"] = [float(d) for d in densities]
        return None if loss is None else float(loss)


def _padded_rows(t, w):
    """``t`` flattened, zero-padded to a multiple of ``w``, as [w, c]."""
    v = t.detach().reshape(-1)
    pad = (-v.numel()) % w
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return v.view(w, -1)


def _by_dtype(tensors):
    """Indices of ``tensors`` grouped by dtype, in order."""
    groups = {}
    for j, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(j)
    return list(groups.values())


def _param_shaped(opt, n):
    """The params-shaped entries of an updater state as lists of its
    ``n`` leaves each (Adam: [m leaves, v leaves]; Nesterovs: [its leaves];
    Sgd: [])."""
    leaves = list(tree_leaves(opt))
    if len(leaves) == n:
        return [leaves]
    if hasattr(opt, "items"):
        return [list(tree_leaves(v)) for v in opt.values()
                if sum(1 for _ in tree_leaves(v)) == n]
    return []


# ----------------------------------------------------------------------
# the facade (reference: SparkDl4jMultiLayer / SparkComputationGraph)
# ----------------------------------------------------------------------

class DistributedMultiLayer:
    """A network paired with a TrainingMaster (reference:
    SparkDl4jMultiLayer): ``fit`` trains through the master; evaluation and
    inference run on the synced local copy."""

    def __init__(self, net, training_master):
        self.net = net
        self.master = training_master
        if net.params is None:
            net.init()

    def fit(self, data, labels=None, *, epochs=1):
        if labels is None:  # an iterator of (x, y) batches
            xs, ys = zip(*list(data))
            data = np.concatenate([np.asarray(a) for a in xs])
            labels = np.concatenate([np.asarray(a) for a in ys])
        return self.master.execute_training(self.net, np.asarray(data), np.asarray(labels),
                                            epochs=epochs)

    def output(self, x, **kw):
        return self.net.output(x, **kw)

    def score(self, x, y, **kw):
        return self.net.score(x, y, **kw)

    def training_stats(self):
        return self.master.training_stats()


# ----------------------------------------------------------------------
# host-side encoded accumulator (reference: EncodedGradientsAccumulator)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _WorkerSlot:
    consumer: int
    residual: np.ndarray
    schedule: _codec.AdaptiveThreshold


class EncodedGradientsAccumulator:
    """Host-thread gradient exchange with threshold compression (reference:
    EncodedGradientsAccumulator.java + FancyBlockingQueue.java): N host
    workers publish threshold-encoded updates; every worker consumes every
    message exactly once, its own included, which keeps replicas equal."""

    def __init__(self, n_params: int, n_workers: int, *, threshold=1e-3, min_threshold=1e-5,
                 threshold_step=1e-5, shake_frequency=0, capacity=256):
        self.n_params = int(n_params)
        self.queue = FancyBlockingQueue(capacity=capacity)
        self._lock = threading.Lock()
        self._slots: dict[int, _WorkerSlot] = {}
        for w in range(n_workers):
            self._slots[w] = _WorkerSlot(
                consumer=self.queue.register_consumer(),
                residual=np.zeros(self.n_params, np.float32),
                schedule=_codec.AdaptiveThreshold(initial=threshold, min_threshold=min_threshold,
                                                  step=threshold_step,
                                                  shake_frequency=shake_frequency))
        self.bytes_published = 0
        self.messages_published = 0

    def store_update(self, worker: int, gradient, timeout=None) -> bool:
        """Encode this worker's gradient (plus its carried residual) and
        publish it; an undelivered message's mass goes back into the
        residual."""
        slot = self._slots[worker]
        g = gradient.detach().cpu().numpy() if torch.is_tensor(gradient) else gradient
        g = np.asarray(g, np.float32).reshape(-1)
        if g.size != self.n_params:
            raise ValueError(f"gradient size {g.size} != {self.n_params}")
        slot.residual += g
        tau = slot.schedule.current()
        msg = _codec.encode(slot.residual, tau)
        slot.schedule.observe(msg)
        ok = self.queue.put(msg, timeout=timeout)
        if ok:
            with self._lock:
                self.bytes_published += msg.nbytes()
                self.messages_published += 1
        else:
            _codec.decode(msg, slot.residual)
        return ok

    def apply_updates(self, worker: int, target: np.ndarray) -> int:
        """Drain and decode every pending message into ``target`` (flat
        f32); returns how many were applied."""
        slot = self._slots[worker]
        applied = 0
        while self.queue.pending(slot.consumer) > 0:
            msg = self.queue.poll(slot.consumer, timeout=1.0)
            if msg is None:
                break
            _codec.decode(msg, target)
            applied += 1
        return applied

    def has_anything(self, worker: int) -> bool:
        return self.queue.pending(self._slots[worker].consumer) > 0

    def close(self):
        self.queue.close()
