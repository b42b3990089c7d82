"""StepDriver: the resumable dispatch loop every fit path of the port runs.

The port of ``deeplearning4j_tpu/continuous/driver.py``. ``fit`` of both
network kinds delegates here, at K=1 and at K > 1, so the loop's contract
lives in one place:

* ``run_round(k_dispatches)`` consumes up to that many dispatches of the
  current epoch (starting one if none is open; ``None``: to its end) and
  returns a ``RoundResult``; params, layer state, updater state and the
  iteration (from which the step seeds follow) are live on the net, and
  the score pipeline and the health monitor hold at most one pending
  entry each.
* Scores resolve one dispatch late (``telemetry.ScorePipeline``): each
  resolved step's loss lands in ``net.score_history`` and reaches the
  listeners' ``iteration_done``, the epoch's last before its
  ``on_epoch_end``. Health bundles resolve one dispatch late too
  (``telemetry.health``), when the watchdog was armed as the driver was
  built.
* ``sync()`` drains both (a ``raise`` watchdog policy raises
  ``NumericsError`` here, one round late); ``checkpoint(path)`` is
  ``sync()`` then ``utils.serialization.save_bundle``; ``restore(bundle)``
  re-arms params, state, updater state and the iteration from a bundle,
  so the run resumes bit-exactly. The restored tensors are new ones, so a
  K-step engine rebuilds its CUDA graph at the next dispatch.
* ``run(epochs)`` is the fit loop: epochs of ``run_round(None)``, the
  health tail flushed, and in ``finally`` the pending score dropped, the
  prefetch producer joined and the listeners' ``on_fit_end`` hooks run.

Engines say what one dispatch is: ``_PlainEngine`` (K=1, one minibatch
through ``net.make_train_step``; a batch ``tbptt_fn`` accepts runs the
net's truncated-BPTT chunks instead) and ``_FusedEngine`` (K > 1, one
super-batch through the ``nn/fused.py`` engine, assembled and copied to
the card by the prefetch thread). ``ParallelTrainer.fit``
(``parallel/data_parallel.py``) runs the sharded engines over the trainer,
which stands in for the net: ``_ShardedPlainEngine`` (K=1, one
``trainer.step`` on the global batch; a batch whose leading dim does not
divide by the data axis is skipped and counted, not dispatched) and
``_ShardedFusedEngine`` (K > 1, the K-step engine over the trainer's step,
each super-batch cut to the rank's rows before it is copied to the card).
Telemetry (JAX ``driver.py:386-401``, ``:446``, ``:499``, ``:543-561``,
``:602``): a network's fit loop is instrumented — with telemetry on, the
whole fit runs in a ``fit`` span and each dispatch in a request trace with
``fit.etl`` and ``fit.step`` spans (the one-late score fetch of the
previous dispatch recorded in that dispatch's trace as
``train.score_fetch``), ``telemetry.scorepipe.StepRecordEmitter`` records
each resolved step (histograms, counter, score gauge, HBM gauges, flight
ring), ``devices.note_jit_cache`` counts a K-step engine's CUDA-graph
captures, and an uncaught exception dumps the flight ring. A span opens
around a dispatch (a graph's replay), never inside a capture. Telemetry
off, each site is one branch. A ``ParallelTrainer`` fit runs the lite loop
(scores and listeners only), as in the JAX package. ``profile_round(n,
logdir)`` runs the n-th round from now inside a ``torch.profiler`` window
(``telemetry/profiling.py``). The goodput ledger (JAX ``:397``, ``:660``):
with telemetry on, an instrumented driver opens the process's goodput
window as it is built, and ``checkpoint`` notes its seconds under
``checkpoint``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.nn import listeners as _listeners
from deeplearning4j_tpu_torch.nn.layers.base import step_seed
from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.telemetry import devices as _devices
from deeplearning4j_tpu_torch.telemetry import flight as _flight
from deeplearning4j_tpu_torch.telemetry import health as _health
from deeplearning4j_tpu_torch.telemetry.scorepipe import ScorePipeline, StepRecordEmitter
from deeplearning4j_tpu_torch.utils import compile_cache as _cc

__all__ = ["StepDriver", "RoundResult"]


@dataclasses.dataclass
class RoundResult:
    """What one ``run_round`` consumed: ``dispatches`` dispatches covering
    ``steps`` updater steps; ``epoch_done`` marks the source's end (the
    epoch-end listeners have run)."""

    dispatches: int = 0
    steps: int = 0
    epoch_done: bool = False


def _first(tree):
    return next(iter(tree.values())) if isinstance(tree, dict) else tree


def _tensor(a, device):
    if a is None:
        return None
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device)


def _on_device(tree, device):
    if isinstance(tree, dict):
        return {k: _tensor(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


class _PlainEngine:
    """K=1: one ``(x, y, mask)`` minibatch a dispatch through the net's
    train step."""

    fused = False
    trace_root = "train.step"

    def __init__(self, net, use_health, tbptt_fn=None):
        self.net = net
        self.use_health = use_health
        self.tbptt_fn = tbptt_fn
        self.step_fn = net.make_train_step(with_health=use_health)

    def cache_fn(self):
        return self.step_fn

    def build_source(self, batch_factory):
        return batch_factory()

    def prepare(self, item):
        x, y, m = item
        dev = self.net.device
        return _on_device(x, dev), _on_device(y, dev), _tensor(m, dev)

    def note_input(self, prep):
        self.net.last_input = _first(prep[0])

    def n_real(self, item):
        return 1

    def dispatch(self, prep, n_real):
        """Returns (loss, health bundle or None, TBPTT chunks or None)."""
        net = self.net
        x, y, m = prep
        if self.tbptt_fn is not None and self.tbptt_fn(x, y):
            # truncated BPTT: the net's chunk loop; a graph's comes with its
            # chunks' (iteration, loss), one listener callback each
            out = net._fit_tbptt(x, y, m)
            return (out[0], None, out[1]) if isinstance(out, tuple) else (out, None, None)
        out = self.step_fn(net.params, net.state, net.opt_state, x, y, net.iteration, m,
                           step_seed(net.conf.seed, net.iteration))
        net.state, net.opt_state = out[1], out[2]
        net.iteration += 1
        return out[3], (out[4] if self.use_health else None), None


class _FusedEngine:
    """K > 1: one stacked super-batch a dispatch through the K-step engine
    (``nn/fused.py``), assembled and copied to the net's device on the
    prefetch thread."""

    fused = True
    trace_root = "train.dispatch"

    def __init__(self, net, k, use_health, batch_size=None, prefetch=True):
        from deeplearning4j_tpu_torch.nn import fused as _fused
        self.net = net
        self.k = int(k)
        self.use_health = use_health
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.steps_fn = _fused._steps_fn_for(net, k, use_health)

    def build_source(self, batch_factory):
        from deeplearning4j_tpu_torch.datasets.iterator import (AsyncDataSetIterator,
                                                                SuperBatchIterator)
        sbit = SuperBatchIterator(batch_factory, self.k, batch_size=self.batch_size)
        if not self.prefetch:
            return sbit
        return AsyncDataSetIterator(sbit, queue_size=2, device=self.net.device)

    def prepare(self, sb):
        return sb.features, sb.labels, sb.labels_mask, sb.step_valid

    def cache_fn(self):
        """The K-step engine (its ``captures`` count the CUDA graphs)."""
        return self.steps_fn

    def note_input(self, prep):
        if self.net.listeners:
            self.net.last_input = _first(prep[0])[0]

    def n_real(self, item):
        return item.n_steps

    def dispatch(self, prep, n_real):
        net = self.net
        xs, ys, ms, sv = prep
        out = self.steps_fn(net.params, net.state, net.opt_state, xs, ys, net.iteration,
                            net.conf.seed, ms, sv)
        losses, hb = out if self.use_health else (out, None)
        net.iteration += n_real
        return losses, hb, None


class _ShardedPlainEngine:
    """ParallelTrainer, K=1: one ``trainer.step`` a dispatch on the global
    batch; a batch whose leading dim does not divide by the data axis is
    skipped and counted in ``trainer.examples_dropped``."""

    fused = False
    sharded = True

    def __init__(self, trainer):
        self.trainer = trainer
        self.net = trainer

    def build_source(self, batch_factory):
        return batch_factory()

    def prepare(self, item):
        return item

    def note_input(self, prep):
        pass

    def n_real(self, item):
        return 1

    def dispatch(self, prep, n_real):
        x, y, m = prep
        t = self.trainer
        rows = _first(x).shape[0]
        if rows % t.world:
            t.examples_dropped += int(rows)
            return None  # skipped: not a dispatch
        return t.step(x, y, m), None, None


class _LocalRows(DataSetIterator):
    """Super-batches cut to one rank's rows ([K, B, ...] -> [K, B/N, ...]),
    on the host, before the prefetch copy."""

    def __init__(self, base, trainer):
        self.base, self.trainer = base, trainer

    @property
    def batch_size(self):
        return self.base.batch_size

    def __iter__(self):
        self.reset()
        return self

    def reset(self):
        self.base.reset()

    def __next__(self):
        from deeplearning4j_tpu_torch.parallel import mesh as _mesh
        sb = next(self.base)
        t = self.trainer
        spec = _mesh.superbatch_sharded(t.mesh)

        def rows(a):
            if isinstance(a, dict):
                return {k: rows(v) for k, v in a.items()}
            return _mesh.local_part(t.mesh, a, spec).contiguous()
        sb.features, sb.labels, sb.labels_mask = rows(sb.features), rows(sb.labels), \
            rows(sb.labels_mask)
        return sb


class _ShardedFusedEngine(_FusedEngine):
    """ParallelTrainer, K > 1: the K-step engine over the trainer's step,
    each super-batch cut to this rank's rows and copied to the card on the
    prefetch thread."""

    sharded = True

    def __init__(self, trainer, k, batch_size=None, prefetch=True):
        self.net = trainer
        self.trainer = trainer
        self.k = int(k)
        self.use_health = False
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.steps_fn = trainer._steps_fn(self.k)
        trainer._plan.timed = False  # a captured step cannot synchronize
        if trainer.shard_params in ("fsdp", "fsdp_stream"):
            # the graph gathers into whole tensors it keeps across replays
            trainer._free_between_steps = False
            trainer._gather_full()

    def build_source(self, batch_factory):
        from deeplearning4j_tpu_torch.datasets.iterator import (AsyncDataSetIterator,
                                                                SuperBatchIterator)
        sbit = _LocalRows(SuperBatchIterator(batch_factory, self.k, batch_size=self.batch_size),
                          self.trainer)
        if not self.prefetch:
            return sbit
        return AsyncDataSetIterator(sbit, queue_size=2, device=self.trainer.device)

    def dispatch(self, prep, n_real):
        t = self.trainer
        xs, ys, ms, sv = prep
        losses = self.steps_fn(t.params, t.state, t.opt_state, xs, ys, t.iteration,
                               t.conf.seed, ms, sv)
        t.iteration += n_real
        return losses, None, None


def _rearm_net(net, restored):
    """Put a restored network's tensors, counters and step RNG chain on the
    live net (the engines hold the live net). The tensors are new objects:
    a K-step engine's graph over the old ones is rebuilt."""
    if hasattr(net, "vertex_params"):
        net.vertex_params = restored.vertex_params
    else:
        net.layer_params = restored.layer_params
    net.state = restored.state
    if restored.opt_state is not None:
        net.opt_state = restored.opt_state
    net.rng = restored.rng
    net.iteration = restored.iteration
    net.epoch = restored.epoch


class StepDriver:
    """Resumable dispatch loop over one engine (see the module docstring).
    ``batch_factory`` is a zero-argument callable returning a fresh
    ``(x, y, mask)`` iterable an epoch; a K-step engine wraps it in the
    super-batching (and prefetching) source once and re-enters it at each
    epoch."""

    def __init__(self, net, batch_factory, *, k=1, batch_size=None, prefetch=True,
                 tbptt_fn=None, engine=None):
        self.net = net
        self.batch_factory = batch_factory
        self.k = int(k)
        self._hm = _health.get_monitor()
        # read once: the step's health variant is chosen as the driver is built
        self._use_health = self._hm.active
        if net.params is None:
            net.init()
        if net.opt_state is None:
            net.opt_state = net.conf.updater.init(net.params)
        if engine is not None:
            self.engine = engine
        else:
            self.engine = (_FusedEngine(net, self.k, self._use_health, batch_size=batch_size,
                                        prefetch=prefetch) if self.k > 1
                           else _PlainEngine(net, self._use_health, tbptt_fn=tbptt_fn))
        self._pipe = ScorePipeline()
        self._src = None   # a K-step engine's source (it owns the prefetcher)
        self._it = None    # the open epoch's iterator
        self._t_etl = None
        self._tctx = None  # the last dispatch's trace (exception cleanup)
        self.profile = None  # an armed ProfileSchedule (profile_round)
        # a network's loop is instrumented; a ParallelTrainer's is the lite one
        self.instrumented = not getattr(self.engine, "sharded", False)
        reg, step_h, etl_h, iters_c, score_g = _tm.train_metrics()
        self._reg = reg
        self._frec = _flight.get_recorder()
        self._emitter = StepRecordEmitter(net, step_h, etl_h, iters_c, score_g, self._frec)
        if self.instrumented and reg.enabled:
            # the first instrumented driver opens the wall-clock goodput window
            _tm.goodput.get_ledger().ensure_started()

    # -- epochs ---------------------------------------------------------

    def _epoch_source(self):
        if self.engine.fused:
            if self._src is None:
                self._src = self.engine.build_source(self.batch_factory)
            return self._src
        return self.engine.build_source(self.batch_factory)

    def start_epoch(self):
        for l in self.net.listeners:
            l.on_epoch_start(self.net)
        self._it = iter(self._epoch_source())
        self._t_etl = time.perf_counter()

    def end_epoch(self):
        # the epoch's last score lands before on_epoch_end
        tail = self._pipe.flush()
        if tail is not None:
            self._emit(*tail)
        for l in self.net.listeners:
            l.on_epoch_end(self.net)
        self.net.epoch += 1
        self._it = None

    def _emit(self, score, meta):
        self._emitter.emit(score, meta)

    # -- rounds ---------------------------------------------------------

    def profile_round(self, rounds_from_now, logdir, force=None):
        """Arm a ``torch.profiler`` window around the n-th future
        ``run_round`` (1: the next): exactly that round runs inside a
        profiler session whose Chrome trace lands under ``logdir``. A
        guarded no-op off a card (``telemetry/profiling.py``); idle, it
        costs one attribute check a round."""
        from deeplearning4j_tpu_torch.telemetry import profiling as _profiling
        if self.profile is None:
            self.profile = _profiling.ProfileSchedule()
        self.profile.arm(rounds_from_now, logdir, force=force)
        return self.profile

    def run_round(self, k_dispatches=None):
        """Consume up to ``k_dispatches`` dispatches of the current epoch
        (``None``: to its end). Returns a ``RoundResult``. An armed
        ``profile_round`` brackets exactly its round in a profiler window."""
        if self.profile is not None and self.profile.armed:
            with self.profile.window():
                return self._run_round(k_dispatches)
        return self._run_round(k_dispatches)

    def _run_round(self, k_dispatches):
        if self._it is None:
            self.start_epoch()
        # the ETL clock restarts with the round: time between rounds (a
        # checkpoint, the caller's code) is not batch assembly
        self._t_etl = time.perf_counter()
        rr = RoundResult()
        while k_dispatches is None or rr.dispatches < k_dispatches:
            try:
                item = next(self._it)
            except StopIteration:
                rr.epoch_done = True
                break
            n = self._dispatch_one(item)
            if n:  # an engine may skip an item (a ragged batch of a sharded fit)
                rr.dispatches += 1
                rr.steps += n
        if rr.epoch_done:
            self.end_epoch()
        return rr

    def run(self, epochs):
        """The fit loop: ``epochs`` epochs to their ends; the health tail
        is resolved (its policy may raise) before it returns."""
        try:
            if self.instrumented:
                with _tm.span("fit", net=type(self.net).__name__):
                    for _ in range(epochs):
                        self.run_round(None)
            else:
                for _ in range(epochs):
                    self.run_round(None)
            if self._use_health:
                self._hm.flush()
        except BaseException as e:
            if self._use_health:
                try:
                    self._hm.flush(apply_policy=False)
                except Exception:
                    pass
            if self._tctx is not None:
                # the dispatch that failed never resolved: close its trace
                self._tctx.abandon()
            if self.instrumented:
                _flight.crash_dump(e)
            raise
        finally:
            self._pipe.abandon()
            self.close_source()
            _listeners.run_fit_end_hooks(self.net)
        if self.net.score_history:
            self.net.score_value = self.net.score_history[-1]
        return self.net

    def _dispatch_one(self, item):
        if not self.instrumented:
            return self._dispatch_lite(item)
        eng, net = self.engine, self.net
        rec = self._reg.enabled  # one read a dispatch
        tctx = _tm.tracectx.maybe_start(eng.trace_root)
        self._tctx = tctx
        with _tm.tracectx.attach(tctx):
            with _tm.span("fit.etl"):
                prep = eng.prepare(item)
            etl = time.perf_counter() - self._t_etl
            eng.note_input(prep)
            step0 = net.iteration
            n_real = eng.n_real(item)
            span_kw = {"iteration": step0, "fused_k": n_real} if eng.fused else {
                "iteration": step0}
            step_start = time.perf_counter() if rec else None
            with _tm.span("fit.step", **span_kw):
                loss, hb, chunks = eng.dispatch(prep, n_real)
                # cold-start gauge (compile_cache): stamped once, then a dict read
                _cc.note_first_step()
                meta = {"step": step0, "iteration": net.iteration, "etl_time_s": etl,
                        "k": n_real, "chunks": chunks, "rec": rec, "health": self._use_health,
                        "trace": tctx, "trace_id": None if tctx is None else tctx.trace_id}
                # queue this dispatch, resolve the previous one inside the
                # span: the fetch overlaps the dispatch just issued
                t_res = time.perf_counter() if tctx is not None else None
                resolved = self._pipe.push(loss, meta)
                if resolved is not None and tctx is not None:
                    prev = resolved[1].get("trace")
                    if prev is not None:
                        prev.add_span("train.score_fetch", t_res, time.perf_counter())
        if rec:
            meta["step_time_s"] = time.perf_counter() - step_start
        if resolved is not None:
            self._emit(*resolved)
        if rec:
            _devices.note_jit_cache("fit.step", eng.cache_fn())
        if hb is not None:
            # the policy may raise NumericsError one dispatch late
            self._hm.on_step(hb, step=step0, k=n_real if eng.fused else None)
        self._t_etl = time.perf_counter()
        return n_real

    def _dispatch_lite(self, item):
        """A ``ParallelTrainer`` dispatch: no spans, traces or flight
        records; the scores reach the trainer's listeners one late."""
        eng, net = self.engine, self.net
        prep = eng.prepare(item)
        etl = time.perf_counter() - self._t_etl
        step0 = net.iteration
        n_real = eng.n_real(item)
        out = eng.dispatch(prep, n_real)
        if out is None:
            return 0
        _cc.note_first_step()
        loss, hb, chunks = out
        meta = {"step": step0, "iteration": net.iteration, "etl_time_s": etl,
                "k": n_real, "chunks": chunks}
        resolved = self._pipe.push(loss, meta)
        if resolved is not None:
            self._emit(*resolved)
        self._t_etl = time.perf_counter()
        return n_real

    # -- resuming -------------------------------------------------------

    def sync(self, apply_policy=True):
        """Resolve what is in flight: the pending score is recorded and the
        pending health bundle resolved (a ``raise`` policy raises here)."""
        tail = self._pipe.flush()
        if tail is not None:
            self._emit(*tail)
        if self._use_health:
            self._hm.flush(apply_policy=apply_policy)

    def checkpoint(self, path, *, buckets=None, save_updater=True):
        """``sync()``, then one resumable ``save_bundle`` unit between
        rounds; ``restore`` of it is bit-exact."""
        from deeplearning4j_tpu_torch.utils import serialization as _ser
        self.sync()
        t0 = time.perf_counter()
        out = _ser.save_bundle(self.net, path, buckets=buckets, save_updater=save_updater)
        if self.instrumented:
            # wall clock the step loop did not compute in: goodput's `checkpoint`
            _tm.goodput.get_ledger().note("checkpoint", time.perf_counter() - t0)
        return out

    def restore(self, path_or_bundle):
        """Drop what is in flight, then re-arm params, state, updater state
        and the iteration from a bundle (a path, a file or a ``Bundle``)."""
        from deeplearning4j_tpu_torch.utils import serialization as _ser
        self.abandon_pending()
        b = (path_or_bundle if isinstance(path_or_bundle, _ser.Bundle)
             else _ser.load_bundle(path_or_bundle, device=self.net.device))
        _rearm_net(self.net, b.net)
        return b

    def abandon_pending(self):
        """Drop the pending score unresolved; record the pending health
        bundle without running its policy."""
        self._pipe.abandon()
        if self._use_health:
            try:
                self._hm.flush(apply_policy=False)
            except Exception:
                pass

    def close_source(self):
        """Stop the prefetch producer; a later ``run_round`` rebuilds the
        source. Safe to call repeatedly."""
        if self._src is not None and hasattr(self._src, "close"):
            self._src.close()
        self._src = None
        self._it = None
