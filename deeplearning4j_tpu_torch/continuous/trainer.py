"""ContinuousTrainer: streaming training that survives its faults.

The port of ``deeplearning4j_tpu/continuous/trainer.py``:
``streaming/pubsub`` -> bounded-staleness admission ->
``AsyncDataSetIterator`` prefetch (with the transient-retry policy) ->
the :class:`~deeplearning4j_tpu_torch.continuous.driver.StepDriver` round
loop with the numerics watchdog armed -> periodic healthy snapshots handed
to the serving tier. Every failure mode has a counted outcome; nothing is
lost silently and nothing hangs:

* a **stale batch** (older than ``max_staleness_s``, aged from its
  publish timestamp and queue residency) is dropped at admission,
  ``continuous_dropped_total{reason=stale}``;
* a **poisoned batch** (NaN/Inf reaching the step) trips the watchdog
  one round late (``NumericsError`` out of ``driver.sync()``), and the
  trainer rolls back to the last good bundle: params, opt_state and the
  iteration (from which the step seeds follow) re-armed, so the resumed
  chain is bit-exact with a run that never saw the poison, counted
  ``continuous_rollback_total{reason=numerics}`` with the lost steps in
  ``continuous_rolled_back_steps_total``. The restore puts new tensors
  on the net, so a K-step engine (``nn/fused.py``) sees new data
  pointers and captures its CUDA graph once more at the next dispatch:
  each rollback costs one recapture, counted in the engine's
  ``captures`` and in ``recompiles_total{site="fit.step"}``;
* a **dead producer** goes quiet: ingest times out, the prefetcher
  retries with backoff (``etl_retry_total``), and the round resumes when
  the replacement producer appears; past the retry budget the run ends
  as a counted ``stream_quiet``, never a hang;
* a **sick snapshot never serves**: under ``policy='raise'`` a sick
  round rolls back before the snapshot point; under record/warn the
  anomaly delta gates publication
  (``continuous_snapshots_total{verdict=skipped_sick}``).

Snapshots are atomic (tmp + rename) ``save_bundle`` units, the rollback
target and the serving handoff at once: ``serve_update`` (see
:func:`registry_updater` / :func:`fleet_updater`) pushes each published
snapshot into a ``ModelRegistry`` or across a ``FleetSupervisor``'s
worker processes, warm-then-atomic, while training continues.
"""

from __future__ import annotations

import os
import queue

import numpy as np

from deeplearning4j_tpu_torch import telemetry as _tm
from deeplearning4j_tpu_torch.telemetry import goodput as _goodput
from deeplearning4j_tpu_torch.telemetry import health as _health
from deeplearning4j_tpu_torch.telemetry import slo as _slo
from deeplearning4j_tpu_torch.continuous.driver import StepDriver
from deeplearning4j_tpu_torch.datasets.iterator import (AsyncDataSetIterator,
                                                        DataSet, DataSetIterator)

__all__ = ["ContinuousTrainer", "StreamingTrainSource",
           "registry_updater", "fleet_updater"]


class StreamingTrainSource(DataSetIterator):
    """Bounded-staleness admission over an ``NDArraySubscriber``.

    Yields :class:`DataSet` minibatches from the subscription; a batch
    older than ``max_staleness_s`` (publish-timestamp + queue-residency
    age from ``receive_timed``) is count-dropped, not trained — the
    bounded-staleness contract of online training: a model update from
    data the stream has already superseded is negative work.

    A quiet stream raises ``TimeoutError`` after ``quiet_timeout_s`` —
    deliberately in ``AsyncDataSetIterator.RETRY_ON`` so the prefetch
    layer retries it with backoff (a producer death is a transient,
    counted, survivable event). The stream ENDS (StopIteration) only
    when the subscriber's connection closed and its queue drained.

    ``screen_nonfinite=True`` additionally drops NaN/Inf batches at
    admission (``continuous_dropped_total{reason=nonfinite}``); the
    default leaves them to the watchdog+rollback path, which also
    catches poison that admission screening can't see (a batch that
    only EXPLODES in the gradient).
    """

    def __init__(self, subscriber, *, max_staleness_s=None,
                 quiet_timeout_s=5.0, screen_nonfinite=False):
        self.sub = subscriber
        self.max_staleness_s = max_staleness_s
        self.quiet_timeout_s = float(quiet_timeout_s)
        self.screen_nonfinite = bool(screen_nonfinite)
        self.stale_dropped = 0
        self.nonfinite_dropped = 0
        self.admitted = 0
        reg = self._reg = _tm.get_registry()
        self._m_dropped = reg.counter(
            "continuous_dropped_total",
            "batches dropped at continuous-training admission, by reason "
            "(stale = older than the staleness bound, nonfinite = "
            "NaN/Inf screened before the step)")

    @property
    def batch_size(self):
        return None  # stream-defined; the first admitted batch decides

    def reset(self):
        pass  # a live stream has no epochs to rewind

    def __next__(self):
        while True:
            try:
                age, item, _ts = self.sub.receive_timed(
                    timeout=self.quiet_timeout_s)
            except queue.Empty:
                if self.sub._closed.is_set() and self.sub.queue.empty():
                    raise StopIteration  # stream ended, fully drained
                raise TimeoutError(
                    f"stream quiet for {self.quiet_timeout_s:.1f}s "
                    "(producer dead or stalled)")
            if not isinstance(item, tuple):
                raise ValueError(
                    "stream carries bare ndarrays, not datasets")
            x, y = np.asarray(item[0]), np.asarray(item[1])
            if (self.max_staleness_s is not None
                    and age > self.max_staleness_s):
                self.stale_dropped += 1
                if self._reg.enabled:
                    self._m_dropped.inc(reason="stale")
                continue
            if self.screen_nonfinite and not (
                    np.isfinite(x).all() and np.isfinite(y).all()):
                self.nonfinite_dropped += 1
                if self._reg.enabled:
                    self._m_dropped.inc(reason="nonfinite")
                continue
            self.admitted += 1
            return DataSet(features=x, labels=y)


def registry_updater(registry, name):
    """A ``serve_update`` hook: hot-swap a :class:`ModelRegistry` entry
    from each published snapshot (warm-then-atomic per the registry's
    own contract — in-flight requests finish on the old snapshot)."""
    def update(path):
        from deeplearning4j_tpu_torch.utils.serialization import load_bundle
        device = registry.engine(name).device
        registry.update_model(name, load_bundle(path, device=device).net)
    return update


def fleet_updater(supervisor, warm=None):
    """A ``serve_update`` hook: fan a published snapshot across a
    :class:`FleetSupervisor`'s workers (sequential warm-then-atomic —
    N-1 workers keep serving while each swaps)."""
    def update(path):
        out = supervisor.update_model(path, warm=warm)
        bad = {w: d for w, d in out.items() if not d.get("ok", True)}
        if bad:
            raise RuntimeError(f"fleet swap failed on {sorted(bad)}: {bad}")
        return out
    return update


class ContinuousTrainer:
    """The continuous-learning loop: rounds, snapshots, rollback, serve.

    ``source`` is any ``(x, y[, mask])`` iterable / DataSetIterator —
    typically a :class:`StreamingTrainSource`. It is wrapped in an
    ``AsyncDataSetIterator`` (host-side: prefetch + the bounded
    transient-retry policy; device placement stays with the engines), so
    a producer hiccup costs counted retries, not the run.

    One ``run()`` iteration = ``dispatches_per_round`` dispatches +
    ``driver.sync()`` (where a sick round surfaces, one round late) +
    on the snapshot cadence an atomic ``save_bundle`` to
    ``snapshot_path`` and the optional ``serve_update`` handoff. An
    initial snapshot is written BEFORE the first round, so rollback
    always has a target.
    """

    def __init__(self, net, source, *, snapshot_path, k=1, batch_size=None,
                 dispatches_per_round=1, snapshot_every=1, buckets=None,
                 rollback=True, max_rollbacks=8, health_policy="raise",
                 grad_norm_limit=None, serve_update=None,
                 ingest_retries=8, ingest_backoff_s=0.25):
        self.net = net
        self.snapshot_path = str(snapshot_path)
        self.dispatches_per_round = int(dispatches_per_round)
        self.snapshot_every = int(snapshot_every)
        self.buckets = buckets
        self.rollback_enabled = bool(rollback)
        self.max_rollbacks = int(max_rollbacks)
        self.serve_update = serve_update
        self.on_round = None  # callable(trainer) after each clean round
        #                       (the runner's progress-line hook)
        self.rounds = 0
        self.rollbacks = 0
        self.snapshots_published = 0
        if getattr(net, "params", None) is None and hasattr(net, "init"):
            net.init()  # the round-0 snapshot needs concrete tensors
        # the watchdog is the rollback trigger: arm it for the run (it is
        # process-wide; a caller that armed it already keeps its policy)
        hm = self._hm = _health.get_monitor()
        if not hm.active:
            hm.enable(policy=health_policy, grad_norm_limit=grad_norm_limit)
        # host-side prefetch: placement on the card stays with the engines
        self._ingest = AsyncDataSetIterator(
            self._as_iterator(source), queue_size=2,
            retry_transient=ingest_retries, retry_backoff_s=ingest_backoff_s)
        self.driver = StepDriver(net, self._batches, k=k,
                                 batch_size=batch_size)
        reg = self._reg = _tm.get_registry()
        self._m_rounds = reg.counter(
            "continuous_rounds_total", "continuous-training rounds, by "
            "outcome (ok / rollback / stream_quiet / stream_closed)")
        self._m_rollback = reg.counter(
            "continuous_rollback_total",
            "rollbacks to the last good bundle, by reason")
        self._m_rolled_steps = reg.counter(
            "continuous_rolled_back_steps_total",
            "optimizer steps undone by rollbacks (trained-then-discarded "
            "work; every loss is counted here, never silent)")
        self._m_snap = reg.counter(
            "continuous_snapshots_total",
            "snapshot points, by verdict (published / skipped_sick / "
            "error)")
        self._m_serve = reg.counter(
            "continuous_serve_updates_total",
            "serving hot-swap handoffs of published snapshots, by outcome")
        if reg.enabled:
            # pre-register every enum series at zero (the prober idiom):
            # the SLO delta discipline ignores a series' FIRST
            # appearance, so a rollback/error series born mid-incident
            # would contribute nothing for a full window
            for outcome in ("ok", "rollback", "stream_quiet",
                            "stream_closed"):
                self._m_rounds.inc(0, outcome=outcome)
            for verdict in ("published", "skipped_sick", "error"):
                self._m_snap.inc(0, verdict=verdict)
            for outcome in ("ok", "error"):
                self._m_serve.inc(0, outcome=outcome)
        self._anoms_at_gate = None

    @staticmethod
    def _as_iterator(source):
        if isinstance(source, DataSetIterator):
            return source
        # (x, y[, m]) tuples / DataSet stream -> DataSetIterator contract
        from deeplearning4j_tpu_torch.datasets.iterator import iter_batches

        class _Wrap(DataSetIterator):
            def __init__(self, src):
                self.src = src
                self._it = None

            @property
            def batch_size(self):
                return getattr(source, "batch_size", None)

            def reset(self):
                # iter() first: a LIST of (x, y) tuples would otherwise
                # take iter_batches' (features, labels)-pair branch
                self._it = iter(iter_batches(iter(self.src)))

            def __next__(self):
                if self._it is None:
                    self.reset()
                x, y, m = next(self._it)
                return DataSet(features=x, labels=y, labels_mask=m)

        return _Wrap(source)

    def _batches(self):
        for ds in self._ingest:
            yield ds.features, ds.labels, ds.labels_mask

    # -- snapshots -------------------------------------------------------

    def _sick_since_gate(self):
        sick = False
        hm = self._hm
        if hm.active:
            seen = hm.nonfinite_steps
            # two conditions, both required: new anomalies since the last
            # gate (a sick ROUND), or the most recently resolved record
            # still carries nonfinite flags (a sick STATE — without this,
            # a run whose anomalies stopped incrementing would republish
            # NaN params the moment the delta went quiet)
            last = hm.last or {}
            sick = ((self._anoms_at_gate is not None
                     and seen > self._anoms_at_gate)
                    or bool(last.get("loss_nonfinite"))
                    or bool(last.get("grad_nonfinite")))
            self._anoms_at_gate = seen
        if not sick:
            # the SLO engine's verdict joins the gate: a FIRING
            # gate-tagged rule (numerics anomalies, step-time
            # regression, recompile storm) blocks publication the same
            # counted skipped_sick way. Default-on-but-inert: no engine
            # running, or every rule ok, changes nothing.
            sick = bool(_slo.firing_gate_rules())
        return sick

    def snapshot(self):
        """Atomically write the bundle and (if healthy) hand it to
        serving. Skipped-sick and handoff errors are counted, never
        silent; a handoff error does not kill training."""
        try:
            # resolve anything still in flight WITHOUT the raise policy,
            # so the gate below judges the true current state — an
            # aborted round (e.g. stream_quiet after a poisoned
            # dispatch) may have left a sick pending bundle that a
            # policy'd flush would throw straight through the caller
            self.driver.sync(apply_policy=False)
        except Exception:  # noqa: BLE001 — a broken pipeline must not
            pass           # mask the health gate
        if self._sick_since_gate():
            # policy=record/warn runs reach here with anomalies on the
            # books; the serving tier must never warm-swap onto them
            if self._reg.enabled:
                self._m_snap.inc(verdict="skipped_sick")
            return None
        tmp = self.snapshot_path + ".tmp"
        try:
            self.driver.checkpoint(tmp, buckets=self.buckets)
            os.replace(tmp, self.snapshot_path)  # atomic: a reader (or a
            # rollback) never sees a half-written bundle
        except Exception:
            if self._reg.enabled:
                self._m_snap.inc(verdict="error")
            raise
        self.snapshots_published += 1
        if self._reg.enabled:
            self._m_snap.inc(verdict="published")
        if self.serve_update is not None:
            try:
                self.serve_update(self.snapshot_path)
                if self._reg.enabled:
                    self._m_serve.inc(outcome="ok")
            except Exception:  # noqa: BLE001 — serving lag must not
                #                kill training; the counter is the signal
                if self._reg.enabled:
                    self._m_serve.inc(outcome="error")
        return self.snapshot_path

    def _rollback(self, reason, exc):
        self.rollbacks += 1
        if self._reg.enabled:
            self._m_rollback.inc(reason=reason)
            self._m_rounds.inc(outcome="rollback")
        if not self.rollback_enabled or self.rollbacks > self.max_rollbacks:
            raise exc
        if self.snapshots_published == 0:
            raise exc  # nothing to roll back to
        it_before = self.net.iteration
        self.driver.restore(self.snapshot_path)
        lost = max(0, it_before - self.net.iteration)
        if lost and self._reg.enabled:
            self._m_rolled_steps.inc(lost)
            # reclassify the undone steps' wall clock in the goodput
            # ledger: trained-then-discarded seconds are rollback_lost,
            # not compute (estimated as lost steps x mean step time)
            h = self._reg.get("train_step_seconds")
            if h is not None and h.count():
                _goodput.get_ledger().note(
                    "rollback_lost", lost * h.sum() / h.count())
        # the gate counter moves on: the anomaly that caused this
        # rollback is handled, the next snapshot may publish
        self._anoms_at_gate = self._hm.nonfinite_steps
        return lost

    # -- the loop --------------------------------------------------------

    def run(self, *, max_rounds=None, until_steps=None, stop_flag=None):
        """Train until the stream closes, ``until_steps`` optimizer steps
        survive (rollbacks subtract), ``max_rounds`` rounds ran, or
        ``stop_flag`` (a ``threading.Event`` — the graceful-drain hook)
        is set. Returns a JSON-ready summary; never hangs — every exit
        path is a counted status."""
        status = "max_rounds"
        self._anoms_at_gate = self._hm.nonfinite_steps
        if self.snapshots_published == 0:
            self.snapshot()  # round-0 bundle: rollback always has a target
        try:
            while max_rounds is None or self.rounds < max_rounds:
                if stop_flag is not None and stop_flag.is_set():
                    status = "stopped"
                    break
                if (until_steps is not None
                        and self.net.iteration >= until_steps):
                    status = "target_steps"
                    break
                try:
                    rr = self.driver.run_round(self.dispatches_per_round)
                    self.driver.sync()  # a sick round raises HERE
                except _health.NumericsError as e:
                    self._rollback("numerics", e)
                    continue
                except TimeoutError:
                    # ingest retry budget exhausted: the producer never
                    # came back — a counted end, not a hang
                    status = "stream_quiet"
                    if self._reg.enabled:
                        self._m_rounds.inc(outcome="stream_quiet")
                    break
                self.rounds += 1
                if self._reg.enabled:
                    self._m_rounds.inc(outcome="ok")
                if rr.dispatches and self.rounds % self.snapshot_every == 0:
                    self.snapshot()
                if self.on_round is not None:
                    self.on_round(self)
                if rr.epoch_done:
                    # the source only exhausts when the stream CLOSED
                    # (subscriber gone / finite reference list done)
                    status = "stream_closed"
                    if self._reg.enabled:
                        self._m_rounds.inc(outcome="stream_closed")
                    break
        finally:
            self.close()
        # final state always lands in the bundle (a graceful stop resumes
        # exactly where it left off); the health gate still applies
        self.snapshot()
        return self.summary(status)

    def close(self):
        self.driver.close_source()
        self._ingest.close()

    def summary(self, status=None):
        src = self._ingest.base
        return {
            "status": status,
            "rounds": self.rounds,
            "iteration": int(self.net.iteration),
            "rollbacks": self.rollbacks,
            "snapshots_published": self.snapshots_published,
            "stale_dropped": getattr(src, "stale_dropped", 0),
            "nonfinite_dropped": getattr(src, "nonfinite_dropped", 0),
            "admitted": getattr(src, "admitted", None),
            # CUDA graphs the K-step engine captured (None at K=1): one
            # for the first signature, one more after each rollback
            "captures": getattr(self.driver.engine.cache_fn(), "captures", None),
            "health": self._hm.summary(),
        }
