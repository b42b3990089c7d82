"""The port's continuous-learning tier (``deeplearning4j_tpu_torch/
continuous/``) held against the JAX package's (``tests/test_continuous.py``).

The same ``chaos.gen_batches`` streams, made from a seed with numpy, go
through the JAX ``ContinuousTrainer`` and the port's from the same
parameters (the JAX net's, copied in): parameters, layer state and updater
state agree at rtol 1e-5 (the JAX updater scalars are float64 under the
conftest's x64), and every counter is the same: stale drops, rollbacks,
rolled-back steps, snapshot verdicts (``skipped_sick`` included) and
``stream_quiet``. Within the port a rollback is bit-exact against a clean
run at K=1 and K=2 (digests). The AsyncDataSetIterator retry policy and
the bounded pub/sub queues follow the JAX tests. The slice as a whole: a
tiny char-RNN streamed through both trainers at K=2 (the port on
``lstm_seq``'s plain version), held at the tolerances of
``tests/test_torch_rnn.py`` (outputs atol 1e-5; parameters under SGD at
atol 2e-5 + rtol 2e-4, the gradient tolerance), with every answer the
registry serves after a snapshot swap equal to the snapshot's forward."""

import copy
import queue as _queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import telemetry as jtelemetry
from deeplearning4j_tpu.continuous import chaos as jchaos
from deeplearning4j_tpu.continuous.trainer import ContinuousTrainer as JTrainer
from deeplearning4j_tpu.continuous.trainer import StreamingTrainSource as JSource
from deeplearning4j_tpu.datasets.iterator import DataSetIterator as JDataSetIterator
from deeplearning4j_tpu.telemetry import health as jhealth
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.continuous import chaos
from deeplearning4j_tpu_torch.continuous.trainer import (ContinuousTrainer,
                                                         StreamingTrainSource, fleet_updater,
                                                         registry_updater)
from deeplearning4j_tpu_torch.datasets.iterator import (AsyncDataSetIterator, DataSet,
                                                        DataSetIterator)
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import flatten_tree

COUNTERS = ("continuous_rounds_total", "continuous_rollback_total",
            "continuous_rolled_back_steps_total", "continuous_dropped_total",
            "continuous_snapshots_total", "continuous_serve_updates_total", "etl_retry_total")


@pytest.fixture(autouse=True)
def _isolate():
    for t in (telemetry, jtelemetry):
        t.reset()
        t.disable()
    yield
    for t in (telemetry, jtelemetry):
        t.disable()
        t.reset()


def _both_enabled():
    telemetry.enable()
    jtelemetry.enable()


def _pair(seed=0):
    """The JAX smoke net and the port's with the JAX net's parameters."""
    jnet = jchaos.smoke_net(seed=seed)
    jnet.init()
    tnet = chaos.smoke_net(seed=seed, device="cpu")
    tnet.init()
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _assert_trees_close(tnet, jnet, rtol=1e-5, atol=1e-7):
    mine = {k: v.detach().numpy() for k, v in
            flatten_tree([tnet.params, tnet.state, tnet.opt_state]).items()}
    theirs = flatten_tree(jax.tree_util.tree_map(
        np.asarray, [jnet.params, jnet.state, jnet.opt_state]))
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_allclose(mine[k], np.asarray(theirs[k], np.float64), rtol=rtol,
                                   atol=atol, err_msg=k)
    assert tnet.iteration == jnet.iteration


def _counters():
    return ({n: telemetry.series_map(n) for n in COUNTERS},
            {n: jtelemetry.series_map(n) for n in COUNTERS})


def _summaries_agree(mine, theirs):
    for key in ("status", "rounds", "iteration", "rollbacks", "snapshots_published",
                "stale_dropped", "nonfinite_dropped", "admitted"):
        assert mine[key] == theirs[key], key


def _run_both(tmp_path, jsrc, tsrc, **kw):
    jnet, tnet = _pair()
    jt = JTrainer(jnet, jsrc, snapshot_path=str(tmp_path / "j.zip"), **kw)
    jsum = jt.run()
    tt = ContinuousTrainer(tnet, tsrc, snapshot_path=str(tmp_path / "t.zip"), **kw)
    tsum = tt.run()
    return jnet, tnet, jsum, tsum


# ---------------------------------------------------------------------------
# the port's trainer against the JAX one
# ---------------------------------------------------------------------------

def test_gen_batches_are_the_jax_streams():
    for kw in ({}, {"poison": {1, 3}}, {"batch": 4, "features": 5, "classes": 2}):
        for (x, y), (xj, yj) in zip(chaos.gen_batches(11, 5, **kw),
                                    jchaos.gen_batches(11, 5, **kw)):
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(y, yj)


def test_rollback_stream_matches_jax(tmp_path):
    _both_enabled()
    bad = chaos.gen_batches(11, 7, poison={3})
    jnet, tnet, jsum, tsum = _run_both(tmp_path, list(bad), list(bad))
    _summaries_agree(tsum, jsum)
    assert tsum["rollbacks"] == 1 and tnet.iteration == 6
    mine, theirs = _counters()
    assert mine == theirs
    _assert_trees_close(tnet, jnet)


def test_sick_snapshot_verdicts_match_jax(tmp_path):
    """policy=record trains through the poison with no rollback; the
    snapshot gate skips the sick states in both packages alike."""
    _both_enabled()
    bad = chaos.gen_batches(13, 5, poison={1})
    jserved, tserved = [], []
    jnet, tnet = _pair()
    JTrainer(jnet, list(bad), snapshot_path=str(tmp_path / "j.zip"), health_policy="record",
             serve_update=jserved.append).run()
    ContinuousTrainer(tnet, list(bad), snapshot_path=str(tmp_path / "t.zip"),
                      health_policy="record", serve_update=tserved.append).run()
    mine, theirs = _counters()
    assert mine == theirs
    assert mine["continuous_snapshots_total"]["verdict=skipped_sick"] >= 1
    assert len(tserved) == len(jserved)
    for path in tserved:  # every snapshot that reached serving is finite
        b = tser.load_bundle(path, device="cpu")
        assert all(torch.isfinite(t).all() for t in flatten_tree(b.net.params).values())


def test_stale_drops_match_jax(tmp_path):
    """Both trainers subscribe to one port broker topic; one batch is
    published already stale, and both drop it, counted, and train the rest
    alike."""
    from deeplearning4j_tpu.streaming.pubsub import NDArraySubscriber as JSub
    from deeplearning4j_tpu_torch.streaming.pubsub import (NDArrayPublisher,
                                                           NDArraySubscriber, StreamingBroker)
    _both_enabled()
    batches = chaos.gen_batches(21, 5)
    broker = StreamingBroker().start()
    try:
        jsub, tsub = JSub("t", port=broker.port), NDArraySubscriber("t", port=broker.port)
        deadline = time.time() + 10
        while len(broker._subs["t"]) < 2 and time.time() < deadline:
            time.sleep(0.02)
        pub = NDArrayPublisher("t", port=broker.port)
        for i, (x, y) in enumerate(batches):
            pub.publish_dataset(x, y, ts=time.time() - 60.0 if i == 2 else None)
        pub.close()
        time.sleep(0.2)
        jsub.close()  # the stream ends once each queue drains
        tsub.close()
        jnet, tnet, jsum, tsum = _run_both(
            tmp_path, JSource(jsub, max_staleness_s=30.0, quiet_timeout_s=0.5),
            StreamingTrainSource(tsub, max_staleness_s=30.0, quiet_timeout_s=0.5),
            ingest_retries=0)
    finally:
        broker.close()
    _summaries_agree(tsum, jsum)
    assert tsum["stale_dropped"] == 1 and tsum["admitted"] == 4 and tnet.iteration == 4
    mine, theirs = _counters()
    assert mine["continuous_dropped_total"] == theirs["continuous_dropped_total"] == {
        "reason=stale": 1.0}
    _assert_trees_close(tnet, jnet)


def test_quiet_stream_matches_jax(tmp_path):
    _both_enabled()

    def quiet(base):
        class Quiet(base):
            batch_size = None

            def reset(self):
                pass

            def __next__(self):
                raise TimeoutError("stream quiet")
        return Quiet()

    t0 = time.monotonic()
    _jnet, _tnet, jsum, tsum = _run_both(tmp_path, quiet(JDataSetIterator),
                                         quiet(DataSetIterator), ingest_retries=1,
                                         ingest_backoff_s=0.01)
    assert time.monotonic() - t0 < 30
    assert tsum["status"] == jsum["status"] == "stream_quiet"
    mine, theirs = _counters()
    assert mine == theirs
    assert mine["etl_retry_total"]["outcome=fatal"] == 1


def test_rollback_budget_exhausted_matches_jax(tmp_path):
    _both_enabled()
    bad = chaos.gen_batches(5, 6, poison={1, 2, 3, 4})
    jnet, tnet = _pair()
    jt = JTrainer(jnet, list(bad), snapshot_path=str(tmp_path / "j.zip"), max_rollbacks=2)
    with pytest.raises(jhealth.NumericsError):
        jt.run()
    tt = ContinuousTrainer(tnet, list(bad), snapshot_path=str(tmp_path / "t.zip"),
                           max_rollbacks=2)
    with pytest.raises(health.NumericsError):
        tt.run()
    assert tt.rollbacks == jt.rollbacks == 3  # 2 allowed + the one that re-raised
    mine, theirs = _counters()
    assert mine == theirs


# ---------------------------------------------------------------------------
# within the port: bit-exact rollback, serving hand-off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_rollback_bit_exact_parity(tmp_path, k):
    """A NaN batch trips the watchdog one round late; rollback to the last
    good bundle and resume is bit-exact with a run that never saw the
    poison. At K=2 the rollback undoes the poisoned dispatch, the good
    batch beside the poison included, so the clean run skips both; each
    restore replaces the net's tensors, and the K-step engine captures once
    more (counted in ``captures``)."""
    telemetry.enable()
    n, poison = 9, 4
    bad = chaos.gen_batches(11, n, poison={poison})
    dispatch = range(poison - poison % k, poison - poison % k + k)
    good = [b for i, b in enumerate(chaos.gen_batches(11, n)) if i not in dispatch]
    net = chaos.smoke_net(device="cpu")
    summary = ContinuousTrainer(net, list(bad), snapshot_path=str(tmp_path / "s.zip"), k=k,
                                batch_size=8).run()
    assert summary["rollbacks"] == 1
    ref = chaos.smoke_net(device="cpu")
    ContinuousTrainer(ref, list(good), snapshot_path=str(tmp_path / "r.zip"), k=k,
                      batch_size=8).run()
    assert net.iteration == ref.iteration
    assert chaos.state_digest(net) == chaos.state_digest(ref)
    lost = telemetry.series_map("continuous_rolled_back_steps_total")[""]
    assert lost == k  # the poisoned dispatch's K steps, undone and counted
    if k > 1:
        assert summary["captures"] == 2  # the first signature + one after the restore
    else:
        assert summary["captures"] is None


def test_serve_update_registry_hot_swap(tmp_path):
    telemetry.enable()
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    net = chaos.smoke_net(device="cpu")
    net.init()
    registry = ModelRegistry()
    registry.register("cont", copy.deepcopy(net), buckets=[8], input_spec=(12,),
                      device="cpu")
    try:
        ContinuousTrainer(net, list(chaos.gen_batches(17, 4)),
                          snapshot_path=str(tmp_path / "s.zip"),
                          serve_update=registry_updater(registry, "cont")).run()
        assert telemetry.series_map("continuous_serve_updates_total")["outcome=ok"] >= 1
        probe = chaos.gen_batches(99, 1)[0][0]
        served = np.asarray(registry.output("cont", probe))
        direct = net.output(probe).detach().numpy()
        assert float(np.max(np.abs(served - direct))) <= 1e-6
    finally:
        registry.unregister("cont")


def test_fleet_updater_fans_out_and_raises_on_a_bad_worker():
    class Sup:
        def __init__(self, out):
            self.out, self.calls = out, []

        def update_model(self, path, warm=None):
            self.calls.append((path, warm))
            return self.out

    ok = Sup({"w0": {"ok": True}, "w1": {"ok": True}})
    assert fleet_updater(ok, warm=[1])("snap.zip") == ok.out
    assert ok.calls == [("snap.zip", [1])]
    bad = Sup({"w0": {"ok": True}, "w1": {"ok": False, "error": "boom"}})
    with pytest.raises(RuntimeError, match=r"\['w1'\]"):
        fleet_updater(bad)("snap.zip")


# ---------------------------------------------------------------------------
# bounded-staleness admission
# ---------------------------------------------------------------------------

def test_stale_batch_dropped_fresh_admitted():
    telemetry.enable()
    from deeplearning4j_tpu_torch.streaming.pubsub import (NDArrayPublisher,
                                                           NDArraySubscriber, StreamingBroker)
    broker = StreamingBroker().start()
    try:
        sub = NDArraySubscriber("t", port=broker.port)
        # the broker fans a frame out only to subscriptions it has already
        # registered: publish once it holds this one (under load its
        # handshake thread may run after the publisher's)
        deadline = time.time() + 60
        while not broker._subs["t"] and time.time() < deadline:
            time.sleep(0.02)
        assert broker._subs["t"], "the broker never registered the subscription"
        pub = NDArrayPublisher("t", port=broker.port)
        # ages far from the bound both ways: no scheduler delay under a
        # loaded test run can make the fresh batch stale or the stale fresh
        src = StreamingTrainSource(sub, max_staleness_s=60.0, quiet_timeout_s=30.0)
        x, y = chaos.gen_batches(1, 1)[0]
        pub.publish_dataset(x, y, ts=time.time() - 3600.0)  # born stale
        pub.publish_dataset(x, y)                           # fresh
        ds = next(src)
        assert isinstance(ds, DataSet)
        assert src.stale_dropped == 1 and src.admitted == 1
        assert telemetry.get_registry().get("continuous_dropped_total").value(
            reason="stale") == 1
        pub.close()
        sub.close()
    finally:
        broker.close()


def test_nonfinite_screen_optional():
    class FakeSub:
        def __init__(self, items):
            self.items = list(items)
            self.queue = _queue.Queue()
            self._closed = threading.Event()

        def receive_timed(self, timeout=None):
            if not self.items:
                self._closed.set()
                raise StopIteration
            return 0.0, self.items.pop(0), None

    x, y = chaos.gen_batches(2, 1)[0]
    bad = x.copy()
    bad[0, 0] = np.inf
    src = StreamingTrainSource(FakeSub([(bad, y), (x, y)]), screen_nonfinite=True)
    ds = next(src)
    assert np.isfinite(ds.features).all()
    assert src.nonfinite_dropped == 1


# ---------------------------------------------------------------------------
# AsyncDataSetIterator transient retry
# ---------------------------------------------------------------------------

class _Flaky(DataSetIterator):
    """Yields n batches; raises ``exc`` ``fail_times`` times before the
    batch at index ``fail_at``."""

    batch_size = 4

    def __init__(self, n=3, fail_at=1, fail_times=2, exc=ConnectionError):
        self.n, self.fail_at, self.fail_times, self.exc = n, fail_at, fail_times, exc
        self._i = self._fails = 0

    def reset(self):
        self._i = self._fails = 0

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        if self._i == self.fail_at and self._fails < self.fail_times:
            self._fails += 1
            raise self.exc("transient")
        self._i += 1
        x = np.zeros((4, 2), np.float32)
        return DataSet(features=x, labels=x)


def _retries():
    return telemetry.series_map("etl_retry_total")


def test_transient_errors_retried_then_recovered():
    telemetry.enable()
    it = AsyncDataSetIterator(_Flaky(fail_times=2), retry_transient=3, retry_backoff_s=0.001)
    assert sum(1 for _ in it) == 3  # nothing lost
    assert _retries() == {"outcome=retried": 2, "outcome=recovered": 1, "outcome=fatal": 0}


def test_budget_exhausted_fatal_and_prompt():
    telemetry.enable()
    it = AsyncDataSetIterator(_Flaky(fail_times=99), retry_transient=2, retry_backoff_s=0.001)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        list(it)
    assert time.monotonic() - t0 < 10  # prompt, not a hang
    assert _retries() == {"outcome=retried": 2, "outcome=recovered": 0, "outcome=fatal": 1}
    it.close()


def test_default_is_fail_on_first():
    """Retry is opt-in: a generator source closes on its first raise, so a
    default-on retry would silently truncate epochs."""
    telemetry.enable()
    it = AsyncDataSetIterator(_Flaky(fail_times=1))
    with pytest.raises(ConnectionError):
        list(it)
    assert _retries()["outcome=retried"] == 0
    it.close()


def test_non_retryable_errors_untouched():
    telemetry.enable()
    it = AsyncDataSetIterator(_Flaky(fail_times=1, exc=ValueError), retry_transient=3)
    with pytest.raises(ValueError):
        list(it)
    assert _retries()["outcome=retried"] == 0
    it.close()


# ---------------------------------------------------------------------------
# bounded pub/sub queues
# ---------------------------------------------------------------------------

def test_subscriber_drop_oldest_counted():
    telemetry.enable()
    from deeplearning4j_tpu_torch.streaming.pubsub import (NDArrayPublisher,
                                                           NDArraySubscriber, StreamingBroker)
    broker = StreamingBroker().start()
    try:
        sub = NDArraySubscriber("t", port=broker.port, buffer=2)
        pub = NDArrayPublisher("t", port=broker.port)
        for i in range(8):
            pub.publish(np.full((4,), i, np.float32))
        deadline = time.time() + 10
        while sub.dropped < 6 and time.time() < deadline:
            time.sleep(0.02)
        assert sub.dropped >= 6 - 2  # all but the buffered tail
        _age, arr, _ts = sub.receive_timed(timeout=2)
        assert arr[0] >= 2  # the oldest were dropped
        assert telemetry.get_registry().get("stream_dropped_total").value(
            site="subscriber") == sub.dropped
        pub.close()
        sub.close()
    finally:
        broker.close()


def test_publish_timestamp_ages_receive():
    from deeplearning4j_tpu_torch.streaming import codec
    x, y = chaos.gen_batches(3, 1)[0]
    buf = codec.encode_dataset(x, y, ts=time.time() - 2.0)
    assert codec.dataset_ts(buf) is not None
    f, _l = codec.decode_dataset(buf)
    np.testing.assert_array_equal(f, x)
    f2, _l2 = codec.decode_dataset(codec.encode_dataset(x, y))
    np.testing.assert_array_equal(f2, x)
    assert codec.dataset_ts(codec.encode_dataset(x, y)) is None


# ---------------------------------------------------------------------------
# the slice as a whole: a char-RNN from a stream into a registry
# ---------------------------------------------------------------------------

def test_char_rnn_streamed_through_both_trainers(tmp_path):
    """``text_generation_lstm(11, hidden=32, seq_len=8)`` under SGD, K=2,
    over one char-RNN stream with a poisoned batch: the port (``lstm_seq``'s
    plain version on the CPU, its backward ``lstm_seq_bwd``) against the
    JAX trainer, and a ``ModelRegistry`` hot-swapped from every published
    snapshot answering as the snapshot's own forward."""
    from deeplearning4j_tpu.models.misc import text_generation_lstm as jtext
    from deeplearning4j_tpu.nn import updaters as JU
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.models.misc import text_generation_lstm
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry

    _both_enabled()
    vocab, batch, seq = 11, 4, 8
    stream = chaos.gen_batches(31, 7, batch=batch, classes=vocab, seq_len=seq, poison={3})
    jnet = JNet(jtext(vocab, hidden=32, seq_len=seq, updater=JU.Sgd(learning_rate=0.1)))
    jnet.init()
    tnet = MultiLayerNetwork(text_generation_lstm(vocab, hidden=32, seq_len=seq,
                                                  updater=U.Sgd(learning_rate=0.1)),
                             device="cpu")
    tnet.init()
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params))
    jsum = JTrainer(jnet, list(stream), snapshot_path=str(tmp_path / "j.zip"), k=2,
                    batch_size=batch).run()

    registry = ModelRegistry()
    registry.register("charnn", copy.deepcopy(tnet), buckets=[batch],
                      input_spec=(seq, vocab), device="cpu")
    probe = chaos.gen_batches(77, 1, batch=batch, classes=vocab, seq_len=seq)[0][0]
    swaps = []
    to_registry = registry_updater(registry, "charnn")

    def serve_update(path):
        to_registry(path)
        served = np.asarray(registry.output("charnn", probe))
        direct = tser.load_bundle(path, device="cpu").net.output(probe).detach().numpy()
        swaps.append(float(np.max(np.abs(served - direct))))

    try:
        tsum = ContinuousTrainer(tnet, list(stream), snapshot_path=str(tmp_path / "t.zip"),
                                 k=2, batch_size=batch, serve_update=serve_update).run()
    finally:
        registry.unregister("charnn")
    _summaries_agree(tsum, jsum)
    assert tsum["rollbacks"] == 1 and tnet.iteration == jnet.iteration == 5  # 7 less [2, 3]
    mine, theirs = _counters()
    for name in ("continuous_rollback_total", "continuous_rolled_back_steps_total",
                 "continuous_snapshots_total"):
        assert mine[name] == theirs[name], name
    _assert_trees_close(tnet, jnet, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tnet.output(probe).detach().numpy(),
                               np.asarray(jnet.output(probe)), atol=1e-5)
    assert len(swaps) == tsum["snapshots_published"] and max(swaps) == 0.0
