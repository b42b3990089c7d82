"""The port's StepDriver (``continuous/driver.py``) and bundles
(``utils/serialization.py`` ``save_bundle``/``load_bundle``), on the CPU.

Mirrors the JAX package's ``tests/test_continuous.py::TestStepDriver``:
rounds consume exactly the dispatches asked for, a checkpoint between
rounds resumes bit-exactly in a fresh net and driver (dropout on, so the
step seeds matter), ``restore`` rolls back bit-exactly and makes the K-step
engine build its signature once more, and both fit facades run through the
driver. Bundles: a JAX-written bundle loads in the port with the same
params, updater state, iteration, epoch and buckets; one that embeds a warm
manifest loads with a warning and without it; a port-written bundle loads
in the JAX package.
"""

import hashlib
import io
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.continuous import RoundResult, StepDriver
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
from deeplearning4j_tpu_torch.nn.listeners import TrainingListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import flatten_tree


def _net(seed=0, dropout=0.2):
    conf = NeuralNetConfig(seed=seed, updater=U.Adam(learning_rate=0.01)).list(
        L.DenseLayer(n_out=16, activation="relu", dropout=dropout),
        L.OutputLayer(n_out=3, loss="mcxent"), input_type=I.FeedForwardType(12))
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _batches(seed, n, batch=8):
    rs = np.random.RandomState(seed)
    return [(rs.rand(batch, 12).astype(np.float32),
             np.eye(3, dtype=np.float32)[rs.randint(0, 3, batch)]) for _ in range(n)]


def _factory(batches):
    return lambda: iter([(x, y, None) for x, y in batches])


def _digest(net):
    """SHA-256 over params, state, updater state and the iteration: equal
    digests, bit-exact training histories."""
    h = hashlib.sha256()
    for _, t in sorted(flatten_tree([net.params, net.state, net.opt_state]).items()):
        h.update(t.detach().numpy().tobytes())
    h.update(str(int(net.iteration)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("k", [1, 2])
def test_run_round_consumes_exactly_k_dispatches(k):
    net = _net()
    drv = StepDriver(net, _factory(_batches(1, 10)), k=k, batch_size=8, prefetch=False)
    rr = drv.run_round(2)
    assert rr == RoundResult(dispatches=2, steps=2 * k, epoch_done=False)
    assert net.iteration == 2 * k and net.epoch == 0
    rr = drv.run_round(None)
    assert rr.epoch_done and rr.steps == 10 - 2 * k and net.iteration == 10 and net.epoch == 1
    assert len(net.score_history) == 10
    drv.close_source()


@pytest.mark.parametrize("k", [1, 2])
def test_round_boundary_checkpoint_resume_bit_exact(tmp_path, k):
    """Stop after a round, bundle, resume in a fresh net and driver over the
    rest of the stream: bit-exact with the uninterrupted run, dropout's
    draws included."""
    batches = _batches(7, 8)
    ref = _net()
    StepDriver(ref, _factory(batches), k=k, prefetch=False).run_round(None)
    want = _digest(ref)

    net = _net()
    drv = StepDriver(net, _factory(batches), k=k, prefetch=False)
    drv.run_round(3 if k == 1 else 2)
    path = tmp_path / "mid.zip"
    drv.checkpoint(path, buckets=[4, 8])
    drv.close_source()
    bundle = tser.load_bundle(path, device="cpu")
    assert bundle.buckets.sizes() == [4, 8]
    resumed = bundle.net
    StepDriver(resumed, _factory(batches[resumed.iteration:]), k=k,
               prefetch=False).run_round(None)
    assert _digest(resumed) == want


@pytest.mark.parametrize("k", [1, 4])
def test_restore_rolls_back_bit_exact_and_rebuilds_once(tmp_path, k):
    batches = _batches(3, 16)
    net = _net()
    drv = StepDriver(net, _factory(batches), k=k, prefetch=False)
    drv.run_round(2)
    path = tmp_path / "good.zip"
    drv.checkpoint(path)
    want = _digest(net)
    drv.run_round(1)  # work to roll back
    assert _digest(net) != want
    drv.restore(path)
    assert _digest(net) == want
    engine = net.__dict__.get("_train_steps_fused", {}).get((k, False))
    before = engine.captures if engine else 0
    drv.run_round(1)
    drv.run_round(1)
    if k > 1:
        # the restored tensors are new: the signature is built again, once
        assert engine.captures == before + 1
    drv.close_source()


def test_checkpoint_resolves_the_pending_score(tmp_path):
    net = _net()
    drv = StepDriver(net, _factory(_batches(2, 4)), prefetch=False)
    drv.run_round(3)
    assert len(net.score_history) == 2  # the third is in flight
    drv.checkpoint(tmp_path / "c.zip")
    assert len(net.score_history) == 3


def test_listener_order_and_fit_end_on_error():
    seen = []

    class Rec(TrainingListener):
        def on_epoch_start(self, model):
            seen.append("start")

        def iteration_done(self, model, iteration, score, etl_time=0.0):
            seen.append(iteration)

        def on_epoch_end(self, model):
            seen.append("end")

        def on_fit_end(self, model):
            seen.append("fit_end")

    net = _net()
    net.add_listener(Rec())
    StepDriver(net, _factory(_batches(4, 5)), k=2, batch_size=8, prefetch=True).run(2)
    assert seen == (["start", 1, 2, 3, 4, 5, "end", "start", 6, 7, 8, 9, 10, "end", "fit_end"])

    def boom():
        yield from [(x, y, None) for x, y in _batches(5, 2)]
        raise RuntimeError("source boom")

    seen.clear()
    with pytest.raises(RuntimeError, match="source boom"):
        StepDriver(net, boom).run(1)
    assert seen[-1] == "fit_end"


def test_fit_facades_delegate_to_the_driver(monkeypatch):
    seen = []
    orig = StepDriver.run

    def spy(self, epochs):
        seen.append((type(self.net).__name__, self.k))
        return orig(self, epochs)

    monkeypatch.setattr(StepDriver, "run", spy)
    x, y = _batches(0, 1)[0]
    _net().fit(x, y, batch_size=4)
    _net().fit(x, y, batch_size=4, steps_per_dispatch=2)
    g = ComputationGraph(
        GraphBuilder(seed=3, updater=U.Adam(learning_rate=0.03)).add_inputs("in")
        .set_input_types(I.FeedForwardType(12))
        .add_layer("d", L.DenseLayer(n_out=8), "in")
        .add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "d").set_outputs("out").build(),
        device="cpu")
    g.fit(x, y, batch_size=4)
    g.fit(x, y, batch_size=4, steps_per_dispatch=2)
    assert seen == [("MultiLayerNetwork", 1), ("MultiLayerNetwork", 2),
                    ("ComputationGraph", 1), ("ComputationGraph", 2)]


# ---------------------------------------------------------------------------
# bundles across the two packages
# ---------------------------------------------------------------------------

def _jax_trained(tmp_path):
    jnet = JNet(JConf(seed=1, updater=JU.Adam(learning_rate=0.01)).list(
        JL.DenseLayer(n_out=16, activation="relu"), JL.OutputLayer(n_out=3, loss="mcxent"),
        input_type=JI.FeedForwardType(12)))
    jnet.init()
    x, y = _batches(8, 1, batch=24)[0]
    jnet.fit(x, y, epochs=2, batch_size=8)
    path = str(tmp_path / "jax_bundle.zip")
    jser.save_bundle(jnet, path, buckets=[2, 8])
    return jnet, path


def _assert_same(tnet, jnet):
    mine = {k: v.detach().numpy() for k, v in
            flatten_tree([tnet.params, tnet.opt_state]).items()}
    theirs = flatten_tree([jax.tree_util.tree_map(np.asarray, jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.opt_state)])
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]), err_msg=k)
    assert (tnet.iteration, tnet.epoch) == (jnet.iteration, jnet.epoch) == (6, 2)


def test_a_jax_bundle_loads_in_the_port(tmp_path):
    jnet, path = _jax_trained(tmp_path)
    b = tser.load_bundle(path, device="cpu")
    assert b.buckets.sizes() == [2, 8]
    _assert_same(b.net, jnet)
    np.testing.assert_array_equal(b.net.rng, np.asarray(jnet._rng))
    # and it trains on from there through the driver
    StepDriver(b.net, _factory(_batches(9, 2)), prefetch=False).run(1)
    assert b.net.iteration == 8


def test_a_warm_manifest_is_dropped_with_a_warning(tmp_path):
    """A bundle's unreadable warm manifest is dropped with the JAX
    package's warning and counted ``deserialize_fail``; the net restores."""
    from deeplearning4j_tpu_torch import telemetry
    from deeplearning4j_tpu_torch.utils import compile_cache as cc

    jnet, path = _jax_trained(tmp_path)
    with zipfile.ZipFile(path, "a") as z:
        z.writestr("warm_manifest.zip", b"serialized executables")
    telemetry.reset()
    telemetry.enable()
    try:
        with pytest.warns(UserWarning, match="warm manifest"):
            b = tser.load_bundle(path, device="cpu")
        assert cc.event_counts().get("deserialize_fail") == 1
    finally:
        telemetry.reset()
        telemetry.disable()
    _assert_same(b.net, jnet)
    assert b.manifest is None


def test_a_port_bundle_loads_in_jax(tmp_path):
    net = _net(dropout=0.0)
    net.fit(*_batches(6, 1, batch=16)[0], batch_size=8, steps_per_dispatch=2)
    path = str(tmp_path / "port.zip")
    tser.save_bundle(net, path, buckets=[8])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = jser.load_bundle(path)
    assert b.buckets.sizes() == [8] and b.net.iteration == 2
    mine = flatten_tree([net.params, net.opt_state])
    theirs = flatten_tree([jax.tree_util.tree_map(np.asarray, b.net.params),
                           jax.tree_util.tree_map(np.asarray, b.net.opt_state)])
    for k in mine:
        np.testing.assert_array_equal(mine[k].detach().numpy(), np.asarray(theirs[k]))


def test_a_plain_checkpoint_loads_as_a_bundle(tmp_path):
    net = _net()
    net.fit(*_batches(6, 1)[0])
    path = tmp_path / "m.zip"
    tser.save_model(net, path)
    b = tser.load_bundle(path, device="cpu")
    assert b.buckets is None and _digest(b.net) == _digest(net)
    with pytest.raises(ValueError, match="initialized"):
        tser.save_bundle(MultiLayerNetwork(net.conf, device="cpu"), io.BytesIO())
