"""The port's K-step engine (``nn/fused.py``) and the iterators it rides on,
on the CPU.

The CPU runs the engine's plain version: the same step function over the
same static buffers, eagerly, where a card captures it into one CUDA graph
(``chip_smoke.py``'s ``fused`` phase holds the replay there). These tests
mirror the JAX package's ``tests/test_fused.py``:

* port K > 1 against port K = 1 in float32 at atol 1e-6 (the JAX tests'
  ``_tree_allclose``) over ragged datasets, a user mask, a pooled RNN,
  sequence labels, a graph, dropout and weight noise (the K = 1 loop draws
  from the same counter-based seeds the K-step engine derives on the
  device, so the masks are the same);
* port ``fit(steps_per_dispatch=4)`` against the JAX package's in float64
  at rtol 1e-9 (a small MultiLayerNetwork and a fused ResNet-shaped graph
  at 32 px; SGD at 0.0625, exact in float32, as ``test_torch_transfer.py``
  holds its steps), the ragged K-tail included;
* ``step_valid = 0`` is a no-op, with L2 and an updater whose state decays;
* one engine call per K steps and none for K = 1; signatures built stay
  at one across epochs that K does not divide;
* the super-batch and prefetch iterators, their error discipline and
  ``close()`` mid-stream;
* the step runs no host sync (``.item()``, ``nonzero``): the step a card
  captures must have none.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.datasets.iterator import SuperBatchIterator as JSuperBatchIterator
from deeplearning4j_tpu.models import resnet as JR
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import dtypes as jdt
from deeplearning4j_tpu_torch.datasets.iterator import (ArrayDataSetIterator,
                                                        AsyncDataSetIterator, DataSet,
                                                        DataSetIterator,
                                                        EarlyTerminationIterator,
                                                        MultipleEpochsIterator, SuperBatch,
                                                        SuperBatchIterator, iter_batches,
                                                        pad_batch)
from deeplearning4j_tpu_torch.models import resnet as TR
from deeplearning4j_tpu_torch.nn import fused as TF
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn import weightnoise as W
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder, LastTimeStepVertex
from deeplearning4j_tpu_torch.nn.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.telemetry import health
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import flatten_tree, tree_leaves


@pytest.fixture(autouse=True)
def _monitor_isolation():
    health.get_monitor().reset()
    yield
    health.get_monitor().reset()


def _mlp(seed=5, updater=None, **dense):
    conf = NeuralNetConfig(seed=seed, updater=updater or U.Adam(learning_rate=0.05)).list(
        L.DenseLayer(n_out=16, activation="tanh", **dense),
        L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=I.FeedForwardType(4))
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _graph(seed=9):
    conf = (GraphBuilder(seed=seed, updater=U.Adam(learning_rate=0.03))
            .add_inputs("in").set_input_types(I.FeedForwardType(4))
            .add_layer("d", L.DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", L.OutputLayer(n_out=2, loss="mcxent"), "d")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device="cpu")
    g.init()
    return g


def _data(n=40, n_classes=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 4).astype(np.float32)
    y = np.eye(n_classes, dtype=np.float32)[rs.randint(0, n_classes, n)]
    return x, y


def _tree_allclose(a, b, atol=1e-6):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=atol, rtol=0)


def _stack(net, n_steps, batch, seed=0):
    x, y = _data(n_steps * batch, seed=seed)
    return x.reshape(n_steps, batch, 4), y.reshape(n_steps, batch, 3)


# ---------------------------------------------------------------------------
# the engine: K steps == K single steps
# ---------------------------------------------------------------------------

class TestMakeTrainSteps:
    def test_matches_sequential_steps(self):
        net = _mlp()
        ref = _mlp()
        xs, ys = _stack(net, 4, 8)
        step = ref.make_train_step()
        ref.opt_state = ref.conf.updater.init(ref.params)
        seq = []
        for j in range(4):
            _, ref.state, ref.opt_state, loss = step(ref.params, ref.state, ref.opt_state,
                                                     torch.from_numpy(xs[j]),
                                                     torch.from_numpy(ys[j]), j,
                                                     torch.ones(8), 77 + j)
            seq.append(float(loss))
        net.opt_state = net.conf.updater.init(net.params)
        fused = net.make_train_steps(4)
        losses = fused(net.params, net.state, net.opt_state, xs, ys, 0, net.conf.seed,
                       np.ones((4, 8), np.float32), np.ones(4, np.float32))
        _tree_allclose(net.params, ref.params)
        _tree_allclose(net.opt_state, ref.opt_state)
        np.testing.assert_allclose(losses.numpy(), seq, atol=1e-6)

    @pytest.mark.parametrize("updater", [U.Adam(learning_rate=0.05),
                                         U.RmsProp(learning_rate=0.01),
                                         U.Nesterovs(learning_rate=0.05)],
                             ids=["adam", "rmsprop", "nesterovs"])
    def test_step_valid_zero_is_noop(self, updater):
        """Both steps valid against only the first: the second leaves
        params and updater state as they were, though L2 and the updater's
        decay would move them under a zero loss mask alone."""
        xs, ys = _stack(None, 2, 8)
        ones = np.ones((2, 8), np.float32)
        nets = []
        for sv in ([1.0, 1.0], [1.0, 0.0]):
            net = _mlp(updater=updater, l2=0.1)
            net.opt_state = net.conf.updater.init(net.params)
            net.make_train_steps(2)(net.params, net.state, net.opt_state, xs, ys, 0,
                                    net.conf.seed, ones, np.asarray(sv, np.float32))
            nets.append(net)
        one = _mlp(updater=updater, l2=0.1)
        one.opt_state = one.conf.updater.init(one.params)
        one.make_train_step()(one.params, one.state, one.opt_state, torch.from_numpy(xs[0]),
                              torch.from_numpy(ys[0]), 0, torch.ones(8), 0)
        _tree_allclose(nets[1].params, one.params, atol=0)
        _tree_allclose(nets[1].opt_state, one.opt_state, atol=0)
        with pytest.raises(AssertionError):
            _tree_allclose(nets[0].params, one.params)

    def test_all_steps_invalid_changes_nothing(self):
        net = _mlp(l2=0.1)
        net.opt_state = net.conf.updater.init(net.params)
        before = {k: v.clone() for k, v in flatten_tree([net.params, net.opt_state]).items()}
        xs, ys = _stack(net, 3, 8)
        net.make_train_steps(3)(net.params, net.state, net.opt_state, xs, ys, 5, net.conf.seed,
                                np.ones((3, 8), np.float32), np.zeros(3, np.float32))
        after = flatten_tree([net.params, net.opt_state])
        assert all(torch.equal(before[k], after[k]) for k in before)

    def test_with_health_bundle_stacked(self):
        net = _mlp()
        net.opt_state = net.conf.updater.init(net.params)
        xs, ys = _stack(net, 3, 8)
        losses, hb = net.make_train_steps(3, with_health=True)(
            net.params, net.state, net.opt_state, xs, ys, 0, net.conf.seed,
            np.ones((3, 8), np.float32), np.ones(3, np.float32))
        assert hb["grad_norm"].shape == (3,)
        np.testing.assert_allclose(hb["loss"].numpy(), losses.numpy(), atol=1e-6)
        assert not bool(hb["loss_nonfinite"].any())
        assert set(hb) >= {"layer/0/grad_norm", "layer/1/gw_ratio", "grad_nonfinite"}

    def test_base_step_refuses_health(self):
        net = _mlp()
        with pytest.raises(ValueError, match="base_step"):
            TF.make_train_steps(net, 2, with_health=True, base_step=net.make_train_step())

    def test_base_step_is_the_single_step(self):
        net = _mlp()
        net.opt_state = net.conf.updater.init(net.params)
        seen = []
        real = net.make_train_step()

        def base(*args):
            seen.append(1)
            return real(*args)

        xs, ys = _stack(net, 2, 8)
        TF.make_train_steps(net, 2, base_step=base)(
            net.params, net.state, net.opt_state, xs, ys, 0, net.conf.seed,
            np.ones((2, 8), np.float32), np.ones(2, np.float32))
        assert len(seen) == 2

    def test_the_step_makes_no_host_sync(self):
        """No ``.item()``/``float()``/``bool()`` and no data-dependent shape
        (``nonzero``) on the step path of the MLN, the graph, a GravesLSTM
        net with DropConnect and a fused ResNet-shaped graph: a captured
        CUDA graph can hold none of them."""
        class NoSync(TorchDispatchMode):
            banned = {"_local_scalar_dense", "nonzero", "masked_select", "item"}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                bool_index = name in ("index", "index_put", "index_put_") and any(
                    torch.is_tensor(i) and i.dtype == torch.bool for i in args[1] or ())
                if name in self.banned or bool_index:
                    raise AssertionError(f"host sync in the step: {func}")
                return func(*args, **(kwargs or {}))

        rs = np.random.RandomState(0)
        cases = [(_mlp(dropout=0.3, weight_noise=W.WeightNoise()), *_stack(None, 2, 8)),
                 (_graph(), _data(16, 2)[0].reshape(2, 8, 4), _data(16, 2)[1].reshape(2, 8, 2))]
        rnn = _rnn_net(weight_noise=W.DropConnect(0.8))
        cases.append((rnn, rs.rand(2, 4, 6, 4).astype(np.float32),
                      np.eye(2, dtype=np.float32)[rs.randint(0, 2, (2, 4, 6))]))
        res = _mini_resnet(TR, GraphBuilder, L, I, U.Adam(learning_rate=1e-3))
        res = ComputationGraph(res, device="cpu")
        res.init()
        cases.append((res, rs.rand(2, 2, 32, 32, 3).astype(np.float32),
                      np.eye(10, dtype=np.float32)[rs.randint(0, 10, (2, 2))]))
        for net, xs, ys in cases:
            net.opt_state = net.conf.updater.init(net.params)
            engine = net.make_train_steps(2, with_health=True)
            ms = np.ones(ys.shape[:2] + ((ys.shape[2],) if ys.ndim == 4 else ()), np.float32)
            with NoSync():
                engine(net.params, net.state, net.opt_state, xs, ys, 3, net.conf.seed, ms,
                       np.asarray([1.0, 0.0], np.float32))


# ---------------------------------------------------------------------------
# fit(steps_per_dispatch=K) against K = 1
# ---------------------------------------------------------------------------

def _rnn_net(seed=2, pooled=False, **lstm):
    layers = [L.GravesLSTM(n_out=8, **lstm)]
    if pooled:
        layers += [L.LastTimeStep(), L.OutputLayer(n_out=2, loss="mcxent")]
    else:
        layers += [L.RnnOutputLayer(n_out=2, loss="mcxent")]
    conf = NeuralNetConfig(seed=seed, updater=U.Sgd(learning_rate=0.1)).list(
        *layers, input_type=I.RecurrentType(4))
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


class TestFitFused:
    @pytest.mark.parametrize("k", [2, 3, 4, 5])
    def test_parity_ragged_dataset(self, k):
        # 40 % 16 != 0: a ragged tail batch and a ragged K-tail
        x, y = _data(40)
        a, b = _mlp(), _mlp()
        a.fit(x, y, epochs=2, batch_size=16)
        b.fit(x, y, epochs=2, batch_size=16, steps_per_dispatch=k)
        assert a.iteration == b.iteration == 6 and a.epoch == b.epoch == 2
        _tree_allclose(a.params, b.params)
        _tree_allclose(a.opt_state, b.opt_state)
        np.testing.assert_allclose(b.score_history, a.score_history, atol=1e-6)

    def test_parity_with_user_mask(self):
        x, y = _data(40)
        mask = (np.random.RandomState(3).rand(40) > 0.2).astype(np.float32)
        a, b = _mlp(), _mlp()
        a.fit(x, y, epochs=2, batch_size=16, mask=mask)
        b.fit(x, y, epochs=2, batch_size=16, mask=mask, steps_per_dispatch=4)
        _tree_allclose(a.params, b.params)

    def test_parity_with_health_and_listeners(self):
        health.enable(policy="record")
        x, y = _data(40)
        a, b = _mlp(), _mlp()
        ca, cb = CollectScoresListener(), CollectScoresListener()
        a.add_listener(ca)
        b.add_listener(cb)
        a.fit(x, y, epochs=2, batch_size=16)
        b.fit(x, y, epochs=2, batch_size=16, steps_per_dispatch=3)
        _tree_allclose(a.params, b.params)
        assert cb.iterations == ca.iterations  # every step fans out, in order
        np.testing.assert_allclose(cb.scores, ca.scores, atol=1e-6)
        assert health.get_monitor().summary()["steps_checked"] == 12  # tail steps dropped

    def test_score_value_is_last_real_step(self):
        x, y = _data(40)
        a, b = _mlp(), _mlp()
        a.fit(x, y, epochs=1, batch_size=16)
        b.fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=2)
        np.testing.assert_allclose(b.score_value, a.score_value, atol=1e-6)

    def test_graph_parity(self):
        x, y = _data(40, n_classes=2)
        a, b = _graph(), _graph()
        a.fit(x, y, epochs=2, batch_size=16)
        b.fit(x, y, epochs=2, batch_size=16, steps_per_dispatch=4)
        _tree_allclose(a.params, b.params)
        _tree_allclose(a.opt_state, b.opt_state)

    def test_pooled_rnn_parity(self):
        """Temporal features and pooled labels: the validity mask is 1-d,
        reaches the loss and not the mask-aware LSTM."""
        rs = np.random.RandomState(1)
        x = rs.rand(20, 6, 4).astype(np.float32)  # 20 % 8 != 0
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, 20)]
        a, b = _rnn_net(pooled=True), _rnn_net(pooled=True)
        a.fit(x, y, epochs=2, batch_size=8)
        b.fit(x, y, epochs=2, batch_size=8, steps_per_dispatch=2)
        _tree_allclose(a.params, b.params, atol=1e-5)

    def test_sequence_labels_parity(self):
        """[B, T, C] labels: the validity mask is [B, T] and serves the
        LSTM's mask and the masked-mean loss."""
        rs = np.random.RandomState(1)
        x = rs.rand(20, 6, 4).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (20, 6))]
        a, b = _rnn_net(seed=4), _rnn_net(seed=4)
        a.fit(x, y, epochs=2, batch_size=8)
        b.fit(x, y, epochs=2, batch_size=8, steps_per_dispatch=2)
        _tree_allclose(a.params, b.params, atol=1e-5)

    @pytest.mark.parametrize("noise", [None, W.DropConnect(0.8), W.WeightNoise()],
                             ids=["dropout", "dropconnect", "weightnoise"])
    def test_draws_match_the_k1_loop(self, noise):
        """Dropout and weight noise at K=4 draw the K=1 loop's masks: the
        engine derives each step's seed on the device from the iteration,
        which the K=1 loop computes on the host; padding to one batch shape
        (``pad_ragged``) keeps the draws' shapes equal."""
        x, y = _data(48)
        kw = {"dropout": 0.3} if noise is None else {"weight_noise": noise}
        a, b, plain = _mlp(**kw), _mlp(**kw), _mlp()
        a.fit(x, y, epochs=2, batch_size=8, pad_ragged=True)
        b.fit(x, y, epochs=2, batch_size=8, steps_per_dispatch=4)
        plain.fit(x, y, epochs=2, batch_size=8, pad_ragged=True)
        _tree_allclose(a.params, b.params)
        with pytest.raises(AssertionError):
            _tree_allclose(a.params, plain.params)

    def test_graph_mixed_label_layouts_rejected_under_bucketing(self):
        conf = (GraphBuilder(seed=3, updater=U.Sgd(learning_rate=0.1))
                .add_inputs("in").set_input_types(I.RecurrentType(4))
                .add_layer("lstm", L.GravesLSTM(n_out=8), "in")
                .add_layer("seq", L.RnnOutputLayer(n_out=2, loss="mcxent"), "lstm")
                .add_vertex("last", LastTimeStepVertex(), "lstm")
                .add_layer("pooled", L.OutputLayer(n_out=2, loss="mcxent"), "last")
                .set_outputs("seq", "pooled").build())
        g = ComputationGraph(conf, device="cpu")
        rs = np.random.RandomState(0)
        x = rs.rand(6, 5, 4).astype(np.float32)
        labels = {"seq": np.eye(2, dtype=np.float32)[rs.randint(0, 2, (6, 5))],
                  "pooled": np.eye(2, dtype=np.float32)[rs.randint(0, 2, 6)]}
        with pytest.raises(ValueError, match="label layout"):
            g.fit({"in": x}, labels, batch_size=4, steps_per_dispatch=2)
        with pytest.raises(ValueError, match="label layout"):
            g.fit({"in": x}, labels, batch_size=4, pad_ragged=True)

    def test_tbptt_rejected_only_when_it_would_engage(self):
        def tb_net():
            conf = NeuralNetConfig(seed=2, updater=U.Sgd(learning_rate=0.1)).list(
                L.GravesLSTM(n_out=8), L.RnnOutputLayer(n_out=2, loss="mcxent"),
                input_type=I.RecurrentType(4), backprop_type="tbptt", tbptt_fwd_length=10)
            return MultiLayerNetwork(conf, device="cpu")

        x = np.zeros((2, 40, 4), np.float32)
        y = np.zeros((2, 40, 2), np.float32)
        with pytest.raises(ValueError, match="TBPTT"):
            tb_net().fit(x, y, steps_per_dispatch=2)
        rs = np.random.RandomState(0)
        xs = rs.rand(4, 6, 4).astype(np.float32)
        ys = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (4, 6))]
        net = tb_net()
        net.fit(xs, ys, epochs=1, batch_size=2, steps_per_dispatch=2)
        assert net.iteration == 2

    def test_graph_tbptt_rejected_at_k_above_1(self):
        conf = (GraphBuilder(seed=3, updater=U.Sgd(learning_rate=0.1), backprop_type="tbptt",
                             tbptt_fwd_length=4)
                .add_inputs("in").set_input_types(I.RecurrentType(4))
                .add_layer("lstm", L.GravesLSTM(n_out=8), "in")
                .add_layer("out", L.RnnOutputLayer(n_out=2, loss="mcxent"), "lstm")
                .set_outputs("out").build())
        g = ComputationGraph(conf, device="cpu")
        x = np.zeros((2, 12, 4), np.float32)
        y = np.zeros((2, 12, 2), np.float32)
        with pytest.raises(ValueError, match="TBPTT"):
            g.fit(x, y, steps_per_dispatch=2)

    def test_dispatch_count_one_per_k_steps(self):
        x, y = _data(37)  # 5 minibatches of 8: 2 dispatches at K=4
        net = _mlp()
        net.fit(x, y, epochs=1, batch_size=8, steps_per_dispatch=4)
        engine = net._train_steps_fused[(4, False)]
        assert net.iteration == 5 and engine.calls == 2 and engine.replays == 0

    def test_k1_loop_makes_no_engine_call(self):
        x, y = _data(24)
        net = _mlp()
        net._train_steps_fused = {}
        net.fit(x, y, epochs=1, batch_size=8)
        assert net._train_steps_fused == {}

    def test_signatures_flat_across_nondivisible_epochs(self):
        """40 % 16 != 0 and 3 batches % 2 != 0: one signature built for the
        whole fit (the JAX package's "recompiles stay flat")."""
        x, y = _data(40)
        net = _mlp()
        net.fit(x, y, epochs=3, batch_size=16, steps_per_dispatch=2)
        engine = net._train_steps_fused[(2, False)]
        assert engine.calls == 6 and engine.captures == 1
        net.fit(x, y, epochs=1, batch_size=16, steps_per_dispatch=2)
        assert engine.captures == 1

    def test_signature_rebuilt_when_the_net_tensors_change(self, tmp_path):
        """A K=1 fit rebinds the layer state; a restored checkpoint brings
        new tensors: the engine builds the signature again, once each."""
        from deeplearning4j_tpu_torch.continuous.driver import _rearm_net
        x, y = _data(32)
        net = _mlp()
        net.fit(x, y, batch_size=8, steps_per_dispatch=2)
        engine = net._train_steps_fused[(2, False)]
        tser.save_bundle(net, tmp_path / "b.zip")
        _rearm_net(net, tser.load_bundle(tmp_path / "b.zip", device="cpu").net)
        net.fit(x, y, batch_size=8, steps_per_dispatch=2)
        net.fit(x, y, batch_size=8, steps_per_dispatch=2)
        assert engine.captures == 2

    def test_k1_pad_ragged_equals_plain_loop(self):
        x, y = _data(40)
        a, b = _mlp(), _mlp()
        a.fit(x, y, epochs=3, batch_size=16, pad_ragged=True)
        b.fit(x, y, epochs=3, batch_size=16)
        _tree_allclose(a.params, b.params)

    def test_fit_closes_prefetcher_on_listener_exception(self):
        class Bomb(CollectScoresListener):
            def iteration_done(self, model, iteration, score, etl_time=0.0):
                raise RuntimeError("listener bomb")

        x, y = _data(40)
        net = _mlp()
        net.add_listener(Bomb())
        before = threading.active_count()
        with pytest.raises(RuntimeError, match="listener bomb"):
            net.fit(x, y, epochs=2, batch_size=8, steps_per_dispatch=2)
        deadline = time.time() + 5
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.01)
        assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# against the JAX package's fused fit, in float64
# ---------------------------------------------------------------------------

LR = 0.0625  # exact in float32: the port's scalar factors are float32


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _np64(tree):
    return {k: (v.detach().double().numpy() if torch.is_tensor(v) else np.asarray(v, np.float64))
            for k, v in flatten_tree(tree).items()}


def _close64(got, want, what):
    g, w = _np64(got), _np64(want)
    assert set(g) == set(w), what
    for k in w:
        scale = float(np.abs(w[k]).max()) if w[k].size else 0.0
        np.testing.assert_allclose(g[k], w[k], rtol=1e-9, atol=1e-12 + 1e-12 * scale,
                                   err_msg=f"{what} {k}")


class _f64_policy:
    def __enter__(self):
        jdt.set_policy(param_dtype=jnp.float64, compute_dtype=jnp.float64,
                       accum_dtype=jnp.float64)

    def __exit__(self, *exc):
        jdt.f32_policy()


def _mini_resnet(R, GB, L_, I_, updater):
    g = GB(updater=updater, seed=3)
    g.add_inputs("input")
    g.set_input_types(I_.ConvolutionalType(32, 32, 3))
    x = R._conv_bn(g, "stem", "input", 8, (3, 3), stride=(2, 2))
    g.add_layer("stem_pool", L_.SubsamplingLayer(kernel=(3, 3), stride=(2, 2), padding="same",
                                                 mode="max"), x)
    x = "stem_pool"
    for si, (filters, stride) in enumerate([(8, (1, 1)), (16, (2, 2))]):
        for bi in range(2):
            x = R._bottleneck(g, f"s{si}b{bi}", x, filters, stride=stride if bi == 0 else (1, 1),
                              project=bi == 0, fused=True)
    g.add_layer("avgpool", L_.GlobalPoolingLayer(mode="avg"), x)
    g.add_layer("fc", L_.OutputLayer(n_out=10, loss="mcxent"), "avgpool")
    g.set_outputs("fc")
    return g.build()


def test_mln_fused_fit_matches_jax_in_float64():
    """11 examples at batch 2: six batches, the last of one; K=4 gives two
    dispatches, the second with two real steps and a padded batch."""
    def layers(Lm):
        return (Lm.DenseLayer(n_out=16, activation="tanh", l2=0.01),
                Lm.DenseLayer(n_out=8, activation="relu"),
                Lm.OutputLayer(n_out=3, loss="mcxent"))
    jnet = JNet(JConf(seed=4, updater=JU.Sgd(learning_rate=LR)).list(
        *layers(JL), input_type=JI.FeedForwardType(5)))
    jnet.init()
    jnet.params = _f64(jnet.params)
    tnet = MultiLayerNetwork(NeuralNetConfig(seed=4, updater=U.Sgd(learning_rate=LR)).list(
        *layers(L), input_type=I.FeedForwardType(5)), device="cpu")
    tnet.init(dtype=torch.float64)
    tser.params_from_numpy(tnet, [{k: np.asarray(v) for k, v in p.items()}
                                  for p in jnet.params])
    rs = np.random.RandomState(0)
    x = rs.randn(11, 5)
    y = np.eye(3)[rs.randint(0, 3, 11)]
    with _f64_policy():
        jnet.fit(x, y, epochs=2, batch_size=2, steps_per_dispatch=4)
    tnet.fit(x, y, epochs=2, batch_size=2, steps_per_dispatch=4)
    assert tnet.iteration == jnet.iteration == 12
    _close64(tnet.params, jnet.params, "params")
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=1e-9)


def test_fused_resnet_graph_fit_matches_jax_in_float64():
    """The fused ResNet-shaped graph at 32 px (the conv kernels' plain
    versions here, the JAX vertex's XLA path there), K=4 over 5 batches of
    2 and one of 1: parameters, BN state and the loss."""
    jnet = JGraph(_mini_resnet(JR, JGB, JL, JI, JU.Sgd(learning_rate=LR)))
    jnet.init()
    jnet.params, jnet.state = _f64(jnet.params), _f64(jnet.state)
    tnet = ComputationGraph(_mini_resnet(TR, GraphBuilder, L, I, U.Sgd(learning_rate=LR)),
                            device="cpu")
    tnet.init(dtype=torch.float64)
    tser.params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
                           state=jax.tree_util.tree_map(np.asarray, jnet.state))
    rs = np.random.RandomState(1)
    x = rs.rand(11, 32, 32, 3)
    y = np.eye(10)[rs.randint(0, 10, 11)]
    with _f64_policy():
        jnet.fit({"input": x}, {"fc": y}, batch_size=2, steps_per_dispatch=4)
    tnet.fit({"input": x}, {"fc": y}, batch_size=2, steps_per_dispatch=4)
    assert tnet.iteration == jnet.iteration == 6
    _close64(tnet.params, jnet.params, "params")
    _close64(tnet.state, jnet.state, "state")
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value), rtol=1e-9)


# ---------------------------------------------------------------------------
# super-batches
# ---------------------------------------------------------------------------

class TestSuperBatchIterator:
    def test_stacks_pads_and_k_tails(self):
        x, y = _data(37)
        sbs = list(SuperBatchIterator(ArrayDataSetIterator(x, y, batch_size=8), 3))
        assert [sb.n_steps for sb in sbs] == [3, 2]
        for sb in sbs:
            assert sb.features.shape == (3, 8, 4) and sb.labels.shape == (3, 8, 3)
            assert sb.labels_mask.shape == (3, 8)
        np.testing.assert_array_equal(sbs[0].step_valid, [1, 1, 1])
        np.testing.assert_array_equal(sbs[1].step_valid, [1, 1, 0])
        np.testing.assert_array_equal(sbs[1].labels_mask.sum(axis=1), [8, 5, 0])
        assert float(np.abs(sbs[1].features[2]).sum()) == 0.0

    def test_matches_the_jax_iterator(self):
        x, y = _data(37)
        mask = (np.random.RandomState(2).rand(37) > 0.3).astype(np.float32)

        def src():
            return iter_batches(x, y, 8, mask)
        from deeplearning4j_tpu.datasets.iterator import iter_batches as j_iter
        mine = list(SuperBatchIterator(src, 3, batch_size=8))
        theirs = list(JSuperBatchIterator(lambda: j_iter(x, y, 8, mask), 3, batch_size=8))
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            for f in ("features", "labels", "labels_mask", "step_valid"):
                np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)))
            assert a.n_steps == b.n_steps

    def test_reset_via_iter_protocol(self):
        x, y = _data(32)
        it = SuperBatchIterator(ArrayDataSetIterator(x, y, batch_size=8), 2)
        assert len(list(it)) == 2
        assert len(list(it)) == 2

    def test_callable_source_and_dict_inputs(self):
        x, y = _data(20, n_classes=2)
        sbs = list(SuperBatchIterator(lambda: iter_batches(x, y, 8), 2, batch_size=8))
        assert [sb.n_steps for sb in sbs] == [2, 1]
        cg_src = lambda: (({"a": bx}, {"o": by}, bm) for bx, by, bm in iter_batches(x, y, 8))
        sbs = list(SuperBatchIterator(cg_src, 2, batch_size=8))
        assert sbs[0].features["a"].shape == (2, 8, 4)
        assert sbs[-1].labels["o"].shape == (2, 8, 2)
        np.testing.assert_array_equal(sbs[-1].labels_mask.sum(axis=1), [4, 0])

    def test_tensor_sources_stack_on_the_host(self):
        x, y = _data(12)
        src = lambda: iter_batches(torch.from_numpy(x), torch.from_numpy(y), 8)
        sbs = list(SuperBatchIterator(src, 2))
        assert isinstance(sbs[0].features, np.ndarray) and sbs[0].features.shape == (2, 8, 4)

    def test_pad_batch_timeseries_mask(self):
        x = np.zeros((3, 7, 4), np.float32)
        y = np.zeros((3, 7, 2), np.float32)
        px, py, m, n = pad_batch(x, y, None, 5)
        assert px.shape == (5, 7, 4) and py.shape == (5, 7, 2) and m.shape == (5, 7) and n == 3
        np.testing.assert_array_equal(m.sum(axis=1), [7, 7, 7, 0, 0])

    def test_pad_batch_dicts(self):
        x = {"a": np.ones((3, 4), np.float32), "b": np.ones((3, 2, 5), np.float32)}
        y = {"o": np.ones((3, 2), np.float32)}
        px, py, m, n = pad_batch(x, y, None, 4)
        assert px["a"].shape == (4, 4) and px["b"].shape == (4, 2, 5) and py["o"].shape == (4, 2)
        np.testing.assert_array_equal(m, [1, 1, 1, 0])

    def test_array_iterator_pad_last(self):
        x, y = _data(20)
        batches = list(ArrayDataSetIterator(x, y, batch_size=8, pad_last=True))
        assert all(b.features.shape == (8, 4) for b in batches)
        assert [int(b.features_mask.sum()) for b in batches] == [8, 8, 4]

    def test_array_iterator_shuffle_drop_last_and_wrappers(self):
        x, y = _data(20)
        it = ArrayDataSetIterator(x, y, batch_size=8, shuffle=True, drop_last=True)
        first = [b.features for b in it]
        assert len(first) == 2 and not np.array_equal(np.concatenate(first), x[:16])
        assert len(list(MultipleEpochsIterator(ArrayDataSetIterator(x, y, 8), 3))) == 9
        assert len(list(EarlyTerminationIterator(ArrayDataSetIterator(x, y, 4), 2))) == 2


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

class _BoomIterator(DataSetIterator):
    def __init__(self, good=2):
        self.good = good
        self._i = 0

    @property
    def batch_size(self):
        return 4

    def reset(self):
        self._i = 0

    def __next__(self):
        self._i += 1
        if self._i > self.good:
            raise RuntimeError("producer boom")
        return DataSet(features=np.zeros((4, 2), np.float32), labels=np.zeros((4, 1), np.float32))


class TestAsyncPrefetch:
    def test_producer_error_propagates_promptly(self):
        it = AsyncDataSetIterator(_BoomIterator(good=2), queue_size=4)
        it.reset()
        deadline = time.time() + 5
        while it._error is None and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="producer boom"):
            next(it)
        it.close()
        assert it._thread is None

    def test_error_raised_at_sentinel_when_consumed_first(self):
        it = AsyncDataSetIterator(_BoomIterator(good=2), queue_size=1)
        with pytest.raises(RuntimeError, match="producer boom"):
            for _ in range(10):
                next(it)
        it.close()

    def test_close_joins_producer_midstream(self):
        it = AsyncDataSetIterator(_BoomIterator(good=10 ** 6), queue_size=2)
        next(it)
        thread = it._thread
        it.close()
        assert it._thread is None and not thread.is_alive()
        assert next(it) is not None  # restarts cleanly
        it.close()

    def test_superbatch_rides_the_queue_intact_onto_the_device(self):
        x, y = _data(20)
        sbit = SuperBatchIterator(ArrayDataSetIterator(x, y, batch_size=8), 2)
        it = AsyncDataSetIterator(sbit, queue_size=2, device="cpu")
        sbs = list(it)
        assert [sb.n_steps for sb in sbs] == [2, 1]
        assert all(isinstance(sb, SuperBatch) for sb in sbs)
        assert torch.is_tensor(sbs[0].features) and sbs[0].features.shape == (2, 8, 4)
        np.testing.assert_array_equal(sbs[1].step_valid, [1, 0])
        it.close()


def test_launch_tally_counts_this_thread_only():
    """A capture's launches are the capturing thread's: ``launch_tally``
    counts what ``note_launch`` reports on its own thread (another
    thread's launches meanwhile stay out), and a nested tally also counts
    into the outer one."""
    import threading

    from deeplearning4j_tpu_torch.ops import _build

    ready, done = threading.Event(), threading.Event()

    def other():
        ready.wait(10)
        for _ in range(5):
            _build.note_launch("lstm_seq", "lstm_seq.variant.persistent")
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with _build.launch_tally() as outer:
        _build.note_launch("lstm_seq", "lstm_seq.variant.persistent")
        ready.set()
        done.wait(10)
        with _build.launch_tally() as inner:
            _build.note_launch("conv_stats.conv_mm_stats")
    t.join(10)
    assert inner == {"conv_stats.conv_mm_stats": 1}
    assert outer == {"lstm_seq": 1, "lstm_seq.variant.persistent": 1,
                     "conv_stats.conv_mm_stats": 1}
    _build.note_launch("lstm_seq")  # no tally open: nothing to count into
