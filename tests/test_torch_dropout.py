"""Input dropout and DropoutLayer in the port.

The masks cannot match the JAX package's bits (threefry Bernoulli there, a
seeded ``torch.Generator`` here), so the parity tests elsewhere run with
the rate at 0 and these tests hold the port's own contract: the keep rate
and the 1/(1 - rate) scale (over 10^6 draws the kept share lies within
5 standard deviations, 5·sqrt(p(1-p)/n) <= 2.5e-3, of 1 - rate), one mask
per seed, a no-op in eval mode and without a seed, one seed a train step
that a run resumed from a checkpoint draws again, and remat: a segment
recomputed in the backward draws the masks of its forward, so its
gradients equal the plain step's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import graph as TG
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.layers import base as B
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import tree_leaves

N = 1_000_000


@pytest.mark.parametrize("rate", [0.1, 0.4, 0.5, 0.9])
def test_dropout_mask_keep_rate_and_scale(rate):
    x = torch.ones(N, dtype=torch.float64)
    y = B.dropout_mask(7, x, rate)
    kept = y != 0
    assert abs(kept.double().mean().item() - (1 - rate)) <= 5 * (rate * (1 - rate) / N) ** 0.5
    assert torch.all(y[kept] == 1 / (1 - rate))
    assert torch.equal(B.dropout_mask(7, x, rate), y)  # one mask a seed
    assert not torch.equal(B.dropout_mask(8, x, rate), y)


def test_dropout_mask_keeps_dtype_and_shape():
    x = torch.randn(4, 5, 6, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    y = B.dropout_mask(3, x, 0.5)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    kept = y != 0
    torch.testing.assert_close(y[kept], (x / 0.5)[kept], rtol=0, atol=0)


def test_seeds_split_and_step_seed_are_deterministic():
    assert B.split_seed(5, 4) == B.split_seed(5, 4) and len(set(B.split_seed(5, 4))) == 4
    assert B.split_seed(5, 2) == B.split_seed(5, 4)[:2]
    assert B.step_seed(12345, 3) == B.step_seed(12345, 3) != B.step_seed(12345, 4)
    assert B.step_seed(12345, 3) != B.step_seed(54321, 3)


@pytest.mark.parametrize("kind", ["dropout", "alpha", "gaussian_dropout", "gaussian_noise"])
def test_dropout_layer_kinds(kind):
    layer = TL.DropoutLayer(rate=0.2, kind=kind)
    x = torch.randn(N, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    assert layer.apply({}, {}, x, train=False, rng=3)[0] is x
    assert layer.apply({}, {}, x, train=True, rng=None)[0] is x
    y, _ = layer.apply({}, {}, x, train=True, rng=3)
    assert torch.equal(layer.apply({}, {}, x, train=True, rng=3)[0], y)
    tol = 5e-3  # 5 standard deviations of a mean over 10^6 unit-variance draws
    if kind == "dropout":
        kept = y != 0
        assert abs(kept.double().mean().item() - 0.8) <= 5 * (0.16 / N) ** 0.5
        torch.testing.assert_close(y[kept], x[kept] / 0.8, rtol=1e-15, atol=0)
    elif kind == "alpha":  # keeps a standard normal input's mean 0 and variance 1
        assert abs(y.mean().item()) <= tol and abs(y.var().item() - 1) <= 3 * tol
    elif kind == "gaussian_dropout":  # x * N(1, rate / (1 - rate))
        noise = y / x
        assert abs(noise.mean().item() - 1) <= tol and abs(noise.var().item() - 0.25) <= tol
    else:  # x + N(0, rate^2)
        noise = y - x
        assert abs(noise.mean().item()) <= tol and abs(noise.std().item() - 0.2) <= tol
    with pytest.raises(ValueError, match="kind"):
        TL.DropoutLayer(kind="bogus").apply({}, {}, x, train=True, rng=1)


def _mln(dropout=0.3):
    return NeuralNetConfig(seed=3, updater=TU.Sgd(learning_rate=0.5)).list(
        TL.DenseLayer(n_out=16, activation="tanh"),
        TL.DenseLayer(n_out=16, activation="tanh", dropout=dropout),
        TL.DropoutLayer(rate=0.25),
        TL.OutputLayer(n_out=3),
        input_type=TI.FeedForwardType(5))


def _data(n=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 5).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])


def test_mln_dropout_only_in_train_steps_with_a_seed():
    net = TNet(_mln(), device="cpu")
    net.init()
    x, y = (torch.from_numpy(a) for a in _data())
    a = net.compute_gradients(net.params, net.state, x, y, rng=11)
    b = net.compute_gradients(net.params, net.state, x, y, rng=11)
    c = net.compute_gradients(net.params, net.state, x, y, rng=12)
    off = net.compute_gradients(net.params, net.state, x, y)
    plain = TNet(_mln(dropout=0.0), device="cpu")
    plain.init()
    ref = plain.compute_gradients(plain.params, plain.state, x, y)
    assert float(a[0]) == float(b[0]) != float(c[0])
    assert float(off[0]) != float(a[0])
    # no seed: no draws (input dropout and DropoutLayer both off)
    for g, h in zip(tree_leaves(off[2]), tree_leaves(ref[2])):
        torch.testing.assert_close(g, h, rtol=0, atol=0)
    np.testing.assert_array_equal(net.output(x).numpy(), plain.output(x).numpy())


def test_a_resumed_run_draws_the_uninterrupted_runs_masks(tmp_path):
    x, y = _data(16)
    whole = TNet(_mln(), device="cpu")
    whole.fit(x, y, batch_size=4)  # 4 steps
    first = TNet(_mln(), device="cpu")
    first.fit(x[:8], y[:8], batch_size=4)
    tser.save_model(first, tmp_path / "half.zip")
    resumed = tser.load_model(tmp_path / "half.zip", device="cpu")
    assert resumed.iteration == 2
    resumed.fit(x[8:], y[8:], batch_size=4)
    for p, q in zip(tree_leaves(resumed.params), tree_leaves(whole.params)):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def _graph(scope=None, checkpointing=False):
    """A graph whose vertices named blk_* form one remat group holding a
    layer with input dropout and a DropoutLayer."""
    return (TG.GraphBuilder(updater=TU.Sgd(learning_rate=0.1), checkpoint_scope=scope,
                            gradient_checkpointing=checkpointing)
            .add_inputs("input").set_input_types(TI.ConvolutionalType(6, 6, 3))
            .add_layer("blk_conv", TL.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same",
                                                       activation="relu"), "input")
            .add_layer("blk_drop", TL.DropoutLayer(rate=0.5), "blk_conv")
            .add_layer("blk_conv2", TL.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same",
                                                        activation="relu", dropout=0.3),
                       "blk_drop")
            .add_layer("blk_bn", TL.BatchNormalization(), "blk_conv2")
            .add_layer("pool", TL.GlobalPoolingLayer(mode="avg"), "blk_bn")
            .add_layer("out", TL.OutputLayer(n_out=3, dropout=0.2), "pool")
            .set_outputs("out").build())


@pytest.mark.parametrize("remat", ["prefix", "every_vertex"])
def test_dropout_inside_a_remat_segment_gives_the_plain_gradient(remat):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(4, 6, 6, 3))
    y = torch.from_numpy(np.eye(3)[[0, 1, 2, 1]])
    plain = TG.ComputationGraph(_graph(), device="cpu")
    net = TG.ComputationGraph(_graph(*(("prefix", False) if remat == "prefix"
                                       else (None, True))), device="cpu")
    if remat == "prefix":
        assert net._segments[0] == ("group", ("blk_conv", "blk_drop", "blk_conv2", "blk_bn"),
                                    ("input",), ("blk_bn",))
    results = []
    for n in (plain, net):
        n.init(torch.Generator().manual_seed(0), dtype=torch.float64)
        results.append(n.compute_gradients(n.params, n.state, {"input": x}, {"out": y}, rng=5))
    (l0, s0, g0), (l1, s1, g1) = results
    assert float(l1) == float(l0)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-15)
    for a, b in zip(tree_leaves(s1), tree_leaves(s0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the masks are live: another seed, another step
    other = plain.compute_gradients(plain.params, plain.state, {"input": x}, {"out": y}, rng=6)
    assert float(other[0]) != float(l0)


def test_graph_fit_draws_one_seed_a_step():
    x, y = _data(8)
    conf = (TG.GraphBuilder(updater=TU.Sgd(learning_rate=0.5), seed=9).add_inputs("in")
            .set_input_types(TI.FeedForwardType(5))
            .add_layer("h", TL.DenseLayer(n_out=8, activation="tanh"), "in")
            .add_layer("out", TL.OutputLayer(n_out=3, dropout=0.5), "h")
            .set_outputs("out").build())
    runs = []
    for c in (conf, conf, dataclasses.replace(conf, seed=10)):
        net = TG.ComputationGraph(c, device="cpu")
        net.init(torch.Generator().manual_seed(0))
        net.fit(x, y, batch_size=4)
        runs.append(net.params["out"]["W"].detach().clone())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
