"""Weight noise in the port (``nn/weightnoise.py``), on the CPU.

The draws are the port's counter-based bits, not the JAX package's
threefry ones, so these tests hold the port's own contract: DropConnect
keeps each weight with its retain probability (over 10^6 draws the kept
share lies within 5 standard deviations of it) and scales the kept ones by
its inverse; WeightNoise adds (or multiplies by) draws of its distribution
(mean and standard deviation within 5 standard errors); biases stay as
they are unless ``apply_to_bias``; one draw a seed; the gradient flows
through the perturbed weights (a dropped weight gets none); inference and
steps without a seed see the plain weights. Against the JAX package: the
configurations round-trip through JSON in both directions, and with the
noise switched off (std 0, retain 1.0) the port's step equals the JAX
package's step with the same switched-off noise (float64, rtol 1e-9).
With the noise on, the K=4 engine draws the K=1 loop's bits, in a
sequential network and in a graph, whose layer vertices the port perturbs
as DL4J does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import initializers as JInit
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn import weightnoise as JW
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JConfiguration
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.nn import initializers as Init
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn import weightnoise as W
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import serialization as tser
from deeplearning4j_tpu_torch.utils.trees import tree_leaves

N = 1_000_000
DENSE = L.DenseLayer(n_out=1000)


def _params():
    return {"W": torch.full((N // 1000, 1000), 2.0, dtype=torch.float64),
            "b": torch.full((1000,), 3.0, dtype=torch.float64)}


@pytest.mark.parametrize("retain", [0.5, 0.9])
def test_dropconnect_keep_share_scale_and_bias(retain):
    out = W.DropConnect(retain).perturb(11, DENSE, _params())
    kept = out["W"] != 0
    share = kept.double().mean().item()
    assert abs(share - retain) <= 5 * (retain * (1 - retain) / N) ** 0.5
    assert torch.all(out["W"][kept] == 2.0 / retain)
    assert torch.equal(out["b"], _params()["b"])
    assert torch.equal(W.DropConnect(retain).perturb(11, DENSE, _params())["W"], out["W"])
    assert not torch.equal(W.DropConnect(retain).perturb(12, DENSE, _params())["W"], out["W"])
    both = W.DropConnect(retain, apply_to_bias=True).perturb(11, DENSE, _params())
    assert not torch.equal(both["b"], _params()["b"])


@pytest.mark.parametrize("additive", [True, False])
def test_weight_noise_moments(additive):
    dist = Init.Distribution(kind="normal", mean=0.0 if additive else 1.0, std=0.1)
    out = W.WeightNoise(dist, additive=additive).perturb(5, DENSE, _params())
    noise = (out["W"] - 2.0) if additive else out["W"] / 2.0
    want_mean = 0.0 if additive else 1.0
    assert abs(noise.mean().item() - want_mean) <= 5 * 0.1 / N ** 0.5
    assert abs(noise.std().item() - 0.1) <= 5 * 0.1 / (2 * N) ** 0.5
    assert torch.equal(out["b"], _params()["b"])
    assert out["W"].dtype == torch.float64


@pytest.mark.parametrize("dist", [Init.Distribution(kind="uniform", lower=-0.5, upper=0.5),
                                  Init.Distribution(kind="constant", value=0.25),
                                  Init.Distribution(kind="truncated_normal", std=0.2)],
                         ids=["uniform", "constant", "truncated_normal"])
def test_weight_noise_distributions(dist):
    n = W.WeightNoise(dist, apply_to_bias=True).perturb(3, DENSE, _params())
    w = n["W"] - 2.0
    if dist.kind == "uniform":
        assert w.min() >= -0.5 and w.max() < 0.5 and abs(w.mean().item()) < 5e-3
    elif dist.kind == "constant":
        assert torch.all(w == 0.25)
    else:
        assert w.abs().max() <= 0.4 + 1e-6 and abs(w.std().item() - 0.2 * 0.8796) < 2e-3
    assert not torch.equal(n["b"], _params()["b"])


def test_orthogonal_noise_is_refused():
    with pytest.raises(ValueError, match="orthogonal"):
        W.WeightNoise(Init.Distribution(kind="orthogonal")).perturb(1, DENSE, _params())


def _net(noise, seed=3, n_in=6):
    conf = NeuralNetConfig(seed=seed, updater=U.Sgd(learning_rate=0.1)).list(
        L.DenseLayer(n_out=12, activation="tanh", weight_noise=noise),
        L.OutputLayer(n_out=3, loss="mcxent", weight_noise=noise),
        input_type=I.FeedForwardType(n_in))
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    return net


def _xy(n=16, n_in=6, seed=0):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(n, n_in).astype(np.float32)),
            torch.from_numpy(np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]))


def test_gradient_flows_through_the_perturbed_weights():
    """A DropConnect layer's gradient is the plain gradient at the perturbed
    weights, times the mask's scale: zero where a weight was dropped."""
    net = _net(W.DropConnect(0.5))
    plain = _net(None)
    x, y = _xy()
    seed = 99
    _, _, grads = net.compute_gradients(net.params, net.state, x, y, rng=seed)
    # the same draws, by hand: the layer seeds split as apply_layer splits them
    from deeplearning4j_tpu_torch.nn.layers.base import split_seed
    perturbed = []
    for i, (layer, p) in enumerate(zip(net.conf.layers, net.params)):
        rest = split_seed(split_seed(seed, 2)[i], 2)[1]
        noisy = layer.weight_noise.perturb(split_seed(rest, 2)[1], layer,
                                           {k: v.detach() for k, v in p.items()})
        perturbed.append(noisy)
    for p, q in zip(tree_leaves(plain.params), tree_leaves(perturbed)):
        p.data.copy_(q)
    _, _, g_plain = plain.compute_gradients(plain.params, plain.state, x, y)
    for i in range(2):
        mask = (perturbed[i]["W"] != 0).to(torch.float32) / 0.5
        torch.testing.assert_close(grads[i]["W"], g_plain[i]["W"] * mask, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(grads[i]["b"], g_plain[i]["b"], rtol=1e-5, atol=1e-7)
    assert bool((grads[0]["W"][perturbed[0]["W"] == 0] == 0).all())


def test_no_noise_in_eval_mode_or_without_a_seed():
    net, plain = _net(W.WeightNoise()), _net(None)
    x, y = _xy()
    torch.testing.assert_close(net.output(x), plain.output(x), rtol=0, atol=0)
    l1, _, g1 = net.compute_gradients(net.params, net.state, x, y)
    l0, _, g0 = plain.compute_gradients(plain.params, plain.state, x, y)
    assert float(l1) == float(l0)
    l2, _, _ = net.compute_gradients(net.params, net.state, x, y, rng=1)
    assert float(l2) != float(l0)


def test_frozen_layers_see_no_noise():
    net, plain = _net(W.DropConnect(0.5)), _net(None)
    layers = (net.conf.layers[0], plain.conf.layers[1])  # noise on the frozen layer only
    net = MultiLayerNetwork(dataclasses.replace(net.conf, layers=layers), device="cpu")
    net.init()
    net.frozen_layers = plain.frozen_layers = (0,)
    x, y = _xy()
    l1, _, _ = net.compute_gradients(net.params, net.state, x, y, rng=7)
    l0, _, _ = plain.compute_gradients(plain.params, plain.state, x, y, rng=7)
    assert float(l1) == float(l0)


def test_configs_round_trip_through_json_both_ways():
    jconf = JConf(seed=1).list(
        JL.DenseLayer(n_out=4, weight_noise=JW.WeightNoise(
            JInit.Distribution(kind="uniform", lower=-0.1, upper=0.1), additive=False)),
        JL.OutputLayer(n_out=2, weight_noise=JW.DropConnect(0.7, apply_to_bias=True)),
        input_type=JI.FeedForwardType(3))
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(conf.layers[0].weight_noise, W.WeightNoise)
    assert conf.layers[1].weight_noise == W.DropConnect(0.7, apply_to_bias=True)
    assert conf.to_json() == jconf.to_json()
    assert JConfiguration.from_json(conf.to_json()).to_json() == jconf.to_json()


@pytest.mark.parametrize("noise", ["weight_noise", "dropconnect"])
def test_switched_off_noise_matches_jax_in_float64(noise):
    """std 0 (additive) and retain 1.0 perturb nothing in either package:
    the steps from the same float64 weights agree to rtol 1e-9."""
    jn = (JW.WeightNoise(JInit.Distribution(kind="normal", std=0.0)) if noise == "weight_noise"
          else JW.DropConnect(1.0))
    tn = (W.WeightNoise(Init.Distribution(kind="normal", std=0.0)) if noise == "weight_noise"
          else W.DropConnect(1.0))
    jnet = JNet(JConf(seed=2, updater=JU.Sgd(learning_rate=0.0625)).list(
        JL.DenseLayer(n_out=12, activation="tanh", weight_noise=jn),
        JL.OutputLayer(n_out=3, loss="mcxent", weight_noise=jn),
        input_type=JI.FeedForwardType(6)))
    jnet.init()
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jnet.params)
    tnet = MultiLayerNetwork(NeuralNetConfig(seed=2, updater=U.Sgd(learning_rate=0.0625)).list(
        L.DenseLayer(n_out=12, activation="tanh", weight_noise=tn),
        L.OutputLayer(n_out=3, loss="mcxent", weight_noise=tn),
        input_type=I.FeedForwardType(6)), device="cpu")
    tnet.init(dtype=torch.float64)
    tser.params_from_numpy(tnet, [{k: np.asarray(v) for k, v in p.items()} for p in p64])
    x, y = (a.double() for a in _xy())
    jl, _, jg = jnet.compute_gradients(p64, jnet.state, jnp.asarray(x.numpy()),
                                       jnp.asarray(y.numpy()), rng=jax.random.PRNGKey(4))
    tl, _, tg = tnet.compute_gradients(tnet.params, tnet.state, x, y, rng=4)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


def _graph(noise):
    conf = (GraphBuilder(seed=4, updater=U.Adam(learning_rate=0.02)).add_inputs("in")
            .set_input_types(I.FeedForwardType(6))
            .add_layer("d", L.DenseLayer(n_out=12, activation="tanh", weight_noise=noise), "in")
            .add_layer("out", L.OutputLayer(n_out=3, loss="mcxent"), "d")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device="cpu")
    g.init()
    return g


def test_a_graph_applies_the_noise():
    """DL4J perturbs a graph layer's weights (the JAX package's graph does
    not read the field; ROADMAP queue 3 holds the divergence)."""
    x, y = _xy(24)
    a, b = _graph(W.DropConnect(0.6)), _graph(None)
    a.fit(x.numpy(), y.numpy(), batch_size=8)
    b.fit(x.numpy(), y.numpy(), batch_size=8)
    assert not torch.equal(a.params["d"]["W"], b.params["d"]["W"])


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_k4_draws_the_k1_noise(graph):
    x, y = _xy(40)
    noise = W.WeightNoise(Init.Distribution(kind="normal", std=0.05))
    make = (lambda: _graph(noise)) if graph else (lambda: _net(noise))
    a, b = make(), make()
    a.fit(x.numpy(), y.numpy(), epochs=2, batch_size=8, pad_ragged=True)
    b.fit(x.numpy(), y.numpy(), epochs=2, batch_size=8, steps_per_dispatch=4)
    for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6, rtol=0)
