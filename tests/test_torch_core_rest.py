"""The rest of the training core against the JAX package: the repaired
faults (``MultiLayerNetwork.feed_forward``, the ``nn/conf/inputs.py``
helpers and the ``nn/conf`` re-exports, NaN rows for embedding ids
outside the vocabulary), the EmbeddingLayer, TimeDistributedDenseLayer
and AutoEncoder layers (config serde, forward, gradients, the
autoencoder's pretrain loss with the same corruption mask),
``memory_report``, ``utils/gradcheck.py``, ``utils/quantization.py``,
``utils/timeseries.py`` and ``nn/simple.py``.

Tolerances: float64 comparisons (the JAX tests run x64) at rtol 1e-10,
atol 1e-12; parameters after an SGD step rtol 1e-7 (the port's learning
rate is a float32 scalar, the JAX package's float64); float32 network
outputs at atol 1e-5 (the reference's f32 forward tolerance,
tests/test_ops.py); the time-series helpers rtol 1e-6 (moving_average
is float32 in both); integer and shape results exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf.memory import memory_report as j_memory_report
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils import gradcheck as jgc
from deeplearning4j_tpu.utils import quantization as jq
from deeplearning4j_tpu.utils import timeseries as jts
from deeplearning4j_tpu_torch.models.lenet import lenet as t_lenet
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import simple as tsimple
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf.memory import memory_report
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TMLC
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TConf
from deeplearning4j_tpu_torch.nn.layers.core import take_rows
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.utils import gradcheck as tgc
from deeplearning4j_tpu_torch.utils import quantization as tq
from deeplearning4j_tpu_torch.utils import timeseries as tts
from deeplearning4j_tpu_torch.utils.serialization import params_from_numpy

F64 = dict(rtol=1e-10, atol=1e-12)


def _np(t):
    return t.detach().double().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)


def _pair(layers_j, layers_t, input_j, input_t, dtype=torch.float64, seed=1, updater=None):
    """The same network in both packages, the port holding the JAX weights."""
    jconf = JConf(seed=seed, updater=updater or JU.Sgd(0.1)).list(*layers_j, input_type=input_j)
    jnet = JNet(jconf)
    jnet.init(dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    tnet = TNet(TMLC.from_json(jconf.to_json()), device="cpu")
    tnet.init(dtype=dtype)
    params_from_numpy(tnet, jax.tree_util.tree_map(np.asarray, jnet.params),
                      state=jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


# ---------------------------------------------------------------------------
# the repaired faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_feed_forward_matches_jax(train):
    """Every layer's activation, the adapters between families applied and
    BatchNormalization's state threaded, as JAX ``feed_forward``."""
    def layers(L):
        return [L.ConvolutionLayer(n_out=3, kernel=(3, 3), activation="relu"),
                L.BatchNormalization(),
                L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
                L.DenseLayer(n_out=5, activation="tanh"),
                L.OutputLayer(n_out=2)]
    jnet, tnet = _pair(layers(JL), layers(TL), JI.ConvolutionalType(8, 8, 2),
                       TI.ConvolutionalType(8, 8, 2))
    x = np.random.RandomState(0).rand(3, 8, 8, 2)
    got, want = tnet.feed_forward(x, train=train), jnet.feed_forward(x, train=train)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), np.asarray(w), **F64)


def test_input_helpers_match_jax():
    assert TI.feed_forward(7) == TI.FeedForwardType(7)
    assert TI.recurrent(4, 9) == TI.RecurrentType(4, 9) and TI.recurrent(4).timesteps is None
    assert TI.convolutional(5, 6, 3).flat_size == 90
    for t_t, j_t in ((TI.feed_forward(7), JI.feed_forward(7)),
                     (TI.recurrent(4, 9), JI.recurrent(4, 9)),
                     (TI.convolutional(5, 6, 3), JI.convolutional(5, 6, 3))):
        assert t_t.shape(2) == j_t.shape(2) and type(t_t).__name__ == type(j_t).__name__
    rs = np.random.RandomState(1)
    cases = [("feed_forward_to_cnn", rs.rand(2, 24), (2, 4, 3)),
             ("feed_forward_to_rnn", rs.rand(6, 5), (3,)),
             ("cnn_to_rnn", rs.rand(2, 3, 4, 5), ()),
             ("rnn_to_cnn", rs.rand(2, 6, 4), (3, 2, 4)),
             ("cnn_to_feed_forward", rs.rand(2, 3, 4, 5), ()),
             ("rnn_to_feed_forward", rs.rand(2, 3, 4), ())]
    for name, x, args in cases:
        got = getattr(TI, name)(torch.from_numpy(x), *args)
        want = getattr(JI, name)(jnp.asarray(x), *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="explicit target dims"):
        TI.adapt(torch.zeros(2, 4), TI.FeedForwardType(4), TI.ConvolutionalType)


def test_nn_conf_reexports_what_jax_does():
    import deeplearning4j_tpu.nn.conf as jconf
    import deeplearning4j_tpu_torch.nn.conf as tconf

    for name in ("InputType", "FeedForwardType", "RecurrentType", "ConvolutionalType"):
        assert getattr(tconf, name) is getattr(TI, name)
        assert hasattr(jconf, name)


def test_take_rows_matches_jnp_take():
    w = np.random.RandomState(2).rand(3, 4)
    ids = np.array([[0, 5, -1], [-2, -3, -4], [3, 2, 1]])
    got = take_rows(torch.from_numpy(w), torch.from_numpy(ids))
    want = jnp.take(jnp.asarray(w), jnp.asarray(ids), axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # NaN rows in place


@pytest.mark.parametrize("kind", ["embedding", "sequence"])
def test_embedding_ids_outside_the_vocabulary_give_jax_rows(kind):
    """An id at or past n_in (or below -n_in) gives a NaN row, -1 the last
    row; no IndexError (a device assert on a card), and the gradient
    reaches only the valid rows, as ``jnp.take``'s."""
    n_in = 4
    if kind == "embedding":
        jl, tl = JL.EmbeddingLayer(n_in=n_in, n_out=3), TL.EmbeddingLayer(n_in=n_in, n_out=3)
        x = np.array([[0.0], [4.0], [-1.0], [7.0], [2.0]])
        it = JI.FeedForwardType(1)
    else:
        jl = JL.EmbeddingSequenceLayer(n_in=n_in, n_out=3)
        tl = TL.EmbeddingSequenceLayer(n_in=n_in, n_out=3)
        x = np.array([[0.0, 4.0, -1.0], [9.0, 2.0, -5.0]])
        it = JI.RecurrentType(1, 3)
    p = jl.init(jax.random.PRNGKey(0), it, dtype=jnp.float64)
    want, _ = jl.apply(p, {}, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p.items()}
    got, _ = tl.apply(tp, {}, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert np.isnan(_np(got)).any()
    jg = jax.grad(lambda q: jnp.sum(jnp.nan_to_num(jl.apply(q, {}, jnp.asarray(x))[0]) ** 2))(p)
    (tg,) = torch.autograd.grad((torch.nan_to_num(got) ** 2).sum(), [tp["W"]])
    np.testing.assert_allclose(_np(tg), np.asarray(jg["W"]), **F64)


# ---------------------------------------------------------------------------
# EmbeddingLayer, TimeDistributedDenseLayer, AutoEncoder
# ---------------------------------------------------------------------------

def _three_layers(L, I):
    return [
        (L.EmbeddingLayer(n_in=6, n_out=4, has_bias=True, activation="tanh"),
         I.FeedForwardType(1), "ids"),
        (L.TimeDistributedDenseLayer(n_out=3, activation="sigmoid"), I.RecurrentType(5, 4), "seq"),
        (L.AutoEncoder(n_out=3, corruption_level=0.3), I.FeedForwardType(5), "dense"),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_layer_config_serde_loads_jax_json(which):
    from deeplearning4j_tpu.utils import serde as jserde
    from deeplearning4j_tpu_torch.utils import serde as tserde

    jl, _, _ = _three_layers(JL, JI)[which]
    tl, _, _ = _three_layers(TL, TI)[which]
    assert tserde.to_json(tl) == jserde.to_json(jl)
    assert tserde.from_json(jserde.to_json(jl)) == tl


@pytest.mark.parametrize("which", [0, 1, 2])
def test_layer_forward_and_gradients_match_jax(which):
    jl, jt, kind = _three_layers(JL, JI)[which]
    tl, tt, _ = _three_layers(TL, TI)[which]
    rs = np.random.RandomState(3 + which)
    x = {"ids": rs.randint(0, 6, (5, 1)).astype(np.float64), "seq": rs.randn(2, 4, 5),
         "dense": rs.rand(5, 5)}[kind]
    p = jl.init(jax.random.PRNGKey(which), jt, dtype=jnp.float64)
    assert set(p) == set(tl.init(torch.Generator().manual_seed(0), tt, torch.float64))
    want, _ = jl.apply(p, {}, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p.items()}
    got, _ = tl.apply(tp, {}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F64)
    assert tl.output_type(tt) == TI.__dict__[type(jl.output_type(jt)).__name__](
        **dataclasses.asdict(jl.output_type(jt)))
    jg = jax.grad(lambda q: jnp.sum(jnp.sin(jl.apply(q, {}, jnp.asarray(x))[0])))(p)
    keys = sorted(tp)
    tg = torch.autograd.grad(torch.sin(got).sum(), [tp[k] for k in keys], allow_unused=True)
    for k, g in zip(keys, tg):
        want_g = np.asarray(jg[k])
        np.testing.assert_allclose(np.zeros_like(want_g) if g is None else _np(g), want_g,
                                   err_msg=k, **F64)


def test_autoencoder_pretrain_loss_matches_jax_with_the_same_mask():
    jl = JL.AutoEncoder(n_out=3, corruption_level=0.4)
    tl = TL.AutoEncoder(n_out=3, corruption_level=0.4)
    x = np.random.RandomState(6).rand(6, 5)
    p = jl.init(jax.random.PRNGKey(1), JI.FeedForwardType(5), dtype=jnp.float64)
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - 0.4, x.shape))  # JAX's own draw
    want, jg = jax.value_and_grad(lambda q: jl.pretrain_loss(q, jnp.asarray(x), key))(p)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p.items()}
    got = tl.pretrain_loss(tp, torch.from_numpy(x), keep=torch.from_numpy(np.array(keep)))
    np.testing.assert_allclose(got.item(), float(want), **F64)
    tg = torch.autograd.grad(got, [tp[k] for k in sorted(tp)])
    for k, g in zip(sorted(tp), tg):
        np.testing.assert_allclose(_np(g), np.asarray(jg[k]), err_msg=k, **F64)
    np.testing.assert_allclose(_np(tl.reconstruct(tp, torch.from_numpy(x))),
                               np.asarray(jl.reconstruct(p, jnp.asarray(x))), **F64)
    # the port's own draw: a generator's mask keeps about 1 - corruption
    g = torch.Generator().manual_seed(0)
    mask = tl.corruption_mask(torch.zeros(200, 50, dtype=torch.float64), g)
    assert abs(mask.double().mean().item() - 0.6) < 0.01
    assert torch.isfinite(tl.pretrain_loss(tp, torch.from_numpy(x), g))


def test_layers_train_inside_a_network_as_jax():
    """EmbeddingLayer -> Dense -> Output: one fit step from the same
    weights agrees with the JAX package's."""
    def layers(L):
        return [L.EmbeddingLayer(n_in=7, n_out=4), L.DenseLayer(n_out=5, activation="tanh"),
                L.OutputLayer(n_out=3)]
    jnet, tnet = _pair(layers(JL), layers(TL), JI.FeedForwardType(1), TI.FeedForwardType(1))
    rs = np.random.RandomState(8)
    x = rs.randint(0, 7, (6, 1)).astype(np.float64)
    y = np.eye(3)[rs.randint(0, 3, 6)]
    jnet.fit(x, y)
    tnet.fit(x, y)
    for jp, tp in zip(jnet.params, tnet.params):
        for k in jp:
            # the port's learning rate is a float32 scalar, the JAX package's float64
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), err_msg=k, rtol=1e-7)


# ---------------------------------------------------------------------------
# memory_report
# ---------------------------------------------------------------------------

def _mem_conf(pkg, updater):
    L, I, Conf = (JL, JI, JConf) if pkg == "jax" else (TL, TI, TConf)
    return Conf(seed=1, updater=updater).list(
        L.ConvolutionLayer(n_out=4, kernel=(3, 3), padding="same"),
        L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)),
        L.DenseLayer(n_out=6),
        L.AutoEncoder(n_out=5),
        L.OutputLayer(n_out=3),
        input_type=I.convolutional(8, 8, 1))


@pytest.mark.parametrize("name", ["Sgd", "Nesterovs", "Adam", "AdaMax", "AmsGrad", "Nadam",
                                  "AdaGrad", "AdaDelta", "RmsProp", "NoOp"])
def test_memory_report_matches_jax(name):
    """Counts, bytes and the step estimates equal the JAX package's for
    every updater: the port's updater state holds the same tensors (a
    moment or two a parameter, no step counter)."""
    t = memory_report(_mem_conf("torch", getattr(TU, name)()), model_name="m")
    j = j_memory_report(_mem_conf("jax", getattr(JU, name)()), model_name="m")
    assert t.to_json() == j.to_json()
    for b in (1, 32):
        for training in (True, False):
            assert t.total_memory_bytes(b, training=training) == \
                j.total_memory_bytes(b, training=training)
    assert t.summary(8) == j.summary(8)


def test_memory_report_of_lenet_allocates_nothing():
    from deeplearning4j_tpu.models import lenet as j_lenet

    t = memory_report(t_lenet(), dtype=torch.bfloat16)
    j = j_memory_report(j_lenet(), dtype=jnp.bfloat16)
    assert t.to_json() == j.to_json()
    assert memory_report(t_lenet()).total_param_count == 431_080
    assert t.total_param_bytes * 2 == memory_report(t_lenet()).total_param_bytes


# ---------------------------------------------------------------------------
# gradcheck
# ---------------------------------------------------------------------------

def test_gradcheck_matches_jax_and_finds_a_wrong_gradient():
    rs = np.random.RandomState(9)
    x = rs.rand(3, 4)
    w = {"W": rs.randn(4, 3), "b": rs.randn(3), "nested": {"a": rs.randn(2)}}

    def j_loss(p):
        return (jnp.sum(jnp.tanh(jnp.asarray(x) @ p["W"] + p["b"]) ** 2)
                + jnp.sum(p["nested"]["a"] ** 3))

    def t_loss(p):
        return (torch.tanh(torch.from_numpy(x) @ p["W"] + p["b"]) ** 2).sum() + \
            (p["nested"]["a"] ** 3).sum()

    tw = {"W": torch.from_numpy(w["W"]), "b": torch.from_numpy(w["b"]),
          "nested": {"a": torch.from_numpy(w["nested"]["a"])}}
    ok, failures = tgc.check_gradients(t_loss, tw, max_params_per_leaf=5)
    j_ok, j_failures = jgc.check_gradients(j_loss, jax.tree_util.tree_map(jnp.asarray, w),
                                           max_params_per_leaf=5)
    assert ok and j_ok and failures == j_failures == []

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            ctx.save_for_backward(a)
            return a ** 2

        @staticmethod
        def backward(ctx, g):
            (a,) = ctx.saved_tensors
            return g * 3 * a  # should be 2a

    ok, failures = tgc.check_gradients(lambda p: Wrong.apply(p["v"]).sum(),
                                       {"v": torch.tensor([1.0, -2.0], dtype=torch.float64)})
    assert not ok and [f["param"] for f in failures] == ["['v']", "['v']"]


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_quantize_params_match_jax():
    rs = np.random.RandomState(10)
    params = [{"W": rs.randn(5, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)},
              {"mha": {"Wqkv": rs.randn(4, 12).astype(np.float32)},
               "expert_W1": rs.randn(3, 4, 6).astype(np.float32),
               "W": np.zeros((2, 2, 3, 4), np.float32)}]   # an all-zero conv weight
    tparams = [{k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
                    else torch.from_numpy(v)) for k, v in d.items()} for d in params]
    tqp, tsc = tq.quantize_params(tparams)
    jqp, jsc = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, params))
    flat_t = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), (tqp, tsc), is_leaf=torch.is_tensor))
    flat_j = [np.asarray(a) for a in jax.tree_util.tree_leaves((jqp, jsc))]
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tsc[1]["expert_W1"].shape == (3, 1, 6) and tsc[0]["b"] is None
    assert tq.weight_bytes(tparams) == jq.weight_bytes(jax.tree_util.tree_map(jnp.asarray, params))
    assert tq.weight_bytes(tqp) * 4 == tq.weight_bytes(tparams)
    deq = tq.dequantize_params(tqp, tsc, torch.float32)
    jdeq = jq.dequantize_params(jqp, jsc, jnp.float32)
    np.testing.assert_array_equal(deq[1]["mha"]["Wqkv"].numpy(), np.asarray(jdeq[1]["mha"]["Wqkv"]))


def test_quantized_inference_matches_jax_on_both_network_kinds():
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.nn.graph import GraphConfiguration as TGC

    def layers(L):
        return [L.ConvolutionLayer(n_out=3, kernel=(3, 3), activation="relu"),
                L.DenseLayer(n_out=6, activation="relu"), L.OutputLayer(n_out=4)]
    jnet, tnet = _pair(layers(JL), layers(TL), JI.ConvolutionalType(6, 6, 1),
                       TI.ConvolutionalType(6, 6, 1), dtype=torch.float32)
    x = np.random.RandomState(11).rand(5, 6, 6, 1).astype(np.float32)
    got = tq.QuantizedInference(tnet).output(x)
    want = jq.QuantizedInference(jnet).output(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert (got.argmax(-1).numpy() == tnet.output(x).argmax(-1).numpy()).all()
    g = JGB(seed=3)
    g.add_inputs("in")
    g.set_input_types(JI.FeedForwardType(5))
    g.add_layer("h", JL.DenseLayer(n_out=7, activation="tanh"), "in")
    g.add_layer("out", JL.OutputLayer(n_out=2), "h")
    g.set_outputs("out")
    jg = JGraph(g.build())
    jg.init()
    tg = TGraph(TGC.from_json(jg.conf.to_json()), device="cpu")
    tg.init()
    params_from_numpy(tg, jax.tree_util.tree_map(np.asarray, jg.params))
    xg = np.random.RandomState(12).rand(4, 5).astype(np.float32)
    np.testing.assert_allclose(tq.QuantizedInference(tg).output(xg).numpy(),
                               np.asarray(jq.QuantizedInference(jg).output(xg)), atol=1e-5)
    np.testing.assert_allclose(tq.QuantizedInference(tg).output({"in": xg}).numpy(),
                               np.asarray(jq.QuantizedInference(jg).output({"in": xg})),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# timeseries and simple
# ---------------------------------------------------------------------------

def test_timeseries_helpers_match_jax():
    rs = np.random.RandomState(13)
    x = rs.randn(3, 5, 2)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float64)
    img = rs.randn(2, 3, 3, 2)
    img_mask = (rs.rand(2, 3, 3) > 0.4).astype(np.float64)
    series = rs.rand(2, 7)
    pairs = [
        (tts.moving_average(series, 3), jts.moving_average(series, 3)),
        (tts.reshape_3d_to_2d(x), jts.reshape_3d_to_2d(x)),
        (tts.reshape_2d_to_3d(x.reshape(15, 2), 3), jts.reshape_2d_to_3d(x.reshape(15, 2), 3)),
        (tts.reshape_time_series_mask_to_vector(mask),
         jts.reshape_time_series_mask_to_vector(mask)),
        (tts.reshape_vector_to_time_series_mask(mask.ravel(), 3),
         jts.reshape_vector_to_time_series_mask(mask.ravel(), 3)),
        (tts.pull_last_time_step(x), jts.pull_last_time_step(x)),
        (tts.pull_last_time_step(x, mask), jts.pull_last_time_step(x, mask)),
        (tts.reverse_time_series(x), jts.reverse_time_series(x)),
        (tts.reverse_time_series(x, mask), jts.reverse_time_series(x, mask)),
    ]
    for kind in ("max", "sum", "avg", "pnorm"):
        pairs.append((tts.masked_pooling_time_series(kind, -np.abs(x), mask),
                      jts.masked_pooling_time_series(kind, -np.abs(x), mask)))
        pairs.append((tts.masked_pooling_convolution(kind, img, img_mask),
                      jts.masked_pooling_convolution(kind, img, img_mask)))
    for i, (got, want) in enumerate(pairs):
        assert tuple(got.shape) == tuple(np.shape(want)), i
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), rtol=1e-6, atol=1e-7,
                                   err_msg=str(i))
    with pytest.raises(ValueError, match="Unknown pooling type"):
        tts.masked_pooling_time_series("median", x, mask)


def test_simple_results_match_jax():
    from deeplearning4j_tpu.nn import simple as jsimple

    out = np.array([[0.1, 0.7, 0.2], [0.5, 0.25, 0.25]], np.float32)
    for o in (out, torch.from_numpy(out)):
        t = tsimple.RankClassificationResult(o, labels=["a", "b", "c"])
        j = jsimple.RankClassificationResult(out, labels=["a", "b", "c"])
        assert t.max_labels() == j.max_labels() == ["b", "a"]
        assert t.ranked_labels(1) == j.ranked_labels(1)
        assert t.probability_for_label(0, "c") == j.probability_for_label(0, "c")
    b, jb = tsimple.BinaryClassificationResult(0.6), jsimple.BinaryClassificationResult(0.6)
    assert b.is_positive == jb.is_positive and repr(b) == repr(jb)
