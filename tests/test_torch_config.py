"""Config JSON, activations, initializers and dtype policy: the port against
the JAX package.

A ``config.json`` written by either package must load in the other and
re-serialise to the same bytes.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.misc import text_generation_lstm as j_charnn
from deeplearning4j_tpu.nn import activations as JA
from deeplearning4j_tpu.nn import initializers as JI
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf import inputs as JIn
from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JNetConf
from deeplearning4j_tpu_torch.models import get_model
from deeplearning4j_tpu_torch.models.misc import text_generation_lstm as t_charnn
from deeplearning4j_tpu_torch.nn import activations as TA
from deeplearning4j_tpu_torch.nn import initializers as TI
from deeplearning4j_tpu_torch.nn import layers as TL
from deeplearning4j_tpu_torch.nn import updaters as TU
from deeplearning4j_tpu_torch.nn.conf import inputs as TIn
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration as TConf
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig as TNetConf
from deeplearning4j_tpu_torch.utils import dtypes as TD


@pytest.mark.parametrize("kwargs", [
    {"vocab_size": 96, "hidden": 512, "seq_len": 128},
    {"vocab_size": 11, "hidden": 32, "seq_len": 8},
    {"vocab_size": 50},
])
def test_charnn_config_round_trips_both_ways(kwargs):
    j_json = j_charnn(**kwargs).to_json()
    t_conf = TConf.from_json(j_json)
    assert t_conf.to_json() == j_json
    assert json.loads(t_conf.to_json()) == json.loads(j_json)
    assert t_charnn(**kwargs).to_json() == j_json
    assert get_model("textgenlstm").builder(**kwargs).to_json() == j_json
    assert JConf.from_json(t_charnn(**kwargs).to_json()).to_json() == j_json


def _dense_confs(jmod, umod, net_config, inputs):
    return net_config(seed=7, activation="relu", weight_init="xavier_uniform", l2=1e-4,
                      updater=umod.Adam(learning_rate=umod.StepSchedule(0.01, 0.5, 10))).list(
        jmod.DenseLayer(n_out=16, dropout=0.1),
        jmod.DenseLayer(n_out=8, activation="tanh", has_bias=False),
        jmod.OutputLayer(n_out=3, loss="mcxent"),
        input_type=inputs.FeedForwardType(5))


def test_dense_config_with_cascaded_defaults_round_trips():
    j_json = _dense_confs(JL, JU, JNetConf, JIn).to_json()
    t_json = _dense_confs(TL, TU, TNetConf, TIn).to_json()
    assert t_json == j_json
    assert TConf.from_json(j_json).to_json() == j_json


_SCHEDULES = ["FixedSchedule", "ExponentialSchedule", "InverseSchedule", "PolySchedule",
              "SigmoidSchedule", "StepSchedule", "WarmupCosineSchedule"]
_UPDATERS = ["Sgd", "Nesterovs", "Adam", "AdaMax", "Nadam", "AdaGrad", "AdaDelta",
             "RmsProp", "AmsGrad", "NoOp"]


@pytest.mark.parametrize("name", _UPDATERS)
def test_updater_configs_round_trip(name):
    cls = getattr(JU, name)
    kwargs = {}
    if "learning_rate" in cls.__dataclass_fields__:
        kwargs["learning_rate"] = JU.ExponentialSchedule(0.05, 0.9)
    j_json = JNetConf(updater=cls(**kwargs)).list(
        JL.DenseLayer(n_out=2), input_type=JIn.FeedForwardType(3)).to_json()
    t_conf = TConf.from_json(j_json)
    assert type(t_conf.updater) is getattr(TU, name)
    assert t_conf.to_json() == j_json


@pytest.mark.parametrize("name", _SCHEDULES)
def test_schedule_configs_round_trip(name):
    jcls, tcls = getattr(JU, name), getattr(TU, name)
    assert [f.name for f in jcls.__dataclass_fields__.values()] == \
        [f.name for f in tcls.__dataclass_fields__.values()]
    j_json = JNetConf(updater=JU.Sgd(learning_rate=jcls())).list(
        JL.DenseLayer(n_out=2), input_type=JIn.FeedForwardType(3)).to_json()
    assert TConf.from_json(j_json).to_json() == j_json


def test_unported_type_raises_a_clear_error():
    # the mixture-of-experts block waits for ROADMAP queue 1 item 5
    conf = JNetConf().list(JL.MoETransformerBlock(n_out=8, n_heads=2),
                           JL.RnnOutputLayer(n_out=2),
                           input_type=JIn.RecurrentType(8, 4))
    with pytest.raises(KeyError, match="not ported"):
        TConf.from_json(conf.to_json())


def _rest_of_core_conf(L, I, NetConf, U):
    return NetConf(seed=4, updater=U.RmsProp(learning_rate=1e-3)).list(
        L.EmbeddingLayer(n_in=10, n_out=6, has_bias=True),
        L.AutoEncoder(n_out=5, corruption_level=0.2),
        L.VariationalAutoencoder(
            n_latent=3, encoder_layer_sizes=(8, 8), decoder_layer_sizes=(8,),
            reconstruction=L.CompositeReconstruction(parts=(
                (2, L.GaussianReconstruction()), (3, L.BernoulliReconstruction()))),
            activation="leakyrelu"),
        L.OutputLayer(n_out=2),
        input_type=I.FeedForwardType(1))


def test_rest_of_core_configs_round_trip_both_ways():
    """EmbeddingLayer, AutoEncoder and the VAE with a composite
    distribution: the JAX package's JSON loads in the port and re-serialises
    to the same bytes, and the port's loads in the JAX package."""
    j_json = _rest_of_core_conf(JL, JIn, JNetConf, JU).to_json()
    t_json = _rest_of_core_conf(TL, TIn, TNetConf, TU).to_json()
    assert t_json == j_json
    assert TConf.from_json(j_json).to_json() == j_json
    assert JConf.from_json(t_json).to_json() == j_json
    td = TConf.from_json(TConf.from_json(j_json).to_json())
    assert [type(l).__name__ for l in td.layers] == [
        "EmbeddingLayer", "AutoEncoder", "VariationalAutoencoder", "OutputLayer"]
    seq = JNetConf().list(JL.TimeDistributedDenseLayer(n_out=3), JL.RnnOutputLayer(n_out=2),
                          input_type=JIn.RecurrentType(4, 5)).to_json()
    assert TConf.from_json(seq).to_json() == seq


def test_layer_input_types_match_jax():
    j_types, j_out = j_charnn(11, hidden=32, seq_len=8).layer_input_types()
    t_types, t_out = t_charnn(11, hidden=32, seq_len=8).layer_input_types()
    assert [t.shape(2) for t in t_types] == [t.shape(2) for t in j_types]
    assert t_out.shape(2) == j_out.shape(2) == (2, 8, 11)


@pytest.mark.parametrize("name", sorted(JA._CATALOG))
def test_activation_matches_jax(name):
    assert sorted(TA._CATALOG) == sorted(JA._CATALOG)
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(2, 12)
    want = np.asarray(JA.get(name)(jnp.asarray(x)))
    got = TA.get(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_activation_with_bound_kwargs():
    x = np.linspace(-3, 3, 12, dtype=np.float32)
    want = np.asarray(JA.get(("leakyrelu", {"alpha": 0.3}))(jnp.asarray(x)))
    got = TA.get(("leakyrelu", {"alpha": 0.3}))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", JI.names())
def test_initializer_catalog_matches_jax(name):
    assert TI.names() == JI.names()
    g = torch.Generator().manual_seed(0)
    w = TI.init_weight(name, g, (64, 64), 64, 64)
    assert w.shape == (64, 64) and w.dtype == torch.float32
    assert torch.isfinite(w).all()
    import jax
    j = np.asarray(JI.init_weight(name, jax.random.PRNGKey(0), (64, 64), 64, 64, jnp.float32))
    # same distribution: compare spread (the two generators give other bits)
    np.testing.assert_allclose(float(w.std()), float(j.std()), rtol=0.15, atol=1e-6)
    np.testing.assert_allclose(float(w.mean()), float(j.mean()), atol=0.05)


def test_initializer_draws_from_the_given_generator():
    a = TI.init_weight("xavier", torch.Generator().manual_seed(3), (4, 4), 4, 4)
    b = TI.init_weight("xavier", torch.Generator().manual_seed(3), (4, 4), 4, 4)
    c = TI.init_weight("xavier", torch.Generator().manual_seed(4), (4, 4), 4, 4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dtype_policy_default_and_bf16():
    try:
        assert TD.get_policy() == TD.DtypePolicy(torch.float32, torch.float32, torch.float32)
        pol = TD.bf16_policy()
        assert (pol.param_dtype, pol.compute_dtype, pol.accum_dtype) == \
            (torch.float32, torch.bfloat16, torch.float32)
        assert TD.compute_dtypes_for(torch.float32) == (torch.bfloat16, torch.float32)
        assert TD.compute_dtypes_for(torch.float64) == (torch.float64, torch.float64)
    finally:
        TD.f32_policy()
    assert TD.get_policy().compute_dtype == torch.float32
