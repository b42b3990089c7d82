"""Every genuine Keras config of the reference's test resources (the 34
JSONs KerasModelConfigurationTest loads: MLPs, CNNs in both dim orderings,
IMDB LSTMs with variable-length Embedding inputs, YOLO, functional
multi-loss models) through the port's importer, with the same layer
catalog as the JAX package's; a representative subset is built and run
forward on the CPU. The corpus is read in place from the reference tree
where it is present, behind the same guard as
``tests/test_keras_config_corpus.py``, whose helpers this module takes."""

import json
import os

import numpy as np
import pytest

import torch_native_guard  # noqa: E402

# before any test runs: the JAX package's native library, built without the race
torch_native_guard.heal_reference_native()

from test_keras_config_corpus import BASE, _all_configs

pytestmark = pytest.mark.skipif(
    not os.path.isdir(BASE), reason="reference tree with Keras config corpus not present")


def _version(path):
    return 1 if "/keras1/" in path else 2


def test_corpus_is_complete():
    assert len(_all_configs()) == 34


@pytest.mark.parametrize("path", _all_configs(),
                         ids=lambda p: "/".join(p.split("/")[-2:]) if isinstance(p, str) else p)
def test_config_parses_as_in_the_jax_package(path):
    from deeplearning4j_tpu.modelimport import keras as jk
    from deeplearning4j_tpu_torch.modelimport import keras as tk

    cfg = json.load(open(path))
    version = _version(path)
    cls, layers = tk._layer_list(cfg)
    if cls == "Sequential":
        ordering = tk._model_dim_ordering(layers, None, version)
        conf, _ = tk.import_keras_sequential_config(cfg, version, dim_ordering=ordering)
        jconf, _ = jk.import_keras_sequential_config(cfg, version, dim_ordering=ordering)
        assert conf.input_type is not None
        assert [type(l).__name__ for l in conf.layers] == \
            [type(l).__name__ for l in jconf.layers]
    else:
        graph, _ = tk.import_keras_model_config(cfg, version, device="cpu")
        jgraph, _ = jk.import_keras_model_config(cfg, version)
        assert graph.conf.outputs == tuple(jgraph.conf.outputs)
        assert graph.num_params() == jgraph.num_params()


@pytest.mark.parametrize("name,shape,out_shape", [
    ("keras1/imdb_lstm_tf_keras_1_config.json", "ids", (2, 1)),
    ("keras1/mnist_cnn_th_keras_1_config.json", (2, 28, 28, 1), (2, 10)),
    ("keras2/mnist_mlp_tf_keras_2_config.json", (2, 784), (2, 10)),
    # TimeDistributedDense keeps the time axis ([B, T, n_out])
    ("keras1/lstm_tddense_config.json", "seq", "BT-last"),
])
def test_config_builds_runnable_network(name, shape, out_shape):
    from deeplearning4j_tpu_torch.modelimport import keras as tk
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    path = os.path.join(BASE, name)
    cfg = json.load(open(path))
    version = _version(path)
    _, layers = tk._layer_list(cfg)
    conf, _ = tk.import_keras_sequential_config(
        cfg, version, dim_ordering=tk._model_dim_ordering(layers, None, version))
    net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    rs = np.random.RandomState(0)
    t = conf.input_type
    if shape == "ids":
        x = rs.randint(0, 100, (2, 12)).astype(np.float32)[..., None]
    elif shape == "seq":
        x = rs.rand(2, t.timesteps or 8, t.size).astype(np.float32)
    else:
        x = rs.rand(*shape).astype(np.float32)
    out = net.output(x).numpy()
    assert np.isfinite(out).all()
    if out_shape == "BT-last":
        n_out = max(getattr(l, "n_out", 0) for l in conf.layers[-2:])
        assert out.shape == (2, t.timesteps or 8, n_out), out.shape
    else:
        assert out.shape == out_shape, out.shape


def test_functional_multiloss_config_runs():
    """The genuine two-input, two-output functional config forwards on
    both heads."""
    from deeplearning4j_tpu_torch.modelimport.keras import import_keras_model_config

    cfg = json.load(open(os.path.join(BASE, "keras1/mlp_fapi_multiloss_config.json")))
    graph, _ = import_keras_model_config(cfg, 1, device="cpu")
    assert len(graph.conf.outputs) == 2
    rs = np.random.RandomState(0)
    feeds = {name: rs.rand(3, graph._types[name].size).astype(np.float32)
             for name in graph.conf.inputs}
    assert len(feeds) == 2
    out = graph.output(feeds)
    assert set(out) == set(graph.conf.outputs)
    for head, arr in out.items():
        assert np.isfinite(arr.numpy()).all(), head
