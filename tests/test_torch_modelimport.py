"""The port's Keras HDF5 import against the JAX package's (reference:
deeplearning4j-modelimport, KerasModelImport.java). Each file is written
with the port's ``Hdf5Archive`` in the layout Keras 2's ``model.save()``
produces (root attributes ``model_config``/``keras_version``/``backend``,
a ``model_weights`` group with ``layer_names``/``weight_names`` string
arrays, nested weight datasets), then imported by both packages: the
parameters and layer state must be equal (numpy, exactly) and the outputs
within f32 rounding (rtol 1e-5, atol 1e-6). Where the JAX test has a numpy
forward of the raw datasets, the port is held to it as well.

The Keras LSTM runs the port's ``lstm_seq`` sequence op only with sigmoid
gates and tanh (``nn/layers/rnn.py _sequence_op``): Keras's default
``hard_sigmoid`` gates take the per-step path in both packages, which is
correct and pinned here.
"""

import json

import numpy as np
import pytest
import torch

import torch_native_guard  # noqa: E402

# before any test runs: the JAX package's native library, built without the race
torch_native_guard.heal_reference_native()

from deeplearning4j_tpu import modelimport as jmi
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch import modelimport as tmi
from deeplearning4j_tpu_torch.models import zoo as tzoo

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _needs_libhdf5():
    if not native.h5_available():
        pytest.skip("system libhdf5 absent")


def _write_keras_file(path, model_config, layer_weights, training_config=None,
                      keras_version="2.3.1", backend="tensorflow"):
    """layer_weights: {layer_name: [(weight_name, array), ...]}"""
    from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

    with Hdf5Archive(str(path), "w") as f:
        f.write_attr_string("model_config", json.dumps(model_config))
        f.write_attr_string("keras_version", keras_version)
        f.write_attr_string("backend", backend)
        if training_config is not None:
            f.write_attr_string("training_config", json.dumps(training_config))
        f.make_group("model_weights")
        f.write_attr_strings("layer_names", list(layer_weights), "model_weights")
        for lname, weights in layer_weights.items():
            f.make_group(f"model_weights/{lname}")
            f.write_attr_strings("weight_names", [wn for wn, _ in weights],
                                 f"model_weights/{lname}")
            for wn, arr in weights:
                f.write_dataset(f"model_weights/{lname}/{wn}", arr)


def _seq_config(layers):
    return {"class_name": "Sequential", "config": {"name": "sequential", "layers": layers}}


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _np(out):
    if isinstance(out, dict):
        out = next(iter(out.values()))
    return out.detach().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)


def _both(path):
    """The Sequential file imported by the port (on the CPU) and by the JAX
    package."""
    return (tmi.import_keras_sequential_model_and_weights(str(path), device="cpu"),
            jmi.import_keras_sequential_model_and_weights(str(path)))


def _assert_same(mine, theirs, x):
    """Same layer catalog, params and state (exactly); outputs within f32
    rounding. Returns the port's output."""
    if hasattr(mine.conf, "layers"):
        assert [type(l).__name__ for l in mine.conf.layers] == \
            [type(l).__name__ for l in theirs.conf.layers]
    for what in ("params", "state"):
        a, b = getattr(mine, what), getattr(theirs, what)
        keys = range(len(a)) if isinstance(a, list) else list(a)
        assert (len(a) == len(b)) if isinstance(a, list) else (set(a) == set(b))
        for i in keys:
            assert set(a[i]) == set(b[i]), (what, i)
            for k in a[i]:
                np.testing.assert_array_equal(_np(a[i][k]),
                                              np.asarray(b[i][k]).astype(np.float32),
                                              err_msg=f"{what}[{i}][{k}]")
    got = _np(mine.output(x))
    np.testing.assert_allclose(got, _np(theirs.output(x)), rtol=RTOL, atol=ATOL)
    return got


def keras_lstm_forward(x, kernel, rec, bias, gate):
    """Keras's LSTM in numpy: gates [i, f, c, o] along the last axis of
    kernel/recurrent_kernel/bias; returns every step's h, [B, T, H]."""
    b, t, _ = x.shape
    h = np.zeros((b, rec.shape[0]))
    c = np.zeros_like(h)
    outs = []
    for s in range(t):
        z = x[:, s] @ kernel + h @ rec + bias
        i, f, g, o = np.split(z, 4, axis=-1)
        c = gate(f) * c + gate(i) * np.tanh(g)
        h = gate(o) * np.tanh(c)
        outs.append(h)
    return np.stack(outs, axis=1)


class TestSequentialImport:
    def test_mlp_predictions_match_numpy(self, tmp_path):
        rs = np.random.RandomState(0)
        w1, b1 = rs.randn(8, 16).astype(np.float32), rs.randn(16).astype(np.float32)
        w2, b2 = rs.randn(16, 3).astype(np.float32), rs.randn(3).astype(np.float32)
        cfg = _seq_config([
            {"class_name": "Dense", "config": {"name": "dense_1", "units": 16,
                                               "activation": "relu", "use_bias": True,
                                               "batch_input_shape": [None, 8]}},
            {"class_name": "Dense", "config": {"name": "dense_2", "units": 3,
                                               "activation": "softmax", "use_bias": True}}])
        p = tmp_path / "mlp.h5"
        _write_keras_file(p, cfg, {"dense_1": [("dense_1/kernel:0", w1), ("dense_1/bias:0", b1)],
                                   "dense_2": [("dense_2/kernel:0", w2), ("dense_2/bias:0", b2)]})
        x = rs.randn(5, 8).astype(np.float32)
        got = _assert_same(*_both(p), x)
        np.testing.assert_allclose(got, _softmax(np.maximum(x @ w1 + b1, 0) @ w2 + b2),
                                   rtol=1e-4, atol=1e-5)

    def test_cnn_import(self, tmp_path):
        rs = np.random.RandomState(1)
        k = rs.randn(3, 3, 1, 4).astype(np.float32) * 0.1
        w = rs.randn(13 * 13 * 4, 2).astype(np.float32) * 0.1
        cfg = _seq_config([
            {"class_name": "Conv2D", "config": {
                "name": "conv", "filters": 4, "kernel_size": [3, 3], "strides": [1, 1],
                "padding": "valid", "activation": "relu", "use_bias": True,
                "data_format": "channels_last", "batch_input_shape": [None, 28, 28, 1]}},
            {"class_name": "MaxPooling2D", "config": {
                "name": "pool", "pool_size": [2, 2], "strides": [2, 2], "padding": "valid",
                "data_format": "channels_last"}},
            {"class_name": "Flatten", "config": {"name": "flatten"}},
            {"class_name": "Dense", "config": {"name": "fc", "units": 2,
                                               "activation": "softmax"}}])
        p = tmp_path / "cnn.h5"
        _write_keras_file(p, cfg, {
            "conv": [("conv/kernel:0", k), ("conv/bias:0", rs.randn(4).astype(np.float32))],
            "pool": [], "flatten": [],
            "fc": [("fc/kernel:0", w), ("fc/bias:0", np.zeros(2, np.float32))]})
        net, jnet = _both(p)
        assert len(net.conf.layers) == 3  # Flatten is implicit
        np.testing.assert_array_equal(net.params[0]["W"].numpy(), k)  # HWIO verbatim
        out = _assert_same(net, jnet, rs.rand(2, 28, 28, 1).astype(np.float32))
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)

    @pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
    def test_lstm_import(self, tmp_path, gate):
        """``sigmoid`` gates reach the sequence op (the kernel's path on a
        card); Keras's default ``hard_sigmoid`` (the config leaves
        ``recurrent_activation`` out) runs the per-step loop, in both
        packages."""
        rs = np.random.RandomState(2)
        units, feat = 5, 3
        kernel = rs.randn(feat, 4 * units).astype(np.float32) * 0.2
        rec = rs.randn(units, 4 * units).astype(np.float32) * 0.2
        bias = rs.randn(4 * units).astype(np.float32) * 0.1
        wd = rs.randn(units, 2).astype(np.float32)
        lcfg = {"name": "lstm", "units": units, "activation": "tanh",
                "batch_input_shape": [None, 7, feat]}
        if gate == "sigmoid":
            lcfg["recurrent_activation"] = "sigmoid"
        cfg = _seq_config([{"class_name": "LSTM", "config": lcfg},
                           {"class_name": "Dense", "config": {"name": "out", "units": 2,
                                                              "activation": "softmax"}}])
        p = tmp_path / "lstm.h5"
        _write_keras_file(p, cfg, {
            "lstm": [("lstm/kernel:0", kernel), ("lstm/recurrent_kernel:0", rec),
                     ("lstm/bias:0", bias)],
            "out": [("out/kernel:0", wd), ("out/bias:0", np.zeros(2, np.float32))]})
        net, jnet = _both(p)
        lstm = net.conf.layers[0]
        assert lstm.gate_activation == ("sigmoid" if gate == "sigmoid" else "hardsigmoid")
        assert lstm._sequence_op() == (gate == "sigmoid")
        np.testing.assert_array_equal(net.params[0]["Wx"].numpy(), kernel)
        np.testing.assert_array_equal(net.params[0]["Wh"].numpy(), rec)
        x = rs.randn(4, 7, feat).astype(np.float32)
        got = _assert_same(net, jnet, x)
        act = _sigmoid if gate == "sigmoid" else (lambda z: np.clip(0.2 * z + 0.5, 0.0, 1.0))
        h = keras_lstm_forward(x.astype(np.float64), kernel, rec, bias, act)[:, -1]
        np.testing.assert_allclose(got, _softmax(h @ wd), rtol=1e-4, atol=1e-5)

    def test_imdb_lstm_embedding_stack(self, tmp_path):
        """The Keras examples' imdb_lstm at a small width: Embedding ->
        LSTM(sigmoid) -> Dense(1, sigmoid) on [B, T] token ids, against a
        numpy forward of the raw datasets; ``restore_checkpoint`` routes
        the Sequential file to a MultiLayerNetwork."""
        rs = np.random.RandomState(9)
        vocab, dim, units, t = 50, 8, 6, 10
        emb = rs.randn(vocab, dim).astype(np.float32) * 0.3
        kernel = rs.randn(dim, 4 * units).astype(np.float32) * 0.3
        rec = rs.randn(units, 4 * units).astype(np.float32) * 0.3
        bias = rs.randn(4 * units).astype(np.float32) * 0.1
        wd = rs.randn(units, 1).astype(np.float32)
        bd = rs.randn(1).astype(np.float32)
        cfg = _seq_config([
            {"class_name": "Embedding", "config": {"name": "embedding", "input_dim": vocab,
                                                   "output_dim": dim,
                                                   "batch_input_shape": [None, t]}},
            {"class_name": "LSTM", "config": {"name": "lstm", "units": units,
                                              "activation": "tanh",
                                              "recurrent_activation": "sigmoid"}},
            {"class_name": "Dense", "config": {"name": "dense", "units": 1,
                                               "activation": "sigmoid"}}])
        p = tmp_path / "imdb.h5"
        _write_keras_file(p, cfg, {
            "embedding": [("embedding/embeddings:0", emb)],
            "lstm": [("lstm/kernel:0", kernel), ("lstm/recurrent_kernel:0", rec),
                     ("lstm/bias:0", bias)],
            "dense": [("dense/kernel:0", wd), ("dense/bias:0", bd)]})
        net = tzoo.restore_checkpoint(str(p), device="cpu")
        assert type(net).__name__ == "MultiLayerNetwork"
        ids = rs.randint(0, vocab, (4, t))
        x = ids.astype(np.float32)[..., None]
        got = _assert_same(net, jmi.import_keras_sequential_model_and_weights(str(p)), x)
        h = keras_lstm_forward(emb[ids].astype(np.float64), kernel, rec, bias, _sigmoid)[:, -1]
        np.testing.assert_allclose(got, _sigmoid(h @ wd + bd), rtol=1e-5, atol=1e-6)

    def test_batchnorm_moving_stats_land_in_state(self, tmp_path):
        rs = np.random.RandomState(3)
        gamma = rs.rand(6).astype(np.float32) + 0.5
        beta, mean = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
        var = rs.rand(6).astype(np.float32) + 0.5
        cfg = _seq_config([
            {"class_name": "Dense", "config": {"name": "d", "units": 6, "activation": "linear",
                                               "batch_input_shape": [None, 4]}},
            {"class_name": "BatchNormalization", "config": {"name": "bn", "momentum": 0.99,
                                                            "epsilon": 1e-3, "axis": -1}}])
        p = tmp_path / "bn.h5"
        _write_keras_file(p, cfg, {
            "d": [("d/kernel:0", rs.randn(4, 6).astype(np.float32)),
                  ("d/bias:0", np.zeros(6, np.float32))],
            "bn": [("bn/gamma:0", gamma), ("bn/beta:0", beta), ("bn/moving_mean:0", mean),
                   ("bn/moving_variance:0", var)]})
        net, jnet = _both(p)
        np.testing.assert_array_equal(net.state[1]["mean"].numpy(), mean)
        np.testing.assert_array_equal(net.state[1]["var"].numpy(), var)
        np.testing.assert_array_equal(net.params[1]["gamma"].numpy(), gamma)
        _assert_same(net, jnet, rs.randn(3, 4).astype(np.float32))

    def test_batchnorm_statistics_of_the_wrong_size_raise(self, tmp_path):
        """The port shape-checks imported layer state as it does parameters;
        the JAX importer installs whatever the file holds (ROADMAP queue 3)."""
        cfg = _seq_config([
            {"class_name": "Dense", "config": {"name": "d", "units": 4, "activation": "linear",
                                               "batch_input_shape": [None, 2]}},
            {"class_name": "BatchNormalization", "config": {"name": "bn", "epsilon": 1e-3,
                                                            "axis": -1}}])
        p = tmp_path / "bnbad.h5"
        _write_keras_file(p, cfg, {
            "d": [("d/kernel:0", np.zeros((2, 4), np.float32)),
                  ("d/bias:0", np.zeros(4, np.float32))],
            "bn": [("bn/gamma:0", np.ones(4, np.float32)), ("bn/beta:0", np.zeros(4, np.float32)),
                   ("bn/moving_mean:0", np.zeros(3, np.float32)),
                   ("bn/moving_variance:0", np.ones(4, np.float32))]})
        with pytest.raises(tmi.KerasImportError, match="state 'mean'"):
            tmi.import_keras_sequential_model_and_weights(str(p), device="cpu")
        assert np.asarray(jmi.import_keras_sequential_model_and_weights(str(p))
                          .state[1]["mean"]).shape == (3,)

    def test_training_config_promotes_output_layer(self, tmp_path):
        from deeplearning4j_tpu_torch.nn import layers as L

        rs = np.random.RandomState(4)
        cfg = _seq_config([{"class_name": "Dense", "config": {
            "name": "d", "units": 3, "activation": "softmax", "batch_input_shape": [None, 5]}}])
        p = tmp_path / "tc.h5"
        _write_keras_file(p, cfg, {"d": [("d/kernel:0", rs.randn(5, 3).astype(np.float32)),
                                         ("d/bias:0", np.zeros(3, np.float32))]},
                          training_config={"loss": "categorical_crossentropy"})
        net, jnet = _both(p)
        assert isinstance(net.conf.layers[-1], L.OutputLayer)
        assert net.conf.layers[-1].loss == "mcxent"
        x = rs.rand(8, 5).astype(np.float32)
        _assert_same(net, jnet, x)
        net.fit(x, np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)])  # trainable after import

    def test_unsupported_layer_raises(self, tmp_path):
        cfg = _seq_config([{"class_name": "Lambda",
                            "config": {"name": "lam", "batch_input_shape": [None, 3]}}])
        p = tmp_path / "bad.h5"
        _write_keras_file(p, cfg, {})
        with pytest.raises(tmi.KerasImportError, match="Lambda"):
            tmi.import_keras_sequential_model_and_weights(str(p), device="cpu")

    def test_channels_first_equals_channels_last(self, tmp_path):
        """The same CNN stored channels_last and channels_first (kernel
        OIHW, input (C, H, W), dense rows C-major) imports to the same
        predictions and the same HWIO kernel."""
        rs = np.random.RandomState(7)
        H = W = 8
        k_hwio = rs.randn(3, 3, 1, 4).astype(np.float32) * 0.3
        kb = rs.randn(4).astype(np.float32) * 0.1
        d_in = 6 * 6 * 4
        w_tf = rs.randn(d_in, 3).astype(np.float32) * 0.2
        b = rs.randn(3).astype(np.float32) * 0.1

        def conv_cfg(fmt, shape):
            return {"class_name": "Conv2D", "config": {
                "name": "conv", "filters": 4, "kernel_size": [3, 3], "strides": [1, 1],
                "padding": "valid", "activation": "relu", "use_bias": True, "data_format": fmt,
                "batch_input_shape": shape}}

        tail = [{"class_name": "Flatten", "config": {"name": "flatten"}},
                {"class_name": "Dense", "config": {"name": "fc", "units": 3,
                                                   "activation": "softmax"}}]
        p_tf, p_th = tmp_path / "tf.h5", tmp_path / "th.h5"
        _write_keras_file(p_tf, _seq_config([conv_cfg("channels_last", [None, H, W, 1])] + tail), {
            "conv": [("conv/kernel:0", k_hwio), ("conv/bias:0", kb)], "flatten": [],
            "fc": [("fc/kernel:0", w_tf), ("fc/bias:0", b)]})
        perm = np.arange(d_in).reshape(6, 6, 4).transpose(2, 0, 1).reshape(-1)
        _write_keras_file(p_th, _seq_config([conv_cfg("channels_first", [None, 1, H, W])] + tail), {
            "conv": [("conv/kernel:0", np.transpose(k_hwio, (3, 2, 0, 1))), ("conv/bias:0", kb)],
            "flatten": [], "fc": [("fc/kernel:0", np.ascontiguousarray(w_tf[perm])),
                                  ("fc/bias:0", b)]})
        x = rs.rand(2, H, W, 1).astype(np.float32)
        out_tf = _assert_same(*_both(p_tf), x)
        net_th, jnet_th = _both(p_th)
        out_th = _assert_same(net_th, jnet_th, x)
        np.testing.assert_allclose(out_th, out_tf, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(net_th.params[0]["W"].numpy(), k_hwio)


class TestFunctionalImport:
    def test_residual_graph(self, tmp_path):
        rs = np.random.RandomState(5)
        w1 = rs.randn(6, 6).astype(np.float32) * 0.3
        w2 = rs.randn(6, 2).astype(np.float32) * 0.3
        cfg = {"class_name": "Model", "config": {
            "name": "resnet_toy",
            "layers": [
                {"class_name": "InputLayer", "name": "in",
                 "config": {"name": "in", "batch_input_shape": [None, 6]}, "inbound_nodes": []},
                {"class_name": "Dense", "name": "h",
                 "config": {"name": "h", "units": 6, "activation": "relu"},
                 "inbound_nodes": [[["in", 0, 0, {}]]]},
                {"class_name": "Add", "name": "res", "config": {"name": "res"},
                 "inbound_nodes": [[["in", 0, 0, {}], ["h", 0, 0, {}]]]},
                {"class_name": "Dense", "name": "out",
                 "config": {"name": "out", "units": 2, "activation": "softmax"},
                 "inbound_nodes": [[["res", 0, 0, {}]]]}],
            "input_layers": [["in", 0, 0]], "output_layers": [["out", 0, 0]]}}
        p = tmp_path / "fn.h5"
        _write_keras_file(p, cfg, {"h": [("h/kernel:0", w1), ("h/bias:0", np.zeros(6, np.float32))],
                                   "out": [("out/kernel:0", w2),
                                           ("out/bias:0", np.zeros(2, np.float32))]})
        graph = tzoo.restore_checkpoint(str(p), device="cpu")
        assert type(graph).__name__ == "ComputationGraph"
        x = rs.randn(3, 6).astype(np.float32)
        got = _assert_same(graph, jmi.import_keras_model_and_weights(str(p)), {"in": x})
        np.testing.assert_allclose(got, _softmax((x + np.maximum(x @ w1, 0)) @ w2),
                                   rtol=1e-4, atol=1e-5)


class TestKeras1Dialect:
    def test_keras1_bn_running_stats_import(self, tmp_path):
        """Keras 1 weight names ``{layer}_{gamma,beta,running_mean,
        running_std}``, where running_std holds the variance."""
        rs = np.random.RandomState(5)
        mean = rs.randn(3).astype(np.float32)
        var = rs.rand(3).astype(np.float32) + 0.25
        cfg = _seq_config([
            {"class_name": "Dense", "config": {"name": "dense_1", "output_dim": 3,
                                               "activation": "linear",
                                               "batch_input_shape": [None, 2]}},
            {"class_name": "BatchNormalization",
             "config": {"name": "batchnormalization_1", "epsilon": 1e-3, "axis": -1}}])
        p = tmp_path / "bn1.h5"
        _write_keras_file(p, cfg, {
            "dense_1": [("dense_1_W", rs.randn(2, 3).astype(np.float32)),
                        ("dense_1_b", np.zeros(3, np.float32))],
            "batchnormalization_1": [
                ("batchnormalization_1_gamma", np.ones(3, np.float32)),
                ("batchnormalization_1_beta", np.zeros(3, np.float32)),
                ("batchnormalization_1_running_mean", mean),
                ("batchnormalization_1_running_std", var)]})
        net, jnet = _both(p)
        np.testing.assert_array_equal(net.state[1]["mean"].numpy(), mean)
        np.testing.assert_array_equal(net.state[1]["var"].numpy(), var)
        _assert_same(net, jnet, rs.randn(4, 2).astype(np.float32))

    def test_keras1_theano_backend_defaults_channels_first(self, tmp_path):
        rs = np.random.RandomState(8)
        k_oihw = rs.randn(2, 1, 3, 3).astype(np.float32) * 0.3
        cfg = {"class_name": "Sequential", "config": [  # Keras 1: a bare layer list
            {"class_name": "Convolution2D", "config": {
                "name": "convolution2d_1", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
                "border_mode": "valid", "activation": "relu",
                "batch_input_shape": [None, 1, 6, 6]}}]}
        p = tmp_path / "k1.h5"
        _write_keras_file(p, cfg, {"convolution2d_1": [
            ("convolution2d_1_W", k_oihw), ("convolution2d_1_b", np.zeros(2, np.float32))]},
            keras_version="1.2.2", backend="theano")
        net, jnet = _both(p)
        t = net.conf.input_type
        assert (t.height, t.width, t.channels) == (6, 6, 1)
        np.testing.assert_array_equal(net.params[0]["W"].numpy(), np.transpose(k_oihw, (2, 3, 1, 0)))
        out = _assert_same(net, jnet, rs.rand(1, 6, 6, 1).astype(np.float32))
        assert out.shape == (1, 4, 4, 2)

    def test_missing_required_weight_raises(self, tmp_path):
        cfg = _seq_config([
            {"class_name": "Dense", "config": {"name": "d", "units": 3, "activation": "linear",
                                               "batch_input_shape": [None, 2]}},
            {"class_name": "BatchNormalization", "config": {"name": "bn", "epsilon": 1e-3,
                                                            "axis": -1}}])
        p = tmp_path / "missing.h5"
        _write_keras_file(p, cfg, {"d": [("d/kernel:0", np.zeros((2, 3), np.float32))],
                                   "bn": [("bn/gamma:0", np.ones(3, np.float32)),
                                          ("bn/beta:0", np.zeros(3, np.float32))]})
        with pytest.raises(tmi.KerasImportError, match="moving_mean"):
            tmi.import_keras_sequential_model_and_weights(str(p), device="cpu")

    def test_save_weights_file_with_separate_config(self, tmp_path):
        """``import_keras_sequential_config_and_weights``: a config JSON and
        a save_weights() file whose layer groups sit at the root."""
        from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive

        rs = np.random.RandomState(6)
        w, b = rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(np.float32)
        cfg = _seq_config([{"class_name": "Dense", "config": {
            "name": "d", "units": 3, "activation": "tanh", "batch_input_shape": [None, 4]}}])
        cfg_path, w_path = tmp_path / "model.json", tmp_path / "model.weight"
        cfg_path.write_text(json.dumps(cfg))
        with Hdf5Archive(str(w_path), "w") as f:
            f.make_group("d")
            f.write_attr_strings("weight_names", ["d/kernel:0", "d/bias:0"], "d")
            f.write_dataset("d/d/kernel:0", w)
            f.write_dataset("d/d/bias:0", b)
        net = tmi.import_keras_sequential_config_and_weights(str(cfg_path), str(w_path),
                                                             device="cpu")
        jnet = jmi.import_keras_sequential_config_and_weights(str(cfg_path), str(w_path))
        x = rs.randn(2, 4).astype(np.float32)
        np.testing.assert_allclose(_assert_same(net, jnet, x), np.tanh(x @ w + b),
                                   rtol=1e-5, atol=1e-6)


def test_every_mapper_builds_the_jax_packages_layer():
    """Each Keras class the JAX mapper table names maps to a port layer of
    the same class with the same fields, on one representative config."""
    import dataclasses

    from deeplearning4j_tpu.modelimport import layers as jlayers
    from deeplearning4j_tpu_torch.modelimport import layers as tlayers

    assert set(tlayers.MAPPERS) == set(jlayers.MAPPERS)
    cfg = {"units": 4, "output_dim": 4, "filters": 3, "nb_filter": 3, "kernel_size": [3, 3],
           "input_dim": 7, "activation": "relu", "rate": 0.25, "stddev": 0.1, "size": 2,
           "pool_size": 2, "padding": "same"}
    for name in sorted(jlayers.MAPPERS):
        c = dict(cfg)
        if name in ("Conv1D", "Convolution1D"):
            c["kernel_size"] = 3
        if name == "ZeroPadding2D":
            c["padding"] = [[1, 2], [0, 1]]
        mine, _ = tlayers.map_layer(name, c)
        theirs, _ = jlayers.map_layer(name, c)
        mine = mine if isinstance(mine, list) else [mine]
        theirs = theirs if isinstance(theirs, list) else [theirs]
        assert [type(l).__name__ for l in mine] == [type(l).__name__ for l in theirs], name
        for a, b in zip(mine, theirs):
            if a is None:
                continue
            fields = {f.name for f in dataclasses.fields(b)}
            for f in fields & {f.name for f in dataclasses.fields(a)}:
                assert getattr(a, f) == getattr(b, f), (name, f)
