"""The port's sklearn adapters (``deeplearning4j_tpu_torch/mlpipeline.py``)
on the CPU: the estimator contract (fit/predict on blobs with labels
mapped back, Pipeline, clone, GridSearchCV, the regressor, the
autoencoder's code), the stand-ins without sklearn, and one fit from the
JAX package's initial weights agreeing with the JAX estimator's."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import mlpipeline as jmlp
from deeplearning4j_tpu.nn import layers as JL
from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu.nn.conf.inputs import FeedForwardType as JFF
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfig as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch import mlpipeline as tmlp
from deeplearning4j_tpu_torch.mlpipeline import (AutoEncoderTransformer, NeuralNetClassifier,
                                                 NeuralNetRegressor)
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as U
from deeplearning4j_tpu_torch.nn.conf.inputs import FeedForwardType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig
from deeplearning4j_tpu_torch.utils import serialization as tser

ROOT = Path(__file__).resolve().parent.parent


def _blobs(n=120, seed=0):
    rs = np.random.RandomState(seed)
    centers = np.array([[2.0, 2.0], [-2.0, -2.0], [2.0, -2.0]])
    y = rs.randint(0, 3, n)
    X = centers[y] + 0.4 * rs.randn(n, 2)
    return X.astype(np.float32), y


def _clf_conf(Conf=NeuralNetConfig, L=L, U=U, FF=FeedForwardType):
    return Conf(seed=1, updater=U.Adam(learning_rate=0.05)).list(
        L.DenseLayer(n_out=16, activation="tanh"),
        L.OutputLayer(n_out=3, loss="mcxent"),
        input_type=FF(2))


def test_fit_predict_blobs():
    X, y = _blobs()
    clf = NeuralNetClassifier(conf=_clf_conf(), epochs=30, seed=0, device="cpu")
    clf.fit(X, y)
    assert (clf.predict(X) == y).mean() > 0.9
    np.testing.assert_allclose(clf.predict_proba(X[:5]).sum(-1), 1.0, atol=1e-5)
    # predict is the argmax of the wrapped net's output
    out = clf.net_.output(X).numpy()
    np.testing.assert_array_equal(clf.predict(X), clf.classes_[out.argmax(-1)])


def test_noncontiguous_labels_map_back():
    X, y = _blobs()
    y = np.array([10, 20, 30])[y]
    clf = NeuralNetClassifier(conf=_clf_conf(), epochs=30, seed=0, device="cpu")
    clf.fit(X, y)
    assert set(np.unique(clf.predict(X))) <= {10, 20, 30}
    assert (clf.predict(X) == y).mean() > 0.9


def test_too_many_classes_for_the_conf_raises():
    X, _ = _blobs(20)
    with pytest.raises(ValueError, match="classes"):
        NeuralNetClassifier(conf=_clf_conf(), epochs=1, device="cpu").fit(X, np.arange(20))


def test_sklearn_pipeline_and_clone():
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    X, y = _blobs()
    pipe = Pipeline([("scale", StandardScaler()),
                     ("net", NeuralNetClassifier(conf=_clf_conf(), epochs=30, seed=0,
                                                 device="cpu"))])
    pipe.fit(X, y)
    assert pipe.score(X, y) > 0.9
    c2 = clone(pipe.named_steps["net"])
    assert c2.epochs == 30 and c2.device == "cpu"
    assert len(c2.conf.layers) == len(pipe.named_steps["net"].conf.layers)
    assert not hasattr(c2, "net_")


def test_grid_search_over_epochs():
    pytest.importorskip("sklearn")
    from sklearn.model_selection import GridSearchCV
    X, y = _blobs(90)
    gs = GridSearchCV(NeuralNetClassifier(conf=_clf_conf(), seed=0, device="cpu"),
                      {"epochs": [2, 20]}, cv=2, n_jobs=1)
    gs.fit(X, y)
    assert gs.best_params_["epochs"] in (2, 20)


def test_regressor_fits_a_linear_target():
    rs = np.random.RandomState(0)
    X = rs.randn(200, 3).astype(np.float32)
    y = X @ np.array([1.0, -2.0, 0.5]) + 0.3
    conf = NeuralNetConfig(seed=2, updater=U.Adam(learning_rate=0.05)).list(
        L.DenseLayer(n_out=16, activation="relu"),
        L.OutputLayer(n_out=1, loss="mse", activation="identity"),
        input_type=FeedForwardType(3))
    reg = NeuralNetRegressor(conf=conf, epochs=60, seed=0, device="cpu")
    reg.fit(X, y)
    assert reg.predict(X).shape == (200,)
    assert reg.score(X, y) > 0.9


def test_autoencoder_transform_is_the_code_layer():
    rs = np.random.RandomState(3)
    X = rs.rand(100, 8).astype(np.float32)
    conf = NeuralNetConfig(seed=3, updater=U.Adam(learning_rate=0.01)).list(
        L.DenseLayer(n_out=3, activation="tanh"),
        L.OutputLayer(n_out=8, loss="mse", activation="sigmoid"),
        input_type=FeedForwardType(8))
    ae = AutoEncoderTransformer(conf=conf, epochs=30, seed=0, device="cpu")
    codes = ae.fit_transform(X)
    assert codes.shape == (100, 3)
    np.testing.assert_allclose(codes, ae.net_.feed_forward(X)[0].numpy(), rtol=1e-6)
    err = np.mean((ae.reconstruct(X) - X) ** 2)
    assert err < np.mean((X.mean(0) - X) ** 2)


def test_estimators_ask_for_the_card_by_default(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _blobs(20)
    assert NeuralNetClassifier(conf=_clf_conf()).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        NeuralNetClassifier(conf=_clf_conf(), epochs=1).fit(X, y)


def test_stand_ins_without_sklearn():
    """Where sklearn is missing (the card's host), the stand-ins keep
    get_params/set_params and fit_transform."""
    code = ("import sys\n"
            "sys.modules['sklearn'] = None\n"
            "import numpy as np\n"
            "from deeplearning4j_tpu_torch import mlpipeline as m\n"
            "from deeplearning4j_tpu_torch.nn import layers as L, updaters as U\n"
            "from deeplearning4j_tpu_torch.nn.conf.inputs import FeedForwardType\n"
            "from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfig\n"
            "conf = NeuralNetConfig(seed=3, updater=U.Adam(learning_rate=0.01)).list(\n"
            "    L.DenseLayer(n_out=2, activation='tanh'),\n"
            "    L.OutputLayer(n_out=4, loss='mse', activation='sigmoid'),\n"
            "    input_type=FeedForwardType(4))\n"
            "ae = m.AutoEncoderTransformer(conf=conf, epochs=2, device='cpu')\n"
            "assert set(ae.get_params()) >= {'conf', 'epochs', 'device', 'seed'}\n"
            "ae.set_params(epochs=3)\n"
            "codes = ae.fit_transform(np.random.RandomState(0).rand(16, 4).astype(np.float32))\n"
            "assert codes.shape == (16, 2) and ae.epochs == 3\n"
            "clf = m.NeuralNetClassifier(conf=conf, epochs=1, device='cpu')\n"
            "assert type(clf).__mro__[1].__module__ == 'deeplearning4j_tpu_torch.mlpipeline'\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_fit_from_the_jax_weights_agrees_with_the_jax_estimator(monkeypatch):
    """The packages draw initial weights differently (PRNGKey against a
    torch.Generator), so the JAX estimator's initial weights are carried
    into the port's; the fits then agree."""
    X, y = _blobs(96, seed=4)
    y = np.array([7, 8, 9])[y]
    jconf = _clf_conf(JConf, JL, JU, JFF)
    ref = JNet(jconf)
    ref.init(rng=jax.random.PRNGKey(5))
    init = jax.tree_util.tree_map(np.asarray, ref.params)
    real = tmlp._new_network

    def carried(conf, seed, device):
        return tser.params_from_numpy(real(conf, seed, device), init)

    monkeypatch.setattr(tmlp, "_new_network", carried)
    j = jmlp.NeuralNetClassifier(conf=jconf, epochs=3, batch_size=16, seed=5).fit(X, y)
    t = NeuralNetClassifier(conf=_clf_conf(), epochs=3, batch_size=16, seed=5,
                            device="cpu").fit(X, y)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    np.testing.assert_allclose(t.predict_proba(X), j.predict_proba(X), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
