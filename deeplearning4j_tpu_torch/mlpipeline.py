"""ML-pipeline adapters: scikit-learn Estimator/Transformer wrappers.

The port of ``deeplearning4j_tpu/mlpipeline.py``. Reference analog:
deeplearning4j-scaleout/spark/dl4j-spark-ml: ``SparkDl4jNetwork.scala``
(an org.apache.spark.ml Estimator whose ``train(DataFrame)`` fits a
network and returns a ``SparkDl4jModel`` with ``predict``) and
``AutoEncoder.scala`` (an unsupervised Transformer). That tier exists so
networks drop into the host ecosystem's pipeline API (feature scaling ->
model -> grid search). The Python ecosystem's pipeline API is
scikit-learn, so the adapters implement the sklearn estimator contract
instead of the JVM one: ``get_params``/``set_params`` (clonable,
GridSearchCV-compatible), ``fit``/``predict``/``predict_proba``/
``transform``, and they compose inside ``sklearn.pipeline.Pipeline``.
Where sklearn is not installed, minimal stand-ins keep the same methods.

The wrapped network is the port's ``MultiLayerNetwork`` on ``device``
(default ``cuda``; a missing card raises, the CPU is asked for with
``device="cpu"``); configs are the frozen dataclass DSL, so cloning an
estimator shares the config object safely. ``seed`` seeds the
``torch.Generator`` the weights are drawn from (the JAX package draws
them from ``PRNGKey(seed)``, so the two packages' weights differ for one
seed). Predictions come back to the host as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

try:
    from sklearn.base import (BaseEstimator, ClassifierMixin, RegressorMixin,
                              TransformerMixin)
except ImportError:  # pragma: no cover - sklearn is in the target image
    class BaseEstimator:  # minimal stand-ins keep import working
        def get_params(self, deep=True):
            return {k: v for k, v in self.__dict__.items()
                    if not k.endswith("_")}

        def set_params(self, **p):
            for k, v in p.items():
                setattr(self, k, v)
            return self

    class ClassifierMixin:
        pass

    class RegressorMixin:
        pass

    class TransformerMixin:
        def fit_transform(self, X, y=None, **kw):
            return self.fit(X, y, **kw).transform(X)


def _new_network(conf, seed, device):
    """The initialised network a fit starts from."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(conf, device=device)
    net.init(generator=None if seed is None else torch.Generator().manual_seed(int(seed)))
    return net


def _fit_network(conf, X, Y, epochs, batch_size, seed, device):
    net = _new_network(conf, seed, device)
    net.fit(np.asarray(X, np.float32), np.asarray(Y, np.float32), epochs=epochs,
            batch_size=batch_size)
    return net


def _host(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class NeuralNetClassifier(ClassifierMixin, BaseEstimator):
    """sklearn classifier over a MultiLayerConfiguration (reference:
    SparkDl4jNetwork + SparkDl4jModel.predict = argmax). ``conf``'s output
    layer width must match the number of classes."""

    def __init__(self, conf=None, epochs=5, batch_size=32, seed=None, device="cuda"):
        self.conf = conf
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = device

    def fit(self, X, y):
        assert self.conf is not None, "conf= is required"
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        width = self.conf.layers[-1].n_out
        if len(self.classes_) > width:
            raise ValueError(
                f"y has {len(self.classes_)} classes but the conf's output "
                f"layer is {width} wide")
        # one-hot at the CONFIGURED width: a CV fold missing some classes
        # still trains the right objective (unseen columns get no mass)
        idx = np.searchsorted(self.classes_, y)
        onehot = np.eye(width, dtype=np.float32)[idx]
        self.net_ = _fit_network(self.conf, X, onehot, self.epochs,
                                 self.batch_size, self.seed, self.device)
        return self

    def predict_proba(self, X):
        # sklearn contract: one column PER OBSERVED CLASS, rows sum to 1
        # (the conf's output may be wider when a CV fold misses classes)
        out = _host(self.net_.output(np.asarray(X, np.float32)))
        out = out[:, :len(self.classes_)]
        return out / np.clip(out.sum(-1, keepdims=True), 1e-9, None)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=-1)]


class NeuralNetRegressor(RegressorMixin, BaseEstimator):
    """sklearn regressor (reference: SparkDl4jModel 'continuous for
    regression')."""

    def __init__(self, conf=None, epochs=5, batch_size=32, seed=None, device="cuda"):
        self.conf = conf
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = device

    def fit(self, X, y):
        assert self.conf is not None, "conf= is required"
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y[:, None]
        self.net_ = _fit_network(self.conf, X, y, self.epochs,
                                 self.batch_size, self.seed, self.device)
        return self

    def predict(self, X):
        out = _host(self.net_.output(np.asarray(X, np.float32)))
        return out[:, 0] if out.shape[-1] == 1 else out


class AutoEncoderTransformer(TransformerMixin, BaseEstimator):
    """Unsupervised encoder (reference: AutoEncoder.scala — fit the
    autoencoder on features, transform = activations of the compressed
    layer). ``conf`` must reconstruct its input (loss vs X itself);
    ``code_layer`` indexes the layer whose OUTPUT is the code (default:
    the middle layer)."""

    def __init__(self, conf=None, code_layer=None, epochs=5, batch_size=32,
                 seed=None, device="cuda"):
        self.conf = conf
        self.code_layer = code_layer
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = device

    def fit(self, X, y=None):
        assert self.conf is not None, "conf= is required"
        X = np.asarray(X, np.float32)
        self.net_ = _fit_network(self.conf, X, X, self.epochs,
                                 self.batch_size, self.seed, self.device)
        n = len(self.conf.layers)
        self.code_layer_ = (self.code_layer if self.code_layer is not None
                            else (n - 1) // 2)
        return self

    def transform(self, X):
        # stop at the code layer — no need to run the decoder half
        x = torch.as_tensor(np.asarray(X, np.float32), device=self.net_.device)
        with torch.inference_mode():
            code, _ = self.net_.apply_fn(self.net_.params, self.net_.state, x, train=False,
                                         layer_limit=self.code_layer_ + 1)
        return _host(code)

    def reconstruct(self, X):
        return _host(self.net_.output(np.asarray(X, np.float32)))
