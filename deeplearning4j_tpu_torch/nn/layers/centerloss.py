"""Center-loss output layer (reference: CenterLossOutputLayer.java; Wen et
al. 2016): softmax cross-entropy plus lambda/2 * mean over the batch of
||f - c_y||^2, where f is the layer's input (the features) and c_y the
center of the example's class.

The centers are layer state, like BatchNormalization's running
statistics: gathered by ``argmax(labels)``, no gradient reaches them, and
in train mode each class's center moves by ``alpha`` times the mean of its
examples' ``f - c`` against the old centers (the count clamped at 1). The
network routes an output layer that defines ``loss_from_features`` through
it, with the layer's input activation and the labels.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import ParamLayer
from deeplearning4j_tpu_torch.nn.layers.core import matmul
from deeplearning4j_tpu_torch.utils.serde import register_config


@register_config
@dataclasses.dataclass(frozen=True)
class CenterLossOutputLayer(ParamLayer):
    n_out: int = 0
    alpha: float = 0.05   # center EMA rate
    lambda_: float = 2e-4  # center-loss weight
    loss: object = "mcxent"
    activation: object = dataclasses.field(default="softmax", kw_only=True)

    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return _inputs.FeedForwardType(self.n_out)

    def _n_in(self, input_type):
        return _inputs.adapted_type(input_type, _inputs.FeedForwardType).size

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = self._n_in(input_type)
        return {"W": _init.init_weight(self.weight_init, generator, (n_in, self.n_out),
                                       n_in, self.n_out, dtype),
                "b": torch.zeros((self.n_out,), dtype=dtype, device=generator.device)}

    def init_state(self, input_type, dtype=torch.float32):
        return {"centers": torch.zeros((self.n_out, self._n_in(input_type)), dtype=dtype)}

    def apply(self, params, state, x, *, train=False):
        z = matmul(x, params["W"]) + params["b"]
        return self.activation_fn()(z), state

    def loss_from_features(self, params, state, feats, labels, mask=None, train=True):
        """(cross-entropy + center term, predictions, new state)."""
        preds, _ = self.apply(params, state, feats)
        ce = _losses.get(self.loss)(preds, labels, mask)
        centers = state["centers"]
        c_y = centers[labels.argmax(dim=-1)]                 # [B, n_in], no gradient
        diff = feats - c_y
        center_loss = 0.5 * self.lambda_ * (diff * diff).sum(dim=-1).mean()
        if not train:
            return ce + center_loss, preds, state
        with torch.no_grad():
            onehot = labels.to(feats.dtype)                  # [B, n_out]
            counts = onehot.sum(dim=0).clamp_min(1.0)
            delta = (onehot.t() @ diff) / counts[:, None]
            new_state = {"centers": centers + self.alpha * delta.to(centers.dtype)}
        return ce + center_loss, preds, new_state
