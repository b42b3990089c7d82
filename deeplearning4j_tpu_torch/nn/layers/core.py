"""Core layers: Dense, Output, Loss, Activation, Dropout and
EmbeddingSequence, and the policy matmul."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer, dropout_mask, normal, uniform
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.serde import register_config


def matmul(x, w):
    """Matmul under the dtype policy: operands rounded to the compute dtype,
    products summed and returned in the accumulation dtype (the JAX
    package's ``preferred_element_type``). A bf16 x bf16 product is exact
    in f32, so upcasting the rounded operands gives that contract with
    plain torch ops."""
    cd, ad = _dtypes.compute_dtypes_for(x.dtype)
    return torch.matmul(x.to(cd).to(ad), w.to(cd).to(ad))


@register_config
@dataclasses.dataclass(frozen=True)
class DenseLayer(ParamLayer):
    n_out: int = 0
    has_bias: bool = True

    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return _inputs.FeedForwardType(self.n_out)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = _inputs.adapted_type(input_type, _inputs.FeedForwardType).size
        p = {"W": _init.init_weight(self.weight_init, generator, (n_in, self.n_out),
                                    n_in, self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        z = matmul(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + loss head."""

    loss: object = "mcxent"
    activation: object = dataclasses.field(default="softmax", kw_only=True)

    def compute_loss(self, predictions, labels, mask=None):
        return _losses.get(self.loss)(predictions, labels, mask)


@register_config
@dataclasses.dataclass(frozen=True)
class LossLayer(Layer):
    """Parameterless loss head."""

    loss: object = "mcxent"
    activation: object = "identity"

    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return _inputs.adapted_type(input_type, _inputs.FeedForwardType)

    def apply(self, params, state, x, *, train=False):
        return _act.get(self.activation)(x), state

    def compute_loss(self, predictions, labels, mask=None):
        return _losses.get(self.loss)(predictions, labels, mask)


@register_config
@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """An activation function alone, on any input family."""

    activation: object = "relu"

    input_family = None  # accepts any family unchanged

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False):
        return _act.get(self.activation)(x), state


@register_config
@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Standalone dropout in train mode (reference: DropoutLayer.java):
    ``kind`` dropout (inverted) | alpha (SELU-preserving) |
    gaussian_dropout (multiplicative N(1, rate/(1-rate))) | gaussian_noise
    (additive N(0, rate^2)). The identity in eval mode or without a seed."""

    rate: float = 0.5
    kind: str = "dropout"

    input_family = None  # accepts any family unchanged

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False, rng=None):
        if not train or self.rate <= 0.0 or rng is None:
            return x, state
        if self.kind == "dropout":
            return dropout_mask(rng, x, self.rate), state
        if self.kind == "alpha":
            alpha_p = -1.7580993408473766
            keep = 1.0 - self.rate
            a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
            b = -a * alpha_p * (1 - keep)
            kept = uniform(rng, x.shape, x.device) < keep
            return a * torch.where(kept, x, torch.full_like(x, alpha_p)) + b, state
        noise = normal(rng, x.shape, x.device).to(x.dtype)
        if self.kind == "gaussian_dropout":
            return x * (1.0 + (self.rate / (1.0 - self.rate)) ** 0.5 * noise), state
        if self.kind == "gaussian_noise":
            return x + self.rate * noise, state
        raise ValueError(f"Unknown dropout kind {self.kind!r}")


@register_config
@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(ParamLayer):
    """Per-timestep id -> vector lookup: [B, T] (or [B, T, 1]) ids, given
    as integers or floats, -> [B, T, n_out], with an optional learned
    positional table ``P`` whose first T rows are added."""

    n_in: int = 0   # vocab size
    n_out: int = 0
    add_positional: bool = False
    weight_init: object = dataclasses.field(default="xavier", kw_only=True)

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        p = {"W": _init.init_weight(self.weight_init, generator, (self.n_in, self.n_out),
                                    self.n_in, self.n_out, dtype)}
        if self.add_positional:
            if input_type.timesteps is None:
                raise ValueError("add_positional requires a fixed timesteps "
                                 "in the RecurrentType input")
            p["P"] = _init.init_weight(self.weight_init, generator,
                                       (input_type.timesteps, self.n_out),
                                       input_type.timesteps, self.n_out, dtype)
        return p

    def apply(self, params, state, x, *, train=False, mask=None):
        idx = x.to(torch.int64)  # truncation toward zero, as astype(int32)
        if idx.dim() == 3:
            idx = idx[..., 0]
        z = params["W"][idx]                          # [B, T, D]
        if "P" in params:
            z = z + params["P"][None, :z.shape[1]]
        if mask is not None:
            z = z * mask[..., None].to(z.dtype)
        return self.activation_fn()(z), state
