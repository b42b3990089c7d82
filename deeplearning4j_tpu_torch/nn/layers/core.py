"""Core layers: Dense, Output, Loss, Activation, Dropout, Embedding,
EmbeddingSequence, TimeDistributedDense and AutoEncoder, the policy matmul
and the embeddings' row gather.

``take_rows`` gathers as the JAX package's ``jnp.take`` does: an id in
[-n, -1] wraps to row n + id, any other id outside [0, n) gives a row of
NaN and no gradient. Nothing asserts on the card, so a served request
with a bad id poisons only its own outputs, not the CUDA context."""

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


def take_rows(table, ids):
    """``table[ids]`` for integer ``ids`` of any shape, with ``jnp.take``'s
    out-of-range rule (wrap [-n, -1], NaN rows elsewhere)."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    rows = table[torch.where(valid, ids, torch.zeros_like(ids))]
    return torch.where(valid[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype, device=rows.device))


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
class EmbeddingLayer(ParamLayer):
    """Id -> vector lookup (reference: EmbeddingLayer.java): [B] or [B, 1]
    class ids, given as integers or floats, -> [B, n_out]; the forward is
    a gather, the backward a scatter-add (autograd's)."""

    n_in: int = 0  # vocab size
    n_out: int = 0
    has_bias: bool = False
    weight_init: object = dataclasses.field(default="xavier", kw_only=True)

    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return _inputs.FeedForwardType(self.n_out)

    def init(self, generator, input_type, dtype=torch.float32):
        p = {"W": _init.init_weight(self.weight_init, generator, (self.n_in, self.n_out),
                                    self.n_in, self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        idx = x.to(torch.int64)  # truncation toward zero, as astype(int32)
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[:, 0]
        z = take_rows(params["W"], idx)
        if self.has_bias:
            z = z + params["b"]
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class TimeDistributedDenseLayer(DenseLayer):
    """Dense at every timestep: [B, T, F] -> [B, T, n_out], the time axis
    kept (reference: a DenseLayer between RnnToFeedForward and
    FeedForwardToRnn preprocessors)."""

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        return _inputs.RecurrentType(self.n_out, input_type.timesteps)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = input_type.size
        p = {"W": _init.init_weight(self.weight_init, generator, (n_in, self.n_out),
                                    n_in, self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        b, t, f = x.shape
        z = matmul(x.reshape(b * t, f), params["W"]).reshape(b, t, self.n_out)
        if self.has_bias:
            z = z + params["b"]
        return self.activation_fn()(z), state


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
        z = take_rows(params["W"], idx)               # [B, T, D]
        if "P" in params:
            z = z + params["P"][None, :z.shape[1]]
        if mask is not None:
            z = z * mask[..., None].to(z.dtype)
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class AutoEncoder(ParamLayer):
    """Denoising autoencoder (reference: AutoEncoder.java). In a network it
    is a dense encoder; ``reconstruct`` and ``pretrain_loss`` are the
    unsupervised path: corrupt -> encode -> decode with the tied weight's
    transpose and the visible bias ``vb`` -> reconstruction loss.

    The corruption keeps each input with probability 1 -
    ``corruption_level``: a draw from ``rng`` (a ``torch.Generator`` on
    the input's device), or the given boolean ``keep`` mask. The JAX
    package draws threefry bits, so parity goes through ``keep``."""

    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss: object = "mse"
    activation: object = dataclasses.field(default="sigmoid", kw_only=True)

    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return _inputs.FeedForwardType(self.n_out)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = _inputs.adapted_type(input_type, _inputs.FeedForwardType).size
        dev = generator.device
        return {
            "W": _init.init_weight(self.weight_init, generator, (n_in, self.n_out), n_in,
                                   self.n_out, dtype),
            "b": torch.full((self.n_out,), self.bias_init, dtype=dtype, device=dev),
            "vb": torch.zeros((n_in,), dtype=dtype, device=dev),  # the decoder's bias
        }

    def apply(self, params, state, x, *, train=False):
        z = matmul(x, params["W"]) + params["b"]
        return self.activation_fn()(z), state

    def reconstruct(self, params, x):
        h, _ = self.apply(params, {}, x)
        return self.activation_fn()(matmul(h, params["W"].T) + params["vb"])

    def corruption_mask(self, x, rng):
        """[*x.shape] bool: True where an input survives the corruption."""
        u = torch.rand(x.shape, generator=rng, device=x.device, dtype=torch.float32)
        return u < 1.0 - self.corruption_level

    def pretrain_loss(self, params, x, rng=None, *, keep=None):
        """The reconstruction loss of ``x`` from its corrupted copy."""
        if keep is None and self.corruption_level > 0 and rng is not None:
            keep = self.corruption_mask(x, rng)
        corrupted = x if keep is None else torch.where(keep, x, torch.zeros_like(x))
        return _losses.get(self.loss)(self.reconstruct(params, corrupted), x)
