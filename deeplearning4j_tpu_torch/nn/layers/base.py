"""Layer protocol.

As in the JAX package a layer IS its config: a frozen dataclass carrying
hyperparameters plus functions

    output_type(input_type)                       -> InputType
    init(generator, input_type, dtype)            -> {name: tensor}
    init_state(input_type, dtype)                 -> {name: tensor}
    apply(params, state, x, *, train)             -> (y, new_state)

The dataclass fields (and their order) are the JAX package's, so the JSON
form is identical. Parameters live in the network (``nn/multilayer.py``),
under the JAX keys.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs


@dataclasses.dataclass(frozen=True)
class Layer:
    """Base: a parameterless layer. Fields are hyperparameters only."""

    name: str | None = dataclasses.field(default=None, kw_only=True)
    dropout: float = dataclasses.field(default=0.0, kw_only=True)  # drop probability on layer input

    # which input family this layer consumes; the network auto-adapts
    input_family = _inputs.FeedForwardType

    def output_type(self, input_type):
        return input_type

    def init(self, generator, input_type, dtype=torch.float32):
        return {}

    def init_state(self, input_type, dtype=torch.float32):
        return {}

    def apply(self, params, state, x, *, train=False):
        return x, state


@dataclasses.dataclass(frozen=True)
class ParamLayer(Layer):
    """Base for layers with weights: activation + init + L1/L2 + constraints."""

    activation: object = dataclasses.field(default="identity", kw_only=True)
    weight_init: object = dataclasses.field(default="xavier", kw_only=True)
    bias_init: float = dataclasses.field(default=0.0, kw_only=True)
    l1: float = dataclasses.field(default=0.0, kw_only=True)
    l2: float = dataclasses.field(default=0.0, kw_only=True)
    l1_bias: float = dataclasses.field(default=0.0, kw_only=True)
    l2_bias: float = dataclasses.field(default=0.0, kw_only=True)
    constraints: tuple = dataclasses.field(default=(), kw_only=True)
    weight_noise: object = dataclasses.field(default=None, kw_only=True)

    def activation_fn(self):
        return _act.get(self.activation)
