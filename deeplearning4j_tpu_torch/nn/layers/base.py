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

Regularization fields are consumed by the network: l1/l2 are added to the
loss over the layer's parameters (``regularization_penalty``), constraints
are projections applied after each update (``apply_constraints``, in
place). Input dropout and weight noise are not ported yet: a network
training a layer that sets them raises.
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

    # ---- regularization hooks consumed by the network ----
    def regularization_penalty(self, params):
        return 0.0

    def apply_constraints(self, params, iteration, epoch):
        return params


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

    WEIGHT_KEYS = ("W",)
    BIAS_KEYS = ("b",)

    def activation_fn(self):
        return _act.get(self.activation)

    def regularization_penalty(self, params):
        """L1/L2 on weights, separate coefficients for biases (reference:
        BaseLayer.calcL1/calcL2 exclude biases unless l1Bias/l2Bias set)."""
        pen = 0.0
        for k, v in params.items():
            if k in self.BIAS_KEYS:
                if self.l1_bias:
                    pen = pen + self.l1_bias * v.abs().sum()
                if self.l2_bias:
                    pen = pen + 0.5 * self.l2_bias * (v * v).sum()
            else:
                if self.l1:
                    pen = pen + self.l1 * v.abs().sum()
                if self.l2:
                    pen = pen + 0.5 * self.l2 * (v * v).sum()
        return pen

    def apply_constraints(self, params, iteration, epoch):
        """Each constraint projects ``params`` in place, in order."""
        for c in self.constraints:
            c.apply(self, params, iteration, epoch)
        return params


def pop_aux_losses(loss, states):
    """(loss + popped aux terms, cleaned states): a layer may stash an
    input-dependent loss term in its per-step state under ``"aux_loss"``;
    the network's loss pops it so the persistent state keeps its
    structure. ``states`` is a list of per-layer dicts, or a dict of
    per-vertex dicts."""
    out = dict(states) if isinstance(states, dict) else list(states)
    for i, s in (states.items() if isinstance(states, dict) else enumerate(states)):
        if isinstance(s, dict) and "aux_loss" in s:
            s = dict(s)
            loss = loss + s.pop("aux_loss")
            out[i] = s
    return loss, out
