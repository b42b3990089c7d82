"""Layer protocol.

As in the JAX package a layer IS its config: a frozen dataclass carrying
hyperparameters plus functions

    output_type(input_type)                       -> InputType
    init(generator, input_type, dtype)            -> {name: tensor}
    init_state(input_type, dtype)                 -> {name: tensor}
    apply(params, state, x, *, train)             -> (y, new_state)

A layer that draws random numbers in train mode (``DropoutLayer``) also
takes ``rng``: an integer seed, or None for no draws.

The dataclass fields (and their order) are the JAX package's, so the JSON
form is identical. Parameters live in the network (``nn/multilayer.py``),
under the JAX keys.

Regularization fields are consumed by the network: l1/l2 are added to the
loss over the layer's parameters (``regularization_penalty``), constraints
are projections applied after each update (``apply_constraints``, in
place), ``dropout`` drops the layer's input in train mode
(``apply_layer``). Weight noise is not ported yet: a network training a
layer that sets it raises.

Random draws follow the JAX package's key splitting with integer seeds: a
train step has one seed (``step_seed``, a function of the configuration's
seed and the iteration), the network splits it into one seed a layer or
vertex (``split_seed``) before anything runs, and a layer with input
dropout splits its seed again into the mask's and its own. A mask is drawn
from a generator seeded on the tensor's device, so a segment recomputed in
the backward (remat) draws the same mask. The masks are not the JAX
package's bits (threefry there, Philox or the CPU's Mersenne twister here).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import numpy as np
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


def split_seed(seed, n):
    """``n`` seeds drawn from ``seed`` (the port's ``jax.random.split``):
    numpy's SeedSequence, the same on every host and device."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n, np.uint32)]


def step_seed(seed, iteration):
    """The seed of train step ``iteration`` of a network seeded ``seed``: a
    run resumed from a checkpoint (which carries the iteration) draws what
    the uninterrupted run would have drawn."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 32, int(iteration)]).generate_state(1)[0])


def dropout_mask(seed, x, rate):
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1/(1 - rate), the mask drawn from a generator seeded with
    ``seed`` on x's device."""
    keep = 1.0 - rate
    g = torch.Generator(device=x.device).manual_seed(int(seed))
    u = torch.rand(x.shape, generator=g, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=None)
def takes(cls, arg):
    """Whether ``cls.apply`` has a parameter named ``arg``."""
    return arg in inspect.signature(cls.apply).parameters


def apply_layer(layer, params, state, x, *, train=False, rng=None, **kwargs):
    """``layer.apply`` as a network runs it: in train mode with a seed, the
    input dropped first (``layer.dropout``) from one half of ``rng``, the
    other half passed on to a layer that draws (as the JAX package's
    ``MultiLayerNetwork._apply_layer`` splits its key)."""
    if rng is not None:
        drop, rng = split_seed(rng, 2)
        if train and layer.dropout > 0.0:
            x = dropout_mask(drop, x, layer.dropout)
    if takes(type(layer), "rng"):
        kwargs["rng"] = rng
    return layer.apply(params, state, x, train=train, **kwargs)
