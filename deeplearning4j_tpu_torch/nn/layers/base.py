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
place), ``dropout`` drops the layer's input in train mode and
``weight_noise`` (``nn/weightnoise.py``) perturbs the layer's parameters
before ``apply`` in train mode (``apply_layer``).

Random draws follow the JAX package's key splitting with seeds: a train
step has one seed (``step_seed``, a function of the configuration's seed
and the iteration), the network splits it into one seed a layer or vertex
(``split_seed``) before anything runs, and a layer with input dropout or
weight noise splits its seed again. A seed is a Python int or a 0-d int64
tensor holding the same value: the draws are counter-based (a 32-bit
integer hash of the seed and each element's index, ``uniform`` and
``normal``), written in plain tensor ops, so the same seed gives the same
bits from a Python int on the host and from a tensor computed on the card
inside a captured CUDA graph (``nn/fused.py``, where the step's seed
follows the iteration on the device). A segment recomputed in the
backward (remat) draws the same mask. The masks are not the JAX package's
bits (threefry there).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.utils import collectives as _collectives


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


_M32 = 0xFFFFFFFF


def _mul32(x, m):
    """``x * m`` mod 2^32 for ``x`` in [0, 2^32) and a constant ``m``, in
    16-bit halves so an int64 tensor never overflows."""
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A bijective 32-bit integer hash (Wellons' lowbias32 constants), the
    same on Python ints and int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x735A2D97)
    return x ^ (x >> 15)


def _combine(seed, i):
    """The seed of stream ``i`` of ``seed`` (ints or tensors)."""
    return _mix32(_mix32(seed) ^ ((_mul32(i & _M32, 0x9E3779B9) + 0x7F4A7C15) & _M32))


def _as_seed(seed):
    return seed if torch.is_tensor(seed) else int(seed) & _M32


def split_seed(seed, n):
    """``n`` seeds drawn from ``seed`` (the port's ``jax.random.split``).
    A Python int gives a list of ints; a 0-d tensor a list of 0-d tensors
    with the same values, computed on its device in one pass."""
    seed = _as_seed(seed)
    if torch.is_tensor(seed):
        return list(_combine(seed, torch.arange(n, dtype=torch.int64, device=seed.device)))
    return [_combine(seed, i) for i in range(n)]


def step_seed(seed, iteration):
    """The seed of train step ``iteration`` of a network seeded ``seed``: a
    run resumed from a checkpoint (which carries the iteration) draws what
    the uninterrupted run would have drawn. ``iteration`` may be a 0-d
    int64 tensor (the K-step engine's counter on the device)."""
    it = iteration & _M32 if torch.is_tensor(iteration) else int(iteration) & _M32
    return _combine(_mix32(int(seed) & _M32), it)


def _bits(seed, shape, device, stream=0, offset=0):
    """[*shape] int64 of 32 random bits each: the hash of each element's
    index (plus ``offset``) under ``seed`` (stream ``stream`` of it).
    ``offset`` may instead be an int64 tensor of ``shape``: each element's
    own index (``slice_offsets``)."""
    seed = _as_seed(seed)
    k1, k2 = _combine(seed, 2 * stream + 1), _combine(seed, 2 * stream + 2)
    n = 1
    for d in shape:
        n *= int(d)
    if torch.is_tensor(offset):
        idx = offset.reshape(-1)
    else:
        idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return _mix32(_mix32((idx + k1) & _M32) ^ k2).reshape(tuple(shape))


def slice_offsets(whole_shape, dim, start, length, device):
    """[*slice] int64: the flat index in a tensor of ``whole_shape`` of each
    element of its slice ``[start, start + length)`` on ``dim``, to draw a
    slice what the whole tensor draws there (a tensor-parallel rank's part
    of a parameter)."""
    shape = list(whole_shape)
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        lo, n = (start, length) if d == dim else (0, shape[d])
        view = [1] * len(shape)
        view[d] = n
        idx = idx + torch.arange(lo, lo + n, dtype=torch.int64, device=device).view(view) * stride
        stride *= shape[d]
    return idx


def uniform(seed, shape, device, offset=0):
    """[*shape] float32 uniform on [0, 1) in steps of 2^-24, from ``seed``;
    ``offset`` is the flat index of the first element (a rank's rows of a
    global batch, ``utils/collectives.row_offset``) or a tensor of each
    element's index (``slice_offsets``)."""
    return (_bits(seed, shape, device, offset=offset) >> 8).to(torch.float32) * (2.0 ** -24)


def normal(seed, shape, device, offset=0):
    """[*shape] float32 standard normal from ``seed`` (Box-Muller on two
    uniform streams); ``offset`` as in ``uniform``."""
    u1 = ((_bits(seed, shape, device, 0, offset) >> 8) + 1).to(torch.float32) * (2.0 ** -24)
    u2 = (_bits(seed, shape, device, 1, offset) >> 8).to(torch.float32) * (2.0 ** -24)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * np.pi) * u2)


def dropout_mask(seed, x, rate, offset=0):
    """Inverted dropout: each element kept with probability 1 - rate and
    scaled by 1/(1 - rate), the mask drawn from ``seed``; ``offset`` as in
    ``uniform``."""
    keep = 1.0 - rate
    u = uniform(seed, x.shape, x.device, offset)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@functools.lru_cache(maxsize=None)
def takes(cls, arg):
    """Whether ``cls.apply`` has a parameter named ``arg``."""
    return arg in inspect.signature(cls.apply).parameters


def apply_layer(layer, params, state, x, *, train=False, rng=None, tp_split=None, **kwargs):
    """``layer.apply`` as a network runs it: in train mode with a seed, the
    input dropped first (``layer.dropout``) from one half of ``rng``, the
    other half passed on to a layer that draws (as the JAX package's
    ``MultiLayerNetwork._apply_layer`` splits its key), after the weight
    noise (``layer.weight_noise``) has perturbed ``params`` from a split of
    that half. Gradients flow through the perturbed parameters.

    A layer whose parameters are split over the active model group runs
    through the group's tensor-parallel application; ``tp_split`` ({key:
    dim}) names the split leaves where ``params`` are not the stored
    tensors (a streamed block's gathered slices). Weight noise draws each
    split leaf's slice at the whole parameter's element indices, so the
    split step applies the noise the whole step applies."""
    takes_rng = takes(type(layer), "rng")
    mg = _collectives.active_model()
    split = {} if mg is None else (tp_split if tp_split is not None else mg.split_of(params))
    if rng is not None:
        drop_in = train and layer.dropout > 0.0
        noise = getattr(layer, "weight_noise", None) if train and len(params) else None
        if drop_in or noise is not None or takes_rng:
            drop, rng = split_seed(rng, 2)
            if drop_in:
                x = dropout_mask(drop, x, layer.dropout, _collectives.row_offset(x))
            if noise is not None:
                rng, noise_seed = split_seed(rng, 2)
                params = noise.perturb(noise_seed, layer, params,
                                       offsets=_split_offsets(params, split, mg))
    if takes_rng:
        kwargs["rng"] = rng
    if split:
        return mg.apply(layer, params, state, x, mg, split=split, train=train, **kwargs)
    return layer.apply(params, state, x, train=train, **kwargs)


def _split_offsets(params, split, mg):
    """{key: slice_offsets} of each leaf split over ``mg``: this rank's
    slice within the whole parameter."""
    out = {}
    for k, d in split.items():
        t = params[k]
        whole = list(t.shape)
        whole[d] *= mg.world
        out[k] = slice_offsets(whole, d, mg.rank * t.shape[d], t.shape[d], t.device)
    return out
