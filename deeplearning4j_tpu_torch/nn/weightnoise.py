"""Weight noise: parameters perturbed in train-mode forward passes.

The port of ``deeplearning4j_tpu/nn/weightnoise.py`` (reference:
nn/conf/weightnoise/ — WeightNoise, DropConnect), the same classes and
fields, so a ``config.json`` naming them loads in either package. The
network perturbs a layer's parameters before ``apply`` in train mode
(``nn/layers/base.py apply_layer``) and the gradient flows through the
perturbed weights; inference and frozen layers see the weights as they
are. Both network kinds apply it: a graph's layer vertices as the
sequential stack's layers (DL4J applies it in graphs; the JAX package's
ComputationGraph does not read the field).

The draws are the port's counter-based ones (``base.uniform`` and
``base.normal``, keyed by the layer's seed and then one seed a parameter),
so they are the same from a seed given as a Python int and from one
computed on the card inside a captured CUDA graph; they are not the JAX
package's threefry bits.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.initializers import Distribution
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.utils.serde import register_config


def _sample(dist, seed, shape, device, dtype, offset=0):
    """``dist`` drawn from ``seed`` with the counter-based draws (``offset``
    as in ``base.uniform``)."""
    if dist.kind == "normal":
        z = _base.normal(seed, shape, device, offset)
        return (dist.mean + dist.std * z).to(dtype)
    if dist.kind == "uniform":
        u = _base.uniform(seed, shape, device, offset)
        return (dist.lower + (dist.upper - dist.lower) * u).to(dtype)
    if dist.kind == "constant":
        return torch.full(tuple(shape), dist.value, dtype=dtype, device=device)
    if dist.kind == "truncated_normal":
        # inverse CDF over the [-2, 2] band: Phi(-2) + u (Phi(2) - Phi(-2))
        lo = 0.022750131948179195
        u = _base.uniform(seed, shape, device, offset).double()
        z = torch.special.ndtri(lo + u * (1.0 - 2.0 * lo)).to(torch.float32)
        return (dist.mean + dist.std * z).to(dtype)
    raise ValueError(f"weight noise cannot draw from a {dist.kind!r} distribution")


def _perturbed(layer, params, seed, apply_to_bias, fn, offsets):
    """``params`` with ``fn(seed_i, value, offset)`` in place of each weight
    (and each bias with ``apply_to_bias``); one seed a parameter, in key
    order; ``offsets`` {key: element indices} for a leaf that is a slice of
    its parameter (tensor parallelism), else 0."""
    bias_keys = getattr(layer, "BIAS_KEYS", ("b",))
    offsets = offsets or {}
    out = {}
    for k, sub in zip(params.keys(), _base.split_seed(seed, len(params))):
        v = params[k]
        out[k] = v if k in bias_keys and not apply_to_bias else fn(sub, v, offsets.get(k, 0))
    return out


@register_config
@dataclasses.dataclass(frozen=True)
class WeightNoise:
    """Additive (``w + n``) or multiplicative (``w * n``) noise ``n`` from
    ``distribution`` (reference: WeightNoise.java)."""

    distribution: Distribution = dataclasses.field(
        default_factory=lambda: Distribution(kind="normal", mean=0.0, std=0.01))
    additive: bool = True
    apply_to_bias: bool = False

    def perturb(self, seed, layer, params, offsets=None):
        def noisy(s, v, off):
            n = _sample(self.distribution, s, v.shape, v.device, v.dtype, off)
            return v + n if self.additive else v * n
        return _perturbed(layer, params, seed, self.apply_to_bias, noisy, offsets)


@register_config
@dataclasses.dataclass(frozen=True)
class DropConnect:
    """Per-weight Bernoulli dropout with inverted scaling: each weight kept
    with probability ``weight_retain_prob`` and scaled by its inverse
    (reference: DropConnect.java); biases kept unless ``apply_to_bias``."""

    weight_retain_prob: float = 0.5
    apply_to_bias: bool = False

    def perturb(self, seed, layer, params, offsets=None):
        rate = 1.0 - self.weight_retain_prob
        return _perturbed(layer, params, seed, self.apply_to_bias,
                          lambda s, v, off: _base.dropout_mask(s, v, rate, off), offsets)
