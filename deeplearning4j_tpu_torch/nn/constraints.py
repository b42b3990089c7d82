"""Parameter constraints: projections applied after each update.

The configs of ``deeplearning4j_tpu/nn/constraints.py`` (DL4J's
MaxNorm, MinMaxNorm, NonNegative and UnitNorm constraints), with the same
math. The port updates parameters in place, so ``apply`` projects the
layer's tensors in place under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.utils.serde import register_config


def _param_keys(layer, params, apply_to):
    if apply_to == "weights":
        return [k for k in params if k in getattr(layer, "WEIGHT_KEYS", ("W",))]
    if apply_to == "biases":
        return [k for k in params if k in getattr(layer, "BIAS_KEYS", ("b",))]
    return list(params)


def _col_norms(w):
    """L2 norm per output unit (last axis)."""
    sq = w * w
    if w.dim() > 1:  # torch sums every axis for dim=(), jnp none
        sq = sq.sum(dim=tuple(range(w.dim() - 1)), keepdim=True)
    return torch.sqrt(sq + 1e-12)


@register_config
@dataclasses.dataclass(frozen=True)
class MaxNormConstraint:
    max_norm: float = 2.0
    apply_to: str = "weights"

    @torch.no_grad()
    def apply(self, layer, params, iteration, epoch):
        for k in _param_keys(layer, params, self.apply_to):
            w = params[k]
            w.mul_((self.max_norm / _col_norms(w)).clamp_max(1.0))
        return params


@register_config
@dataclasses.dataclass(frozen=True)
class MinMaxNormConstraint:
    min_norm: float = 0.0
    max_norm: float = 2.0
    rate: float = 1.0
    apply_to: str = "weights"

    @torch.no_grad()
    def apply(self, layer, params, iteration, epoch):
        for k in _param_keys(layer, params, self.apply_to):
            w = params[k]
            norms = _col_norms(w)
            target = self.rate * norms.clamp(self.min_norm, self.max_norm) \
                + (1 - self.rate) * norms
            w.mul_(target / norms)
        return params


@register_config
@dataclasses.dataclass(frozen=True)
class NonNegativeConstraint:
    apply_to: str = "all"

    @torch.no_grad()
    def apply(self, layer, params, iteration, epoch):
        for k in _param_keys(layer, params, self.apply_to):
            params[k].clamp_min_(0.0)
        return params


@register_config
@dataclasses.dataclass(frozen=True)
class UnitNormConstraint:
    apply_to: str = "weights"

    @torch.no_grad()
    def apply(self, layer, params, iteration, epoch):
        for k in _param_keys(layer, params, self.apply_to):
            params[k].div_(_col_norms(params[k]))
        return params
