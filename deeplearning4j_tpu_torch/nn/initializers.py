"""Weight initializer catalog.

The same names and distributions as ``deeplearning4j_tpu/nn/initializers.py``.
Each initializer is ``(generator, shape, fan_in, fan_out, dtype) -> tensor``
and draws from an explicit ``torch.Generator``; tensors are made on the
generator's device. A torch generator and a jax key give different numbers
from the same seed, so parity with the JAX package goes through its weights
(a checkpoint zip, or ``utils.serialization.params_from_numpy``).
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.utils.serde import register_config


def _normal(g, shape, dtype):
    return torch.randn(shape, generator=g, dtype=dtype, device=g.device)


def _uniform(g, shape, dtype, lo, hi):
    u = torch.rand(shape, generator=g, dtype=dtype, device=g.device)
    return lo + (hi - lo) * u


def zero(g, shape, fan_in, fan_out, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=g.device)


def ones(g, shape, fan_in, fan_out, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=g.device)


def normal(g, shape, fan_in, fan_out, dtype=torch.float32):
    # ND4J NORMAL: N(0, 1/sqrt(fan_in))
    return _normal(g, shape, dtype) / fan_in ** 0.5


def uniform(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (3.0 / fan_in) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def xavier(g, shape, fan_in, fan_out, dtype=torch.float32):
    return (2.0 / (fan_in + fan_out)) ** 0.5 * _normal(g, shape, dtype)


def xavier_uniform(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def xavier_fan_in(g, shape, fan_in, fan_out, dtype=torch.float32):
    return _normal(g, shape, dtype) / fan_in ** 0.5


def relu_init(g, shape, fan_in, fan_out, dtype=torch.float32):
    # He normal: N(0, 2/fan_in)
    return (2.0 / fan_in) ** 0.5 * _normal(g, shape, dtype)


def relu_uniform(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (6.0 / fan_in) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def lecun_normal(g, shape, fan_in, fan_out, dtype=torch.float32):
    return (1.0 / fan_in) ** 0.5 * _normal(g, shape, dtype)


def lecun_uniform(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (3.0 / fan_in) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def sigmoid_uniform(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = 4.0 * (6.0 / (fan_in + fan_out)) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def identity_init(g, shape, fan_in, fan_out, dtype=torch.float32):
    if len(shape) == 2 and shape[0] == shape[1]:
        return torch.eye(shape[0], dtype=dtype, device=g.device)
    raise ValueError(f"IDENTITY init requires a square 2-D shape, got {shape}")


def var_scaling_normal_fan_in(g, shape, fan_in, fan_out, dtype=torch.float32):
    return (1.0 / fan_in) ** 0.5 * _normal(g, shape, dtype)


def var_scaling_normal_fan_out(g, shape, fan_in, fan_out, dtype=torch.float32):
    return (1.0 / fan_out) ** 0.5 * _normal(g, shape, dtype)


def var_scaling_normal_fan_avg(g, shape, fan_in, fan_out, dtype=torch.float32):
    return (2.0 / (fan_in + fan_out)) ** 0.5 * _normal(g, shape, dtype)


def var_scaling_uniform_fan_in(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (3.0 / fan_in) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def var_scaling_uniform_fan_out(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (3.0 / fan_out) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


def var_scaling_uniform_fan_avg(g, shape, fan_in, fan_out, dtype=torch.float32):
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return _uniform(g, shape, dtype, -a, a)


_CATALOG = {
    "zero": zero,
    "ones": ones,
    "normal": normal,
    "uniform": uniform,
    "xavier": xavier,
    "xavier_uniform": xavier_uniform,
    "xavier_fan_in": xavier_fan_in,
    "relu": relu_init,
    "relu_uniform": relu_uniform,
    "lecun_normal": lecun_normal,
    "lecun_uniform": lecun_uniform,
    "sigmoid_uniform": sigmoid_uniform,
    "identity": identity_init,
    "var_scaling_normal_fan_in": var_scaling_normal_fan_in,
    "var_scaling_normal_fan_out": var_scaling_normal_fan_out,
    "var_scaling_normal_fan_avg": var_scaling_normal_fan_avg,
    "var_scaling_uniform_fan_in": var_scaling_uniform_fan_in,
    "var_scaling_uniform_fan_out": var_scaling_uniform_fan_out,
    "var_scaling_uniform_fan_avg": var_scaling_uniform_fan_avg,
}


@register_config
@dataclasses.dataclass(frozen=True)
class Distribution:
    """Explicit-distribution init (reference: WeightInit.DISTRIBUTION)."""

    kind: str = "normal"  # normal | uniform | constant | truncated_normal | orthogonal
    mean: float = 0.0
    std: float = 1.0
    lower: float = -1.0
    upper: float = 1.0
    value: float = 0.0
    gain: float = 1.0

    def sample(self, g, shape, dtype=torch.float32):
        if self.kind == "normal":
            return self.mean + self.std * _normal(g, shape, dtype)
        if self.kind == "uniform":
            return _uniform(g, shape, dtype, self.lower, self.upper)
        if self.kind == "constant":
            return torch.full(shape, self.value, dtype=dtype, device=g.device)
        if self.kind == "truncated_normal":
            t = torch.empty(shape, dtype=dtype, device=g.device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            return self.mean + self.std * t
        if self.kind == "orthogonal":
            t = torch.empty(shape, dtype=dtype, device=g.device)
            return torch.nn.init.orthogonal_(t, gain=self.gain, generator=g)
        raise ValueError(f"Unknown distribution kind {self.kind!r}")


def init_weight(name_or_dist, generator, shape, fan_in, fan_out, dtype=torch.float32):
    """Initialize a weight tensor by catalog name or explicit Distribution."""
    if isinstance(name_or_dist, Distribution):
        return name_or_dist.sample(generator, shape, dtype)
    fn = _CATALOG.get(str(name_or_dist).lower())
    if fn is None:
        raise KeyError(f"Unknown weight init {name_or_dist!r}. Known: {sorted(_CATALOG)}")
    return fn(generator, shape, fan_in, fan_out, dtype)


def names():
    return sorted(_CATALOG)
