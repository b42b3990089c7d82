"""Activation catalog: the JAX package's names, as torch functions."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return F.relu6(x)


def leakyrelu(x, alpha=0.01):
    return F.leaky_relu(x, negative_slope=alpha)


def elu(x):
    return F.elu(x)


def selu(x):
    return F.selu(x)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def swish(x):
    return F.silu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def tanh(x):
    return torch.tanh(x)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def rationaltanh(x):
    # 1.7159 * tanh(2x/3) approximation used by ND4J's RationalTanh
    a = torch.abs(2.0 * x / 3.0)
    tanh_approx = torch.sign(x) * (1.0 - 1.0 / (1.0 + a + a * a + 1.41645 * a**4))
    return 1.7159 * tanh_approx


def rectifiedtanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def softmax(x):
    return torch.softmax(x, dim=-1)


def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


def cube(x):
    return x**3


def thresholdedrelu(x, theta=1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def mish(x):
    return x * torch.tanh(F.softplus(x))


_CATALOG = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "swish": swish,
    "silu": swish,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "tanh": tanh,
    "hardtanh": hardtanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softplus": softplus,
    "softsign": softsign,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "cube": cube,
    "thresholdedrelu": thresholdedrelu,
    "mish": mish,
}


def get(name):
    """Resolve an activation by name (or pass a callable through).
    ``("leakyrelu", {"alpha": 0.3})`` binds keyword arguments onto the
    named activation, as in the JAX package."""
    if isinstance(name, (tuple, list)) and name:
        kwargs = dict(name[1]) if len(name) > 1 and name[1] else {}
        return functools.partial(get(name[0]), **kwargs)
    if callable(name):
        return name
    try:
        return _CATALOG[name.lower()]
    except KeyError:
        raise KeyError(f"Unknown activation {name!r}. Known: {sorted(_CATALOG)}") from None


def names():
    return sorted(_CATALOG)
