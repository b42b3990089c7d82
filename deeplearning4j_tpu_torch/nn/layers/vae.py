"""Variational autoencoder layer and its reconstruction distributions.

The port of ``deeplearning4j_tpu/nn/layers/vae.py`` (reference:
VariationalAutoencoder.java and the ReconstructionDistribution SPI). An
encoder MLP gives the mean and log-variance of q(z|x); a sample
z = mean + exp(logvar / 2) * eps goes through the decoder MLP to the
parameters of the reconstruction distribution. Inside a network the layer
outputs the posterior mean. ``pretrain_loss`` is the -ELBO,
-E[log p(x|z)] + KL(q(z|x) || N(0, I)), averaged over the batch; autograd
gives its gradients.

Distributions: ``param_size`` (the decoder's output width), ``log_prob``,
``mean`` and ``sample``; ``"gaussian"``, ``"bernoulli"`` and
``"exponential"`` are shorthands (``resolve_distribution``). The
Bernoulli's probabilities are the activation clipped to [1e-7, 1 - 1e-7]
before the logs, as in the JAX package: that is not
``binary_cross_entropy_with_logits``, whose gradient differs where the
clip bites.

Random draws come from a ``torch.Generator`` on the input's device
(``rng``). The JAX package draws threefry bits, so parity with it goes
through the explicit ``eps`` arguments: one standard-normal tensor shaped
as the latent mean for each sample.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import ParamLayer
from deeplearning4j_tpu_torch.nn.layers.core import matmul
from deeplearning4j_tpu_torch.utils.serde import register_config


def _randn(rng, like):
    return torch.randn(like.shape, generator=rng, dtype=like.dtype, device=like.device)


@register_config
@dataclasses.dataclass(frozen=True)
class GaussianReconstruction:
    """p(x|z) = N(mean, diag(var)); the decoder emits [mean | logvar] and
    the activation applies to the mean half only."""

    activation: str = "identity"

    def param_size(self, n):
        return 2 * n

    def _split(self, pre):
        n = pre.shape[-1] // 2
        return _act.get(self.activation)(pre[..., :n]), pre[..., n:]

    def log_prob(self, pre, x):
        mean, logvar = self._split(pre)
        return -0.5 * torch.sum(logvar + (x - mean) ** 2 / torch.exp(logvar)
                                + math.log(2 * math.pi), dim=-1)

    def mean(self, pre):
        return self._split(pre)[0]

    def sample(self, pre, rng):
        mean, logvar = self._split(pre)
        return mean + torch.exp(0.5 * logvar) * _randn(rng, mean)


@register_config
@dataclasses.dataclass(frozen=True)
class BernoulliReconstruction:
    """p(x|z) = prod Bernoulli(p), p the activation (sigmoid) of the
    decoder's output, clipped to [1e-7, 1 - 1e-7]."""

    activation: str = "sigmoid"

    def param_size(self, n):
        return n

    def _p(self, pre):
        return torch.clamp(_act.get(self.activation)(pre), 1e-7, 1.0 - 1e-7)

    def log_prob(self, pre, x):
        p = self._p(pre)
        return torch.sum(x * torch.log(p) + (1.0 - x) * torch.log(1.0 - p), dim=-1)

    def mean(self, pre):
        return self._p(pre)

    def sample(self, pre, rng):
        return torch.bernoulli(self._p(pre), generator=rng)


@register_config
@dataclasses.dataclass(frozen=True)
class ExponentialReconstruction:
    """p(x|z) = lambda exp(-lambda x) with lambda = exp(activation(pre)):
    log p = gamma - lambda x."""

    activation: str = "identity"

    def param_size(self, n):
        return n

    def log_prob(self, pre, x):
        gamma = _act.get(self.activation)(pre)
        return torch.sum(gamma - torch.exp(gamma) * x, dim=-1)

    def mean(self, pre):
        return torch.exp(-_act.get(self.activation)(pre))  # E[x] = 1/lambda

    def sample(self, pre, rng):
        gamma = _act.get(self.activation)(pre)
        u = torch.rand(gamma.shape, generator=rng, dtype=gamma.dtype, device=gamma.device)
        u = 1e-7 + (1.0 - 2e-7) * u
        return -torch.log1p(-u) * torch.exp(-gamma)  # the inverse CDF


@register_config
@dataclasses.dataclass(frozen=True)
class LossWrapperReconstruction:
    """A loss function as the distribution (reference: LossFunctionWrapper):
    log_prob is minus the per-example loss times the feature count, so the
    term sums over features as the others do."""

    loss: str = "mse"
    activation: str = "identity"

    def param_size(self, n):
        return n

    def _out(self, pre):
        return _act.get(self.activation)(pre)

    def log_prob(self, pre, x):
        fn = _losses.get(self.loss)
        per = torch.func.vmap(lambda o, t: fn(o[None], t[None]))(self._out(pre), x)
        return -per * x.shape[-1]

    def mean(self, pre):
        return self._out(pre)

    def sample(self, pre, rng):
        return self._out(pre)  # a loss has no sampler


@register_config
@dataclasses.dataclass(frozen=True)
class CompositeReconstruction:
    """Different distributions over slices of the features: ``parts`` is a
    tuple of (feature count, distribution) pairs covering the input."""

    parts: tuple = ()

    def __post_init__(self):
        # serde rebuilds nested pairs as lists: keep the dataclass hashable
        object.__setattr__(self, "parts", tuple((int(sz), d) for sz, d in self.parts))

    def param_size(self, n):
        total = sum(sz for sz, _ in self.parts)
        if total != n:
            raise ValueError(f"composite covers {total} features, input has {n}")
        return sum(d.param_size(sz) for sz, d in self.parts)

    def _slices(self):
        x_off = p_off = 0
        for sz, d in self.parts:
            yield d, (x_off, x_off + sz), (p_off, p_off + d.param_size(sz))
            x_off += sz
            p_off += d.param_size(sz)

    def log_prob(self, pre, x):
        total = 0.0
        for d, (x0, x1), (p0, p1) in self._slices():
            total = total + d.log_prob(pre[..., p0:p1], x[..., x0:x1])
        return total

    def mean(self, pre):
        return torch.cat([d.mean(pre[..., p0:p1]) for d, _, (p0, p1) in self._slices()], dim=-1)

    def sample(self, pre, rng):
        return torch.cat([d.sample(pre[..., p0:p1], rng) for d, _, (p0, p1) in self._slices()],
                         dim=-1)


_DIST_SHORTHAND = {
    "gaussian": GaussianReconstruction,
    "bernoulli": BernoulliReconstruction,
    "exponential": ExponentialReconstruction,
}


def resolve_distribution(spec):
    """A shorthand string or a distribution instance -> the instance."""
    if isinstance(spec, str):
        try:
            return _DIST_SHORTHAND[spec]()
        except KeyError:
            raise ValueError(f"unknown reconstruction {spec!r}; use one of "
                             f"{sorted(_DIST_SHORTHAND)} or a distribution instance") from None
    if isinstance(spec, (list, tuple)):  # serde round-trip of composites
        return CompositeReconstruction(parts=tuple(
            (int(sz), resolve_distribution(d)) for sz, d in spec))
    return spec


@register_config
@dataclasses.dataclass(frozen=True)
class VariationalAutoencoder(ParamLayer):
    n_latent: int = 2
    encoder_layer_sizes: tuple = (64,)
    decoder_layer_sizes: tuple = (64,)
    # "gaussian" | "bernoulli" | "exponential" | a distribution instance
    reconstruction: object = "gaussian"
    num_samples: int = 1
    activation: object = dataclasses.field(default="relu", kw_only=True)

    input_family = _inputs.FeedForwardType

    @property
    def dist(self):
        return resolve_distribution(self.reconstruction)

    def output_type(self, input_type):
        return _inputs.FeedForwardType(self.n_latent)

    def init(self, generator, input_type, dtype=torch.float32):
        n_in = _inputs.adapted_type(input_type, _inputs.FeedForwardType).size
        p = {}

        def dense(name, a, b):
            p[f"{name}_W"] = _init.init_weight(self.weight_init, generator, (a, b), a, b, dtype)
            p[f"{name}_b"] = torch.zeros((b,), dtype=dtype, device=generator.device)

        sizes = [n_in, *self.encoder_layer_sizes]
        for i in range(len(sizes) - 1):
            dense(f"enc{i}", sizes[i], sizes[i + 1])
        dense("z_mean", sizes[-1], self.n_latent)
        dense("z_logvar", sizes[-1], self.n_latent)
        dsizes = [self.n_latent, *self.decoder_layer_sizes]
        for i in range(len(dsizes) - 1):
            dense(f"dec{i}", dsizes[i], dsizes[i + 1])
        dense("x_out", dsizes[-1], self.dist.param_size(n_in))
        return p

    def _mlp(self, params, prefix, n, h):
        act = self.activation_fn()
        for i in range(n):
            h = act(matmul(h, params[f"{prefix}{i}_W"]) + params[f"{prefix}{i}_b"])
        return h

    def encode(self, params, x):
        """(mean, logvar) of q(z|x)."""
        h = self._mlp(params, "enc", len(self.encoder_layer_sizes), x)
        mean = matmul(h, params["z_mean_W"]) + params["z_mean_b"]
        logvar = matmul(h, params["z_logvar_W"]) + params["z_logvar_b"]
        return mean, logvar

    def decode(self, params, z):
        """The distribution's parameters (pre-activation) at latent ``z``."""
        h = self._mlp(params, "dec", len(self.decoder_layer_sizes), z)
        return matmul(h, params["x_out_W"]) + params["x_out_b"]

    def apply(self, params, state, x, *, train=False):
        mean, _ = self.encode(params, x)
        return mean, state

    def _sample_z(self, mean, logvar, rng, eps):
        if eps is None:
            if rng is None:
                return mean
            eps = _randn(rng, mean)
        return mean + torch.exp(0.5 * logvar) * eps

    def reconstruct(self, params, x, rng=None, *, eps=None):
        """The distribution's mean at z = the posterior mean, or at a sample
        (from ``rng``, or ``eps`` given)."""
        mean, logvar = self.encode(params, x)
        return self.dist.mean(self.decode(params, self._sample_z(mean, logvar, rng, eps)))

    def generate_at_mean(self, params, z):
        """Decode latent points to the distribution's mean (reference:
        generateAtMeanGivenZ)."""
        return self.dist.mean(self.decode(params, z))

    def generate_random(self, params, z, rng):
        """Decode latent points and sample the distribution (reference:
        generateRandomGivenZ)."""
        return self.dist.sample(self.decode(params, z), rng)

    def pretrain_loss(self, params, x, rng=None, *, eps=None):
        """-ELBO averaged over the batch, over ``num_samples`` draws of z
        (``eps``: a sequence of that many standard-normal tensors); with
        neither ``rng`` nor ``eps``, z is the posterior mean."""
        dist = self.dist
        mean, logvar = self.encode(params, x)
        kl = 0.5 * torch.sum(torch.exp(logvar) + mean ** 2 - 1.0 - logvar, dim=-1)
        rec = 0.0
        for s in range(self.num_samples):
            z = self._sample_z(mean, logvar, rng, None if eps is None else eps[s])
            rec = rec + dist.log_prob(self.decode(params, z), x)
        rec = rec / self.num_samples
        return torch.mean(kl - rec)

    def reconstruction_probability(self, params, x, rng=None, num_samples=8, *, eps=None):
        """Monte-Carlo estimate of log p(x) for anomaly scoring (reference:
        reconstructionProbability): the log-mean-exp over ``num_samples``
        draws of log p(x|z)."""
        dist = self.dist
        mean, logvar = self.encode(params, x)
        total = None
        for s in range(num_samples):
            e = _randn(rng, mean) if eps is None else eps[s]
            ll = dist.log_prob(self.decode(params, mean + torch.exp(0.5 * logvar) * e), x)
            total = ll if total is None else torch.logaddexp(total, ll)
        return total - math.log(float(num_samples))
