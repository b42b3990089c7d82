"""FusedConvBNVertex: conv (no bias) + batch-norm + optional residual add +
activation as one graph vertex.

It collapses what the unfused graph expresses as ConvolutionLayer ->
BatchNormalization (-> ElementWiseVertex(add) -> ActivationLayer), so the
conv kernel can take the batch-norm statistics in its epilogue
(``ops/conv_stats.py``); ``models/resnet.py`` builds with it under
``fused=True``.

In train mode, for the geometries the kernels cover (``supported``), it
runs ``fused_conv_bn_act``: the Hopper kernel on CUDA tensors, the kernel's
plain version on CPU tensors, both with ``var = max(E[z^2] - mean^2, 0)``
from the kernel's sums. x, W and the residual are cast to the compute dtype
first (bf16 under the mixed policy); statistics and the normalize stay f32.
Elsewhere (eval mode, other geometries) it runs the unfused chain's math
with a library conv: running statistics in eval mode, the two-pass batch
variance in train mode. Running statistics update as ``decay * old +
(1 - decay) * batch`` with the biased batch variance.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn import activations as _acts
from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.graph import GraphVertex
from deeplearning4j_tpu_torch.nn.layers.conv import _conv_out_size, _pair, conv
from deeplearning4j_tpu_torch.ops import conv_stats
from deeplearning4j_tpu_torch.utils import collectives as _collectives
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.serde import register_config


@register_config
@dataclasses.dataclass(frozen=True)
class FusedConvBNVertex(GraphVertex):
    """conv (no bias) + batch-norm + optional residual add + activation.

    Inputs: (x,) or (x, residual) when ``residual=True``; the residual is
    added after the affine, before the activation (the ResNet bottleneck
    tail conv_c -> BN -> add -> relu)."""

    n_out: int = 0
    kernel: tuple = (1, 1)
    stride: tuple = (1, 1)
    padding: str = "same"
    activation: str = "relu"
    residual: bool = False
    eps: float = 1e-5
    decay: float = 0.9
    weight_init: object = "relu"

    def output_type(self, input_types):
        it = input_types[0]
        if not isinstance(it, _inputs.ConvolutionalType):
            raise ValueError(f"FusedConvBNVertex needs CNN input, got {it}")
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        return _inputs.ConvolutionalType(_conv_out_size(it.height, kh, sh, self.padding, 0),
                                         _conv_out_size(it.width, kw, sw, self.padding, 0),
                                         self.n_out)

    def init(self, generator, input_types, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        cin = input_types[0].channels
        dev = generator.device
        return {"W": _init.init_weight(self.weight_init, generator, (kh, kw, cin, self.n_out),
                                       cin * kh * kw, self.n_out * kh * kw, dtype),
                "gamma": torch.ones((self.n_out,), dtype=dtype, device=dev),
                "beta": torch.zeros((self.n_out,), dtype=dtype, device=dev)}

    def init_state(self, input_types, dtype=torch.float32):
        return {"mean": torch.zeros((self.n_out,), dtype=dtype),
                "var": torch.ones((self.n_out,), dtype=dtype)}

    def _update(self, state, mean, var):
        with torch.no_grad():
            return {"mean": self.decay * state["mean"]
                    + (1 - self.decay) * mean.to(state["mean"].dtype),
                    "var": self.decay * state["var"]
                    + (1 - self.decay) * var.to(state["var"].dtype)}

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        x = xs[0]
        r = xs[1] if self.residual else None
        if train and conv_stats.supported(_pair(self.kernel), _pair(self.stride), self.padding,
                                          (1, 1), self.activation, x_shape=x.shape):
            cd, _ = _dtypes.compute_dtypes_for(x.dtype)
            y, mean, var = conv_stats.fused_conv_bn_act(
                x.to(cd), params["W"].to(cd), params["gamma"], params["beta"],
                None if r is None else r.to(cd), _pair(self.stride), self.eps,
                self.activation)
            return y, self._update(state, mean, var)
        z = conv(x, params["W"], stride=_pair(self.stride), padding=self.padding)
        _, ad = _dtypes.compute_dtypes_for(z.dtype)
        zf = z.to(ad)
        axes = (0, 1, 2)
        if train:
            mean, var = _collectives.batch_moments(zf, axes)
            new_state = self._update(state, mean, var)
        else:
            mean, var = state["mean"].to(ad), state["var"].to(ad)
            new_state = state
        ypre = (zf - mean) * torch.rsqrt(var + self.eps) * params["gamma"].to(ad) \
            + params["beta"].to(ad)
        if r is not None:
            ypre = ypre + r.to(ad)
        return _acts.get(self.activation)(ypre).to(z.dtype), new_state
