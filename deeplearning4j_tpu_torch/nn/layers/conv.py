"""Convolutional layers: ConvolutionLayer, SubsamplingLayer,
BatchNormalization and GlobalPoolingLayer.

Activations stay logically NHWC and kernels HWIO, as in the JAX package, so
parameters and checkpoints need no transpose. A library convolution gets an
NCHW view of the NHWC tensor (channels-last strides, no copy) and the
kernel as an OIHW view. Padding follows XLA: "same" pads
``max((out - 1) * stride + k - in, 0)`` with the extra pad at the high end
(a 7x7 stride-2 conv on 224 pads (2, 3), a 3x3 stride-2 pool on 112 pads
(0, 1)), so an asymmetric pad is applied explicitly; torch's own
``padding=`` is symmetric. Max pooling pads with -inf, the others with 0
(an average divides by the full window, pads included). BatchNormalization
updates its running variance with the biased batch variance,
``decay * old + (1 - decay) * batch``; torch's ``F.batch_norm`` would take
the unbiased one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.serde import register_config


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out_size(size, kernel, stride, pad_mode, pad):
    if pad_mode == "same":
        return -(-size // stride)
    if pad_mode == "valid":
        return (size - kernel) // stride + 1
    return (size + 2 * pad - kernel) // stride + 1


def _explicit_padding(pad_mode, pad_hw, size_hw, kernel_hw, stride_hw):
    """((lo, hi), (lo, hi)) of the two spatial axes: XLA's SAME (extra pad
    high), VALID (none) or the explicit symmetric ``pad_hw``."""
    if pad_mode == "valid":
        return (0, 0), (0, 0)
    if pad_mode == "same":
        out = []
        for size, k, s in zip(size_hw, kernel_hw, stride_hw):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    ph, pw = pad_hw
    return (ph, ph), (pw, pw)


def _nchw_padded(x, pads, value=0.0):
    """The NCHW view of NHWC ``x`` and the symmetric padding left for the
    library call: an asymmetric pad is applied here with ``value``."""
    xn = x.permute(0, 3, 1, 2)
    (hl, hh), (wl, wh) = pads
    if (hl, wl) == (hh, wh):
        return xn, (hl, wl)
    return F.pad(xn, (wl, wh, hl, hh), value=value), (0, 0)


def conv(x, w, *, stride=(1, 1), padding="valid", pad=(0, 0), dilation=(1, 1)):
    """Policy-aware 2-D convolution of NHWC ``x`` with HWIO ``w`` (the JAX
    package's ``conv``): operands in the compute dtype; under mixed
    precision (bf16 compute, f32 accumulation) the result stays in bf16, as
    the JAX package computes bf16 -> bf16, else it comes back in the
    accumulation dtype."""
    cd, ad = _dtypes.compute_dtypes_for(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    dh, dw = _pair(dilation)
    keff = (kh + (kh - 1) * (dh - 1), kw + (kw - 1) * (dw - 1))
    pads = _explicit_padding(padding, _pair(pad), x.shape[1:3], keff, _pair(stride))
    xn, sym = _nchw_padded(x.to(cd), pads)
    z = F.conv2d(xn, w.to(cd).permute(3, 2, 0, 1), stride=_pair(stride), padding=sym,
                 dilation=(dh, dw))
    z = z.permute(0, 2, 3, 1)
    return z if cd != ad else z.to(ad)


@register_config
@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(ParamLayer):
    """2-D convolution. Kernel layout HWIO; params: W [kh,kw,cin,cout], b [cout]."""

    n_out: int = 0  # number of filters
    kernel: tuple = (3, 3)
    stride: tuple = (1, 1)
    padding: str = "valid"  # "same" | "valid" | "explicit"
    pad: tuple = (0, 0)
    dilation: tuple = (1, 1)
    has_bias: bool = True
    weight_init: object = dataclasses.field(default="relu", kw_only=True)

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        if not isinstance(input_type, _inputs.ConvolutionalType):
            raise ValueError(f"{type(self).__name__} needs CNN input, got {input_type}")
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.pad)
        dh, dw = _pair(self.dilation)
        h = _conv_out_size(input_type.height, kh + (kh - 1) * (dh - 1), sh, self.padding, ph)
        w = _conv_out_size(input_type.width, kw + (kw - 1) * (dw - 1), sw, self.padding, pw)
        return _inputs.ConvolutionalType(h, w, self.n_out)

    def init(self, generator, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        cin = input_type.channels
        p = {"W": _init.init_weight(self.weight_init, generator, (kh, kw, cin, self.n_out),
                                    cin * kh * kw, self.n_out * kh * kw, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        z = conv(x, params["W"], stride=_pair(self.stride), padding=self.padding,
                 pad=_pair(self.pad), dilation=_pair(self.dilation))
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    """Pooling: max | avg | sum | pnorm (``(sum |x|^p)^(1/p)``)."""

    kernel: tuple = (2, 2)
    stride: tuple = (2, 2)
    padding: str = "valid"
    pad: tuple = (0, 0)
    mode: str = "max"  # max | avg | sum | pnorm
    pnorm: int = 2

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.pad)
        h = _conv_out_size(input_type.height, kh, sh, self.padding, ph)
        w = _conv_out_size(input_type.width, kw, sw, self.padding, pw)
        return _inputs.ConvolutionalType(h, w, input_type.channels)

    def apply(self, params, state, x, *, train=False):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        pads = _explicit_padding(self.padding, _pair(self.pad), x.shape[1:3], (kh, kw), (sh, sw))
        (hl, hh), (wl, wh) = pads
        xn = x.permute(0, 3, 1, 2)
        if self.mode == "max":
            xn = F.pad(xn, (wl, wh, hl, hh), value=float("-inf"))
            y = F.max_pool2d(xn, (kh, kw), (sh, sw))
        elif self.mode in ("avg", "sum", "pnorm"):
            if self.mode == "pnorm":
                p = float(self.pnorm)
                xn = xn.abs() ** p
            xn = F.pad(xn, (wl, wh, hl, hh))
            y = F.avg_pool2d(xn, (kh, kw), (sh, sw), divisor_override=1)
            if self.mode == "avg":
                y = y / (kh * kw)
            elif self.mode == "pnorm":
                y = y ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling mode {self.mode!r}")
        return y.permute(0, 2, 3, 1), state


@register_config
@dataclasses.dataclass(frozen=True)
class BatchNormalization(ParamLayer):
    """Batch normalization over the channel/feature axis (the last one).
    ``decay`` is the running-average momentum (default 0.9); state holds
    the running mean and (biased) variance used at inference."""

    decay: float = 0.9
    eps: float = 1e-5
    use_gamma_beta: bool = True  # reference: lockGammaBeta inverts this
    activation: object = dataclasses.field(default="identity", kw_only=True)

    input_family = None  # works on FF [B,F], RNN [B,T,F] and CNN [B,H,W,C]

    def _nfeat(self, input_type):
        if isinstance(input_type, _inputs.ConvolutionalType):
            return input_type.channels
        return input_type.size

    def output_type(self, input_type):
        return input_type

    def init(self, generator, input_type, dtype=torch.float32):
        n = self._nfeat(input_type)
        if not self.use_gamma_beta:
            return {}
        return {"gamma": torch.ones((n,), dtype=dtype, device=generator.device),
                "beta": torch.zeros((n,), dtype=dtype, device=generator.device)}

    def init_state(self, input_type, dtype=torch.float32):
        n = self._nfeat(input_type)
        return {"mean": torch.zeros((n,), dtype=dtype), "var": torch.ones((n,), dtype=dtype)}

    WEIGHT_KEYS = ("gamma",)
    BIAS_KEYS = ("beta",)

    def apply(self, params, state, x, *, train=False):
        axes = tuple(range(x.dim() - 1))  # all but channel/feature
        # batch statistics in the accumulation dtype; the output is cast
        # back so bf16 activations stay bf16 downstream
        out_dtype = x.dtype
        _, ad = _dtypes.compute_dtypes_for(x.dtype)
        x = x.to(ad)
        if train:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, correction=0)
            with torch.no_grad():
                new_state = {"mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                             "var": self.decay * state["var"] + (1 - self.decay) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.use_gamma_beta:
            y = y * params["gamma"] + params["beta"]
        return self.activation_fn()(y).to(out_dtype), new_state


@register_config
@dataclasses.dataclass(frozen=True)
class GlobalPoolingLayer(Layer):
    """Pool over time (RNN [B,T,F], mask-aware) or space (CNN [B,H,W,C]):
    max | avg | sum | pnorm."""

    mode: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    input_family = None

    def output_type(self, input_type):
        if isinstance(input_type, _inputs.RecurrentType):
            return _inputs.FeedForwardType(input_type.size)
        if isinstance(input_type, _inputs.ConvolutionalType):
            return _inputs.FeedForwardType(input_type.channels)
        return input_type

    def apply(self, params, state, x, *, train=False, mask=None):
        axes = (1,) if x.dim() == 3 else (1, 2) if x.dim() == 4 else None
        if axes is None:
            return x, state
        if mask is not None and x.dim() == 3:
            m = mask[..., None].to(x.dtype)
            if self.mode == "max":
                y = torch.where(m > 0, x, torch.full_like(x, float("-inf"))).amax(dim=1)
            elif self.mode == "sum":
                y = (x * m).sum(dim=1)
            elif self.mode == "avg":
                y = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
            else:
                p = float(self.pnorm)
                y = ((x * m).abs() ** p).sum(dim=1) ** (1.0 / p)
            return y, state
        if self.mode == "max":
            y = x.amax(dim=axes)
        elif self.mode == "avg":
            y = x.mean(dim=axes)
        elif self.mode == "sum":
            y = x.sum(dim=axes)
        elif self.mode == "pnorm":
            p = float(self.pnorm)
            y = (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
        else:
            raise ValueError(f"Unknown pooling mode {self.mode!r}")
        return y, state
