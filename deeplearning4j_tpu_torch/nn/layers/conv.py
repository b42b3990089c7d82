"""Convolutional layers: ConvolutionLayer, Convolution1DLayer,
Deconvolution2DLayer, SeparableConvolution2DLayer, SubsamplingLayer,
Subsampling1DLayer, Upsampling1D/2D, ZeroPadding1D/2D, SpaceToDepth,
SpaceToBatch, BatchNormalization, LocalResponseNormalization,
ResidualBottleneck and GlobalPoolingLayer.

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
the unbiased one. LocalResponseNormalization divides by
``(k + alpha * sum x^2)^beta`` over a channel window padded (n//2,
n-1-n//2), as the JAX package's ``reduce_window``; torch's
``local_response_norm`` divides alpha by n and centres the window
otherwise.

Deconvolution2DLayer is the JAX package's ``lax.conv_transpose`` with
``transpose_kernel=False`` on an HWIO kernel: a correlation of the
stride-dilated input with the kernel as given, padded (k - 1, s - 1 +
max(k - s, 0)) for "valid", (k - 1, s - 1) or (ceil((k + s - 2) / 2), the
rest) for "same" (output = input * stride) and ``pad`` on both sides for
"explicit". Torch's ``conv_transpose2d`` computes the full correlation
(pad k - 1 both sides) with the kernel flipped and its in and out axes
swapped; the port feeds it that kernel and crops or zero-pads the full
output to the JAX padding. SpaceToDepthLayer orders the new channels
(block row, block column, channel), where ``pixel_unshuffle`` orders them
(channel, block row, block column); SpaceToBatchLayer orders the new batch
(block row, block column, image).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import initializers as _init
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer
from deeplearning4j_tpu_torch.utils import collectives as _collectives
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


def conv(x, w, *, stride=(1, 1), padding="valid", pad=(0, 0), dilation=(1, 1), groups=1):
    """Policy-aware 2-D convolution of NHWC ``x`` with HWIO ``w`` (the JAX
    package's ``conv``): operands in the compute dtype; under mixed
    precision (bf16 compute, f32 accumulation) the result stays in bf16, as
    the JAX package computes bf16 -> bf16, else it comes back in the
    accumulation dtype. ``groups`` is XLA's ``feature_group_count``: output
    channel o reads input group o // (cout / groups), as in torch."""
    cd, ad = _dtypes.compute_dtypes_for(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    dh, dw = _pair(dilation)
    keff = (kh + (kh - 1) * (dh - 1), kw + (kw - 1) * (dw - 1))
    pads = _explicit_padding(padding, _pair(pad), x.shape[1:3], keff, _pair(stride))
    xn, sym = _nchw_padded(x.to(cd), pads)
    z = F.conv2d(xn, w.to(cd).permute(3, 2, 0, 1), stride=_pair(stride), padding=sym,
                 dilation=(dh, dw), groups=groups)
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
            # over the global batch under a batch group (parallel/)
            mean, var = _collectives.batch_moments(x, axes)
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
class LocalResponseNormalization(Layer):
    """Cross-channel LRN (reference: LocalResponseNormalization.java;
    defaults k=2, n=5, alpha=1e-4, beta=0.75, the AlexNet formulation)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        return input_type

    def apply(self, params, state, x, *, train=False):
        half = self.n // 2
        sq = F.pad(x * x, (half, self.n - 1 - half))  # the channel (last) axis
        ssum = sq.unfold(-1, self.n, 1).sum(-1)
        return x / (self.k + self.alpha * ssum) ** self.beta, state


@register_config
@dataclasses.dataclass(frozen=True)
class ResidualBottleneck(ParamLayer):
    """ResNet-v1 bottleneck (1x1 reduce -> 3x3 -> 1x1 expand 4x, shortcut
    add, relu) as one layer of a MultiLayerNetwork, the geometry of
    ``models/resnet.py _bottleneck``: filters f -> (f, f, 4f), the stride
    on the first 1x1, a projection shortcut (1x1 stride conv + BN) whenever
    the shortcut's shape changes or ``project`` is set. Parameters and
    state nest by sublayer (``a_conv``, ``a_bn``, ..., ``proj_bn``)."""

    filters: int = 64
    stride: tuple = (1, 1)
    project: bool = False  # a projection shortcut (automatic when shapes differ)
    decay: float = 0.9  # BN running-average momentum
    eps: float = 1e-5

    input_family = _inputs.ConvolutionalType

    def _needs_proj(self, input_type):
        return (self.project or input_type.channels != 4 * self.filters
                or _pair(self.stride) != (1, 1))

    def _plan(self, input_type):
        """[(name, sublayer, its input type)]: the main chain, then the shortcut."""
        f = self.filters
        subs, t = [], input_type
        for tag, k, s, act, nout in (("a", (1, 1), self.stride, "relu", f),
                                     ("b", (3, 3), (1, 1), "relu", f),
                                     ("c", (1, 1), (1, 1), "identity", 4 * f)):
            cl = ConvolutionLayer(n_out=nout, kernel=k, stride=s, padding="same",
                                  has_bias=False, weight_init="relu")
            subs.append((f"{tag}_conv", cl, t))
            t = cl.output_type(t)
            subs.append((f"{tag}_bn", BatchNormalization(decay=self.decay, eps=self.eps,
                                                         activation=act), t))
        if self._needs_proj(input_type):
            pc = ConvolutionLayer(n_out=4 * f, kernel=(1, 1), stride=self.stride,
                                  padding="same", has_bias=False, weight_init="relu")
            subs.append(("proj_conv", pc, input_type))
            subs.append(("proj_bn", BatchNormalization(decay=self.decay, eps=self.eps,
                                                       activation="identity"),
                         pc.output_type(input_type)))
        return subs

    def output_type(self, input_type):
        if not isinstance(input_type, _inputs.ConvolutionalType):
            raise ValueError(f"{type(self).__name__} needs CNN input, got {input_type}")
        sh, sw = _pair(self.stride)
        return _inputs.ConvolutionalType(-(-input_type.height // sh),
                                         -(-input_type.width // sw), 4 * self.filters)

    def init(self, generator, input_type, dtype=torch.float32):
        out = {}
        for name, sub, t in self._plan(input_type):
            p = sub.init(generator, t, dtype)
            if p:
                out[name] = p
        return out

    def init_state(self, input_type, dtype=torch.float32):
        return {name: sub.init_state(t, dtype) for name, sub, t in self._plan(input_type)
                if isinstance(sub, BatchNormalization)}

    def apply(self, params, state, x, *, train=False):
        it = _inputs.ConvolutionalType(x.shape[1], x.shape[2], x.shape[3])
        new_state = dict(state)
        h, shortcut = x, x
        for name, sub, _ in self._plan(it):
            on_shortcut = name.startswith("proj")
            y, st = sub.apply(params.get(name, {}), state.get(name, {}),
                              shortcut if on_shortcut else h, train=train)
            if name in state:
                new_state[name] = st
            if on_shortcut:
                shortcut = y
            else:
                h = y
        return torch.relu(h + shortcut), new_state

    def regularization_penalty(self, params):
        """L1/L2 on the conv kernels only (BN's gamma and beta are not
        regularized, the reference's default)."""
        pen = 0.0
        for name, sub in params.items():
            if name.endswith("_conv"):
                w = sub["W"]
                if self.l1:
                    pen = pen + self.l1 * w.abs().sum()
                if self.l2:
                    pen = pen + 0.5 * self.l2 * (w * w).sum()
        return pen


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


def _conv_transpose_pads(k, s, padding, pad):
    """(lo, hi) padding of the stride-dilated input in ``lax.conv_transpose``
    (its ``_conv_transpose_padding`` for "same" and "valid"; an explicit
    ``pad`` on both sides)."""
    if padding == "same":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
        return lo, total - lo
    if padding == "valid":
        return k - 1, s - 1 + max(k - s, 0)
    return pad, pad


@register_config
@dataclasses.dataclass(frozen=True)
class Convolution1DLayer(ParamLayer):
    """1-D convolution over time (reference: Convolution1DLayer.java). Input
    [B, T, F]; W [k, cin, cout]; computed as the 2-D conv over a width-1
    axis."""

    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: str = "valid"
    pad: int = 0
    dilation: int = 1
    has_bias: bool = True
    weight_init: object = dataclasses.field(default="relu", kw_only=True)

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        if not isinstance(input_type, _inputs.RecurrentType):
            raise ValueError(f"{type(self).__name__} needs RNN input, got {input_type}")
        t = input_type.timesteps
        if t is not None:
            k_eff = self.kernel + (self.kernel - 1) * (self.dilation - 1)
            t = _conv_out_size(t, k_eff, self.stride, self.padding, self.pad)
        return _inputs.RecurrentType(self.n_out, t)

    def init(self, generator, input_type, dtype=torch.float32):
        cin = input_type.size
        p = {"W": _init.init_weight(self.weight_init, generator, (self.kernel, cin, self.n_out),
                                    cin * self.kernel, self.n_out * self.kernel, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        z = conv(x[:, :, None, :], params["W"][:, None], stride=(self.stride, 1),
                 padding=self.padding, pad=(self.pad, 0), dilation=(self.dilation, 1))[:, :, 0]
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class Deconvolution2DLayer(ConvolutionLayer):
    """Transposed convolution (reference: Deconvolution2D.java), the JAX
    package's function (see the module docstring); ``dilation`` is
    ignored, as there."""

    def output_type(self, input_type):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.pad)
        if self.padding == "same":
            h, w = input_type.height * sh, input_type.width * sw
        else:
            pads = (0, 0) if self.padding == "valid" else (ph, pw)
            h = sh * (input_type.height - 1) + kh - 2 * pads[0]
            w = sw * (input_type.width - 1) + kw - 2 * pads[1]
        return _inputs.ConvolutionalType(h, w, self.n_out)

    def apply(self, params, state, x, *, train=False):
        cd, ad = _dtypes.compute_dtypes_for(x.dtype)
        w = params["W"]
        kh, kw = w.shape[0], w.shape[1]
        (sh, sw), (ph, pw) = _pair(self.stride), _pair(self.pad)
        hl, hh = _conv_transpose_pads(kh, sh, self.padding, ph)
        wl, wh = _conv_transpose_pads(kw, sw, self.padding, pw)
        full = F.conv_transpose2d(x.to(cd).permute(0, 3, 1, 2),
                                  w.to(cd).permute(2, 3, 0, 1).flip(2, 3), stride=(sh, sw))
        # the full correlation pads k - 1 on each side: crop (or zero-pad)
        # it to the JAX padding
        z = F.pad(full, (wl - (kw - 1), wh - (kw - 1), hl - (kh - 1), hh - (kh - 1)))
        z = z.permute(0, 2, 3, 1)
        z = z if cd != ad else z.to(ad)
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class SeparableConvolution2DLayer(ParamLayer):
    """Depthwise-separable convolution (reference: SeparableConvolution2D.java):
    D [kh, kw, 1, cin * mult] depthwise (output channel o reads input
    channel o // mult), then P [1, 1, cin * mult, cout] pointwise."""

    n_out: int = 0
    kernel: tuple = (3, 3)
    stride: tuple = (1, 1)
    padding: str = "valid"
    pad: tuple = (0, 0)
    depth_multiplier: int = 1
    has_bias: bool = True
    weight_init: object = dataclasses.field(default="relu", kw_only=True)

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.pad)
        h = _conv_out_size(input_type.height, kh, sh, self.padding, ph)
        w = _conv_out_size(input_type.width, kw, sw, self.padding, pw)
        return _inputs.ConvolutionalType(h, w, self.n_out)

    def init(self, generator, input_type, dtype=torch.float32):
        kh, kw = _pair(self.kernel)
        cin = input_type.channels
        cm = cin * self.depth_multiplier
        p = {"D": _init.init_weight(self.weight_init, generator, (kh, kw, 1, cm), cin * kh * kw,
                                    cm, dtype),
             "P": _init.init_weight(self.weight_init, generator, (1, 1, cm, self.n_out), cm,
                                    self.n_out, dtype)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                                device=generator.device)
        return p

    def apply(self, params, state, x, *, train=False):
        z = conv(x, params["D"], stride=_pair(self.stride), padding=self.padding,
                 pad=_pair(self.pad), groups=x.shape[-1])
        z = conv(z, params["P"])
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return self.activation_fn()(z), state


@register_config
@dataclasses.dataclass(frozen=True)
class Subsampling1DLayer(Layer):
    """1-D pooling over time (reference: Subsampling1DLayer.java): "max",
    "avg", or a sum for any other mode; "same" or "valid" padding."""

    kernel: int = 2
    stride: int = 2
    padding: str = "valid"
    mode: str = "max"

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        t = input_type.timesteps
        if t is not None:
            t = _conv_out_size(t, self.kernel, self.stride, self.padding, 0)
        return _inputs.RecurrentType(input_type.size, t)

    def apply(self, params, state, x, *, train=False):
        mode = self.mode if self.mode in ("max", "avg") else "sum"
        pool = SubsamplingLayer(kernel=(self.kernel, 1), stride=(self.stride, 1),
                                padding=self.padding, mode=mode)
        y, _ = pool.apply(params, state, x[:, :, None, :])
        return y[:, :, 0], state


@register_config
@dataclasses.dataclass(frozen=True)
class Upsampling2DLayer(Layer):
    """Nearest-neighbour repeat (reference: Upsampling2D.java)."""

    size: tuple = (2, 2)

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        sh, sw = _pair(self.size)
        return _inputs.ConvolutionalType(input_type.height * sh, input_type.width * sw,
                                         input_type.channels)

    def apply(self, params, state, x, *, train=False):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), state


@register_config
@dataclasses.dataclass(frozen=True)
class Upsampling1DLayer(Layer):
    size: int = 2

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        t = None if input_type.timesteps is None else input_type.timesteps * self.size
        return _inputs.RecurrentType(input_type.size, t)

    def apply(self, params, state, x, *, train=False):
        return x.repeat_interleave(self.size, dim=1), state


@register_config
@dataclasses.dataclass(frozen=True)
class ZeroPaddingLayer(Layer):
    """(reference: ZeroPaddingLayer.java) pad = (top, bottom, left, right)."""

    pad: tuple = (1, 1, 1, 1)

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        t, b, l, r = self.pad
        return _inputs.ConvolutionalType(input_type.height + t + b,
                                         input_type.width + l + r, input_type.channels)

    def apply(self, params, state, x, *, train=False):
        t, b, l, r = self.pad
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_config
@dataclasses.dataclass(frozen=True)
class ZeroPadding1DLayer(Layer):
    pad: tuple = (1, 1)

    input_family = _inputs.RecurrentType

    def output_type(self, input_type):
        l, r = self.pad
        t = None if input_type.timesteps is None else input_type.timesteps + l + r
        return _inputs.RecurrentType(input_type.size, t)

    def apply(self, params, state, x, *, train=False):
        l, r = self.pad
        return F.pad(x, (0, 0, l, r)), state


@register_config
@dataclasses.dataclass(frozen=True)
class SpaceToDepthLayer(Layer):
    """(reference: SpaceToDepthLayer.java; the YOLO passthrough) Channels
    ordered (block row, block column, channel)."""

    blocks: int = 2

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        b = self.blocks
        return _inputs.ConvolutionalType(input_type.height // b, input_type.width // b,
                                         input_type.channels * b * b)

    def apply(self, params, state, x, *, train=False):
        b = self.blocks
        n, h, w, c = x.shape
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h // b, w // b, b * b * c), state


@register_config
@dataclasses.dataclass(frozen=True)
class SpaceToBatchLayer(Layer):
    """(reference: SpaceToBatchLayer.java) Batch ordered (block row, block
    column, image)."""

    blocks: tuple = (2, 2)

    input_family = _inputs.ConvolutionalType

    def output_type(self, input_type):
        bh, bw = _pair(self.blocks)
        return _inputs.ConvolutionalType(input_type.height // bh, input_type.width // bw,
                                         input_type.channels)

    def apply(self, params, state, x, *, train=False):
        bh, bw = _pair(self.blocks)
        n, h, w, c = x.shape
        y = x.reshape(n, h // bh, bh, w // bw, bw, c).permute(2, 4, 0, 1, 3, 5)
        return y.reshape(n * bh * bw, h // bh, w // bw, c), state
