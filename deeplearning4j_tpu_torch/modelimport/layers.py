"""Keras layer -> port layer mappers (the JAX package's
``deeplearning4j_tpu/modelimport/layers.py``, mapping onto the port's layers).

Reference analog: the ~45 per-layer mappers under deeplearning4j-modelimport/
.../keras/layers/ plus the version-split config dictionaries
Keras1LayerConfiguration.java / Keras2LayerConfiguration.java (SURVEY.md
§2.6). Keras 1 and 2 differ in config key names (output_dim vs units,
nb_filter vs filters, ...); ``cfg()`` resolves the alias chains so one mapper
serves both.

Weight layout notes (why import is mostly a straight copy):
- Keras TF-backend kernels are HWIO and activations channels_last — exactly
  this framework's NHWC convention, so conv kernels import untransposed
  (the reference needs TensorFlowCnnToFeedForwardPreProcessor gymnastics
  because DL4J is NCHW).
- Keras LSTM gate order is i, f, c(candidate), o — identical to
  nn/layers/rnn.py's fused layout; kernel/recurrent_kernel concatenate
  directly onto Wx/Wh.
- Theano-ordering (channels_first) models import via one-time weight
  re-layout: conv kernels OIHW->HWIO (_conv_weights_th), and the first
  dense after an implicit flatten gets its input rows permuted from
  C-major to HWC-major (keras.py:_permute_flattened_dense) — replacing the
  reference's runtime preprocessor pair (TensorFlowCnnToFeedForward /
  CnnToFeedForwardPreProcessor dim-ordering branches).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nn import layers as L


class KerasImportError(Exception):
    pass


# Keras activation -> ours
_ACTIVATIONS = {
    "relu": "relu", "softmax": "softmax", "sigmoid": "sigmoid",
    "tanh": "tanh", "linear": "identity", "elu": "elu", "selu": "selu",
    "softplus": "softplus", "softsign": "softsign",
    "hard_sigmoid": "hardsigmoid", "swish": "swish", "gelu": "gelu",
    "relu6": "relu6", "exponential": "identity",
}

# Keras loss -> ours (for training_config round-trip)
LOSSES = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "sparse_mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse", "mse": "mse",
    "mean_absolute_error": "mae", "mae": "mae",
    "hinge": "hinge", "squared_hinge": "squared_hinge",
    "kullback_leibler_divergence": "kl_divergence",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
    "mean_squared_logarithmic_error": "mean_squared_log_error",
    "mean_absolute_percentage_error": "mean_absolute_percentage_error",
}


def activation(name):
    if name is None:
        return "identity"
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise KerasImportError(f"Unsupported Keras activation {name!r}")


class Cfg:
    """Alias-resolving view over a Keras layer config dict."""

    def __init__(self, d, keras_version=2, default_dim_ordering="tf"):
        self.d = d
        self.version = keras_version
        # model-level fallback for layers that omit data_format/dim_ordering
        # (Keras-1 files rely on the backend's image_dim_ordering default)
        self.default_dim_ordering = default_dim_ordering

    def get(self, *names, default=None):
        for n in names:
            if n in self.d:
                return self.d[n]
        return default

    def require(self, *names):
        v = self.get(*names, default=None)
        if v is None:
            raise KerasImportError(f"Missing Keras config key (any of {names}): "
                                   f"have {sorted(self.d)}")
        return v


def _data_format(c: Cfg):
    """'tf' (channels_last) or 'th' (channels_first/Theano ordering).

    Reference analog: the dimOrdering plumbing in KerasConvolution /
    KerasModel (deeplearning4j-modelimport/.../keras/layers/convolutional/
    KerasConvolution2D.java + KerasLayerUtils) — Keras-1 models saved with
    the Theano backend default to 'th' and store conv kernels OIHW with
    channels-first activations."""
    fmt = c.get("data_format", "dim_ordering", default=None)
    if fmt in (None, "default"):
        return c.default_dim_ordering
    if fmt in ("channels_last", "tf"):
        return "tf"
    if fmt in ("channels_first", "th"):
        return "th"
    raise KerasImportError(f"Unknown Keras data_format/dim_ordering {fmt!r}")


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _padding(c: Cfg):
    p = c.get("padding", "border_mode", default="valid")
    if p not in ("valid", "same"):
        raise KerasImportError(f"Unsupported Keras padding {p!r}")
    return p


# ---------------------------------------------------------------------------
# Weight mappers: keras weight-name suffix -> (param_key, transform)
# Each mapper returns (params_dict, state_dict)
# ---------------------------------------------------------------------------


def _w(weights, *names):
    """Find a weight by Keras 2 name (``.../kernel:0``) or Keras 1 name
    (underscore-suffixed, e.g. ``dense_1_W``)."""
    # exact-name pass first so e.g. "kernel" never suffix-matches
    # "recurrent_kernel" regardless of HDF5 key order
    for n in names:
        for key, arr in weights.items():
            if key.split("/")[-1].split(":")[0] == n:
                return np.asarray(arr, np.float32)
    for n in names:
        for key, arr in weights.items():
            if key.split("/")[-1].split(":")[0].endswith("_" + n):
                return np.asarray(arr, np.float32)
    return None


def _require(weights, *names):
    """Like _w but a missing weight is an import error, not a silent skip
    (reference KerasBatchNormalization.setWeights:144-163 et al. throw
    InvalidKerasConfigurationException on absent required params)."""
    v = _w(weights, *names)
    if v is None:
        raise KerasImportError(
            f"Required weight {names[0]!r} not found among {sorted(weights)}")
    return v


def _dense_weights(layer, weights):
    p = {"W": _require(weights, "kernel", "W")}
    b = _w(weights, "bias", "b")
    if b is not None:
        p["b"] = b
    return p, {}


def _conv_weights(layer, weights):
    return _dense_weights(layer, weights)  # HWIO kernel + bias, same keys


def _conv_weights_th(layer, weights):
    """channels_first conv kernels are stored OIHW (Theano layout:
    [filters, stack, rows, cols]); transpose to this framework's HWIO.
    The same (2,3,1,0) permutation maps Theano deconvolution kernels
    [in, out, rows, cols] onto the Keras-2 transpose layout [H, W, out, in]
    the Deconvolution2DLayer expects."""
    k = _require(weights, "kernel", "W")
    if k.ndim != 4:
        raise KerasImportError(
            f"channels_first conv kernel must be rank-4, got {k.shape}")
    p = {"W": np.ascontiguousarray(np.transpose(k, (2, 3, 1, 0)))}
    b = _w(weights, "bias", "b")
    if b is not None:
        p["b"] = b
    return p, {}


def _separable_conv_weights(layer, weights):
    p = {"D": _w(weights, "depthwise_kernel"),
         "P": _w(weights, "pointwise_kernel")}
    b = _w(weights, "bias")
    if b is not None:
        p["b"] = b
    return p, {}


def _bn_weights(layer, weights):
    p = {}
    gamma, beta = _w(weights, "gamma"), _w(weights, "beta")
    if gamma is not None:
        p["gamma"] = gamma
    if beta is not None:
        p["beta"] = beta
    # Keras 2: moving_mean/moving_variance; Keras 1: running_mean/running_std
    # (Keras 1's "running_std" holds the variance — the reference maps it 1:1
    # to GLOBAL_VAR, Keras1LayerConfiguration.java:67)
    state = {"mean": _require(weights, "moving_mean", "running_mean"),
             "var": _require(weights, "moving_variance", "running_std")}
    return p, state


def _lstm_weights(layer, weights):
    # Keras: kernel [in,4H], recurrent_kernel [H,4H], bias [4H]; gate order
    # i,f,c,o == ours (rnn.py fused layout). Keras 1 split per-gate weights
    # (W_i, U_i, b_i, ...) are concatenated.
    k = _w(weights, "kernel")
    if k is not None:
        p = {"Wx": k, "Wh": _w(weights, "recurrent_kernel")}
        b = _w(weights, "bias")
        if b is not None:
            p["b"] = b
        return p, {}
    parts_x, parts_h, parts_b = [], [], []
    for g in ("i", "f", "c", "o"):
        parts_x.append(_w(weights, f"W_{g}"))
        parts_h.append(_w(weights, f"U_{g}"))
        parts_b.append(_w(weights, f"b_{g}"))
    if any(v is None for v in parts_x + parts_h + parts_b):
        raise KerasImportError(f"Unrecognized LSTM weight set: {sorted(weights)}")
    return {"Wx": np.concatenate(parts_x, 1), "Wh": np.concatenate(parts_h, 1),
            "b": np.concatenate(parts_b, 0)}, {}


def _embedding_weights(layer, weights):
    return {"W": _w(weights, "embeddings", "W")}, {}


def _simple_rnn_weights(layer, weights):
    # Keras 2: kernel/recurrent_kernel/bias; Keras 1: W/U/b
    p = {"Wx": _require(weights, "kernel", "W"),
         "Wh": _require(weights, "recurrent_kernel", "U")}
    b = _w(weights, "bias")
    if b is not None:
        p["b"] = b
    return p, {}


# ---------------------------------------------------------------------------
# Layer mappers. Each returns (layer | None, weight_mapper | None).
# None layer = structural no-op in this framework (Flatten between CNN and
# Dense is implicit — nn/conf/inputs.py adapt()).
# ---------------------------------------------------------------------------


def _map_dense(c: Cfg):
    return (L.DenseLayer(
        n_out=int(c.require("units", "output_dim")),
        activation=activation(c.get("activation")),
        has_bias=bool(c.get("use_bias", "bias", default=True))), _dense_weights)


def _map_conv2d(c: Cfg):
    wmap = _conv_weights_th if _data_format(c) == "th" else _conv_weights
    return (L.ConvolutionLayer(
        n_out=int(c.require("filters", "nb_filter")),
        kernel=_pair(c.get("kernel_size", default=None) or
                     (c.require("nb_row"), c.require("nb_col"))),
        stride=_pair(c.get("strides", "subsample", default=(1, 1))),
        padding=_padding(c),
        dilation=_pair(c.get("dilation_rate", default=(1, 1))),
        has_bias=bool(c.get("use_bias", "bias", default=True)),
        activation=activation(c.get("activation"))), wmap)


def _map_conv1d(c: Cfg):
    k = c.get("kernel_size", "filter_length", default=3)
    if isinstance(k, (list, tuple)):
        k = k[0]
    s = c.get("strides", "subsample_length", default=1)
    if isinstance(s, (list, tuple)):
        s = s[0]
    return (L.Convolution1DLayer(
        n_out=int(c.require("filters", "nb_filter")),
        kernel=int(k), stride=int(s), padding=_padding(c),
        has_bias=bool(c.get("use_bias", "bias", default=True)),
        activation=activation(c.get("activation"))), _dense_weights)


def _map_separable_conv2d(c: Cfg):
    if _data_format(c) == "th":
        raise KerasImportError(
            "channels_first SeparableConv2D import is not supported; "
            "re-export with data_format=channels_last")
    return (L.SeparableConvolution2DLayer(
        n_out=int(c.require("filters", "nb_filter")),
        kernel=_pair(c.require("kernel_size")),
        stride=_pair(c.get("strides", default=(1, 1))),
        padding=_padding(c),
        depth_multiplier=int(c.get("depth_multiplier", default=1)),
        has_bias=bool(c.get("use_bias", default=True)),
        activation=activation(c.get("activation"))), _separable_conv_weights)


def _map_conv2d_transpose(c: Cfg):
    wmap = _conv_weights_th if _data_format(c) == "th" else _conv_weights
    return (L.Deconvolution2DLayer(
        n_out=int(c.require("filters", "nb_filter")),
        kernel=_pair(c.require("kernel_size")),
        stride=_pair(c.get("strides", default=(1, 1))),
        padding=_padding(c),
        has_bias=bool(c.get("use_bias", default=True)),
        activation=activation(c.get("activation"))), wmap)


def _map_maxpool2d(c: Cfg):
    _data_format(c)  # validate; pool geometry is layout-independent
    pool = _pair(c.get("pool_size", default=(2, 2)))
    return (L.SubsamplingLayer(
        kernel=pool, stride=_pair(c.get("strides", default=None) or pool),
        padding=_padding(c), mode="max"), None)


def _map_avgpool2d(c: Cfg):
    _data_format(c)
    pool = _pair(c.get("pool_size", default=(2, 2)))
    return (L.SubsamplingLayer(
        kernel=pool, stride=_pair(c.get("strides", default=None) or pool),
        padding=_padding(c), mode="avg"), None)


def _map_pool1d(mode):
    def go(c: Cfg):
        pool = c.get("pool_size", "pool_length", default=2)
        if isinstance(pool, (list, tuple)):
            pool = pool[0]
        stride = c.get("strides", "stride", default=None)
        if isinstance(stride, (list, tuple)):
            stride = stride[0]
        return (L.Subsampling1DLayer(
            kernel=int(pool), stride=int(stride or pool),
            padding=_padding(c), mode=mode), None)
    return go


def _map_global_pool(mode):
    def go(c: Cfg):
        return (L.GlobalPoolingLayer(mode=mode), None)
    return go


def _map_batchnorm(c: Cfg):
    axis = c.get("axis", default=-1)
    if axis not in (-1, 3) and axis is not None:
        # channels_last => feature axis is the last one
        raise KerasImportError(
            f"BatchNormalization axis={axis} unsupported (channels_last only)")
    return (L.BatchNormalization(
        decay=float(c.get("momentum", default=0.99)),
        eps=float(c.get("epsilon", default=1e-3)),
        use_gamma_beta=bool(c.get("scale", default=True) or
                            c.get("center", default=True))), _bn_weights)


def _seq_or_last(c: Cfg, rnn_layer):
    """Keras return_sequences=False (the default) keeps only the final step;
    this framework's RNN layers always emit [B,T,H], so append LastTimeStep."""
    if c.get("return_sequences", default=False):
        return rnn_layer
    return [rnn_layer, L.LastTimeStep()]


def _map_lstm(c: Cfg):
    inner = activation(c.get("recurrent_activation", "inner_activation",
                             default="hard_sigmoid"))
    layer = L.LSTM(
        n_out=int(c.require("units", "output_dim")),
        activation=activation(c.get("activation", default="tanh")),
        gate_activation=inner,
        forget_gate_bias=1.0 if c.get("unit_forget_bias",
                                      default=True) else 0.0)
    return (_seq_or_last(c, layer), _lstm_weights)


def _map_simple_rnn(c: Cfg):
    layer = L.SimpleRnn(
        n_out=int(c.require("units", "output_dim")),
        activation=activation(c.get("activation", default="tanh")))
    return (_seq_or_last(c, layer), _simple_rnn_weights)


def _map_embedding(c: Cfg):
    # a Keras Embedding is ALWAYS sequential ([B, T] ids -> [B, T, D]);
    # the sequence layer is the faithful mapping (imdb_lstm configs in the
    # reference's own test resources are Embedding -> LSTM stacks)
    return (L.EmbeddingSequenceLayer(
        n_in=int(c.require("input_dim")),
        n_out=int(c.require("output_dim", "units"))), _embedding_weights)


def _map_time_distributed_dense(c: Cfg):
    # Keras-1 legacy TimeDistributedDense: dense applied per timestep with
    # the time axis PRESERVED ([B,T,F] -> [B,T,n_out]); a bare DenseLayer
    # would fold time into batch and lose it for everything downstream
    return (L.TimeDistributedDenseLayer(
        n_out=int(c.require("output_dim", "units")),
        activation=activation(c.get("activation", default="linear")),
        has_bias=bool(c.get("use_bias", "bias", default=True))),
        _dense_weights)


def _map_dropout(c: Cfg):
    return (L.DropoutLayer(rate=float(c.get("rate", "p", default=0.5))), None)


def _map_alpha_dropout(c: Cfg):
    return (L.DropoutLayer(rate=float(c.get("rate", "p", default=0.5)),
                           kind="alpha"), None)


def _map_gaussian_dropout(c: Cfg):
    return (L.DropoutLayer(rate=float(c.get("rate", "p", default=0.5)),
                           kind="gaussian_dropout"), None)


def _map_gaussian_noise(c: Cfg):
    return (L.DropoutLayer(rate=float(c.get("stddev", "sigma", default=0.1)),
                           kind="gaussian_noise"), None)


def _map_activation(c: Cfg):
    return (L.ActivationLayer(activation=activation(c.require("activation"))),
            None)


def _map_leaky_relu(c: Cfg):
    alpha = float(c.get("alpha", "negative_slope", default=0.3))
    return (L.ActivationLayer(activation=("leakyrelu", {"alpha": alpha})),
            None)


def _map_zero_padding2d(c: Cfg):
    _data_format(c)
    p = c.get("padding", default=(1, 1))
    if isinstance(p, (list, tuple)) and len(p) == 2 and \
            all(isinstance(x, (list, tuple)) for x in p):
        pad = (int(p[0][0]), int(p[0][1]), int(p[1][0]), int(p[1][1]))
    else:
        ph, pw = _pair(p)
        pad = (ph, ph, pw, pw)
    return (L.ZeroPaddingLayer(pad=pad), None)


def _map_upsampling2d(c: Cfg):
    _data_format(c)
    return (L.Upsampling2DLayer(size=_pair(c.get("size", default=(2, 2)))), None)


def _map_upsampling1d(c: Cfg):
    s = c.get("size", "length", default=2)
    if isinstance(s, (list, tuple)):
        s = s[0]
    return (L.Upsampling1DLayer(size=int(s)), None)


def _map_noop(c: Cfg):
    return (None, None)


# class_name -> mapper
MAPPERS = {
    "Dense": _map_dense,
    "Conv2D": _map_conv2d, "Convolution2D": _map_conv2d,
    "Conv1D": _map_conv1d, "Convolution1D": _map_conv1d,
    "SeparableConv2D": _map_separable_conv2d,
    "SeparableConvolution2D": _map_separable_conv2d,
    "Conv2DTranspose": _map_conv2d_transpose,
    "Deconvolution2D": _map_conv2d_transpose,
    "MaxPooling2D": _map_maxpool2d,
    "AveragePooling2D": _map_avgpool2d,
    "MaxPooling1D": _map_pool1d("max"),
    "AveragePooling1D": _map_pool1d("avg"),
    "GlobalMaxPooling2D": _map_global_pool("max"),
    "GlobalAveragePooling2D": _map_global_pool("avg"),
    "GlobalMaxPooling1D": _map_global_pool("max"),
    "GlobalAveragePooling1D": _map_global_pool("avg"),
    "BatchNormalization": _map_batchnorm,
    "LSTM": _map_lstm,
    "SimpleRNN": _map_simple_rnn,
    "Embedding": _map_embedding,
    "TimeDistributedDense": _map_time_distributed_dense,
    "Dropout": _map_dropout,
    "SpatialDropout1D": _map_dropout,
    "SpatialDropout2D": _map_dropout,
    "AlphaDropout": _map_alpha_dropout,
    "GaussianDropout": _map_gaussian_dropout,
    "GaussianNoise": _map_gaussian_noise,
    "Activation": _map_activation,
    "LeakyReLU": _map_leaky_relu,
    "ZeroPadding2D": _map_zero_padding2d,
    "UpSampling2D": _map_upsampling2d,
    "UpSampling1D": _map_upsampling1d,
    "Flatten": _map_noop,       # implicit CNN->FF adaptation
    "Reshape": _map_noop,       # family adaptation handles common cases
    "InputLayer": _map_noop,
    "Masking": _map_noop,
    "Permute": _map_noop,
}


def map_layer(class_name, config, keras_version=2, default_dim_ordering="tf"):
    """Map one Keras layer config. Returns (layer | None, weight_mapper)."""
    mapper = MAPPERS.get(class_name)
    if mapper is None:
        raise KerasImportError(f"Unsupported Keras layer type {class_name!r}")
    return mapper(Cfg(config, keras_version, default_dim_ordering))
