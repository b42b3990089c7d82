"""DL4J ModelSerializer zip import/export (the JAX package's
``deeplearning4j_tpu/modelimport/dl4j.py``, building the port's networks).

Reference: util/ModelSerializer.java:51 (writeModel — zip entries
``configuration.json`` / ``coefficients.bin`` / ``updaterState.bin``),
:136 (restoreMultiLayerNetwork). The zoo's ``pretrainedUrl`` checkpoints
(zoo/ZooModel.java:40-52, model/ResNet50.java:54) are exactly this format,
so this reader is what makes ``init_pretrained`` loadable for real.

Binary array format (legacy Nd4j.write / Nd4j.read, the 0.5-0.9.x era all
regression-test zips use — RegressionTest050..080.java load it): TWO
DataBuffer records back to back, shape-info then data, each laid out by
BaseDataBuffer.write as

    writeUTF(allocationMode)   # java modified-UTF8: u16-BE byte length + bytes
    writeInt(length)           # i32 BE element count
    writeUTF(dataType)         # "INT" | "FLOAT" | "DOUBLE"
    elements                   # length x {i32|f32|f64} BE

The shape-info buffer (type INT) is the nd4j shape descriptor
``[rank, *shape, *stride, offset, elementWiseStride, order]`` with order
the ordinal of 'c' (99) or 'f' (102).

Param-vector layout per layer (the flat ``model.params()`` row vector is
the concatenation of each layer's view, MultiLayerNetwork.java:1079-1102):

* Dense/Output/Embedding (DefaultParamInitializer.java:97-139): W
  (nIn*nOut, 'f'-order reshape to [nIn, nOut]) then b (nOut).
* Convolution (ConvolutionParamInitializer.java:118-149): b (nOut) FIRST,
  then W in 'c' order as [nOut, nIn, kh, kw] -> transposed here to this
  framework's HWIO.
* BatchNormalization (BatchNormalizationParamInitializer.java:88-102):
  gamma, beta, then running mean, running var (each nOut; mean/var are
  "params" in the reference but live in this framework's layer STATE).
* LSTM/GravesLSTM (LSTMParamInitializer.java:119-149 /
  GravesLSTMParamInitializer): W [nIn, 4H] 'f', RW [H, 4H(+3)] 'f',
  b [4H]. DL4J's gate column blocks are [a(candidate), f, o, i] — the
  block applied the LAYER activation is the candidate and the "input
  modulation gate" is the sigmoid input gate (LSTMHelpers.java:216-262;
  header comment :70 names the columns [wI,wF,wO,wG]) — versus this
  framework's [i, f, g, o] (nn/layers/rnn.py _step), so columns are
  permuted on import. Graves peephole columns 4H..4H+2 are
  [wFF(f), wOO(o), wGG(i)] (LSTMHelpers.java:103-115) -> Wp rows [i,f,o].

The restores build the network on ``device`` (default ``"cuda"``; a
missing card raises), initialise it there as the JAX package does, then
copy every imported array into its tensor in the tensor's dtype. The
writers read the network's tensors back to the host; ``updaterState.bin``
holds the updater state's leaves in the JAX package's order (lists in
order, dict keys sorted), so both packages write the same bytes.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport._tensors import install
from deeplearning4j_tpu_torch.nn import graph as G
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as _updaters
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


class Dl4jImportError(ValueError):
    pass


# ---------------------------------------------------------------------------
# legacy Nd4j binary array format
# ---------------------------------------------------------------------------

_NP_OF = {"FLOAT": (np.dtype(">f4"), np.float32),
          "DOUBLE": (np.dtype(">f8"), np.float64),
          "INT": (np.dtype(">i4"), np.int32)}


def _read_utf(f):
    n = struct.unpack(">H", f.read(2))[0]
    return f.read(n).decode("utf-8")


def _write_utf(f, s):
    b = s.encode("utf-8")
    f.write(struct.pack(">H", len(b)))
    f.write(b)


def _read_buffer(f):
    """One BaseDataBuffer.write record -> np array (native byte order)."""
    alloc = _read_utf(f)  # HEAP/JAVACPP/DIRECT/... — informational only
    del alloc
    length = struct.unpack(">i", f.read(4))[0]
    typ = _read_utf(f)
    if typ not in _NP_OF:
        raise Dl4jImportError(f"unsupported nd4j buffer type {typ!r}")
    be, native = _NP_OF[typ]
    raw = f.read(length * be.itemsize)
    if len(raw) != length * be.itemsize:
        raise Dl4jImportError("truncated nd4j buffer")
    return np.frombuffer(raw, be).astype(native)


def _write_buffer(f, arr, typ):
    _write_utf(f, "HEAP")
    f.write(struct.pack(">i", arr.size))
    _write_utf(f, typ)
    f.write(np.ascontiguousarray(arr, _NP_OF[typ][0]).tobytes())


def read_nd4j(stream_or_bytes) -> np.ndarray:
    """Nd4j.read: shape-info buffer + data buffer -> ndarray."""
    f = (io.BytesIO(stream_or_bytes)
         if isinstance(stream_or_bytes, (bytes, bytearray)) else
         stream_or_bytes)
    shape_info = _read_buffer(f)
    rank = int(shape_info[0])
    shape = tuple(int(s) for s in shape_info[1:1 + rank])
    order = chr(int(shape_info[2 * rank + 3]))
    data = _read_buffer(f)
    n = int(np.prod(shape)) if shape else 1
    if data.size < n:
        raise Dl4jImportError(
            f"data buffer has {data.size} elements, shape {shape} needs {n}")
    return np.reshape(data[:n], shape, order=order)


def write_nd4j(arr: np.ndarray, f, order="c") -> None:
    """Nd4j.write-compatible serialization (f32 unless the array is f64)."""
    arr = np.asarray(arr)
    if arr.ndim == 0:  # nd4j has no rank-0: scalars are length-1 vectors
        arr = arr.reshape(1)
    typ = "DOUBLE" if arr.dtype == np.float64 else "FLOAT"
    rank = arr.ndim
    shape = arr.shape
    # strides in elements for the chosen order
    strides = [0] * len(shape)
    acc = 1
    idx = range(len(shape) - 1, -1, -1) if order == "c" else range(len(shape))
    for i in idx:
        strides[i] = acc
        acc *= shape[i]
    info = [rank, *shape, *strides, 0, strides[-1] if order == "c" else 1,
            ord(order)]
    _write_buffer(f, np.asarray(info, np.int32), "INT")
    flat = np.ravel(arr, order=order)
    _write_buffer(f, flat, typ)


# ---------------------------------------------------------------------------
# config JSON -> layer catalog
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "relu": "relu", "lrelu": "leaky_relu", "leakyrelu": "leaky_relu",
    "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "identity": "identity", "softplus": "softplus", "softsign": "softsign",
    "elu": "elu", "selu": "selu", "cube": "cube", "hardtanh": "hardtanh",
    "hardsigmoid": "hardsigmoid", "rationaltanh": "rationaltanh",
    "rectifiedtanh": "rectifiedtanh", "swish": "swish",
}

_LOSSES = {
    "lossmcxent": "mcxent", "lossnegativeloglikelihood":
        "negativeloglikelihood", "lossmse": "mse", "lossmae": "mae",
    "lossbinaryxent": "xent", "lossxent": "xent", "lossl1": "l1",
    "lossl2": "l2", "losshinge": "hinge",
    "losssquaredhinge": "squared_hinge", "losskld": "kl_divergence",
    "losscosineproximity": "cosine_proximity", "losspoisson": "poisson",
    "lossmsle": "mean_squared_log_error",
    "lossmape": "mean_absolute_percentage_error",
}

_WEIGHT_INITS = {
    "xavier": "xavier", "xavier_uniform": "xavier_uniform",
    "xavier_fan_in": "xavier_fan_in", "relu": "relu",
    "relu_uniform": "relu_uniform", "uniform": "uniform", "zero": "zero",
    "ones": "ones", "sigmoid_uniform": "sigmoid_uniform",
    "lecun_normal": "lecun_normal", "lecun_uniform": "lecun_uniform",
    "normal": "normal", "distribution": "normal",
    "var_scaling_normal_fan_in": "var_scaling_normal_fan_in",
    "var_scaling_normal_fan_out": "var_scaling_normal_fan_out",
    "var_scaling_normal_fan_avg": "var_scaling_normal_fan_avg",
}


def _ci(d: dict, *names, default=None):
    """Case-insensitive JSON field lookup (Jackson's bean-name mangling
    lowercases leading caps — nIn serializes as "nin" — but hand-written
    and legacy files vary)."""
    lower = {k.lower(): v for k, v in d.items()}
    for n in names:
        if n.lower() in lower:
            return lower[n.lower()]
    return default


def _activation(body, default="identity"):
    fn = _ci(body, "activationFn", "activationFunction")
    if fn is None:
        return default
    if isinstance(fn, str):
        name = fn
    else:
        cls = fn.get("@class", "")
        name = cls.rsplit(".", 1)[-1]
        if name.startswith("Activation"):
            name = name[len("Activation"):]
    key = name.lower().replace("_", "")
    return _ACTIVATIONS.get(key, key)


def _loss(body, default="mcxent"):
    fn = _ci(body, "lossFn", "lossFunction")
    if fn is None:
        return default
    if isinstance(fn, str):
        key = "loss" + fn.lower().replace("_", "") \
            if not fn.lower().startswith("loss") else fn.lower()
        return _LOSSES.get(key.replace("_", ""), default)
    cls = fn.get("@class", "").rsplit(".", 1)[-1].lower()
    return _LOSSES.get(cls, default)


def _weight_init(body):
    wi = _ci(body, "weightInit", default="XAVIER")
    return _WEIGHT_INITS.get(str(wi).lower(), "xavier")


def _pair(v, default):
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _conv_padding(body):
    """DL4J: convolutionMode Same -> SAME; else explicit padding ints."""
    mode = str(_ci(body, "convolutionMode", default="Truncate")).lower()
    pad = _pair(_ci(body, "padding"), (0, 0))
    if mode == "same":
        return "same", (0, 0)
    if pad == (0, 0):
        return "valid", (0, 0)
    return "explicit", pad


def _common(body):
    return dict(
        activation=_activation(body),
        weight_init=_weight_init(body),
        bias_init=float(_ci(body, "biasInit", default=0.0) or 0.0),
        l1=float(_ci(body, "l1", default=0.0) or 0.0),
        l2=float(_ci(body, "l2", default=0.0) or 0.0),
        name=_ci(body, "layerName"),
    )


def _layer_from_json(kind: str, body: dict):
    """One DL4J layer JSON (wrapper-object name + body) -> framework layer.
    Type names per the @JsonSubTypes table at conf/layers/Layer.java:49-74."""
    k = kind.lower()
    n_out = int(_ci(body, "nOut", default=0) or 0)
    if k == "dense":
        return L.DenseLayer(n_out=n_out, **_common(body))
    if k == "output":
        return L.OutputLayer(n_out=n_out, loss=_loss(body), **_common(body))
    if k == "rnnoutput":
        return L.RnnOutputLayer(n_out=n_out, loss=_loss(body),
                                **_common(body))
    if k == "loss":
        return L.LossLayer(loss=_loss(body),
                           activation=_activation(body, "identity"))
    if k == "rnnlosslayer":
        return L.RnnLossLayer(loss=_loss(body),
                              activation=_activation(body, "identity"))
    if k == "embedding":
        return L.EmbeddingLayer(n_in=int(_ci(body, "nIn", default=0) or 0),
                                n_out=n_out, **_common(body))
    if k == "autoencoder":
        return L.AutoEncoder(n_out=n_out, **_common(body))
    if k in ("convolution", "convolution2d"):
        padding, pad = _conv_padding(body)
        return L.ConvolutionLayer(
            n_out=n_out, kernel=_pair(_ci(body, "kernelSize"), (3, 3)),
            stride=_pair(_ci(body, "stride"), (1, 1)), padding=padding,
            pad=pad, **_common(body))
    if k in ("subsampling", "subsampling2d"):
        padding, pad = _conv_padding(body)
        mode = str(_ci(body, "poolingType", default="MAX")).lower()
        return L.SubsamplingLayer(
            kernel=_pair(_ci(body, "kernelSize"), (2, 2)),
            stride=_pair(_ci(body, "stride"), (2, 2)), padding=padding,
            pad=pad, mode={"max": "max", "avg": "avg", "sum": "sum",
                           "pnorm": "pnorm"}.get(mode, "max"),
            pnorm=int(_ci(body, "pnorm", default=2) or 2))
    if k == "batchnormalization":
        return L.BatchNormalization(
            decay=float(_ci(body, "decay", default=0.9) or 0.9),
            eps=float(_ci(body, "eps", default=1e-5) or 1e-5),
            use_gamma_beta=not bool(_ci(body, "lockGammaBeta",
                                        default=False)),
            activation=_activation(body, "identity"))
    if k == "localresponsenormalization":
        return L.LocalResponseNormalization(
            n=int(_ci(body, "n", default=5) or 5),
            k=float(_ci(body, "k", default=2.0) or 2.0),
            alpha=float(_ci(body, "alpha", default=1e-4) or 1e-4),
            beta=float(_ci(body, "beta", default=0.75) or 0.75))
    if k in ("graveslstm", "lstm"):
        cls = L.GravesLSTM if k == "graveslstm" else L.LSTM
        return cls(n_out=n_out,
                   forget_gate_bias=float(_ci(body, "forgetGateBiasInit",
                                              default=1.0) or 1.0),
                   **_common(body))
    if k == "activation":
        return L.ActivationLayer(activation=_activation(body))
    if k == "dropout":
        # dropOut is the RETAIN probability in DL4J's 0.9-era semantics,
        # with 0.0 meaning "disabled" (the field default) — so an explicit
        # 0.0 maps to drop-rate 0, not 1
        keep = _ci(body, "dropOut")
        keep = 0.5 if keep is None else float(keep)
        return L.DropoutLayer(rate=0.0 if keep == 0.0 else 1.0 - keep)
    if k == "globalpooling":
        mode = str(_ci(body, "poolingType", default="MAX")).lower()
        return L.GlobalPoolingLayer(mode=mode if mode in
                                    ("max", "avg", "sum", "pnorm") else "max")
    if k == "zeropadding":
        p = _ci(body, "padding", default=[0, 0])
        if isinstance(p, (list, tuple)) and len(p) == 4:
            pad = ((int(p[0]), int(p[1])), (int(p[2]), int(p[3])))
        else:
            ph, pw = _pair(p, (0, 0))
            pad = ((ph, ph), (pw, pw))
        return L.ZeroPaddingLayer(pad=pad)
    if k == "upsampling2d":
        s = _ci(body, "size", default=2)
        return L.Upsampling2DLayer(size=_pair(s, (2, 2)))
    raise Dl4jImportError(f"unsupported DL4J layer type {kind!r}")


_UPDATERS = {
    "sgd": lambda lr, b: _updaters.Sgd(lr),
    "nesterovs": lambda lr, b: _updaters.Nesterovs(
        lr, momentum=float(_ci(b, "momentum", default=0.9) or 0.9)),
    "adam": lambda lr, b: _updaters.Adam(
        lr, beta1=float(_ci(b, "adamMeanDecay", default=0.9) or 0.9),
        beta2=float(_ci(b, "adamVarDecay", default=0.999) or 0.999)),
    "adamax": lambda lr, b: _updaters.AdaMax(lr),
    "nadam": lambda lr, b: _updaters.Nadam(lr),
    "adagrad": lambda lr, b: _updaters.AdaGrad(lr),
    "adadelta": lambda lr, b: _updaters.AdaDelta(
        rho=float(_ci(b, "rho", default=0.95) or 0.95)),
    "rmsprop": lambda lr, b: _updaters.RmsProp(
        lr, decay=float(_ci(b, "rmsDecay", default=0.95) or 0.95)),
    "none": lambda lr, b: _updaters.NoOp(),
}


def _updater_from_conf(layer_body):
    name = str(_ci(layer_body, "updater", default="SGD")).lower()
    lr = float(_ci(layer_body, "learningRate", default=0.1) or 0.1)
    mk = _UPDATERS.get(name)
    return mk(lr, layer_body) if mk else _updaters.Sgd(lr)


def _infer_input_type(layers_json, preprocessors, input_type):
    """Input type: explicit override > CNN preprocessor dims > first layer
    nIn. DL4J configs don't store the input shape for CNNs — the
    preprocessor entries (CnnToFeedForwardPreProcessor et al) carry the
    spatial dims when present."""
    if input_type is not None:
        return input_type
    first_kind, first_body = layers_json[0]
    n_in = int(_ci(first_body, "nIn", default=0) or 0)
    k = first_kind.lower()
    if k in ("convolution", "convolution2d", "subsampling",
             "subsampling2d", "batchnormalization", "zeropadding",
             "upsampling2d"):
        # look for any preprocessor that records inputHeight/inputWidth
        for body in (preprocessors or {}).values():
            if isinstance(body, dict):
                inner = body
                if len(body) == 1 and isinstance(next(iter(body.values())),
                                                 dict):
                    inner = next(iter(body.values()))
                h = _ci(inner, "inputHeight")
                w = _ci(inner, "inputWidth")
                c = _ci(inner, "numChannels")
                if h and w and c:
                    return I.convolutional(int(h), int(w), int(c))
        raise Dl4jImportError(
            "CNN config without spatial input dims: pass input_type=")
    if k in ("graveslstm", "lstm", "rnnoutput", "embedding"):
        if k == "embedding":
            return I.feed_forward(n_in)
        return I.recurrent(n_in, None)
    return I.feed_forward(n_in)


def read_multilayer_config(config_json, input_type=None):
    """MultiLayerConfiguration JSON (MultiLayerConfiguration.toJson:120
    format) -> (MultiLayerConfiguration, [(kind, body), ...])."""
    cfg = (json.loads(config_json) if isinstance(config_json, str)
           else config_json)
    confs = cfg.get("confs")
    if confs is None:
        raise Dl4jImportError("not a MultiLayerConfiguration (no 'confs')")
    layers_json = []
    for c in confs:
        layer = c.get("layer")
        if not isinstance(layer, dict) or len(layer) != 1:
            raise Dl4jImportError(f"malformed layer entry: {layer!r}")
        (kind, body), = layer.items()
        layers_json.append((kind, body))
    layers = tuple(_layer_from_json(k, b) for k, b in layers_json)
    it = _infer_input_type(layers_json, cfg.get("inputPreProcessors"),
                           input_type)
    tbptt = None
    if str(cfg.get("backpropType", "Standard")).lower() == "truncatedbptt":
        tbptt = int(cfg.get("tbpttFwdLength", 20))
    conf = MultiLayerConfiguration(
        layers=layers, input_type=it,
        updater=_updater_from_conf(layers_json[0][1]),
        backprop_type="tbptt" if tbptt else "standard",
        tbptt_fwd_length=tbptt or 20,
        tbptt_back_length=int(cfg.get("tbpttBackLength", tbptt or 20)))
    return conf, layers_json


# ---------------------------------------------------------------------------
# flat param vector -> per-layer pytrees
# ---------------------------------------------------------------------------


def _take(flat, pos, n):
    if pos + n > flat.size:
        raise Dl4jImportError(
            f"params exhausted: need {pos + n}, have {flat.size}")
    return flat[pos:pos + n], pos + n


def _lstm_col_perm(h):
    """DL4J gate blocks [a, f, o, i] -> framework [i, f, g, o]."""
    blocks = [np.arange(3 * h, 4 * h),   # i  <- wG (input mod gate)
              np.arange(h, 2 * h),       # f  <- wF
              np.arange(0, h),           # g  <- wI (candidate)
              np.arange(2 * h, 3 * h)]   # o  <- wO
    return np.concatenate(blocks)


def _split_layer_params(layer, kind, body, in_type, flat, pos):
    """Slice one layer's segment off the flat vector -> (params, state, pos).
    Layouts per the param initializers cited in the module docstring."""
    k = kind.lower()
    params, state = {}, {}
    if isinstance(layer, (L.DenseLayer, L.EmbeddingLayer, L.AutoEncoder)) \
            or k in ("dense", "output", "rnnoutput", "embedding",
                     "autoencoder"):
        n_in = int(_ci(body, "nIn"))
        n_out = int(_ci(body, "nOut"))
        w, pos = _take(flat, pos, n_in * n_out)
        params["W"] = np.reshape(w, (n_in, n_out), order="F")
        b, pos = _take(flat, pos, n_out)
        params["b"] = b.copy()
        if k == "autoencoder":
            # AutoEncoderParamInitializer appends decoder vb (nIn)
            vb, pos = _take(flat, pos, n_in)
            params["vb"] = vb.copy()
    elif k in ("convolution", "convolution2d"):
        n_in = int(_ci(body, "nIn"))
        n_out = int(_ci(body, "nOut"))
        kh, kw = _pair(_ci(body, "kernelSize"), (3, 3))
        b, pos = _take(flat, pos, n_out)
        params["b"] = b.copy()
        w, pos = _take(flat, pos, n_out * n_in * kh * kw)
        w = np.reshape(w, (n_out, n_in, kh, kw), order="C")
        params["W"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO
    elif k == "batchnormalization":
        n = (in_type.channels if isinstance(in_type, I.ConvolutionalType)
             else in_type.size)
        if layer.use_gamma_beta:
            g, pos = _take(flat, pos, n)
            be, pos = _take(flat, pos, n)
            params["gamma"], params["beta"] = g.copy(), be.copy()
        m, pos = _take(flat, pos, n)
        v, pos = _take(flat, pos, n)
        state["mean"], state["var"] = m.copy(), v.copy()
    elif k in ("graveslstm", "lstm"):
        n_in = int(_ci(body, "nIn"))
        h = int(_ci(body, "nOut"))
        peep = (k == "graveslstm")
        rw_cols = 4 * h + (3 if peep else 0)
        perm = _lstm_col_perm(h)
        wx, pos = _take(flat, pos, n_in * 4 * h)
        wx = np.reshape(wx, (n_in, 4 * h), order="F")
        params["Wx"] = np.ascontiguousarray(wx[:, perm])
        rw, pos = _take(flat, pos, h * rw_cols)
        rw = np.reshape(rw, (h, rw_cols), order="F")
        params["Wh"] = np.ascontiguousarray(rw[:, perm])
        if peep:
            # peephole cols [4H..4H+2] = [wFF(f), wOO(o), wGG(i)]
            params["Wp"] = np.ascontiguousarray(
                np.stack([rw[:, 4 * h + 2], rw[:, 4 * h], rw[:, 4 * h + 1]]))
        b, pos = _take(flat, pos, 4 * h)
        params["b"] = np.ascontiguousarray(b[perm])
    # parameterless kinds contribute nothing
    return params, state, pos


def params_from_flat(conf, layers_json, flat):
    """DL4J flat param row vector -> per-layer [params], [state] lists
    matching ``conf`` (already built by read_multilayer_config)."""
    flat = np.asarray(flat).reshape(-1).astype(np.float32)
    types, _ = conf.layer_input_types()
    params, states = [], []
    pos = 0
    for layer, (kind, body), in_type in zip(conf.layers, layers_json, types):
        p, s, pos = _split_layer_params(layer, kind, body, in_type, flat, pos)
        params.append(p)
        states.append(s)
    if pos != flat.size:
        raise Dl4jImportError(
            f"flat params length {flat.size} != consumed {pos} "
            "(layer catalog mismatch)")
    return params, states


# ---------------------------------------------------------------------------
# ComputationGraph configs (the format every zoo pretrainedUrl zip uses —
# ResNet50.java etc. are graphs)
# ---------------------------------------------------------------------------


def _vertex_from_json(kind: str, body: dict):
    """One GraphVertex JSON (wrapper-object per GraphVertex.java:39-56) ->
    (my vertex object | layer, layer_json_or_None)."""
    k = kind.lower()
    if k == "layervertex":
        layer_conf = _ci(body, "layerConf") or {}
        layer = layer_conf.get("layer")
        if not isinstance(layer, dict) or len(layer) != 1:
            raise Dl4jImportError(f"malformed LayerVertex body: {body!r}")
        (lk, lb), = layer.items()
        pre = _ci(body, "preProcessor")
        if pre is not None:
            pcls = str(pre.get("@class", "") or next(iter(pre), "")
                       if isinstance(pre, dict) else pre).lower()
            if "cnntofeedforward" not in pcls:
                # rank adaption is implicit here for the common cases; an
                # unknown preprocessor means silently-wrong numerics, so
                # refuse loudly instead
                raise Dl4jImportError(
                    f"LayerVertex preprocessor {pre!r} unsupported")
        return _layer_from_json(lk, lb), (lk, lb, pre)
    if k == "mergevertex":
        return G.MergeVertex(), None
    if k == "elementwisevertex":
        op = str(_ci(body, "op", default="Add")).lower()
        return G.ElementWiseVertex(op={"add": "add", "subtract": "subtract",
                                       "product": "product",
                                       "average": "average",
                                       "max": "max"}.get(op, "add")), None
    if k == "subsetvertex":
        return G.SubsetVertex(from_idx=int(_ci(body, "from", default=0)),
                              to_idx=int(_ci(body, "to", default=0))), None
    if k == "stackvertex":
        return G.StackVertex(), None
    if k == "unstackvertex":
        return G.UnstackVertex(index=int(_ci(body, "from", default=0)),
                               stack_size=int(_ci(body, "stackSize",
                                                  default=1))), None
    if k == "scalevertex":
        return G.ScaleVertex(factor=float(_ci(body, "scaleFactor",
                                              default=1.0))), None
    if k == "shiftvertex":
        return G.ShiftVertex(amount=float(_ci(body, "shiftFactor",
                                              default=0.0))), None
    if k == "l2normalizevertex":
        return G.L2NormalizeVertex(), None
    if k == "l2vertex":
        return G.L2Vertex(), None
    if k == "poolhelpervertex":
        return G.PoolHelperVertex(), None
    if k == "lasttimestepvertex":
        return G.LastTimeStepVertex(), None
    if k == "duplicatetotimeseriesvertex":
        # this framework's vertex carries a static T; read_graph_config
        # resolves it from the DL4J inputName's RecurrentType (and refuses
        # when it can't — a silent T=1 broadcast would corrupt numerics)
        return G.DuplicateToTimeSeriesVertex(), None
    if k == "preprocessorvertex":
        # map the common preprocessor classes onto the explicit-conversion
        # vertex; anything else defers to this framework's implicit rank
        # adaption (nn/conf/inputs.py) via a cnn_to_ff-style no-op
        pre = _ci(body, "preProcessor") or {}
        pcls = ""
        if isinstance(pre, dict):
            pcls = str(pre.get("@class", "") or next(iter(pre), ""))
        pl = pcls.lower()
        if "cnntofeedforward" in pl:
            return G.PreprocessorVertex(kind="cnn_to_ff"), None
        if "feedforwardtocnn" in pl:
            return G.PreprocessorVertex(
                kind="ff_to_cnn",
                height=int(_ci(pre, "inputHeight", default=0) or 0),
                width=int(_ci(pre, "inputWidth", default=0) or 0),
                channels=int(_ci(pre, "numChannels", default=0) or 0)), None
        if "rnntofeedforward" in pl:
            return G.PreprocessorVertex(kind="rnn_to_ff"), None
        if "feedforwardtornn" in pl:
            return G.PreprocessorVertex(
                kind="ff_to_rnn",
                timesteps=int(_ci(pre, "timesteps", default=1) or 1)), None
        if "cnntornn" in pl:
            return G.PreprocessorVertex(kind="cnn_to_rnn"), None
        raise Dl4jImportError(
            f"unsupported PreprocessorVertex preprocessor {pcls!r}")
    raise Dl4jImportError(f"unsupported DL4J graph vertex type {kind!r}")


def _reference_topo_order(inputs, vertex_names, vertex_inputs):
    """Kahn FIFO exactly as ComputationGraph.topologicalSortOrder:1194 —
    indices assigned inputs-first then JSON map order, seeds and edge
    releases processed in ascending index order — because the FLAT PARAM
    VECTOR is laid out in this order (ComputationGraph.java:455-463)."""
    names = list(inputs) + list(vertex_names)
    idx_of = {n: i for i, n in enumerate(names)}
    in_edges = {i: set() for i in range(len(names))}
    out_edges = {i: set() for i in range(len(names))}
    for v, ins in vertex_inputs.items():
        for s in ins:
            in_edges[idx_of[v]].add(idx_of[s])
            out_edges[idx_of[s]].add(idx_of[v])
    queue = [i for i in range(len(names)) if not in_edges[i]]
    out = []
    while queue:
        nxt = queue.pop(0)
        out.append(nxt)
        for v in sorted(out_edges[nxt]):
            in_edges[v].discard(nxt)
            if not in_edges[v]:
                queue.append(v)
    if len(out) != len(names):
        raise Dl4jImportError("cycle in graph config")
    return [names[i] for i in out if names[i] not in set(inputs)]


def read_graph_config(config_json, input_type=None):
    """ComputationGraphConfiguration JSON -> (GraphConfiguration,
    {vertex_name: (kind, layer_body) or None}, param_order)."""
    cfg = (json.loads(config_json) if isinstance(config_json, str)
           else config_json)
    vertices = cfg.get("vertices")
    if vertices is None:
        raise Dl4jImportError("not a ComputationGraphConfiguration "
                              "(no 'vertices')")
    net_inputs = cfg.get("networkInputs", [])
    net_outputs = cfg.get("networkOutputs", [])
    vertex_inputs = cfg.get("vertexInputs", {})

    layer_bodies = {}
    built = {}
    first_layer_body = None
    for name, wrapped in vertices.items():
        if not isinstance(wrapped, dict) or len(wrapped) != 1:
            raise Dl4jImportError(f"malformed vertex entry {name!r}")
        (kind, body), = wrapped.items()
        obj, lb = _vertex_from_json(kind, body)
        built[name] = obj
        layer_bodies[name] = lb
        if lb is not None and first_layer_body is None:
            first_layer_body = lb

    if input_type is None:
        if first_layer_body is None:
            raise Dl4jImportError("graph has no layers; pass input_type=")
        input_type = _infer_input_type([first_layer_body[:2]],
                                       cfg.get("inputPreProcessors"), None)

    tbptt = None
    if str(cfg.get("backpropType", "Standard")).lower() == "truncatedbptt":
        tbptt = int(cfg.get("tbpttFwdLength", 20))
    # network-wide updater from the first layer conf (same convention as
    # the MLN reader)
    g = G.GraphBuilder(
        updater=(_updater_from_conf(first_layer_body[1])
                 if first_layer_body is not None else None),
        backprop_type="tbptt" if tbptt else "standard",
        tbptt_fwd_length=tbptt or 20,
        tbptt_back_length=int(cfg.get("tbpttBackLength", tbptt or 20)))
    g.add_inputs(*net_inputs)
    types = list(input_type) if isinstance(input_type, (list, tuple)) \
        else [input_type] * len(net_inputs)
    g.set_input_types(*types)

    # resolve DuplicateToTimeSeriesVertex timesteps from its DL4J
    # inputName (rnn/DuplicateToTimeSeriesVertex.java stores the name of a
    # [B,T,*] input whose T it copies; this framework's vertex is static-T)
    _Dup = G.DuplicateToTimeSeriesVertex
    type_of_input = dict(zip(net_inputs, types))
    for name, wrapped in vertices.items():
        if not isinstance(built.get(name), _Dup):
            continue
        (_, body), = wrapped.items()
        ref = _ci(body, "inputName")
        ref_t = type_of_input.get(ref)
        t = getattr(ref_t, "timesteps", None)
        if t is None:
            raise Dl4jImportError(
                f"DuplicateToTimeSeriesVertex {name!r} references input "
                f"{ref!r} whose timestep count is unknown — pass an "
                "input_type with explicit timesteps")
        built[name] = _Dup(timesteps=int(t))
    for name, obj in built.items():
        ins = vertex_inputs.get(name, [])
        if isinstance(obj, L.Layer):
            g.add_layer(name, obj, *ins)
        else:
            g.add_vertex(name, obj, *ins)
    g.set_outputs(*net_outputs)
    conf = g.build()
    order = _reference_topo_order(net_inputs, list(vertices), vertex_inputs)
    return conf, layer_bodies, order


def _install_params(target_p, target_s, imported_p, imported_s, label):
    """Shape-checked copy of one layer's imported params/state into the
    initialized tensors, on their device and in their dtype (shared by the
    MLN and CG restore paths)."""
    for key, arr in imported_p.items():
        if key not in target_p:
            # the DL4J format always stores a bias; a has_bias=False layer
            # here has no slot — an all-zero import is exactly equivalent,
            # anything else would silently change the model
            if np.all(arr == 0):
                continue
            raise Dl4jImportError(
                f"{label}: zip stores non-zero {key!r} but the model layer "
                f"has no such parameter (params: {sorted(target_p)})")
        want = tuple(np.shape(target_p[key]))
        if tuple(arr.shape) != want:
            raise Dl4jImportError(
                f"{label} param {key!r}: zip has {arr.shape}, model needs "
                f"{want}")
        install(target_p[key], arr)
    for key, arr in imported_s.items():
        want = tuple(np.shape(target_s[key]))
        if tuple(arr.shape) != want:
            raise Dl4jImportError(
                f"{label} state {key!r}: zip has {arr.shape}, model needs "
                f"{want}")
        install(target_s[key], arr)


def _cnn_flatten_permutation(h, w, c):
    """Row permutation taking DL4J's CnnToFeedForwardPreProcessor flatten
    (NCHW activations, channel-major: index = c*H*W + h*W + w) to this
    framework's NHWC flatten (index = h*W*C + w*C + c). Same transform as
    the Keras importer's channels_first handling."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0) \
        .reshape(-1)


def restore_computation_graph(path, input_type=None, load_updater=False, *,
                              device="cuda"):
    """restoreComputationGraph (ModelSerializer.java) for this framework:
    flat params slice in the REFERENCE's topological order (emulated in
    _reference_topo_order) since that is the layout the zips store. As in
    the MLN reader, ``load_updater`` keeps the raw updaterState.bin vector
    on ``net.dl4j_updater_state``."""
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        cfg = json.loads(zf.read("configuration.json").decode("utf-8"))
        conf, layer_bodies, order = read_graph_config(cfg, input_type)
        if "coefficients.bin" not in names:
            raise Dl4jImportError("zip has no coefficients.bin")
        flat = read_nd4j(zf.read("coefficients.bin")).reshape(-1) \
            .astype(np.float32)
        net = G.ComputationGraph(conf, device=device)
        net.init()
        pos = 0
        new_p = net.params
        new_s = net.state
        for vname in order:
            lb = layer_bodies.get(vname)
            if lb is None:
                continue
            kind, body, pre = lb
            # input type for BN feature count: my CG's inferred vertex
            # input types
            vdef = net._defs[vname]
            in_t = net._types[vdef.inputs[0]] if vdef.inputs else None
            layer = vdef.vertex.layer
            p, s, pos = _split_layer_params(layer, kind, body, in_t, flat,
                                            pos)
            if pre is not None and "W" in p and p["W"].ndim == 2:
                # CnnToFeedForward LayerVertex preprocessor: the dense
                # weight rows are stored in DL4J's channel-major CHW
                # flatten; re-order to this framework's HWC flatten
                if isinstance(in_t, I.ConvolutionalType):
                    perm = _cnn_flatten_permutation(
                        in_t.height, in_t.width, in_t.channels)
                    if p["W"].shape[0] == perm.size:
                        p["W"] = np.ascontiguousarray(p["W"][perm])
            _install_params(new_p[vname], new_s[vname], p, s,
                            f"vertex {vname!r}")
        if pos != flat.size:
            raise Dl4jImportError(
                f"flat params length {flat.size} != consumed {pos}")
        if load_updater and "updaterState.bin" in names:
            net.dl4j_updater_state = read_nd4j(zf.read("updaterState.bin"))
        return net


# ---------------------------------------------------------------------------
# zip restore / write
# ---------------------------------------------------------------------------


def restore_multilayer_network(path, input_type=None, load_updater=False, *,
                               device="cuda") -> MultiLayerNetwork:
    """ModelSerializer.restoreMultiLayerNetwork(:136) for this framework:
    read the zip, map config + params (+ updater state flat vector kept on
    ``net.dl4j_updater_state`` for inspection — the reference's view-block
    layout is updater-specific and is not re-split here)."""
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        if "configuration.json" not in names:
            raise Dl4jImportError("zip has no configuration.json")
        cfg_raw = zf.read("configuration.json").decode("utf-8")
        cfg = json.loads(cfg_raw)
        if "confs" not in cfg:
            if "vertices" in cfg:
                raise Dl4jImportError(
                    "this is a ComputationGraph zip — use "
                    "restore_computation_graph")
            raise Dl4jImportError("unrecognized configuration.json")
        conf, layers_json = read_multilayer_config(cfg, input_type)
        if "coefficients.bin" not in names:
            raise Dl4jImportError("zip has no coefficients.bin")
        flat = read_nd4j(zf.read("coefficients.bin"))
        net = MultiLayerNetwork(conf, device=device)
        net.init()
        params, states = params_from_flat(conf, layers_json, flat)
        # shape-check against the initialized tensors, then install
        for i, (p, s) in enumerate(zip(params, states)):
            _install_params(net.params[i], net.state[i], p, s, f"layer {i}")
        if load_updater and "updaterState.bin" in names:
            net.dl4j_updater_state = read_nd4j(zf.read("updaterState.bin"))
        return net


# ---------------------------------------------------------------------------
# export (also the spec-authored fixture writer for tests)
# ---------------------------------------------------------------------------

_KIND_OF = {
    L.DenseLayer: "dense", L.OutputLayer: "output",
    L.RnnOutputLayer: "rnnoutput", L.EmbeddingLayer: "embedding",
    L.ConvolutionLayer: "convolution", L.SubsamplingLayer: "subsampling",
    L.BatchNormalization: "batchNormalization", L.LSTM: "LSTM",
    L.GravesLSTM: "gravesLSTM", L.ActivationLayer: "activation",
    L.DropoutLayer: "dropout", L.GlobalPoolingLayer: "GlobalPooling",
    L.LossLayer: "loss", L.AutoEncoder: "autoEncoder",
}

def _act_json(name):
    base = {"leaky_relu": "LReLU", "relu": "ReLU", "sigmoid": "Sigmoid",
            "tanh": "TanH", "softmax": "Softmax", "identity": "Identity",
            "softplus": "SoftPlus", "elu": "ELU", "selu": "SELU",
            "cube": "Cube", "hardtanh": "HardTanH",
            "hardsigmoid": "HardSigmoid", "softsign": "SoftSign",
            "swish": "Swish", "rationaltanh": "RationalTanh",
            "rectifiedtanh": "RectifiedTanh"}.get(name)
    if base is None:
        # refuse rather than silently exporting Identity
        raise Dl4jImportError(
            f"activation {name!r} has no DL4J export mapping")
    return {"@class": f"org.nd4j.linalg.activations.impl.Activation{base}"}


def _loss_json(name):
    base = {"mcxent": "LossMCXENT",
            "negativeloglikelihood": "LossNegativeLogLikelihood",
            "mse": "LossMSE", "mae": "LossMAE", "xent": "LossBinaryXENT",
            "l1": "LossL1", "l2": "LossL2",
            "hinge": "LossHinge", "squared_hinge": "LossSquaredHinge",
            "kl_divergence": "LossKLD",
            "cosine_proximity": "LossCosineProximity",
            "poisson": "LossPoisson",
            "mean_squared_log_error": "LossMSLE",
            "mean_absolute_percentage_error": "LossMAPE"}.get(name)
    if base is None:
        raise Dl4jImportError(f"loss {name!r} has no DL4J export mapping")
    return {"@class": f"org.nd4j.linalg.lossfunctions.impl.{base}"}


def _layer_json(layer, in_type):
    """Framework layer -> (kind, DL4J-field-named body). Only fields the
    reader consumes are emitted — enough for round-trip + cross-checking."""
    kind = _KIND_OF.get(type(layer))
    if kind is None:
        raise Dl4jImportError(f"cannot export layer {type(layer).__name__}")
    body = {}
    act = getattr(layer, "activation", None)
    if act is not None and isinstance(act, str):
        body["activationFn"] = _act_json(act)
    if hasattr(layer, "n_out"):
        body["nout"] = int(layer.n_out)
    # nIn from shape inference
    if isinstance(layer, L.RnnOutputLayer):
        body["nin"] = int(in_type.size)
    elif isinstance(layer, (L.DenseLayer, L.EmbeddingLayer, L.AutoEncoder)):
        body["nin"] = int(I.adapted_type(in_type, I.FeedForwardType).size)
    elif isinstance(layer, L.ConvolutionLayer):
        body["nin"] = int(in_type.channels)
        body["kernelSize"] = list(layer.kernel)
        body["stride"] = list(layer.stride)
        if layer.padding == "same":
            body["convolutionMode"] = "Same"
        else:
            body["convolutionMode"] = "Truncate"
            body["padding"] = list(layer.pad)
    elif isinstance(layer, (L.LSTM, L.GravesLSTM)):
        body["nin"] = int(in_type.size)
        body["forgetGateBiasInit"] = float(layer.forget_gate_bias)
    elif isinstance(layer, L.SubsamplingLayer):
        body["kernelSize"] = list(layer.kernel)
        body["stride"] = list(layer.stride)
        body["poolingType"] = layer.mode.upper()
        if layer.padding == "same":
            body["convolutionMode"] = "Same"
        else:
            body["convolutionMode"] = "Truncate"
            body["padding"] = list(layer.pad)
    elif isinstance(layer, L.BatchNormalization):
        body["decay"] = float(layer.decay)
        body["eps"] = float(layer.eps)
        body["lockGammaBeta"] = not layer.use_gamma_beta
    elif isinstance(layer, L.GlobalPoolingLayer):
        body["poolingType"] = layer.mode.upper()
    elif isinstance(layer, L.DropoutLayer):
        body["dropOut"] = 1.0 - float(layer.rate)
    if isinstance(layer, (L.OutputLayer, L.RnnOutputLayer, L.LossLayer)):
        body["lossFn"] = _loss_json(layer.loss)
    wi = getattr(layer, "weight_init", None)
    if isinstance(wi, str):
        body["weightInit"] = wi.upper()
    if layer.name:
        body["layerName"] = layer.name
    return kind, body


def _updater_json(updater):
    lr = float(getattr(updater, "learning_rate", 0.1) or 0.1) \
        if isinstance(getattr(updater, "learning_rate", None),
                      (int, float)) else 0.1
    name = {_updaters.Sgd: "SGD", _updaters.Nesterovs: "NESTEROVS",
            _updaters.Adam: "ADAM", _updaters.AdaMax: "ADAMAX",
            _updaters.Nadam: "NADAM", _updaters.AdaGrad: "ADAGRAD",
            _updaters.AdaDelta: "ADADELTA", _updaters.RmsProp: "RMSPROP",
            _updaters.NoOp: "NONE"}.get(type(updater), "SGD")
    extra = {}
    if isinstance(updater, _updaters.Nesterovs):
        extra["momentum"] = float(updater.momentum)
    if isinstance(updater, _updaters.Adam):
        extra["adamMeanDecay"] = float(updater.beta1)
        extra["adamVarDecay"] = float(updater.beta2)
    if isinstance(updater, _updaters.RmsProp):
        extra["rmsDecay"] = float(updater.decay)
    return name, lr, extra


def _host(t):
    """A tensor (or array) as a float32 numpy array on the host."""
    if torch.is_tensor(t):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _sorted_leaves(tree):
    """The leaves of a tree of lists and mappings in the JAX package's
    ``jax.tree_util.tree_leaves`` order: lists in order, dict keys sorted.
    ``None`` is an empty subtree there."""
    if tree is None:
        return
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _sorted_leaves(v)
    elif hasattr(tree, "items"):
        for k in sorted(tree.keys()):
            yield from _sorted_leaves(tree[k])
    else:
        yield tree


def _updater_entry(net):
    """``updaterState.bin``'s bytes: the updater state's leaves, flattened
    and concatenated as one row vector, or None when there is none."""
    if getattr(net, "opt_state", None) is None:
        return None
    leaves = [np.ravel(_host(a)) for a in _sorted_leaves(net.opt_state)]
    if not leaves:
        return None
    flat_u = np.concatenate(leaves)
    if not flat_u.size:
        return None
    ub = io.BytesIO()
    write_nd4j(flat_u.reshape(1, -1), ub)
    return ub.getvalue()


def _flat_layer_params(layer, kind, params, state):
    """Inverse of _split_layer_params: framework pytree -> DL4J segment."""
    k = kind.lower()
    out = []
    get = lambda key: _host(params[key])

    def bias(n):
        # the DL4J format always stores a bias; a has_bias=False layer
        # exports zeros (reads back as an explicit zero bias — identical
        # outputs)
        return (get("b") if "b" in params else np.zeros((n,), np.float32))

    if k in ("dense", "output", "rnnoutput", "embedding", "autoencoder"):
        W = get("W")
        out.append(np.ravel(W, order="F"))
        out.append(np.ravel(bias(W.shape[1]), order="C"))
        if k == "autoencoder":
            out.append(np.ravel(get("vb"), order="C"))
    elif k == "convolution":
        w = get("W")
        out.append(np.ravel(bias(w.shape[3]), order="C"))
        out.append(np.ravel(w.transpose(3, 2, 0, 1), order="C"))  # ->OIHW
    elif k == "batchnormalization":
        if "gamma" in params:
            out.append(get("gamma"))
            out.append(get("beta"))
        out.append(_host(state["mean"]))
        out.append(_host(state["var"]))
    elif k in ("graveslstm", "lstm"):
        h = get("b").size // 4
        perm = _lstm_col_perm(h)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        wx = get("Wx")[:, inv]
        wh = get("Wh")[:, inv]
        if "Wp" in params:
            wp = get("Wp")  # rows [i, f, o] -> cols [wFF(f), wOO(o), wGG(i)]
            wh = np.concatenate([wh, wp[1][:, None], wp[2][:, None],
                                 wp[0][:, None]], axis=1)
        out.append(np.ravel(wx, order="F"))
        out.append(np.ravel(wh, order="F"))
        out.append(np.ravel(get("b")[inv], order="C"))
    return out


def _vertex_json(vertex):
    """My vertex object -> (kind, DL4J-field body)."""
    if isinstance(vertex, G.MergeVertex):
        return "MergeVertex", {}
    if isinstance(vertex, G.ElementWiseVertex):
        return "ElementWiseVertex", {"op": vertex.op.capitalize()}
    if isinstance(vertex, G.SubsetVertex):
        return "SubsetVertex", {"from": vertex.from_idx,
                                "to": vertex.to_idx}
    if isinstance(vertex, G.StackVertex):
        return "StackVertex", {}
    if isinstance(vertex, G.UnstackVertex):
        return "UnstackVertex", {"from": vertex.index,
                                 "stackSize": vertex.stack_size}
    if isinstance(vertex, G.ScaleVertex):
        return "ScaleVertex", {"scaleFactor": vertex.factor}
    if isinstance(vertex, G.ShiftVertex):
        return "ShiftVertex", {"shiftFactor": vertex.amount}
    if isinstance(vertex, G.L2NormalizeVertex):
        return "L2NormalizeVertex", {}
    if isinstance(vertex, G.L2Vertex):
        return "L2Vertex", {}
    if isinstance(vertex, G.PoolHelperVertex):
        return "PoolHelperVertex", {}
    if isinstance(vertex, G.LastTimeStepVertex):
        return "LastTimeStepVertex", {}
    if isinstance(vertex, G.DuplicateToTimeSeriesVertex):
        return "DuplicateToTimeSeriesVertex", {}
    if isinstance(vertex, G.PreprocessorVertex):
        cls = {"cnn_to_ff": "CnnToFeedForwardPreProcessor",
               "ff_to_cnn": "FeedForwardToCnnPreProcessor",
               "rnn_to_ff": "RnnToFeedForwardPreProcessor",
               "ff_to_rnn": "FeedForwardToRnnPreProcessor",
               "cnn_to_rnn": "CnnToRnnPreProcessor"}.get(vertex.kind)
        if cls is None:
            raise Dl4jImportError(
                f"PreprocessorVertex kind {vertex.kind!r} has no DL4J "
                "export mapping")
        body = {"@class":
                f"org.deeplearning4j.nn.conf.preprocessor.{cls}"}
        if vertex.kind == "ff_to_cnn":
            body.update(inputHeight=vertex.height, inputWidth=vertex.width,
                        numChannels=vertex.channels)
        elif vertex.kind == "ff_to_rnn":
            body["timesteps"] = vertex.timesteps
        return "PreprocessorVertex", {"preProcessor": body}
    raise Dl4jImportError(
        f"cannot export vertex {type(vertex).__name__}")


def write_computation_graph(net, path, save_updater=False) -> None:
    """ModelSerializer.writeModel for a ComputationGraph: vertices map +
    vertexInputs + flat params in the reference's topological order."""
    LayerVertex = G.LayerVertex
    conf = net.conf
    name_upd, lr, extra = _updater_json(conf.updater)
    vertices = {}
    vertex_inputs = {}
    for v in conf.vertices:
        vertex_inputs[v.name] = list(v.inputs)
        if isinstance(v.vertex, LayerVertex):
            in_t = net._types[v.inputs[0]] if v.inputs else None
            kind, body = _layer_json(v.vertex.layer, in_t)
            body["updater"] = name_upd
            body["learningRate"] = lr
            body.update(extra)
            vertices[v.name] = {"LayerVertex": {"layerConf": {
                "layer": {kind: body}}}}
        else:
            vk, vb = _vertex_json(v.vertex)
            vertices[v.name] = {vk: vb}
    cfg = {"networkInputs": list(conf.inputs),
           "networkOutputs": list(conf.outputs),
           "vertices": vertices, "vertexInputs": vertex_inputs}
    if getattr(conf, "backprop_type", "standard") == "tbptt":
        cfg["backpropType"] = "TruncatedBPTT"
        cfg["tbpttFwdLength"] = conf.tbptt_fwd_length
        cfg["tbpttBackLength"] = conf.tbptt_back_length
    else:
        cfg["backpropType"] = "Standard"
    order = _reference_topo_order(conf.inputs, list(vertices),
                                  vertex_inputs)
    segments = []
    for vname in order:
        v = net._defs[vname]
        if isinstance(v.vertex, LayerVertex):
            in_t = net._types[v.inputs[0]] if v.inputs else None
            kind, body = _layer_json(v.vertex.layer, in_t)
            segments.extend(_flat_layer_params(
                v.vertex.layer, kind, net.params[vname], net.state[vname]))
    flat = (np.concatenate(segments) if segments
            else np.zeros((0,), np.float32))
    buf = io.BytesIO()
    write_nd4j(flat.reshape(1, -1), buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(cfg, indent=2))
        zf.writestr("coefficients.bin", buf.getvalue())
        updater = _updater_entry(net) if save_updater else None
        if updater is not None:
            zf.writestr("updaterState.bin", updater)


def write_multilayer_network(net: MultiLayerNetwork, path,
                             save_updater=False) -> None:
    """ModelSerializer.writeModel(:51) equivalent: zip with
    configuration.json (DL4J field names) + coefficients.bin (legacy Nd4j
    binary). Read back with restore_multilayer_network — and, format-wise,
    with the reference's own ModelSerializer."""
    conf = net.conf
    types, _ = conf.layer_input_types()
    confs = []
    name, lr, extra = _updater_json(conf.updater)
    segments = []
    for layer, in_type, p, s in zip(conf.layers, types, net.params,
                                    net.state):
        kind, body = _layer_json(layer, in_type)
        body["updater"] = name
        body["learningRate"] = lr
        body.update(extra)
        confs.append({"layer": {kind: body}})
        segments.extend(_flat_layer_params(layer, kind, p, s))
    cfg = {"backprop": True, "pretrain": False, "confs": confs}
    # CNN input dims ride in an inputPreProcessors entry, as DL4J's
    # setInputType does — _infer_input_type reads them back, so CNN zips
    # restore without the caller passing input_type. Only when layer 0 is
    # conv-family: a feedForwardToCnn entry in front of a dense layer
    # would tell DL4J to reshape flat input to 4D in the wrong place.
    first_fam = getattr(conf.layers[0], "input_family", None) \
        if conf.layers else None
    if isinstance(conf.input_type, I.ConvolutionalType) \
            and first_fam is I.ConvolutionalType:
        it = conf.input_type
        cfg["inputPreProcessors"] = {"0": {"feedForwardToCnn": {
            "inputHeight": int(it.height), "inputWidth": int(it.width),
            "numChannels": int(it.channels)}}}
    if conf.backprop_type == "tbptt":
        cfg["backpropType"] = "TruncatedBPTT"
        cfg["tbpttFwdLength"] = conf.tbptt_fwd_length
        cfg["tbpttBackLength"] = conf.tbptt_back_length
    else:
        cfg["backpropType"] = "Standard"
    flat = (np.concatenate(segments) if segments
            else np.zeros((0,), np.float32))
    buf = io.BytesIO()
    write_nd4j(flat.reshape(1, -1), buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", json.dumps(cfg, indent=2))
        zf.writestr("coefficients.bin", buf.getvalue())
        updater = _updater_entry(net) if save_updater else None
        if updater is not None:
            zf.writestr("updaterState.bin", updater)
