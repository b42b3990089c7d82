"""Keras .h5 model import (the JAX package's
``deeplearning4j_tpu/modelimport/keras.py``, building the port's networks).

Reference analog: deeplearning4j-modelimport — KerasModelImport.java:50-233
(entry points), KerasModel.java (config build + weight copy),
Hdf5Archive.java (native HDF5 reads), KerasModelUtils weight copying
(SURVEY.md §2.6, §3.5 call stack). Reads Keras 1 & 2 files saved with
``model.save()`` (architecture + weights [+ training config]).

Differences from the reference:
- HDF5 access goes through the C++ bridge (``native/h5.py``).
- No runtime dim-ordering preprocessors: Keras TF models are
  channels_last/HWIO, already this framework's native layout; Theano/
  channels_first models are converted ONCE at import (kernel transposition
  + flatten-row permutation) so the running network is always NHWC (see
  layers.py docstring).
- The result is a ready MultiLayerNetwork / ComputationGraph on ``device``
  (default ``"cuda"``; a missing card raises): the network is initialised
  there, then every imported array is copied into its tensor, in the
  tensor's dtype.
"""

from __future__ import annotations

import json

import numpy as np

from deeplearning4j_tpu_torch.modelimport._tensors import install
from deeplearning4j_tpu_torch.modelimport.layers import KerasImportError, LOSSES, map_layer
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import updaters as _updaters
from deeplearning4j_tpu_torch.nn.conf import inputs as I
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _open(path):
    from deeplearning4j_tpu_torch.native.h5 import Hdf5Archive
    return Hdf5Archive(str(path))


def _model_config(archive) -> dict:
    raw = archive.read_attr_string("model_config")
    return json.loads(raw)


def _version_of(vstr) -> int:
    """'1.2.2' -> 1, '2.x' -> 2 — the one place the classification lives
    (used for both the archive attr and a config JSON's keras_version)."""
    return 1 if str(vstr).startswith("1") else 2


def _keras_version(archive) -> int:
    try:
        return _version_of(archive.read_attr_string("keras_version"))
    except IOError:
        return 2


def _layer_list(model_cfg: dict):
    cls = model_cfg.get("class_name")
    cfg = model_cfg.get("config")
    if cls == "Sequential":
        # Keras 1: config is the layer list; Keras 2: {"layers": [...]}
        layers = cfg if isinstance(cfg, list) else cfg.get("layers", [])
        return cls, layers
    if cls in ("Model", "Functional"):
        return cls, cfg.get("layers", [])
    raise KerasImportError(f"Unsupported Keras model class {cls!r}")


def _input_type_from_shape(shape, dim_ordering="tf"):
    """Keras batch_input_shape (batch, ...) -> InputType. channels_first
    models declare (batch, C, H, W); the network itself always runs NHWC —
    the importer's job is weight re-layout, not runtime transposition
    (reference: TensorFlowCnnToFeedForwardPreProcessor.java + the
    dim-ordering branches in KerasModel; here the transposition happens
    once at import)."""
    dims = [d for d in shape[1:]]
    if len(dims) == 1:
        if dims[0] is None:
            # [batch, None]: a variable-length token-id sequence (the only
            # Keras input this shape can mean — e.g. an Embedding consumer)
            return I.recurrent(1, None)
        return I.feed_forward(int(dims[0]))
    if len(dims) == 2:
        t, f = dims
        return I.recurrent(int(f), None if t is None else int(t))
    if len(dims) == 3:
        if dim_ordering == "th":
            ch, h, w = dims
        else:
            h, w, ch = dims
        return I.convolutional(int(h), int(w), int(ch))
    raise KerasImportError(f"Unsupported input shape {shape}")


def _model_dim_ordering(keras_layers, backend=None, keras_version=2):
    """Model-wide dim ordering: any layer declaring channels_first/th makes
    the model channels_first (Keras forbids mixing); otherwise Keras-1
    models saved from the Theano backend default to 'th'."""
    explicit = None
    for kl in keras_layers:
        lcfg = kl.get("config", {}) or {}
        fmt = lcfg.get("data_format", lcfg.get("dim_ordering"))
        if fmt in ("channels_first", "th"):
            return "th"
        if fmt in ("channels_last", "tf"):
            explicit = "tf"
    if explicit is None and keras_version == 1 and backend == "theano":
        return "th"
    return "tf"


def _backend(archive):
    try:
        return archive.read_attr_string("backend")
    except IOError:
        return None


def _cnn_flatten_permutation(h, w, c):
    """Row permutation taking a Keras channels_first flatten (C-major:
    index = c*H*W + h*W + w) to this framework's NHWC flatten (index =
    h*W*C + w*C + c). Apply as W_ours = W_keras[perm]."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _permute_flattened_dense(mapped_params, in_type, layer_desc):
    """If a dense-family kernel consumes implicitly-flattened conv features
    from a channels_first model, re-order its input rows."""
    W = mapped_params.get("W")
    if W is None or W.ndim != 2:
        return mapped_params
    h, w, c = in_type.height, in_type.width, in_type.channels
    if W.shape[0] != h * w * c:
        raise KerasImportError(
            f"{layer_desc}: dense kernel rows {W.shape[0]} do not match "
            f"flattened conv input {h}x{w}x{c}")
    out = dict(mapped_params)
    out["W"] = np.ascontiguousarray(W[_cnn_flatten_permutation(h, w, c)])
    return out


def _training_loss(archive):
    try:
        raw = archive.read_attr_string("training_config")
    except IOError:
        return None
    try:
        tc = json.loads(raw)
    except ValueError:
        return None
    loss = tc.get("loss")
    if isinstance(loss, dict) and loss.get("class_name"):
        loss = loss["class_name"]
    if isinstance(loss, str):
        # normalize CamelCase class names to snake_case keys
        key = loss if loss in LOSSES else \
            "".join("_" + ch.lower() if ch.isupper() else ch
                    for ch in loss).lstrip("_")
        return LOSSES.get(key)
    return None


def _walk_datasets(archive, base, rel=""):
    """All datasets under ``base``, keyed by path relative to it —
    the fallback for layer groups with NO weight_names attribute (the
    reference's tfscope .with.tensorflow.scope fixture nests weights
    under arbitrary scope groups without the attr; KerasModelImportTest
    loads it, so we must too)."""
    out = []
    here = f"{base}/{rel}".rstrip("/")
    for kind, name in archive.list(here):
        sub = f"{rel}/{name}".lstrip("/")
        if kind == "d":
            out.append(sub)
        elif kind == "g":
            out.extend(_walk_datasets(archive, base, sub))
    return out


def _read_layer_weights(archive, layer_name, prefix="model_weights/"):
    """{weight_name: np.ndarray} for one Keras layer group."""
    base = f"{prefix}{layer_name}"
    if not archive.exists(base):
        return {}
    try:
        names = archive.read_attr_strings("weight_names", base)
    except IOError:
        names = _walk_datasets(archive, base)
        return {wn: archive.read_dataset(f"{base}/{wn}") for wn in names}
    out = {}
    for wn in names:
        ds_path = f"{base}/{wn}"
        if not archive.exists(ds_path):
            # listed-but-unresolvable is a PARSE failure, not "no weights":
            # silently continuing would leave random init posing as the
            # imported model (the genuine tfscope fixture exposed exactly
            # this when scoped weight names were mis-read). KerasImportError
            # keeps the module's error contract (and is not IOError, so the
            # attr-missing fallback above cannot swallow it)
            raise KerasImportError(
                f"Keras archive lists weight {wn!r} for layer "
                f"{layer_name!r} but dataset {ds_path!r} is missing")
        out[wn] = archive.read_dataset(ds_path)
    return out


def _assign_params(layer, mapped_params, init_params, layer_desc):
    """Copy the imported params into the initialized ones, shape-checked."""
    for key, arr in mapped_params.items():
        if arr is None:
            continue
        if key not in init_params:
            raise KerasImportError(
                f"{layer_desc}: imported param {key!r} not in layer params "
                f"{sorted(init_params)}")
        want = tuple(init_params[key].shape)
        got = tuple(arr.shape)
        if want != got:
            raise KerasImportError(
                f"{layer_desc}: shape mismatch for {key!r}: model has {want}, "
                f"file has {got}")
        install(init_params[key], arr)


def _pre_adaptation_types(conf):
    """Per-layer input types BEFORE family adaptation — i.e. what the layer
    actually receives from upstream, so a FeedForward layer fed conv
    activations shows the ConvolutionalType being implicitly flattened."""
    cur = conf.input_type
    out = []
    for layer in conf.layers:
        out.append(cur)
        fam = layer.input_family
        if fam is not None and not isinstance(cur, fam):
            cur = I.adapted_type(cur, fam)
        cur = layer.output_type(cur)
    return out


# ---------------------------------------------------------------------------
# Sequential
# ---------------------------------------------------------------------------


def import_keras_sequential_config(model_config_json: str,
                                   keras_version: int = 2,
                                   dim_ordering: str | None = None):
    """Keras Sequential config JSON -> (MultiLayerConfiguration,
    [(layer_index_or_None, keras_name, weight_mapper)])."""
    model_cfg = json.loads(model_config_json) if isinstance(
        model_config_json, str) else model_config_json
    cls, keras_layers = _layer_list(model_cfg)
    if cls != "Sequential":
        raise KerasImportError("use import_keras_model_and_weights for "
                               f"{cls!r} models")
    if dim_ordering is None:
        dim_ordering = _model_dim_ordering(keras_layers,
                                           keras_version=keras_version)
    layers = []
    records = []  # (our_layer_index | None, keras_layer_name, weight_mapper)
    input_type = None
    for kl in keras_layers:
        lcls = kl["class_name"]
        lcfg = kl.get("config", {})
        name = lcfg.get("name") or kl.get("name") or lcls.lower()
        shape = lcfg.get("batch_input_shape", lcfg.get("input_shape"))
        if input_type is None and shape is not None:
            if "input_shape" in lcfg and "batch_input_shape" not in lcfg:
                shape = [None] + list(shape)
            if lcls == "Embedding":
                # [batch, T] TOKEN IDS (possibly variable-length), not T
                # scalar features — the imdb_lstm fixtures declare
                # batch_input_shape [null, null]
                t = shape[1] if len(shape) > 1 else None
                input_type = I.recurrent(1, None if t is None else int(t))
            else:
                input_type = _input_type_from_shape(shape, dim_ordering)
        if (lcls == "Embedding" and not layers
                and isinstance(input_type, I.FeedForwardType)):
            # explicit InputLayer([None, T]) followed by Embedding: T is a
            # token-sequence length, not T scalar features (same
            # reinterpretation the functional path applies to the source)
            input_type = I.recurrent(1, input_type.size)
        layer, wmap = map_layer(lcls, lcfg, keras_version, dim_ordering)
        if layer is None:
            records.append((None, name, wmap))
            continue
        chain = layer if isinstance(layer, list) else [layer]
        layers.append(chain[0])
        records.append((len(layers) - 1, name, wmap))  # weights -> first layer
        layers.extend(chain[1:])
    if input_type is None:
        raise KerasImportError("model config has no input shape "
                               "(batch_input_shape missing)")
    conf = MultiLayerConfiguration(
        layers=tuple(layers), input_type=input_type,
        updater=_updaters.Sgd(0.01))
    return conf, records


def import_keras_sequential_model_and_weights(path: str, *,
                                              device="cuda") -> MultiLayerNetwork:
    """Load a Keras Sequential .h5 (architecture + weights) into a
    MultiLayerNetwork on ``device`` (reference: KerasModelImport.
    importKerasSequentialModelAndWeights:143)."""
    with _open(path) as archive:
        version = _keras_version(archive)
        model_cfg = _model_config(archive)
        _, keras_layers = _layer_list(model_cfg)
        ordering = _model_dim_ordering(keras_layers, _backend(archive), version)
        conf, records = import_keras_sequential_config(
            model_cfg, version, dim_ordering=ordering)
        loss = _training_loss(archive)
        if loss is not None and conf.layers:
            last = conf.layers[-1]
            if type(last) is L.DenseLayer:
                import dataclasses as _dc
                new_last = L.OutputLayer(
                    **{f.name: getattr(last, f.name)
                       for f in _dc.fields(L.DenseLayer)}, loss=loss)
                conf = _dc.replace(conf,
                                   layers=conf.layers[:-1] + (new_last,))
        return _sequential_net_with_weights(conf, records, archive, ordering,
                                            device=device)


def _sequential_net_with_weights(conf, records, archive, ordering,
                                 weights_prefix="model_weights/", device="cuda"):
    """Build the MultiLayerNetwork and pour the archive's weights into it.
    ``weights_prefix``: layer groups live under /model_weights in a full
    model .h5 but at the ROOT of a save_weights()-style weights file."""
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    params = net.params
    state = net.state
    pre_types = _pre_adaptation_types(conf) if ordering == "th" else None
    n_expected = sum(1 for idx, _, wmap in records
                     if idx is not None and wmap is not None)
    n_loaded = 0
    for idx, keras_name, wmap in records:
        if idx is None or wmap is None:
            continue
        weights = _read_layer_weights(archive, keras_name,
                                      prefix=weights_prefix)
        if not weights:
            # a save_weights() archive keeps layer groups at the root while
            # a full-model .h5 nests them under /model_weights — a caller
            # guessing the wrong flavour would otherwise get a silently
            # random-initialized net posing as the import
            alt = "" if weights_prefix else "model_weights/"
            weights = _read_layer_weights(archive, keras_name, prefix=alt)
        if not weights:
            continue
        n_loaded += 1
        mapped_p, mapped_s = wmap(conf.layers[idx], weights)
        if (pre_types is not None
                and isinstance(pre_types[idx], I.ConvolutionalType)
                and conf.layers[idx].input_family is I.FeedForwardType):
            # dense consuming implicitly-flattened conv features: Keras
            # flattened C-major, we flatten HWC-major
            mapped_p = _permute_flattened_dense(
                mapped_p, pre_types[idx], f"layer {idx} ({keras_name})")
        _assign_params(conf.layers[idx], mapped_p, params[idx],
                       f"layer {idx} ({keras_name})")
        _assign_state(state[idx], mapped_s, f"layer {idx} ({keras_name})")
    if n_expected and not n_loaded:
        raise KerasImportError(
            "no layer group in the weights archive matched any "
            "weighted layer of the config (tried prefixes "
            f"{weights_prefix!r} and its alternate) — refusing to return "
            "a randomly initialized network posing as the import")
    return net


def _assign_state(init_state, mapped_state, layer_desc):
    """Copy the imported layer state (BatchNormalization's moving
    statistics) into the initialized state, shape-checked."""
    for key, arr in (mapped_state or {}).items():
        if arr is None or key not in (init_state or {}):
            continue
        arr = np.asarray(arr, np.float32)
        if tuple(init_state[key].shape) != arr.shape:
            raise KerasImportError(
                f"{layer_desc}: shape mismatch for state {key!r}: model has "
                f"{tuple(init_state[key].shape)}, file has {arr.shape}")
        install(init_state[key], arr)


def import_keras_sequential_config_and_weights(
        config_path: str, weights_path: str, *, device="cuda") -> MultiLayerNetwork:
    """Load a Keras Sequential model from a config JSON file + a separate
    save_weights() .h5 (reference: KerasModelImport.
    importKerasSequentialModelAndWeights(modelJsonFile, weightsFile) —
    exercised by the reference's own tfscope/model.json+model.weight
    fixture pair)."""
    with open(config_path) as f:
        model_cfg = json.load(f)
    _, keras_layers = _layer_list(model_cfg)
    with _open(weights_path) as archive:
        if "keras_version" in model_cfg:
            version = _version_of(model_cfg["keras_version"])
        else:
            # early Keras-1 to_json omits the field: fall back to the
            # weights archive's own keras_version attr (same probe the
            # full-h5 path uses) so Keras-1+Theano dim-ordering defaulting
            # still fires
            version = _keras_version(archive)
        ordering = _model_dim_ordering(keras_layers, _backend(archive),
                                       version)
        conf, records = import_keras_sequential_config(
            model_cfg, version, dim_ordering=ordering)
        return _sequential_net_with_weights(conf, records, archive,
                                            ordering, weights_prefix="",
                                            device=device)


# ---------------------------------------------------------------------------
# Functional models -> ComputationGraph
# ---------------------------------------------------------------------------

_MERGE_MODES = {
    "Add": ("elementwise", "add"), "add": ("elementwise", "add"),
    "Subtract": ("elementwise", "subtract"),
    "subtract": ("elementwise", "subtract"),
    "Multiply": ("elementwise", "product"),
    "multiply": ("elementwise", "product"),
    "Average": ("elementwise", "average"),
    "average": ("elementwise", "average"),
    "Maximum": ("elementwise", "max"), "maximum": ("elementwise", "max"),
    "Concatenate": ("merge", None), "concatenate": ("merge", None),
    "Merge": ("merge", None),
}


def import_keras_model_config(model_config_json, keras_version: int = 2,
                              dim_ordering: str | None = None, *, device="cuda"):
    """Keras functional-model config (JSON string or dict) -> an
    initialized ComputationGraph + weight records, no weights file needed
    (reference: KerasModelImport.importKerasModelConfiguration:66 — the
    config-only entry its KerasModelConfigurationTest drives)."""
    model_cfg = json.loads(model_config_json) if isinstance(
        model_config_json, str) else model_config_json
    cls, keras_layers = _layer_list(model_cfg)
    if cls == "Sequential":
        raise KerasImportError("use import_keras_sequential_config "
                               "for Sequential models")
    ordering = dim_ordering or _model_dim_ordering(
        keras_layers, keras_version=keras_version)
    return _graph_from_config(model_cfg, keras_layers, keras_version,
                              ordering, device)


def import_keras_model_and_weights(path: str, *, device="cuda"):
    """Load a Keras functional .h5 into a ComputationGraph on ``device``
    (reference: KerasModelImport.importKerasModelAndWeights:103)."""
    with _open(path) as archive:
        version = _keras_version(archive)
        model_cfg = _model_config(archive)
        cls, keras_layers = _layer_list(model_cfg)
        if cls == "Sequential":
            raise KerasImportError("use import_keras_sequential_model_and_weights "
                                   "for Sequential models")
        ordering = _model_dim_ordering(keras_layers, _backend(archive), version)
        graph, records = _graph_from_config(model_cfg, keras_layers,
                                            version, ordering, device)

        params = graph.params
        state = graph.state
        for vname, keras_name, wmap in records:
            weights = _read_layer_weights(archive, keras_name)
            if not weights:
                continue
            vdef = graph._defs[vname]
            mapped_p, mapped_s = wmap(vdef.vertex.layer, weights)
            if ordering == "th" and vdef.inputs:
                src_type = graph._types[vdef.inputs[0]]
                if (isinstance(src_type, I.ConvolutionalType)
                        and vdef.vertex.layer.input_family is I.FeedForwardType):
                    mapped_p = _permute_flattened_dense(
                        mapped_p, src_type, f"vertex {vname!r}")
            _assign_params(vdef.vertex.layer, mapped_p, params[vname],
                           f"vertex {vname!r}")
            _assign_state(state.get(vname), mapped_s, f"vertex {vname!r}")
        return graph


def _graph_from_config(model_cfg, keras_layers, version, ordering, device="cuda"):
    """(initialized ComputationGraph, [(vertex, keras_name, wmap)])."""
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph, ElementWiseVertex, GraphBuilder, MergeVertex)

    cfg = model_cfg["config"]
    builder = GraphBuilder(updater=_updaters.Sgd(0.01))
    input_names = [inp[0] for inp in cfg.get("input_layers", [])]
    output_names = [out[0] for out in cfg.get("output_layers", [])]
    records = []  # (vertex_name, keras_name, weight_mapper)

    input_types = {}
    for kl in keras_layers:
        lcls = kl["class_name"]
        lcfg = kl.get("config", {})
        name = kl.get("name") or lcfg.get("name")
        inbound = kl.get("inbound_nodes", [])
        # flatten keras's [[["src", node_idx, tensor_idx, {}], ...]] form
        srcs = []
        if inbound:
            if len(inbound) > 1:
                raise KerasImportError(
                    f"Layer {name!r} is applied {len(inbound)} times "
                    "(shared layer); shared-layer functional models are "
                    "not supported")
            node = inbound[0]
            if isinstance(node, dict):  # keras 3 style {"args": ...}
                raise KerasImportError("Keras 3 saved-model configs are "
                                       "not supported; save as .h5 from "
                                       "Keras 2")
            for entry in node:
                srcs.append(entry[0])
        if lcls == "InputLayer":
            shape = lcfg.get("batch_input_shape") or lcfg.get("batch_shape")
            input_types[name] = _input_type_from_shape(shape, ordering)
            continue
        kind = _MERGE_MODES.get(lcls)
        if kind is not None:
            if kind[0] == "elementwise":
                builder.add_vertex(name, ElementWiseVertex(op=kind[1]), *srcs)
            else:
                builder.add_vertex(name, MergeVertex(), *srcs)
            continue
        layer, wmap = map_layer(lcls, lcfg, version, ordering)
        if lcls == "Embedding":
            # an Embedding consumer means its source Input is a [B, T]
            # token-id sequence, not T scalar features — reinterpret the
            # recorded input type (same rule as the Sequential path)
            for src in srcs:
                it = input_types.get(src)
                if isinstance(it, I.FeedForwardType):
                    input_types[src] = I.recurrent(1, it.size)
        if layer is None:
            # structural no-op: alias by inserting an identity activation
            builder.add_vertex(
                name, _identity_vertex(), *srcs)
            continue
        chain = layer if isinstance(layer, list) else [layer]
        if len(chain) == 1:
            builder.add_layer(name, chain[0], *srcs)
            records.append((name, name, wmap))
        else:
            # param layer gets an internal name; downstream consumers see
            # the chain's final output under the Keras name
            inner = f"{name}__0"
            builder.add_layer(inner, chain[0], *srcs)
            records.append((inner, name, wmap))
            prev = inner
            for j, extra in enumerate(chain[1:-1], 1):
                nm = f"{name}__{j}"
                builder.add_layer(nm, extra, prev)
                prev = nm
            builder.add_layer(name, chain[-1], prev)

    builder.add_inputs(*input_names)
    builder.set_input_types(*[input_types[n] for n in input_names])
    builder.set_outputs(*output_names)
    graph = ComputationGraph(builder.build(), device=device)
    graph.init()
    return graph, records


def _identity_vertex():
    from deeplearning4j_tpu_torch.nn.graph import ScaleVertex
    return ScaleVertex(factor=1.0)
