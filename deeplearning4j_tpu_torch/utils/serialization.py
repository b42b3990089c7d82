"""Model persistence: the JAX package's checkpoint zip, format version 1.

Layout inside the zip (``deeplearning4j_tpu/utils/serialization.py``):

    format.json     {"format_version": 1, "kind": "multilayer"|"graph",
                     "iteration": N, "epoch": N, "has_updater": bool,
                     "has_rng": bool}
    config.json     network configuration (serde JSON)
    arrays.npz      flat {path -> ndarray}; paths are jax keystr paths of
                    the params/state/opt_state trees, e.g. params[0]['Wx']

Both kinds are read and written: a MultiLayerNetwork's parameters are a
list of per-layer dicts (``params[1]['mha']['Wqkv']``) with per-layer
state beside them (``state[1]['mean']``, ``state[4]['a_bn']['var']``), a
ComputationGraph's a dict of per-vertex dicts (``params['stem_conv']['W']``)
with per-vertex state (``state['stem_bn']['mean']``,
``state['lossLayer']['centers']``).
Parameters and state load into the port's tensors. Updater state (``opt...``) loads into the
port's updater state under the same paths (Adam's ``opt['m'][1]['W']``,
RmsProp's ``opt[0]['W']``) and is written back from it, so a checkpoint
taken mid-training in either package resumes in the other with its
moments. The step RNG chain (``rng``) is kept as the raw array it is.

A bundle (``save_bundle``/``load_bundle``) is the same zip plus
``buckets.json``, the batch-size buckets the job ran with: one resumable
unit for ``continuous.StepDriver``. A bundle written by the JAX package
may also embed ``warm_manifest.zip``, serialized XLA executables; a CUDA
graph cannot be serialized, so the port drops that entry with a warning,
as the JAX package drops a manifest built for another backend.

A fitted input normalizer rides in the same zip as ``normalizer.json``
(``add_normalizer_to_model``, ``restore_normalizer``).
"""

from __future__ import annotations

import io
import json
import warnings
import zipfile
from dataclasses import dataclass

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.trees import flatten_tree

FORMAT_VERSION = 1


def _load_flat(template, arrays, prefix, what):
    """Copy ``arrays`` (keystr path -> ndarray) into the tensors of
    ``template`` under ``prefix``; every path and shape must match."""
    flat = flatten_tree(template, prefix)
    theirs = {k for k in arrays if k.startswith(prefix)}
    if set(flat) != theirs:
        raise ValueError(f"{what}: keys {sorted(theirs - set(flat))} are not in the port's "
                         f"layout, and {sorted(set(flat) - theirs)} are missing")
    with torch.no_grad():
        for key, dst in flat.items():
            src = np.asarray(arrays[key])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what} {key}: shape {src.shape} != expected "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src)))


def _write_model(z, net, save_updater):
    graph = isinstance(net, ComputationGraph)
    arrays = {k: t.detach().cpu().numpy()
              for k, t in flatten_tree(net.params or [], "params").items()}
    arrays.update({k: t.detach().cpu().numpy()
                   for k, t in flatten_tree(net.state, "state").items()})
    has_updater = bool(save_updater and net.opt_state is not None)
    if has_updater:
        arrays.update({k: t.detach().cpu().numpy()
                       for k, t in flatten_tree(net.opt_state, "opt").items()})
    if net.rng is not None:
        arrays["rng"] = net.rng
    meta = {"format_version": FORMAT_VERSION, "kind": "graph" if graph else "multilayer",
            "iteration": net.iteration, "epoch": net.epoch,
            "has_updater": has_updater, "has_rng": net.rng is not None}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    z.writestr("format.json", json.dumps(meta))
    z.writestr("config.json", net.conf.to_json())
    z.writestr("arrays.npz", buf.getvalue())


def save_model(net, path, *, save_updater=True):
    """Write a MultiLayerNetwork or ComputationGraph checkpoint the JAX
    package's ``load_model`` reads."""
    if net.params is None:
        raise ValueError("save_model needs an initialized network")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        _write_model(z, net, save_updater)
    return path


def params_from_numpy(net, params, state=None):
    """Load parameters given as the JAX package's ``net.params`` (a list of
    per-layer dicts for a MultiLayerNetwork, a dict of per-vertex dicts for
    a ComputationGraph, nested where a layer nests, of numpy arrays or
    anything ``np.asarray`` takes) into ``net``, on its device, and its
    ``state`` (BatchNormalization's running statistics, center-loss
    centers) the same way. Every key and shape must match the network's
    own layout. Returns ``net``."""
    if net.params is None:
        net.init()
    if isinstance(net, ComputationGraph):
        _load_flat(net.params, flatten_tree(params, "p"), "p", "parameters")
        if state is not None:
            _load_flat(net.state, flatten_tree(state, "s"), "s", "state")
        return net
    for what, mine, theirs in (("parameter", net.params, params), ("state", net.state, state)):
        if theirs is None:
            continue
        if len(theirs) != len(mine):
            raise ValueError(f"{len(theirs)} {what} dicts for {len(mine)} layers")
        for i, (m, t) in enumerate(zip(mine, theirs)):
            _load_flat(m, flatten_tree(t), "", f"layer {i} {what}")
    return net


def _read_model(z, device):
    meta = json.loads(z.read("format.json"))
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"Checkpoint format {meta['format_version']} is newer "
                         f"than supported {FORMAT_VERSION}")
    arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    conf_json = z.read("config.json").decode()
    if meta["kind"] == "graph":
        net = ComputationGraph(GraphConfiguration.from_json(conf_json), device=device)
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json), device=device)
    net.init()  # template tensors, overwritten below
    _load_flat(net.state, arrays, "state", "state")
    _load_flat(net.params, arrays, "params", "parameters")
    if meta.get("has_updater"):
        net.opt_state = net.conf.updater.init(net.params)
        _load_flat(net.opt_state, arrays, "opt", "updater state")
    if meta.get("has_rng"):
        net.rng = arrays["rng"]
    net.iteration = meta.get("iteration", 0)
    net.epoch = meta.get("epoch", 0)
    return net


def load_model(path, *, device="cuda"):
    """Restore a MultiLayerNetwork or ComputationGraph written by either
    package onto ``device``."""
    with zipfile.ZipFile(path) as z:
        return _read_model(z, device)


def _bucket_sizes(buckets):
    """A BucketRegistry or an iterable of sizes as the sorted int list of
    ``buckets.json``."""
    if hasattr(buckets, "sizes"):
        return buckets.sizes()
    return sorted(int(b) for b in buckets)


@dataclass
class Bundle:
    """One resumable unit: the restored network (params, state, updater
    state, step RNG chain, iteration and epoch) and the bucket registry the
    job ran with."""

    net: object
    buckets: object = None   # datasets.iterator.BucketRegistry | None


def save_bundle(net, path, *, buckets=None, save_updater=True):
    """Write the checkpoint, updater state and step RNG chain, and with
    ``buckets`` (a BucketRegistry or sizes) ``buckets.json``, into one zip
    that ``load_bundle`` (either package's) resumes from."""
    if net.params is None:
        raise ValueError("save_bundle needs an initialized network")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        _write_model(z, net, save_updater)
        if buckets is not None:
            z.writestr("buckets.json", json.dumps(_bucket_sizes(buckets)))
    return path


def load_bundle(path, *, device="cuda"):
    """Restore a ``Bundle`` onto ``device``. An embedded warm manifest
    (the JAX package's serialized executables) is dropped with a warning:
    the port captures its CUDA graphs at the first dispatch instead."""
    from deeplearning4j_tpu_torch.datasets.iterator import BucketRegistry

    with zipfile.ZipFile(path) as z:
        net = _read_model(z, device)
        names = set(z.namelist())
        buckets = (BucketRegistry(json.loads(z.read("buckets.json")))
                   if "buckets.json" in names else None)
    if "warm_manifest.zip" in names:
        warnings.warn(f"bundle {path}: the embedded warm manifest holds XLA executables, "
                      "which the port cannot run; dropped (the first dispatch captures "
                      "its CUDA graph instead)", stacklevel=2)
    return Bundle(net=net, buckets=buckets)


def add_normalizer_to_model(path, normalizer):
    """Attach a fitted normalizer (``datasets/normalizers.py``) to an
    existing checkpoint zip as ``normalizer.json``, the JAX package's entry
    (reference: ModelSerializer.addNormalizerToModel, which appends a
    Java-serialized ``normalizer.bin``)."""
    entry = normalizer.to_json()
    with zipfile.ZipFile(path, "a", zipfile.ZIP_DEFLATED) as z:
        if "normalizer.json" in z.namelist():
            raise ValueError(f"{path} already contains a normalizer")
        z.writestr("normalizer.json", entry)
    return path


def restore_normalizer(path):
    """The fitted normalizer attached to a checkpoint, or None (reference:
    ModelSerializer.restoreNormalizerFromFile). A DL4J zip's JVM-serialized
    ``normalizer.bin`` cannot be read and raises rather than be skipped:
    a model served without its normalizer answers wrongly and silently."""
    from deeplearning4j_tpu_torch.datasets.normalizers import _FittedNormalizer

    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        if "normalizer.json" in names:
            return _FittedNormalizer.from_json(z.read("normalizer.json").decode())
        if "normalizer.bin" in names:
            raise ValueError(
                f"{path} contains a JVM-serialized normalizer.bin (DL4J "
                "ModelSerializer format), which is not readable here. Re-fit the "
                "normalizer (datasets.normalizers) on the training data, or export "
                "its statistics from the JVM side; the model config and params in "
                "this zip still load.")
        return None
