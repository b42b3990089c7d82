"""Model persistence: the JAX package's checkpoint zip, format version 1.

Layout inside the zip (``deeplearning4j_tpu/utils/serialization.py``):

    format.json     {"format_version": 1, "kind": "multilayer"|"graph",
                     "iteration": N, "epoch": N, "has_updater": bool,
                     "has_rng": bool}
    config.json     network configuration (serde JSON)
    arrays.npz      flat {path -> ndarray}; paths are jax keystr paths of
                    the params/state/opt_state trees, e.g. params[0]['Wx']

Both kinds are read and written: a MultiLayerNetwork's parameters are a
list of per-layer dicts (``params[1]['mha']['Wqkv']``), a
ComputationGraph's a dict of per-vertex dicts (``params['stem_conv']['W']``)
with per-vertex state beside them (``state['stem_bn']['mean']``).
Parameters and state load into the port's tensors. Updater state (``opt...``) loads into the
port's updater state under the same paths (Adam's ``opt['m'][1]['W']``,
RmsProp's ``opt[0]['W']``) and is written back from it, so a checkpoint
taken mid-training in either package resumes in the other with its
moments. The step RNG chain (``rng``) is kept as the raw array it is.
"""

from __future__ import annotations

import io
import json
import zipfile

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
    if graph:
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
    anything ``np.asarray`` takes) into ``net``, on its device, and a
    graph's ``state`` the same way. Every key and shape must match the
    network's own layout. Returns ``net``."""
    if net.params is None:
        net.init()
    if isinstance(net, ComputationGraph):
        _load_flat(net.params, flatten_tree(params, "p"), "p", "parameters")
        if state is not None:
            _load_flat(net.state, flatten_tree(state, "s"), "s", "state")
        return net
    if state is not None and any(len(s) for s in state):
        raise NotImplementedError("layer state in a MultiLayerNetwork is not ported yet")
    if len(params) != len(net.params):
        raise ValueError(f"{len(params)} parameter dicts for "
                         f"{len(net.params)} layers")
    for i, (mine, theirs) in enumerate(zip(net.params, params)):
        _load_flat(mine, flatten_tree(theirs), "", f"layer {i} parameters")
    return net


def _read_model(z, device):
    meta = json.loads(z.read("format.json"))
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"Checkpoint format {meta['format_version']} is newer "
                         f"than supported {FORMAT_VERSION}")
    arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    if meta["kind"] == "graph":
        net = ComputationGraph(GraphConfiguration.from_json(z.read("config.json").decode()),
                               device=device)
        net.init()  # template tensors, overwritten below
        _load_flat(net.state, arrays, "state", "state")
    else:
        conf = MultiLayerConfiguration.from_json(z.read("config.json").decode())
        net = MultiLayerNetwork(conf, device=device)
        net.init()
        if any(k.startswith("state") for k in arrays):
            raise NotImplementedError("checkpoint carries layer state: stateful layers in a "
                                      "MultiLayerNetwork are not ported yet")
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
