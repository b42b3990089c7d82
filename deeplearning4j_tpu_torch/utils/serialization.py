"""Model persistence: the JAX package's checkpoint zip, format version 1.

Layout inside the zip (``deeplearning4j_tpu/utils/serialization.py``):

    format.json     {"format_version": 1, "kind": "multilayer"|"graph",
                     "iteration": N, "epoch": N, "has_updater": bool,
                     "has_rng": bool}
    config.json     network configuration (serde JSON)
    arrays.npz      flat {path -> ndarray}; paths are jax keystr paths of
                    the params/state/opt_state trees, e.g. params[0]['Wx']

Parameters load into the port's tensors; updater state (``opt...``) and the
step RNG chain (``rng``) are kept as the raw arrays they are and written
back unchanged, so a zip passed through the port still resumes in JAX.
"""

from __future__ import annotations

import io
import json
import re
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FORMAT_VERSION = 1

_PARAM_KEY = re.compile(r"^params\[(\d+)\]\['([^'\]]+)'\]$")


def param_key(i, name):
    """The jax keystr path of layer ``i``'s parameter ``name``."""
    return f"params[{i}]['{name}']"


def _write_model(z, net, save_updater):
    arrays = {}
    for i, p in enumerate(net.params or ()):
        for name, t in p.items():
            arrays[param_key(i, name)] = t.detach().cpu().numpy()
    has_updater = bool(save_updater and net.opt_arrays)
    if has_updater:
        arrays.update(net.opt_arrays)
    if net.rng is not None:
        arrays["rng"] = net.rng
    meta = {"format_version": FORMAT_VERSION, "kind": "multilayer",
            "iteration": net.iteration, "epoch": net.epoch,
            "has_updater": has_updater, "has_rng": net.rng is not None}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    z.writestr("format.json", json.dumps(meta))
    z.writestr("config.json", net.conf.to_json())
    z.writestr("arrays.npz", buf.getvalue())


def save_model(net, path, *, save_updater=True):
    """Write a MultiLayerNetwork checkpoint the JAX package's ``load_model``
    reads."""
    if net.params is None:
        raise ValueError("save_model needs an initialized network")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        _write_model(z, net, save_updater)
    return path


def params_from_numpy(net, params):
    """Load per-layer parameters given as the JAX package's ``net.params``
    (a list of dicts of arrays, numpy or anything ``np.asarray`` takes)
    into ``net``, on its device. Every key and shape must match the
    network's own layout. Returns ``net``."""
    if net.params is None:
        net.init()
    if len(params) != len(net.params):
        raise ValueError(f"{len(params)} parameter dicts for "
                         f"{len(net.params)} layers")
    for i, (mine, theirs) in enumerate(zip(net.params, params)):
        if set(mine) != set(theirs):
            raise ValueError(f"layer {i}: parameter keys {sorted(theirs)} != "
                             f"expected {sorted(mine)}")
        for name, dst in mine.items():
            src = np.asarray(theirs[name])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"layer {i} {name!r}: shape {src.shape} != "
                                 f"expected {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(src)))
    return net


def _read_model(z, device):
    meta = json.loads(z.read("format.json"))
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"Checkpoint format {meta['format_version']} is newer "
                         f"than supported {FORMAT_VERSION}")
    if meta["kind"] != "multilayer":
        raise NotImplementedError(f"checkpoint kind {meta['kind']!r} is not "
                                  "ported yet (MultiLayerNetwork only)")
    conf = MultiLayerConfiguration.from_json(z.read("config.json").decode())
    arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    net = MultiLayerNetwork(conf, device=device)
    net.init()  # template tensors, overwritten below
    params = [dict() for _ in conf.layers]
    for key, arr in arrays.items():
        m = _PARAM_KEY.match(key)
        if m:
            params[int(m.group(1))][m.group(2)] = arr
        elif key.startswith("params") or key.startswith("state"):
            raise NotImplementedError(f"checkpoint entry {key!r} belongs to a "
                                      "layer layout not ported yet")
    params_from_numpy(net, params)
    if meta.get("has_updater"):
        net.opt_arrays = {k: v for k, v in arrays.items() if k.startswith("opt")}
    if meta.get("has_rng"):
        net.rng = arrays["rng"]
    net.iteration = meta.get("iteration", 0)
    net.epoch = meta.get("epoch", 0)
    return net


def load_model(path, *, device="cuda"):
    """Restore a MultiLayerNetwork written by either package onto
    ``device``."""
    with zipfile.ZipFile(path) as z:
        return _read_model(z, device)
