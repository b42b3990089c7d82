"""Transfer learning (reference: nn/transferlearning/TransferLearning.java,
FineTuneConfiguration.java, TransferLearningHelper.java).

The port of ``deeplearning4j_tpu/nn/transfer.py``: the same builders and
fields. ``TransferLearning`` rebuilds a trained MultiLayerNetwork with a
frozen prefix and a changed tail, ``TransferLearningGraph`` does the same
for a ComputationGraph by vertex name, ``TransferLearningHelper``
featurizes inputs through the frozen prefix once.

Freezing belongs to the networks here: ``frozen_layers`` and
``frozen_vertices`` are attributes that their forward, ``make_train_step``
and updater honour (DL4J's FrozenLayer). A frozen layer runs with
``train=False`` in every pass, its parameters stay out of autograd, so no
backward runs through the frozen prefix, and out of the updater: after any
number of steps its parameters and state equal the source network's bit
for bit. Its updater state is left as initialized, as DL4J's FrozenLayer
trains with a no-op updater; the JAX package computes the frozen
gradients, advances their updater state and restores only the parameters.

Built networks own their parameters: every copy from the source is a real
copy. A checkpoint saves no frozen set (the JAX package's format has none
either): a restored network trains every layer until it is frozen again.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.utils.trees import flatten_tree


@dataclasses.dataclass
class FineTuneConfiguration:
    """Overrides applied when fine-tuning (reference:
    FineTuneConfiguration.java): ``l1``, ``l2`` and ``dropout`` on every
    layer that has the field, the updater and seed on the configuration."""

    updater: object = None
    l1: float = None
    l2: float = None
    dropout: float = None
    seed: int = None

    def layer_overrides(self):
        return {f: getattr(self, f) for f in ("l1", "l2", "dropout")
                if getattr(self, f) is not None}

    def override_layer(self, layer):
        """``layer`` with the overrides it has fields for."""
        upd = {k: v for k, v in self.layer_overrides().items() if hasattr(layer, k)}
        return dataclasses.replace(layer, **upd) if upd else layer

    def conf_overrides(self):
        return {k: v for k, v in (("updater", self.updater), ("seed", self.seed))
                if v is not None}

    def apply_to(self, conf: MultiLayerConfiguration) -> MultiLayerConfiguration:
        return dataclasses.replace(conf, layers=tuple(self.override_layer(l) for l in conf.layers),
                                   **self.conf_overrides())


def _clone_tree(tree):
    """Plain dicts of detached copies of ``tree``'s tensors."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    return {k: _clone_tree(v) for k, v in tree.items()}


def _copy_params(dst, src):
    """Copy the source entry's parameters into ``dst`` (a ParameterDict) in
    place when every key and shape matches; returns whether it did."""
    d, s = flatten_tree(dst), flatten_tree(src)
    if d.keys() != s.keys() or any(d[k].shape != s[k].shape for k in d):
        return False
    with torch.no_grad():
        for k, t in d.items():
            t.copy_(s[k])
    return True


def _param_dtype(net):
    for p in net.parameters():
        return p.dtype
    return None


class TransferLearning:
    """Builder over a trained MultiLayerNetwork (reference:
    TransferLearning.Builder)."""

    def __init__(self, net):
        if net.params is None:
            raise ValueError("the source network must be initialized or trained")
        self._src = net
        self._freeze_until = -1  # layers [0, freeze_until] frozen
        self._fine_tune = None
        self._removed_from = None
        self._appended = []
        self._replaced = {}

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, layer_idx):
        """Freeze layers 0..layer_idx inclusive."""
        self._freeze_until = layer_idx
        return self

    def remove_output_layer(self):
        self._removed_from = len(self._src.conf.layers) - 1
        return self

    def remove_layers_from(self, layer_idx):
        self._removed_from = layer_idx
        return self

    def replace_layer(self, idx, new_layer):
        self._replaced[idx] = new_layer
        return self

    def add_layer(self, layer):
        self._appended.append(layer)
        return self

    def build(self):
        """The new network on the source's device and in its parameter
        dtype: kept layers carry copies of the source's parameters and
        state, replaced and added ones a fresh initialisation."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        src = self._src
        keep = len(src.conf.layers) if self._removed_from is None else self._removed_from
        layers = [self._replaced.get(i, l) for i, l in enumerate(src.conf.layers[:keep])]
        layers += self._appended
        conf = dataclasses.replace(src.conf, layers=tuple(layers))
        if self._fine_tune is not None:
            conf = self._fine_tune.apply_to(conf)
        net = MultiLayerNetwork(conf, device=src.device)
        net.frozen_layers = tuple(range(self._freeze_until + 1))
        net.init(dtype=_param_dtype(src))
        for i in range(keep):
            if i not in self._replaced and _copy_params(net.params[i], src.params[i]):
                net.state[i] = _clone_tree(src.state[i])
        net.opt_state = conf.updater.init(net.params)
        return net


class TransferLearningHelper:
    """Featurization at the frozen boundary (reference:
    TransferLearningHelper.java): run inputs through the frozen prefix once
    (in inference mode), then train only the unfrozen tail on the
    features."""

    def __init__(self, net, frozen_until: int):
        self.net = net
        self.frozen_until = frozen_until

    def featurize(self, x):
        """The activations after layer ``frozen_until``, inference mode."""
        net = self.net
        from deeplearning4j_tpu_torch.nn.multilayer import _as_tensor
        from deeplearning4j_tpu_torch.utils import dtypes as _dtypes

        with _dtypes.policy_precision():
            return net.apply_fn(net.params, net.state, _as_tensor(x, net.device), train=False,
                                layer_limit=self.frozen_until + 1)[0]

    def unfrozen_net(self):
        """A network over the unfrozen tail layers, with copies of their
        parameters and state."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = self.net.conf
        k = self.frozen_until + 1
        types, _ = conf.layer_input_types()
        tail_conf = dataclasses.replace(conf, layers=tuple(conf.layers[k:]),
                                        input_type=types[k] if k < len(types)
                                        else conf.input_type)
        tail = MultiLayerNetwork(tail_conf, device=self.net.device)
        tail.init(dtype=_param_dtype(self.net))
        for i, (dst, src) in enumerate(zip(tail.params, self.net.params[k:])):
            _copy_params(dst, src)
            tail.state[i] = _clone_tree(self.net.state[k + i])
        tail.opt_state = tail_conf.updater.init(tail.params)
        return tail


class TransferLearningGraph:
    """Transfer learning for a ComputationGraph (reference:
    TransferLearning.GraphBuilder): freeze a feature-extractor prefix,
    replace the head, extend the graph. Freezing is by vertex name:
    ``set_feature_extractor(v)`` freezes ``v`` and every vertex before it
    in the graph's topological order."""

    def __init__(self, cg):
        if cg.params is None:
            raise ValueError("the source graph must be initialized or trained")
        self._src = cg
        self._fine_tune = None
        self._frozen = set()
        self._replaced = {}
        self._added = []       # (name, layer, inputs)
        self._outputs = None

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._fine_tune = ftc
        return self

    def set_feature_extractor(self, vertex_name):
        order = self._src._order
        if vertex_name not in order:
            raise ValueError(f"unknown vertex {vertex_name!r}")
        upto = order.index(vertex_name)
        self._frozen = {n for n in order[:upto + 1] if n not in self._src.conf.inputs}
        return self

    def replace_layer(self, name, new_layer):
        """Swap a LayerVertex's layer; its parameters initialize afresh."""
        self._replaced[name] = new_layer
        return self

    def add_layer(self, name, layer, *inputs):
        self._added.append((name, layer, tuple(inputs)))
        return self

    def set_outputs(self, *names):
        self._outputs = tuple(names)
        return self

    def build(self):
        """The new graph on the source's device and in its parameter dtype:
        a vertex neither replaced nor added carries copies of the source's
        parameters and state where every shape matches (a vertex below a
        replaced layer whose width changed keeps its fresh
        initialisation)."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, LayerVertex, VertexDef

        src, conf = self._src, self._src.conf
        added = {n for n, _, _ in self._added}
        bad = (set(self._replaced) | added) & self._frozen
        if bad:
            raise ValueError(f"vertices {sorted(bad)} are both frozen and replaced/added: a "
                             "replaced layer inside the frozen prefix would stay at its random "
                             "initialization")
        vertices = [VertexDef(v.name, LayerVertex(layer=self._replaced[v.name]), v.inputs)
                    if v.name in self._replaced else v for v in conf.vertices]
        vertices += [VertexDef(n, LayerVertex(layer=l), i) for n, l, i in self._added]
        kwargs = {"vertices": tuple(vertices)}
        ft = self._fine_tune
        if ft is not None:
            if ft.layer_overrides():
                kwargs["vertices"] = tuple(
                    VertexDef(v.name, LayerVertex(layer=ft.override_layer(v.vertex.layer)),
                              v.inputs) if isinstance(v.vertex, LayerVertex) else v
                    for v in vertices)
            kwargs.update(ft.conf_overrides())
        if self._outputs is not None:
            kwargs["outputs"] = self._outputs
        new_conf = dataclasses.replace(conf, **kwargs)
        net = ComputationGraph(new_conf, device=src.device)
        net.frozen_vertices = set(self._frozen)
        net.init(dtype=_param_dtype(src))
        for name in net.params:
            if name in src.params and name not in self._replaced and name not in added \
                    and _copy_params(net.params[name], src.params[name]):
                net.state[name] = _clone_tree(src.state[name])
        net.opt_state = new_conf.updater.init(net.params)
        return net
