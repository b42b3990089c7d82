"""ComputationGraph: networks over a DAG of vertices, as an ``nn.Module``.

The configuration classes (``VertexDef``, ``GraphConfiguration``, the
vertices) carry the JAX package's fields in its order, so a graph's
``config.json`` written by either package loads in the other. Parameters
live in one ``nn.ParameterDict`` per vertex under the JAX keys
(``params['stem_conv']['W']``); per-vertex state (BatchNormalization's
running ``mean``/``var``) is a dict of plain tensors per vertex, replaced
by each training step and never part of the autograd graph.

The functional core mirrors the JAX package's: ``apply_fn``, ``loss_fn``,
``compute_gradients``, ``apply_update`` (no constraint pass, as there) and
``make_train_step``; ``fit``, ``score`` and ``output`` wrap it. ``fit`` is
a plain loop, one step per batch, the loss fetched one step late.

Ported vertices: ``LayerVertex``, ``ElementWiseVertex`` and
``nn/fusion.py FusedConvBNVertex``. The other vertex classes parse and
round-trip, but a graph using one raises ``NotImplementedError`` when it is
built; so do training a graph with ``checkpoint_scope`` or
``gradient_checkpointing`` set, TBPTT, ``steps_per_dispatch > 1`` and
``pad_ragged``.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.nn import gradnorm as _gradnorm
from deeplearning4j_tpu_torch.nn import updaters as _updaters
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.nn.multilayer import _as_tensor, _param_tree
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils import serde
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

_NOT_PORTED = "is not ported yet (ROADMAP queue 1, \"Left out of slice 3\")"


def _loss_mask_for(mask, label):
    """The batch mask as an output's label mask only when its layout
    matches that output's per-example loss: [B] with pooled (<= 2-d)
    labels, [B, T] with time-distributed (>= 3-d) labels."""
    if mask is None:
        return None
    if (mask.dim() == 1 and label.dim() <= 2) or (mask.dim() == 2 and label.dim() >= 3):
        return mask
    return None


# --------------------------------------------------------------------------
# vertices
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphVertex:
    """Base: a function over a list of input activations."""

    def output_type(self, input_types):
        if len(input_types) != 1:
            raise ValueError(f"{type(self).__name__} takes one input, got {len(input_types)}")
        return input_types[0]

    def init(self, generator, input_types, dtype=torch.float32):
        return {}

    def init_state(self, input_types, dtype=torch.float32):
        return {}

    def apply(self, params, state, xs, *, train=False, mask=None):
        return xs[0], state

    def regularization_penalty(self, params):
        return 0.0


@serde.register_config
@dataclasses.dataclass(frozen=True)
class LayerVertex(GraphVertex):
    """Wraps any layer of the catalog."""

    layer: object = None

    def _adapted(self, input_types):
        it = input_types[0]
        fam = self.layer.input_family
        if fam is not None and not isinstance(it, fam):
            return _inputs.adapted_type(it, fam)
        return it

    def output_type(self, input_types):
        return self.layer.output_type(self._adapted(input_types))

    def init(self, generator, input_types, dtype=torch.float32):
        return self.layer.init(generator, self._adapted(input_types), dtype)

    def init_state(self, input_types, dtype=torch.float32):
        return self.layer.init_state(self._adapted(input_types), dtype)

    def apply(self, params, state, xs, *, train=False, mask=None):
        x = xs[0]
        if self.layer.input_family is _inputs.FeedForwardType and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        kwargs = {}
        # a 1-d mask marks valid examples; only [batch, time] masks reach
        # mask-aware layers
        if mask is not None and mask.dim() >= 2 \
                and "mask" in inspect.signature(type(self.layer).apply).parameters:
            kwargs["mask"] = mask
        return self.layer.apply(params, state, x, train=train, **kwargs)

    def regularization_penalty(self, params):
        return self.layer.regularization_penalty(params) if len(params) else 0.0


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """add | subtract | product | average | max over the inputs."""

    op: str = "add"

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, xs, *, train=False, mask=None):
        if self.op == "add":
            return functools.reduce(torch.add, xs), state
        if self.op == "subtract":
            if len(xs) != 2:
                raise ValueError(f"subtract takes two inputs, got {len(xs)}")
            return xs[0] - xs[1], state
        if self.op == "product":
            return functools.reduce(torch.mul, xs), state
        if self.op == "average":
            return functools.reduce(torch.add, xs) / len(xs), state
        if self.op == "max":
            return functools.reduce(torch.maximum, xs), state
        raise ValueError(f"Unknown elementwise op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class _NotPortedVertex(GraphVertex):
    """A vertex class whose config parses and round-trips but whose
    function is not ported: building a graph that uses it raises."""

    def output_type(self, input_types):
        raise NotImplementedError(f"{type(self).__name__} {_NOT_PORTED}")

    def apply(self, params, state, xs, *, train=False, mask=None):
        raise NotImplementedError(f"{type(self).__name__} {_NOT_PORTED}")


@serde.register_config
@dataclasses.dataclass(frozen=True)
class MergeVertex(_NotPortedVertex):
    pass


@serde.register_config
@dataclasses.dataclass(frozen=True)
class SubsetVertex(_NotPortedVertex):
    from_idx: int = 0
    to_idx: int = 0


@serde.register_config
@dataclasses.dataclass(frozen=True)
class StackVertex(_NotPortedVertex):
    pass


@serde.register_config
@dataclasses.dataclass(frozen=True)
class UnstackVertex(_NotPortedVertex):
    index: int = 0
    stack_size: int = 1


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ScaleVertex(_NotPortedVertex):
    factor: float = 1.0


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ShiftVertex(_NotPortedVertex):
    amount: float = 0.0


@serde.register_config
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(_NotPortedVertex):
    eps: float = 1e-8


@serde.register_config
@dataclasses.dataclass(frozen=True)
class L2Vertex(_NotPortedVertex):
    eps: float = 1e-8


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(_NotPortedVertex):
    shape: tuple = ()
    output_input_type: object = None


@serde.register_config
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(_NotPortedVertex):
    pass


@serde.register_config
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(_NotPortedVertex):
    timesteps: int = 1


@serde.register_config
@dataclasses.dataclass(frozen=True)
class PoolHelperVertex(_NotPortedVertex):
    pass


@serde.register_config
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(_NotPortedVertex):
    kind: str = "cnn_to_ff"
    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: int = 0


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------


@serde.register_config
@dataclasses.dataclass(frozen=True)
class VertexDef:
    name: str = ""
    vertex: object = None
    inputs: tuple = ()


@serde.register_config
@dataclasses.dataclass(frozen=True)
class GraphConfiguration:
    """Immutable, JSON-round-trippable graph config."""

    inputs: tuple = ()          # input names
    input_types: tuple = ()     # matching InputTypes
    vertices: tuple = ()        # VertexDef tuple (definition order)
    outputs: tuple = ()         # names of output vertices
    updater: object = dataclasses.field(default_factory=_updaters.Sgd)
    gradient_normalization: str = "none"
    gradient_normalization_threshold: float = 1.0
    seed: int = 12345
    gradient_checkpointing: bool = False
    backprop_type: str = "standard"  # standard | tbptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    checkpoint_scope: str | None = None

    def to_json(self, indent=2):
        return serde.to_json(self, indent=indent)

    @staticmethod
    def from_json(s):
        conf = serde.from_json(s)
        if not isinstance(conf, GraphConfiguration):
            raise TypeError(f"expected a GraphConfiguration JSON, got {type(conf).__name__}")
        return conf

    def topological_order(self):
        """Kahn's sort, ties taken in name order (the JAX package's order)."""
        defs = {v.name: v for v in self.vertices}
        indeg = {v.name: 0 for v in self.vertices}
        dependents = {name: [] for name in list(defs) + list(self.inputs)}
        for v in self.vertices:
            for inp in v.inputs:
                if inp not in defs and inp not in self.inputs:
                    raise ValueError(f"Vertex {v.name!r} input {inp!r} undefined")
                if inp in defs:
                    indeg[v.name] += 1
                dependents[inp].append(v.name)
        queue = [n for n, d in sorted(indeg.items()) if d == 0]
        seen = set(queue)
        result = []
        while queue:
            n = queue.pop(0)
            result.append(n)
            for dep in dependents[n]:
                indeg[dep] -= 1
                if indeg[dep] == 0 and dep not in seen:
                    seen.add(dep)
                    queue.append(dep)
        if len(result) != len(self.vertices):
            raise ValueError("Graph has a cycle")
        return result

    def vertex_types(self):
        """Shape inference over the DAG: {name: output InputType}."""
        defs = {v.name: v for v in self.vertices}
        types = dict(zip(self.inputs, self.input_types))
        for name in self.topological_order():
            v = defs[name]
            types[name] = v.vertex.output_type([types[i] for i in v.inputs])
        return types


class GraphBuilder:
    """Fluent builder of a ``GraphConfiguration``."""

    def __init__(self, updater=None, seed=12345, gradient_normalization="none",
                 gradient_normalization_threshold=1.0, gradient_checkpointing=False,
                 checkpoint_scope=None, backprop_type="standard", tbptt_fwd_length=20,
                 tbptt_back_length=20):
        self._inputs, self._input_types, self._vertices, self._outputs = [], [], [], []
        self._kw = dict(updater=updater or _updaters.Sgd(), seed=seed,
                        gradient_normalization=gradient_normalization,
                        gradient_normalization_threshold=gradient_normalization_threshold,
                        gradient_checkpointing=gradient_checkpointing,
                        checkpoint_scope=checkpoint_scope, backprop_type=backprop_type,
                        tbptt_fwd_length=tbptt_fwd_length, tbptt_back_length=tbptt_back_length)

    def add_inputs(self, *names):
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types):
        self._input_types.extend(types)
        return self

    def add_layer(self, name, layer, *inputs):
        self._vertices.append(VertexDef(name, LayerVertex(layer=layer), tuple(inputs)))
        return self

    def add_vertex(self, name, vertex, *inputs):
        self._vertices.append(VertexDef(name, vertex, tuple(inputs)))
        return self

    def set_outputs(self, *names):
        self._outputs.extend(names)
        return self

    def build(self) -> GraphConfiguration:
        conf = GraphConfiguration(inputs=tuple(self._inputs),
                                  input_types=tuple(self._input_types),
                                  vertices=tuple(self._vertices), outputs=tuple(self._outputs),
                                  **self._kw)
        conf.topological_order()  # validate
        return conf


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------


class ComputationGraph(nn.Module):
    """DAG network: config in, functional core + convenience API out."""

    def __init__(self, conf: GraphConfiguration, *, device="cuda"):
        super().__init__()
        self.conf = conf
        self._device = resolve_device(device)
        self._defs = {v.name: v for v in conf.vertices}
        self._order = conf.topological_order()
        self._types = conf.vertex_types()
        self.vertex_params = nn.ModuleDict()
        self.state = None
        self.opt_state = None
        # the JAX package's step RNG chain, carried through checkpoints
        # unused (no ported vertex draws random numbers)
        self.rng = None
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.score_history = []

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return self._device

    @property
    def params(self):
        """{vertex name: parameter dict} in topological order (``None``
        before ``init``)."""
        if self.state is None:
            return None
        return {name: self.vertex_params[name] for name in self._order}

    # ------------------------------------------------------------------
    # functional core
    # ------------------------------------------------------------------

    def init(self, generator=None, dtype=None):
        """Initialize parameters (from ``generator``, default a CPU
        generator seeded with ``conf.seed``, drawn in topological order)
        and state on the network's device; the updater state is made at
        the first ``fit``. Returns the parameters."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.conf.seed)
        dtype = dtype or _dtypes.get_policy().param_dtype
        params, state = {}, {}
        for name in self._order:
            v = self._defs[name]
            in_types = [self._types[i] for i in v.inputs]
            params[name] = _param_tree(v.vertex.init(generator, in_types, dtype), self._device)
            state[name] = {k: t.to(self._device)
                           for k, t in v.vertex.init_state(in_types, dtype).items()}
        self.vertex_params = nn.ModuleDict(params)
        self.state = state
        self.opt_state = None
        return self.params

    def _check_trainable(self):
        if self.conf.checkpoint_scope is not None or self.conf.gradient_checkpointing:
            raise NotImplementedError(f"activation checkpointing (checkpoint_scope / "
                                      f"gradient_checkpointing) {_NOT_PORTED}")
        for v in self.conf.vertices:
            layer = getattr(v.vertex, "layer", None)
            if layer is not None and (layer.dropout > 0.0
                                      or getattr(layer, "weight_noise", None) is not None):
                raise NotImplementedError(f"vertex {v.name!r}: input dropout and weight noise "
                                          "in train mode are not ported yet (ROADMAP queue 1, "
                                          "\"Rest of the training core\")")

    def _forward_pass(self, params, state, inputs, *, train, mask=None, labels=None,
                      label_masks=None):
        """The topological traversal every forward entry point shares.
        Returns (acts, new_state, loss); ``loss`` sums the output vertices'
        losses when ``labels`` is given, else it is None."""
        if not isinstance(inputs, dict):
            inputs = {self.conf.inputs[0]: inputs}
        acts = dict(inputs)
        new_state = dict(state)
        loss = 0.0 if labels is not None else None
        for name in self._order:
            v = self._defs[name]
            acts[name], new_state[name] = v.vertex.apply(
                params[name], state[name], [acts[i] for i in v.inputs], train=train, mask=mask)
            if labels is not None and name in self.conf.outputs:
                head = v.vertex.layer if isinstance(v.vertex, LayerVertex) else v.vertex
                if not hasattr(head, "compute_loss"):
                    raise ValueError(f"Output vertex {name!r} has no loss")
                lm = (label_masks or {}).get(name)
                if lm is None:
                    lm = _loss_mask_for(mask, labels[name])
                loss = loss + head.compute_loss(acts[name], labels[name], lm)
        return acts, new_state, loss

    def apply_fn(self, params, state, inputs, *, train=False, mask=None):
        """Forward pass over a dict of inputs (or one tensor for a
        single-input graph). Returns ({output name: activation},
        new_state). ``train=False`` runs under ``torch.inference_mode()``."""
        if train:
            self._check_trainable()
        with torch.enable_grad() if train else torch.inference_mode():
            acts, new_state, _ = self._forward_pass(params, state, inputs, train=train,
                                                    mask=mask)
        return {o: acts[o] for o in self.conf.outputs}, new_state

    def loss_fn(self, params, state, inputs, labels, *, train=True, mask=None,
                label_masks=None):
        """Sum of the output vertices' losses + L1/L2 penalties. Returns
        (loss, (new_state, outputs))."""
        if not isinstance(labels, dict):
            labels = {self.conf.outputs[0]: labels}
        if train:
            self._check_trainable()
        with torch.enable_grad() if train else torch.inference_mode():
            acts, new_state, loss = self._forward_pass(params, state, inputs, train=train,
                                                       mask=mask, labels=labels,
                                                       label_masks=label_masks)
            for name in self._order:
                if len(params[name]):
                    loss = loss + self._defs[name].vertex.regularization_penalty(params[name])
            loss, new_state = _base.pop_aux_losses(loss, new_state)
        return loss, (new_state, {o: acts[o] for o in self.conf.outputs})

    def compute_gradients(self, params, state, inputs, labels, *, mask=None):
        """Loss and normalized gradients. Returns (loss, new_state, grads)
        with ``grads`` a dict of per-vertex dicts shaped as ``params``. A
        parameter the loss does not reach gets zeros."""
        leaves = list(tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        loss, (new_state, _) = self.loss_fn(params, state, inputs, labels, train=True, mask=mask)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_like(params, iter([torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, gs)]))
        mode = self.conf.gradient_normalization
        if mode not in (None, "none"):
            grads = {k: _gradnorm.normalize_layer_grads(
                mode, g, self.conf.gradient_normalization_threshold) if g else g
                for k, g in grads.items()}
        return loss.detach(), new_state, grads

    def apply_update(self, params, opt_state, grads, step):
        """The updater, in place; the graph has no constraint pass.
        Returns (params, opt_state)."""
        with torch.profiler.record_function("updater.step"):
            opt_state = self.conf.updater.update_(params, grads, opt_state, step)
        return params, opt_state

    def apply_constraints(self, params, step):
        return params

    def make_train_step(self):
        """The train step: (params, state, opt_state, inputs, labels, step,
        mask) -> (params, state, opt_state, loss)."""
        def train_step(params, state, opt_state, inputs, labels, step, mask=None):
            loss, new_state, grads = self.compute_gradients(params, state, inputs, labels,
                                                            mask=mask)
            params, opt_state = self.apply_update(params, opt_state, grads, step)
            return params, new_state, opt_state, loss
        return train_step

    # ------------------------------------------------------------------
    # convenience (stateful) API
    # ------------------------------------------------------------------

    def _named(self, arrays, names):
        """A dict of tensors on the network's device from a dict or one array."""
        if not isinstance(arrays, dict):
            arrays = {names[0]: arrays}
        return {k: _as_tensor(v, self.device) for k, v in arrays.items()}

    def fit(self, inputs, labels, *, epochs=1, batch_size=None, mask=None,
            steps_per_dispatch=1, pad_ragged=None):
        """Train over dict-keyed (or single-array) inputs and labels, numpy
        or tensors, sliced into batches of ``batch_size``. Each step's loss
        lands in ``score_history`` one step late; ``score_value`` is the
        last. Returns the network."""
        if int(steps_per_dispatch) != 1 or pad_ragged:
            raise NotImplementedError(f"steps_per_dispatch > 1 and pad_ragged {_NOT_PORTED}")
        if self.params is None:
            self.init()
        if self.opt_state is None:
            self.opt_state = self.conf.updater.init(self.params)
        if not isinstance(inputs, dict):
            inputs = {self.conf.inputs[0]: inputs}
        if not isinstance(labels, dict):
            labels = {self.conf.outputs[0]: labels}
        if self.conf.backprop_type == "tbptt" and any(
                np.ndim(v) == 3 and v.shape[1] > self.conf.tbptt_fwd_length
                for v in inputs.values()):
            raise NotImplementedError(f"truncated BPTT {_NOT_PORTED}")
        step_fn = self.make_train_step()
        dev = self.device
        n = next(iter(inputs.values())).shape[0]
        bs = batch_size or n
        self.score_history = []
        for _ in range(epochs):
            pending = None
            for i in range(0, n, bs):
                bi = {k: _as_tensor(v[i:i + bs], dev) for k, v in inputs.items()}
                bl = {k: _as_tensor(v[i:i + bs], dev) for k, v in labels.items()}
                bm = _as_tensor(mask[i:i + bs], dev) if mask is not None else None
                _, self.state, self.opt_state, loss = step_fn(
                    self.params, self.state, self.opt_state, bi, bl, self.iteration, bm)
                self.iteration += 1
                if pending is not None:
                    self.score_history.append(float(pending))
                pending = loss
            if pending is not None:
                self.score_history.append(float(pending))
            self.epoch += 1
        if self.score_history:
            self.score_value = self.score_history[-1]
        return self

    def output(self, inputs, mask=None):
        """Inference; one tensor for a single-output graph, else a dict."""
        if self.params is None:
            self.init()
        dev = self.device
        outs, _ = self.apply_fn(self.params, self.state, self._named(inputs, self.conf.inputs),
                                mask=_as_tensor(mask, dev))
        return outs[self.conf.outputs[0]] if len(outs) == 1 else outs

    def forward(self, inputs, mask=None):
        return self.apply_fn(self.params, self.state, inputs, mask=mask)[0]

    def score(self, inputs, labels, mask=None):
        """The loss on (inputs, labels) without training (inference forward)."""
        if self.params is None:
            self.init()
        loss, _ = self.loss_fn(self.params, self.state, self._named(inputs, self.conf.inputs),
                               self._named(labels, self.conf.outputs), train=False,
                               mask=_as_tensor(mask, self.device))
        return float(loss)

    def num_params(self):
        return sum(int(p.numel()) for p in self.parameters())
