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
``make_train_step``; ``fit``, ``score`` and ``output`` wrap it. ``fit`` runs
``continuous.StepDriver``: one step a batch with the loss fetched one step
late, or with ``steps_per_dispatch=K`` K steps a dispatch through
``nn/fused.py`` (one CUDA-graph replay on a card; dict inputs and labels
stack entry by entry); ``pad_ragged=True`` pads the K=1 loop's batches to
the batch size with validity masks.

Truncated BPTT and streaming follow the MultiLayerNetwork's contract: with
``backprop_type="tbptt"`` a batch whose [B, T, ...] input is longer than
``tbptt_fwd_length`` trains in chunks (static [B, F] entries and 2-d
labels pass whole into every chunk), the recurrent LayerVertices' carries
threaded through ``_forward_pass`` and detached at each boundary;
``rnn_time_step`` streams with the same carries. Bidirectional layers
refuse both.

Every vertex class of the JAX package is ported (``nn/fusion.py`` holds
``FusedConvBNVertex``). An output layer with ``loss_from_features``
(``CenterLossOutputLayer``) sees its input activation and the labels.
``feed_forward`` returns every vertex's activation.

Random draws (input dropout, ``DropoutLayer``, weight noise) take a seed
a train step (``nn/layers/base.py step_seed``), split into one seed a
vertex before the traversal starts, as the JAX package splits its key. Remat:
``checkpoint_scope="prefix"`` runs each group of consecutive vertices that
share a name prefix (``s0b0_a_bn``, ``s0b0_b_bn``, ... -> ``s0b0``) under
``torch.utils.checkpoint``, the JAX package's segments;
``gradient_checkpointing`` checkpoints every other vertex on its own. A
layer vertex's weight noise (``nn/weightnoise.py``) perturbs its
parameters in train mode, as DL4J's graphs do (the JAX package's graph
does not read the field).

Freezing (``nn/transfer.py``): ``frozen_vertices`` names the vertices that
train as DL4J's FrozenLayer does: each runs with ``train=False`` in every
pass (BatchNormalization keeps its running statistics, a fused vertex
launches no kernel, dropout is off), and its parameters stay out of
autograd and out of the updater, whose state for them is left as it is.
Listeners (``nn/listeners.py``) hear ``fit`` and its TBPTT branch one step
late; ``evaluate``, ``evaluate_regression`` and ``evaluate_roc`` take an
``output_name`` for a head of a multi-output graph.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from deeplearning4j_tpu_torch.datasets.iterator import iter_batches
from deeplearning4j_tpu_torch.nn import gradnorm as _gradnorm
from deeplearning4j_tpu_torch.nn import updaters as _updaters
from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.nn.layers.base import dropout_mask, split_seed, step_seed
from deeplearning4j_tpu_torch.nn.layers.rnn import (Bidirectional, GravesBidirectionalLSTM,
                                                    last_time_step)
from deeplearning4j_tpu_torch.nn.multilayer import _as_tensor, _detach, _param_tree
from deeplearning4j_tpu_torch.telemetry import health as _health
from deeplearning4j_tpu_torch.utils import collectives as _collectives
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils import serde
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.trees import drop_entries, tree_leaves, tree_like


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
    """Base: a function over a list of input activations. ``rng`` is the
    vertex's seed in a train step (None outside one)."""

    def output_type(self, input_types):
        if len(input_types) != 1:
            raise ValueError(f"{type(self).__name__} takes one input, got {len(input_types)}")
        return input_types[0]

    def init(self, generator, input_types, dtype=torch.float32):
        return {}

    def init_state(self, input_types, dtype=torch.float32):
        return {}

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
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

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        x = xs[0]
        if self.layer.input_family is _inputs.FeedForwardType and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        kwargs = {}
        # a 1-d mask marks valid examples; only [batch, time] masks reach
        # mask-aware layers
        if mask is not None and mask.dim() >= 2 and _base.takes(type(self.layer), "mask"):
            kwargs["mask"] = mask
        return _base.apply_layer(self.layer, params, state, x, train=train, rng=rng, **kwargs)

    def regularization_penalty(self, params):
        return self.layer.regularization_penalty(params) if len(params) else 0.0

    # the recurrent carry (TBPTT, rnn_time_step), delegated to the layer
    def has_carry(self):
        return hasattr(self.layer, "apply_with_carry")

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return self.layer.zero_carry(batch, dtype, device)

    def apply_with_carry(self, params, carry, xs, *, mask=None):
        return self.layer.apply_with_carry(params, carry, xs[0], mask=mask)


@serde.register_config
@dataclasses.dataclass(frozen=True)
class MergeVertex(GraphVertex):
    """Concatenation on the feature/channel axis (the last: activations are
    NHWC), so a merged map feeds the next conv as a channels-last view."""

    def output_type(self, input_types):
        t0 = input_types[0]
        if isinstance(t0, _inputs.ConvolutionalType):
            return _inputs.ConvolutionalType(t0.height, t0.width,
                                             sum(t.channels for t in input_types))
        if isinstance(t0, _inputs.RecurrentType):
            return _inputs.RecurrentType(sum(t.size for t in input_types), t0.timesteps)
        return _inputs.FeedForwardType(sum(t.size for t in input_types))

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return torch.cat(xs, dim=-1), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(GraphVertex):
    """add | subtract | product | average | max over the inputs."""

    op: str = "add"

    def output_type(self, input_types):
        return input_types[0]

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
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


@serde.register_config
@dataclasses.dataclass(frozen=True)
class SubsetVertex(GraphVertex):
    """The feature range [from_idx, to_idx], both ends included."""

    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, input_types):
        n = self.to_idx - self.from_idx + 1
        t = input_types[0]
        if isinstance(t, _inputs.RecurrentType):
            return _inputs.RecurrentType(n, t.timesteps)
        if isinstance(t, _inputs.ConvolutionalType):
            return _inputs.ConvolutionalType(t.height, t.width, n)
        return _inputs.FeedForwardType(n)

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return xs[0][..., self.from_idx:self.to_idx + 1], state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class StackVertex(GraphVertex):
    """The inputs stacked on the batch axis."""

    def output_type(self, input_types):
        return input_types[0]  # the batch is not part of an InputType

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return torch.cat(xs, dim=0), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class UnstackVertex(GraphVertex):
    """Slice ``index`` of ``stack_size`` equal slices of the batch."""

    index: int = 0
    stack_size: int = 1

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        x = xs[0]
        step = x.shape[0] // self.stack_size
        return x[self.index * step:(self.index + 1) * step], state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ScaleVertex(GraphVertex):
    factor: float = 1.0

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return xs[0] * self.factor, state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ShiftVertex(GraphVertex):
    amount: float = 0.0

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return xs[0] + self.amount, state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(GraphVertex):
    """x / (||x|| + eps), the norm over all non-batch axes (eps outside the
    square root, unlike ``F.normalize``)."""

    eps: float = 1e-8

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        x = xs[0]
        norm = (x * x).sum(dim=tuple(range(1, x.dim())), keepdim=True).sqrt()
        return x / (norm + self.eps), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class L2Vertex(GraphVertex):
    """The L2 distance between two inputs, sqrt(sum d^2 + eps): [B, 1]."""

    eps: float = 1e-8

    def output_type(self, input_types):
        return _inputs.FeedForwardType(1)

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        a, b = xs
        d = (a - b).reshape(a.shape[0], -1)
        return ((d * d).sum(dim=1, keepdim=True) + self.eps).sqrt(), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(GraphVertex):
    """The non-batch axes reshaped to ``shape``."""

    shape: tuple = ()
    output_input_type: object = None

    def output_type(self, input_types):
        return self.output_input_type or input_types[0]

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return xs[0].reshape((xs[0].shape[0],) + tuple(self.shape)), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class LastTimeStepVertex(GraphVertex):
    """[B,T,F] -> [B,F], the last valid step under a [B, T] mask
    (reference: rnn/LastTimeStepVertex.java)."""

    def output_type(self, input_types):
        return _inputs.FeedForwardType(input_types[0].size)

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return last_time_step(xs[0], mask), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[B,F] -> [B,T,F], the input repeated over ``timesteps`` steps."""

    timesteps: int = 1

    def output_type(self, input_types):
        return _inputs.RecurrentType(input_types[0].size, self.timesteps)

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        x = xs[0]
        return x[:, None, :].expand(x.shape[0], self.timesteps, x.shape[-1]), state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class PoolHelperVertex(GraphVertex):
    """The first row and column cut off (GoogLeNet import compatibility)."""

    def output_type(self, input_types):
        t = input_types[0]
        return _inputs.ConvolutionalType(t.height - 1, t.width - 1, t.channels)

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        return xs[0][:, 1:, 1:, :], state


@serde.register_config
@dataclasses.dataclass(frozen=True)
class PreprocessorVertex(GraphVertex):
    """An explicit change of input family: cnn_to_ff | ff_to_cnn |
    rnn_to_ff | ff_to_rnn | cnn_to_rnn."""

    kind: str = "cnn_to_ff"
    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: int = 0

    def output_type(self, input_types):
        t = input_types[0]
        if self.kind == "cnn_to_ff":
            return _inputs.FeedForwardType(t.flat_size)
        if self.kind == "ff_to_cnn":
            return _inputs.ConvolutionalType(self.height, self.width, self.channels)
        if self.kind == "rnn_to_ff":
            return _inputs.FeedForwardType(t.size)
        if self.kind == "ff_to_rnn":
            return _inputs.RecurrentType(t.size, self.timesteps)
        if self.kind == "cnn_to_rnn":
            return _inputs.RecurrentType(t.width * t.channels, t.height)
        raise ValueError(f"Unknown preprocessor kind {self.kind!r}")

    def apply(self, params, state, xs, *, train=False, mask=None, rng=None):
        x = xs[0]
        if self.kind == "cnn_to_ff":
            return x.reshape(x.shape[0], -1), state
        if self.kind == "ff_to_cnn":
            return x.reshape(x.shape[0], self.height, self.width, self.channels), state
        if self.kind == "rnn_to_ff":
            return x.reshape(-1, x.shape[-1]), state
        if self.kind == "ff_to_rnn":
            return x.reshape(-1, self.timesteps, x.shape[-1]), state
        if self.kind == "cnn_to_rnn":
            return x.reshape(x.shape[0], x.shape[1], -1), state
        raise ValueError(f"Unknown preprocessor kind {self.kind!r}")


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

    def add_module(self, module, layer_name, input_size, config, input_layer):
        """Append a reusable fragment through the ``GraphBuilderModule``
        interface (reference: GraphBuilderModule.updateBuilder)."""
        return module.update_builder(self, layer_name, input_size, config, input_layer)

    def last_vertex_name(self):
        """The most recently added vertex (a module adds its output last)."""
        return self._vertices[-1].name if self._vertices else None

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
        self._pos = {name: i for i, name in enumerate(self._order)}
        self._segments = self._build_segments() if conf.checkpoint_scope == "prefix" else None
        self.vertex_params = nn.ModuleDict()
        self.state = None
        self.opt_state = None
        # the JAX package's step RNG chain, carried through checkpoints; the
        # port's draws come from ``_base.step_seed(conf.seed, iteration)``
        self.rng = None
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.score_history = []
        self._rnn_stream_state = None
        self.listeners = []
        self.last_input = None  # the fit loop's current first input (listeners read it)
        # names of the vertices that train frozen (``nn/transfer.py``)
        self.frozen_vertices = set()

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

    def _trainable(self, tree):
        """A per-vertex tree (parameters, gradients, updater state) with the
        frozen vertices' entries emptied."""
        return drop_entries(tree, self.frozen_vertices, self._order)

    def _watch(self, params):
        """Turn autograd on for the trainable parameters and off for the
        frozen ones; returns the trainable tree."""
        for p in tree_leaves(params):
            p.requires_grad_(False)
        trainable = self._trainable(params)
        for p in tree_leaves(trainable):
            p.requires_grad_(True)
        return trainable

    def _build_segments(self):
        """The ``checkpoint_scope="prefix"`` partition of the topological
        order, the JAX package's: a maximal run of >= 2 consecutive vertices
        whose names share the prefix before the first '_' becomes
        ("group", names, external inputs, boundary outputs); output
        vertices and loss-from-features heads stay ("single", name). Only a
        group's boundary outputs are kept for the backward; its interior is
        recomputed."""
        dependents = {}
        for v in self.conf.vertices:
            for inp in v.inputs:
                dependents.setdefault(inp, set()).add(v.name)

        def scope_of(name):
            if name in self.conf.outputs:
                return None
            if hasattr(getattr(self._defs[name].vertex, "layer", None), "loss_from_features"):
                return None
            return name.split("_", 1)[0] if "_" in name else None

        segments, order, i = [], self._order, 0
        while i < len(order):
            sc = scope_of(order[i])
            j = i + 1
            while sc is not None and j < len(order) and scope_of(order[j]) == sc:
                j += 1
            if sc is None or j - i < 2:
                segments.append(("single", order[i]))
                i += 1
                continue
            names = order[i:j]
            produced, ext = set(names), []
            for n in names:
                for inp in self._defs[n].inputs:
                    if inp not in produced and inp not in ext:
                        ext.append(inp)
            after = set(order[j:])
            bnd = [n for n in names if n in self.conf.outputs or dependents.get(n, set()) & after]
            segments.append(("group", tuple(names), tuple(ext), tuple(bnd)))
            i = j
        return segments

    def _run_group(self, seg, params, state, acts, new_state, seeds, mask, train):
        """One checkpoint group: its vertices run under
        ``torch.utils.checkpoint``, which keeps only the group's inputs and
        recomputes the interior in the backward. Each vertex's seed is drawn
        before the group runs, so the recompute draws the same masks (the
        checkpoint's own RNG restore covers the global generator only).
        Only the boundary outputs land in ``acts``."""
        _, names, ext, bnd = seg

        def run(gp, gs, ext_vals, m):
            local = dict(zip(ext, ext_vals))
            ns = {}
            for n in names:
                v = self._defs[n]
                local[n], ns[n] = v.vertex.apply(gp[n], gs[n], [local[i] for i in v.inputs],
                                                 train=train and n not in self.frozen_vertices,
                                                 mask=m, rng=seeds[self._pos[n]])
            return [local[n] for n in bnd], ns

        outs, ns = torch.utils.checkpoint.checkpoint(
            run, {n: params[n] for n in names}, {n: state[n] for n in names},
            [acts[i] for i in ext], mask, use_reentrant=False, preserve_rng_state=False)
        acts.update(zip(bnd, outs))
        new_state.update(ns)

    def _forward_pass(self, params, state, inputs, *, train, rng=None, mask=None, labels=None,
                      label_masks=None, carries=None):
        """The topological traversal every forward entry point shares.
        Returns (acts, new_state, loss); ``loss`` sums the output vertices'
        losses when ``labels`` is given, else it is None (an output layer
        with ``loss_from_features`` gets its input activation and the
        labels). ``rng`` is the step's seed, split into one seed a vertex
        before any vertex runs. With ``carries`` ({vertex name: carry}) the
        recurrent LayerVertices run ``apply_with_carry`` and the updated
        carries come back as a fourth element. Remat (``checkpoint_scope``,
        ``gradient_checkpointing``) applies where autograd records, on the
        loss path without carries."""
        if not isinstance(inputs, dict):
            inputs = {self.conf.inputs[0]: inputs}
        acts = dict(inputs)
        new_state = dict(state)
        new_carries = None if carries is None else dict(carries)
        loss = 0.0 if labels is not None else None
        seeds = (split_seed(rng, len(self._order)) if rng is not None
                 else [None] * len(self._order))
        remat = labels is not None and carries is None and torch.is_grad_enabled()
        walk = (self._segments if remat and self._segments is not None
                else [("single", n) for n in self._order])
        for seg in walk:
            if seg[0] == "group":
                self._run_group(seg, params, state, acts, new_state, seeds, mask, train)
                continue
            name = seg[1]
            v = self._defs[name]
            seed = seeds[self._pos[name]]
            # FrozenLayer.java: a frozen vertex runs as in inference
            v_train = train and name not in self.frozen_vertices
            xs = [acts[i] for i in v.inputs]
            layer = getattr(v.vertex, "layer", None)
            lm = None
            if labels is not None and name in self.conf.outputs:
                lm = (label_masks or {}).get(name)
                if lm is None:
                    lm = _loss_mask_for(mask, labels[name])
            if labels is not None and name in self.conf.outputs \
                    and hasattr(layer, "loss_from_features"):
                x = xs[0]
                if layer.input_family is _inputs.FeedForwardType and x.dim() > 2:
                    x = x.reshape(x.shape[0], -1)
                if v_train and seed is not None and layer.dropout > 0.0:
                    x = dropout_mask(split_seed(seed, 2)[0], x, layer.dropout,
                                     _collectives.row_offset(x))
                l_i, acts[name], new_state[name] = layer.loss_from_features(
                    params[name], state[name], x, labels[name], lm, train=v_train)
                loss = loss + l_i
                continue
            if new_carries is not None and isinstance(v.vertex, LayerVertex) \
                    and v.vertex.has_carry():
                acts[name], new_carries[name] = v.vertex.apply_with_carry(
                    params[name], new_carries.get(name), xs, mask=mask)
            elif remat and self.conf.gradient_checkpointing:
                acts[name], new_state[name] = torch.utils.checkpoint.checkpoint(
                    functools.partial(v.vertex.apply, train=v_train, rng=seed), params[name],
                    state[name], xs, mask=mask, use_reentrant=False, preserve_rng_state=False)
            else:
                acts[name], new_state[name] = v.vertex.apply(
                    params[name], state[name], xs, train=v_train, mask=mask, rng=seed)
            if labels is not None and name in self.conf.outputs:
                head = layer if layer is not None else v.vertex
                if not hasattr(head, "compute_loss"):
                    raise ValueError(f"Output vertex {name!r} has no loss")
                loss = loss + head.compute_loss(acts[name], labels[name], lm)
        if carries is not None:
            return acts, new_state, loss, new_carries
        return acts, new_state, loss

    def apply_fn(self, params, state, inputs, *, train=False, mask=None, rng=None):
        """Forward pass over a dict of inputs (or one tensor for a
        single-input graph). Returns ({output name: activation},
        new_state). ``train=False`` runs under ``torch.inference_mode()``."""
        with torch.enable_grad() if train else torch.inference_mode():
            acts, new_state, _ = self._forward_pass(params, state, inputs, train=train,
                                                    mask=mask, rng=rng)
        return {o: acts[o] for o in self.conf.outputs}, new_state

    def feed_forward(self, inputs, *, train=False, mask=None):
        """The activation of every vertex, {name: tensor} (reference:
        ComputationGraph.feedForward), inputs included."""
        if self.params is None:
            self.init()
        dev = self.device
        with _dtypes.policy_precision(), \
                torch.enable_grad() if train else torch.inference_mode():
            acts, _, _ = self._forward_pass(self.params, self.state,
                                            self._named(inputs, self.conf.inputs), train=train,
                                            mask=_as_tensor(mask, dev))
        return acts

    def loss_fn(self, params, state, inputs, labels, *, train=True, mask=None,
                label_masks=None, carries=None, rng=None):
        """Sum of the output vertices' losses + L1/L2 penalties. Returns
        (loss, (new_state, outputs)); with ``carries`` (TBPTT chunks) the
        updated carries join them: (loss, (new_state, outputs, carries))."""
        if not isinstance(labels, dict):
            labels = {self.conf.outputs[0]: labels}
        with torch.enable_grad() if train else torch.inference_mode():
            fwd = self._forward_pass(params, state, inputs, train=train, mask=mask, rng=rng,
                                     labels=labels, label_masks=label_masks, carries=carries)
            acts, new_state, loss = fwd[:3]
            for name in self._order:
                if len(params[name]):
                    loss = loss + self._defs[name].vertex.regularization_penalty(params[name])
            loss, new_state = _base.pop_aux_losses(loss, new_state)
        outs = {o: acts[o] for o in self.conf.outputs}
        if carries is not None:
            return loss, (new_state, outs, fwd[3])
        return loss, (new_state, outs)

    # ------------------------------------------------------------------
    # truncated BPTT and streaming inference (reference:
    # ComputationGraph.doTruncatedBPTT:2595, rnnTimeStep)
    # ------------------------------------------------------------------

    def _zero_carries(self, batch, dtype, device):
        for v in self.conf.vertices:
            if isinstance(getattr(v.vertex, "layer", None),
                          (Bidirectional, GravesBidirectionalLSTM)):
                # the backward direction needs the whole future sequence
                raise ValueError(f"vertex {v.name!r}: bidirectional layers do not "
                                 "support TBPTT / rnn_time_step streaming")
        sd = torch.promote_types(dtype, torch.float32)
        return {v.name: v.vertex.zero_carry(batch, sd, device) for v in self.conf.vertices
                if isinstance(v.vertex, LayerVertex) and v.vertex.has_carry()}

    def _grads(self, loss, params):
        """Gradients of ``loss`` shaped as ``params`` (zeros where the loss
        does not reach), normalized per vertex by the configured mode."""
        leaves = list(tree_leaves(params))
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_like(params, iter([torch.zeros_like(p) if g is None else g
                                        for p, g in zip(leaves, gs)]))
        mode = self.conf.gradient_normalization
        if mode not in (None, "none"):
            grads = {k: _gradnorm.normalize_layer_grads(
                mode, g, self.conf.gradient_normalization_threshold) if g else g
                for k, g in grads.items()}
        return grads

    def make_tbptt_step(self):
        """One TBPTT chunk: (params, state, opt_state, carries, inputs,
        labels, step, mask, rng) -> (params, state, opt_state, carries,
        loss), the carries detached coming in and going out."""
        def tbptt_step(params, state, opt_state, carries, inputs, labels, step, mask=None,
                       rng=None):
            carries = {k: _detach(c) for k, c in carries.items()}
            trainable = self._watch(params)
            loss, (new_state, _, new_carries) = self.loss_fn(
                params, state, inputs, labels, train=True, mask=mask, carries=carries, rng=rng)
            grads = self._grads(loss, trainable)
            params, opt_state = self.apply_update(params, opt_state, grads, step)
            return (params, new_state, opt_state, {k: _detach(c) for k, c in new_carries.items()},
                    loss.detach())
        return tbptt_step

    @staticmethod
    def _chunk_time(tree, t0, t1):
        """[B, T, ...] entries sliced along time; static [B, F] entries (and
        the 2-d labels of a LastTimeStep head) pass whole."""
        return {k: v[:, t0:t1] if v.dim() == 3 else v for k, v in tree.items()}

    @staticmethod
    def _time_major(inputs):
        """The [B, T, ...] entry that sets the chunking (a multi-input graph
        may list a static [B, F] input first)."""
        for v in inputs.values():
            if np.ndim(v) == 3:
                return v
        return None

    def _fit_tbptt(self, inputs, labels, mask):
        """One batch in chunks of ``tbptt_fwd_length`` steps; ``iteration``
        advances once a chunk. Returns the mean chunk loss (a device
        scalar) and the chunks' ``(iteration, loss)`` pairs."""
        step_fn = self.make_tbptt_step()
        first = self._time_major(inputs)
        length = self.conf.tbptt_fwd_length
        carries = self._zero_carries(first.shape[0], first.dtype, first.device)
        total, chunks = 0.0, []
        for t0 in range(0, first.shape[1], length):
            cm = None if mask is None else mask[:, t0:t0 + length]
            _, self.state, self.opt_state, carries, loss = step_fn(
                self.params, self.state, self.opt_state, carries,
                self._chunk_time(inputs, t0, t0 + length),
                self._chunk_time(labels, t0, t0 + length), self.iteration, cm,
                step_seed(self.conf.seed, self.iteration))
            total = total + loss
            self.iteration += 1
            chunks.append((self.iteration, loss))
        return total / max(len(chunks), 1), chunks

    def rnn_clear_previous_state(self):
        self._rnn_stream_state = None

    def rnn_time_step(self, inputs):
        """One timestep [B, F] (or a short [B, T, F] chunk) of streaming
        inference, carrying the recurrent state between calls; one tensor
        for a single-output graph, else a dict."""
        if self.params is None:
            self.init()
        inputs = self._named(inputs, self.conf.inputs)
        squeeze = next(iter(inputs.values())).dim() == 2
        if squeeze:
            inputs = {k: v[:, None, :] for k, v in inputs.items()}
        first = next(iter(inputs.values()))
        carries = self._rnn_stream_state
        if carries is None:
            carries = self._zero_carries(first.shape[0], first.dtype, first.device)
        with _dtypes.policy_precision(), torch.inference_mode():
            acts, _, _, carries = self._forward_pass(self.params, self.state, inputs,
                                                     train=False, carries=carries)
        self._rnn_stream_state = carries
        # a LastTimeStep-style head already gives [B, C]: only [B, T, C] squeezes
        outs = {o: acts[o][:, 0] if squeeze and acts[o].dim() == 3 else acts[o]
                for o in self.conf.outputs}
        return next(iter(outs.values())) if len(outs) == 1 else outs

    def compute_gradients(self, params, state, inputs, labels, *, mask=None, rng=None):
        """Loss and normalized gradients. Returns (loss, new_state, grads)
        with ``grads`` a dict of per-vertex dicts shaped as ``params``. A
        parameter the loss does not reach gets zeros. ``rng``, the step's
        seed, turns on the random draws (dropout). A frozen vertex's entry
        is ``{}``: no gradient is computed for it."""
        trainable = self._watch(params)
        loss, (new_state, _) = self.loss_fn(params, state, inputs, labels, train=True, mask=mask,
                                            rng=rng)
        return loss.detach(), new_state, self._grads(loss, trainable)

    def apply_update(self, params, opt_state, grads, step):
        """The updater, in place, over the trainable vertices (``grads`` as
        ``compute_gradients`` gives them): a frozen vertex's parameters and
        updater state are not touched. The graph has no constraint pass.
        Returns (params, opt_state)."""
        with torch.profiler.record_function("updater.step"):
            self.conf.updater.update_(self._trainable(params), self._trainable(grads),
                                      self._trainable(opt_state), step)
        return params, opt_state

    def apply_constraints(self, params, step):
        return params

    def make_train_step(self, with_health=False):
        """The train step: (params, state, opt_state, inputs, labels, step,
        mask, rng) -> (params, state, opt_state, loss[, health]); ``step``
        and ``with_health`` as in ``MultiLayerNetwork.make_train_step``."""
        def train_step(params, state, opt_state, inputs, labels, step, mask=None, rng=None):
            loss, new_state, grads = self.compute_gradients(params, state, inputs, labels,
                                                            mask=mask, rng=rng)
            health = _health.health_stats(grads, params, loss) if with_health else None
            params, opt_state = self.apply_update(params, opt_state, grads, step)
            if with_health:
                return params, new_state, opt_state, loss, health
            return params, new_state, opt_state, loss
        return train_step

    def make_train_steps(self, k, with_health=False):
        """The K-step engine over the graph's train step (``nn/fused.py``;
        dict inputs and labels stack entry by entry)."""
        from deeplearning4j_tpu_torch.nn import fused as _fused
        return _fused.make_train_steps(self, k, with_health=with_health)

    # ------------------------------------------------------------------
    # convenience (stateful) API
    # ------------------------------------------------------------------

    def _named(self, arrays, names):
        """A dict of tensors on the network's device from a dict or one array."""
        if not isinstance(arrays, dict):
            arrays = {names[0]: arrays}
        return {k: _as_tensor(v, self.device) for k, v in arrays.items()}

    def _fit_batches(self, inputs, labels, batch_size, mask, pad_to=False):
        """An epoch's (inputs, labels, mask) minibatches of the dict-keyed
        arrays; ``pad_to`` pads each to the batch size with the validity
        folded into the mask."""
        from deeplearning4j_tpu_torch.datasets.iterator import pad_batch

        n = next(iter(inputs.values())).shape[0]
        bs = batch_size or n
        for i in range(0, n, bs):
            bi = {k: v[i:i + bs] for k, v in inputs.items()}
            bl = {k: v[i:i + bs] for k, v in labels.items()}
            bm = mask[i:i + bs] if mask is not None else None
            if pad_to:
                bi, bl, bm, _ = pad_batch(bi, bl, bm, bs)
            yield bi, bl, bm

    def fit(self, inputs, labels, *, epochs=1, batch_size=None, mask=None,
            steps_per_dispatch=1, pad_ragged=None):
        """Train over dict-keyed (or single-array) inputs and labels, numpy
        or tensors, sliced into batches of ``batch_size``. Each step's loss
        lands in ``score_history`` one dispatch late, where the listeners
        hear it (a TBPTT batch: one entry, the mean of its chunks; one
        listener callback a chunk); ``score_value`` is the last. Returns
        the network.

        ``steps_per_dispatch=K`` and ``pad_ragged`` as in
        ``MultiLayerNetwork.fit``. Both bucket with one validity mask, so a
        graph whose outputs mix label layouts (pooled and time-distributed,
        or two lengths) is refused, and so is TBPTT at K > 1.

        Telemetry is the StepDriver's, TBPTT batches included (JAX
        ``graph.py:1052-1072``'s ``fit`` and ``fit.step`` spans, step
        histogram, iteration counter, score gauge and crash dump)."""
        from deeplearning4j_tpu_torch.continuous.driver import StepDriver

        if self.params is None:
            self.init()
        if not isinstance(inputs, dict):
            inputs = {self.conf.inputs[0]: inputs}
        if not isinstance(labels, dict):
            labels = {self.conf.outputs[0]: labels}
        tm = self._time_major(inputs)
        use_tbptt = (self.conf.backprop_type == "tbptt" and tm is not None
                     and tm.shape[1] > self.conf.tbptt_fwd_length)
        k = int(steps_per_dispatch)
        if k > 1 or pad_ragged:
            layouts = {"pooled" if np.ndim(v) <= 2 else ("temporal", v.shape[1])
                       for v in labels.values()}
            if len(layouts) > 1:
                raise ValueError(
                    "shape bucketing (steps_per_dispatch > 1 / pad_ragged) needs a single "
                    "label layout; this graph mixes pooled / differently-lengthed "
                    "time-distributed outputs: pad the dataset to the batch size yourself or "
                    "train with steps_per_dispatch=1")
        self.score_history = []
        if k > 1:
            if use_tbptt:
                raise ValueError("steps_per_dispatch > 1 does not compose with TBPTT (the "
                                 "chunk loop is its own loop); use the default single-step "
                                 "path")
            from deeplearning4j_tpu_torch.nn import fused as _fused
            with _dtypes.policy_precision():
                return _fused.fit_fused(
                    self, lambda: self._fit_batches(inputs, labels, batch_size, mask),
                    epochs=epochs, k=k, batch_size=batch_size)
        drv = StepDriver(
            self, lambda: self._fit_batches(inputs, labels, batch_size, mask,
                                            pad_to=bool(pad_ragged)),
            tbptt_fn=(lambda x, y: True) if use_tbptt else None)
        with _dtypes.policy_precision():
            return drv.run(epochs)

    def output(self, inputs, mask=None):
        """Inference; one tensor for a single-output graph, else a dict."""
        if self.params is None:
            self.init()
        dev = self.device
        with _dtypes.policy_precision():
            outs, _ = self.apply_fn(self.params, self.state,
                                    self._named(inputs, self.conf.inputs),
                                    mask=_as_tensor(mask, dev))
        return outs[self.conf.outputs[0]] if len(outs) == 1 else outs

    def forward(self, inputs, mask=None):
        return self.apply_fn(self.params, self.state, inputs, mask=mask)[0]

    def score(self, inputs, labels, mask=None):
        """The loss on (inputs, labels) without training (inference forward)."""
        if self.params is None:
            self.init()
        with _dtypes.policy_precision():
            loss, _ = self.loss_fn(self.params, self.state,
                                   self._named(inputs, self.conf.inputs),
                                   self._named(labels, self.conf.outputs), train=False,
                                   mask=_as_tensor(mask, self.device))
        return float(loss)

    def _eval_batches(self, data, labels, batch_size, output_name):
        """(labels, mask, output) of the head ``output_name`` (default: the
        first output) for each batch of the evaluate family: dict-keyed
        inputs and labels are sliced entry by entry, everything else goes
        through ``iter_batches``."""
        head = output_name or self.conf.outputs[0]
        if isinstance(data, dict):
            n = next(iter(data.values())).shape[0]
            bs = batch_size or n
            batches = (({k: v[i:i + bs] for k, v in data.items()},
                        {k: v[i:i + bs] for k, v in labels.items()}
                        if isinstance(labels, dict) else labels[i:i + bs], None)
                       for i in range(0, n, bs))
        else:
            batches = iter_batches(data, labels, batch_size, None)
        for bx, by, bm in batches:
            out = self.output(bx, mask=bm)
            yield (by[head] if isinstance(by, dict) else by, bm,
                   out[head] if isinstance(out, dict) else out)

    def evaluate(self, data, labels=None, *, batch_size=None, evaluation=None,
                 output_name=None):
        """Classification ``Evaluation`` over arrays, an (x, y) pair, dict
        inputs and labels or a DataSetIterator (reference:
        ComputationGraph.evaluate); ``output_name`` picks a head."""
        from deeplearning4j_tpu_torch.eval.classification import Evaluation

        e = evaluation if evaluation is not None else Evaluation()
        for by, bm, out in self._eval_batches(data, labels, batch_size, output_name):
            e.eval(by, out, mask=bm)
        return e

    def evaluate_regression(self, data, labels=None, *, batch_size=None, output_name=None):
        """``RegressionEvaluation`` (reference:
        ComputationGraph.evaluateRegression)."""
        from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation

        e = RegressionEvaluation()
        for by, bm, out in self._eval_batches(data, labels, batch_size, output_name):
            e.eval(by, out, mask=bm)
        return e

    def evaluate_roc(self, data, labels=None, *, batch_size=None, threshold_steps=0,
                     output_name=None):
        """``ROC`` (at most 2 outputs) or ``ROCMultiClass`` (reference:
        ComputationGraph.evaluateROC / evaluateROCMultiClass)."""
        from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass

        roc = None
        for by, bm, out in self._eval_batches(data, labels, batch_size, output_name):
            if roc is None:
                roc = ROC(threshold_steps) if out.shape[-1] <= 2 else ROCMultiClass(threshold_steps)
            roc.eval(by, out, mask=bm)
        if roc is None:
            raise ValueError("no data to evaluate")
        return roc

    def add_listener(self, *ls):
        self.listeners.extend(ls)
        return self

    def num_params(self):
        return sum(int(p.numel()) for p in self.parameters())


class GraphBuilderModule:
    """A reusable graph fragment (reference: nn/conf/module/
    GraphBuilderModule.java): ``update_builder`` appends a named sub-graph
    (an inception block, say) to a ``GraphBuilder``, its output vertex
    last, and returns the builder."""

    def module_name(self):
        """Lowercase module name, the prefix of the vertices it adds."""
        raise NotImplementedError

    def update_builder(self, builder, layer_name, input_size, config, input_layer):
        """Append this module's vertices to ``builder``: ``layer_name`` is
        their base name, ``input_size`` the channel count of
        ``input_layer``'s activations, ``config`` the module's own table.
        Returns the builder."""
        raise NotImplementedError
