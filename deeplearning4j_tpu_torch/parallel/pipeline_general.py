"""Pipeline parallelism for any layer stack or single-input graph:
``PipelinedNetwork`` and ``PipelinedGraph``.

The port of ``deeplearning4j_tpu/parallel/pipeline_general.py``. The JAX
module packs each stage's parameters, state and boundary activations into
flat padded buffers because ``shard_map`` traces one program for every
device; here each rank of the ``stage`` group holds its own layers'
tensors and runs only its own stage, so nothing is packed. The stages
hand on their activations through ``parallel/pipeline.py``'s schedules
(GPipe or 1F1B); a graph's boundary carries every tensor still live
across it (skip connections of any span), concatenated flat.

The semantics kept from the JAX module:

* batch statistics are per microbatch, and a stage's running statistics
  are threaded from microbatch k to k+1 in microbatch order (the
  sequential per-microbatch run), whichever schedule; no batch group is
  opened, and with a ``data`` axis the running statistics are averaged
  over it after the step (ghost batch norm);
* dropout draws from a per-microbatch seed (``split_seed`` of the step's
  seed, one a microbatch) with the network's own per-layer chain, so a
  microbatch draws what the sequential network draws with that seed (the
  port's draws, not JAX's);
* masks reach the mask-aware layers and the output loss, microbatch by
  microbatch;
* the loss: GPipe computes the output layer's loss on all microbatches'
  predictions at once (the network's loss); 1F1B weights each microbatch's
  loss by its share of the rows (of the valid rows, when masked); L1/L2
  penalties are added by the stage that holds the layer;
* gradient normalization, feature-loss heads and aux-loss layers are
  refused with the JAX module's messages (``ValueError``).

``init(from_params=, from_state=)`` takes a whole network's per-layer (or
per-vertex) trees and ``unpack()``/``unpack_state()`` give them back, the
stages' parts gathered: the exchange with a sequential network and its
checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.nn.layers.base import apply_layer, split_seed, step_seed
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.pipeline import (StageLink, _grads_take, _grads_zero,
                                                        load_named, run_schedule, sum_flat)
from deeplearning4j_tpu_torch.utils import collectives as C
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.device import resolve_device
from deeplearning4j_tpu_torch.utils.trees import flatten_tree, tree_leaves, tree_like


def _type_shape(it, mb):
    """The activation shape of ``mb`` rows of input type ``it``."""
    if isinstance(it, _inputs.ConvolutionalType):
        return (mb, it.height, it.width, it.channels)
    if isinstance(it, _inputs.RecurrentType):
        if it.timesteps is None:
            raise ValueError("pipelined RNN stacks need a static sequence length")
        return (mb, it.timesteps, it.size)
    return (mb, it.size)


def _count(tree):
    return sum(int(np.prod(t.shape)) for t in tree_leaves(tree))


def _greedy_balance(counts, n_stages):
    """Contiguous group bounds over per-item parameter counts (close a
    group once it reaches the ideal share); [(start, end)] pairs."""
    total = sum(counts) or 1
    ideal = total / n_stages
    bounds, acc = [], 0.0
    for i, c in enumerate(counts):
        acc += c
        remaining = len(counts) - i - 1
        rem_stages = n_stages - len(bounds) - 1
        if acc >= ideal and rem_stages > 0 and remaining >= rem_stages:
            bounds.append(i + 1)
            acc = 0.0
    while len(bounds) < n_stages - 1:  # degenerate: force non-empty stages
        cand = [i for i in range(1, len(counts)) if i not in bounds]
        bounds.append(cand[0])
        bounds.sort()
    out, prev = [], 0
    for b in bounds + [len(counts)]:
        out.append((prev, b))
        prev = b
    return out


def _param_count(unit, *args):
    """A layer's (or vertex's) parameter count, from a throwaway init."""
    return _count(unit.init(torch.Generator().manual_seed(0), *args))


def balance_stages(conf, n_stages):
    """Contiguous stage groups of layer indices balancing the parameter
    counts (the JAX rule)."""
    if n_stages > len(conf.layers):
        raise ValueError(f"{n_stages} stages need at least that many layers "
                         f"(got {len(conf.layers)})")
    types = conf.layer_input_types()[0]
    counts = [_param_count(layer, it) for layer, it in zip(conf.layers, types)]
    return [list(range(a, b)) for a, b in _greedy_balance(counts, n_stages)]


def balance_graph_stages(conf, n_stages, order=None, types=None):
    """Contiguous topological-order groups of vertex names balancing the
    parameter counts (the JAX rule)."""
    order = order if order is not None else conf.topological_order()
    types = dict(types if types is not None else conf.vertex_types())
    types.update(zip(conf.inputs, conf.input_types))
    defs = {v.name: v for v in conf.vertices}
    if n_stages > len(order):
        raise ValueError(f"{n_stages} stages need at least that many vertices")
    counts = [_param_count(defs[n].vertex, [types[i] for i in defs[n].inputs]) for n in order]
    return [order[a:b] for a, b in _greedy_balance(counts, n_stages)]


def _tensors(tree, device, dtype=None):
    if hasattr(tree, "items"):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    t = tree if torch.is_tensor(tree) else torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).clone()


def _gather_objects(obj, group):
    """Every stage rank's ``obj`` (a picklable CPU tree), in stage order."""
    if group is None or dist.get_world_size(group) == 1:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _detached(tree):
    if hasattr(tree, "items"):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if torch.is_tensor(tree) else tree


def _cpu(tree):
    if hasattr(tree, "items"):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


class _StagedBase:
    """What ``PipelinedNetwork`` and ``PipelinedGraph`` share: the stage
    link, the updater over this stage's tensors, the step (schedule,
    penalties, the exchange over the mesh), the whole-model exchange and
    the checkpoint leaves."""

    def _setup(self, mesh, n_microbatches, updater, schedule, device):
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule {schedule!r}: 'gpipe' or '1f1b'")
        if self.conf.gradient_normalization not in (None, "none"):
            raise ValueError(f"{type(self).__name__} does not apply gradient normalization; "
                             "clip on the sequential network's path")
        self.mesh = mesh
        self.schedule = schedule
        self.n_micro = n_microbatches
        self.n_stages = mesh.shape["stage"]
        self.link = StageLink(mesh)
        self.stage = self.link.s
        self.data_group = mesh.group("data")
        self.dp = mesh.shape["data"]
        self.updater = updater or self.conf.updater
        self.device = resolve_device(device)
        self.params = None
        self.state = None
        self.opt_state = None
        self.iteration = 0
        self.listeners = []
        self.timing = False
        self.wait_ms = []
        self.last_peak_stash = None

    def add_listener(self, listener):
        """A TrainingListener fired after every step (one host read of the
        loss a step)."""
        self.listeners.append(listener)
        return self

    def num_params(self):
        """The whole model's parameter count."""
        return self._n_params

    def _keys(self):
        return self.groups[self.stage]

    def _place(self, ptrees, strees, dtype=None):
        dt = dtype or _dtypes.get_policy().param_dtype
        self._n_params = int(sum(_count(ptrees[k]) for k in self._all_keys()))
        self.params = {k: _tensors(ptrees[k], self.device, dt) for k in self._keys()}
        self.state = {k: _tensors(strees[k], self.device, dt) for k in self._keys()}
        self.opt_state = self.updater.init(self.params)

    # -- the step ----------------------------------------------------------
    def _penalty(self):
        pen = 0.0
        for k in self._keys():
            if len(self.params[k]):
                pen = pen + self._unit(k).regularization_penalty(self.params[k])
        return pen

    def _loss_and_grads(self, x, y, mask, rng, train_grads=True):
        """Run the schedule on this rank's rows: (global loss, grads like
        ``self.params``, or None without ``train_grads``)."""
        x, y = (next(iter(a.values())) if isinstance(a, dict) else a for a in (x, y))
        x, y, mask = self._local(x), self._local(y), self._local(mask)
        b = x.shape[0]
        mb = b // self.n_micro
        if mb * self.n_micro != b:
            raise ValueError(f"batch {b * self.dp} does not divide into {self.n_micro} "
                             f"microbatches x data={self.dp}")
        if mask is not None:
            total = C.all_reduce_(mask.sum().reshape(1).float().clone(), self.data_group)[0]
            total = total.clamp_min(1.0)
        weight_all = (mask.sum() / total) if mask is not None else 1.0 / self.dp
        seeds = split_seed(rng, self.n_micro) if rng is not None else [None] * self.n_micro
        leaves = list(tree_leaves(self.params))
        if train_grads:
            _grads_zero(leaves)
        out_head = self._head()
        mbs = lambda t, m: None if t is None else t[m * mb:(m + 1) * mb]  # noqa: E731

        def head(ys):
            return out_head.compute_loss(torch.cat(ys), y, mask) * weight_all

        def head_mb(m, pred):
            ym, mm = mbs(y, m), mbs(mask, m)
            w = (mm.sum() / total) if mm is not None else mb / (b * self.dp)
            return out_head.compute_loss(pred, ym, mm) * w

        def stage_fn(m, a):
            return self._stage_forward(m, a, mbs(mask, m), seeds[m])

        link = self.link
        link.timed, link.wait_ms = self.timing, 0.0
        with torch.enable_grad() if train_grads else torch.no_grad():
            res = run_schedule(self.schedule if train_grads else "gpipe", link,
                               self.n_micro, stage_fn, source=lambda m: self._source(x, m, mb),
                               head=head, head_mb=head_mb, device=self.device,
                               backward=train_grads)
            pen = self._penalty()
        loss = res.loss if res.loss is not None else torch.zeros((), device=self.device)
        if torch.is_tensor(pen):
            if train_grads and pen.requires_grad:
                (pen / self.dp).backward()
            loss = loss + pen.detach() / self.dp
        elif pen:
            loss = loss + pen / self.dp
        self.last_peak_stash = res.peak_stash
        if self.timing:
            self.wait_ms.append(link.wait_ms)
        grads = _grads_take(leaves) if train_grads else []
        summed = sum_flat([loss.reshape(1).double()], link.group)
        summed = sum_flat(summed + grads, self.data_group)
        g_tree = tree_like(self.params, iter(summed[1:])) if train_grads else None
        return summed[0][0], g_tree

    def _local(self, a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: self._local(v) for k, v in a.items()}
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
        return _mesh.ensure_data_sharded(self.mesh, t).to(self.device)

    def _ghost_bn(self):
        """Average the running statistics over the data axis."""
        if self.dp == 1:
            return
        leaves = [t for t in tree_leaves(self.state) if torch.is_tensor(t)]
        for t, s in zip(leaves, sum_flat(leaves, self.data_group)):
            t.copy_(s / self.dp)

    def step(self, x, y, mask=None):
        """One update on the global batch (the same on every rank); returns
        the global loss."""
        if self.params is None:
            self.init()
        rng = step_seed(self.conf.seed, self.iteration) if self._use_rng else None
        with _dtypes.policy_precision():
            loss, grads = self._loss_and_grads(x, y, mask, rng)
            self.updater.update_(self.params, grads, self.opt_state, self.iteration)
        self._ghost_bn()
        self.iteration += 1
        if self.listeners:
            score = float(loss)
            for li in self.listeners:
                li.iteration_done(self, self.iteration, score)
        return loss

    def loss(self, x, y, mask=None):
        """The pipelined loss of the global batch without a step (train-mode
        statistics; the running state is kept as it was)."""
        if self.params is None:
            self.init()
        saved = {k: dict(v) for k, v in self.state.items()}
        with _dtypes.policy_precision():
            loss, _ = self._loss_and_grads(x, y, mask, None, train_grads=False)
        self.state = saved
        return loss

    # -- whole-model exchange -------------------------------------------------
    def unpack(self):
        """The whole model's parameters (a network's list or dict of
        trees, CPU tensors), gathered from the stages; every rank calls
        it."""
        return self._whole(self.params)

    def unpack_state(self):
        """The whole model's layer state, as ``unpack``."""
        return self._whole(self.state)

    def _whole(self, mine):
        parts = _gather_objects({k: _cpu(v) for k, v in mine.items()}, self.link.group)
        merged = {}
        for p in parts:
            merged.update(p)
        keys = self._all_keys()
        if isinstance(keys[0], int):
            return [merged[k] for k in keys]
        return {k: merged[k] for k in keys}

    # -- checkpoints (``utils/sharded_checkpoint``) ------------------------------
    def checkpoint_leaves(self):
        """{global name: tensor} of everything this rank holds that a
        resume needs."""
        out = {}
        for part, tree in (("params", self.params), ("state", self.state),
                           ("opt_state", self.opt_state)):
            out.update(flatten_tree(tree, part))
        return out

    def load_checkpoint_leaves(self, named):
        load_named(self.checkpoint_leaves(), named)


class PipelinedNetwork(_StagedBase):
    """GPipe or 1F1B over the mesh's ``stage`` axis for any
    MultiLayerConfiguration (see the module docstring). ``stage_layers``:
    contiguous groups of layer indices, one a stage (default: balanced by
    parameter count)."""

    def __init__(self, conf, mesh, *, n_microbatches=4, stage_layers=None, updater=None,
                 seed=None, schedule="gpipe", device="cuda"):
        self.conf = conf
        self.seed = conf.seed if seed is None else seed
        if hasattr(conf.layers[-1], "loss_from_features"):
            raise ValueError("feature-loss heads (CenterLossOutputLayer) need the pre-head "
                             "activations MultiLayerNetwork.loss_fn threads specially; not "
                             "stageable")
        for layer in conf.layers:
            if hasattr(layer, "aux_loss_weight"):
                raise ValueError(f"{type(layer).__name__} emits an aux loss; aux-loss layers "
                                 "(MoE) are not supported inside pipelined stages (use the "
                                 "expert-parallel tier)")
        self._setup(mesh, n_microbatches, updater, schedule, device)
        self.groups = (stage_layers if stage_layers is not None
                       else balance_stages(conf, self.n_stages))
        if len(self.groups) != self.n_stages or \
                [i for g in self.groups for i in g] != list(range(len(conf.layers))):
            raise ValueError("stage_layers must be contiguous groups covering every layer, "
                             "one a stage")
        self.layer_inputs, self.output_type = conf.layer_input_types()
        self._mask_aware = [_base.takes(type(l), "mask") for l in conf.layers]
        self._use_rng = any(getattr(l, "dropout", 0.0) or getattr(l, "weight_noise", None)
                            is not None for l in conf.layers)
        # the type reaching layer i before its adaptation (the previous output)
        self._raw_in = [conf.input_type] + [l.output_type(t) for l, t in
                                            zip(conf.layers[:-1], self.layer_inputs[:-1])]

    def _all_keys(self):
        return list(range(len(self.conf.layers)))

    def _unit(self, i):
        return self.conf.layers[i]

    def _head(self):
        return self.conf.layers[-1]

    def init(self, generator=None, from_params=None, from_state=None, dtype=None):
        """Random weights from the seed (every rank draws the whole network,
        as ``MultiLayerNetwork.init``, and keeps its layers) or a whole
        network's per-layer trees; ``dtype`` overrides the policy's
        parameter dtype (float64 for parity checks)."""
        if from_params is None:
            g = generator or torch.Generator().manual_seed(self.seed)
            from_params = [layer.init(g, it) for layer, it in
                           zip(self.conf.layers, self.layer_inputs)]
        if from_state is None:
            from_state = [layer.init_state(it) for layer, it in
                          zip(self.conf.layers, self.layer_inputs)]
        self._place(list(from_params), list(from_state), dtype)
        return self

    def _source(self, x, m, mb):
        return x[m * mb:(m + 1) * mb]

    def _stage_forward(self, m, a, mask, seed):
        """This stage's layers on microbatch ``m``'s activation, the
        running state advanced in place (microbatch order)."""
        g = self.groups[self.stage]
        n = len(self.conf.layers)
        seeds = split_seed(seed, n) if seed is not None else [None] * n
        cur = self._raw_in[g[0]]
        for i in g:
            layer = self.conf.layers[i]
            fam = layer.input_family
            if fam is not None and not isinstance(cur, fam):
                a = _inputs.adapt(a, cur, fam)
                cur = _inputs.adapted_type(cur, fam)
            kwargs = {}
            if self._mask_aware[i] and mask is not None and mask.dim() >= 2:
                kwargs["mask"] = mask
            a, st = apply_layer(layer, self.params[i], self.state[i], a, train=True,
                                rng=seeds[i], **kwargs)
            self.state[i] = _detached(st)
            cur = layer.output_type(cur)
        return a


class PipelinedGraph(_StagedBase):
    """GPipe or 1F1B over the mesh's ``stage`` axis for a single-input,
    single-output ComputationGraph (see the module docstring).
    ``stage_vertices``: contiguous topological-order groups of vertex
    names, one a stage (default: balanced by parameter count)."""

    def __init__(self, conf, mesh, *, n_microbatches=4, stage_vertices=None, updater=None,
                 seed=None, schedule="gpipe", device="cuda"):
        if len(conf.inputs) != 1 or len(conf.outputs) != 1:
            raise ValueError("PipelinedGraph stages single-input/single-output graphs")
        self.conf = conf
        self.seed = conf.seed if seed is None else seed
        self.order = conf.topological_order()
        if self.order[-1] != conf.outputs[0]:
            raise ValueError("the output vertex must be the topological sink")
        self.defs = {v.name: v for v in conf.vertices}
        self.types = dict(conf.vertex_types())
        self.types[conf.inputs[0]] = conf.input_types[0]
        for v in conf.vertices:
            layer = getattr(v.vertex, "layer", None)
            if getattr(layer, "dropout", 0.0) not in (0.0, None):
                raise ValueError(f"vertex {v.name}: no dropout inside PipelinedGraph")
            if getattr(layer, "weight_noise", None) is not None:
                raise ValueError(f"vertex {v.name}: no weight noise inside PipelinedGraph")
            if hasattr(layer, "aux_loss_weight") or hasattr(v.vertex, "aux_loss_weight"):
                raise ValueError(f"vertex {v.name}: aux-loss layers are not stageable")
        if hasattr(getattr(self.defs[conf.outputs[0]].vertex, "layer", None),
                   "loss_from_features"):
            raise ValueError("feature-loss heads (CenterLossOutputLayer) compute their loss "
                             "from pre-head activations ComputationGraph.loss_fn threads "
                             "specially; not stageable - use the sequential graph")
        self._setup(mesh, n_microbatches, updater, schedule, device)
        self._use_rng = False
        self.groups = (stage_vertices if stage_vertices is not None
                       else balance_graph_stages(conf, self.n_stages, self.order, self.types))
        if len(self.groups) != self.n_stages or \
                [n for g in self.groups for n in g] != self.order:
            raise ValueError("stage_vertices must be contiguous topo-order groups, one a stage")
        self._boundaries = self._compute_boundaries()

    def _all_keys(self):
        return list(self.order)

    def _unit(self, name):
        return self.defs[name].vertex

    def _head(self):
        return self.defs[self.conf.outputs[0]].vertex.layer

    def _compute_boundaries(self):
        """boundaries[k]: the tensor names live entering stage k (the graph
        input for k = 0), and a last entry with the output vertex."""
        in_name = self.conf.inputs[0]
        consumed_at = {}
        for k, g in enumerate(self.groups):
            for vn in g:
                for src in self.defs[vn].inputs:
                    consumed_at[src] = max(consumed_at.get(src, -1), k)
        bounds = [[in_name]]
        for k in range(1, self.n_stages):
            produced = [in_name] + [n for g in self.groups[:k] for n in g]
            bounds.append([n for n in produced if consumed_at.get(n, -1) >= k])
        bounds.append([self.conf.outputs[0]])
        return bounds

    def init(self, generator=None, from_params=None, from_state=None, dtype=None):
        """Random weights from the seed (drawn in topological order, as
        ``ComputationGraph.init``; every rank keeps its vertices) or a whole
        graph's per-vertex trees; ``dtype`` as ``PipelinedNetwork.init``."""
        if from_params is None:
            g = generator or torch.Generator().manual_seed(self.seed)
            from_params = {n: self.defs[n].vertex.init(g, [self.types[i] for i in
                                                           self.defs[n].inputs])
                           for n in self.order}
        if from_state is None:
            from_state = {n: self.defs[n].vertex.init_state([self.types[i] for i in
                                                             self.defs[n].inputs])
                          for n in self.order}
        self._place(dict(from_params), dict(from_state), dtype)
        return self

    def _source(self, x, m, mb):
        return x[m * mb:(m + 1) * mb].reshape(mb, -1)

    def _stage_forward(self, m, a, mask, seed):
        """This stage's vertices on microbatch ``m``'s boundary (flat), the
        next boundary's live tensors out (flat; the output vertex's
        activation itself on the last stage)."""
        k = self.stage
        mb = a.shape[0]
        vals, off = {}, 0
        for name in self._boundaries[k]:
            shape = _type_shape(self.types[name], mb)
            size = int(np.prod(shape[1:]))
            vals[name] = a[:, off:off + size].reshape(shape)
            off += size
        for name in self.groups[k]:
            v = self.defs[name]
            vals[name], st = v.vertex.apply(self.params[name], self.state[name],
                                            [vals[i] for i in v.inputs], train=True, rng=None)
            self.state[name] = _detached(st)
        if self.link.last:
            return vals[self.conf.outputs[0]]
        return torch.cat([vals[n].reshape(mb, -1) for n in self._boundaries[k + 1]], dim=1)
