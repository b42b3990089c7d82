"""Data-parallel training over ``torch.distributed``: ``ParallelTrainer``.

The port of ``deeplearning4j_tpu/parallel/data_parallel.py`` (reference
analog: ParallelWrapper, and the exact limit of the Spark TrainingMasters'
gradient sharing). One process a rank; the ranks of the mesh's ``data``
group train one network on one global batch.

The API is the JAX trainer's: every rank gets the SAME global batch and
takes rows ``[r*B/N, (r+1)*B/N)`` by its ``data`` coordinate, which is what
the JAX sharding of a global array does, and every call returns the global
loss. The JAX trainer is one global program (GSPMD), so a step equals the
single-device step on the global batch, batch statistics included; so does
this one: at world > 1 the forward and backward run under the mesh's batch
group (``utils/collectives.py``), where BatchNormalization, the fused
conv-BN op's kernel statistics and masked losses reduce over the global
batch and dropout draws with global row indices. The parameter gradients
are then averaged across the group.

Four storage layouts, the JAX names:

* ``replicated``: parameters and updater state whole on every rank; one
  all-reduce (mean) of the gradients, bucketed by dtype, and the net's own
  ``apply_update``.
* ``zero1`` (the default; Xu et al. 2020, arxiv 2004.13336): the updater
  state of each leaf lives split on the leaf's ``zero1_sharding`` dim. The
  gradients are reduce-scattered onto that split, the updater runs on the
  shard (the shard of the parameter is a view into it), and one all-gather
  brings the parameters back whole; constraints run after the gather. A
  leaf with no divisible dim stays whole (its gradient is all-reduced).
  Gradient normalization takes its norms across the shards: one all-reduce
  of the squared sums. A stateless updater (Sgd) takes the replicated step.
* ``fsdp``: the parameters themselves are stored split between steps
  (the full tensors are freed) and all-gathered at step entry.
* ``fsdp_stream``: the homogeneous trunk of a MultiLayerNetwork (>= 2
  identical stateless layers, ``streamable_trunk``) runs block by block:
  each block's parameters are gathered inside a ``torch.utils.checkpoint``
  region by ``_GatherBlock`` (all-gather forward, reduce-scatter backward),
  so the backward gathers each block again instead of keeping them all,
  and no full trunk gradient ever exists. Penalties are re-added in layer
  order. The layers outside the trunk are gathered at step entry as under
  ``fsdp``.

``fit(steps_per_dispatch=K)`` runs K steps a dispatch through the K-step
engine (``nn/fused.py``) with this trainer's step as its base step; on NCCL
the K steps, collectives included, are one CUDA graph; on gloo (no
collective can be captured) they run eagerly and the engine's
``captures`` stays 0.

``tensor_parallel=True`` splits parameters over the mesh's ``model`` axis
by the JAX rule (``parallel/tensor_parallel.py``): each model rank stores,
differentiates and updates its slice of every split leaf (MoE experts
included: expert parallelism), the forward runs under the model group
(``utils/collectives.sync_model``) with explicit collectives whose
transposes keep every gradient the replicated step's, and the ``data``
axis exchanges the slices' gradients as above, in any of the layouts
(``fsdp_stream`` gathers each streamed block's data-axis shards of the
model rank's slices). Weight noise draws each slice at the whole
parameter's element indices (``nn/layers/base.py apply_layer``), so a
split step applies the noise the world-1 step applies. A sharded
checkpoint (``utils/sharded_checkpoint.py``) records both splits of every
leaf and restores into any data x model layout.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from deeplearning4j_tpu_torch.nn.conf import inputs as _inputs
from deeplearning4j_tpu_torch.nn.layers import base as _base
from deeplearning4j_tpu_torch.nn.layers.base import apply_layer, split_seed, step_seed
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel import tensor_parallel as _tp
from deeplearning4j_tpu_torch.utils import collectives as C
from deeplearning4j_tpu_torch.utils import dtypes as _dtypes
from deeplearning4j_tpu_torch.utils.trees import tree_leaves, tree_like

LAYOUTS = ("replicated", "zero1", "fsdp", "fsdp_stream")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def _first(tree):
    return next(iter(tree.values())) if isinstance(tree, dict) else tree


def _moved(t, d):
    """``t`` with dim ``d`` first, flattened to [N-major] order."""
    return t.movedim(d, 0).reshape(-1)


def streamable_trunk(net, params, state):
    """``(i0, i1)`` bounds of the longest homogeneous trunk the streamed
    step can run block by block (the JAX rule): a run of >= 2 identical,
    stateless, param-carrying, unfrozen layers (equal configs, equal input
    types, equal parameter shapes and dtypes) that excludes the output
    layer; or None (a ComputationGraph has none)."""
    layers = getattr(getattr(net, "conf", None), "layers", None)
    if layers is None or isinstance(params, dict) or params is None:
        return None
    n = len(layers)
    frozen = set(getattr(net, "frozen_layers", ()))

    def sig(p):
        flat = list(tree_leaves(p))
        return (_mesh._structure(p), tuple((tuple(t.shape), str(t.dtype)) for t in flat))

    def eligible(i):
        return (i < n - 1 and i not in frozen and bool(len(params[i]))
                and not list(tree_leaves(state[i])))

    def same(i, j):
        return (type(layers[i]) is type(layers[j]) and layers[i] == layers[j]
                and net.layer_inputs[i] == net.layer_inputs[j]
                and sig(params[i]) == sig(params[j]))

    best, i = None, 0
    while i < n:
        if not eligible(i):
            i += 1
            continue
        j = i + 1
        while j < n and eligible(j) and same(i, j):
            j += 1
        if j - i >= 2 and (best is None or (j - i) > (best[1] - best[0])):
            best = (i, j)
        i = j
    return best


def make_param_shardings(mesh, net, params, tensor_parallel=False):
    """The compute-layout spec tree of ``params``: every leaf whole
    (``P()``), or with ``tensor_parallel`` the JAX rule's split over
    'model' (``tensor_parallel.tp_param_specs``)."""
    if tensor_parallel:
        return _tp.tp_param_specs(mesh, net, params)
    return tree_like(params, (_mesh.P() for _ in tree_leaves(params)))


# ---------------------------------------------------------------------------
# bucketed exchanges over a plan of leaves
# ---------------------------------------------------------------------------

class _Plan:
    """Where each leaf of a list splits: ``dims[j]`` the split dim of leaf
    j or None (whole), over a group of ``world`` ranks of which this is
    ``rank``."""

    def __init__(self, dims, shapes, group, world, rank):
        self.dims, self.shapes = list(dims), [tuple(s) for s in shapes]
        self.group, self.world, self.rank = group, world, rank
        #: with ``timed`` (eager steps only: it synchronizes the card), the
        #: milliseconds spent in this plan's collectives accumulate here
        self.timed = False
        self.spent_ms = 0.0

    def _timed(self, fn, *args):
        if not self.timed:
            return fn(*args)
        dev = next((a for a in args if torch.is_tensor(a)), None)
        cuda = dev is not None and dev.is_cuda
        if cuda:
            torch.cuda.synchronize(dev.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(dev.device)
        self.spent_ms += 1e3 * (time.perf_counter() - t0)
        return out

    def shard(self, j, t):
        """Rank's part of leaf j (a view of ``t``)."""
        d = self.dims[j]
        if d is None:
            return t
        c = t.shape[d] // self.world
        return t.narrow(d, self.rank * c, c)

    def _groups(self, js, tensors):
        by = {}
        for j, t in zip(js, tensors):
            by.setdefault(t.dtype, []).append((j, t))
        return by.values()

    def reduce_scatter_mean(self, js, tensors):
        """The group mean of each full tensor, as this rank's shard (a
        whole leaf: its all-reduced mean). One collective a dtype and
        kind. Returns the list in order."""
        out = [None] * len(js)
        pos = {j: k for k, j in enumerate(js)}
        split = [(j, t) for j, t in zip(js, tensors) if self.dims[j] is not None]
        whole = [(j, t) for j, t in zip(js, tensors) if self.dims[j] is None]
        n = self.world
        for items in self._groups(*zip(*split)) if split else ():
            send = torch.cat([_moved(t, self.dims[j]).reshape(n, -1) for j, t in items], dim=1)
            flat = self._timed(C.reduce_scatter, send.reshape(-1), self.group) / n
            off = 0
            for j, t in items:
                d = self.dims[j]
                moved = t.movedim(d, 0).shape
                shape = (moved[0] // n,) + tuple(moved[1:])
                size = int(np.prod(shape))
                out[pos[j]] = flat[off:off + size].reshape(shape).movedim(0, d)
                off += size
        for items in self._groups(*zip(*whole)) if whole else ():
            flat = torch.cat([t.reshape(-1) for _, t in items])
            flat = self._timed(C.all_reduce_, flat, self.group) / n
            off = 0
            for j, t in items:
                out[pos[j]] = flat[off:off + t.numel()].view(t.shape)
                off += t.numel()
        return out

    def gather(self, js, shards, outs=None):
        """The whole tensors of split leaves ``js`` from this rank's
        ``shards``: written into ``outs`` (in place) where given, else
        returned as new tensors. One all-gather a dtype."""
        n = self.world
        result = [None] * len(js)
        pos = {j: k for k, j in enumerate(js)}
        for items in self._groups(js, shards):
            flat = self._timed(C.all_gather, torch.cat([_moved(s, self.dims[j]) for j, s in items]),
                               self.group).view(n, -1)
            off = 0
            for j, s in items:
                d = self.dims[j]
                moved = s.movedim(d, 0).shape
                size = s.numel()
                full = flat[:, off:off + size].reshape((moved[0] * n,) + tuple(moved[1:]))
                full = full.movedim(0, d)
                if outs is not None:
                    outs[pos[j]].copy_(full)
                    result[pos[j]] = outs[pos[j]]
                else:
                    result[pos[j]] = full.contiguous()
                off += size
        return result


def _all_reduce_mean(tensors, group, world):
    """The group mean of each tensor (one all-reduce a dtype)."""
    plan = _Plan([None] * len(tensors), [t.shape for t in tensors], group, world, 0)
    return plan.reduce_scatter_mean(list(range(len(tensors))), tensors)


class _GatherBlock(torch.autograd.Function):
    """A streamed block's whole parameters from this rank's shards: the
    forward all-gathers the split leaves (whole leaves pass), the backward
    reduce-scatters their cotangents (whole leaves: all-reduce), both as
    group means."""

    @staticmethod
    def forward(ctx, plan, js, *shards):
        ctx.plan, ctx.js = plan, js
        ctx.like = [(s.shape, s.dtype, s.device) for s in shards]
        split = [k for k, j in enumerate(js) if plan.dims[j] is not None]
        full = list(shards)
        if split:
            gathered = plan.gather([js[k] for k in split], [shards[k] for k in split])
            for k, g in zip(split, gathered):
                full[k] = g
        return tuple(t if t is not s else t.detach().clone() for t, s in zip(full, shards))

    @staticmethod
    def backward(ctx, *gs):
        gs = [torch.zeros(ctx.plan.shapes[j], dtype=dt, device=dev) if g is None else g
              for j, g, (_, dt, dev) in zip(ctx.js, gs, ctx.like)]
        return (None, None) + tuple(ctx.plan.reduce_scatter_mean(ctx.js, gs))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class ParallelTrainer:
    """Data-parallel trainer around a MultiLayerNetwork's or
    ComputationGraph's functional core (see the module docstring).

    ``donate`` is accepted for the JAX signature and has no effect: the
    updates run in place. Usage, on every rank of an initialised process
    group:
        trainer = ParallelTrainer(net, mesh).init()
        for x, y in data:                 # the global batch, on every rank
            loss = trainer.step(x, y)     # the global loss
    """

    def __init__(self, net, mesh=None, *, tensor_parallel=False, donate=True,
                 shard_optimizer_state=True, shard_params=None):
        if shard_params not in (None, "fsdp", "fsdp_stream"):
            raise ValueError(
                f"shard_params={shard_params!r}: None (replicated between steps), 'fsdp' "
                "(parameters stored split between steps, gathered at step entry) or "
                "'fsdp_stream' (the homogeneous trunk gathered block by block inside the "
                "step)")
        self.net = net
        self.mesh = mesh if mesh is not None else _mesh.make_mesh()
        self.tensor_parallel = bool(tensor_parallel)
        self.group = self.mesh.group("data")
        self.world = self.mesh.shape["data"]
        self.rank = self.mesh.coords["data"]
        self.shard_optimizer_state = (bool(shard_optimizer_state)
                                      or shard_params in ("fsdp", "fsdp_stream"))
        self.shard_params = shard_params
        # world 1: every collective is an identity and the step is net.fit's
        self._bg = C.BatchGroup(self.group, self.rank, self.world) if self.world > 1 else None
        tp = self.mesh.shape["model"]
        #: the model group of a tensor-parallel trainer (None without one)
        self._mg = (C.ModelGroup(self.mesh.group("model"), self.mesh.coords["model"], tp,
                                 apply=_tp.tp_apply)
                    if self.tensor_parallel and tp > 1 else None)
        self._tp_whole = False
        self.params = None
        self.state = None
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        self.score_value = None
        self.score_history = []
        self.listeners = []
        self.last_input = None
        self.examples_dropped = 0
        self._free_between_steps = True
        self._trunk = None
        #: with ``timing`` (eager steps only: it synchronizes the card), each
        #: step appends the milliseconds of its parameter and gradient
        #: collectives (gathers, reduce-scatters, all-reduces) to
        #: ``collective_ms``
        self.timing = False
        self.collective_ms = []
        #: tensor-parallel steps with ``timing``: {kind: ms} of the model
        #: group's forward collectives ('tp_gather', 'tp_weights', 'ep_combine')
        self.model_collective_ms = []

    # -- the net's face (listeners and the StepDriver see the trainer) ----

    @property
    def conf(self):
        return self.net.conf

    @property
    def device(self):
        return self.net.device

    def num_params(self):
        return self._n_params if self.params is not None else self.net.num_params()

    def add_listener(self, *listeners):
        """Attach TrainingListeners: they hear every fit iteration (one
        dispatch late) and each epoch end, with the trainer as the model."""
        self.listeners.extend(listeners)
        return self

    @property
    def layout(self):
        """'replicated' | 'zero1' | 'fsdp' | 'fsdp_stream'."""
        if self.shard_params:
            return self.shard_params
        return "zero1" if self.shard_optimizer_state else "replicated"

    # -- placement ------------------------------------------------------

    def _derive(self, params, opt):
        """The per-leaf plan of the trainable leaves: under ZeRO each leaf
        splits on the dim ``zero1_sharding`` gives it (or stays whole)."""
        net = self.net
        self._zero = (self.shard_params in ("fsdp", "fsdp_stream")
                      or (self.shard_optimizer_state and bool(list(tree_leaves(opt)))))
        trainable_ids = {id(t) for t in tree_leaves(net._trainable(params))}
        leaves = list(tree_leaves(params))
        self._trainable_mask = [id(t) in trainable_ids for t in leaves]
        trainable = [t for t, tr in zip(leaves, self._trainable_mask) if tr]
        dims = []
        for t in trainable:
            spec = _mesh.zero1_sharding(self.mesh, _mesh.P(), t) if self._zero else _mesh.P()
            dims.append(next((i for i, e in enumerate(spec) if "data" in _mesh._axes(e)), None))
        self._plan = _Plan(dims, [t.shape for t in trainable], self.group, self.world, self.rank)
        # gradient-normalization groups of each trainable leaf: (layer, key)
        self._norm_groups = []
        trainable = net._trainable(params)
        entries = trainable.items() if isinstance(trainable, dict) else enumerate(trainable)
        for name, layer_tree in entries:
            items = layer_tree.items() if hasattr(layer_tree, "items") else []
            for key, sub in items:
                for _ in tree_leaves(sub):
                    self._norm_groups.append((name, key))

    def _opt_sliced(self, opt, params, fn):
        """``opt`` with the trainable leaves of each params-shaped entry
        mapped by ``fn(j, leaf)`` (j: the trainable leaf's index)."""
        p_struct = _mesh._structure(params)
        mask = self._trainable_mask

        def per_entry(sub):
            if _mesh._structure(sub) != p_struct:
                return sub
            out, j = [], 0
            for leaf, tr in zip(tree_leaves(sub), mask):
                if tr:
                    out.append(fn(j, leaf))
                    j += 1
                else:
                    out.append(leaf)
            return tree_like(sub, iter(out))

        if _mesh._structure(opt) == p_struct:
            return per_entry(opt)
        if hasattr(opt, "items"):
            return {k: per_entry(v) for k, v in opt.items()}
        return opt

    def _place(self, params, state, opt):
        net = self.net
        if self.shard_params == "fsdp_stream":
            self._trunk = streamable_trunk(net, params, state)
            if self._trunk is None or hasattr(net.conf.layers[-1], "loss_from_features"):
                raise ValueError(
                    "shard_params='fsdp_stream' needs a homogeneous trunk to stream: >= 2 "
                    "consecutive identical stateless layers (same config, same param "
                    "shapes) below a standard loss head. This net has none; use "
                    "shard_params='fsdp' (whole-tree gather) instead")
        self._n_params = int(sum(t.numel() for t in tree_leaves(params)))
        if self._mg is not None:
            opt = self._tp_place(params, opt)
        self._derive(params, opt)
        plan = self._plan
        if self._zero:
            opt = self._opt_sliced(opt, params, lambda j, t: plan.shard(j, t).clone())
        self.opt_state = opt
        self.state = state
        net.state = state
        self._full = [p for p, tr in zip(tree_leaves(params), self._trainable_mask) if tr]
        if self.shard_params in ("fsdp", "fsdp_stream"):
            # a whole leaf is stored as the net's own parameter
            shards = iter([p if plan.dims[j] is None else plan.shard(j, p.detach()).clone()
                           for j, p in enumerate(self._full)])
            self.params = tree_like(params, (next(shards) if tr else p for p, tr in
                                             zip(tree_leaves(params), self._trainable_mask)))
            self._free_full()
        else:
            self.params = params
        # the HBM ledger of this layout (JAX data_parallel.py:337)
        from deeplearning4j_tpu_torch.telemetry import devices as _devices
        _devices.note_train_tree_bytes(params=self.params, opt_state=self.opt_state,
                                       site="parallel_trainer")

    def init(self, generator=None):
        """Initialise the net (from its seed) and place its trees."""
        net = self.net
        net.init(generator)
        self._place(net.params, net.state, net.conf.updater.init(net.params))
        return self

    # -- tensor parallelism -------------------------------------------------

    def _tp_place(self, params, opt):
        """Cut every split leaf of ``params`` (in place: the net's own
        parameter keeps its identity) and of each params-shaped entry of
        ``opt`` to this model rank's slice; returns the cut ``opt``."""
        mg = self._mg
        self._tp_specs = make_param_shardings(self.mesh, self.net, params, True)
        dims = [_tp.split_dim(s) for s in tree_leaves(self._tp_specs)]
        self._tp_dims = dims
        for p, d in zip(tree_leaves(params), dims):
            if d is not None:
                p.data = C.local_slice(p.data, d, mg.rank, mg.world).clone()
        mg.split = _tp.split_map(params, self._tp_specs)
        p_struct = _mesh._structure(params)

        def cut(sub):
            if _mesh._structure(sub) != p_struct:
                return sub
            out = []
            for t, d in zip(tree_leaves(sub), dims):
                if d is not None:
                    t = C.local_slice(t, d, mg.rank, mg.world).clone()
                out.append(t)
            return tree_like(sub, iter(out))

        if _mesh._structure(opt) == p_struct:
            return cut(opt)
        if hasattr(opt, "items"):
            return {k: cut(v) for k, v in opt.items()}
        return opt

    def _tp_local(self):
        """After ``sync_to_net`` made the net whole: the split leaves back
        to this rank's slice."""
        if not self._tp_whole:
            return
        mg = self._mg
        for p, d in zip(tree_leaves(self.net.params), self._tp_dims):
            if d is not None:
                p.data = C.local_slice(p.data, d, mg.rank, mg.world).clone()
        self._tp_whole = False

    def _tp_gathered(self, tree):
        """Whole copies of a params-shaped tree's split leaves (the others
        as they are), gathered over the model group."""
        out = [C.gather_dim(t, d, self._mg.group) if d is not None else t
               for t, d in zip(tree_leaves(tree), self._tp_dims)]
        return tree_like(tree, iter(out))

    def adopt_net_state(self):
        """Place the wrapped net's parameters, state and updater state (a
        checkpoint loaded into it, or a fresh init) and its counters in this
        trainer's layout; the inverse of ``sync_to_net``."""
        net = self.net
        if net.params is None:
            raise ValueError("adopt_net_state: the wrapped net has no params; load a "
                             "checkpoint into it (utils.serialization) or net.init() first")
        opt = net.opt_state if net.opt_state is not None else net.conf.updater.init(net.params)
        self._place(net.params, net.state, opt)
        self.iteration = int(getattr(net, "iteration", 0))
        self.epoch = int(getattr(net, "epoch", 0))
        return self

    # -- fsdp storage -----------------------------------------------------

    def _stored(self):
        """This rank's stored tensor of each trainable leaf (fsdp: the shard
        or the whole leaf; else the net's parameter)."""
        return [p for p, tr in zip(tree_leaves(self.params), self._trainable_mask) if tr]

    def _split_js(self, skip=()):
        return [j for j, d in enumerate(self._plan.dims) if d is not None and j not in skip]

    def _gather_full(self, skip=()):
        """fsdp: the net's parameters made whole from the shards (in place
        where they are still allocated)."""
        js = self._split_js(skip)
        if not js:
            return
        stored = self._stored()
        full = [self._full[j] for j in js]
        if all(tuple(p.shape) == self._plan.shapes[j] for p, j in zip(full, js)):
            self._plan.gather(js, [stored[j] for j in js], outs=[p.data for p in full])
            return
        for p, t in zip(full, self._plan.gather(js, [stored[j] for j in js])):
            p.data = t

    def _free_full(self):
        """fsdp: release the whole tensors of the split leaves."""
        for j in self._split_js():
            p = self._full[j]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    # -- the step ---------------------------------------------------------

    def _streamed_loss(self, state, x, y, rng, mask):
        """``MultiLayerNetwork.loss_fn`` with the trunk run block by block:
        each block's parameters gathered from their shards inside a
        checkpoint region (the backward gathers again), the penalties
        re-added in layer order so the sum's order is the net's. Under
        tensor parallelism the gather brings back this model rank's slice
        of each leaf (never the whole block), and the block runs through the
        model group as outside the trunk. Returns (loss, new_state)."""
        net = self.net
        layers = net.conf.layers
        n = len(layers)
        i0, i1 = self._trunk
        full = net.params
        stored = self._stored()
        layer_js = self._layer_leaf_js()
        new_state = list(state)
        cur_type = net.conf.input_type
        seeds = split_seed(rng, n) if rng is not None else [None] * n
        pens = [0.0] * n
        mg = self._mg
        h = x
        for i, layer in enumerate(layers):
            fam = layer.input_family
            if fam is not None and not isinstance(cur_type, fam):
                h = _inputs.adapt(h, cur_type, fam)
                cur_type = _inputs.adapted_type(cur_type, fam)
            kwargs = {}
            if net._mask_aware[i] and mask is not None and mask.dim() >= 2:
                kwargs["mask"] = mask
            l_train = net._layer_train(i, True)
            if i0 <= i < i1:
                js = layer_js[i]
                shards = [stored[j] for j in js]

                # under tensor parallelism a block's leaves are this model
                # rank's slices, gathered over data only
                tp_split = mg.split_of(full[i]) if mg is not None else None

                def block(h_in, *sh, i=i, layer=layer, js=js, kwargs=kwargs, l_train=l_train,
                          tp_split=tp_split):
                    whole = _GatherBlock.apply(self._plan, js, *sh)
                    p_full = tree_like(full[i], iter(whole))
                    out, _ = apply_layer(layer, p_full, state[i], h_in, train=l_train,
                                         rng=seeds[i], tp_split=tp_split, **kwargs)
                    pen = layer.regularization_penalty(p_full)
                    if not torch.is_tensor(pen):
                        pen = torch.zeros((), dtype=h_in.dtype, device=h_in.device) + pen
                    return out, pen

                h, pens[i] = torch.utils.checkpoint.checkpoint(
                    block, h, *shards, use_reentrant=False, preserve_rng_state=False)
            else:
                h, new_state[i] = apply_layer(layer, full[i], state[i], h, train=l_train,
                                              rng=seeds[i], **kwargs)
            cur_type = layer.output_type(cur_type)
        loss = layers[-1].compute_loss(h, y, mask)
        for i in range(n):
            if i0 <= i < i1:
                loss = loss + pens[i]
            elif len(full[i]):
                loss = loss + layers[i].regularization_penalty(full[i])
        return _base.pop_aux_losses(loss, new_state)

    def _tp_trainable_split(self):
        """Per trainable leaf: whether it is split over the model group."""
        return [d is not None for d, tr in zip(self._tp_dims, self._trainable_mask) if tr]

    def _layer_leaf_js(self):
        """Trainable leaf indices of each top-level entry of the params."""
        out, j = [], 0
        for tr_tree in self.net._trainable(self.net.params):
            k = sum(1 for _ in tree_leaves(tr_tree))
            out.append(list(range(j, j + k)))
            j += k
        return out

    def _normalize_sharded(self, grads):
        """The net's gradient normalization on exchanged gradients, the norms
        taken over the whole leaves: each split leaf's shard adds its
        squares, each whole leaf 1/N of its squares, and one all-reduce sums
        them over the group."""
        conf = self.net.conf
        mode, thr = conf.gradient_normalization, conf.gradient_normalization_threshold
        if mode in (None, "none"):
            return grads
        if mode == "clip_elementwise_absolute_value":
            return [g.clamp(-thr, thr) for g in grads]
        per_layer = mode in ("renormalize_l2_per_layer", "clip_l2_per_layer")
        keys = [grp[0] if per_layer else grp for grp in self._norm_groups]
        order = list(dict.fromkeys(keys))
        pos = {k: i for i, k in enumerate(order)}
        sq = torch.zeros(len(order), dtype=torch.float32, device=grads[0].device)
        tp_split = self._tp_trainable_split() if self._mg is not None else None
        for j, g in enumerate(grads):
            s = (g.float() * g.float()).sum()
            if self._plan.dims[j] is None and self._zero:
                s = s / self.world
            if tp_split is not None and not tp_split[j]:
                s = s / self._mg.world  # a whole leaf is counted once over the model group
            sq[pos[keys[j]]] += s
        if self._zero:
            C.all_reduce_(sq, self.group)
        if tp_split is not None:
            C.all_reduce_(sq, self._mg.group)
        norm = torch.sqrt(sq + 1e-32)
        if mode.startswith("renormalize"):  # divided, as nn/gradnorm.py divides
            return [g / norm[pos[keys[j]]].to(g.dtype) for j, g in enumerate(grads)]
        scale = (thr / norm).clamp_max(1.0)
        return [g * scale[pos[keys[j]]].to(g.dtype) for j, g in enumerate(grads)]

    def _train_step(self, params, state, opt_state, x, y, step, mask=None, rng=None):
        """One step on this rank's rows: ``make_train_step``'s signature
        (and the K-step engine's base step). Returns (params, new_state,
        opt_state, global loss)."""
        net, plan = self.net, self._plan
        stream = self.shard_params == "fsdp_stream"
        fsdp = self.shard_params in ("fsdp", "fsdp_stream")
        trunk_js = set()
        if stream:
            lj = self._layer_leaf_js()
            trunk_js = {j for i in range(*self._trunk) for j in lj[i]}
        if fsdp:
            self._gather_full(skip=trunk_js)
        full = net.params
        with C.sync_batch(self._bg), C.sync_model(self._mg):
            if stream:
                for p in tree_leaves(full):
                    p.requires_grad_(False)
                stored = self._stored()
                targets = []
                for j, p in enumerate(self._full):
                    t = stored[j] if j in trunk_js else p
                    targets.append(t.requires_grad_(True))
                loss, new_state = self._streamed_loss(state, x, y, rng, mask)
            else:
                trainable = net._watch(full)
                targets = list(tree_leaves(trainable))
                loss, (new_state, _) = net.loss_fn(full, state, x, y, train=True, mask=mask,
                                                   rng=rng)
            gs = torch.autograd.grad(loss, targets, allow_unused=True)
        for t in targets:
            t.requires_grad_(False)
        gs = [torch.zeros_like(t) if g is None else g for t, g in zip(targets, gs)]
        loss = loss.detach()
        updater = net.conf.updater
        if not self._zero:
            grads = plan.reduce_scatter_mean(list(range(len(gs))), gs)
            if self._mg is not None:
                grads = self._normalize_sharded(grads)
            tree = tree_like(net._trainable(full), iter(grads))
            if self._mg is None:
                tree = _normalize_full(net, tree)
            net.apply_update(full, opt_state, tree, step)
        else:
            js = [j for j in range(len(gs)) if j not in trunk_js]
            exchanged = plan.reduce_scatter_mean(js, [gs[j] for j in js])
            grads = list(gs)
            for j, g in zip(js, exchanged):
                grads[j] = g
            grads = self._normalize_sharded(grads)
            views = self._stored() if fsdp else [plan.shard(j, p.data)
                                                 for j, p in enumerate(self._full)]
            updater.update_(views, grads, net._trainable(opt_state), step)
            if not fsdp:
                split = self._split_js()
                plan.gather(split, [views[j] for j in split],
                            outs=[self._full[j].data for j in split])
                net.apply_constraints(full, step)
            elif _has_constraints(net):
                self._gather_full()
                net.apply_constraints(full, step)
                stored = self._stored()
                with torch.no_grad():
                    for j in self._split_js():
                        stored[j].copy_(plan.shard(j, self._full[j].data))
        loss = C.all_reduce_(loss.reshape(1).clone(), self.group)[0] / self.world
        return params, new_state, opt_state, loss

    def _local(self, a):
        """This rank's rows of a global array (or dict of them) on the
        net's device; None stays None."""
        if a is None:
            return None
        dev = self.device

        def one(t):
            part = _mesh.ensure_data_sharded(self.mesh, t)
            return part.to(dev, non_blocking=True) if part.device != dev else part
        return _map(one, a)

    def step(self, x, y, mask=None):
        """One train step on the global batch ``(x, y[, mask])`` (the same
        arrays on every rank); returns the global loss (a device scalar)."""
        if self.params is None:
            self.init()
        if self._mg is not None:
            self._tp_local()
            self._mg.timed, self._mg.spent_ms = self.timing, {}
        xl, yl, ml = self._local(x), self._local(y), self._local(mask)
        self.last_input = _first(xl)
        self._plan.timed, self._plan.spent_ms = self.timing, 0.0
        with _dtypes.policy_precision():
            out = self._train_step(self.params, self.state, self.opt_state, xl, yl,
                                   self.iteration, ml, step_seed(self.conf.seed, self.iteration))
        self.state = self.net.state = out[1]
        if self.timing:
            self.collective_ms.append(self._plan.spent_ms)
            if self._mg is not None:
                self.model_collective_ms.append(dict(self._mg.spent_ms))
        if self.shard_params in ("fsdp", "fsdp_stream") and self._free_between_steps:
            self._free_full()
        loss = out[3]
        self.score_value = loss
        self.iteration += 1
        return loss

    # -- fit --------------------------------------------------------------

    def _batches(self, x, y, batch_size, mask):
        from deeplearning4j_tpu_torch.datasets.iterator import iter_batches
        if isinstance(x, dict):
            n = _first(x).shape[0]
            bs = batch_size or n
            for i in range(0, n, bs):
                yield ({k: v[i:i + bs] for k, v in x.items()},
                       _map(lambda v: v[i:i + bs], y),
                       None if mask is None else mask[i:i + bs])
            return
        yield from iter_batches(x, y, batch_size, mask)

    def fit(self, x, y=None, *, epochs=1, batch_size=None, mask=None, steps_per_dispatch=1):
        """Train on arrays, an (x, y) pair or an iterator of batches, the
        same on every rank. A batch whose leading dim does not divide by
        the data axis is skipped and counted in ``examples_dropped``.
        ``steps_per_dispatch=K`` runs K steps a dispatch through the K-step
        engine (ragged batches pad, validity in the loss mask). Returns the
        last score."""
        from deeplearning4j_tpu_torch.continuous.driver import (StepDriver, _ShardedFusedEngine,
                                                                 _ShardedPlainEngine)

        is_iterator = (y is None and hasattr(x, "__iter__") and not isinstance(x, (tuple, list))
                       and not hasattr(x, "shape") and not isinstance(x, dict))
        if is_iterator and (batch_size is not None or mask is not None):
            raise ValueError("batch_size/mask have no effect with an iterator input: the "
                             "iterator owns its own batching and per-batch masks")
        if self.params is None:
            self.init()
        if self._mg is not None:
            self._tp_local()
            self._mg.timed = False
        k = int(steps_per_dispatch)
        if k > 1:
            feats = x[0] if (y is None and isinstance(x, (tuple, list))) else x
            feats = _first(feats)
            nominal = batch_size if batch_size is not None else (
                feats.shape[0] if hasattr(feats, "shape") else None)
            if nominal is not None and nominal % self.world:
                raise ValueError(f"bucketed batch size {nominal} not divisible by the "
                                 f"data-axis size {self.world}")
            engine = _ShardedFusedEngine(self, k, batch_size=batch_size)
        else:
            engine = _ShardedPlainEngine(self)
        self.examples_dropped = 0
        self.score_history = []
        drv = StepDriver(self, lambda: self._batches(x, y, batch_size, mask), engine=engine)
        drv.profile = getattr(self, "_profile_schedule", None)
        try:
            with _dtypes.policy_precision():
                self._run_epochs(drv, epochs)
        finally:
            drv.close_source()
            if k > 1 and self.shard_params in ("fsdp", "fsdp_stream"):
                self._free_between_steps = True
                self._free_full()
        if self.examples_dropped:
            warnings.warn(f"ParallelTrainer.fit dropped {self.examples_dropped} examples in "
                          f"ragged batches not divisible by data={self.world}")
        if self.score_history:
            self.score_value = self.score_history[-1]
        return self.score_value

    def profile_round(self, rounds_from_now, logdir, force=None):
        """Arm a ``torch.profiler`` window around the n-th future fit round
        (one epoch of the driver loop; 1: the next), JAX
        ``data_parallel.py:620``. A guarded no-op off a card
        (``telemetry/profiling.py``); the armed schedule goes to the
        StepDriver the next ``fit`` builds."""
        from deeplearning4j_tpu_torch.telemetry import profiling as _profiling
        sched = getattr(self, "_profile_schedule", None)
        if sched is None:
            sched = self._profile_schedule = _profiling.ProfileSchedule()
        sched.arm(rounds_from_now, logdir, force=force)
        return sched

    def _run_epochs(self, drv, epochs):
        """The JAX trainer's epoch contract: an empty first epoch, or an
        input exhausted before a later epoch, raises."""
        try:
            for epoch in range(epochs):
                rr = drv.run_round(None)
                if rr.steps == 0 and epoch == 0:
                    raise ValueError("no trainable batches: every batch's leading dim must be "
                                     f"divisible by the data-axis size {self.world}")
                if rr.steps == 0:
                    raise ValueError(f"input exhausted before epoch {epoch + 1}: pass a "
                                     "resettable DataSetIterator (or arrays) for epochs>1")
        finally:
            drv._pipe.abandon()

    def _steps_fn(self, k):
        """The cached K-step engine over this trainer's step."""
        from deeplearning4j_tpu_torch.nn import fused as _fused
        cache = self.__dict__.setdefault("_steps_fns_fused", {})
        if k not in cache:
            # gloo cannot be captured: its K steps run eagerly (captures 0)
            gloo = dist.get_backend(self.group) == dist.Backend.GLOO
            cache[k] = _fused.make_train_steps(self.net, k, base_step=self._train_step,
                                               eager=gloo)
        return cache[k]

    def score(self, x, y, mask=None):
        """The global loss on ``(x, y)`` without training (inference mode;
        the same arrays on every rank)."""
        if self.params is None:
            self.init()
        fsdp = self.shard_params in ("fsdp", "fsdp_stream")
        if self._mg is not None:
            self._tp_local()
        if fsdp:
            self._gather_full()
        try:
            with _dtypes.policy_precision(), C.sync_batch(self._bg), C.sync_model(self._mg):
                loss, _ = self.net.loss_fn(self.net.params, self.state, self._local(x),
                                           self._local(y), train=False, mask=self._local(mask))
        finally:
            if fsdp:
                self._free_full()
        loss = C.all_reduce_(loss.detach().reshape(1).clone(), self.group)[0] / self.world
        return float(loss)

    def output(self, x, mask=None):
        """Inference through the trained parameters: ``sync_to_net``, then
        the net's ``output`` (every rank computes the whole batch)."""
        self.sync_to_net()
        return self.net.output(x, mask=mask)

    def step_memory_analysis(self, x, y, mask=None):
        """Run one train step (it trains) with the card's peak counter reset
        and return ``{"layout", "peak_bytes", "param_bytes",
        "opt_state_bytes"}`` for this rank; None off a card. The step's
        ledger also goes to ``step_peak_bytes{site="parallel_trainer"}``
        (JAX ``data_parallel.py:842``). The step runs through
        ``utils/compile_cache.aot_compile`` under the JAX package's kind,
        ``trainer_step:<layout>`` (JAX ``:835-838``)."""
        from deeplearning4j_tpu_torch.telemetry import devices as _devices
        from deeplearning4j_tpu_torch.utils import compile_cache as _cc
        if self.params is None:
            self.init()
        if self.device.type != "cuda":
            return None
        stats, _src = _cc.aot_compile(
            lambda: _devices.step_peak_stats(lambda: self.step(x, y, mask), self.device),
            kind=f"trainer_step:{self.layout}", signature=_cc.signature_of((x, y, mask)))
        _devices.note_step_peak_bytes("parallel_trainer", stats, layout=self.layout)
        return {"layout": self.layout, "peak_bytes": stats["peak_bytes"], **self.tree_bytes()}

    def tree_bytes(self):
        """This rank's stored bytes between steps: parameters and updater
        state, in this layout."""
        def nbytes(tree):
            return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                           if torch.is_tensor(t)))
        return {"param_bytes": nbytes(self.params), "opt_state_bytes": nbytes(self.opt_state)}

    def sync_to_net(self):
        """Whole parameters, state and updater state back into the wrapped
        net, gathered one leaf at a time (at most one gathered leaf in
        flight), with the counters; returns the net."""
        net, plan = self.net, self._plan
        if self.params is None or self._tp_whole:
            return net
        if self.shard_params in ("fsdp", "fsdp_stream"):
            stored = self._stored()
            for j in self._split_js():
                p = self._full[j]
                p.data = plan.gather([j], [stored[j]])[0]
        net.state = self.state
        if self._zero:
            params = net.params
            opt = self.opt_state

            def whole(j, t):
                if plan.dims[j] is None:
                    return t.clone()
                return plan.gather([j], [t])[0]
            net.opt_state = self._opt_sliced(opt, params, whole)
        else:
            net.opt_state = self.opt_state
        if self._mg is not None and not self._tp_whole:
            # whole parameters in place (the next step cuts them again) and a
            # whole copy of the updater state
            for p, d in zip(tree_leaves(net.params), self._tp_dims):
                if d is not None:
                    p.data = C.gather_dim(p.data, d, self._mg.group)
            self._tp_whole = True
            p_struct = _mesh._structure(net.params)
            opt = net.opt_state
            if _mesh._structure(opt) == p_struct:
                net.opt_state = self._tp_gathered(opt)
            elif hasattr(opt, "items"):
                net.opt_state = {k: self._tp_gathered(v) if _mesh._structure(v) == p_struct
                                 else v for k, v in opt.items()}
        net.iteration = self.iteration
        net.epoch = self.epoch
        return net


def _normalize_full(net, grads):
    """The net's own gradient normalization on whole gradients (per layer
    of a MultiLayerNetwork, per vertex of a graph)."""
    from deeplearning4j_tpu_torch.nn import gradnorm as _gradnorm
    conf = net.conf
    mode = conf.gradient_normalization
    if mode in (None, "none"):
        return grads
    if isinstance(grads, dict):
        return {k: _gradnorm.normalize_layer_grads(mode, g, conf.gradient_normalization_threshold)
                if g else g for k, g in grads.items()}
    return _gradnorm.normalize_grads(mode, grads, conf.gradient_normalization_threshold)


def _has_constraints(net):
    layers = getattr(net.conf, "layers", None)
    return bool(layers) and any(getattr(l, "constraints", None) for l in layers)

