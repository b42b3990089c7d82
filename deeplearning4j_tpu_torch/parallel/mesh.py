"""A named mesh of ranks over ``torch.distributed``.

The port of ``deeplearning4j_tpu/parallel/mesh.py``'s ``MeshSpec`` and
``make_mesh``. The JAX package lays devices out as a ``jax.sharding.Mesh``
with the axes

    data  - data parallelism (replicas)
    model - tensor parallelism (weight shards)
    seq   - sequence/context parallelism (``parallel/sequence.py``)
    stage - pipeline parallelism

Here the ranks of an initialised default process group take the place of
the devices, laid out in the same row-major order (rank r sits at
``np.unravel_index(r, (data, model, seq, stage))``), and every axis gets one
process group per line of ranks along it (``dist.new_group``, on the
default group's backend). The caller initialises the default group, as is
PyTorch's idiom.

Placement: where the JAX module returns a ``NamedSharding`` over a
``PartitionSpec``, this one returns the spec alone, a ``P`` (a tuple with
one entry a dim: None, an axis name, or a tuple of them), which says which
dim splits over which axis. ``zero1_sharding`` keeps the JAX rule; a rank
takes its part of a tensor with ``local_part`` (``shard_batch`` and
``ensure_data_sharded`` for the rows of a global batch).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model", "seq", "stage")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Named mesh shape; -1 on the data axis = every remaining rank."""

    data: int = -1
    model: int = 1
    seq: int = 1
    stage: int = 1

    def resolve(self, n_devices):
        """(data, model, seq, stage) over ``n_devices`` ranks; raises
        ``ValueError`` unless the shape covers them exactly."""
        d = self.data
        if d == -1:
            d = n_devices // (self.model * self.seq * self.stage)
        if d * self.model * self.seq * self.stage != n_devices:
            raise ValueError(f"mesh {d}x{self.model}x{self.seq}x{self.stage} != "
                             f"{n_devices} devices")
        return d, self.model, self.seq, self.stage


class Mesh:
    """This rank's place in the mesh: ``shape`` {axis: size}, ``coords``
    {axis: index}, and ``group(axis)``, the process group of the ranks that
    differ from this one on ``axis`` alone, ordered by their index there
    (its group rank is the index)."""

    def __init__(self, shape, rank, groups, ranks):
        self.shape = dict(zip(AXES, shape))
        self.rank = rank
        self.coords = dict(zip(AXES, (int(i) for i in np.unravel_index(rank, shape))))
        self._groups = groups
        self._ranks = ranks

    def group(self, axis):
        return self._groups[axis]

    def ranks(self, axis):
        """The global ranks of ``group(axis)``, in axis order."""
        return list(self._ranks[axis])


def make_mesh(spec: MeshSpec | None = None) -> Mesh:
    """The mesh of ``spec`` (default ``MeshSpec()``: every rank on ``data``)
    over the world of the initialised default process group. Every rank
    must call it, with the same spec: it creates the axis groups, which is
    a collective. Raises ``ValueError`` when the spec does not cover the
    world (an axis is never shrunk to fit)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    spec = spec or MeshSpec()
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = spec.resolve(world)
    layout = np.arange(world).reshape(shape)  # the JAX mesh's device layout
    groups, ranks = {}, {}
    for a, axis in enumerate(AXES):
        for line in np.moveaxis(layout, a, -1).reshape(-1, shape[a]).tolist():
            group = dist.new_group(line)  # a collective: every rank creates every group
            if rank in line:
                groups[axis], ranks[axis] = group, line
    return Mesh(shape, rank, groups, ranks)


# ---------------------------------------------------------------------------
# placement specs (the JAX module's shardings, as specs)
# ---------------------------------------------------------------------------

class P:
    """A partition spec: entry d names the mesh axis (or tuple of axes) dim
    d splits over, None for a whole dim; missing trailing entries are
    None. Iterates and compares as the tuple of its entries (so it equals
    the JAX ``PartitionSpec`` of the same entries), and is a leaf of a
    parameter tree."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        try:
            return self.entries == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _axes(entry):
    return entry if isinstance(entry, tuple) else () if entry is None else (entry,)


def replicated(mesh):
    return P()


def data_sharded(mesh):
    """Batch-dim split over the data axis."""
    return P("data")


def superbatch_sharded(mesh):
    """Stacked ``[K, B, ...]`` super-batches (``nn/fused.py``): K whole on
    every rank, the batch axis split over 'data'."""
    return P(None, "data")


def zero1_sharding(mesh, spec, leaf, axis="data"):
    """``spec`` extended with ``axis`` for the ZeRO copy of ``leaf`` (its
    updater moments, or the stored parameter under FSDP; Xu et al. 2020,
    arxiv 2004.13336), the JAX rule: the FIRST dim whose per-rank size
    divides by the axis size takes the split (dim 0 in the common case; a
    [4097, 512] table on 8 ranks splits dim 1); a leaf with no such dim
    keeps ``spec`` and stays whole over ``axis``."""
    ax_n = mesh.shape[axis]
    ndim = len(leaf.shape)
    if ax_n == 1 or ndim == 0:
        return spec
    entries = list(spec) + [None] * (ndim - len(spec))
    if any(axis in _axes(e) for e in entries):
        return spec
    for dim, entry in enumerate(entries):
        axes = _axes(entry)
        shard_n = int(np.prod([mesh.shape[a] for a in axes], dtype=int))
        if (leaf.shape[dim] // shard_n) % ax_n != 0:
            continue
        merged = tuple(axes) + (axis,)
        entries[dim] = merged[0] if len(merged) == 1 else merged
        return P(*entries)
    return spec


def slab_sharding(mesh, spec):
    """The spec of a ``[L, ...block]`` stack of blocks with ``spec``: the
    block dims shift one right and the stack axis stays whole."""
    return P(None, *spec)


def _structure(tree):
    if isinstance(tree, (list, tuple)):
        return ("list", tuple(_structure(t) for t in tree))
    if hasattr(tree, "items"):
        return ("dict", tuple((k, _structure(v)) for k, v in tree.items()))
    return "leaf"


def opt_shardings_like(opt_state, params, p_shards, replicated_spec):
    """Spec tree of an updater-state tree: every entry structured like the
    params tree (Adam's m and v, Nesterov's momenta) takes ``p_shards``;
    anything else (scalars, empty states) ``replicated_spec``. A state
    that is itself params-shaped takes ``p_shards`` whole (a
    ComputationGraph's params tree is a dict too)."""
    p_struct = _structure(params)

    def per_entry(sub):
        if _structure(sub) == p_struct:
            return p_shards
        return _map_leaves(lambda _: replicated_spec, sub)

    if _structure(opt_state) == p_struct:
        return p_shards
    if hasattr(opt_state, "items"):
        return {k: per_entry(v) for k, v in opt_state.items()}
    return per_entry(opt_state)


def _map_leaves(fn, tree):
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, t) for t in tree]
    if hasattr(tree, "items"):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def local_part(mesh, a, spec):
    """This rank's part of the global tensor ``a`` (numpy or torch) under
    ``spec``: each split dim narrowed to this rank's equal slice by its
    coordinates on the spec's axes (the first named axis outermost, as the
    JAX mesh tiles). Raises ``ValueError`` when a dim does not divide."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = int(np.prod([mesh.shape[x] for x in axes], dtype=int))
        idx = 0
        for x in axes:
            idx = idx * mesh.shape[x] + mesh.coords[x]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks "
                             f"of {axes}")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t


def shard_batch(mesh, batch):
    """This rank's rows of a global host batch (an array, or a dict or
    tuple of them) on the data axis."""
    return _map_leaves(lambda a: local_part(mesh, a, data_sharded(mesh)), batch)


def ensure_data_sharded(mesh, a):
    """This rank's rows of ``a``: ``local_part`` on the data axis."""
    return local_part(mesh, a, data_sharded(mesh))
