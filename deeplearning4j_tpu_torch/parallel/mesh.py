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
PyTorch's idiom. The placement helpers of the JAX module (``replicated``,
``data_sharded``, ``zero1_sharding``, ...) belong to the parallel
trainers and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
