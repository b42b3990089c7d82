"""Parallelism over ``torch.distributed``: the mesh and sequence-parallel
attention (the parallel trainers are not ported yet)."""

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.sequence import (  # noqa: F401
    make_ring_attention_fn, ring_self_attention, ulysses_self_attention)
