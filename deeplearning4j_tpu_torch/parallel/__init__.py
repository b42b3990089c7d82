"""Parallelism over ``torch.distributed``: the mesh and its placement specs,
data-parallel training (``ParallelTrainer``), the TrainingMasters,
batched inference and sequence-parallel attention. Pipeline, tensor and
expert parallelism are not ported yet (ROADMAP queue 1, item 6)."""

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelTrainer  # noqa: F401
from deeplearning4j_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedMultiLayer, EncodedGradientsAccumulator, ParameterAveragingTrainingMaster,
    SharedTrainingMaster, TrainingMaster, initialize_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference  # noqa: F401
from deeplearning4j_tpu_torch.parallel.sequence import (  # noqa: F401
    make_ring_attention_fn, ring_self_attention, ulysses_self_attention)
