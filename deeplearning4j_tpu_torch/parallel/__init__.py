"""Parallelism over ``torch.distributed``: the mesh and its placement specs,
data-, tensor- and expert-parallel training (``ParallelTrainer``), the
TrainingMasters, batched inference, sequence-parallel attention, the
GPipe/1F1B pipelines (``PipelineParallelLM``, ``PipelinedNetwork``,
``PipelinedGraph``) and the composed dp x tp x pp (x sp) LM."""

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelTrainer  # noqa: F401
from deeplearning4j_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedMultiLayer, EncodedGradientsAccumulator, ParameterAveragingTrainingMaster,
    SharedTrainingMaster, TrainingMaster, initialize_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.parallel.inference import ParallelInference  # noqa: F401
from deeplearning4j_tpu_torch.parallel.pipeline import PipelineParallelLM  # noqa: F401
from deeplearning4j_tpu_torch.parallel.pipeline_general import (  # noqa: F401
    PipelinedGraph, PipelinedNetwork)
from deeplearning4j_tpu_torch.parallel.composed import (  # noqa: F401
    ComposedParallelLM, ComposedTrainer)
from deeplearning4j_tpu_torch.parallel.sequence import (  # noqa: F401
    make_ring_attention_fn, ring_self_attention, ulysses_self_attention)
