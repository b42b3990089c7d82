from deeplearning4j_tpu_torch.graphlib.graph import Graph  # noqa: F401
from deeplearning4j_tpu_torch.graphlib.walks import (  # noqa: F401
    Node2VecWalkIterator, RandomWalkIterator, WeightedWalkIterator,
)
from deeplearning4j_tpu_torch.graphlib.deepwalk import DeepWalk, Node2Vec  # noqa: F401
