from deeplearning4j_tpu_torch.nn import activations, initializers, updaters  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.inputs import (  # noqa: F401
    InputType, FeedForwardType, RecurrentType,
)
