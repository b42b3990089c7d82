"""Layer catalog ported so far (each class registers its config type)."""

from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.rnn import (  # noqa: F401
    LSTM, GravesLSTM, RnnOutputLayer)
