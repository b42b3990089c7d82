"""Layer catalog ported so far (each class registers its config type)."""

from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer, DenseLayer, EmbeddingSequenceLayer, LossLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.layers.rnn import (  # noqa: F401
    LSTM, GravesLSTM, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNormalization, MultiHeadAttention, TransformerBlock)
