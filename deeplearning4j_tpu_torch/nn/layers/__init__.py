"""Layer catalog ported so far (each class registers its config type)."""

from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer, DenseLayer, DropoutLayer, EmbeddingSequenceLayer, LossLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer, LocalResponseNormalization,
    ResidualBottleneck, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.layers.centerloss import CenterLossOutputLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.rnn import (  # noqa: F401
    LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep, RnnLossLayer,
    RnnOutputLayer, SimpleRnn)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNormalization, MultiHeadAttention, TransformerBlock)
