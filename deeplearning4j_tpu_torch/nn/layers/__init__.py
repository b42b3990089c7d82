"""Layer catalog ported so far (each class registers its config type)."""

from deeplearning4j_tpu_torch.nn.layers.base import Layer, ParamLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.core import (  # noqa: F401
    ActivationLayer, AutoEncoder, DenseLayer, DropoutLayer, EmbeddingLayer,
    EmbeddingSequenceLayer, LossLayer, OutputLayer, TimeDistributedDenseLayer)
from deeplearning4j_tpu_torch.nn.layers.conv import (  # noqa: F401
    BatchNormalization, Convolution1DLayer, ConvolutionLayer, Deconvolution2DLayer,
    GlobalPoolingLayer, LocalResponseNormalization, ResidualBottleneck,
    SeparableConvolution2DLayer, SpaceToBatchLayer, SpaceToDepthLayer, Subsampling1DLayer,
    SubsamplingLayer, Upsampling1DLayer, Upsampling2DLayer, ZeroPadding1DLayer,
    ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2OutputLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.centerloss import CenterLossOutputLayer  # noqa: F401
from deeplearning4j_tpu_torch.nn.layers.rnn import (  # noqa: F401
    LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM, LastTimeStep, RnnLossLayer,
    RnnOutputLayer, SimpleRnn)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: F401
    LayerNormalization, MultiHeadAttention, TransformerBlock)
from deeplearning4j_tpu_torch.nn.layers.vae import (  # noqa: F401
    BernoulliReconstruction, CompositeReconstruction, ExponentialReconstruction,
    GaussianReconstruction, LossWrapperReconstruction, VariationalAutoencoder)
