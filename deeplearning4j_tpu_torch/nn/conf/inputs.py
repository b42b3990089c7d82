"""Input typing & shape inference.

Three families, as in the JAX package:

- FeedForward:   activations [batch, size]
- Recurrent:     activations [batch, time, size] (batch-major)
- Convolutional: activations [batch, height, width, channels] (NHWC, the
                 JAX package's layout; convolutions hand PyTorch an NCHW
                 view of it with channels-last strides)

``adapt`` converts Recurrent and Convolutional activations to FeedForward
(the sequential network's implicit preprocessors); other conversions raise.
``feed_forward``/``recurrent``/``convolutional`` build the types and the
remaining preprocessors (``feed_forward_to_cnn``, ``feed_forward_to_rnn``,
``cnn_to_rnn``, ``rnn_to_cnn``) reshape with explicit target dims, as the
JAX package's.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.utils.serde import register_config


@dataclasses.dataclass(frozen=True)
class InputType:
    pass


@register_config
@dataclasses.dataclass(frozen=True)
class FeedForwardType(InputType):
    size: int = 0

    def shape(self, batch=1):
        return (batch, self.size)


@register_config
@dataclasses.dataclass(frozen=True)
class RecurrentType(InputType):
    size: int = 0
    timesteps: int | None = None  # None = variable length

    def shape(self, batch=1):
        return (batch, self.timesteps or 1, self.size)


@register_config
@dataclasses.dataclass(frozen=True)
class ConvolutionalType(InputType):
    height: int = 0
    width: int = 0
    channels: int = 0

    def shape(self, batch=1):
        return (batch, self.height, self.width, self.channels)

    @property
    def flat_size(self):
        return self.height * self.width * self.channels


# convenience constructors mirroring InputType.feedForward(...) etc.
def feed_forward(size):
    return FeedForwardType(size)


def recurrent(size, timesteps=None):
    return RecurrentType(size, timesteps)


def convolutional(height, width, channels):
    return ConvolutionalType(height, width, channels)


# Preprocessors: reshapes between the families (the reference's
# CnnToFeedForwardPreProcessor family). The network inserts the two to
# FeedForward itself (``adapt``); the others take explicit target dims.


def cnn_to_feed_forward(x):
    """[B, H, W, C] -> [B, H*W*C], flattened in NHWC order."""
    return x.reshape(x.shape[0], -1)


def feed_forward_to_cnn(x, height, width, channels):
    """[B, H*W*C] -> [B, H, W, C]"""
    return x.reshape(x.shape[0], height, width, channels)


def feed_forward_to_rnn(x, timesteps):
    """[B*T, F] -> [B, T, F]"""
    return x.reshape(-1, timesteps, x.shape[-1])


def rnn_to_feed_forward(x):
    """[B, T, F] -> [B*T, F]"""
    return x.reshape(-1, x.shape[-1])


def cnn_to_rnn(x):
    """[B, H, W, C] -> [B, H, W*C], height as time."""
    return x.reshape(x.shape[0], x.shape[1], -1)


def rnn_to_cnn(x, height, width, channels):
    """[B, T, F] -> [B, H, W, C]"""
    return x.reshape(x.shape[0], height, width, channels)


def adapt(x, from_type: InputType, to_family: type):
    """Reshape activations from ``from_type`` to the family ``to_family``
    (the sequential network's implicit preprocessors)."""
    if isinstance(from_type, to_family):
        return x
    if isinstance(from_type, ConvolutionalType) and to_family is FeedForwardType:
        return cnn_to_feed_forward(x)
    if isinstance(from_type, RecurrentType) and to_family is FeedForwardType:
        return rnn_to_feed_forward(x)
    if isinstance(from_type, FeedForwardType) and to_family is ConvolutionalType:
        raise ValueError("FeedForward->CNN adaptation requires explicit target dims; "
                         "set an explicit preprocessor or input_type on the layer")
    raise ValueError(f"No automatic adaptation from {from_type} to "
                     f"{to_family.__name__} in the torch port")


def adapted_type(from_type: InputType, to_family: type) -> InputType:
    """Shape-inference companion of ``adapt``."""
    if isinstance(from_type, to_family):
        return from_type
    if isinstance(from_type, ConvolutionalType) and to_family is FeedForwardType:
        return FeedForwardType(from_type.flat_size)
    if isinstance(from_type, RecurrentType) and to_family is FeedForwardType:
        return FeedForwardType(from_type.size)
    raise ValueError(f"No automatic adaptation from {from_type} to "
                     f"{to_family.__name__} in the torch port")
