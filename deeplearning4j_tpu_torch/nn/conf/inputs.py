"""Input typing & shape inference.

Two families are ported:

- FeedForward: activations [batch, size]
- Recurrent:   activations [batch, time, size] (batch-major, as in the JAX
               package)

The convolutional family is not ported yet: a config naming it fails to
parse with the serde registry's "not ported" error, and ``adapt`` raises
on any conversion other than Recurrent -> FeedForward.
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


def rnn_to_feed_forward(x):
    """[B, T, F] -> [B*T, F]"""
    return x.reshape(-1, x.shape[-1])


def adapt(x, from_type: InputType, to_family: type):
    """Reshape activations from ``from_type`` to the family ``to_family``
    (the sequential network's implicit preprocessors)."""
    if isinstance(from_type, to_family):
        return x
    if isinstance(from_type, RecurrentType) and to_family is FeedForwardType:
        return rnn_to_feed_forward(x)
    raise ValueError(f"No automatic adaptation from {from_type} to "
                     f"{to_family.__name__} in the torch port")


def adapted_type(from_type: InputType, to_family: type) -> InputType:
    """Shape-inference companion of ``adapt``."""
    if isinstance(from_type, to_family):
        return from_type
    if isinstance(from_type, RecurrentType) and to_family is FeedForwardType:
        return FeedForwardType(from_type.size)
    raise ValueError(f"No automatic adaptation from {from_type} to "
                     f"{to_family.__name__} in the torch port")
